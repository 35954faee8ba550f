// Same-size 2-D sliding-window percentile, for Hopper (sm_90a).
//
// Replaces kraken_tpu/ops/binarize.py:_window_percentile, which nlbin's
// background estimate (_nlbin_core) calls twice a page, with windows of
// (range, 2) and then (2, range): an XLA program there that stacks all
// sh * sw shifted copies of the zoomed page and sorts across them. For
// each of N (H, W) fp32 maps and each pixel (y, x), the window is the
// sh x sw block at (y, x) of the map padded as jnp.pad(mode='reflect')
// pads it: top = (sh - 1) / 2 rows above and sh - 1 - top below, left =
// (sw - 1) / 2 columns to the left and sw - 1 - left to the right, with no
// edge repeat (a pad wider than the map reflects again, with period
// 2 (n - 1); a map of one row or column repeats it). Of its n = sh * sw
// values the kernel takes the lo-th and hi-th smallest (0-based, hi <= lo
// + 1) and writes v_lo * w_lo + v_hi * w_hi, each product and the sum
// rounded once (__fmul_rn, __fadd_rn: no FMA is contracted), which is
// jnp.percentile's 'linear' method when the wrapper computes lo, hi and
// the weights as JAX does (ops/binarize.py:_ranks). An order statistic is
// the same value whichever selection finds it, so every route gives the
// plain version's result (ops/binarize.py:window_percentile_reference) bit
// for bit. The one freedom: where +0.0 and -0.0 tie (they compare equal),
// a route may return either zero, as the plain version's sort may order
// them either way. A window with a NaN has no rank; every route writes
// NaN there and sets bit 1 of `error`, which the wrapper reads once after
// the launch and raises on (the plain version's caller checks the same on
// the CPU).
//
// What bounds it on the H100: the least work is one read of the map and one
// write of the result (8 bytes a pixel), against at least n + min(k, n - k + 1)
// - 2 comparisons a pixel to select an order statistic (Hyafil's bound; 47
// for n = 40): bytes, 0.0065 ms a pass at the fixture page's zoomed
// 1982 x 1371.
//
// The first design (the "staged" and "direct" routes below) counts
// ranks: each of a pixel's n values against all n, n^2 comparisons a pixel
// (1,600 shared-memory loads at n = 40, 4.35 G a pass at the fixture page),
// which no tiling brings under ~0.6 ms; it ran at 1.02-1.05 ms, 160x its
// bound. Neighbouring windows share all but one line, so the "sliding"
// route, the one nlbin's windows take, keeps each line of the window
// sorted and slides it:
// - it takes every window with a side of 1 or 2 (s = that side, r the
//   other): "vertical" when sw <= 2 (the runs are columns of r rows,
//   sliding down), else "horizontal" (rows of r columns, sliding right);
// - a warp takes 32 lines across (33 - s outputs: with s = 2 the last lane
//   only carries the run its left neighbour needs) and kSlideSteps outputs
//   along them; it stages its strip with the reflect pad (the reflect()
//   index, so any pad, however wide, is exact) in shared memory as rows of
//   kStride = 33 words, one a lane, read from device memory by lanes on
//   consecutive addresses (a horizontal strip is transposed on the way in
//   and out, the odd stride keeping both directions free of bank
//   conflicts);
// - each lane keeps its line's r values as a sorted run in shared memory,
//   value i at run[32 i + lane] (its own bank whatever i), built once by
//   insertion and then slid one step an output: the leaving value is found
//   by binary search and the entering one shifted into place, O(r) a step
//   with no sort; a NaN enters the run as +inf and is counted;
// - the lo-th and hi-th of the union of the lane's run and its right
//   neighbour's (s = 2) come by a merge-path binary search over the two
//   runs, O(log r), the same number of steps in every lane; two __syncwarp
//   a step order the neighbour's reads against the next slide, and no
//   block barrier is needed: each warp runs alone;
// - each output is written into the strip's spent row (the row that left
//   the window that step) and the strip is written out coalesced at the
//   end.
// About r + log r operations a pixel against 4 r^2. A block holds up to
// kSlideWarps warps, fewer where their strips and runs exceed the card's
// shared memory a block; a window whose single warp exceeds it (a range
// over 877, e.g. the (1800, 2) window) and every window with both sides
// over 2 keep the rank-count routes:
//   - "staged": a block takes a TW x TH = 32 x 8 output tile, a thread a
//     pixel, and stages the tile with its reflect halo ((TH + sh - 1) x
//     (TW + sw - 1) floats) in shared memory, a warp on consecutive
//     addresses of a row, so a warp's lanes read consecutive words of one
//     row at every step of the count; the window's columns are a template
//     constant where sw == 2;
//   - "direct": a window whose tile and halo exceed the card's shared
//     memory a block is read straight from device memory through the
//     reflect indices.
// The route is the first of sliding, staged and direct that takes the
// window on the card (route_geometry(); the wrapper mirrors it in
// ops/binarize.py:plan and passes it in).
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int TW = 32;
constexpr int TH = 8;
constexpr int kStaticSmem = 48 * 1024;
constexpr int kSlideSteps = 32;  // outputs a warp slides along its lines
constexpr int kSlideWarps = 4;   // warps a block on the sliding route, at most
constexpr int kStride = 33;      // words a staged row of a sliding strip

enum Route { kDirect = 0, kStaged = 1, kSliding = 2 };

// numpy's 'reflect' index into [0, n) for any i
__device__ __forceinline__ int reflect(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  int m = i % period;
  if (m < 0) m += period;
  return m < n ? m : period - m;
}

size_t staged_bytes(int sh, int sw) {
  return (size_t)(TH + sh - 1) * (size_t)(TW + sw - 1) * sizeof(float);
}

// The sliding route's shared memory a warp for lines of r values: its
// strip, kSlideSteps + r rows of kStride words (a spare row, then the
// kSlideSteps + r - 1 the outputs' windows cover), and 32 runs of r.
__host__ __device__ inline size_t slide_warp_bytes(int r) {
  return ((size_t)(kSlideSteps + r) * kStride + (size_t)32 * r) * sizeof(float);
}

// SW: the window's columns when known at compile time (2), else 0 (sw)
template <bool STAGED, int SW>
__global__ void __launch_bounds__(TW * TH)
percentile_kernel(const float* __restrict__ in, float* __restrict__ out, int H, int W, int sh,
                  int sw_arg, int lo, int hi, float w_lo, float w_hi, int* __restrict__ error) {
  extern __shared__ float tile[];
  const int sw = SW ? SW : sw_arg;
  const float* src = in + (size_t)blockIdx.z * H * W;
  const int top = (sh - 1) / 2, left = (sw - 1) / 2;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tw = TW + sw - 1;
  if constexpr (STAGED) {
    const int th = TH + sh - 1;
    for (int r = threadIdx.y; r < th; r += TH) {
      const float* row = src + (size_t)reflect(y0 + r - top, H) * W;
      for (int c = threadIdx.x; c < tw; c += TW) tile[r * tw + c] = row[reflect(x0 + c - left, W)];
    }
    __syncthreads();
  }
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  // the window's value at (dy, dx)
  auto value = [&](int dy, int dx) -> float {
    if constexpr (STAGED) return tile[(threadIdx.y + dy) * tw + threadIdx.x + dx];
    else return __ldg(src + (size_t)reflect(y + dy - top, H) * W + reflect(x + dx - left, W));
  };
  float v_lo = 0.f, v_hi = 0.f;
  bool has_nan = false;
  for (int iy = 0; iy < sh; ++iy) {
    for (int ix = 0; ix < sw; ++ix) {
      const float v = value(iy, ix);
      has_nan |= v != v;
      int less = 0, equal = 0;
      for (int jy = 0; jy < sh; ++jy) {
        for (int jx = 0; jx < sw; ++jx) {
          const float u = value(jy, jx);
          less += u < v;
          equal += u == v;
        }
      }
      if (less <= lo && lo < less + equal) v_lo = v;
      if (less <= hi && hi < less + equal) v_hi = v;
    }
  }
  float result;
  if (has_nan) {
    result = __int_as_float(0x7fc00000);
    atomicOr(error, 1);
  } else {
    result = __fadd_rn(__fmul_rn(v_lo, w_lo), __fmul_rn(v_hi, w_hi));
  }
  out[(size_t)blockIdx.z * H * W + (size_t)y * W + x] = result;
}

// The sliding route: VERTICAL takes (r, S) windows (runs down columns),
// else (S, r) (runs along rows); S, the short side, is 1 or 2. Warp w of
// block b takes unit b * warps + w: map n, strip `strip` of kSlideSteps
// outputs along the runs, group `group` of 33 - S outputs across them.
template <bool VERTICAL, int S>
__global__ void __launch_bounds__(32 * kSlideWarps)
percentile_sliding_kernel(const float* __restrict__ in, float* __restrict__ out, int N, int H,
                          int W, int r, int lo, int hi, float w_lo, float w_hi,
                          int* __restrict__ error) {
  extern __shared__ float smem[];
  constexpr int kOuts = 33 - S;
  const int lane = threadIdx.x & 31;
  const int n_long = VERTICAL ? H : W, n_short = VERTICAL ? W : H;
  const int groups = (n_short + kOuts - 1) / kOuts;
  const int strips = (n_long + kSlideSteps - 1) / kSlideSteps;
  const long long unit = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (unit >= (long long)N * strips * groups) return;  // the same for every lane
  const int group = (int)(unit % groups);
  const int strip = (int)(unit / groups % strips);
  const int n = (int)(unit / groups / strips);
  const int q0 = group * kOuts;         // the first line across
  const int p0 = strip * kSlideSteps;   // the first output along
  const int steps = min(kSlideSteps, n_long - p0);
  const int outs = min(kOuts, n_short - q0);
  const int before = (r - 1) / 2;       // the window's pad before its output
  const float* src = in + (size_t)n * H * W;
  float* dst = out + (size_t)n * H * W;
  float* buf = smem + (threadIdx.x >> 5) * (slide_warp_bytes(r) / sizeof(float));
  float* run = buf + (size_t)(kSlideSteps + r) * kStride + lane;  // value i at run[32 i]
  const float inf = __int_as_float(0x7f800000);

  // stage row 1 + i of the strip: position p0 - before + i along, i < rows
  const int rows = steps + r - 1;
  if (VERTICAL) {
    const int x = reflect(q0 + lane, W);
    for (int i = 0; i < rows; ++i)
      buf[(1 + i) * kStride + lane] = src[(size_t)reflect(p0 - before + i, H) * W + x];
  } else {
    for (int c = 0; c < 32; ++c) {
      const float* row = src + (size_t)reflect(q0 + c, H) * W;
      for (int i = lane; i < rows; i += 32)
        buf[(1 + i) * kStride + c] = row[reflect(p0 - before + i, W)];
    }
  }
  __syncwarp();

  // this lane's run: the first window's r values by insertion (NaN as +inf)
  int nans = 0;  // NaNs in this lane's run
  for (int i = 0; i < r; ++i) {
    float v = buf[(1 + i) * kStride + lane];
    if (v != v) {
      ++nans;
      v = inf;
    }
    int j = i;
    for (; j > 0; --j) {
      const float u = run[32 * (j - 1)];
      if (u <= v) break;
      run[32 * j] = u;
    }
    run[32 * j] = v;
  }

  bool had_nan = false;
  for (int p = 0; p < steps; ++p) {
    if (p > 0) {  // strip row p leaves the window, row p + r enters
      float gone = buf[p * kStride + lane];
      float come = buf[(p + r) * kStride + lane];
      if (gone != gone) {
        --nans;
        gone = inf;
      }
      if (come != come) {
        ++nans;
        come = inf;
      }
      int a = 0, b = r - 1;  // the first slot not below `gone`: it holds gone
      while (a < b) {
        const int m = (a + b) >> 1;
        if (run[32 * m] < gone) a = m + 1;
        else b = m;
      }
      int j = a;
      if (come > gone) {
        for (; j + 1 < r; ++j) {
          const float u = run[32 * (j + 1)];
          if (u >= come) break;
          run[32 * j] = u;
        }
      } else {
        for (; j > 0; --j) {
          const float u = run[32 * (j - 1)];
          if (u <= come) break;
          run[32 * j] = u;
        }
      }
      run[32 * j] = come;
    }
    __syncwarp();
    const int window_nans = nans + (S == 2 ? __shfl_down_sync(0xffffffffu, nans, 1) : 0);
    float result = 0.f;
    if (lane < outs) {
      float v_lo, v_hi;
      if (S == 1) {
        v_lo = run[32 * lo];
        v_hi = run[32 * hi];
      } else {
        // the union of this run (A) and the next lane's (B): i of its lo
        // smallest come from A (A first on ties), found by merge path
        const float* A = run;
        const float* B = run + 1;
        int a = max(0, lo - r), b = min(lo, r);
        while (a < b) {
          const int m = (a + b) >> 1;
          if (A[32 * m] <= B[32 * (lo - m - 1)]) a = m + 1;
          else b = m;
        }
        int i = a, j = lo - a;
        const bool from_a = i < r && (j >= r || A[32 * i] <= B[32 * j]);
        v_lo = from_a ? A[32 * i] : B[32 * j];
        if (from_a) ++i;
        else ++j;
        v_hi = hi == lo ? v_lo : (i < r && (j >= r || A[32 * i] <= B[32 * j])) ? A[32 * i]
                                                                              : B[32 * j];
      }
      if (window_nans > 0) {
        result = __int_as_float(0x7fc00000);
        had_nan = true;
      } else {
        result = __fadd_rn(__fmul_rn(v_lo, w_lo), __fmul_rn(v_hi, w_hi));
      }
    }
    __syncwarp();  // the next lane has read this run
    buf[p * kStride + lane] = result;  // row p is spent: it left this step
  }
  __syncwarp();

  // write the strip's outputs, row p of the strip for output p0 + p
  if (VERTICAL) {
    if (lane < outs)
      for (int p = 0; p < steps; ++p) dst[(size_t)(p0 + p) * W + q0 + lane] = buf[p * kStride + lane];
  } else {
    for (int c = 0; c < outs; ++c) {
      float* row = dst + (size_t)(q0 + c) * W + p0;
      for (int p = lane; p < steps; p += 32) row[p] = buf[p * kStride + c];
    }
  }
  if (had_nan) atomicOr(error, 1);
}

bool valid(int N, int H, int W, int sh, int sw, int lo, int hi) {
  return N > 0 && H > 0 && W > 0 && sh > 0 && sw > 0 && N <= 65535 &&
         (long long)sh * sw <= (1LL << 30) && 0 <= lo && lo <= hi && hi < sh * sw;
}

struct Geometry {
  int route;
  int tw, th;        // the output tile of a warp (sliding) or of a block (staged, direct)
  int tiles;         // tiles a block: its warps on the sliding route, else 1
  size_t smem;       // dynamic shared memory a block in bytes
  long long blocks;
};

// The launch of `route` for N (H, W) maps and a window (sh, sw) on a card
// whose blocks may have `optin` bytes of shared memory; false when the
// route does not take the window there.
bool route_geometry(int route, int N, int H, int W, int sh, int sw, int optin, Geometry* g) {
  const long long tiles_2d = (long long)((W + TW - 1) / TW) * ((H + TH - 1) / TH) * N;
  switch (route) {
    case kSliding: {
      if (sw > 2 && sh > 2) return false;
      const bool vertical = sw <= 2;
      const int r = vertical ? sh : sw, s = vertical ? sw : sh;
      const int warps = (int)std::min<size_t>(kSlideWarps, (size_t)optin / slide_warp_bytes(r));
      if (warps < 1) return false;
      const int outs = 33 - s;
      const int tw = vertical ? outs : kSlideSteps, th = vertical ? kSlideSteps : outs;
      const long long units = (long long)((W + tw - 1) / tw) * ((H + th - 1) / th) * N;
      *g = {kSliding, tw, th, warps, warps * slide_warp_bytes(r), (units + warps - 1) / warps};
      return true;
    }
    case kStaged:
      if (staged_bytes(sh, sw) > (size_t)optin) return false;
      *g = {kStaged, TW, TH, 1, staged_bytes(sh, sw), tiles_2d};
      return true;
    case kDirect:
      *g = {kDirect, TW, TH, 1, 0, tiles_2d};
      return true;
    default:
      return false;
  }
}

// The route a window takes on `device`: the first of sliding, staged and
// direct that takes it.
cudaError_t geometry(int N, int H, int W, int sh, int sw, int device, Geometry* g) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  for (int route = kSliding; !route_geometry(route, N, H, W, sh, sw, optin, g); --route) {
  }
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= (size_t)kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool VERTICAL, int S>
cudaError_t launch_sliding(const float* src, float* dst, int N, int H, int W, int r, int lo,
                           int hi, float w_lo, float w_hi, int* error, const Geometry& g,
                           cudaStream_t stream) {
  auto kernel = percentile_sliding_kernel<VERTICAL, S>;
  cudaError_t err = allow_smem(kernel, g.smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)g.blocks, 32 * g.tiles, g.smem, stream>>>(src, dst, N, H, W, r, lo, hi,
                                                               w_lo, w_hi, error);
  return cudaGetLastError();
}

}  // namespace

// The launch N (H, W) maps and a window of (sh, sw) take on `device`: the
// route (0 direct, 1 staged, 2 sliding), the output tile (x, y) of a warp
// (sliding) or a block, the tiles a block, its dynamic shared memory in
// bytes and the blocks.
extern "C" int percentile_geometry(int N, int H, int W, int sh, int sw, int device, int* route,
                                   int* tw, int* th, int* tiles, int* smem, long long* blocks) {
  if (N <= 0 || H <= 0 || W <= 0 || sh <= 0 || sw <= 0) return (int)cudaErrorInvalidValue;
  Geometry g;
  cudaError_t err = geometry(N, H, W, sh, sw, device, &g);
  if (err != cudaSuccess) return (int)err;
  *route = g.route;
  *tw = g.tw;
  *th = g.th;
  *tiles = g.tiles;
  *smem = (int)g.smem;
  *blocks = g.blocks;
  return 0;
}

// in, out: (N, H, W) fp32 contiguous on `device`; error: one int32, zeroed
// by the caller, which gets bit 1 when a window held a NaN. lo <= hi <= lo
// + 1 are the 0-based ranks of the two order statistics, w_lo and w_hi
// their weights; route 0 (direct), 1 (staged) or 2 (sliding), which must
// take the window on the card (the wrapper passes the route geometry()
// gives, as its plan mirrors it). Returns a cudaError_t.
extern "C" int percentile_forward(const void* in, void* out, void* error, int N, int H, int W,
                                  int sh, int sw, int lo, int hi, float w_lo, float w_hi,
                                  int route, int device, void* stream) {
  if (!valid(N, H, W, sh, sw, lo, hi) || hi > lo + 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  Geometry g;
  if (!route_geometry(route, N, H, W, sh, sw, optin, &g)) return (int)cudaErrorInvalidValue;
  const float* src = static_cast<const float*>(in);
  float* dst = static_cast<float*>(out);
  int* err_bits = static_cast<int*>(error);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g.route == kSliding) {
    const bool vertical = sw <= 2;
    const int r = vertical ? sh : sw, side = vertical ? sw : sh;
    auto launch = vertical ? (side == 2 ? launch_sliding<true, 2> : launch_sliding<true, 1>)
                           : (side == 2 ? launch_sliding<false, 2> : launch_sliding<false, 1>);
    return (int)launch(src, dst, N, H, W, r, lo, hi, w_lo, w_hi, err_bits, g, s);
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  const dim3 block(TW, TH);
  if (g.route == kDirect) {
    percentile_kernel<false, 0><<<grid, block, 0, s>>>(src, dst, H, W, sh, sw, lo, hi, w_lo,
                                                       w_hi, err_bits);
    return (int)cudaGetLastError();
  }
  auto kernel = sw == 2 ? percentile_kernel<true, 2> : percentile_kernel<true, 0>;
  err = allow_smem(kernel, g.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, block, g.smem, s>>>(src, dst, H, W, sh, sw, lo, hi, w_lo, w_hi, err_bits);
  return (int)cudaGetLastError();
}
