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
// values the kernel takes the lo-th and hi-th smallest (0-based) and
// writes v_lo * w_lo + v_hi * w_hi, each product and the sum rounded once
// (__fmul_rn, __fadd_rn: no FMA is contracted), which is jnp.percentile's
// 'linear' method when the wrapper computes lo, hi and the weights as JAX
// does (ops/binarize.py:_ranks). The result is then exactly the plain
// version's (ops/binarize.py:window_percentile_reference).
//
// The selection counts ranks: value v of the window is the r-th smallest
// for every r in [less, less + equal), where less and equal count the
// window's values below and equal to v. That is right for ties and for any
// window, with no sort and no register array whose size depends on n. A
// window with a NaN has no rank; the kernel writes NaN there and sets bit
// 1 of `error`, which the wrapper reads once after the launch and raises
// on (the plain version's caller checks the same on the CPU).
//
// What bounds it on the H100: the least work is one read of the map and one
// write of the result (8 bytes a pixel), against at least n + min(k, n - k + 1)
// - 2 comparisons a pixel to select an order statistic (Hyafil's bound; 47
// for n = 40): bytes, 0.0065 ms a pass at the fixture page's zoomed
// 1982 x 1371. This kernel is the simple one: n^2 comparisons a pixel
// (1,600 at n = 40), each a shared-memory load, two compares and two adds.
//   - A block takes a TW x TH = 32 x 8 output tile, a thread a pixel, and
//     stages the tile with its reflect halo ((TH + sh - 1) x (TW + sw - 1)
//     floats: 3.6 KB for (20, 2), 1.8 KB for (2, 20)) in shared memory, a
//     warp on consecutive addresses of a row. A warp's lanes then read
//     consecutive words of one row at every step of the count: no bank
//     conflict.
//   - The window's columns are a template constant where sw == 2 (the
//     first of nlbin's two passes), so that loop unrolls; with sw a
//     runtime 2 the pass took 2.83 ms against 1.30 for (2, 20) on an H100.
//   - A window whose tile and halo exceed the card's shared memory a block
//     (a range of over ~1,700 for (range, 2)) is read straight from device
//     memory through the reflect indices instead ("direct"); every range
//     the CLI takes runs on the kernel.
// Later work (not done): the two passes fused into one launch, a sorting
// network in registers for n <= 64, a selection that reuses the window of
// the pixel before (a sliding histogram).
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;
constexpr int TH = 8;
constexpr int kStaticSmem = 48 * 1024;

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

bool valid(int N, int H, int W, int sh, int sw, int lo, int hi) {
  return N > 0 && H > 0 && W > 0 && sh > 0 && sw > 0 && N <= 65535 &&
         (long long)sh * sw <= (1LL << 30) && 0 <= lo && lo <= hi && hi < sh * sw;
}

// The route a window takes on `device`: staged in shared memory when its
// tile and halo fit a block, else direct; and the dynamic shared memory.
cudaError_t route(int sh, int sw, int device, bool* staged, size_t* smem) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t bytes = staged_bytes(sh, sw);
  *staged = bytes <= (size_t)optin;
  *smem = *staged ? bytes : 0;
  return cudaSuccess;
}

}  // namespace

// The launch a window of (sh, sw) takes on `device`: staged (1) or direct
// (0), its dynamic shared memory in bytes, and the output tile.
extern "C" int percentile_geometry(int sh, int sw, int device, int* staged, int* smem, int* tw,
                                   int* th) {
  if (sh <= 0 || sw <= 0) return (int)cudaErrorInvalidValue;
  bool s;
  size_t bytes;
  cudaError_t err = route(sh, sw, device, &s, &bytes);
  if (err != cudaSuccess) return (int)err;
  *staged = s ? 1 : 0;
  *smem = (int)bytes;
  *tw = TW;
  *th = TH;
  return 0;
}

// in, out: (N, H, W) fp32 contiguous on `device`; error: one int32, zeroed
// by the caller, which gets bit 1 when a window held a NaN. lo <= hi are
// the 0-based ranks of the two order statistics, w_lo and w_hi their
// weights. Returns a cudaError_t.
extern "C" int percentile_forward(const void* in, void* out, void* error, int N, int H, int W,
                                  int sh, int sw, int lo, int hi, float w_lo, float w_hi,
                                  int device, void* stream) {
  if (!valid(N, H, W, sh, sw, lo, hi)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  bool staged;
  size_t smem;
  err = route(sh, sw, device, &staged, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  const dim3 block(TW, TH);
  const float* src = static_cast<const float*>(in);
  float* dst = static_cast<float*>(out);
  int* err_bits = static_cast<int*>(error);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!staged) {
    percentile_kernel<false, 0><<<grid, block, 0, s>>>(src, dst, H, W, sh, sw, lo, hi, w_lo,
                                                       w_hi, err_bits);
    return (int)cudaGetLastError();
  }
  auto kernel = sw == 2 ? percentile_kernel<true, 2> : percentile_kernel<true, 0>;
  if (smem > (size_t)kStaticSmem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, block, smem, s>>>(src, dst, H, W, sh, sw, lo, hi, w_lo, w_hi, err_bits);
  return (int)cudaGetLastError();
}
