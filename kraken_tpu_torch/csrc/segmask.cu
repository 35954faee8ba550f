// The three kernels of segmentation's reduced heatmap downloads, for Hopper
// (sm_90a).
//
// 1. maxpool20_kernel: scipy.ndimage.maximum_filter(size=20, mode='reflect')
//    of an (M, H, W) fp32 stack. Replaces kraken_tpu/inference/
//    segmentation.py:61 _maxpool20 (an XLA program there): np.pad
//    'symmetric' of (10, 9) on both axes, then a VALID 20 x 20 max window,
//    so output pixel (y, x) is the max over rows y-10..y+9 and columns
//    x-10..x+9, an index outside the map reflected about its edges with the
//    edge repeated. The reflection is index arithmetic, periodic over 2n,
//    so it holds for maps shorter or narrower than the pad (np.pad repeats
//    the reflection there).
//
//    What bounds it: bytes, the map read once and the filtered map written
//    once (0.0107 ms at the full-size spec's two 1800 x 1245 maps).
//
//    Design: the van Herk / Gil-Werman running max, so a pixel's work does
//    not grow with the window. An axis cut into segments of 20 gives each
//    window of 20 as one segment's suffix max and the next one's prefix
//    max: about three max a pixel an axis. A block of 160 threads takes an
//    output tile of 141 columns and 20 rows (one segment). Vertical pass, in
//    registers: a thread takes one of the tile's 160 input columns (the
//    141 and the 19 of the window's halo) and issues the loads of its 39
//    rows at once (one memory latency; coalesced across the warp, each
//    pixel loaded once): the suffix maxima of the first 20, then the
//    running prefix of the next 19, each output row the max of one of each,
//    into shared memory. Horizontal pass: a thread takes one of the 20
//    staged rows' 8 segments of 20 columns and writes their prefix and
//    suffix maxima beside the row (a staged row on its own bank: no
//    conflicts); then a thread takes an output column down the 20 rows,
//    each output the max of one suffix and one prefix, each row's store
//    coalesced. The reflection is computed only in tiles within 10 pixels
//    of an edge: there the strip's 39 row indices are one table in shared
//    memory, and each thread reflects its one column once; an interior
//    tile indexes directly. A NaN propagates (a compare and a select: the
//    NaN is kept once seen, as XLA's max and torch.amax keep it). Max is
//    exact, so the kernel equals its plain version (and the JAX program)
//    bit for bit, but for which zero a tie of -0.0 and +0.0 gives: the
//    order of the max differs (the plain version's and XLA's differ too),
//    so the two are compared as values there.
//
// 2. pack_masks_kernel: the decision masks of heatmap_precision='packbits',
//    bit-packed. Replaces kraken_tpu/inference/segmentation.py:173-185 (the
//    thresholds) and :71 _packbits_w. Plane k of the (N, K, H, ceil(W/8))
//    output is, for k < nr, probs[:, regions[k]] > 0.5; then diff > 0.2 and
//    diff < -0.2 with diff = filt[:, 0] - filt[:, 1] (the two max-filtered
//    separator maps); then the ridge kernel's masks (nonzero = set). Eight
//    pixels a byte, the first in the most significant bit, pad bits 0 (what
//    np.unpackbits(axis=-1) reverses). The comparisons are in fp32 against
//    the fp32 constants (the JAX constants are weakly typed, so XLA rounds
//    them to fp32 too), the difference rounded on its own (no FMA can
//    occur). Any number of region channels: their indices are an int32
//    table in device memory.
//
//    Design: the planes are independent but for the two separator planes,
//    which share their inputs; so the grid's y axis is a task (a region
//    plane, the separator pair, a ridge plane) and its x axis the tiles of
//    a map, 8 runs of 32 pixels of 2 rows (a 1 KB span of each fp32 row):
//    a warp a tile, a lane a pixel of each run, its 16 loads unconditional
//    (a lane past W reads its row's last pixel, a row past H the last row),
//    so they issue back to back and wait once, and the blocks in flight
//    stream one or two maps at a time. For each run the warp makes one
//    coalesced 128-byte load (32 bytes for a ridge mask) and one
//    __ballot_sync of the compare; lane 4 q + j takes run q's ballot,
//    __brev puts the run's first pixel in the top bit and
//    __byte_perm(.., 0x0123) swaps the bytes into memory order, and the lane
//    stores byte j of it: one store of 32 contiguous bytes a row (an output
//    row is ceil(W/8) bytes, so a run's 4 bytes start on a word only where
//    the row allows; bytes take every offset). Lanes past W vote 0, which
//    makes the pad bits. The separator task reads both filtered maps once a
//    pixel and makes both planes from that one read, with two ballots.
//    The warp's task and page come from the grid, its rows and runs from
//    one 32-bit division a warp; offsets within a map are 32-bit, a
//    plane's base 64-bit (no 64-bit division: the grid-stride loop of a
//    thread a byte paid three 64-bit div/mod pairs a byte). A region
//    task's channel is one load from the int32 table.
//
// 3. quantize_u8_kernel: heatmap_precision='uint8', round(p * 255) to
//    uint8, half to even (rintf in the default rounding mode, as jnp.round
//    and torch.round), the product rounded to fp32 first, saturated to
//    [0, 255] (XLA's conversion; the sigmoid never leaves it). Replaces
//    kraken_tpu/inference/segmentation.py:196. A thread four elements.
//
// What bounds them on the H100: bytes. Each reads its inputs once (the max
// filter's tiles re-read their halo, 19 rows and 19 columns, from L2) and
// writes its output once; a pixel costs a few comparisons.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWin = 20;                          // window side, and the segment's
constexpr int kBefore = 10;                       // scipy's origin-0 anchor: 10 before, 9 after
constexpr int kPoolThreads = 160;                 // a max-filter block: its input columns
constexpr int kPoolOut = kPoolThreads - kWin + 1;  // output columns of a tile (141)
constexpr int kStrip = kWin;                      // output rows of a tile: one segment
constexpr int kSegs = kPoolThreads / kWin;        // segments of a staged row (8)
constexpr int kPitch = kPoolThreads + 1;          // staged row pitch: odd, rows on distinct banks
constexpr int kStripRows = kStrip + kWin - 1;     // input rows of a tile (39)
static_assert(kPoolThreads % kWin == 0 && kStrip * kSegs == kPoolThreads,
              "a horizontal segment a thread");
constexpr int kPackWarps = 4;                     // a pack block: warps, a tile each
constexpr int kPackThreads = kPackWarps * 32;
constexpr int kPackRuns = 8;                      // a tile: 8 runs of 32 pixels of a row...
constexpr int kPackRows = 2;                      // ... in 2 rows
static_assert(4 * kPackRuns <= 32, "a lane an output byte of a tile's row");
constexpr int kQuantThreads = 256;

// np.pad(mode='symmetric') index: periodic over 2n, the second half mirrored.
__device__ __forceinline__ int reflect(int i, int n) {
  const int p = 2 * n;
  int m = i % p;
  if (m < 0) m += p;
  return m < n ? m : p - 1 - m;
}

// max that keeps a NaN once seen (XLA's max, torch.amax)
__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

// The vertical pass of a thread's column `col`: its 39 input rows (row p
// of the tile at y_top + p, or s_rows[p] in a strip by an edge), each
// loaded once; output row k of the strip is the max of rows k..k+19, the
// suffix max of the first segment at k and the prefix max of the second
// up to k - 1.
template <bool kEdgeRows>
__device__ __forceinline__ void pool_column(const float* __restrict__ src, int W, int col,
                                            int y_top, const int* s_rows,
                                            float (*s_v)[kPitch], int u) {
  const auto at = [&](int p) {
    const int r = kEdgeRows ? s_rows[p] : y_top + p;
    return __ldg(src + (long long)r * W + col);
  };
  // every load issued before the first max: one memory latency a column
  float h[kWin], a[kWin - 1];
#pragma unroll
  for (int k = 0; k < kWin; ++k) h[k] = at(k);
#pragma unroll
  for (int k = 0; k < kWin - 1; ++k) a[k] = at(kWin + k);
#pragma unroll
  for (int k = kWin - 2; k >= 0; --k) h[k] = nan_max(h[k + 1], h[k]);
  s_v[0][u] = h[0];
  float g = a[0];
#pragma unroll
  for (int k = 1; k < kWin; ++k) {
    s_v[k][u] = nan_max(h[k], g);
    if (k < kWin - 1) g = nan_max(g, a[k]);
  }
}

__global__ void __launch_bounds__(kPoolThreads)
    maxpool20_kernel(const float* __restrict__ x, float* __restrict__ y, int H, int W) {
  __shared__ float s_v[kStrip][kPitch];  // vertical maxima, then their segments' suffix maxima
  __shared__ float s_g[kStrip][kPitch];  // the segments' prefix maxima
  __shared__ int s_rows[kStripRows];
  const int x0 = blockIdx.x * kPoolOut, y0 = blockIdx.y * kStrip;
  const long long plane = (long long)blockIdx.z * H * W;
  const float* src = x + plane;
  const int u = threadIdx.x;
  const int y_top = y0 - kBefore, x_left = x0 - kBefore;
  const int gx = x_left + u;
  const int col = x_left < 0 || x_left + kPoolThreads > W ? reflect(gx, W) : gx;
  if (y_top < 0 || y_top + kStripRows > H) {
    if (u < kStripRows) s_rows[u] = reflect(y_top + u, H);
    __syncthreads();
    pool_column<true>(src, W, col, y_top, s_rows, s_v, u);
  } else {
    pool_column<false>(src, W, col, y_top, s_rows, s_v, u);
  }
  __syncthreads();
  {
    const int r = u % kStrip, c0 = (u / kStrip) * kWin;
    float v[kWin];
#pragma unroll
    for (int j = 0; j < kWin; ++j) v[j] = s_v[r][c0 + j];
    float m = v[0];
    s_g[r][c0] = m;
#pragma unroll
    for (int j = 1; j < kWin; ++j) {
      m = nan_max(m, v[j]);
      s_g[r][c0 + j] = m;
    }
    m = v[kWin - 1];
#pragma unroll
    for (int j = kWin - 2; j >= 0; --j) {
      m = nan_max(m, v[j]);
      s_v[r][c0 + j] = m;
    }
  }
  __syncthreads();
  // a thread an output column down the strip: each row's store coalesced
  if (u < kPoolOut && x0 + u < W) {
    float* dst = y + plane + (long long)y0 * W + x0 + u;
#pragma unroll
    for (int r = 0; r < kStrip; ++r) {
      if (y0 + r < H) dst[(long long)r * W] = nan_max(s_v[r][u], s_g[r][u + kWin - 1]);
    }
  }
}

// A row of a warp's tile: lane 4 q + j takes the ballot of run q (bit i =
// pixel i of the run) and stores byte j of it at `dst` where `st`:
// __brev puts the run's first pixel in the top bit, __byte_perm(.., 0x0123)
// swaps the bytes into memory order.
__device__ __forceinline__ void store_row(uint8_t* __restrict__ dst, bool st, int lane,
                                          const unsigned (&bits)[kPackRuns]) {
  const int q = lane >> 2;
  unsigned b = bits[0];
#pragma unroll
  for (int k = 1; k < kPackRuns; ++k) b = q == k ? bits[k] : b;
  const unsigned word = __byte_perm(__brev(b), 0, 0x0123);  // byte j: output byte j of the run
  if (st) *dst = (uint8_t)(word >> (8 * (lane & 3)));
}

// The tile's pixels: `row[i]` the offset of its row i in a map (a row past
// H is the last row again), `col[q]` lane's pixel of run q in a row (a lane
// past W takes the row's last pixel); loads unconditional, so all of them
// issue back to back and wait once.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, const int (&row)[kPackRows],
                                          const int (&col)[kPackRuns],
                                          T (&v)[kPackRows][kPackRuns]) {
#pragma unroll
  for (int i = 0; i < kPackRows; ++i) {
#pragma unroll
    for (int q = 0; q < kPackRuns; ++q) v[i][q] = __ldg(src + row[i] + col[q]);
  }
}

// grid: (tiles of a map, tasks, pages). Task k < nr is region plane k, task
// nr the two separator planes, task nr + 1 + j ridge plane nr + 2 + j.
__global__ void __launch_bounds__(kPackThreads)
    pack_masks_kernel(const float* __restrict__ probs, const int* __restrict__ regions, int nr,
                      int C, const float* __restrict__ filt, const uint8_t* __restrict__ ridge,
                      int nb, uint8_t* __restrict__ out, int H, int W, int W8, int strips,
                      int tiles) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kPackWarps + (threadIdx.x >> 5);  // the warp's tile of the map
  if (w >= tiles) return;                                      // the whole warp
  const int task = blockIdx.y, n = blockIdx.z;
  const int g = w / strips;                                    // the tile's rows ...
  const int s = w - g * strips;                                // ... and its runs
  const int y0 = g * kPackRows, x0 = s * kPackRuns * 32;
  const int hw = H * W;
  int row[kPackRows], col[kPackRuns];
  bool in[kPackRuns];
#pragma unroll
  for (int i = 0; i < kPackRows; ++i) row[i] = min(y0 + i, H - 1) * W;
#pragma unroll
  for (int q = 0; q < kPackRuns; ++q) {
    const int x = x0 + q * 32 + lane;
    in[q] = x < W;
    col[q] = min(x, W - 1);
  }
  // lane 4 q + j stores byte j of run q of each of the tile's rows
  const int xb = s * kPackRuns * 4 + lane;
  const bool st = lane < 4 * kPackRuns && xb < W8;
  const size_t plane = (size_t)H * W8;
  uint8_t* const o = out + (size_t)n * (nr + 2 + nb) * plane + (size_t)y0 * W8 + xb;
  if (task == nr) {
    // the separator maps, each read once: both their planes come from it
    const float* f = filt + (size_t)n * 2 * hw;
    float a[kPackRows][kPackRuns], b[kPackRows][kPackRuns];
    load_tile(f, row, col, a);
    load_tile(f + hw, row, col, b);
#pragma unroll
    for (int i = 0; i < kPackRows; ++i) {
      unsigned above[kPackRuns], below[kPackRuns];
#pragma unroll
      for (int q = 0; q < kPackRuns; ++q) {
        const float d = __fsub_rn(a[i][q], b[i][q]);
        above[q] = __ballot_sync(~0u, in[q] && d > 0.2f);
        below[q] = __ballot_sync(~0u, in[q] && d < -0.2f);
      }
      const bool here = st && y0 + i < H;
      store_row(o + nr * plane + (size_t)i * W8, here, lane, above);
      store_row(o + (nr + 1) * plane + (size_t)i * W8, here, lane, below);
    }
  } else if (task < nr) {
    const float* src = probs + ((size_t)n * C + __ldg(regions + task)) * hw;
    float v[kPackRows][kPackRuns];
    load_tile(src, row, col, v);
#pragma unroll
    for (int i = 0; i < kPackRows; ++i) {
      unsigned bits[kPackRuns];
#pragma unroll
      for (int q = 0; q < kPackRuns; ++q) bits[q] = __ballot_sync(~0u, in[q] && v[i][q] > 0.5f);
      store_row(o + task * plane + (size_t)i * W8, st && y0 + i < H, lane, bits);
    }
  } else {
    const int j = task - nr - 1;
    const uint8_t* src = ridge + ((size_t)n * nb + j) * hw;
    uint8_t v[kPackRows][kPackRuns];
    load_tile(src, row, col, v);
#pragma unroll
    for (int i = 0; i < kPackRows; ++i) {
      unsigned bits[kPackRuns];
#pragma unroll
      for (int q = 0; q < kPackRuns; ++q) bits[q] = __ballot_sync(~0u, in[q] && v[i][q] != 0);
      store_row(o + (nr + 2 + j) * plane + (size_t)i * W8, st && y0 + i < H, lane, bits);
    }
  }
}

// values outside [0, 255] saturate, as XLA's conversion and the plain version
__device__ __forceinline__ uint8_t quant(float p) {
  return (uint8_t)fminf(fmaxf(rintf(__fmul_rn(p, 255.f)), 0.f), 255.f);
}

__global__ void __launch_bounds__(kQuantThreads)
    quantize_u8_kernel(const float* __restrict__ p, uint8_t* __restrict__ q, long long n) {
  const long long n4 = n / 4;
  const float4* p4 = reinterpret_cast<const float4*>(p);
  uchar4* q4 = reinterpret_cast<uchar4*>(q);
  for (long long i = (long long)blockIdx.x * kQuantThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kQuantThreads) {
    const float4 v = __ldg(p4 + i);
    q4[i] = make_uchar4(quant(v.x), quant(v.y), quant(v.z), quant(v.w));
  }
  const long long tail = n4 * 4 + (long long)blockIdx.x * kQuantThreads + threadIdx.x;
  if (tail < n) q[tail] = quant(__ldg(p + tail));
}

int blocks_for(long long work, int threads) {
  long long b = (work + threads - 1) / threads;
  const long long most = 132LL * 16;  // enough blocks to fill the card; the rest loop
  if (b > most) b = most;
  return (int)(b < 1 ? 1 : b);
}

}  // namespace

// x, y: (M, H, W) fp32, contiguous on `device`.
extern "C" int maxpool20_forward(const void* x, void* y, int M, int H, int W, int device,
                                 void* stream) {
  if (M <= 0 || M > 65535 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((W + kPoolOut - 1) / kPoolOut, (H + kStrip - 1) / kStrip, M);
  if (blocks.y > 65535) return (int)cudaErrorInvalidValue;
  maxpool20_kernel<<<blocks, kPoolThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(x),
                                                          static_cast<float*>(y), H, W);
  return (int)cudaGetLastError();
}

// probs (N, C, H, W) fp32; regions: nr int32 channel indices, each in
// 0..C-1 (the caller checks), in device memory (unread when nr == 0); filt
// (N, 2, H, W) fp32; ridge (N, nb, H, W) uint8 (unused when nb == 0); out
// (N, nr + 2 + nb, H, ceil(W / 8)) uint8. All contiguous on `device`.
extern "C" int pack_masks_forward(const void* probs, const void* regions, int nr, int C,
                                  const void* filt, const void* ridge, int nb, void* out, int N,
                                  int H, int W, int device, void* stream) {
  if (N <= 0 || N > 65535 || H <= 0 || W <= 0 || nr < 0 || nb < 0 || C <= 0
      || (nr > 0 && regions == nullptr) || (long long)nr + 1 + nb > 65535
      || (long long)H * W > (1LL << 31) - 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int W8 = (W + 7) / 8, strips = (W + kPackRuns * 32 - 1) / (kPackRuns * 32);
  const long long tiles = (long long)((H + kPackRows - 1) / kPackRows) * strips;
  if (tiles > (1LL << 31) - 1 - kPackWarps) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((unsigned)((tiles + kPackWarps - 1) / kPackWarps), (unsigned)(nr + 1 + nb),
                    (unsigned)N);
  pack_masks_kernel<<<blocks, kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(probs), static_cast<const int*>(regions), nr, C,
      static_cast<const float*>(filt), static_cast<const uint8_t*>(ridge), nb,
      static_cast<uint8_t*>(out), H, W, W8, strips, (int)tiles);
  return (int)cudaGetLastError();
}

// p: n fp32, q: n uint8, contiguous on `device`, p 16-byte aligned.
extern "C" int quantize_u8_forward(const void* p, void* q, long long n, int device, void* stream) {
  if (n <= 0 || (reinterpret_cast<uintptr_t>(p) & 15) || (reinterpret_cast<uintptr_t>(q) & 3)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  quantize_u8_kernel<<<blocks_for(n / 4 + 1, kQuantThreads), kQuantThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(p),
                                                            static_cast<uint8_t*>(q), n);
  return (int)cudaGetLastError();
}
