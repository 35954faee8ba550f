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
//    occur). A thread an output byte.
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
constexpr int kPackThreads = 256;
constexpr int kQuantThreads = 256;
constexpr int kMaxRegions = 64;

struct Regions {
  int c[kMaxRegions];
};

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

__global__ void __launch_bounds__(kPackThreads)
    pack_masks_kernel(const float* __restrict__ probs, Regions regions, int nr, int C,
                      const float* __restrict__ filt, const uint8_t* __restrict__ ridge, int nb,
                      uint8_t* __restrict__ out, int N, int H, int W, int W8) {
  const int K = nr + 2 + nb;
  const long long total = (long long)N * K * H * W8;
  const long long hw = (long long)H * W;
  for (long long i = (long long)blockIdx.x * kPackThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kPackThreads) {
    const int xb = (int)(i % W8);
    long long t = i / W8;
    const int yy = (int)(t % H);
    t /= H;
    const int k = (int)(t % K);
    const int n = (int)(t / K);
    const int xs = xb * 8;
    const int cnt = W - xs < 8 ? W - xs : 8;
    const long long pix = (long long)yy * W + xs;
    unsigned byte = 0;
    if (k < nr) {
      const float* p = probs + ((long long)n * C + regions.c[k]) * hw + pix;
      for (int j = 0; j < cnt; ++j) byte |= (unsigned)(__ldg(p + j) > 0.5f) << (7 - j);
    } else if (k < nr + 2) {
      const float* a = filt + (long long)n * 2 * hw + pix;
      const float* b = a + hw;
      for (int j = 0; j < cnt; ++j) {
        const float d = __fsub_rn(__ldg(a + j), __ldg(b + j));
        const bool set = k == nr ? d > 0.2f : d < -0.2f;
        byte |= (unsigned)set << (7 - j);
      }
    } else {
      const uint8_t* m = ridge + ((long long)n * nb + (k - nr - 2)) * hw + pix;
      for (int j = 0; j < cnt; ++j) byte |= (unsigned)(__ldg(m + j) != 0) << (7 - j);
    }
    out[i] = (uint8_t)byte;
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

// probs (N, C, H, W) fp32; regions: nr channel indices < C; filt (N, 2, H, W)
// fp32; ridge (N, nb, H, W) uint8 (unused when nb == 0); out (N, nr + 2 +
// nb, H, ceil(W / 8)) uint8. All contiguous on `device`.
extern "C" int pack_masks_forward(const void* probs, const int* regions, int nr, int C,
                                  const void* filt, const void* ridge, int nb, void* out, int N,
                                  int H, int W, int device, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || nr < 0 || nr > kMaxRegions || nb < 0 || C <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Regions r = {};
  for (int k = 0; k < nr; ++k) {
    if (regions[k] < 0 || regions[k] >= C) return (int)cudaErrorInvalidValue;
    r.c[k] = regions[k];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int W8 = (W + 7) / 8;
  const long long total = (long long)N * (nr + 2 + nb) * H * W8;
  pack_masks_kernel<<<blocks_for(total, kPackThreads), kPackThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(probs), r, nr, C, static_cast<const float*>(filt),
      static_cast<const uint8_t*>(ridge), nb, static_cast<uint8_t*>(out), N, H, W, W8);
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
