// Padding-aware GroupNorm, for Hopper (sm_90a).
//
// Replaces kraken_tpu/nn/layers.py:GroupNorm.apply, the normalisation of
// every shipped segmentation model (an XLA program in the JAX package).
// For each sample n and group g of C/G channels, the mean and variance are
// taken over the valid columns only, w < L = clamp(len[n], 1, W) (all W
// columns when no lengths are given); then
//   y = (x - mean) * rsqrt(var + eps) * weight[c] + bias[c]   for w < L,
//   y = 0                                                      for w >= L,
// with the math in fp32 and the output in the input's type (fp32, bf16 or
// fp16). var is the population variance.
//
// What bounds it on the H100: bytes. Each element needs one read and one
// write, a handful of flops each; at the full-size segmentation spec a
// forward moves 107.8 M elements through four such layers, 0.86 GB at one
// read and one write each (about 0.26 ms at 3.35 TB/s). The statistics of
// a group must be complete before any of its elements can be written, so
// either the group stays on chip between the two, or it is read twice.
// The activations come after a ReLU and have a mean about as large as their
// spread, so a naive sum and sum of squares loses digits: statistics are
// (count, mean, M2) triples merged with Chan's formula, in a fixed order
// (no float atomics: the same bits from run to run).
//
// Two designs, picked per call by the wrapper (ops/groupnorm.py:_design)
// from the shapes alone:
//
// "cluster" (groupnorm_cluster_kernel), one launch, every group whose
//   elements fit the shared memory of a thread-block cluster (every layer
//   of the shipped model): one cluster of CL CTAs (8, or 16 as a
//   non-portable size) per (sample, group). CTA j takes rows
//   [j*rows/CL, (j+1)*rows/CL) of the group's Cg*H rows, a contiguous
//   slice of x, and copies it into its shared memory in x's own type with
//   bulk copies (cp.async.bulk, counted on an mbarrier; the slice's
//   unaligned first and last elements are loaded by threads). Everything
//   after that runs on 16-byte units of shared memory (4 fp32 or 8 bf16
//   elements a load), the column of each element kept by counting, not
//   dividing. The statistics take two passes over shared memory: the CTA's
//   sum and count of valid elements (a fixed-order tree over its threads),
//   then the squared deviations from the CTA's mean; so each CTA has an
//   exact (count, mean, M2) triple. After one cluster barrier, one warp of
//   every CTA reads the CL triples through distributed shared memory and
//   merges them in a fixed tree order: every CTA computes the same (mean,
//   M2, count). Each CTA then normalises its slice from shared memory,
//   applies the affine, zeroes the columns >= L and writes it with 16-byte
//   stores. x is read from device memory once; there is no scratch buffer.
//   (A first version kept a triple per thread, walked rows with scalar
//   loads and merged the triples one by one: it was slower than the
//   two-launch design at every shipped shape, chip_smoke.py on an H100.)
//
// "stream" (unchanged from the first port), two launches, for groups that
//   do not fit a cluster (the 64- and 256-channel layers of the full-size
//   spec): every group is split over S blocks of whole rows (the wrapper
//   picks S so that the launch has about 8 blocks per SM); launch 1
//   (groupnorm_stats_kernel) writes the S partial triples of every group,
//   launch 2 (groupnorm_apply_kernel) runs on the same grid: each block
//   first merges its group's S triples (one warp, a fixed order), then
//   normalises its rows, reading x a second time. Per-element Welford
//   updates keep the triples exact over a block's many elements. A warp
//   walks one row at a time, lanes on neighbouring columns, so every load
//   and store is coalesced and a ragged row end idles at most one
//   iteration of the warp.
//
// Training: given a `stats` buffer either design also writes each (sample,
// group)'s mean and rstd; groupnorm_backward (two launches on the stream
// design's grids, see "backward" below) gives the gradient.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_f(const __half* p) { return __half2float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_f(__half* p, float v) { *p = __float2half_rn(v); }

struct Stats {
  float n, mean, m2;
};

// Chan et al.'s merge of two (count, mean, M2) triples; either may be empty.
__device__ __forceinline__ Stats merge(const Stats a, const Stats b) {
  const float n = a.n + b.n;
  if (n == 0.f) return a;
  const float d = b.mean - a.mean;
  const float fb = b.n / n;
  return Stats{n, a.mean + d * fb, a.m2 + b.m2 + d * d * a.n * fb};
}

__device__ __forceinline__ Stats warp_merge(Stats s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Stats o{__shfl_down_sync(0xffffffffu, s.n, off), __shfl_down_sync(0xffffffffu, s.mean, off),
                  __shfl_down_sync(0xffffffffu, s.m2, off)};
    s = merge(s, o);
  }
  return s;
}

__device__ __forceinline__ int valid_cols(const int* lens, int n, int W) {
  return lens ? min(max(lens[n], 1), W) : W;
}

// ------------------------------------------------------------------- stream

// grid (S, N*G). Block b of group ng takes rows [b*rows_per_block, ...) of
// the group's Cg*H rows of W columns (contiguous in NCHW).
template <typename T>
__global__ void __launch_bounds__(kThreads) groupnorm_stats_kernel(
    const T* __restrict__ x, const int* __restrict__ lens, float* __restrict__ partial, int G,
    int rows, int W, int rows_per_block) {
  const int ng = blockIdx.y;
  const int L = valid_cols(lens, ng / G, W);
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, rows);
  const T* base = x + (size_t)ng * rows * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Stats s{0.f, 0.f, 0.f};
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const T* row = base + (size_t)r * W;
    for (int c = lane; c < L; c += 32) {
      const float v = load_f(row + c);
      s.n += 1.f;
      const float d = v - s.mean;
      s.mean += d / s.n;
      s.m2 += d * (v - s.mean);
    }
  }
  s = warp_merge(s);
  __shared__ Stats warp_stats[kWarps];
  if (lane == 0) warp_stats[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    Stats t = warp_stats[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t = merge(t, warp_stats[w]);
    float* p = partial + ((size_t)ng * gridDim.x + blockIdx.x) * 3;
    p[0] = t.n;
    p[1] = t.mean;
    p[2] = t.m2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) groupnorm_apply_kernel(
    const T* __restrict__ x, const int* __restrict__ lens, const float* __restrict__ partial,
    const float* __restrict__ weight, const float* __restrict__ bias, T* __restrict__ y,
    float* __restrict__ stats, int G, int Cg, int H, int W, int rows_per_block, float eps) {
  const int ng = blockIdx.y;
  const int L = valid_cols(lens, ng / G, W);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __shared__ float s_mean, s_rstd;
  if (warp == 0) {
    const int S = gridDim.x;
    const float* p = partial + (size_t)ng * S * 3;
    Stats s{0.f, 0.f, 0.f};
    for (int i = lane; i < S; i += 32) s = merge(s, Stats{p[3 * i], p[3 * i + 1], p[3 * i + 2]});
    s = warp_merge(s);
    if (lane == 0) {
      s_mean = s.mean;
      s_rstd = 1.f / sqrtf(s.m2 / s.n + eps);
      if (stats != nullptr && blockIdx.x == 0) {
        stats[2 * ng] = s_mean;
        stats[2 * ng + 1] = s_rstd;
      }
    }
  }
  __syncthreads();
  const float mean = s_mean, rstd = s_rstd;
  const int rows = Cg * H;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, rows);
  const size_t base = (size_t)ng * rows * W;
  const int c0 = (ng % G) * Cg;
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const int c = c0 + r / H;
    const float w = weight[c], b = bias[c];
    const T* xr = x + base + (size_t)r * W;
    T* yr = y + base + (size_t)r * W;
    for (int col = lane; col < W; col += 32) {
      store_f(yr + col, col < L ? (load_f(xr + col) - mean) * rstd * w + b : 0.f);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const int* lens, float* partial, const float* weight,
                   const float* bias, void* y, float* stats, int N, int C, int H, int W, int G, int S,
                   float eps, cudaStream_t stream) {
  const int Cg = C / G;
  const int rows = Cg * H;
  const int rows_per_block = (rows + S - 1) / S;
  const dim3 grid(S, N * G);
  groupnorm_stats_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), lens, partial,
                                                           G, rows, W, rows_per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  groupnorm_apply_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), lens, partial,
                                                           weight, bias, static_cast<T*>(y), stats,
                                                           G, Cg, H, W, rows_per_block, eps);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ cluster

constexpr int kClusterThreads = 512;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr uint32_t kBulkBytes = 16384;  // bytes per bulk copy

__host__ __device__ __forceinline__ int cta_row(int rows, int CL, int rank) {
  return (int)((long long)rank * rows / CL);
}

// Dynamic shared memory of a CTA that holds up to `rows` rows of W elements
// of `es` bytes: the rows from the 16-byte line that holds their first
// element, rounded up to whole 16-byte lines (room for both ragged ends),
// then the weight and bias of each row.
__host__ __device__ __forceinline__ size_t slice_bytes(int rows, int W, int es) {
  return ((size_t)rows * W * es + 32 + 15) / 16 * 16;
}
size_t cluster_smem(int rows, int W, int es) { return slice_bytes(rows, W, es) + 8 * (size_t)rows; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// waits for the bulk copies counted on `bar` (its first phase); a copy that
// never lands traps after ~10 s instead of hanging the card
__device__ __forceinline__ void wait_copies(uint32_t bar) {
  uint64_t start = 0;
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(bar) : "memory");
    if (done) return;
    if ((i & 1023) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (i == 0) start = now;
      else if (now - start > 10000000000ull) __trap();
    }
  }
}

// the 16 bytes at p (16-byte aligned) as 16 / sizeof(T) floats, and back,
// in registers (bit operations, no local copy whose address is taken)
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void store16(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ float lo_f(uint32_t w, const __nv_bfloat16*) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w, const __nv_bfloat16*) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float lo_f(uint32_t w, const __half*) {
  return __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
}
__device__ __forceinline__ float hi_f(uint32_t w, const __half*) {
  return __half2float(__ushort_as_half((unsigned short)(w >> 16)));
}
__device__ __forceinline__ uint32_t bits(float f, const __nv_bfloat16*) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}
__device__ __forceinline__ uint32_t bits(float f, const __half*) {
  return __half_as_ushort(__float2half_rn(f));
}
template <typename T>  // bf16 or fp16: 8 elements, two in each 32-bit word
__device__ __forceinline__ void load16(const T* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = lo_f(w[k], p);
    f[2 * k + 1] = hi_f(w[k], p);
  }
}
template <typename T>
__device__ __forceinline__ void store16(T* p, const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = bits(f[2 * k], p) | (bits(f[2 * k + 1], p) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Row and column (0 <= col < W) of a slice element i, which may be
// negative by less than 16 (the unit before the slice's first element).
struct Cursor {
  int row, col;
  __device__ static Cursor at(int i, int W) {
    const int r = i >= 0 ? i / W : -((W - 1 - i) / W);
    return Cursor{r, i - r * W};
  }
  // moves on by step_r * W + step_c elements (step_c < W)
  __device__ void advance(int step_r, int step_c, int W) {
    row += step_r;
    col += step_c;
    if (col >= W) {
      col -= W;
      ++row;
    }
  }
};

// the sum over the warp of each lane's `v`, the same in every lane
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The sum over the CTA of each thread's `v`, the same in every thread: a
// butterfly across each warp, then the warps' totals in order (fixed
// order: the same bits on every run). `slots` holds kClusterWarps floats.
__device__ __forceinline__ float block_sum(float v, float* slots) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = slots[0];
#pragma unroll
  for (int w = 1; w < kClusterWarps; ++w) t += slots[w];
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kClusterThreads) groupnorm_cluster_kernel(
    const T* __restrict__ x, const int* __restrict__ lens, const float* __restrict__ weight,
    const float* __restrict__ bias, T* __restrict__ y, float* __restrict__ stats, int G, int Cg,
    int H, int W, float eps) {
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int ng = blockIdx.x / CL;
  const int rows = Cg * H;
  const int r0 = cta_row(rows, CL, rank), r1 = cta_row(rows, CL, rank + 1);
  const int my_rows = r1 - r0;
  const int L = valid_cols(lens, ng / G, W);
  const int R = (rows + CL - 1) / CL;  // the most rows a CTA of the cluster takes

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  float* row_w = reinterpret_cast<float*>(smem_raw + slice_bytes(R, W, sizeof(T)));  // [R]
  float* row_b = row_w + R;                                                           // [R]
  __shared__ uint64_t bar;
  __shared__ float slots[3][kClusterWarps];
  __shared__ Stats cta_stats;
  __shared__ float s_mean, s_rstd;

  // the slice [e0, e1) of x; x + e is 16-byte aligned where (xo + e) % V == 0,
  // and shared element i holds x[a0 + i], a0 the first element of e0's line
  constexpr int V = 16 / sizeof(T);
  const long long e0 = ((long long)ng * rows + r0) * W, e1 = ((long long)ng * rows + r1) * W;
  const long long xo = (long long)((reinterpret_cast<uintptr_t>(x) / sizeof(T)) % V);
  const long long a0 = (e0 + xo) / V * V - xo;
  const long long m0 = a0 < e0 ? a0 + V : a0;     // the aligned middle [m0, m1)
  const long long m1 = (e1 + xo) / V * V - xo;
  const bool bulk = m1 > m0;

  if (bulk && threadIdx.x == 0) {
    const uint32_t b = smem_u32(&bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const uint32_t bytes = (uint32_t)((m1 - m0) * sizeof(T));
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(b), "r"(bytes)
                 : "memory");
    const uint32_t dst = smem_u32(xs + (m0 - a0));
    const char* src = reinterpret_cast<const char*>(x + m0);
    for (uint32_t off = 0; off < bytes; off += kBulkBytes) {
      const uint32_t n = bytes - off < kBulkBytes ? bytes - off : kBulkBytes;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          :: "r"(dst + off), "l"(src + off), "r"(n), "r"(b) : "memory");
    }
  }
  // while the copies run: the elements outside the aligned middle (all of
  // them when there is none), and each row's weight and bias
  const long long h1 = bulk ? m0 : e1, t0 = bulk ? m1 : e1;
  for (long long e = e0 + threadIdx.x; e < h1; e += kClusterThreads) xs[e - a0] = x[e];
  for (long long e = t0 + threadIdx.x; e < e1; e += kClusterThreads) xs[e - a0] = x[e];
  const int c0 = (ng % G) * Cg;
  for (int r = threadIdx.x; r < my_rows; r += kClusterThreads) {
    const int c = c0 + (r0 + r) / H;
    row_w[r] = weight[c];
    row_b[r] = bias[c];
  }
  __syncthreads();
  if (bulk) wait_copies(smem_u32(&bar));

  // The slice in 16-byte units of shared memory, unit u holding slice
  // elements i0 = u*V - off0 .. i0 + V-1 (element i: row i / W, column i % W;
  // only unit 0 may start before the slice). A thread takes units
  // threadIdx.x + k*kClusterThreads and keeps the row and column of each
  // unit's first element by adding a fixed step, without dividing.
  // Statistics in two passes over shared memory: the CTA's sum and count of
  // valid elements, then the squared deviations from the CTA's mean.
  const int n_el = my_rows * W;
  const int off0 = (int)(e0 - a0);
  const int units = (off0 + n_el + V - 1) / V;
  const Cursor start = Cursor::at((int)threadIdx.x * V - off0, W);
  const int step_r = kClusterThreads * V / W, step_c = kClusterThreads * V % W;
  float sum = 0.f, cnt = 0.f;
  Cursor at = start;
#pragma unroll 2
  for (int u = threadIdx.x; u < units; u += kClusterThreads, at.advance(step_r, step_c, W)) {
    float v[V];
    load16(xs + u * V, v);
    const int i0 = u * V - off0;
    if (L == W && i0 >= 0 && i0 + V <= n_el) {  // a whole unit of valid elements
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < V; ++q) t += v[q];
      sum += t;
      cnt += (float)V;
      continue;
    }
    int col = at.col;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      if (q > 0 && ++col == W) col = 0;
      if (i0 + q >= 0 && i0 + q < n_el && col < L) {
        sum += v[q];
        cnt += 1.f;
      }
    }
  }
  const float n_cta = block_sum(cnt, slots[0]);
  const float mean_cta = block_sum(sum, slots[1]) / n_cta;
  float m2 = 0.f;
  at = start;
#pragma unroll 2
  for (int u = threadIdx.x; u < units; u += kClusterThreads, at.advance(step_r, step_c, W)) {
    float v[V];
    load16(xs + u * V, v);
    const int i0 = u * V - off0;
    if (L == W && i0 >= 0 && i0 + V <= n_el) {
#pragma unroll
      for (int q = 0; q < V; ++q) m2 += (v[q] - mean_cta) * (v[q] - mean_cta);
      continue;
    }
    int col = at.col;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      if (q > 0 && ++col == W) col = 0;
      const float d = v[q] - mean_cta;
      if (i0 + q >= 0 && i0 + q < n_el && col < L) m2 += d * d;
    }
  }
  const float m2_cta = block_sum(m2, slots[2]);
  if (threadIdx.x == 0) cta_stats = Stats{n_cta, mean_cta, m2_cta};
  // every CTA's triple is written and visible across the cluster; warp 0
  // reads all CL of them at once and merges them in a fixed tree order, the
  // same in every CTA
  cluster.sync();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    Stats t{0.f, 0.f, 0.f};
    if (lane < CL) t = *cluster.map_shared_rank(&cta_stats, lane);
    // Chan's formula over all CL triples at once: n = sum n_i,
    // mean = sum n_i mean_i / n, M2 = sum (M2_i + n_i (mean_i - mean)^2),
    // each sum a butterfly over the warp (a fixed order)
    const float n = warp_sum(t.n);
    const float mean = warp_sum(t.n * t.mean) / n;
    const float d = t.mean - mean;
    const float m2 = warp_sum(t.m2 + t.n * d * d);
    if (lane == 0) {
      s_mean = mean;
      s_rstd = 1.f / sqrtf(m2 / n + eps);
      if (stats != nullptr && rank == 0) {
        stats[2 * ng] = s_mean;
        stats[2 * ng + 1] = s_rstd;
      }
    }
  }
  __syncthreads();
  // this CTA is done reading the others' shared memory; none may exit
  // before every CTA is (the wait below)
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");

  // normalise, affine, zero the columns >= L; 16-byte stores where y's
  // lines fall where x's do (always for a y allocated like x)
  const float mean = s_mean, rstd = s_rstd;
  const bool lined_up = (long long)((reinterpret_cast<uintptr_t>(y) / sizeof(T)) % V) == xo;
  at = start;
#pragma unroll 2
  for (int u = threadIdx.x; u < units; u += kClusterThreads, at.advance(step_r, step_c, W)) {
    float v[V];
    load16(xs + u * V, v);
    const int i0 = u * V - off0;
    const bool whole = i0 >= 0 && i0 + V <= n_el;
    if (whole && at.col + V <= L) {  // valid elements of one row
      const float w = row_w[at.row], b = row_b[at.row];
#pragma unroll
      for (int q = 0; q < V; ++q) v[q] = (v[q] - mean) * rstd * w + b;
    } else {
      int r = at.row, col = at.col;
#pragma unroll
      for (int q = 0; q < V; ++q) {
        if (q > 0 && ++col == W) {
          col = 0;
          ++r;
        }
        const bool in = i0 + q >= 0 && i0 + q < n_el;
        v[q] = in && col < L ? (v[q] - mean) * rstd * row_w[r] + row_b[r] : 0.f;
      }
    }
    T* out = y + (a0 + (long long)u * V);
    if (lined_up && whole) {
      store16(out, v);
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) {
        if (i0 + q >= 0 && i0 + q < n_el) store_f(out + q, v[q]);
      }
    }
  }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Sets up a cluster launch of CL CTAs per group; with y == nullptr it only
// asks how many such clusters the card holds at once (*max_clusters).
template <typename T>
cudaError_t launch_cluster(const void* x, const int* lens, const float* weight, const float* bias,
                           void* y, float* stats, int N, int C, int H, int W, int G, int CL, float eps,
                           cudaStream_t stream, int* max_clusters, size_t* smem_out) {
  auto kernel = groupnorm_cluster_kernel<T>;
  const int Cg = C / G, rows = Cg * H;
  const size_t smem = cluster_smem((rows + CL - 1) / CL, W, (int)sizeof(T));
  *smem_out = smem;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (CL > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N * G * CL);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (y == nullptr) {
    err = cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
    return err;
  }
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), lens, weight, bias,
                            static_cast<T*>(y), stats, G, Cg, H, W, eps);
}

// ----------------------------------------------------------------- backward

// The gradient of the padding-aware GroupNorm (the training path), fp32, in
// two launches on the stream design's grids. With x̂ = (x - mean) * rstd of
// the forward (its mean and rstd per (sample, group), which the forward
// writes when given `stats`), m = [w < L] and dŷ = dy * weight[c] * m:
//   dx = rstd * (dŷ - mean_m(dŷ) - x̂ * mean_m(dŷ * x̂)) * m
// the means over the group's valid elements (count Cg * H * L). Both means
// come from per-(sample, channel) sums A = Σ dy x̂ m and B = Σ dy m:
// mean_m(dŷ x̂) = Σ_c weight[c] A[n, c] / count, mean_m(dŷ) = Σ_c weight[c]
// B[n, c] / count. Launch 1 (groupnorm_bwd_sums_kernel, grid (S1, N*C))
// writes each block's partial (A, B) of its rows of one (n, c) plane;
// launch 2 (groupnorm_bwd_apply_kernel, grid (S2, N*G)) merges its group's
// partials (one warp, a fixed order) and writes dx over its rows, zero at
// the pad columns. The partials also give d weight = Σ_n A and d bias =
// Σ_n B, which the wrapper sums with torch.

__device__ __forceinline__ float block_sum256(float v, float* slots) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = slots[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) t += slots[w];
  return t;
}

// grid (S1, N*C): block s of plane nc takes rows [s*rows_per_block, ...) of
// its H rows; partial[(nc * S1 + s) * 2 + {0, 1}] = (A, B) of those rows
__global__ void __launch_bounds__(kThreads) groupnorm_bwd_sums_kernel(
    const float* __restrict__ x, const float* __restrict__ dy, const int* __restrict__ lens,
    const float* __restrict__ stats, float* __restrict__ partial, int C, int G, int H, int W,
    int rows_per_block) {
  const int nc = blockIdx.y;
  const int n = nc / C, g = (nc % C) / (C / G);
  const int L = valid_cols(lens, n, W);
  const float mean = stats[2 * (n * G + g)], rstd = stats[2 * (n * G + g) + 1];
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, H);
  const size_t base = (size_t)nc * H * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float a = 0.f, b = 0.f;
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const float* xr = x + base + (size_t)r * W;
    const float* dr = dy + base + (size_t)r * W;
    for (int col = lane; col < L; col += 32) {
      const float d = dr[col];
      a += d * (xr[col] - mean) * rstd;
      b += d;
    }
  }
  __shared__ float slots[2][kWarps];
  a = block_sum256(a, slots[0]);
  b = block_sum256(b, slots[1]);
  if (threadIdx.x == 0) {
    float* p = partial + ((size_t)nc * gridDim.x + blockIdx.x) * 2;
    p[0] = a;
    p[1] = b;
  }
}

// grid (S2, N*G): block s of group ng merges the group's Cg * S1 partials,
// then writes dx over rows [s*rows_per_block, ...) of its Cg*H rows
__global__ void __launch_bounds__(kThreads) groupnorm_bwd_apply_kernel(
    const float* __restrict__ x, const float* __restrict__ dy, const int* __restrict__ lens,
    const float* __restrict__ stats, const float* __restrict__ partial, const float* __restrict__ weight,
    float* __restrict__ dx, int G, int Cg, int H, int W, int S1, int rows_per_block) {
  const int ng = blockIdx.y;
  const int n = ng / G;
  const int L = valid_cols(lens, n, W);
  const int c0 = (ng % G) * Cg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __shared__ float s_ma, s_mb;
  if (warp == 0) {
    // Σ_c weight[c] (A, B) over the group's channels and their S1 partials
    const float* p = partial + ((size_t)n * (G * Cg) + c0) * S1 * 2;
    float a = 0.f, b = 0.f;
    for (int i = lane; i < Cg * S1; i += 32) {
      const float w = weight[c0 + i / S1];
      a += w * p[2 * i];
      b += w * p[2 * i + 1];
    }
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    if (lane == 0) {
      const float count = (float)Cg * (float)H * (float)L;
      s_ma = a / count;
      s_mb = b / count;
    }
  }
  __syncthreads();
  const float mean = stats[2 * ng], rstd = stats[2 * ng + 1];
  const float ma = s_ma, mb = s_mb;
  const int rows = Cg * H;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, rows);
  const size_t base = (size_t)ng * rows * W;
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const float w = weight[c0 + r / H];
    const float* xr = x + base + (size_t)r * W;
    const float* dr = dy + base + (size_t)r * W;
    float* out = dx + base + (size_t)r * W;
    for (int col = lane; col < W; col += 32) {
      float v = 0.f;
      if (col < L) {
        const float xh = (xr[col] - mean) * rstd;
        v = rstd * (dr[col] * w - mb - xh * ma);
      }
      out[col] = v;
    }
  }
}

}  // namespace

// The cluster design (one launch): x, y, lens, weight, bias as for
// groupnorm_forward below; CL CTAs (1..16) per (sample, group), at most
// Cg*H of them. Returns a cudaError_t (0 = launched); a cluster shape the
// card cannot hold is refused by the launch.
// stats: N*G*2 fp32 (mean, rstd of each (sample, group)) written for the
// backward, or null (both designs).
extern "C" int groupnorm_cluster(const void* x, const void* lens, const void* weight,
                                 const void* bias, void* y, void* stats, int N, int C, int H, int W,
                                 int G, int CL, float eps, int dtype, int device, void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || G <= 0 || C % G || CL < 1 || CL > 16 ||
      CL > (C / G) * H || y == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int* l = static_cast<const int*>(lens);
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int clusters = 0;
  size_t smem = 0;
  float* st = static_cast<float*>(stats);
  switch (dtype) {
    case 0: err = launch_cluster<float>(x, l, w, b, y, st, N, C, H, W, G, CL, eps, s, &clusters, &smem); break;
    case 1: err = launch_cluster<__nv_bfloat16>(x, l, w, b, y, st, N, C, H, W, G, CL, eps, s, &clusters, &smem); break;
    case 2: err = launch_cluster<__half>(x, l, w, b, y, st, N, C, H, W, G, CL, eps, s, &clusters, &smem); break;
    default: return (int)cudaErrorInvalidValue;
  }
  // a refused call also leaves its error as the runtime's last error: clear
  // it, so that it is not reported again by the next launch of any kernel
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// What the cluster design asks of the card for one (sample, group) of
// (C, H, W) in G groups with CL CTAs: dynamic shared memory per CTA, threads
// per CTA, and how many such clusters the card holds at once (0: it cannot
// run them).
extern "C" int groupnorm_cluster_occupancy(int C, int H, int W, int G, int CL, int dtype,
                                           int device, int* smem_bytes, int* threads,
                                           int* max_clusters) {
  if (C <= 0 || H <= 0 || W <= 0 || G <= 0 || C % G || CL < 1 || CL > 16 || CL > (C / G) * H) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t smem = 0;
  *max_clusters = 0;
  *threads = kClusterThreads;
  switch (dtype) {
    case 0: err = launch_cluster<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, C, H, W, G, CL, 0.f, 0, max_clusters, &smem); break;
    case 1: err = launch_cluster<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, C, H, W, G, CL, 0.f, 0, max_clusters, &smem); break;
    case 2: err = launch_cluster<__half>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, C, H, W, G, CL, 0.f, 0, max_clusters, &smem); break;
    default: return (int)cudaErrorInvalidValue;
  }
  *smem_bytes = (int)smem;
  if (err != cudaSuccess) cudaGetLastError();  // not reported again by a later launch
  return (int)err;
}

// The stream design (two launches).
// x, y: (N, C, H, W) contiguous, dtype 0 fp32 / 1 bf16 / 2 fp16. lens: N
// int32 on the device, or null (every column valid). weight, bias: C fp32.
// partial: N*G*S*3 fp32 scratch. S: blocks per group, with every block
// holding at least one row: (S - 1) * ceil(Cg*H / S) < Cg*H.
extern "C" int groupnorm_forward(const void* x, const void* lens, void* partial, const void* weight,
                                 const void* bias, void* y, void* stats, int N, int C, int H, int W,
                                 int G, int S, float eps, int dtype, int device, void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || G <= 0 || C % G || S <= 0 || N * G > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = (C / G) * H;
  if ((S - 1) * ((rows + S - 1) / S) >= rows) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int* l = static_cast<const int*>(lens);
  float* p = static_cast<float*>(partial);
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  switch (dtype) {
    case 0: return (int)launch<float>(x, l, p, w, b, y, st, N, C, H, W, G, S, eps, s);
    case 1: return (int)launch<__nv_bfloat16>(x, l, p, w, b, y, st, N, C, H, W, G, S, eps, s);
    case 2: return (int)launch<__half>(x, l, p, w, b, y, st, N, C, H, W, G, S, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The gradient (two launches): x, dy, dx (N, C, H, W) fp32 contiguous; lens
// as for the forward; stats the forward's (mean, rstd) of each (sample,
// group); weight C fp32; partial N*C*S1*2 fp32, each (n, c) plane's S1
// partial (Σ dy x̂, Σ dy) over its valid columns (S1 blocks a plane, each
// holding at least one of its H rows), read by the wrapper for d weight and
// d bias; S2 blocks a group as S in groupnorm_forward.
extern "C" int groupnorm_backward(const void* x, const void* dy, const void* lens, const void* stats,
                                  const void* weight, void* partial, void* dx, int N, int C, int H,
                                  int W, int G, int S1, int S2, int device, void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || G <= 0 || C % G || S1 <= 0 || S2 <= 0 ||
      N * C > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int Cg = C / G, rows = Cg * H;
  const int rpb1 = (H + S1 - 1) / S1, rpb2 = (rows + S2 - 1) / S2;
  if ((S1 - 1) * rpb1 >= H || (S2 - 1) * rpb2 >= rows) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* x_ = static_cast<const float*>(x);
  const float* dy_ = static_cast<const float*>(dy);
  const int* l = static_cast<const int*>(lens);
  const float* st = static_cast<const float*>(stats);
  float* p = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  groupnorm_bwd_sums_kernel<<<dim3(S1, N * C), kThreads, 0, s>>>(x_, dy_, l, st, p, C, G, H, W, rpb1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  groupnorm_bwd_apply_kernel<<<dim3(S2, N * G), kThreads, 0, s>>>(
      x_, dy_, l, st, p, static_cast<const float*>(weight), static_cast<float*>(dx), G, Cg, H, W, S1,
      rpb2);
  return (int)cudaGetLastError();
}
