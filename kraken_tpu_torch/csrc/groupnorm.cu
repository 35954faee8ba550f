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
// group)'s mean and rstd; the backward (one launch, routes "cluster" and
// "l2", see "backward" below) gives the gradient.
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
// the backward's: slices of x and dy (fp32), each row's weight, and the
// CTA's (A, B) of each channel of the group
size_t bwd_cluster_smem(int rows, int W, int Cg) {
  return 2 * slice_bytes(rows, W, sizeof(float)) + 4 * (size_t)rows + 8 * (size_t)Cg;
}

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

// The sum over the CTA of WARPS warps of each thread's `v`, the same in
// every thread: a butterfly across each warp, then the warps' totals in
// order (fixed order: the same bits on every run). `slots` holds WARPS floats.
template <int WARPS = kClusterWarps>
__device__ __forceinline__ float block_sum(float v, float* slots) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = slots[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) t += slots[w];
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

// The gradient of the padding-aware GroupNorm (the training path), fp32,
// one launch a call. With x̂ = (x - mean) * rstd of the forward (its mean and
// rstd per (sample, group), which the forward writes when given `stats`),
// m = [w < L] and dŷ = dy * weight[c] * m:
//   dx = rstd * (dŷ - mean_m(dŷ) - x̂ * mean_m(dŷ * x̂)) * m
// the means over the group's valid elements (count Cg * H * L). Both means
// come from per-(sample, channel) sums A = Σ dy x̂ m and B = Σ dy m:
// mean_m(dŷ x̂) = Σ_c weight[c] A[n, c] / count, mean_m(dŷ) = Σ_c weight[c]
// B[n, c] / count. The partial (A, B) the kernel writes also give d weight =
// Σ_n A and d bias = Σ_n B, which the wrapper sums with torch. No float
// atomics: every sum is taken in a fixed order, the same bits on every run.
//
// What bounds it: bytes. x and dy are read and dx is written once at least
// (3 passes); a group's sums must be complete before any of its dx, so the
// group is either held on chip between the two, or read twice. Two routes,
// picked by the wrapper (ops/groupnorm.py:_backward_design) from the shapes:
//
// "cluster" (groupnorm_bwd_cluster_kernel), groups whose x and dy fit the
//   shared memory of a cluster (the `tpu` preset's layers): one cluster of
//   CL CTAs (1 to 16, the fewest whose CTAs hold their rows with three CTAs
//   an SM, ops/groupnorm.py:_backward_design) per (sample, group), CTA j
//   taking rows [j*rows/CL, (j+1)*rows/CL) of the group's Cg*H rows. Bulk
//   copies on one mbarrier bring its slices of x and dy into shared memory
//   (the unaligned ends by threads). Per channel its rows touch, the CTA
//   sums (A, B) over its slice in 16-byte units, a fixed-order tree over its
//   threads, and writes them for d weight / d bias. After one cluster
//   barrier, one warp of every CTA reads the CL * Cg partials through
//   distributed shared memory and merges them in a fixed order. dx is
//   written from shared memory with 16-byte stores, zero at the pad
//   columns: x and dy are read and dx written once, the bound's 3 passes.
//
// "l2" (groupnorm_bwd_l2_kernel), every other group (the segtrain layers at
//   height 1800: 4.5-9.0 MB of x and dy a group): a cooperative launch (the
//   card holds every CTA at once) of 2 CTAs of 256 threads an SM. Item
//   (sample, channel, part) is `per` elements of one channel plane (a
//   multiple of 4, at least 8192); CTA i takes items i, i + grid, ... (works
//   of K items where a group has more channels than the grid CTAs). For its
//   item the CTA sums (A, B) with 16-byte loads and writes them and then its
//   flag (the launch's epoch); it sums its next item too, then waits until
//   every item of the current item's group has its flag, merges the group's
//   partials in a fixed order, and reads the item's x and dy a second time
//   for dx (L2 eviction hints keep the lines between the reads). Summing
//   ahead lets the wait overlap loads. Groups in flight:
//   two items a CTA lie between their two reads, 264 * 2 * 8192 * 8 bytes =
//   35 MB of x and dy on an H100 (four 9 MB groups of segtrain's), within
//   its 50 MB L2, so the second read finds most of them there; items of half
//   the size (17 MB in flight) left HBM idle more, items of twice it (69 MB)
//   gained nothing (ops/groupnorm.py:L2_ITEM).
//   Deadlock-free: a CTA sums item i only after it has written item i -
//   2 * grid, which waits only for items of its own group, all below i
//   since a group has at most grid items (the wrapper sizes `per` so); by
//   induction over the item index every item arrives. The flags live in a
//   buffer the wrapper keeps per device and stream; a new epoch each launch,
//   so they are never reset. A flag that never comes traps after ~10 s
//   instead of hanging the card.

__device__ __forceinline__ void wait_flags_or_trap(uint64_t& start, int i) {
  if ((i & 1023) == 0) {
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (i == 0) start = now;
    else if (now - start > 10000000000ull) __trap();
  }
}

// partial: (N*G, CL, Cg, 2) fp32, each CTA's (A, B) of every channel of its
// group (zero where its rows miss the channel)
__global__ void __launch_bounds__(kClusterThreads) groupnorm_bwd_cluster_kernel(
    const float* __restrict__ x, const float* __restrict__ dy, const int* __restrict__ lens,
    const float* __restrict__ stats, const float* __restrict__ weight, float* __restrict__ partial,
    float* __restrict__ dx, int G, int Cg, int H, int W) {
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int ng = blockIdx.x / CL;
  const int rows = Cg * H;
  const int r0 = cta_row(rows, CL, rank), r1 = cta_row(rows, CL, rank + 1);
  const int my_rows = r1 - r0;
  const int L = valid_cols(lens, ng / G, W);
  const int R = (rows + CL - 1) / CL;  // the most rows a CTA of the cluster takes
  const size_t slice = slice_bytes(R, W, sizeof(float));

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* ds = reinterpret_cast<float*>(smem_raw + slice);
  float* row_w = reinterpret_cast<float*>(smem_raw + 2 * slice);  // [R]
  float* ab = row_w + R;                                          // [Cg][2]: this CTA's (A, B)
  __shared__ uint64_t bar;
  __shared__ float slots[2][kClusterWarps];
  __shared__ float s_ma, s_mb;

  // the slice [e0, e1) of x and dy (both 16-byte aligned, the wrapper's
  // check); shared element i holds element a0 + i, a0 the first of e0's line
  constexpr int V = 4;
  const long long e0 = ((long long)ng * rows + r0) * W, e1 = ((long long)ng * rows + r1) * W;
  const long long a0 = e0 / V * V;
  const long long m0 = a0 < e0 ? a0 + V : a0;  // the aligned middle [m0, m1)
  const long long m1 = e1 / V * V;
  const bool bulk = m1 > m0;
  if (bulk && threadIdx.x == 0) {
    const uint32_t b = smem_u32(&bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const uint32_t bytes = (uint32_t)((m1 - m0) * sizeof(float));
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(b), "r"(2 * bytes)
                 : "memory");
    for (int t = 0; t < 2; ++t) {
      const uint32_t dst = smem_u32((t ? ds : xs) + (m0 - a0));
      const char* src = reinterpret_cast<const char*>((t ? dy : x) + m0);
      for (uint32_t off = 0; off < bytes; off += kBulkBytes) {
        const uint32_t n = bytes - off < kBulkBytes ? bytes - off : kBulkBytes;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
            :: "r"(dst + off), "l"(src + off), "r"(n), "r"(b) : "memory");
      }
    }
  }
  const long long h1 = bulk ? m0 : e1, t0 = bulk ? m1 : e1;
  for (long long e = e0 + threadIdx.x; e < h1; e += kClusterThreads) {
    xs[e - a0] = x[e];
    ds[e - a0] = dy[e];
  }
  for (long long e = t0 + threadIdx.x; e < e1; e += kClusterThreads) {
    xs[e - a0] = x[e];
    ds[e - a0] = dy[e];
  }
  const int c0 = (ng % G) * Cg;
  for (int r = threadIdx.x; r < my_rows; r += kClusterThreads) row_w[r] = weight[c0 + (r0 + r) / H];
  for (int i = threadIdx.x; i < 2 * Cg; i += kClusterThreads) ab[i] = 0.f;
  __syncthreads();
  if (bulk) wait_copies(smem_u32(&bar));

  // (A, B) of each channel the slice touches: its rows [sa, sb) of the
  // slice, in 16-byte units (unit u: slice elements u*V - off0 ...)
  const float mean = stats[2 * ng], rstd = stats[2 * ng + 1];
  const int off0 = (int)(e0 - a0);
  const int step_r = kClusterThreads * V / W, step_c = kClusterThreads * V % W;
  for (int cl = r0 / H; cl <= (r1 - 1) / H; ++cl) {
    const int ia = (max(r0, cl * H) - r0) * W, ib = (min(r1, (cl + 1) * H) - r0) * W;
    const int ua = (ia + off0) / V, ub = (ib + off0 + V - 1) / V;
    float a = 0.f, b = 0.f;
    Cursor at = Cursor::at((ua + (int)threadIdx.x) * V - off0, W);
#pragma unroll 2
    for (int u = ua + threadIdx.x; u < ub; u += kClusterThreads, at.advance(step_r, step_c, W)) {
      float xv[V], dv[V];
      load16(xs + u * V, xv);
      load16(ds + u * V, dv);
      const int i0 = u * V - off0;
      int col = at.col;
#pragma unroll
      for (int q = 0; q < V; ++q) {
        if (q > 0 && ++col == W) col = 0;
        if (i0 + q >= ia && i0 + q < ib && col < L) {
          a += dv[q] * ((xv[q] - mean) * rstd);
          b += dv[q];
        }
      }
    }
    a = block_sum(a, slots[0]);
    b = block_sum(b, slots[1]);
    if (threadIdx.x == 0) {
      ab[2 * cl] = a;
      ab[2 * cl + 1] = b;
    }
    __syncthreads();  // slots are read before the next channel writes them
  }
  float* p = partial + ((size_t)ng * CL + rank) * Cg * 2;
  for (int i = threadIdx.x; i < 2 * Cg; i += kClusterThreads) p[i] = ab[i];
  // every CTA's partials are written and visible across the cluster (a
  // release/acquire barrier of the cluster's scope: cluster.sync() would
  // fence the whole GPU; one CTA needs only its own barrier); warp 0 reads
  // all CL * Cg of them and merges them in a fixed order, the same in every
  // CTA
  if (CL > 1) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  } else {
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float a = 0.f, b = 0.f;
    for (int i = lane; i < CL * Cg; i += 32) {
      const float* q = cluster.map_shared_rank(ab, i / Cg) + 2 * (i % Cg);
      const float w = weight[c0 + i % Cg];
      a += w * q[0];
      b += w * q[1];
    }
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      const float count = (float)Cg * (float)H * (float)L;
      s_ma = a / count;
      s_mb = b / count;
    }
  }
  __syncthreads();
  // this CTA is done reading the others' shared memory; none may exit
  // before every CTA is (the wait below)
  if (CL > 1) asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");

  const float ma = s_ma, mb = s_mb;
  const int n_el = my_rows * W;
  const int units = (off0 + n_el + V - 1) / V;
  Cursor at = Cursor::at((int)threadIdx.x * V - off0, W);
#pragma unroll 2
  for (int u = threadIdx.x; u < units; u += kClusterThreads, at.advance(step_r, step_c, W)) {
    float xv[V], dv[V];
    load16(xs + u * V, xv);
    load16(ds + u * V, dv);
    const int i0 = u * V - off0;
    const bool whole = i0 >= 0 && i0 + V <= n_el;
    int r = at.row, col = at.col;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      if (q > 0 && ++col == W) {
        col = 0;
        ++r;
      }
      const bool in = i0 + q >= 0 && i0 + q < n_el;
      xv[q] = in && col < L ? rstd * (dv[q] * row_w[r] - mb - (xv[q] - mean) * rstd * ma) : 0.f;
    }
    float* out = dx + (a0 + (long long)u * V);
    if (whole) {
      store16(out, xv);
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) {
        if (i0 + q >= 0 && i0 + q < n_el) out[q] = xv[q];
      }
    }
  }
  if (CL > 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Sets up a cluster launch of the backward, CL CTAs per group; with dx ==
// nullptr it only asks how many such clusters the card holds at once.
cudaError_t launch_bwd_cluster(const float* x, const float* dy, const int* lens, const float* stats,
                               const float* weight, float* partial, float* dx, int N, int C, int H, int W,
                               int G, int CL, cudaStream_t stream, int* max_clusters, size_t* smem_out) {
  auto kernel = groupnorm_bwd_cluster_kernel;
  const int Cg = C / G, rows = Cg * H;
  const size_t smem = bwd_cluster_smem((rows + CL - 1) / CL, W, Cg);
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
  if (dx == nullptr) return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  return cudaLaunchKernelEx(&cfg, kernel, x, dy, lens, stats, weight, partial, dx, G, Cg, H, W);
}

constexpr int kL2Threads = 256;
constexpr int kL2Warps = kL2Threads / 32;
constexpr int kL2MinBlocksPerSM = 2;  // at most 128 registers a thread

// the 16-byte unit of x and dy at element i0 (16-byte aligned), elements at
// or past `total` 0 (the tensor's last unit may end inside it)
// L2 eviction policies (createpolicy): the first read of an item keeps its
// lines (evict_last) for the second, which lets them go (evict_first), as
// do the dx stores (on an H100 the hints took 9-12% off segtrain's layers
// against plain accesses, PERF.md).
__device__ __forceinline__ uint64_t l2_policy(bool last) {
  uint64_t p;
  if (last) {
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  } else {
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  }
  return p;
}
__device__ __forceinline__ void load16_hint(const float* p, float* f, uint64_t pol) {
  asm("ld.global.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(f[0]), "=f"(f[1]), "=f"(f[2]), "=f"(f[3]) : "l"(p), "l"(pol));
}
__device__ __forceinline__ void store16_hint(float* p, const float* f, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;"
               :: "l"(p), "f"(f[0]), "f"(f[1]), "f"(f[2]), "f"(f[3]), "l"(pol) : "memory");
}

__device__ __forceinline__ void load_unit(const float* x, const float* dy, long long i0, long long total,
                                          float* xv, float* dv, uint64_t pol) {
  if (i0 + 4 <= total) {
    load16_hint(x + i0, xv, pol);
    load16_hint(dy + i0, dv, pol);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    xv[q] = i0 + q < total ? x[i0 + q] : 0.f;
    dv[q] = i0 + q < total ? dy[i0 + q] : 0.f;
  }
}

// Item `item` of the l2 route: `per` elements [e0, e1) of channel plane nc
// (the last of a plane shorter), in the 16-byte units [ua, ub) of the
// tensor; its sample, group, valid columns and the forward's statistics.
struct L2Item {
  int n, c, ng, L;
  long long p0, e0, e1, ua, ub;
  float mean, rstd;
  __device__ L2Item(int item, int C, int G, int HW, int W, int S, int per, const int* lens,
                    const float* stats) {
    const int nc = item / S, s = item % S;
    n = nc / C;
    c = nc % C;
    ng = n * G + c / (C / G);
    L = valid_cols(lens, n, W);
    p0 = (long long)nc * HW;
    e0 = p0 + (long long)s * per;
    e1 = p0 + min((long long)(s + 1) * per, (long long)HW);
    ua = e0 / 4;
    ub = (e1 + 3) / 4;
    mean = stats[2 * ng];
    rstd = stats[2 * ng + 1];
  }
};

// The item's (A, B) over its valid elements, written to `partial`, then its
// flag (release: the partial is visible to whoever sees the flag).
__device__ __forceinline__ void l2_sums(const L2Item& it, int item, const float* x, const float* dy,
                                        long long total, int W, float* partial, int* flags, int epoch,
                                        float (*slots)[kL2Warps], uint64_t keep) {
  constexpr int V = 4;
  const int step_r = kL2Threads * V / W, step_c = kL2Threads * V % W;
  float a = 0.f, b = 0.f;
  Cursor at = Cursor::at((int)((it.ua + threadIdx.x) * V - it.p0), W);
#pragma unroll 4
  for (long long u = it.ua + threadIdx.x; u < it.ub; u += kL2Threads, at.advance(step_r, step_c, W)) {
    float xv[V], dv[V];
    const long long i0 = u * V;
    load_unit(x, dy, i0, total, xv, dv, keep);
    int col = at.col;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      if (q > 0 && ++col == W) col = 0;
      if (i0 + q >= it.e0 && i0 + q < it.e1 && col < it.L) {
        a += dv[q] * ((xv[q] - it.mean) * it.rstd);
        b += dv[q];
      }
    }
  }
  a = block_sum<kL2Warps>(a, slots[0]);
  b = block_sum<kL2Warps>(b, slots[1]);
  if (threadIdx.x == 0) {
    partial[2 * (size_t)item] = a;
    partial[2 * (size_t)item + 1] = b;
    asm volatile("st.release.gpu.global.b32 [%0], %1;" :: "l"(flags + item), "r"(epoch) : "memory");
  }
}

// Waits until every item of group `g` (its Cg * S items from first) has its
// flag, then merges the group's Σ_c weight[c] (A, B) over its items in a
// fixed order: (mean_m(dŷ x̂), mean_m(dŷ)) in *ma, *mb, in every thread.
__device__ __forceinline__ void l2_group_means(int first, int group_items, int c0, int S, float count,
                                               const float* weight, const float* partial, const int* flags,
                                               int epoch, float (*slots)[kL2Warps], float* ma, float* mb) {
  uint64_t t_start = 0;
  for (int i = 0;; ++i) {
    bool ready = true;
    for (int k = threadIdx.x; k < group_items; k += kL2Threads) {
      int f;
      asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(f) : "l"(flags + first + k) : "memory");
      ready = ready && f == epoch;
    }
    if (__syncthreads_and(ready)) break;
    wait_flags_or_trap(t_start, i);
  }
  float wa = 0.f, wb = 0.f;
  for (int k = threadIdx.x; k < group_items; k += kL2Threads) {
    const float w = weight[c0 + k / S];
    wa += w * __ldcg(partial + 2 * (size_t)(first + k));
    wb += w * __ldcg(partial + 2 * (size_t)(first + k) + 1);
  }
  *ma = block_sum<kL2Warps>(wa, slots[0]) / count;
  *mb = block_sum<kL2Warps>(wb, slots[1]) / count;
}

// The item's dx from its group's means, zero at the pad columns.
__device__ __forceinline__ void l2_dx(const L2Item& it, const float* x, const float* dy, long long total,
                                      int W, float w, float ma, float mb, float* dx, uint64_t drop) {
  constexpr int V = 4;
  const int step_r = kL2Threads * V / W, step_c = kL2Threads * V % W;
  Cursor at = Cursor::at((int)((it.ua + threadIdx.x) * V - it.p0), W);
#pragma unroll 4
  for (long long u = it.ua + threadIdx.x; u < it.ub; u += kL2Threads, at.advance(step_r, step_c, W)) {
    float xv[V], dv[V];
    const long long i0 = u * V;
    load_unit(x, dy, i0, total, xv, dv, drop);
    int col = at.col;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      if (q > 0 && ++col == W) col = 0;
      xv[q] = col < it.L ? it.rstd * (dv[q] * w - mb - (xv[q] - it.mean) * it.rstd * ma) : 0.f;
    }
    if (i0 >= it.e0 && i0 + V <= it.e1) {
      store16_hint(dx + i0, xv, drop);
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) {
        if (i0 + q >= it.e0 && i0 + q < it.e1) dx[i0 + q] = xv[q];
      }
    }
  }
}

// partial: (N, C, S, 2) fp32, each item's (A, B); flags: N*C*S int32, the
// epoch of the launch that last wrote the item's partial. A group's Cg * S
// items (contiguous: plane-major, channels of a group adjacent) are cut
// into works of K consecutive items (K = 1 unless a group has more items
// than the grid has CTAs); CTA i takes works i, i + grid, ... It sums the
// items of its next work before it waits for the group of its current one,
// so the wait overlaps loads; two works a CTA lie between their two reads.
__global__ void __launch_bounds__(kL2Threads, kL2MinBlocksPerSM) groupnorm_bwd_l2_kernel(
    const float* __restrict__ x, const float* __restrict__ dy, const int* __restrict__ lens,
    const float* __restrict__ stats, const float* __restrict__ weight, float* __restrict__ partial,
    int* __restrict__ flags, int epoch, float* __restrict__ dx, int N, int C, int G, int H, int W, int S,
    int per, int K) {
  const int HW = H * W, Cg = C / G;
  const uint64_t keep = l2_policy(true), drop = l2_policy(false);
  const int group_items = Cg * S;
  const int works_a_group = (group_items + K - 1) / K;
  const int n_works = N * G * works_a_group;
  const long long total = (long long)N * C * HW;
  __shared__ float slots[2][kL2Warps];
  auto sums = [&](int work) {
    const int first = (work / works_a_group) * group_items, j = work % works_a_group;
    for (int i = first + j * K; i < first + min((j + 1) * K, group_items); ++i) {
      l2_sums(L2Item(i, C, G, HW, W, S, per, lens, stats), i, x, dy, total, W, partial, flags, epoch,
              slots, keep);
    }
  };
  int work = blockIdx.x;
  if (work < n_works) sums(work);
  for (; work < n_works; work += gridDim.x) {
    if (work + (int)gridDim.x < n_works) sums(work + gridDim.x);
    const int g = work / works_a_group, j = work % works_a_group;
    const int first = g * group_items;
    const L2Item head(first, C, G, HW, W, S, per, lens, stats);
    float ma, mb;
    l2_group_means(first, group_items, (g % G) * Cg, S, (float)Cg * (float)H * (float)head.L, weight,
                   partial, flags, epoch, slots, &ma, &mb);
    for (int i = first + j * K; i < first + min((j + 1) * K, group_items); ++i) {
      const L2Item it(i, C, G, HW, W, S, per, lens, stats);
      l2_dx(it, x, dy, total, W, weight[it.c], ma, mb, dx, drop);
    }
    __syncthreads();  // the slots are read before the next work writes them
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

// The gradient, one launch. x, dy, dx: (N, C, H, W) fp32, contiguous and
// 16-byte aligned; lens as for the forward; stats the forward's (mean,
// rstd) of each (sample, group); weight C fp32. Each returns a cudaError_t.
//
// The cluster route: CL CTAs (1..16, at most Cg*H) per (sample, group);
// partial (N*G, CL, Cg, 2) fp32, each CTA's (Σ dy x̂, Σ dy) over its rows of
// each channel of the group, read by the wrapper for d weight and d bias.
extern "C" int groupnorm_backward_cluster(const void* x, const void* dy, const void* lens, const void* stats,
                                          const void* weight, void* partial, void* dx, int N, int C, int H,
                                          int W, int G, int CL, int device, void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || G <= 0 || C % G || CL < 1 || CL > 16 ||
      CL > (C / G) * H || dx == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int clusters = 0;
  size_t smem = 0;
  err = launch_bwd_cluster(static_cast<const float*>(x), static_cast<const float*>(dy),
                           static_cast<const int*>(lens), static_cast<const float*>(stats),
                           static_cast<const float*>(weight), static_cast<float*>(partial),
                           static_cast<float*>(dx), N, C, H, W, G, CL, static_cast<cudaStream_t>(stream),
                           &clusters, &smem);
  const cudaError_t last = cudaGetLastError();  // a refused launch is not reported again later
  return (int)(err != cudaSuccess ? err : last);
}

// What the backward's cluster route asks of the card for groups of (C, H,
// W) in G groups with CL CTAs: dynamic shared memory per CTA, threads per
// CTA, and how many such clusters the card holds at once (0: it cannot).
extern "C" int groupnorm_bwd_cluster_occupancy(int C, int H, int W, int G, int CL, int device,
                                               int* smem_bytes, int* threads, int* max_clusters) {
  if (C <= 0 || H <= 0 || W <= 0 || G <= 0 || C % G || CL < 1 || CL > 16 || CL > (C / G) * H) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t smem = 0;
  *max_clusters = 0;
  *threads = kClusterThreads;
  err = launch_bwd_cluster(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, C, H, W, G, CL,
                           0, max_clusters, &smem);
  *smem_bytes = (int)smem;
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// The l2 route: a cooperative launch of `grid` CTAs (at most the card's
// capacity, groupnorm_bwd_l2_capacity) over N*C*S items of `per` elements
// (a multiple of 4; S = ceil(H*W / per) a plane) in works of K items
// (ceil((C/G) * S / K) <= grid); partial (N, C, S, 2) fp32 as above, per
// item; flags N*C*S int32 that no launch of the same `epoch` has written
// (the wrapper's per-stream buffer, a new epoch a launch).
extern "C" int groupnorm_backward_l2(const void* x, const void* dy, const void* lens, const void* stats,
                                     const void* weight, void* partial, void* flags, int epoch, void* dx,
                                     int N, int C, int H, int W, int G, int per, int K, int grid,
                                     int device, void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || G <= 0 || C % G || per <= 0 || per % 4 || K <= 0 ||
      grid <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long HW = (long long)H * W;
  const long long S = (HW + per - 1) / per;
  if ((long long)N * C * S > 0x7fffffffLL || HW > 0x7fffffffLL || ((C / G) * S + K - 1) / K > grid) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kL2Threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, groupnorm_bwd_l2_kernel, static_cast<const float*>(x),
                           static_cast<const float*>(dy), static_cast<const int*>(lens),
                           static_cast<const float*>(stats), static_cast<const float*>(weight),
                           static_cast<float*>(partial), static_cast<int*>(flags), epoch,
                           static_cast<float*>(dx), N, C, G, H, W, (int)S, per, K);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// CTAs of the l2 route the card holds at once: the largest cooperative grid
extern "C" int groupnorm_bwd_l2_capacity(int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, groupnorm_bwd_l2_kernel, kL2Threads, 0);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  *blocks = per_sm * sms;
  return 0;
}
