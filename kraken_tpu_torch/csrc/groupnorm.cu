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
// What bounds it on the H100: bytes. Each element is read twice (once for
// the statistics, once to normalise) and written once, a handful of flops
// each; at the full-size segmentation spec a forward moves 107.8 M elements
// through four such layers, 0.86 GB at one read and one write each (about
// 0.26 ms at 3.35 TB/s).
//
// The design answers two things. (1) A group holds up to 2 x 900 x 623 =
// 1.1 M elements, and a layer has only N x G groups (32 at the full size),
// so one block per group would leave most of the 132 SMs idle: every group
// is split over S blocks of whole rows (the wrapper picks S so that the
// launch has about 8 blocks per SM). (2) The activations come after a ReLU
// and have a mean about as large as their spread, so a naive sum and sum of
// squares loses digits: each thread keeps a Welford triple (count, mean,
// M2), and triples merge with Chan's formula, first across a warp, then
// across the block. Each block writes its triple; there are no float
// atomics, and every merge runs in a fixed order, so results do not change
// from run to run.
// Launch 1 (groupnorm_stats_kernel) writes the S partial triples of every
// group. Launch 2 (groupnorm_apply_kernel) runs on the same grid: each
// block first merges its group's S triples (one warp, a fixed order), then
// normalises its rows, applies the affine and zeroes the columns >= L.
// A warp walks one row at a time, lanes on neighbouring columns, so every
// load and store is coalesced and a ragged row end idles at most one
// iteration of the warp.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
    const float* __restrict__ weight, const float* __restrict__ bias, T* __restrict__ y, int G,
    int Cg, int H, int W, int rows_per_block, float eps) {
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
                   const float* bias, void* y, int N, int C, int H, int W, int G, int S,
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
                                                           weight, bias, static_cast<T*>(y), G, Cg,
                                                           H, W, rows_per_block, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y: (N, C, H, W) contiguous, dtype 0 fp32 / 1 bf16 / 2 fp16. lens: N
// int32 on the device, or null (every column valid). weight, bias: C fp32.
// partial: N*G*S*3 fp32 scratch. S: blocks per group, with every block
// holding at least one row: (S - 1) * ceil(Cg*H / S) < Cg*H.
extern "C" int groupnorm_forward(const void* x, const void* lens, void* partial, const void* weight,
                                 const void* bias, void* y, int N, int C, int H, int W, int G, int S,
                                 float eps, int dtype, int device, void* stream) {
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
  switch (dtype) {
    case 0: return (int)launch<float>(x, l, p, w, b, y, N, C, H, W, G, S, eps, s);
    case 1: return (int)launch<__nv_bfloat16>(x, l, p, w, b, y, N, C, H, W, G, S, eps, s);
    case 2: return (int)launch<__half>(x, l, p, w, b, y, N, C, H, W, G, S, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
