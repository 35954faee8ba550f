// LSTM recurrence over precomputed input projections, for Hopper (sm_90a).
//
// Replaces the TPU kernel kraken_tpu/ops/lstm.py:lstm_pallas (kernel body
// _lstm_kernel). Per step t of one direction:
//   gates = gates_x[:, t] + h @ w_hh^T              (gate order i, f, g, o)
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')
// Where mask[:, t] is 0 the carry (h, c) is frozen and the output is 0
// (torch packed-sequence semantics). A reversed direction walks t from T-1
// down to 0 with the same, un-flipped mask, so each row starts at its true
// end. The carry and the recurrent product are fp32 whatever the input type.
//
// Layouts (all contiguous):
//   gates  (B, T, D, 4H)  fp32 | bf16 | fp16, biases included
//   w_hh_t (D, H, 4H)     fp32, the transposed torch weight_hh
//   mask   (B, T)         bool (one byte)
//   out    (B, T, D, H)   the type of gates
// D is 1 or 2. Direction 0 runs reversed iff `reverse0`; direction 1 runs
// the other way, so one launch (gridDim.y = D) computes both directions of
// a bidirectional layer into the concatenated (B, T, 2H) layout.
//
// What bounds it on the H100: the T dependent steps. Per step a block needs
// all of w_hh (4H x H fp32: 640 KB at H = 200), more than the 227 KB of
// shared memory a block may hold, so it streams w_hh from L2 (50 MB, where
// it stays resident) on every step. The work itself, 2*B*T*4H*H flops, is
// on the fp32 CUDA cores (67 TFLOP/s peak); the bytes the function must
// move (gates once, out once, w_hh once) are far below either.
//
// Design (simple and right first): one block per (tile of ROWS rows,
// direction); the time loop runs inside the block. Thread k owns hidden
// unit k for all ROWS rows of the tile: it accumulates the four gate dot
// products for k, H+k, 2H+k, 3H+k in registers, reusing each w_hh value it
// loads for ROWS rows, and keeps c and h of its units in registers. h of
// the whole tile is exchanged through shared memory, double-buffered, so a
// step needs one __syncthreads(). Loads of w_hh_t and of gates are
// coalesced across k. Faster designs (w_hh split across a thread-block
// cluster in distributed shared memory, tensor-core products) are later
// work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 4;
static_assert(ROWS == 4, "h is exchanged as one float4 per hidden unit");

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half(v); }

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// one thread per hidden unit, H <= 1024: the bound caps registers so that
// every admitted H launches
template <typename T>
__global__ void __launch_bounds__(1024) lstm_recurrence_kernel(const T* __restrict__ gates,
                                       const float* __restrict__ w_hh_t,
                                       const uint8_t* __restrict__ mask,
                                       T* __restrict__ out,
                                       int B, int T_len, int D, int H, int reverse0) {
  // h of the tile, [2 buffers][H][ROWS]: one float4 read gives all rows of unit j
  extern __shared__ float4 h_smem[];
  const int d = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int k = threadIdx.x;
  const bool active = k < H;
  const bool reverse = (d == 1) != (reverse0 != 0);
  const int G = 4 * H;
  const float* w = w_hh_t + (size_t)d * H * G;

  for (int i = threadIdx.x; i < 2 * H; i += blockDim.x) h_smem[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float c[ROWS], h[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) { c[r] = 0.f; h[r] = 0.f; }
  __syncthreads();

  int cur = 0;
  for (int s = 0; s < T_len; ++s) {
    const int t = reverse ? T_len - 1 - s : s;
    if (active) {
      float acc[4][ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int b = row0 + r;
        if (b < B) {
          const T* g = gates + (((size_t)b * T_len + t) * D + d) * G + k;
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q][r] = to_f32<T>(g[q * H]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q][r] = 0.f;
        }
      }
      const float4* hb = h_smem + cur * H;
#pragma unroll 4
      for (int j = 0; j < H; ++j) {
        const float* wj = w + (size_t)j * G + k;
        const float wq[4] = {__ldg(wj), __ldg(wj + H), __ldg(wj + 2 * H), __ldg(wj + 3 * H)};
        const float4 hv = hb[j];
        const float hr[ROWS] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[q][r] = fmaf(hr[r], wq[q], acc[q][r]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int b = row0 + r;
        if (b >= B) continue;
        const float ig = sigmoid(acc[0][r]);
        const float fg = sigmoid(acc[1][r]);
        const float gg = tanhf(acc[2][r]);
        const float og = sigmoid(acc[3][r]);
        const float c_new = fg * c[r] + ig * gg;
        const float h_new = og * tanhf(c_new);
        const bool m = mask[(size_t)b * T_len + t] != 0;
        if (m) {
          c[r] = c_new;
          h[r] = h_new;
        }
        out[(((size_t)b * T_len + t) * D + d) * H + k] = from_f32<T>(m ? h_new : 0.f);
      }
      h_smem[(cur ^ 1) * H + k] = make_float4(h[0], h[1], h[2], h[3]);
    }
    __syncthreads();
    cur ^= 1;
  }
}

template <typename T>
void launch(const void* gates, const float* w_hh_t, const uint8_t* mask, void* out,
            int B, int T_len, int D, int H, int reverse0, cudaStream_t stream) {
  const dim3 grid((B + ROWS - 1) / ROWS, D);
  const int threads = (H + 31) / 32 * 32;
  const size_t smem = 2 * (size_t)H * sizeof(float4);
  lstm_recurrence_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(gates), w_hh_t, mask, static_cast<T*>(out), B, T_len, D, H, reverse0);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16. Returns a cudaError_t (0 = launched).
extern "C" int lstm_recurrence(const void* gates, const void* w_hh_t, const void* mask, void* out,
                               int B, int T_len, int D, int H, int reverse0, int dtype,
                               int device, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || H > 1024 || (D != 1 && D != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* w = static_cast<const float*>(w_hh_t);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(gates, w, m, out, B, T_len, D, H, reverse0, s); break;
    case 1: launch<__nv_bfloat16>(gates, w, m, out, B, T_len, D, H, reverse0, s); break;
    case 2: launch<__half>(gates, w, m, out, B, T_len, D, H, reverse0, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
