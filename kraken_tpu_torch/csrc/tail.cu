// Recognition tail: temperature softmax over the classes, then the
// per-frame argmax and max, for Hopper (sm_90a).
//
// Replaces the tail of the recognition forward of
// kraken_tpu/inference/recognition.py (prepare_recognition._tail, jitted
// into fwd there):
//   probs  = softmax(logits.astype(float32) / T, axis=C)   (N, C, W)
//   labels = argmax_C probs                                 (N, W) int64
//   confs  = max_C probs                                    (N, W) fp32
// on logits of shape (N, C, 1, W), fp32 or bf16 (fp16 too), computed in
// fp32. The full probs are written only when the caller passes a pointer
// for them (a consumer such as a non-greedy decoder needs them); on the
// greedy path only the (N, W) labels and confidences are written.
//
// Design: one thread per (n, w) frame, walking the C classes of its frame
// in three passes. The logits come with their strides: the network's
// output layer leaves them as a (N, C, 1, W) view of an (N, W, C) tensor,
// so a thread reads its frame's classes from one contiguous run (the same
// few cache lines pass after pass), and no transposing copy is made; where
// W is the contiguous axis, the threads of a warp read 32 consecutive
// frames of one class row (coalesced). The passes:
// - pass 1: the max m of x / T;
// - pass 2: the sum s of exp(x / T - m), accumulated in fp64 and rounded to
//   fp32 once;
// - pass 3: p_c = exp(x / T - m) / s, each step rounded as the plain
//   version rounds it on the card (x times the fp32 reciprocal of T, which
//   is how torch divides a CUDA tensor by a scalar; expf; an fp32 division
//   by s); the first class with the largest p_c is the label, that p_c the
//   confidence; p_c is stored when probs are asked for.
// Passes 2 and 3 read the logits again, from L1 or L2 (the flagship
// batch's are 8.2 MB). Each pass issues the loads of kUnroll classes before
// it uses them, so a thread keeps that many loads in flight.
// So the numerators equal the plain version's bit for bit, and so does the
// sum but where its fp64 sums, taken in another order, round to two
// neighbouring floats: probs agree to an ulp. (The plain version sums in
// fp64 for that reason: torch.softmax's fp32 sum was up to 1.43e-6 off
// this kernel's at 250 classes, and a first version of this kernel with
// an online fp32 sum, rescaled whenever the max grew, 1.07e-6 off
// torch.softmax; on an H100 80GB HBM3.) Two classes whose probabilities
// are that close may swap as the argmax.
// What bounds it: bytes (the logits read once, the outputs written once;
// a few flops and one expf a logit a pass). With a thread per frame the
// flagship batch (64 x 128 frames) is 2 warps an SM, too few to hide the
// memory latency: the kernel is latency-bound, far from the bytes bound.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 64;  // 64 frames a block: the flagship batch's 8192 frames fill 128 SMs
constexpr int kUnroll = 8;    // classes whose loads a thread issues before it uses them

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_f(const __half* p) { return __half2float(*p); }

// x / T as the plain version forms it on the card, for class c of a frame
template <typename T>
__device__ __forceinline__ float scaled(const T* col, int c, long long sc, float inv_t) {
  return __fmul_rn(load_f(col + c * sc), inv_t);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tail_kernel(const T* __restrict__ x, float* __restrict__ probs, int64_t* __restrict__ labels,
                float* __restrict__ confs, int C, int W, long long sn, long long sc, long long sw,
                long long frames, float inv_t) {
  const long long f = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (f >= frames) return;
  const long long n = f / W;
  const int w = (int)(f - n * W);
  const T* col = x + n * sn + w * sw;

  // pass 1: the max of x / T
  float m = -INFINITY;
  for (int c0 = 0; c0 < C; c0 += kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) v[j] = c0 + j < C ? scaled(col, c0 + j, sc, inv_t) : -INFINITY;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) m = fmaxf(m, v[j]);
  }

  // pass 2: the sum of exp(x / T - m), accumulated in fp64 and rounded once
  double s = 0.0;
  for (int c0 = 0; c0 < C; c0 += kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) v[j] = c0 + j < C ? scaled(col, c0 + j, sc, inv_t) : -INFINITY;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) s += (double)expf(v[j] - m);
  }
  const float sum = (float)s;

  // pass 3: p_c, the first class with the largest p_c and that p_c
  float best = -INFINITY;
  int64_t arg = 0;
  float* out = probs != nullptr ? probs + n * C * (long long)W + w : nullptr;  // contiguous
  for (int c0 = 0; c0 < C; c0 += kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) v[j] = c0 + j < C ? scaled(col, c0 + j, sc, inv_t) : 0.f;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (c0 + j < C) {
        const float p = __fdiv_rn(expf(v[j] - m), sum);
        if (out != nullptr) out[(long long)(c0 + j) * W] = p;
        if (p > best) {
          best = p;
          arg = c0 + j;
        }
      }
    }
  }
  labels[f] = arg;
  confs[f] = best;
}

template <typename T>
cudaError_t launch(const void* x, float* probs, int64_t* labels, float* confs, int N, int C, int W,
                   long long sn, long long sc, long long sw, float inv_t, cudaStream_t stream) {
  const long long frames = (long long)N * W;
  const unsigned blocks = (unsigned)((frames + kThreads - 1) / kThreads);
  tail_kernel<T><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(x), probs, labels, confs,
                                                  C, W, sn, sc, sw, frames, inv_t);
  return cudaGetLastError();
}

}  // namespace

// x: (N, C, W) logits with element strides (sn, sc, sw), dtype 0 fp32 /
// 1 bf16 / 2 fp16. probs: (N, C, W) contiguous fp32, or null to skip
// writing them. labels: (N, W) int64; confs: (N, W) fp32.
extern "C" int tail_forward(const void* x, void* probs, void* labels, void* confs, int N, int C,
                            int W, long long sn, long long sc, long long sw, float temperature,
                            int dtype, int device, void* stream) {
  if (N <= 0 || C <= 0 || W <= 0 || temperature == 0.f || !std::isfinite(temperature) ||
      (long long)N * W > (long long)kThreads * 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  float* p = static_cast<float*>(probs);
  int64_t* l = static_cast<int64_t*>(labels);
  float* c = static_cast<float*>(confs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the reciprocal, as torch's division of a CUDA tensor by a scalar forms it
  const float inv_t = 1.f / temperature;
  switch (dtype) {
    case 0: return (int)launch<float>(x, p, l, c, N, C, W, sn, sc, sw, inv_t, s);
    case 1: return (int)launch<__nv_bfloat16>(x, p, l, c, N, C, W, sn, sc, sw, inv_t, s);
    case 2: return (int)launch<__half>(x, p, l, c, N, C, W, sn, sc, sw, inv_t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
