// Segmentation head: bilinear upsampling of the logits, then the sigmoid,
// for Hopper (sm_90a).
//
// Replaces the head of the segmentation forward of
// kraken_tpu/inference/segmentation.py (prepare_segmentation.fwd, an XLA
// program there): jax.image.resize(logits.astype(float32), ...,
// 'bilinear') followed by jax.nn.sigmoid. For upsampling, jax.image.resize
// samples output pixel o at the input coordinate (o + 0.5) * in / out - 0.5
// with a triangle kernel and renormalises the weights of the taps that fall
// inside the input; that equals clamping the coordinate into [0, in - 1]
// (torch's align_corners=False rule). Each output pixel is
//   sigmoid(lerp_y(lerp_x(4 taps)))
// in fp32; the logits may be fp32, bf16 or fp16, the output is fp32.
// Only upsampling (out >= in on both axes) is taken: when it shrinks an
// axis jax.image.resize antialiases, which this kernel does not.
//
// What bounds it on the H100: bytes. The output is ~16x the input (22.4 M
// fp32 pixels at the full-size spec, 90 MB written against 5.6 MB read),
// a few dozen flops a pixel. One block row of threads takes one output row
// of one (sample, class) plane, lanes on neighbouring output columns: the
// vertical taps and weight are computed once per row, every store is
// coalesced, and the few input rows a block reads stay in L1/L2.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_f(const __half* p) { return __half2float(*p); }

// Source index pair and weight of the upper one, align_corners=False. The
// arithmetic is rounded step by step (no fused multiply-adds), as the plain
// version computes it: a fused position moves a sample by an ulp of the
// coordinate, which steep logits turn into 1e-5 of probability.
__device__ __forceinline__ void taps(int o, float scale, int n_in, int* i0, int* i1, float* lam) {
  const float f = fmaxf(__fsub_rn(__fmul_rn((float)o + 0.5f, scale), 0.5f), 0.f);
  const int i = min((int)f, n_in - 1);
  *i0 = i;
  *i1 = min(i + 1, n_in - 1);
  *lam = f - (float)i;
}

// grid (ceil(OW / kThreads), OH, N*K)
template <typename T>
__global__ void __launch_bounds__(kThreads) seghead_kernel(const T* __restrict__ x,
                                                           float* __restrict__ y, int h, int w,
                                                           int OH, int OW, float sy, float sx) {
  const int ox = blockIdx.x * kThreads + threadIdx.x;
  if (ox >= OW) return;
  const int oy = blockIdx.y;
  const size_t plane = blockIdx.z;
  int y0, y1, x0, x1;
  float ly, lx;
  taps(oy, sy, h, &y0, &y1, &ly);
  taps(ox, sx, w, &x0, &x1, &lx);
  const T* top = x + (plane * h + y0) * w;
  const T* bot = x + (plane * h + y1) * w;
  const float a = load_f(top + x0), b = load_f(top + x1);
  const float c = load_f(bot + x0), d = load_f(bot + x1);
  const float ux = 1.f - lx;
  const float top_v = __fadd_rn(__fmul_rn(ux, a), __fmul_rn(lx, b));
  const float bot_v = __fadd_rn(__fmul_rn(ux, c), __fmul_rn(lx, d));
  const float v = __fadd_rn(__fmul_rn(1.f - ly, top_v), __fmul_rn(ly, bot_v));
  y[(plane * OH + oy) * OW + ox] = 1.f / (1.f + expf(-v));
}

template <typename T>
cudaError_t launch(const void* x, float* y, int NK, int h, int w, int OH, int OW,
                   cudaStream_t stream) {
  const dim3 grid((OW + kThreads - 1) / kThreads, OH, NK);
  seghead_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), y, h, w, OH, OW,
                                                   (float)h / (float)OH, (float)w / (float)OW);
  return cudaGetLastError();
}

}  // namespace

// x: (N, K, h, w) contiguous logits, dtype 0 fp32 / 1 bf16 / 2 fp16.
// y: (N, K, OH, OW) fp32 probabilities, OH >= h, OW >= w.
extern "C" int seghead_forward(const void* x, void* y, int N, int K, int h, int w, int OH, int OW,
                               int dtype, int device, void* stream) {
  if (N <= 0 || K <= 0 || h <= 0 || w <= 0 || OH < h || OW < w || OH > 65535 ||
      (long long)N * K > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(x, out, N * K, h, w, OH, OW, s);
    case 1: return (int)launch<__nv_bfloat16>(x, out, N * K, h, w, OH, OW, s);
    case 2: return (int)launch<__half>(x, out, N * K, h, w, OH, OW, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
