// Multi-scale Sato ridge filter with its threshold, for Hopper (sm_90a).
//
// Replaces kraken_tpu/ops/ridge.py:_sato_core_batch and the threshold that
// follows it in kraken_tpu/inference/segmentation.py (prepare_segmentation
// .fwd), XLA programs there, on the baseline channels of the segmentation
// heatmaps. Per sigma in (1, 3, 5, 7, 9), with zero padding outside the
// map, the scale-normalised Hessian
//   hxx = s^2 * (g0 along y, then g2 along x)
//   hyy = s^2 * (g2 along y, then g0 along x)
//   hxy = s^2 * (g1 along y, then g1 along x)
// where gk is the order-k Gaussian-derivative kernel of radius
// int(4 s + 0.5) (4, 12, 20, 28, 36), applied as a correlation; per pixel
//   tmp = sqrt((hyy - hxx)^2 + 4 hxy^2),  low = (hyy + hxx - tmp) / 2,
// and the response is the max over sigmas of max(0, -low). The mask is
// response > threshold (strict), as uint8; the fp32 response is written
// too when the caller passes a buffer for it. One launch covers every
// chosen channel of every page of an (N, K, H, W) fp32 stack.
//
// What bounds it on the H100: operations. The separable filters need
// 205 taps per component per pass, 3 components, 2 passes: 2,460 flops a
// pixel (22 GFLOP on the 4 x 1800 x 1245 baseline maps of the full-size
// spec, 0.33 ms at the 67 TFLOP/s fp32 peak), against 36 MB read and 9 MB
// written (0.013 ms). The design keeps the operations fed:
//   - A block takes a 32 x 32 output tile. It loads the tile with a
//     zero-filled halo of 36 (104 x 104 fp32) into shared memory once.
//   - Per sigma, the vertical pass computes the three column filters g0,
//     g1, g2 of every tile row and of the 32 + 2r columns the horizontal
//     pass will need, into shared memory; each thread takes 4 consecutive
//     rows of one column, so each shared load feeds up to 12 FMAs. The
//     horizontal pass then gives each thread 4 consecutive pixels of one
//     row (again up to 12 FMAs per load; the row stride of the
//     intermediates is odd, so the 32 lanes never hit one bank twice),
//     and the eigenvalue epilogue keeps the running max over sigmas in
//     registers. Nothing intermediate leaves the SM.
//   - The kernel bank (only each sigma's non-zero taps, 615 floats) lives
//     in __constant__ memory, uploaded once by ridge_set_bank; the tap
//     loops are unrolled at compile time per sigma, so every tap is an
//     immediate constant-bank operand of its FMA.
//   The vertical pass computes 32 + 2r columns for 32 outputs, which is
//   1,623 of the 2,238 multiply-adds a pixel costs here against the 1,230
//   of the bound: the price of a tile that keeps everything on chip.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRadius = 36;
constexpr int TW = 32, TH = 32;                 // output tile
constexpr int IN_W = TW + 2 * kMaxRadius;       // 104
constexpr int IN_H = TH + 2 * kMaxRadius;       // 104
constexpr int V_STRIDE = TW + 2 * kMaxRadius + 1;  // 105, odd: conflict-free horizontal loads
constexpr int V_SIZE = TH * V_STRIDE;
constexpr int kBankSize = 3 * (9 + 25 + 41 + 57 + 73);  // 615
constexpr int kMaxChannels = 32;
constexpr size_t kSmemBytes = sizeof(float) * (IN_W * IN_H + 3 * V_SIZE);

// per sigma i (radius r_i, NT = 2 r_i + 1): g0, g1, g2, NT taps each
__constant__ float c_bank[kBankSize];

struct Channels {
  int c[kMaxChannels];
};

// v_k[y][col] = sum_t g_k[t] * in[R - RAD + y + t][R - RAD + col], k = 0, 1, 2
template <int RAD, int OFF>
__device__ __forceinline__ void vertical(const float* __restrict__ in_s, float* __restrict__ v_s) {
  constexpr int NT = 2 * RAD + 1;
  constexpr int NC = TW + 2 * RAD;
  constexpr int ITEMS = (TH / 4) * NC;
  for (int item = threadIdx.x; item < ITEMS; item += kThreads) {
    const int rg = item / NC, col = item - rg * NC;
    const int y0 = rg * 4;
    const float* src = in_s + (kMaxRadius - RAD + y0) * IN_W + (kMaxRadius - RAD + col);
    float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f}, a2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < NT + 3; ++u) {
      const float v = src[u * IN_W];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = u - j;
        if (t >= 0 && t < NT) {
          a0[j] = fmaf(c_bank[OFF + t], v, a0[j]);
          a1[j] = fmaf(c_bank[OFF + NT + t], v, a1[j]);
          a2[j] = fmaf(c_bank[OFF + 2 * NT + t], v, a2[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v_s[(y0 + j) * V_STRIDE + col] = a0[j];
      v_s[V_SIZE + (y0 + j) * V_STRIDE + col] = a1[j];
      v_s[2 * V_SIZE + (y0 + j) * V_STRIDE + col] = a2[j];
    }
  }
}

// hxx = g2 (x) v0, hxy = g1 (x) v1, hyy = g0 (x) v2 at 4 pixels of a row,
// then the eigenvalue epilogue into the running max
template <int RAD, int OFF>
__device__ __forceinline__ void horizontal(const float* __restrict__ v_s, float s2, float resp[4]) {
  constexpr int NT = 2 * RAD + 1;
  const int y = threadIdx.x >> 3, x0 = (threadIdx.x & 7) * 4;
  const float* p0 = v_s + y * V_STRIDE + x0;
  const float* p1 = p0 + V_SIZE;
  const float* p2 = p0 + 2 * V_SIZE;
  float xx[4] = {0.f, 0.f, 0.f, 0.f}, xy[4] = {0.f, 0.f, 0.f, 0.f}, yy[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int u = 0; u < NT + 3; ++u) {
    const float q0 = p0[u], q1 = p1[u], q2 = p2[u];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = u - j;
      if (t >= 0 && t < NT) {
        xx[j] = fmaf(c_bank[OFF + 2 * NT + t], q0, xx[j]);
        xy[j] = fmaf(c_bank[OFF + NT + t], q1, xy[j]);
        yy[j] = fmaf(c_bank[OFF + t], q2, yy[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float hxx = xx[j] * s2, hyy = yy[j] * s2, hxy = xy[j] * s2;
    const float d = hyy - hxx;
    const float tmp = sqrtf(d * d + 4.f * (hxy * hxy));
    const float low = 0.5f * (hyy + hxx - tmp);
    resp[j] = fmaxf(resp[j], low < 0.f ? -low : 0.f);
  }
}

template <int RAD, int OFF>
__device__ __forceinline__ void sigma_pass(const float* in_s, float* v_s, float s2, float resp[4]) {
  vertical<RAD, OFF>(in_s, v_s);
  __syncthreads();
  horizontal<RAD, OFF>(v_s, s2, resp);
  __syncthreads();
}

// grid (tiles_x * tiles_y, N * nc)
__global__ void __launch_bounds__(kThreads, 2) sato_kernel(
    const float* __restrict__ probs, int K, int H, int W, int tiles_x, Channels ch, int nc,
    float threshold, uint8_t* __restrict__ mask, float* __restrict__ response) {
  extern __shared__ float smem[];
  float* in_s = smem;
  float* v_s = smem + IN_W * IN_H;
  const int tile = blockIdx.x;
  const int ty0 = (tile / tiles_x) * TH, tx0 = (tile % tiles_x) * TW;
  const int n = blockIdx.y / nc, j = blockIdx.y % nc;
  const float* plane = probs + ((size_t)n * K + ch.c[j]) * H * W;
  for (int i = threadIdx.x; i < IN_W * IN_H; i += kThreads) {
    const int r = i / IN_W, c = i - r * IN_W;
    const int gy = ty0 - kMaxRadius + r, gx = tx0 - kMaxRadius + c;
    in_s[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? plane[(size_t)gy * W + gx] : 0.f;
  }
  __syncthreads();
  float resp[4] = {0.f, 0.f, 0.f, 0.f};
  sigma_pass<4, 0>(in_s, v_s, 1.f, resp);
  sigma_pass<12, 27>(in_s, v_s, 9.f, resp);
  sigma_pass<20, 102>(in_s, v_s, 25.f, resp);
  sigma_pass<28, 225>(in_s, v_s, 49.f, resp);
  sigma_pass<36, 396>(in_s, v_s, 81.f, resp);
  const int y = ty0 + (threadIdx.x >> 3), x0 = tx0 + (threadIdx.x & 7) * 4;
  if (y >= H) return;
  const size_t out = ((size_t)blockIdx.y * H + y) * W;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int x = x0 + k;
    if (x < W) {
      mask[out + x] = resp[k] > threshold ? 1 : 0;
      if (response) response[out + x] = resp[k];
    }
  }
}

}  // namespace

// Uploads the 615-float kernel bank (per sigma: g0, g1, g2 taps) to the
// constant memory of `device`.
extern "C" int ridge_set_bank(const float* bank, int n, int device) {
  if (n != kBankSize) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(c_bank, bank, sizeof(float) * kBankSize);
}

// probs: (N, K, H, W) fp32 contiguous. channels: nc (<= 32) channel indices
// in host memory. mask: (N, nc, H, W) uint8. response: (N, nc, H, W) fp32
// or null.
extern "C" int sato_ridge_forward(const void* probs, int N, int K, int H, int W,
                                  const int* channels, int nc, float threshold, void* mask,
                                  void* response, int device, void* stream) {
  if (N <= 0 || K <= 0 || H <= 0 || W <= 0 || nc <= 0 || nc > kMaxChannels ||
      (long long)N * nc > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Channels ch;
  for (int i = 0; i < nc; ++i) {
    if (channels[i] < 0 || channels[i] >= K) return (int)cudaErrorInvalidValue;
    ch.c[i] = channels[i];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(sato_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y, N * nc);
  sato_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(probs), K, H, W, tiles_x, ch, nc, threshold,
      static_cast<uint8_t*>(mask), static_cast<float*>(response));
  return (int)cudaGetLastError();
}
