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
// What bounds it on the H100: operations. The separable filters have 205
// taps per component per pass, 3 components, 2 passes: 1,230 multiply-adds
// a pixel filtered tap by tap. The least the function needs is 1,105 fp32
// instructions a pixel (ops/ridge.py:bound_slots_per_pixel): g0 and g2 are
// even and g1 odd, and g1's centre tap and g2's taps at +-s are 0, so in
// the vertical pass, where the 3 components share one input, a tap pair
// costs 2 FADD + 3 FFMA (505 a pixel), and the horizontal pass skips the
// zero taps (600). FADD issues at the FFMA rate, 33.5 T a second (the
// 67 TFLOP/s fp32 peak over 2 flops an FMA): 0.2957 ms on the
// 4 x 1800 x 1245 baseline maps of the full-size spec, against 36 MB read
// and 9 MB written (0.013 ms). This kernel filters tap by tap (the pair
// trick would change the rounding) and keeps the FMA pipes fed:
//   - A block takes a TW x TH = 128 x 16 output tile and stages it once,
//     with a zero-filled halo of 36, into shared memory (88 x 200 fp32).
//     Staging walks rows with a warp and columns with its lanes: coalesced,
//     no division, and each float goes by cp.async (zero-fill outside the
//     map) so all 77 copies of a thread are in flight at once without
//     holding a register. (TMA cannot take the map: its global row stride
//     must be a multiple of 16 bytes, and W = 1245 or 354 is not.)
//   - Per sigma (radius r), the vertical pass filters the TH rows at the
//     TW + 2r columns the horizontal pass needs into three intermediates
//     in shared memory (g0, g1, g2 along y); the horizontal pass then
//     filters them along x and the eigenvalue epilogue keeps the running
//     max over sigmas in registers. Nothing intermediate leaves the SM.
//   - The halo in y costs only loads: the vertical pass reads TH + 2r rows
//     to make TH, and the staging reads (16 + 72) x (128 + 72) floats a
//     tile, 8.6 a pixel, mostly from L2. The halo in x costs multiply-adds:
//     the vertical pass filters TW + 2r columns for TW outputs. Amortised
//     over 128 columns that is 867 multiply-adds a pixel in the vertical
//     pass and 1,482 in all (1.20x the tap-by-tap 1,230, 1.34x the bound's
//     1,105 instructions; 32-wide tiles: 1,623 and 2,238).
//     ops/ridge.py:macs_per_pixel counts them.
//   - Vertical pass: a work item is 2 rows of one column, so one shared
//     load feeds the g0, g1, g2 FMAs of both rows (1:6), and the 8 (TW + 2r)
//     items of a sigma (1,088 to 1,600) keep 85-96% of the 256 threads'
//     rounds busy (only a sigma's last round is partial; 91% weighted by
//     taps). A warp reads 32 neighbouring columns of a row: conflict-free.
//   - Horizontal pass: each thread takes 8 neighbouring pixels of a row, so
//     3 loads feed 24 FMAs (1:8). A warp takes 8 rows x 4 threads x 8
//     pixels; the intermediates' row stride is 201 = 9 mod 32, so the lanes
//     of one tap step read banks 9y + 8k + c (y < 8, k < 4): 32 distinct
//     banks, no conflict.
//   - The kernel bank (only each sigma's non-zero taps, 615 floats) lives
//     in __constant__ memory, uploaded once by ridge_set_bank; the tap
//     loops are unrolled at compile time per sigma, so every tap is an
//     immediate constant-bank operand of its FMA. The horizontal 8-pixel
//     window stays fully unrolled: a version that rolled its middle steps
//     into a loop with the taps in a register window cut the SASS by a third
//     and was faster on the shipped page but slower at full size
//     (chip_smoke.py --ridge-variants times both).
//   - Each output keeps one fmaf chain per component, taps in ascending
//     order, then the s^2 scaling and the epilogue, whatever the tile: the
//     response does not depend on the tile shape, bit for bit.
//   Shared memory: 70,400 B staged input + 38,592 B intermediates =
//   108,992 B a block, two blocks an SM (__launch_bounds__(256, 2), at most
//   128 registers a thread). -Xptxas -v (nvcc 12.9, sm_90a): 56 registers,
//   0 bytes stack frame, 0 bytes spill stores and loads, 1 barrier; 9,552
//   SASS instructions (the 32 x 32 design: 40 registers, 7,528).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRadius = 36;
constexpr int TW = 128, TH = 16;                   // output tile
constexpr int IN_W = TW + 2 * kMaxRadius;          // 200
constexpr int IN_H = TH + 2 * kMaxRadius;          // 88
constexpr int V_STRIDE = IN_W + 1;                 // 201 = 9 mod 32: conflict-free horizontal loads
constexpr int V_SIZE = TH * V_STRIDE;
constexpr int kVRows = 2;                          // rows of one column a vertical work item takes
constexpr int kPixels = 8;                         // pixels of one row a thread takes
constexpr int kBankSize = 3 * (9 + 25 + 41 + 57 + 73);  // 615
constexpr int kMaxChannels = 32;
constexpr size_t kSmemBytes = sizeof(float) * (IN_W * IN_H + 3 * V_SIZE);
static_assert(TW * TH == kThreads * kPixels, "a thread takes 8 pixels of the tile");
static_assert(TH == 2 * 8 && TW == 4 * 32, "8 warps of 8 rows x 32 columns");

// per sigma i (radius r_i, NT = 2 r_i + 1): g0, g1, g2, NT taps each
__constant__ float c_bank[kBankSize];

struct Channels {
  int c[kMaxChannels];
};

// The first of the 8 pixels a thread takes: warp w holds rows 8 (w / 4) + lane / 4
// and columns 32 (w % 4) + 8 (lane % 4) .. + 7.
__device__ __forceinline__ int pixel_row() {
  return ((threadIdx.x >> 7) << 3) + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int pixel_col() {
  return (((threadIdx.x >> 5) & 3) << 5) + ((threadIdx.x & 3) << 3);
}

// v_k[y][col] = sum_t g_k[t] * in[R - RAD + y + t][R - RAD + col], k = 0, 1, 2,
// for y < TH and col < TW + 2 RAD
template <int RAD, int OFF>
__device__ __forceinline__ void vertical(const float* __restrict__ in_s, float* __restrict__ v_s) {
  constexpr int NT = 2 * RAD + 1;
  constexpr int NC = TW + 2 * RAD;
  constexpr int ITEMS = (TH / kVRows) * NC;
  for (int item = threadIdx.x; item < ITEMS; item += kThreads) {
    const int rg = item / NC, col = item - rg * NC;
    const int y0 = rg * kVRows;
    const float* src = in_s + (kMaxRadius - RAD + y0) * IN_W + (kMaxRadius - RAD + col);
    float a0[kVRows] = {0.f, 0.f}, a1[kVRows] = {0.f, 0.f}, a2[kVRows] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < NT + kVRows - 1; ++u) {
      const float v = src[u * IN_W];
#pragma unroll
      for (int j = 0; j < kVRows; ++j) {
        const int t = u - j;
        if (t >= 0 && t < NT) {
          a0[j] = fmaf(c_bank[OFF + t], v, a0[j]);
          a1[j] = fmaf(c_bank[OFF + NT + t], v, a1[j]);
          a2[j] = fmaf(c_bank[OFF + 2 * NT + t], v, a2[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kVRows; ++j) {
      v_s[(y0 + j) * V_STRIDE + col] = a0[j];
      v_s[V_SIZE + (y0 + j) * V_STRIDE + col] = a1[j];
      v_s[2 * V_SIZE + (y0 + j) * V_STRIDE + col] = a2[j];
    }
  }
}

// hxx = g2 (x) v0, hxy = g1 (x) v1, hyy = g0 (x) v2 at the thread's 8 pixels,
// then the eigenvalue epilogue into the running max
template <int RAD, int OFF>
__device__ __forceinline__ void horizontal(const float* __restrict__ v_s, float s2,
                                           float resp[kPixels]) {
  constexpr int NT = 2 * RAD + 1;
  const float* p0 = v_s + pixel_row() * V_STRIDE + pixel_col();
  const float* p1 = p0 + V_SIZE;
  const float* p2 = p0 + 2 * V_SIZE;
  float xx[kPixels], xy[kPixels], yy[kPixels];
#pragma unroll
  for (int j = 0; j < kPixels; ++j) xx[j] = xy[j] = yy[j] = 0.f;
#pragma unroll
  for (int u = 0; u < NT + kPixels - 1; ++u) {
    const float q0 = p0[u], q1 = p1[u], q2 = p2[u];
#pragma unroll
    for (int j = 0; j < kPixels; ++j) {
      const int t = u - j;
      if (t >= 0 && t < NT) {
        xx[j] = fmaf(c_bank[OFF + 2 * NT + t], q0, xx[j]);
        xy[j] = fmaf(c_bank[OFF + NT + t], q1, xy[j]);
        yy[j] = fmaf(c_bank[OFF + t], q2, yy[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPixels; ++j) {
    const float hxx = xx[j] * s2, hyy = yy[j] * s2, hxy = xy[j] * s2;
    const float d = hyy - hxx;
    const float tmp = sqrtf(d * d + 4.f * (hxy * hxy));
    const float low = 0.5f * (hyy + hxx - tmp);
    resp[j] = fmaxf(resp[j], low < 0.f ? -low : 0.f);
  }
}

template <int RAD, int OFF>
__device__ __forceinline__ void sigma_pass(const float* in_s, float* v_s, float s2,
                                           float resp[kPixels]) {
  vertical<RAD, OFF>(in_s, v_s);
  __syncthreads();
  horizontal<RAD, OFF>(v_s, s2, resp);
  __syncthreads();
}

// Copies one float from global to shared memory without passing through a
// register (cp.async, 4 bytes), or writes 0 when `in` is false (zero-fill).
__device__ __forceinline__ void stage4(float* dst, const float* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// Stores 8 mask bytes (bits, little-endian) at p in the widest stores p's
// alignment allows: one 8-byte store when p is 8-aligned, else 2 to 4.
__device__ __forceinline__ void store_mask8(uint8_t* p, uint64_t bits) {
  const int a = (int)(reinterpret_cast<uintptr_t>(p) & 7);
  int next = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i != next) continue;
    const int al = (a + i) & 7;
    if (i == 0 && al == 0) {
      *reinterpret_cast<uint64_t*>(p) = bits;
      next = 8;
    } else if (i <= 4 && (al & 3) == 0) {
      *reinterpret_cast<uint32_t*>(p + i) = (uint32_t)(bits >> (8 * i));
      next = i + 4;
    } else if (i <= 6 && (al & 1) == 0) {
      *reinterpret_cast<uint16_t*>(p + i) = (uint16_t)(bits >> (8 * i));
      next = i + 2;
    } else {
      p[i] = (uint8_t)(bits >> (8 * i));
      next = i + 1;
    }
  }
}

// Stores 8 floats at q in the widest stores q's alignment allows: two
// 16-byte stores when q is 16-aligned, else 3 or 4.
__device__ __forceinline__ void store_float8(float* q, const float v[kPixels]) {
  const int a = (int)((reinterpret_cast<uintptr_t>(q) >> 2) & 3);
  int next = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i != next) continue;
    const int al = (a + i) & 3;
    if (i <= 4 && al == 0) {
      *reinterpret_cast<float4*>(q + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
      next = i + 4;
    } else if (i <= 6 && (al & 1) == 0) {
      *reinterpret_cast<float2*>(q + i) = make_float2(v[i], v[i + 1]);
      next = i + 2;
    } else {
      q[i] = v[i];
      next = i + 1;
    }
  }
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
  // the plane's channel, read with static indices: beside the cp.async asm,
  // indexing the parameter with j made ptxas copy it to a local frame
  int chan = 0;
#pragma unroll
  for (int i = 0; i < kMaxChannels; ++i) chan = i == j ? ch.c[i] : chan;
  const float* plane = probs + ((size_t)n * K + chan) * H * W;
  // a warp stages a row, its lanes 32 neighbouring columns at a time
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < IN_H; r += kThreads / 32) {
    const int gy = ty0 - kMaxRadius + r;
    float* dst = in_s + r * IN_W;
    const bool row_in = gy >= 0 && gy < H;
    const float* src = plane + (size_t)(row_in ? gy : 0) * W;
#pragma unroll
    for (int i = 0; i < (IN_W + 31) / 32; ++i) {
      const int c = lane + 32 * i;
      const int gx = tx0 - kMaxRadius + c;
      if (c < IN_W) {
        const bool in = row_in && gx >= 0 && gx < W;
        stage4(dst + c, in ? src + gx : plane, in);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  float resp[kPixels];
#pragma unroll
  for (int k = 0; k < kPixels; ++k) resp[k] = 0.f;
  sigma_pass<4, 0>(in_s, v_s, 1.f, resp);
  sigma_pass<12, 27>(in_s, v_s, 9.f, resp);
  sigma_pass<20, 102>(in_s, v_s, 25.f, resp);
  sigma_pass<28, 225>(in_s, v_s, 49.f, resp);
  sigma_pass<36, 396>(in_s, v_s, 81.f, resp);
  const int y = ty0 + pixel_row(), x0 = tx0 + pixel_col();
  if (y >= H || x0 >= W) return;
  const size_t out = ((size_t)blockIdx.y * H + y) * W + x0;
  if (x0 + kPixels <= W) {
    uint64_t bits = 0;
#pragma unroll
    for (int k = 0; k < kPixels; ++k) bits |= (uint64_t)(resp[k] > threshold ? 1 : 0) << (8 * k);
    store_mask8(mask + out, bits);
    if (response) store_float8(response + out, resp);
    return;
  }
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    if (x0 + k < W) {
      mask[out + k] = resp[k] > threshold ? 1 : 0;
      if (response) response[out + k] = resp[k];
    }
  }
}

bool valid(int N, int H, int W, int nc) {
  return N > 0 && H > 0 && W > 0 && nc > 0 && nc <= kMaxChannels && (long long)N * nc <= 65535;
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

// The launch the kernel takes for nc channels of N (H, W) maps: output tile
// (tw, th), threads a block, dynamic shared memory bytes a block, grid.
extern "C" int ridge_geometry(int N, int nc, int H, int W, int* tw, int* th, int* threads,
                              int* smem, int* grid_x, int* grid_y) {
  if (!valid(N, H, W, nc)) return (int)cudaErrorInvalidValue;
  *tw = TW;
  *th = TH;
  *threads = kThreads;
  *smem = (int)kSmemBytes;
  *grid_x = ((W + TW - 1) / TW) * ((H + TH - 1) / TH);
  *grid_y = N * nc;
  return 0;
}

// probs: (N, K, H, W) fp32 contiguous. channels: nc (<= 32) channel indices
// in host memory. mask: (N, nc, H, W) uint8. response: (N, nc, H, W) fp32
// or null.
extern "C" int sato_ridge_forward(const void* probs, int N, int K, int H, int W,
                                  const int* channels, int nc, float threshold, void* mask,
                                  void* response, int device, void* stream) {
  if (K <= 0 || !valid(N, H, W, nc)) return (int)cudaErrorInvalidValue;
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
