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
// a few dozen flops a pixel. So the design spends as little as it can on
// anything but the stores:
// - One block takes a band of kBand output rows and a chunk of CW output
//   columns of one (sample, class) plane (grid: column chunks, bands,
//   planes). It stages the few input rows and columns the band reads (about
//   kBand * in / out + 2 rows) in shared memory once, converted to fp32.
// - Each thread computes the horizontal taps of its columns once and lerps
//   every staged row at them into a shared (rows x CW) buffer: a row's
//   horizontal lerp is computed once, not once per output row that reads it.
// - Each output row (one warp a row, lanes on its 16-byte lines of y) is
//   then one vertical lerp of two buffered rows and the sigmoid, stored 16
//   bytes at a time; a row's unaligned head and tail (OW = 354 or 1245
//   starts rows anywhere in a 16-byte line) are peeled into scalar stores.
//   A lane reads its 4 lerped values out of two aligned float4 loads of the
//   buffer. (A first version gave each thread of the block one line of any
//   row: an integer division and 64-bit index math per line, and 4 scalar
//   shared loads with 4-way bank conflicts on 3 of 4 rows of a 1245-wide
//   map; chip_smoke.py timed it at 0.063 ms at full size, this one at
//   0.049, on an H100 80GB HBM3 at 700 W.)
// The arithmetic is that of the plain version step by step (no fused
// multiply-adds; the horizontal lerp of a row is the same value whichever
// output row reads it), so the output is bit-identical to it.
// The host picks CW so that a block's shared memory stays within 48 KB, and
// sizes the staged rows and columns exactly (max over the bands and chunks,
// with the taps computed as the device computes them).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kBand = 16;                // output rows a block takes
constexpr size_t kSmemBudget = 48 << 10;  // dynamic shared memory a block may take

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_f(const __half* p) { return __half2float(*p); }

// Source index pair and weight of the upper one, align_corners=False. The
// arithmetic is rounded step by step (no fused multiply-adds), as the plain
// version computes it: a fused position moves a sample by an ulp of the
// coordinate, which steep logits turn into 1e-5 of probability. The host
// copy (x86-64 SSE float arithmetic, no contraction) gives the same indices;
// it only sizes the shared memory.
__host__ __device__ __forceinline__ void taps(int o, float scale, int n_in, int* i0, int* i1,
                                              float* lam) {
#ifdef __CUDA_ARCH__
  const float f = fmaxf(__fsub_rn(__fmul_rn((float)o + 0.5f, scale), 0.5f), 0.f);
#else
  const float p = ((float)o + 0.5f) * scale;
  const float f = std::max(p - 0.5f, 0.f);
#endif
  const int i = (int)f < n_in - 1 ? (int)f : n_in - 1;
  *i0 = i;
  *i1 = i + 1 < n_in - 1 ? i + 1 : n_in - 1;
  *lam = f - (float)i;
}

// First and last source index the outputs [o0, o1) read (taps are monotone in o).
__host__ __device__ __forceinline__ void span(int o0, int o1, float scale, int n_in, int* lo,
                                              int* hi) {
  int a, b;
  float l;
  taps(o0, scale, n_in, lo, &a, &l);
  taps(o1 - 1, scale, n_in, &a, hi, &l);
}

struct Geometry {
  int cw;     // output columns a block takes (a multiple of 4)
  int rows;   // staged input rows, the most any band reads
  int cols;   // staged input columns, the most any column chunk reads
  size_t smem;
};

// The most input indices any of the runs of `run` outputs of [0, n_out) reads.
int max_span(int n_out, int run, float scale, int n_in) {
  int most = 0;
  for (int o0 = 0; o0 < n_out; o0 += run) {
    int lo, hi;
    span(o0, std::min(o0 + run, n_out), scale, n_in, &lo, &hi);
    most = std::max(most, hi - lo + 1);
  }
  return most;
}

size_t smem_bytes(int rows, int cols, int cw) {
  // lerped rows (4 pad floats each side), staged input rows, and the
  // vertical taps of the band
  return sizeof(float) * ((size_t)rows * (cw + 8) + (size_t)rows * cols) + 3 * sizeof(float) * kBand;
}

Geometry geometry(int h, int w, int OH, int OW) {
  const float sy = (float)h / (float)OH, sx = (float)w / (float)OW;
  Geometry g;
  g.rows = max_span(OH, kBand, sy, h);
  for (int chunks = 1;; ++chunks) {
    g.cw = ((OW + chunks - 1) / chunks + 3) & ~3;
    if (g.cw <= 4) g.cw = 4;
    g.cols = max_span(OW, g.cw, sx, w);
    g.smem = smem_bytes(g.rows, g.cols, g.cw);
    if (g.smem <= kSmemBudget || g.cw == 4) return g;
  }
}

// v[q] = p[4 + 4j - sh + q], q = 0..3, for p 16-byte aligned and 0 <= sh < 4,
// from the aligned float4s at 4j and 4j + 4 (sh is the same across a warp)
__device__ __forceinline__ void gather4(const float* p, int j, int sh, float v[4]) {
  const float4 b = *reinterpret_cast<const float4*>(p + 4 * j + 4);
  if (sh == 0) {
    v[0] = b.x, v[1] = b.y, v[2] = b.z, v[3] = b.w;
    return;
  }
  const float4 a = *reinterpret_cast<const float4*>(p + 4 * j);
  const float w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = sh == 1 ? w[3 + q] : (sh == 2 ? w[2 + q] : w[1 + q]);
}

// grid (ceil(OW / CW), ceil(OH / kBand), N*K); dynamic shared memory
// smem_bytes(ROWS, COLS, CW)
template <typename T>
__global__ void __launch_bounds__(kThreads) seghead_kernel(const T* __restrict__ x,
                                                           float* __restrict__ y, int h, int w,
                                                           int OH, int OW, float sy, float sx,
                                                           int CW, int ROWS, int COLS) {
  extern __shared__ float smem[];
  float* lerp_s = smem;                           // [ROWS][4 + CW + 4] horizontal lerps
  float* in_s = lerp_s + (size_t)ROWS * (CW + 8); // [ROWS][COLS] staged input, fp32
  int* vy0 = reinterpret_cast<int*>(in_s + (size_t)ROWS * COLS);  // [kBand] per output row:
  int* vy1 = vy0 + kBand;                                          // staged row of each tap
  float* vly = reinterpret_cast<float*>(vy1 + kBand);              // and the lower weight

  const int c0 = blockIdx.x * CW, c1 = min(c0 + CW, OW), cw = c1 - c0;
  const int oy0 = blockIdx.y * kBand, oy1 = min(oy0 + kBand, OH), band = oy1 - oy0;
  const size_t plane = blockIdx.z;
  int ylo, yhi, xlo, xhi;
  span(oy0, oy1, sy, h, &ylo, &yhi);
  span(c0, c1, sx, w, &xlo, &xhi);
  const int rows = yhi - ylo + 1, cols = xhi - xlo + 1;

  // 1. stage the input rows and columns the block reads, and the band's vertical taps
  const T* src = x + (plane * h + ylo) * w + xlo;
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols, c = i - r * cols;
    in_s[r * COLS + c] = load_f(src + (size_t)r * w + c);
  }
  if (threadIdx.x < band) {
    int a, b;
    float l;
    taps(oy0 + threadIdx.x, sy, h, &a, &b, &l);
    vy0[threadIdx.x] = a - ylo;
    vy1[threadIdx.x] = b - ylo;
    vly[threadIdx.x] = l;
  }
  __syncthreads();

  // 2. the horizontal lerp of every staged row, once, at this block's columns
  for (int c = threadIdx.x; c < cw; c += kThreads) {
    int a, b;
    float lx;
    taps(c0 + c, sx, w, &a, &b, &lx);
    a -= xlo;
    b -= xlo;
    const float ux = 1.f - lx;
    for (int r = 0; r < rows; ++r) {
      const float* row = in_s + r * COLS;
      lerp_s[r * (CW + 8) + 4 + c] = __fadd_rn(__fmul_rn(ux, row[a]), __fmul_rn(lx, row[b]));
    }
  }
  __syncthreads();

  // 3. each output row, one warp a row: a vertical lerp of two lerped rows,
  // the sigmoid, and 16-byte stores. Lane j takes the row's j-th 16-byte
  // line of y; a row starting `sh` elements into a line reads its 4 lerped
  // values out of the two aligned float4s around them in the buffer (4 pad
  // floats on each side of a buffer row). The lines at the row's two ends
  // may hold only part of it (scalar stores).
  const int yo = (int)((reinterpret_cast<uintptr_t>(y) >> 2) & 3);  // y's offset in its line
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rr = warp; rr < band; rr += kThreads / 32) {
    const size_t rb = (plane * OH + oy0 + rr) * OW + c0;  // element index of the row's first output
    const int sh = (int)((rb + yo) & 3);
    const int lines = (cw + sh + 3) >> 2;
    const float* top = lerp_s + vy0[rr] * (CW + 8);  // column k at top[4 + k]
    const float* bot = lerp_s + vy1[rr] * (CW + 8);
    const float ly = vly[rr], uy = 1.f - ly;
    float* out = y + rb - sh;  // 16-byte aligned
    for (int j = lane; j < lines; j += 32) {
      float t[4], b[4];
      gather4(top, j, sh, t);
      gather4(bot, j, sh, b);
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float s = __fadd_rn(__fmul_rn(uy, t[q]), __fmul_rn(ly, b[q]));
        v[q] = 1.f / (1.f + expf(-s));
      }
      const int k0 = 4 * j - sh;  // the line's first column
      if (k0 >= 0 && k0 + 3 < cw) {
        *reinterpret_cast<float4*>(out + 4 * j) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (k0 + q >= 0 && k0 + q < cw) out[4 * j + q] = v[q];
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, float* y, int NK, int h, int w, int OH, int OW,
                   cudaStream_t stream) {
  const Geometry g = geometry(h, w, OH, OW);
  const dim3 grid((OW + g.cw - 1) / g.cw, (OH + kBand - 1) / kBand, NK);
  seghead_kernel<T><<<grid, kThreads, g.smem, stream>>>(
      static_cast<const T*>(x), y, h, w, OH, OW, (float)h / (float)OH, (float)w / (float)OW, g.cw,
      g.rows, g.cols);
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

// The block shape the kernel takes for (h, w) -> (OH, OW): output columns
// per block, staged input rows and columns, dynamic shared memory bytes.
extern "C" int seghead_geometry(int h, int w, int OH, int OW, int* cw, int* rows, int* cols,
                                int* smem) {
  if (h <= 0 || w <= 0 || OH < h || OW < w) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(h, w, OH, OW);
  *cw = g.cw;
  *rows = g.rows;
  *cols = g.cols;
  *smem = (int)g.smem;
  return 0;
}
