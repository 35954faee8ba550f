// Recognition tail: temperature softmax over the classes, then the
// per-frame argmax and max, for Hopper (sm_90a).
//
// Replaces the tail of the recognition forward of
// kraken_tpu/inference/recognition.py:143 (prepare_recognition._tail,
// jitted into fwd there):
//   probs  = softmax(logits.astype(float32) / T, axis=C)   (N, C, W)
//   labels = argmax_C probs                                 (N, W) int64
//   confs  = max_C probs                                    (N, W) fp32
// on logits of shape (N, C, 1, W), fp32, bf16 or fp16, in any strides,
// computed in fp32. The full probs are written only when the caller passes
// a pointer for them (a consumer such as a non-greedy decoder needs them);
// on the greedy path only the (N, W) labels and confidences are written.
//
// What bounds it: bytes. The logits are read once and the outputs written
// once; the arithmetic is a few fp32 operations, one expf and one fp64 add
// a logit, far below the card's rates. The flagship batch, (64, 250, 1, 128)
// fp32, is 8.2 MB of logits: 2.5 us at 3.35 TB/s. A thread a frame would
// leave that batch 2 warps an SM, too few to hide the memory's latency, and
// in the network's layout a warp's lanes would read C elements apart.
//
// Design ("tile" route, every C up to 3,615): a block of 16 warps takes a
// tile of F consecutive frames of one line (F = 32, or 16 or 8 where the
// tile would not leave room for two blocks an SM); grid N x ceil(W / F),
// flattened, the ragged last tile of a line masked. A warp takes a frame
// (two of a 32-frame tile), lanes on classes c = lane (mod 32).
// 1. The logits, read once, coalesced, as x * (1/T) in fp32 (bf16/fp16
//    widened as they are read):
//    - in the network's layout (a (N, C, 1, W) view of (N, W, C): sc = 1,
//      sw = C; and any layout whose class stride is the smaller) with
//      C <= 256, a warp loads its two frames straight into registers, 8
//      classes a lane, neighbouring lanes on neighbouring classes; all 16
//      loads of a lane are in flight before the first frame's arithmetic
//      waits on its own, so the second frame's loads overlap the first
//      frame's arithmetic. (Staging them in shared memory and passing
//      over the staged rows, as the other layouts do, takes 0.0090 ms at
//      the flagship shape against 0.0064: `chip_smoke.py --tail-variants`,
//      "staged", on an H100 80GB HBM3 at 700 W.)
//    - otherwise the block stages the tile in shared memory, frame f's
//      class c at tile[f * cp + c], cp = C rounded up to odd, copying along
//      the axis of the smaller stride: in the contiguous layout (sw = 1) a
//      warp copies class rows, lanes on the tile's frames; a lane issues its
//      16 loads of a round before it stores any. A warp then passes over
//      its frame's row.
// 2. A frame's arithmetic, from registers or over the staged row:
//    - m = max of x / T, by redux.sync on the floats' order-preserving ints;
//    - e = expf(x / T - m) in fp32, summed in fp64 per lane, then across
//      lanes by a fixed xor tree (the same order on every run), rounded to
//      fp32 once: s;
//    - the confidence is the largest posterior, e / s at e = exp(0) = 1:
//      1 / s, correctly rounded; the label is the first class whose
//      posterior e / s (an fp32 division) equals it, by redux.sync min.
//      Only classes within 2^-20 of e = 1 can round to it, so without the
//      posteriors only those few are divided.
//    With the posteriors every p = e / s is divided and kept in shared
//    memory.
// 3. The posteriors, when asked for, leave the tile class by class: the F
//    frames of a class are F consecutive floats of the (N, C, W) output, so
//    each store of a warp is coalesced, and the odd row stride cp keeps the
//    transposed read of the tile free of bank conflicts.
// Each step is rounded as the plain version rounds it on the card (x times
// the fp32 reciprocal of T, which is how torch divides a CUDA tensor by a
// scalar; expf; an fp32 division by s), so the numerators equal the plain
// version's bit for bit, and so does the sum but where its fp64 sums, taken
// in another order, round to two neighbouring floats: probs agree to an ulp.
// (The plain version sums in fp64 for that reason: torch.softmax's fp32 sum
// was up to 1.43e-6 off this kernel's at 250 classes.) Two classes whose
// probabilities are that close may swap as the argmax.
// Where the time goes (`chip_smoke.py --tail-variants`, H100 80GB HBM3,
// 700 W, flagship shape fp32): 0.0064 ms device; a bare launch of the same
// grid takes 0.0010, the loads alone 0.0032, the arithmetic alone 0.0066.
// The arithmetic sets the time and the loads hide under it, 2.6x the bytes
// bound.
//
// "Direct" route, C above 3,615 (where even 8 frames of fp32 would not
// leave room for two blocks an SM): still a warp per frame (16 frames a
// block), reading its frame's classes straight from device memory in three
// passes (max; sum; posteriors and label), coalesced along C in the
// network's layout; the second and third pass find the frame in L1 or L2.
//
// tail_geometry answers the launch (route, F, threads, shared bytes,
// blocks) for a shape; kraken_tpu_torch/ops/tail.py:plan mirrors it.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxFrames = 32;                        // frames of a tile, at most
constexpr int kFramesPerWarp = kMaxFrames / kWarps;   // in the compute step, at most
constexpr int kRound = 8;                             // loads a lane issues per frame slot and round
constexpr int kRegClasses = 8;  // classes a lane holds in registers: C <= 256 runs from registers
// shared memory a block may take so that two blocks fit an SM (233,472
// bytes an SM on an H100, 1 KB of it reserved for each block)
constexpr int kSmemTwoBlocks = 233472 / 2 - 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_f(const __half* p) { return __half2float(*p); }

struct Launch {
  int route;  // 0 tile, 1 direct
  int frames;
  int threads;
  int smem;
  long long blocks;
};

// the row stride of the tile: C rounded up to odd
__host__ __device__ __forceinline__ int row_stride(int C) { return C | 1; }

Launch plan(int N, int C, int W) {
  const long long cp = row_stride(C);
  for (int f = kMaxFrames; f >= 8; f /= 2) {
    if (f * cp * 4 <= kSmemTwoBlocks) {
      return {0, f, kThreads, (int)(f * cp * 4), (long long)N * ((W + f - 1) / f)};
    }
  }
  return {1, kWarps, kThreads, 0, ((long long)N * W + kWarps - 1) / kWarps};
}

// warp-wide max of a float: redux.sync on an int whose order is the float's
__device__ __forceinline__ int ordered(int i) { return i >= 0 ? i : i ^ 0x7fffffff; }
__device__ __forceinline__ float warp_max(float m) {
  return __int_as_float(ordered(__reduce_max_sync(kFull, ordered(__float_as_int(m)))));
}

// warp-wide fp64 sum by a fixed xor tree: every lane adds the same pairs in
// the same order, on every run
__device__ __forceinline__ double warp_sum(double s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// The label and confidence of a frame. The largest posterior is e / s at
// e = exp(0) = 1, so the confidence is 1 / s (correctly rounded, as the
// plain version's division rounds it) and the label the first class whose
// posterior equals it: `cand` is a lane's first such class, or kNone.
constexpr unsigned kNone = 0xffffffffu;
// a class whose e is below this has a posterior below 1 / s: e / s is then
// 2^-20 below 1 / s, at least 8 of its ulps, so it rounds below RN(1 / s)
constexpr float kNear = 1.f - 0x1p-20f;
__device__ __forceinline__ void frame_out(unsigned cand, float conf, int lane, int64_t* label,
                                          float* confs) {
  cand = __reduce_min_sync(kFull, cand);
  if (lane == 0) {
    *label = cand == kNone ? 0 : cand;
    *confs = conf;
  }
}

// The tail of a frame whose x / T a lane holds in v[j] for class
// lane + 32 j (-inf beyond C). Writes the posteriors into row[0, C) where
// row is not null.
template <int K>
__device__ __forceinline__ void frame_regs(float (&v)[K], int C, int lane, float* row,
                                           int64_t* label, float* confs) {
  float m = v[0];
#pragma unroll
  for (int j = 1; j < K; ++j) m = fmaxf(m, v[j]);
  m = warp_max(m);
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    v[j] = lane + 32 * j < C ? expf(v[j] - m) : 0.f;
    s += (double)v[j];
  }
  const float sum = (float)warp_sum(s);
  const float conf = __frcp_rn(sum);
  unsigned cand = kNone;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = lane + 32 * j;
    if (c < C && (row != nullptr || v[j] >= kNear)) {
      const float p = __fdiv_rn(v[j], sum);
      if (row != nullptr) row[c] = p;
      if (p == conf) cand = min(cand, (unsigned)c);
    }
  }
  frame_out(cand, conf, lane, label, confs);
}

// The same for a frame of any C whose x / T sit in row[0, C) (shared
// memory): passes over the row, leaving e there, or the posteriors where
// keep_p is set.
__device__ __forceinline__ void frame_loop(float* row, int C, int lane, bool keep_p,
                                           int64_t* label, float* confs) {
  float m = -INFINITY;
  for (int c = lane; c < C; c += 32) m = fmaxf(m, row[c]);
  m = warp_max(m);
  double s = 0.0;
  for (int c = lane; c < C; c += 32) {
    const float e = expf(row[c] - m);
    row[c] = e;
    s += (double)e;
  }
  const float sum = (float)warp_sum(s);
  const float conf = __frcp_rn(sum);
  unsigned cand = kNone;
  for (int c = lane; c < C; c += 32) {
    const float e = row[c];
    if (keep_p || e >= kNear) {
      const float p = __fdiv_rn(e, sum);
      if (keep_p) row[c] = p;
      if (p == conf) cand = min(cand, (unsigned)c);
    }
  }
  frame_out(cand, conf, lane, label, confs);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    tail_tile_kernel(const T* __restrict__ x, float* __restrict__ probs,
                     int64_t* __restrict__ labels, float* __restrict__ confs, int C, int W,
                     long long sn, long long sc, long long sw, int F, int log2_f, int tiles_w,
                     bool lanes_on_frames, float inv_t) {
  extern __shared__ float tile[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n = blockIdx.x / tiles_w;
  const int w0 = (int)(blockIdx.x - n * tiles_w) * F;
  const int nf = min(F, W - w0);
  const int cp = row_stride(C);
  const T* src = x + n * sn + w0 * sw;
  const bool keep_p = probs != nullptr;
  const long long frame0 = n * W + w0;

  if (C <= 32 * kRegClasses && !lanes_on_frames) {
    // lanes on classes: a warp's frames straight into registers
    float v[kFramesPerWarp][kRegClasses];
#pragma unroll
    for (int q = 0; q < kFramesPerWarp; ++q) {
      const int f = warp + q * kWarps;
#pragma unroll
      for (int j = 0; j < kRegClasses; ++j) {
        const int c = lane + 32 * j;
        v[q][j] = f < nf && c < C ? __fmul_rn(load_f(src + f * sw + c * sc), inv_t) : -INFINITY;
      }
    }
#pragma unroll
    for (int q = 0; q < kFramesPerWarp; ++q) {
      const int f = warp + q * kWarps;
      if (f < nf) {
        frame_regs(v[q], C, lane, keep_p ? tile + f * cp : nullptr, labels + frame0 + f,
                   confs + frame0 + f);
      }
    }
  } else {
    // 1. stage x / T, along the axis of the smaller stride
    if (lanes_on_frames) {
      // lanes on frames, warps on classes
      constexpr int kRows = kRound * kFramesPerWarp;
      for (int c0 = warp; c0 < C; c0 += kWarps * kRows) {
        float v[kRows];
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int c = c0 + j * kWarps;
          v[j] = lane < nf && c < C ? load_f(src + c * sc + lane * sw) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int c = c0 + j * kWarps;
          if (lane < nf && c < C) tile[lane * cp + c] = __fmul_rn(v[j], inv_t);
        }
      }
    } else {
      // a warp on its frames, lanes on classes
      for (int c0 = lane; c0 < C; c0 += 32 * kRound) {
        float v[kFramesPerWarp][kRound];
#pragma unroll
        for (int q = 0; q < kFramesPerWarp; ++q) {
          const int f = warp + q * kWarps;
#pragma unroll
          for (int j = 0; j < kRound; ++j) {
            const int c = c0 + 32 * j;
            v[q][j] = f < nf && c < C ? load_f(src + f * sw + c * sc) : 0.f;
          }
        }
#pragma unroll
        for (int q = 0; q < kFramesPerWarp; ++q) {
          const int f = warp + q * kWarps;
#pragma unroll
          for (int j = 0; j < kRound; ++j) {
            const int c = c0 + 32 * j;
            if (f < nf && c < C) tile[f * cp + c] = __fmul_rn(v[q][j], inv_t);
          }
        }
      }
    }
    __syncthreads();

    // 2. a warp per frame
#pragma unroll
    for (int q = 0; q < kFramesPerWarp; ++q) {
      const int f = warp + q * kWarps;
      if (f < nf) {
        frame_loop(tile + f * cp, C, lane, keep_p, labels + frame0 + f, confs + frame0 + f);
      }
    }
  }
  if (!keep_p) return;
  __syncthreads();

  // 3. the posteriors, class by class: (N, C, W) contiguous
  float* out = probs + n * C * (long long)W + w0;
  for (int i = threadIdx.x; i < C * F; i += kThreads) {
    const int c = i >> log2_f, f = i & (F - 1);
    if (f < nf) out[(long long)c * W + f] = tile[f * cp + c];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tail_direct_kernel(const T* __restrict__ x, float* __restrict__ probs,
                       int64_t* __restrict__ labels, float* __restrict__ confs, int C, int W,
                       long long sn, long long sc, long long sw, long long frames, float inv_t) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= frames) return;  // the whole warp
  const long long n = g / W;
  const int w = (int)(g - n * W);
  const T* col = x + n * sn + w * sw;

  float m = -INFINITY;
  for (int c0 = lane; c0 < C; c0 += 32 * kRound) {
    float v[kRound];
#pragma unroll
    for (int j = 0; j < kRound; ++j) {
      const int c = c0 + 32 * j;
      v[j] = c < C ? __fmul_rn(load_f(col + c * sc), inv_t) : -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < kRound; ++j) m = fmaxf(m, v[j]);
  }
  m = warp_max(m);

  double s = 0.0;
  for (int c0 = lane; c0 < C; c0 += 32 * kRound) {
    float v[kRound];
#pragma unroll
    for (int j = 0; j < kRound; ++j) {
      const int c = c0 + 32 * j;
      v[j] = c < C ? __fmul_rn(load_f(col + c * sc), inv_t) : -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < kRound; ++j) s += (double)expf(v[j] - m);
  }
  const float sum = (float)warp_sum(s);
  const float conf = __frcp_rn(sum);

  unsigned cand = kNone;
  float* out = probs != nullptr ? probs + n * C * (long long)W + w : nullptr;
  for (int c0 = lane; c0 < C; c0 += 32 * kRound) {
    float v[kRound];
#pragma unroll
    for (int j = 0; j < kRound; ++j) {
      const int c = c0 + 32 * j;
      v[j] = c < C ? __fmul_rn(load_f(col + c * sc), inv_t) : -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < kRound; ++j) {
      const int c = c0 + 32 * j;
      const float e = expf(v[j] - m);
      if (c < C && (out != nullptr || e >= kNear)) {
        const float p = __fdiv_rn(e, sum);
        if (out != nullptr) out[(long long)c * W] = p;
        if (p == conf) cand = min(cand, (unsigned)c);
      }
    }
  }
  frame_out(cand, conf, lane, labels + g, confs + g);
}

template <typename T>
cudaError_t launch(const void* x, float* probs, int64_t* labels, float* confs, int N, int C, int W,
                   long long sn, long long sc, long long sw, float inv_t, cudaStream_t stream) {
  const Launch l = plan(N, C, W);
  const T* xt = static_cast<const T*>(x);
  if (l.route == 1) {
    tail_direct_kernel<T><<<(unsigned)l.blocks, l.threads, 0, stream>>>(
        xt, probs, labels, confs, C, W, sn, sc, sw, (long long)N * W, inv_t);
    return cudaGetLastError();
  }
  if (l.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tail_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
    if (err != cudaSuccess) return err;
  }
  int log2_f = 0;
  while ((1 << log2_f) < l.frames) ++log2_f;
  // lanes along the axis of the smaller stride
  const bool lanes_on_frames = sw < sc && C > 1 && W > 1;
  tail_tile_kernel<T><<<(unsigned)l.blocks, l.threads, l.smem, stream>>>(
      xt, probs, labels, confs, C, W, sn, sc, sw, l.frames, log2_f, (W + l.frames - 1) / l.frames,
      lanes_on_frames, inv_t);
  return cudaGetLastError();
}

bool valid(int N, int C, int W) {
  return N > 0 && C > 0 && W > 0 && plan(N, C, W).blocks <= 0x7fffffffLL;
}

}  // namespace

// The launch the kernel takes for (N, C, 1, W) logits of any type: route
// (0 tile, 1 direct), frames a block, threads a block, dynamic shared
// memory bytes a block, blocks.
extern "C" int tail_geometry(int N, int C, int W, int* route, int* frames, int* threads, int* smem,
                             long long* blocks) {
  if (!valid(N, C, W)) return (int)cudaErrorInvalidValue;
  const Launch l = plan(N, C, W);
  *route = l.route;
  *frames = l.frames;
  *threads = l.threads;
  *smem = l.smem;
  *blocks = l.blocks;
  return 0;
}

// x: (N, C, W) logits with element strides (sn, sc, sw), dtype 0 fp32 /
// 1 bf16 / 2 fp16. probs: (N, C, W) contiguous fp32, or null to skip
// writing them. labels: (N, W) int64; confs: (N, W) fp32.
extern "C" int tail_forward(const void* x, void* probs, void* labels, void* confs, int N, int C,
                            int W, long long sn, long long sc, long long sw, float temperature,
                            int dtype, int device, void* stream) {
  if (!valid(N, C, W) || temperature == 0.f || !std::isfinite(temperature)) {
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
