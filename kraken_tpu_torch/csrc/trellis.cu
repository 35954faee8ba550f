// CTC forced-alignment trellis, for Hopper (sm_90a).
//
// Replaces kraken_tpu/align.py:78 get_trellis_device (a lax.scan over
// frames carrying one trellis row, an XLA program there), batched over the
// lines of a page. For line n with T frames, L >= 1 tokens, emission E
// (T, C) fp32 log-probabilities and tokens tok (L,) it computes exactly the
// numpy get_trellis of kraken_tpu/align.py:53-75:
//   tr[0, 0] = 0, tr[0, 1:] = -inf;
//   tr[1:, 0] = the running sum of E[:, 0], its last L rows set to +inf;
//   tr[t+1, j] = max(tr[t, j] + E[t, 0], tr[t, j-1] + E[t, tok[j-1]]).
// The inputs are padded: emission (N, T_max, C), tokens (N, L_max), with
// each line's frame and token counts; the output (N, T_max + 1, L_max + 1)
// holds each line's trellis in its top-left (T + 1, L + 1) block, and
// nothing else of it is written. Padded frames and tokens are never read.
//
// Bit for bit equal to numpy: every add is a plain fp32 add (no fast math,
// nothing to contract), column 0 is summed frame by frame by one thread, as
// np.cumsum sums, and the max is np.maximum's (the first operand unless the
// second is larger or NaN).
//
// Each block checks its line: 0 <= T <= T_max and 1 <= L <= L_max (else
// it writes nothing), every token in [0, C) (a token outside reads class 0
// instead), and every emission the recurrence reads finite. A line that
// fails sets its bits in `error` (1: counts, 2: tokens, 4: emissions), so
// no token or count sends a read out of bounds and the wrapper raises after
// the launch instead of returning the trellis.
//
// What bounds it on the H100: neither bytes nor operations but the chain of
// T dependent rows. A line reads T * (L + 1) emission values, gathered from
// rows of C floats, and writes (T + 1) * (L + 1) floats, a few hundred KB a
// page against 3.35 TB/s; each row must wait for the one before it. The
// design is the simple one:
// - one block a line, a thread a token column (2 columns a thread where
//   L + 1 exceeds 1024 threads, up to 2048 columns);
// - the current row double-buffered in shared memory, so one __syncthreads
//   a frame separates a row's reads from the next row's writes;
// - each thread loads the next frame's emissions into registers before it
//   computes the current row, so the gather's latency overlaps a step;
// - each row written out coalesced, a thread a column.
// A line of more than 2047 tokens (it needs over 4096 frames; rare, but
// any length must align) takes the "long" kernel: 1024 threads walk the
// row in chunks of 1024 columns, a thread a column of each chunk, and read
// the row before from the output itself, which the block wrote a step
// earlier (the barrier makes it visible), so no length needs more shared
// memory than a block has. Its arithmetic is the same, in the same order.
// Later work (not done): a warp a short line, many lines a block, the next
// emission rows staged by cp.async.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxColsPerThread = 2;

struct Geometry {
  int threads;  // a block's threads
  int cpt;      // token columns a thread (1 or 2), or 0: the long kernel
  int smem;     // dynamic shared memory in bytes: two rows of L_max + 1 floats (16 KB at most)
};

Geometry geometry(int L_max) {
  const int cols = L_max + 1;
  if (cols > kMaxColsPerThread * kMaxThreads) return {kMaxThreads, 0, 0};
  const int cpt = cols > kMaxThreads ? 2 : 1;
  const int per = (cols + cpt - 1) / cpt;
  return {(per + 31) / 32 * 32, cpt, 2 * cols * (int)sizeof(float)};
}

// np.maximum: a, unless b is larger or NaN (a NaN a stays)
__device__ __forceinline__ float np_maximum(float a, float b) {
  return (a >= b || a != a) ? a : b;
}

template <int CPT>
__global__ void __launch_bounds__(kMaxThreads)
trellis_kernel(const float* __restrict__ emission, const int* __restrict__ tokens,
               const int* __restrict__ frame_lens, const int* __restrict__ token_lens,
               float* __restrict__ trellis, int T_max, int C, int L_max,
               int* __restrict__ error) {
  extern __shared__ float rows[];  // two rows of W floats
  const int n = blockIdx.x;
  const int T = frame_lens[n];
  const int L = token_lens[n];
  if (T < 0 || T > T_max || L < 1 || L > L_max) {  // the same for every thread
    if (threadIdx.x == 0) atomicOr(error, 1);
    return;
  }
  const int W = L_max + 1;
  const float* E = emission + (size_t)n * T_max * C;
  float* out = trellis + (size_t)n * (T_max + 1) * W;
  // rows first_inf.. of column 0 are the +inf sentinels (the last L rows)
  const int first_inf = T + 1 - L;
  const float inf = __int_as_float(0x7f800000);

  int bad = 0;
  int col[CPT];
  int tok[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    col[k] = j;
    tok[k] = (j >= 1 && j <= L) ? tokens[(size_t)n * L_max + j - 1] : 0;
    if (tok[k] < 0 || tok[k] >= C) {
      bad |= 2;
      tok[k] = 0;
    }
  }
  // row 0
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int j = col[k];
    if (j <= L) {
      const float v = j == 0 ? (first_inf <= 0 ? inf : 0.f) : -inf;
      rows[j] = v;
      out[j] = v;
    }
  }
  // this frame's emissions: the blank, and each column's token
  float e0 = 0.f;
  float et[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) et[k] = 0.f;
  if (T > 0) {
    e0 = E[0];
#pragma unroll
    for (int k = 0; k < CPT; ++k)
      if (col[k] >= 1 && col[k] <= L) et[k] = E[tok[k]];
  }
  float acc = 0.f;  // the running sum of column 0 (thread 0 only)
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* prev = rows + (t & 1) * W;
    float* cur = rows + ((t + 1) & 1) * W;
    float* orow = out + (size_t)(t + 1) * W;
    // the next frame's emissions, loaded while this row is computed
    float n0 = 0.f;
    float nt[CPT];
#pragma unroll
    for (int k = 0; k < CPT; ++k) nt[k] = 0.f;
    if (t + 1 < T) {
      const float* e = E + (size_t)(t + 1) * C;
      n0 = e[0];
#pragma unroll
      for (int k = 0; k < CPT; ++k)
        if (col[k] >= 1 && col[k] <= L) nt[k] = e[tok[k]];
    }
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int j = col[k];
      if (j > L) continue;
      float v;
      if (j == 0) {
        if (!isfinite(e0)) bad |= 4;
        acc = __fadd_rn(acc, e0);
        v = t + 1 >= first_inf ? inf : acc;
      } else {
        if (!isfinite(et[k])) bad |= 4;
        const float stay = __fadd_rn(prev[j], e0);
        const float advance = __fadd_rn(prev[j - 1], et[k]);
        v = np_maximum(stay, advance);
      }
      cur[j] = v;
      orow[j] = v;
    }
    e0 = n0;
#pragma unroll
    for (int k = 0; k < CPT; ++k) et[k] = nt[k];
    __syncthreads();
  }
  if (bad) atomicOr(error, bad);
}

// The trellis of a line of any length (the kernel above for L + 1 > 2048
// columns): the same checks and arithmetic, the columns walked in chunks of
// blockDim.x, the row before read back from `trellis`.
__global__ void __launch_bounds__(kMaxThreads)
trellis_long_kernel(const float* __restrict__ emission, const int* __restrict__ tokens,
                    const int* __restrict__ frame_lens, const int* __restrict__ token_lens,
                    float* trellis, int T_max, int C, int L_max, int* __restrict__ error) {
  const int n = blockIdx.x;
  const int T = frame_lens[n];
  const int L = token_lens[n];
  if (T < 0 || T > T_max || L < 1 || L > L_max) {
    if (threadIdx.x == 0) atomicOr(error, 1);
    return;
  }
  const int W = L_max + 1;
  const float* E = emission + (size_t)n * T_max * C;
  const int* tok = tokens + (size_t)n * L_max;
  float* out = trellis + (size_t)n * (T_max + 1) * W;
  const int first_inf = T + 1 - L;
  const float inf = __int_as_float(0x7f800000);
  int bad = 0;
  for (int j = threadIdx.x; j <= L; j += blockDim.x) {
    out[j] = j == 0 ? (first_inf <= 0 ? inf : 0.f) : -inf;
    if (j >= 1 && (tok[j - 1] < 0 || tok[j - 1] >= C)) bad |= 2;
  }
  float acc = 0.f;
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float* e = E + (size_t)t * C;
    const float* prev = out + (size_t)t * W;
    float* cur = out + (size_t)(t + 1) * W;
    const float e0 = e[0];
    for (int j = threadIdx.x; j <= L; j += blockDim.x) {
      float v;
      if (j == 0) {
        if (!isfinite(e0)) bad |= 4;
        acc = __fadd_rn(acc, e0);
        v = t + 1 >= first_inf ? inf : acc;
      } else {
        int k = tok[j - 1];
        if (k < 0 || k >= C) k = 0;
        const float et = e[k];
        if (!isfinite(et)) bad |= 4;
        const float stay = __fadd_rn(prev[j], e0);
        const float advance = __fadd_rn(prev[j - 1], et);
        v = np_maximum(stay, advance);
      }
      cur[j] = v;
    }
    __syncthreads();
  }
  if (bad) atomicOr(error, bad);
}

template <int CPT>
cudaError_t launch(const float* emission, const int* tokens, const int* frame_lens,
                   const int* token_lens, float* trellis, int N, int T_max, int C, int L_max,
                   int* error, const Geometry& g, cudaStream_t stream) {
  trellis_kernel<CPT><<<N, g.threads, g.smem, stream>>>(emission, tokens, frame_lens, token_lens,
                                                        trellis, T_max, C, L_max, error);
  return cudaGetLastError();
}

}  // namespace

// emission (N, T_max, C) fp32, tokens (N, L_max) int32, frame_lens and
// token_lens (N,) int32, all contiguous on `device`; trellis (N, T_max + 1,
// L_max + 1) fp32; error one int32, zeroed by the caller, which gets the
// bits of the lines the kernel refused. Returns a cudaError_t.
extern "C" int trellis_forward(const void* emission, const void* tokens, const void* frame_lens,
                               const void* token_lens, void* trellis, void* error, int N,
                               int T_max, int C, int L_max, int device, void* stream) {
  if (N <= 0 || T_max < 0 || C <= 0 || L_max <= 0) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(L_max);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* e = static_cast<const float*>(emission);
  const int* tok = static_cast<const int*>(tokens);
  const int* fl = static_cast<const int*>(frame_lens);
  const int* tl = static_cast<const int*>(token_lens);
  float* out = static_cast<float*>(trellis);
  int* err_bits = static_cast<int*>(error);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g.cpt) {
    case 0:
      trellis_long_kernel<<<N, g.threads, 0, s>>>(e, tok, fl, tl, out, T_max, C, L_max, err_bits);
      return (int)cudaGetLastError();
    case 1: return (int)launch<1>(e, tok, fl, tl, out, N, T_max, C, L_max, err_bits, g, s);
    case 2: return (int)launch<2>(e, tok, fl, tl, out, N, T_max, C, L_max, err_bits, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
