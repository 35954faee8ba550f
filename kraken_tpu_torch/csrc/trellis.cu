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
// Bit for bit equal to numpy on every route: every add is a plain fp32 add
// (__fadd_rn: no fast math, nothing to contract), column 0 is summed frame
// by frame, as np.cumsum sums, and the max is np.maximum's (the first
// operand unless the second is larger or NaN).
//
// Each line is checked: 0 <= T <= T_max and 1 <= L <= L_max (else nothing
// of it is written), every token in [0, C) (a token outside reads class 0
// instead), and every emission the recurrence reads finite. A line that
// fails sets its bits in `error` (1: counts, 2: tokens, 4: emissions), so
// no token or count sends a read out of bounds and the wrapper raises after
// the launch instead of returning the trellis.
//
// What bounds it on the H100: neither bytes nor operations but the chain of
// T dependent rows. A line reads T * (L + 1) emission values, gathered from
// rows of C floats, and writes (T + 1) * (L + 1) floats, a few hundred KB a
// page against 3.35 TB/s; each row must wait for the one before it, so a
// line's time is T times the latency of one row.
//
// The first design (the "block" route) gave a line a block of up to 1,024
// threads, a thread a column, the row double-buffered in shared memory: a
// frame cost a __syncthreads across the block, a round trip through shared
// memory and the gather of the next frame's emissions, about 0.25 us a
// frame on the fixture page (0.0596 ms for 264 frames). Almost every line
// of a page is short (the fixture page's longest has 89 tokens), so the
// "warp" route, the one the pages take, gives a line one warp and keeps
// its row in registers:
// - lane l holds columns j = l + 32 k, k < K, K the smallest of 1, 2, 4 and
//   8 with 32 K >= L_max + 1 (up to 256 columns); a block holds
//   kWarpLines warps (fewer where their chunks exceed its shared memory), a
//   line each, and no barrier: each warp runs alone;
// - column j - 1 of the row before comes by one __shfl_sync a k (lane l
//   reads lane l - 1, lane 0 reads lane 31, whose value of k - 1 is column
//   32 k - 1); column 0 is computed by every lane and kept by lane 0 by a
//   select, so the warp never diverges;
// - the emissions come through shared memory in chunks of kChunk frames:
//   a chunk is kChunk whole rows of the line, one contiguous run of
//   kChunk * C floats, copied by cp.async 16 bytes a lane (4 at its
//   unaligned ends) while the chunk before it is computed, two buffers a
//   warp; each column then reads its token from the staged row. One wait
//   and two __syncwarp a chunk, no copy inside the frame loop. (Copies
//   issued every frame, whether gathers of a lane's K + 1 values into
//   registers 1 to 16 frames ahead or by cp.async into a ring, or a ring
//   of whole rows, held the chain at 2-3 times its time without them: a
//   warp issues its copies between the steps of its own chain;
//   `chip_smoke.py --trellis-variants` splits the time);
// - each row is stored coalesced, 32 consecutive floats a k.
// The block route stays for lines of 257 to 2,048 columns (a thread a
// column, 2 a thread above 1,024) and for codecs whose chunks exceed a
// block's shared memory (C over 1,815), and the "long" route for lines
// above 2,048 columns (over 2,047 tokens, so over 4,094 frames: rare, but
// any length must align): 1,024 threads walk the row in chunks of 1,024
// columns and read the row before back from the output, which the block
// wrote a step earlier (the barrier makes it visible), so no length needs
// more shared memory than a block has. Their arithmetic is the same, in
// the same order. One launch takes a page: the route is the first of warp,
// block and long that takes the page (geometry(); the wrapper mirrors it in
// ops/trellis.py:plan and passes it in).
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxColsPerThread = 2;
constexpr int kStaticSmem = 48 * 1024;
constexpr int kWarpMaxK = 8;   // the warp route's most columns a lane: 32 * 8 = 256 a line
constexpr int kWarpLines = 4;  // lines (warps) a block on the warp route, at most
constexpr int kChunk = 16;     // frames of emission rows a warp stages at once

enum Route { kWarp = 0, kBlock = 1, kLong = 2 };

struct Geometry {
  int route;
  int k;        // token columns a thread: K (warp), 1 or 2 (block), chunks of 1,024 (long)
  int threads;  // a block's threads
  int lines;    // lines a block
  int smem;     // dynamic shared memory in bytes: the warp route's two chunks a warp, the block
                // route's two rows of L_max + 1 floats
  int blocks;
};

// A warp's two chunk buffers on the warp route, in floats: kChunk rows of C
// floats and 3 to align the first 16-byte copy, rounded up to 16 bytes.
__host__ __device__ inline int chunk_floats(int C) { return (kChunk * C + 3 + 3) / 4 * 4; }

// The launch of `route` for N lines of up to L_max tokens over C classes
// on a card whose blocks may have `optin` bytes of shared memory; false
// when the route does not take the page.
bool route_geometry(int route, int N, int L_max, int C, int optin, Geometry* g) {
  const int cols = L_max + 1;
  switch (route) {
    case kWarp: {
      const long long warp_bytes = 2LL * chunk_floats(C) * sizeof(float);
      const int lines = (int)std::min<long long>(kWarpLines, optin / warp_bytes);
      if (cols > 32 * kWarpMaxK || lines < 1) return false;
      int k = 1;
      while (32 * k < cols) k *= 2;
      *g = {kWarp, k, 32 * lines, lines, (int)(lines * warp_bytes), (N + lines - 1) / lines};
      return true;
    }
    case kBlock: {
      if (cols > kMaxColsPerThread * kMaxThreads) return false;
      const int cpt = cols > kMaxThreads ? 2 : 1;
      const int per = (cols + cpt - 1) / cpt;
      *g = {kBlock, cpt, (per + 31) / 32 * 32, 1, 2 * cols * (int)sizeof(float), N};
      return true;
    }
    case kLong:
      *g = {kLong, (cols + kMaxThreads - 1) / kMaxThreads, kMaxThreads, 1, 0, N};
      return true;
    default:
      return false;
  }
}

// The route a page takes on `device`: the first of warp, block and long
// that takes it.
cudaError_t geometry(int N, int L_max, int C, int device, Geometry* g) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  for (int route = kWarp; !route_geometry(route, N, L_max, C, optin, g); ++route) {
  }
  return cudaSuccess;
}

// np.maximum: a, unless b is larger or NaN (a NaN a stays)
__device__ __forceinline__ float np_maximum(float a, float b) {
  return (a >= b || a != a) ? a : b;
}

// Copies 4 or 16 bytes from global to shared memory without passing
// through a register (cp.async).
__device__ __forceinline__ void fetch4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void fetch16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// Floats of `p` past a 16-byte boundary.
__device__ __forceinline__ int misalign(const float* p) {
  return (int)((reinterpret_cast<size_t>(p) >> 2) & 3);
}

// A warp copies `count` floats from `src` to `dst` + misalign(src), whose
// 16-byte boundaries then fall on src's: 4-byte copies up to the first
// boundary and after the last, 16-byte copies between them.
__device__ __forceinline__ void stage_run(float* dst, const float* src, int count, int lane) {
  const int shift = misalign(src);
  dst += shift;
  const int head = min(count, (4 - shift) & 3);
  const int body = (count - head) / 4;
  for (int i = lane; i < head; i += 32) fetch4(dst + i, src + i);
  for (int i = lane; i < body; i += 32) fetch16(dst + head + 4 * i, src + head + 4 * i);
  for (int i = head + 4 * body + lane; i < count; i += 32) fetch4(dst + i, src + i);
}

// The warp route: warp w of block b takes line b * (blockDim.x / 32) + w,
// lane l its columns l + 32 k. The same checks and arithmetic as the block
// kernel.
template <int K>
__global__ void __launch_bounds__(32 * kWarpLines)
trellis_warp_kernel(const float* __restrict__ emission, const int* __restrict__ tokens,
                    const int* __restrict__ frame_lens, const int* __restrict__ token_lens,
                    float* __restrict__ trellis, int N, int T_max, int C, int L_max,
                    int* __restrict__ error) {
  extern __shared__ float chunks[];  // a warp's two buffers of chunk_floats(C)
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= N) return;
  const int T = frame_lens[n];
  const int L = token_lens[n];
  if (T < 0 || T > T_max || L < 1 || L > L_max) {  // the same for every lane
    if (lane == 0) atomicOr(error, 1);
    return;
  }
  const int W = L_max + 1;
  const float* E = emission + (size_t)n * T_max * C;
  float* out = trellis + (size_t)n * (T_max + 1) * W;
  const int first_inf = T + 1 - L;  // rows first_inf.. of column 0 are +inf
  const float inf = __int_as_float(0x7f800000);
  float* buffers = chunks + (size_t)(threadIdx.x >> 5) * 2 * chunk_floats(C);

  int bad = 0;
  int tok[K];     // each column's class (0 for column 0 and past the line)
  bool live[K];   // 1 <= j <= L: a token column of the line
  float row[K];   // the row before, column l + 32 k
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    live[k] = j >= 1 && j <= L;
    tok[k] = live[k] ? tokens[(size_t)n * L_max + j - 1] : 0;
    if (tok[k] < 0 || tok[k] >= C) {
      bad |= 2;
      tok[k] = 0;
    }
    row[k] = j == 0 ? (first_inf <= 0 ? inf : 0.f) : -inf;
    if (j <= L) out[j] = row[k];
  }
  // chunk c, frames c * kChunk on, into buffer c % 2 (one group a chunk,
  // committed even when empty, so a group is a chunk)
  auto stage = [&](int c) {
    const int f0 = c * kChunk;
    if (f0 < T)
      stage_run(buffers + (c & 1) * chunk_floats(C), E + (size_t)f0 * C,
                (min(T, f0 + kChunk) - f0) * C, lane);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage(0);
  float acc = 0.f;  // the running sum of column 0 (the same in every lane)
  float* orow = out + W;
  for (int f0 = 0, c = 0; f0 < T; f0 += kChunk, ++c) {
    __syncwarp();  // every lane is done with chunk c - 1, whose buffer chunk c + 1 takes
    stage(c + 1);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // chunk c has landed ...
    __syncwarp();  // ... every lane's part of it
    const float* rows = buffers + (c & 1) * chunk_floats(C) + misalign(E + (size_t)f0 * C);
    const int f1 = min(T, f0 + kChunk);
    for (int t = f0; t < f1; ++t, orow += W, rows += C) {
      const float e0 = rows[0];
      if (!isfinite(e0)) bad |= 4;
      acc = __fadd_rn(acc, e0);
      // column j - 1 of the row before: lane l - 1's, and for lane 0 lane
      // 31's of k - 1 (kept from the shuffle of k - 1)
      float left[K];
#pragma unroll
      for (int k = 0; k < K; ++k) left[k] = __shfl_sync(0xffffffffu, row[k], (lane + 31) & 31);
#pragma unroll
      for (int k = K - 1; k >= 1; --k) left[k] = lane == 0 ? left[k - 1] : left[k];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float et = rows[tok[k]];
        if (live[k] && !isfinite(et)) bad |= 4;
        float v = np_maximum(__fadd_rn(row[k], e0), __fadd_rn(left[k], et));
        if (k == 0 && lane == 0) v = t + 1 >= first_inf ? inf : acc;  // column 0
        row[k] = v;
        if (lane + 32 * k <= L) orow[lane + 32 * k] = v;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (bad) atomicOr(error, bad);
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

template <int K>
cudaError_t launch_warp(const float* emission, const int* tokens, const int* frame_lens,
                        const int* token_lens, float* trellis, int N, int T_max, int C, int L_max,
                        int* error, const Geometry& g, cudaStream_t stream) {
  if (g.smem > kStaticSmem) {
    cudaError_t err = cudaFuncSetAttribute(trellis_warp_kernel<K>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (err != cudaSuccess) return err;
  }
  trellis_warp_kernel<K><<<g.blocks, g.threads, g.smem, stream>>>(
      emission, tokens, frame_lens, token_lens, trellis, N, T_max, C, L_max, error);
  return cudaGetLastError();
}

}  // namespace

// The launch a page of N lines of up to L_max tokens over C classes takes
// on `device`: its route (0 warp, 1 block, 2 long), the token columns a
// thread, the threads and the lines a block, the dynamic shared memory a
// block and the blocks.
extern "C" int trellis_geometry(int N, int L_max, int C, int device, int* route, int* k,
                                int* threads, int* lines, int* smem, int* blocks) {
  if (N <= 0 || L_max <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  Geometry g;
  const cudaError_t err = geometry(N, L_max, C, device, &g);
  if (err != cudaSuccess) return (int)err;
  *route = g.route;
  *k = g.k;
  *threads = g.threads;
  *lines = g.lines;
  *smem = g.smem;
  *blocks = g.blocks;
  return 0;
}

// emission (N, T_max, C) fp32, tokens (N, L_max) int32, frame_lens and
// token_lens (N,) int32, all contiguous on `device`; trellis (N, T_max + 1,
// L_max + 1) fp32; error one int32, zeroed by the caller, which gets the
// bits of the lines the kernel refused; route 0 (warp), 1 (block) or 2
// (long), which must take the page on the card (the wrapper passes
// geometry()'s, as its plan mirrors it). Returns a cudaError_t.
extern "C" int trellis_forward(const void* emission, const void* tokens, const void* frame_lens,
                               const void* token_lens, void* trellis, void* error, int N,
                               int T_max, int C, int L_max, int route, int device, void* stream) {
  if (N <= 0 || T_max < 0 || C <= 0 || L_max <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  Geometry g;
  if (!route_geometry(route, N, L_max, C, optin, &g)) return (int)cudaErrorInvalidValue;
  const float* e = static_cast<const float*>(emission);
  const int* tok = static_cast<const int*>(tokens);
  const int* fl = static_cast<const int*>(frame_lens);
  const int* tl = static_cast<const int*>(token_lens);
  float* out = static_cast<float*>(trellis);
  int* err_bits = static_cast<int*>(error);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g.route == kLong) {
    trellis_long_kernel<<<N, g.threads, 0, s>>>(e, tok, fl, tl, out, T_max, C, L_max, err_bits);
    return (int)cudaGetLastError();
  }
  if (g.route == kBlock)
    return (int)(g.k == 1 ? launch<1> : launch<2>)(e, tok, fl, tl, out, N, T_max, C, L_max,
                                                   err_bits, g, s);
  switch (g.k) {
    case 1: return (int)launch_warp<1>(e, tok, fl, tl, out, N, T_max, C, L_max, err_bits, g, s);
    case 2: return (int)launch_warp<2>(e, tok, fl, tl, out, N, T_max, C, L_max, err_bits, g, s);
    case 4: return (int)launch_warp<4>(e, tok, fl, tl, out, N, T_max, C, L_max, err_bits, g, s);
    case 8: return (int)launch_warp<8>(e, tok, fl, tl, out, N, T_max, C, L_max, err_bits, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
