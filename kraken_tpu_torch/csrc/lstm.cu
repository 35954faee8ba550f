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
// D is 1 or 2. Direction 0 runs reversed iff `reverse0`; direction 1 runs
// the other way, so one launch (gridDim.y = D) computes both directions of
// a bidirectional layer into the concatenated (B, T, D, H) layout.
//
// Peephole variant (a template flag of both designs; replaces the lax.scan
// kraken_tpu/nn/layers.py:_peephole_scan of the legacy ocropy LSTM): with
// peephole weights p = (w_ip, w_fp, w_op) of direction d,
//   i = sigmoid(i + w_ip * c),  f = sigmoid(f + w_fp * c),  g = tanh(g)
//   c' = f * c + i * g;  o = sigmoid(o + w_op * c');  h' = o * tanh(c')
// o reads the new cell, i and f the old one. The thread that owns a unit
// keeps its three peephole weights in registers for the whole launch. The
// mask acts as above; the ocropy layer passes an all-true one.
//
// What bounds it on the H100: the T dependent steps, not bytes or flops.
// The work, 2*B*T*4H*H flops on the fp32 CUDA cores (67 TFLOP/s), and the
// bytes the function must move (gates once, out once, w_hh once) are both
// far below the time of T steps that each need all of w_hh (4H x H: 640 KB
// in fp32 at H = 200) and the whole of h from the step before. w_hh is more
// than the 227 KB of shared memory one block may hold, so a single block per
// row tile has to stream it from L2 on every step; and every step ends in an
// exchange of h between all the blocks that share a row tile.
//
// Two designs, chosen per call by the wrapper (ops/lstm.py:_design) from
// the shapes alone:
//
// "cluster" (lstm_cluster_kernel): w_hh stays on chip across a thread-block
//   cluster. One cluster of C CTAs (8, or 16 as a non-portable size) per
//   (tile of R rows, direction). CTA j owns hidden units
//   [j*H/C, (j+1)*H/C) with all four gates of each, loads its slice of
//   w_hh into shared memory once (from the torch layout (D, 4H, H), in any
//   of fp32/bf16/fp16, converted to fp32), and keeps h of the whole tile in
//   shared memory, double-buffered. Per step each CTA computes its units'
//   R x 4U dot products of length H from shared memory, applies the cell
//   update, and sends its slice of h' into the next h buffer of every CTA
//   of the cluster with st.async (distributed shared memory), which counts
//   the bytes on an mbarrier of the receiving CTA. A CTA starts step s+1 as
//   soon as its own mbarrier has all H*R*4 bytes of h: there is no cluster
//   barrier per step (cluster.sync() puts a fence over the whole GPU,
//   MEMBAR.ALL.GPU, before its barrier). Two buffers are enough: a CTA
//   holds all of step s's bytes only after every thread of every CTA has
//   sent them (the last send of each warp follows all of its reads), and each
//   thread sends only after its own reads of the buffer it is about to
//   have overwritten. Nothing is sent after the last step, so no store
//   outlives its receiver.
//   Inside a CTA four lanes share one (unit, group of 4 rows): each sums
//   every fourth term of the 4 gates x 4 rows products (two float4 shared
//   loads for 16 FMAs), and two shuffle rounds leave lane r with the four
//   gates of row r. Units run fastest across lanes, so 8 lanes read 8
//   neighbouring gate columns of one row (coalesced) and share one h load
//   (broadcast); with a row stride HP = 4 mod 8 float4s the w_hh loads of a
//   quarter warp never hit one bank twice. A step's gates are loaded before
//   the wait for h, so their latency hides behind it.
//   Shared memory per CTA (4 bytes each):
//   ceil(H/C) * HP * 4 (w_hh) + 2 * R * HP (h) + ceil(H/C) * R (c),
//   which bounds H to about 320 at C = 8 and 460 at C = 16.
//
// "stream" (lstm_stream_kernel, unchanged from the first port), for the
//   hidden sizes whose w_hh does not fit a cluster (up to H = 1024): one
//   block per (tile of 4 rows, direction), thread k owning hidden unit k,
//   w_hh read from L2 (transposed fp32 copy, (D, H, 4H)) on every step, h
//   exchanged through double-buffered shared memory, one __syncthreads()
//   per step.
//
// Layouts (all contiguous):
//   gates  (B, T, D, 4H)  fp32 | bf16 | fp16, biases included
//   w_hh   (D, 4H, H)     fp32 | bf16 | fp16, the torch weight_hh (cluster)
//   w_hh_t (D, H, 4H)     fp32, the transposed torch weight_hh (stream)
//   mask   (B, T)         bool (one byte)
//   peep   (D, 3, H)      fp32 (w_ip, w_fp, w_op), or null for the plain cell
//   out    (B, T, D, H)   the type of gates

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

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

// dtype codes shared with the wrapper: 0 = fp32, 1 = bf16, 2 = fp16
__device__ __forceinline__ float load_f32(const void* p, int dtype, size_t i) {
  switch (dtype) {
    case 1: return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case 2: return __half2float(static_cast<const __half*>(p)[i]);
    default: return static_cast<const float*>(p)[i];
  }
}

// ------------------------------------------------------------------ cluster

constexpr int CLUSTER_THREADS = 512;
constexpr int MAX_ITERS = 4;  // (unit, row) slots per thread: units * R <= MAX_ITERS * CLUSTER_THREADS
constexpr unsigned FULL = 0xffffffffu;

// float4 row stride of w_hh and h in shared memory: >= H and 4 mod 8, so
// that two 64-byte spans half a stride apart fill one 128-byte bank line
__host__ __device__ __forceinline__ int padded_h(int H) { return H + ((12 - H % 8) % 8); }

struct ClusterShape {
  int units;    // ceil(H / C): the most hidden units a CTA owns
  int hp;       // padded row stride, in float4
  int iters;    // (unit, row) slots each thread takes per step
  int threads;  // block size, a multiple of 32
  size_t smem;  // dynamic shared memory, bytes
};

ClusterShape cluster_shape(int H, int C, int R) {
  ClusterShape s;
  s.units = (H + C - 1) / C;
  s.hp = padded_h(H);
  const int slots = s.units * R;  // one lane per (unit, row)
  s.iters = (slots + CLUSTER_THREADS - 1) / CLUSTER_THREADS;
  s.threads = ((slots + s.iters - 1) / s.iters + 31) / 32 * 32;
  // w_hh slice, h double-buffered, c, and one mbarrier per h buffer
  s.smem = sizeof(float4) * ((size_t)s.units * s.hp + 2 * (size_t)(R / 4) * s.hp) +
           sizeof(float) * (size_t)s.units * R + 2 * sizeof(uint64_t);
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the address `a` of this CTA's shared memory in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// a 16-byte store into another CTA's shared memory that counts its bytes
// on that CTA's mbarrier
__device__ __forceinline__ void st_async(uint32_t a, float4 v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
               :: "r"(a), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar) : "memory");
}

// the one arrival of a phase, announcing the bytes that complete it
__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(bar), "r"(bytes) : "memory");
}

// waits for the phase of `parity` to complete; the stores of other CTAs that
// completed it are visible afterwards. A phase that never completes (a lost
// store) traps after ~10 s instead of hanging the card.
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if ((i & 1023) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (i == 0) start = now;
      else if (now - start > 10000000000ull) __trap();
    }
  }
}

template <typename T, int ITERS, bool PEEP>
__global__ void __launch_bounds__(CLUSTER_THREADS) lstm_cluster_kernel(
    const T* __restrict__ gates, const void* __restrict__ w_hh, int w_dtype,
    const uint8_t* __restrict__ mask, const float* __restrict__ peep, T* __restrict__ out,
    int B, int T_len, int D, int H, int R, int reverse0) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int d = blockIdx.y;
  const int row0 = (blockIdx.x / C) * R;
  const bool reverse = (d == 1) != (reverse0 != 0);
  const int G = 4 * H;
  const int u0 = rank * H / C;
  const int n_units = (rank + 1) * H / C - u0;
  const int max_units = (H + C - 1) / C;
  const int HP = padded_h(H);
  const int RG = R / 4;  // groups of 4 rows

  extern __shared__ float4 smem[];
  float4* w_s = smem;                         // [max_units][HP]: the 4 gates of unit u0+ul, column k
  float4* h_s = w_s + (size_t)max_units * HP; // [2][RG][HP]: rows 4g..4g+3 of h, unit k
  float* c_s = reinterpret_cast<float*>(h_s + 2 * (size_t)RG * HP);  // [n_units*RG][4]
  uint64_t* bar = reinterpret_cast<uint64_t*>(c_s + (size_t)max_units * R);  // [2]: h buffer full
  // every CTA stores h of its units for all R rows into each h buffer of every CTA
  const uint32_t step_bytes = (uint32_t)H * R * sizeof(float);

  for (int i = threadIdx.x; i < n_units * H; i += blockDim.x) {
    const int ul = i / H, k = i % H;
    const size_t base = ((size_t)d * G + u0 + ul) * H + k;
    w_s[(size_t)ul * HP + k] = make_float4(load_f32(w_hh, w_dtype, base),
                                           load_f32(w_hh, w_dtype, base + (size_t)H * H),
                                           load_f32(w_hh, w_dtype, base + (size_t)2 * H * H),
                                           load_f32(w_hh, w_dtype, base + (size_t)3 * H * H));
  }
  for (int i = threadIdx.x; i < RG * HP; i += blockDim.x) h_s[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < n_units * R; i += blockDim.x) c_s[i] = 0.f;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(bar + b)) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    expect_bytes(smem_u32(bar), step_bytes);
    expect_bytes(smem_u32(bar + 1), step_bytes);
  }
  // every CTA of the cluster is running and initialised before any DSMEM store
  cluster.sync();

  // (unit, row group) pairs, 4 lanes each, units fastest: 8 lanes of a warp
  // read 8 neighbouring gate columns of one row, and share its h loads
  const int n_items = n_units * RG;
  const int lane = threadIdx.x & 31;
  // the peephole weights of each slot's unit, read once
  float pw[ITERS][3];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int q = 0; q < 3; ++q) pw[it][q] = 0.f;
    if constexpr (PEEP) {
      const int item = (it * blockDim.x + threadIdx.x) >> 2;
      if (item < n_items) {
#pragma unroll
        for (int q = 0; q < 3; ++q) pw[it][q] = peep[((size_t)d * 3 + q) * H + u0 + item % n_units];
      }
    }
  }
  for (int s = 0; s < T_len; ++s) {
    const int t = reverse ? T_len - 1 - s : s;
    const int cur = s & 1;
    const float4* hc = h_s + (size_t)cur * RG * HP;
    const uint32_t next_h = smem_u32(h_s + (size_t)(cur ^ 1) * RG * HP);
    const uint32_t next_bar = smem_u32(bar + (cur ^ 1));

    // this step's inputs of the cell update, in flight while h arrives
    float gx[ITERS][4];
    bool m[ITERS];
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int item = (it * blockDim.x + threadIdx.x) >> 2;
      const int b = row0 + (item / n_units) * 4 + (threadIdx.x & 3);
      m[it] = false;
#pragma unroll
      for (int q = 0; q < 4; ++q) gx[it][q] = 0.f;
      if (item < n_items && b < B) {
        const T* g = gates + (((size_t)b * T_len + t) * D + d) * G + u0 + item % n_units;
#pragma unroll
        for (int q = 0; q < 4; ++q) gx[it][q] = to_f32<T>(g[q * H]);
        m[it] = mask[(size_t)b * T_len + t] != 0;
      }
    }
    // h of step s: zeros at s = 0, else the (s-1)/2-th fill of buffer cur.
    // Re-arming the buffer's next phase at once is safe: its bytes are sent
    // only after this CTA has sent h of step s + 1, which thread 0 does later.
    if (s > 0) {
      const uint32_t b = smem_u32(bar + cur);
      wait_phase(b, ((s - 1) >> 1) & 1);
      if (threadIdx.x == 0) expect_bytes(b, step_bytes);
    }

#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int item = (it * blockDim.x + threadIdx.x) >> 2;
      const int ks = threadIdx.x & 3;  // this lane's share of k, and the row it updates
      const bool valid = item < n_items;
      const int ul = valid ? item % n_units : 0;
      const int rg = valid ? item / n_units : 0;
      const int b = row0 + rg * 4 + ks;
      const bool live = valid && b < B;
      const int u = u0 + ul;

      float acc[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[q][r] = 0.f;
      }
      const float4* wr = w_s + (size_t)ul * HP;
      const float4* hr = hc + (size_t)rg * HP;
#pragma unroll 4
      for (int k = ks; k < H; k += 4) {
        const float4 w = wr[k];
        const float4 hv = hr[k];
        const float wq[4] = {w.x, w.y, w.z, w.w};
        const float hrow[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[q][r] = fmaf(wq[q], hrow[r], acc[q][r]);
        }
      }

      // sum over the 4 lanes of the item; lane ks keeps the gates of row ks
      const bool hi = ks & 2, lo = ks & 1;
      float s1[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float keep = hi ? acc[q][2 + j] : acc[q][j];
          const float send = hi ? acc[q][j] : acc[q][2 + j];
          s1[q][j] = keep + __shfl_xor_sync(FULL, send, 2);
        }
      }
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float keep = lo ? s1[q][1] : s1[q][0];
        const float send = lo ? s1[q][0] : s1[q][1];
        pre[q] = gx[it][q] + keep + __shfl_xor_sync(FULL, send, 1);
      }

      float h_out = 0.f;  // padding rows keep h = 0
      if (live) {
        float* c = c_s + 4 * item + ks;
        const float h_old = reinterpret_cast<const float*>(hc + (size_t)rg * HP + u)[ks];
        const float c_old = *c;
        float c_new, h_new;
        if constexpr (PEEP) {
          c_new = sigmoid(pre[1] + pw[it][1] * c_old) * c_old +
                  sigmoid(pre[0] + pw[it][0] * c_old) * tanhf(pre[2]);
          h_new = sigmoid(pre[3] + pw[it][2] * c_new) * tanhf(c_new);
        } else {
          c_new = sigmoid(pre[1]) * c_old + sigmoid(pre[0]) * tanhf(pre[2]);
          h_new = sigmoid(pre[3]) * tanhf(c_new);
        }
        if (m[it]) *c = c_new;
        h_out = m[it] ? h_new : h_old;
        out[(((size_t)b * T_len + t) * D + d) * H + u] = from_f32<T>(m[it] ? h_new : 0.f);
      }
      // the 4 rows of unit u as one float4, sent by the 4 lanes to all C CTAs;
      // nothing is sent after the last step, so no store outlives a CTA
      const int base = lane & ~3;
      const float4 h4 = make_float4(__shfl_sync(FULL, h_out, base), __shfl_sync(FULL, h_out, base + 1),
                                    __shfl_sync(FULL, h_out, base + 2), __shfl_sync(FULL, h_out, base + 3));
      if (valid && s + 1 < T_len) {
        const uint32_t dst = next_h + (uint32_t)(((size_t)rg * HP + u) * sizeof(float4));
        for (int r = ks; r < C; r += 4) st_async(map_rank(dst, r), h4, map_rank(next_bar, r));
      }
    }
  }
}

template <typename T, int ITERS, bool PEEP>
cudaError_t launch_cluster_iters(const ClusterShape& s, const void* gates, const void* w_hh, int w_dtype,
                                 const uint8_t* mask, const float* peep, void* out, int B, int T_len,
                                 int D, int H, int C, int R, int reverse0, cudaStream_t stream,
                                 int* max_clusters) {
  auto kernel = lstm_cluster_kernel<T, ITERS, PEEP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((B + R - 1) / R), D);
  cfg.blockDim = dim3(s.threads);
  cfg.dynamicSmemBytes = s.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (*max_clusters == 0) return cudaErrorLaunchOutOfResources;
  if (gates == nullptr) return cudaSuccess;  // a query only (lstm_cluster_occupancy)
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(gates), w_hh, w_dtype, mask, peep,
                            static_cast<T*>(out), B, T_len, D, H, R, reverse0);
}

template <typename T, bool PEEP>
cudaError_t launch_cluster_peep(const ClusterShape& s, const void* gates, const void* w_hh, int w_dtype,
                                const uint8_t* mask, const float* peep, void* out, int B, int T_len,
                                int D, int H, int C, int R, int reverse0, cudaStream_t stream,
                                int* max_clusters) {
  switch (s.iters) {
    case 1: return launch_cluster_iters<T, 1, PEEP>(s, gates, w_hh, w_dtype, mask, peep, out, B, T_len, D, H, C, R, reverse0, stream, max_clusters);
    case 2: return launch_cluster_iters<T, 2, PEEP>(s, gates, w_hh, w_dtype, mask, peep, out, B, T_len, D, H, C, R, reverse0, stream, max_clusters);
    case 3: return launch_cluster_iters<T, 3, PEEP>(s, gates, w_hh, w_dtype, mask, peep, out, B, T_len, D, H, C, R, reverse0, stream, max_clusters);
    case 4: return launch_cluster_iters<T, 4, PEEP>(s, gates, w_hh, w_dtype, mask, peep, out, B, T_len, D, H, C, R, reverse0, stream, max_clusters);
    default: return cudaErrorInvalidValue;  // units * R above MAX_ITERS * CLUSTER_THREADS
  }
}

template <typename T>
cudaError_t launch_cluster(const void* gates, const void* w_hh, int w_dtype, const uint8_t* mask,
                           const float* peep, void* out, int B, int T_len, int D, int H, int C, int R,
                           int reverse0, cudaStream_t stream, int* max_clusters) {
  const ClusterShape s = cluster_shape(H, C, R);
  if (peep != nullptr) {
    return launch_cluster_peep<T, true>(s, gates, w_hh, w_dtype, mask, peep, out, B, T_len, D, H, C, R, reverse0, stream, max_clusters);
  }
  return launch_cluster_peep<T, false>(s, gates, w_hh, w_dtype, mask, peep, out, B, T_len, D, H, C, R, reverse0, stream, max_clusters);
}

// ------------------------------------------------------------------- stream

constexpr int ROWS = 4;
static_assert(ROWS == 4, "h is exchanged as one float4 per hidden unit");

// one thread per hidden unit, H <= 1024: the bound caps registers so that
// every admitted H launches
template <typename T, bool PEEP>
__global__ void __launch_bounds__(1024) lstm_stream_kernel(const T* __restrict__ gates,
                                       const float* __restrict__ w_hh_t,
                                       const uint8_t* __restrict__ mask,
                                       const float* __restrict__ peep,
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
  // this unit's peephole weights (w_ip, w_fp, w_op), read once
  float pw[3] = {0.f, 0.f, 0.f};
  if constexpr (PEEP) {
    if (active) {
#pragma unroll
      for (int q = 0; q < 3; ++q) pw[q] = peep[((size_t)d * 3 + q) * H + k];
    }
  }
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
        float c_new, h_new;
        if constexpr (PEEP) {
          const float ig = sigmoid(acc[0][r] + pw[0] * c[r]);
          const float fg = sigmoid(acc[1][r] + pw[1] * c[r]);
          c_new = fg * c[r] + ig * tanhf(acc[2][r]);
          h_new = sigmoid(acc[3][r] + pw[2] * c_new) * tanhf(c_new);
        } else {
          const float ig = sigmoid(acc[0][r]);
          const float fg = sigmoid(acc[1][r]);
          const float gg = tanhf(acc[2][r]);
          const float og = sigmoid(acc[3][r]);
          c_new = fg * c[r] + ig * gg;
          h_new = og * tanhf(c_new);
        }
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
cudaError_t launch_stream(const void* gates, const float* w_hh_t, const uint8_t* mask, const float* peep,
                          void* out, int B, int T_len, int D, int H, int reverse0, cudaStream_t stream) {
  const dim3 grid((B + ROWS - 1) / ROWS, D);
  const int threads = (H + 31) / 32 * 32;
  const size_t smem = 2 * (size_t)H * sizeof(float4);
  if (peep != nullptr) {
    lstm_stream_kernel<T, true><<<grid, threads, smem, stream>>>(
        static_cast<const T*>(gates), w_hh_t, mask, peep, static_cast<T*>(out), B, T_len, D, H, reverse0);
  } else {
    lstm_stream_kernel<T, false><<<grid, threads, smem, stream>>>(
        static_cast<const T*>(gates), w_hh_t, mask, peep, static_cast<T*>(out), B, T_len, D, H, reverse0);
  }
  return cudaGetLastError();
}

bool valid_shape(int B, int T_len, int D, int H) {
  return B > 0 && T_len > 0 && H > 0 && (D == 1 || D == 2);
}

}  // namespace

// dtype, w_dtype: 0 = fp32, 1 = bf16, 2 = fp16. Each entry returns a
// cudaError_t (0 = launched).

// The cluster design: w_hh is the torch weight (D, 4H, H) in its own type;
// C is 1..16 CTAs per cluster, R a multiple of 4 rows per tile. A cluster
// shape the card cannot hold (cudaOccupancyMaxActiveClusters = 0) is an error.
// peep is the (D, 3, H) fp32 peephole weights, or null (both designs).
extern "C" int lstm_recurrence_cluster(const void* gates, const void* w_hh, const void* mask,
                                       const void* peep, void* out, int B, int T_len, int D, int H,
                                       int C, int R, int reverse0, int dtype, int w_dtype, int device,
                                       void* stream) {
  if (!valid_shape(B, T_len, D, H) || C < 1 || C > 16 || R < 4 || R % 4 || w_dtype < 0 || w_dtype > 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* p = static_cast<const float*>(peep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int clusters = 0;
  switch (dtype) {
    case 0: err = launch_cluster<float>(gates, w_hh, w_dtype, m, p, out, B, T_len, D, H, C, R, reverse0, s, &clusters); break;
    case 1: err = launch_cluster<__nv_bfloat16>(gates, w_hh, w_dtype, m, p, out, B, T_len, D, H, C, R, reverse0, s, &clusters); break;
    case 2: err = launch_cluster<__half>(gates, w_hh, w_dtype, m, p, out, B, T_len, D, H, C, R, reverse0, s, &clusters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What the cluster design asks of the card at (H, C, R): its dynamic shared
// memory per CTA and block size, and how many such clusters fit at once.
extern "C" int lstm_cluster_occupancy(int H, int C, int R, int device, int* smem_bytes, int* threads,
                                      int* max_clusters) {
  if (H <= 0 || C < 1 || C > 16 || R < 4 || R % 4) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const ClusterShape s = cluster_shape(H, C, R);
  *smem_bytes = (int)s.smem;
  *threads = s.threads;
  // a query (no gates) of the kernel that would launch, one tile of one direction
  err = launch_cluster<float>(nullptr, nullptr, 0, nullptr, nullptr, nullptr, R, 1, 1, H, C, R, 0, 0, max_clusters);
  return (int)(err == cudaErrorLaunchOutOfResources ? cudaSuccess : err);
}

// The stream design: w_hh_t is the transposed fp32 weight (D, H, 4H), H <= 1024.
extern "C" int lstm_recurrence_stream(const void* gates, const void* w_hh_t, const void* mask,
                                      const void* peep, void* out, int B, int T_len, int D, int H,
                                      int reverse0, int dtype, int device, void* stream) {
  if (!valid_shape(B, T_len, D, H) || H > 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* w = static_cast<const float*>(w_hh_t);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* p = static_cast<const float*>(peep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_stream<float>(gates, w, m, p, out, B, T_len, D, H, reverse0, s);
    case 1: return (int)launch_stream<__nv_bfloat16>(gates, w, m, p, out, B, T_len, D, H, reverse0, s);
    case 2: return (int)launch_stream<__half>(gates, w, m, p, out, B, T_len, D, H, reverse0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
