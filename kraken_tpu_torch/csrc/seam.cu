// The batched minimum-energy seam carver of line polygonization, for
// Hopper (sm_90a): the forward DP, the start selection and the backtrace
// of every patch of a page in one launch.
//
// Replaces kraken_tpu/ops/seam.py:30 _seam_forward and :47
// _seam_forward_batch (a lax.scan over columns, vmapped over patches padded
// to a common shape: an XLA program there) together with the start
// selection and the backtrace that kraken_tpu/ops/seam.py:51-89
// carve_seams_device runs on the host.
//
// Input: one buffer (ops/seam.py:pack_patches), uploaded in one copy. It
// starts with descriptors of 8 int32 words: [data offset in words from the
// buffer's start, height H, width w, first output row, backtrack offset in
// bytes (-1: shared memory), the patch's index in its batch, 1 where the
// patch holds a value that is not finite, its group g | rank << 4 (0: no
// patch)]; first one a block-route patch, then four a block of the group
// route (one a warp). The patches follow, each column-major with a column
// stride S = H rounded up to 4 words and 16-byte aligned, so a column is
// contiguous. H counts the patch's two pad rows (rows 0 and H - 1), rows of
// the DP like any other.
//
// Per patch, with every energy mapped as np.nan_to_num(x, posinf=3.4e38)
// maps it (NaN 0, +inf 3.4e38, -inf -FLT_MAX; done as it is loaded, for a
// patch whose descriptor says it needs it), the cost of column 0 is its
// column 0; for column j >= 1 and row r
//   up = cost[r - 1] (3.4e38 at r = 0), stay = cost[r],
//   down = cost[r + 1] (3.4e38 at r = H - 1),
//   arg = the first minimum in the order up, stay, down (jnp.argmin of
//         stack([up, cost, down])), cost'[r] = energy[r, j] + min,
// and the backtrack code of (j, r) is arg (0 up, 1 stay, 2 down). The adds
// are plain fp32 adds (__fadd_rn), so 3.4e38 + 3.4e38 overflows to inf as
// in XLA; the comparisons are strict, so ties keep the earlier candidate.
// No NaN can arise (the mapped energies are finite, and a finite value
// plus +inf or -inf is never NaN), so the first minimum is well defined.
// The DP runs to the patch's last column w - 1. The start row is the first
// minimum of that column's cost over rows 1 .. H - 2 (np.argmin over the
// rows without the pad rows); a patch one column wide has no DP and starts
// at np.argmin of its raw column 0 over those rows (a NaN first). The
// backtrace walks from the last column to column 0: row(j) = row(j + 1) +
// code(j + 1, row(j + 1)) - 1, reading the code of a negative row counted
// once from the patch's end, as numpy indexing reads the host's int8
// backtrack (only a patch whose costs all overflow walks off its rows); a
// row out of [-H, H) sets the patch's status word, where numpy raises.
// The rows are written with the pad offset removed (row - 1), at the
// patch's first output row, and its status word (0 or 1) at its index.
//
// What bounds it: latency. A patch's columns are a chain of dependent
// steps (min of three costs, one add), 235 on the fixture page's widest
// patch, and its backtrace a second chain; the bytes (the patches read
// once, the rows written once: 4.7 MB on that page) take 1.4 us.
//
// Design:
// - Group route (H <= 1920): a patch on g = 1-4 consecutive warps of a
//   block of four; lane l of warp `rank` holds rows rank 32 R + l R ..
//   + R - 1 of the cost column in registers, R odd (1-15: the least odd
//   count that covers H on g warps), so the lanes' loads of a staged
//   column fall in distinct banks. A column's step takes the two edge
//   costs of its neighbours by two __shfl_sync; a group's warps trade
//   their edge costs through shared memory behind one named barrier
//   (bar.sync, the group's warps only) a column. ops/seam.py:group_plan
//   picks g: one warp up to 224 rows, else warps of 5 rows a lane (on the
//   card a column of one warp costs about 80 + 28 (R - 1) cycles, one of
//   a group of three warps of 5 rows about 350). The energies come off
//   the chain: a warp's lane 0 keeps three tiles of columns (2048 words
//   each) in flight, by 1-D bulk copies (cp.async.bulk) of the warp's rows
//   into shared memory completing on its mbarrier; a step loads the next
//   column's energies while it computes this one. A row's minimum is two
//   fminf and its code the first candidate equal to it; a row past H is
//   clamped to 3.4e38, so no row needs a predicate. A lane packs its
//   codes of a column into one word of 2 bits a row (1, 2 or 4 bytes), in
//   the warp's 30 kB of shared memory, or in global memory where a
//   patch's do not fit there. Start: a shuffle argmin a warp, the group's
//   candidates merged in row order. Backtrace: one lane walks the code
//   words, loading the next column's word of the same lane before the
//   step is known.
// - Block route (H > 1920, up to 13,848 rows): a block a patch, threads
//   over rows, the cost column double-buffered in shared memory, a barrier
//   a column; thread 0 keeps up to 16 energy columns in flight by bulk
//   copies; a code byte a cell in global memory. Start: a block argmin.
//   Backtrace: warp 0, five steps a round: from the current row, the rows
//   the next five steps can reach lie in a cone of 1 + 3 + 5 + 7 + 9
//   cells, whose codes 25 lanes load from L2 together; each step then
//   takes its own by one __shfl_sync. Exact; not tuned.
//
// The same kernel's forward mode (seam_forward) serves the padded batch's
// API: no mapping, every code written as the int8 backtrack (N, W - 1, H),
// the cost after the last column as (N, H); it selects and walks nothing.
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kWarps = 4;          // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;         // column tiles a warp keeps in flight
constexpr int kGroupRows = 1920;   // the group route's tallest patch: 4 warps, 15 rows a lane
constexpr int kDescWords = 8;
constexpr int kRegionHead = 64;    // a warp's region: mbarriers, edge costs, argmin candidate
constexpr int kEdgeOff = 32;       // float[2][2]: the first and last row's cost, by parity
constexpr int kCandOff = 48;       // float, int: the warp's argmin
constexpr int kRing = 16;          // energy columns the block route keeps in flight at most
constexpr unsigned kFull = 0xffffffffu;

struct Desc {
  int data, height, width, out, code, index, map, group;
};

__device__ __forceinline__ Desc load_desc(const float* buf, int slot) {
  const int* w = reinterpret_cast<const int*>(buf) + slot * kDescWords;
  const int4 a = __ldg(reinterpret_cast<const int4*>(w));
  const int4 b = __ldg(reinterpret_cast<const int4*>(w + 4));
  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

// np.nan_to_num(x, posinf=3.4e38)
__device__ __forceinline__ float finite(float x) {
  if (fabsf(x) < INFINITY) return x;
  return x != x ? 0.f : (x > 0.f ? kBig : -FLT_MAX);
}

// whether (v, r) comes before (bv, br) in np.argmin's order: a NaN before
// any number, then the smaller value, then the lower row
__device__ __forceinline__ bool before(float v, int r, float bv, int br) {
  const bool vn = v != v, bn = bv != bv;
  if (vn || bn) return vn && (!bn || r < br);
  return v < bv || (v == bv && r < br);
}

__device__ __forceinline__ void warp_argmin(float& v, int& r) {
#pragma unroll
  for (int d = 16; d; d >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, d);
    const int orow = __shfl_xor_sync(kFull, r, d);
    if (before(ov, orow, v, r)) {
      v = ov;
      r = orow;
    }
  }
}

// the first minimum over the block; every thread passes its own
__device__ __forceinline__ int block_argmin(float v, int r) {
  __shared__ float red_v[kWarps];
  __shared__ int red_r[kWarps + 1];
  warp_argmin(v, r);
  if ((threadIdx.x & 31) == 0) {
    red_v[threadIdx.x >> 5] = v;
    red_r[threadIdx.x >> 5] = r;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < kWarps ? red_v[threadIdx.x] : INFINITY;
    r = threadIdx.x < kWarps ? red_r[threadIdx.x] : INT_MAX;
    warp_argmin(v, r);
    if (threadIdx.x == 0) red_r[kWarps] = r;
  }
  __syncthreads();
  return red_r[kWarps];
}

// the minimum of (up, stay, down) and its code, the first minimum in that
// order (the code of the first candidate the minimum equals; fminf's value
// is the first minimum's but for the sign of a zero, which no comparison
// sees)
__device__ __forceinline__ float step_min(float up, float stay, float down, uint32_t& arg) {
  const float best = fminf(fminf(up, stay), down);
  arg = best == up ? 0u : (best == stay ? 1u : 2u);
  return best;
}

// the row whose code a backtrace step at row `cur` reads: a negative one
// counted once from the patch's end, as numpy indexing counts it; false
// where that row lies outside the patch
__device__ __forceinline__ bool wrap(int cur, int H, int& idx) {
  idx = cur < 0 ? cur + H : cur;
  return idx >= 0 && idx < H;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// one lane: the barrier's phase completes when `bytes` have landed
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// one lane: `bytes` (a multiple of 16; both ends 16-byte aligned) from
// global to shared memory, counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// np.argmin of a raw column 0 over rows 1 .. H - 2 by kCount threads (a
// patch one column wide); the first of them writes the row and the status
template <int kCount>
__device__ __forceinline__ void first_column(const float* src, const Desc d, int* rows,
                                             int* status) {
  const int tid = threadIdx.x % kCount;
  float bv = INFINITY;
  int br = INT_MAX;
  for (int r = 1 + tid; r <= d.height - 2; r += kCount) {
    const float v = __ldg(src + r);
    if (before(v, r, bv, br)) {
      bv = v;
      br = r;
    }
  }
  if (kCount == 32)
    warp_argmin(bv, br);
  else
    br = block_argmin(bv, br);
  if (tid == 0) {
    rows[d.out] = br - 1;
    status[d.index] = 0;
  }
}

// The group route: one patch on g consecutive warps (rank 0 .. g - 1) of a
// block; lane l of warp `rank` holds rows rank 32 R + l R .. + R - 1 (R
// odd, so the lanes' loads of a staged column fall in distinct banks).
// kMap: the patch holds a value that is not finite, so energies are mapped;
// kGroup: the patch may take more than one warp (else g = 1 is known here).
template <int R, bool kForward, bool kMap, bool kGroup>
__device__ void group_patch(const float* __restrict__ buf, const Desc d, unsigned char* smem,
                            int region_bytes, int stage_floats, int* __restrict__ rows,
                            int* __restrict__ status, unsigned char* __restrict__ codes_g,
                            float* __restrict__ col) {
  // a lane's codes of a column, 2 bits a row
  using Code = typename std::conditional<
      (R <= 3), uint8_t, typename std::conditional<(R <= 7), uint16_t, uint32_t>::type>::type;
  constexpr int RW = 32 * R;  // rows a warp holds
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = kGroup ? d.group & 15 : 1, rank = kGroup ? d.group >> 4 : 0;
  const int lead = warp - rank;
  const int H = d.height, S = (H + 3) & ~3, last = d.width - 1;
  const int wrow0 = rank * RW, row0 = wrow0 + lane * R;
  const float* src = buf + d.data;
  if (!kForward && last == 0) {
    if (rank == 0) first_column<32>(src, d, rows, status);
    return;
  }
  unsigned char* region = smem + warp * region_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(region);
  float* stage = reinterpret_cast<float*>(region + kRegionHead);
  // the codes: the warp's shared memory, or its offset in global memory
  // (each warp of a group the same size, cstride bytes after the last)
  const bool shared = !kForward && d.code < 0;
  const int cstride = shared ? region_bytes : ((last * 32 * (int)sizeof(Code) + 15) & ~15);
  Code* cs = reinterpret_cast<Code*>(region + kRegionHead + sizeof(float) * kStages * stage_floats);
  Code* cg = reinterpret_cast<Code*>(codes_g + max(d.code, 0));
  // a staged column: its stride, and the warp's rows of it
  const int ss = g == 1 ? S : RW;
  const int seg = min(RW, S - wrow0);
  const int T = stage_floats / ss;  // columns a tile, at least 4
  const int ncols = last + 1, ntiles = (ncols + T - 1) / T;
  auto issue = [&](int t, int s) {
    const int cols = min(T, ncols - t * T);
    float* dst = stage + s * stage_floats;
    bar_expect(bars + s, (uint32_t)(sizeof(float) * cols * seg));
    if (g == 1) {
      bulk_copy(dst, src + (size_t)t * T * S, (uint32_t)(sizeof(float) * cols * S), bars + s);
    } else {
      for (int c = 0; c < cols; ++c)
        bulk_copy(dst + c * RW, src + (size_t)(t * T + c) * S + wrow0,
                  (uint32_t)(sizeof(float) * seg), bars + s);
    }
  };
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int t = 0; t < kStages && t < ntiles; ++t) issue(t, t);
  }
  __syncwarp();
  auto group_sync = [&]() {
    if (g > 1) asm volatile("bar.sync %0, %1;" ::"r"(1 + lead), "r"(32 * g) : "memory");
  };
  float* edges = reinterpret_cast<float*>(region + kEdgeOff);
  const float* up_edges = reinterpret_cast<const float*>(region - region_bytes + kEdgeOff);
  const float* down_edges = reinterpret_cast<const float*>(region + region_bytes + kEdgeOff);
  // a row past H stays 3.4e38: its cost clamped to [lo, hi] = [3.4e38,
  // 3.4e38] (the others' to [-inf, inf]), with no predicate a row
  float c[R], e[R], lo[R], hi[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const bool in = row0 + i < H;
    lo[i] = in ? -INFINITY : kBig;
    hi[i] = in ? INFINITY : kBig;
    c[i] = kBig;
  }
  // a lane's rows of a staged column at p, as they lie (rows past H, and
  // past the tile after its last column, read what lies there: the warp's
  // region), and np.nan_to_num of them where the patch needs it
  auto load = [&](const float* p) {
#pragma unroll
    for (int i = 0; i < R; ++i) e[i] = p[i];
  };
  auto map = [&]() {
    if (kMap) {
#pragma unroll
      for (int i = 0; i < R; ++i) e[i] = finite(e[i]);
    }
  };
  // the group's warps trade the first and last row's cost of a column
  auto publish = [&](int p) {
    if (g > 1) {
      if (lane == 0) edges[2 * p] = c[0];
      if (lane == 31) edges[2 * p + 1] = c[R - 1];
      group_sync();
    }
  };
  // tile t (columns jt .. jn - 1) in stage s, completing phase ph
  for (int t = 0, jt = 0, s = 0, ph = 0;; ++t) {
    bar_wait(bars + s, ph);
    const float* ep = stage + s * stage_floats + lane * R;  // column j's rows
    const int jn = min(jt + T, ncols);
    int j = jt;
    load(ep);
    if (j == 0) {
      map();
#pragma unroll
      for (int i = 0; i < R; ++i) c[i] = fmaxf(fminf(e[i], hi[i]), lo[i]);
      publish(0);
      load(ep += ss);
      ++j;
    }
    for (; j < jn; ++j) {
      float above = __shfl_up_sync(kFull, c[R - 1], 1);
      float below = __shfl_down_sync(kFull, c[0], 1);
      const int p = (j - 1) & 1;
      if (lane == 0) above = rank > 0 ? up_edges[2 * p + 1] : kBig;
      if (lane == 31) below = rank < g - 1 ? down_edges[2 * p] : kBig;
      map();
      float n[R];
      uint32_t word = 0;
      // the rows between the lane's first and last first: their
      // neighbours are the lane's own, so they wait for no shuffle
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int i = k < R - 2 ? k + 1 : (k == R - 2 ? 0 : R - 1);
        uint32_t arg;
        const float best =
            step_min(i > 0 ? c[i - 1] : above, c[i], i < R - 1 ? c[i + 1] : below, arg);
        n[i] = fmaxf(fminf(__fadd_rn(e[i], best), hi[i]), lo[i]);
        word |= arg << (2 * i);
        if (kForward && row0 + i < H)
          codes_g[d.code + (size_t)(j - 1) * H + row0 + i] = (unsigned char)arg;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) c[i] = n[i];
      if (!kForward) {
        if (shared)
          cs[(j - 1) * 32 + lane] = (Code)word;
        else
          cg[(j - 1) * 32 + lane] = (Code)word;
      }
      publish(j & 1);
      load(ep += ss);  // the next column, off the chain
    }
    // the tile computed: its stage takes the tile kStages on
    __syncwarp();
    if (lane == 0 && t + kStages < ntiles) issue(t + kStages, s);
    if (jn == ncols) break;
    jt = jn;
    if (++s == kStages) {
      s = 0;
      ph ^= 1;
    }
  }
  if (kForward) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (row0 + i < H) col[(size_t)d.index * H + row0 + i] = c[i];
    return;
  }
  float bv = INFINITY;
  int br = INT_MAX;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = row0 + i;
    if (r >= 1 && r <= H - 2 && before(c[i], r, bv, br)) {
      bv = c[i];
      br = r;
    }
  }
  warp_argmin(bv, br);
  if (g > 1) {  // the group's candidates, merged in row order by rank 0
    float* cand = reinterpret_cast<float*>(region + kCandOff);
    if (lane == 0) {
      cand[0] = bv;
      reinterpret_cast<int*>(cand)[1] = br;
    }
    group_sync();
    if (rank != 0) return;
    for (int r = 1; r < g; ++r) {
      const float* other = reinterpret_cast<const float*>(region + r * region_bytes + kCandOff);
      const int orow = reinterpret_cast<const int*>(other)[1];
      if (before(other[0], orow, bv, br)) {
        bv = other[0];
        br = orow;
      }
    }
  }
  if (lane != 0) return;
  // The backtrace: row cur at column j takes its 2 bits (rr of the lane's
  // R rows) from the code word of its lane (q of the group) and column,
  // at p. The words of the next two columns of the same lane are loaded
  // before the step is known; a step that leaves the lane, or a row off
  // the patch (wrapped as numpy wraps it), finds q, rr and p anew.
  int* out = rows + d.out;
  out[last] = br - 1;
  const int wstride = cstride / (int)sizeof(Code);  // code words between two warps
  auto walk = [&](const Code* base) {
    int cur = br, rr = 0, bad = 0;
    bool wrapped = false;
    const Code* p = base;
    auto locate = [&](int j) {  // p and rr of row cur at column j; false off the patch
      int idx;
      if (!wrap(cur, H, idx)) return false;
      const unsigned q = (unsigned)idx / R;
      rr = (int)((unsigned)idx - q * R);
      p = base + (int)(q >> 5) * wstride + (j - 1) * 32 + (int)(q & 31);
      wrapped = cur < 0;
      return true;
    };
    locate(last);
    uint32_t w0 = *p, w1 = last > 1 ? p[-32] : 0u;  // this column's word, the next one's
    for (int j = last; j >= 1; --j) {
      const uint32_t w2 = j > 2 ? p[-64] : 0u;
      const int step = (int)((w0 >> (2 * rr)) & 3u) - 1;
      cur += step;
      rr += step;
      out[j - 1] = cur - 1;
      p -= 32;
      w0 = w1;
      w1 = w2;
      if (__builtin_expect(rr < 0 || rr >= R || (unsigned)cur >= (unsigned)H || wrapped, 0)) {
        if (j == 1) break;
        if (!locate(j - 1)) {
          bad = 1;
          break;
        }
        w0 = *p;
        w1 = j > 2 ? p[-32] : 0u;
      }
    }
    status[d.index] = bad;
  };
  if (shared)
    walk(cs);
  else
    walk(cg);
}

// The block route: one patch a block, H <= the rows its shared memory
// holds: kRing mbarriers, two cost columns and a ring of at least two
// energy columns (smem_bytes in all).
template <bool kForward, bool kMap>
__device__ void block_patch(const float* __restrict__ buf, const Desc d, unsigned char* smem,
                            int smem_bytes, int* __restrict__ rows, int* __restrict__ status,
                            unsigned char* __restrict__ codes_g, float* __restrict__ col) {
  const int H = d.height, S = (H + 3) & ~3, last = d.width - 1, tid = threadIdx.x;
  const float* src = buf + d.data;
  if (!kForward && last == 0) {
    first_column<kThreads>(src, d, rows, status);
    return;
  }
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* cost = reinterpret_cast<float*>(smem + kRing * sizeof(uint64_t));  // [2][S]
  float* ring = cost + 2 * S;                                               // [ns][S]
  const int ns = min(kRing, (smem_bytes - kRing * (int)sizeof(uint64_t)) / (4 * S) - 2);
  unsigned char* codes = codes_g + d.code;
  // column c >= 1 lands in slot (c - 1) % ns
  auto issue = [&](int c, int s) {
    bar_expect(bars + s, (uint32_t)(sizeof(float) * S));
    bulk_copy(ring + s * S, src + (size_t)c * S, (uint32_t)(sizeof(float) * S), bars + s);
  };
  if (tid == 0) {
    for (int s = 0; s < ns; ++s) bar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int c = 1; c <= min(ns, last); ++c) issue(c, c - 1);
  }
  for (int r = tid; r < H; r += kThreads) {
    const float v = __ldg(src + r);
    cost[r] = kMap ? finite(v) : v;
  }
  for (int j = 1, s = 0, ph = 0; j <= last; ++j) {
    __syncthreads();  // column j - 1 computed: its slot is free
    if (tid == 0 && j >= 2 && j - 1 + ns <= last) issue(j - 1 + ns, s == 0 ? ns - 1 : s - 1);
    bar_wait(bars + s, ph);
    const float* prev = cost + ((j - 1) & 1) * S;
    float* cur = cost + (j & 1) * S;
    const float* e = ring + s * S;
    unsigned char* cj = codes + (size_t)(j - 1) * H;
#pragma unroll 4
    for (int r = tid; r < H; r += kThreads) {
      uint32_t arg;
      const float best =
          step_min(r > 0 ? prev[r - 1] : kBig, prev[r], r < H - 1 ? prev[r + 1] : kBig, arg);
      cur[r] = __fadd_rn(kMap ? finite(e[r]) : e[r], best);
      cj[r] = (unsigned char)arg;
    }
    if (++s == ns) {
      s = 0;
      ph ^= 1;
    }
  }
  __syncthreads();
  const float* fin = cost + (last & 1) * S;
  if (kForward) {
    for (int r = tid; r < H; r += kThreads) col[(size_t)d.index * H + r] = fin[r];
    return;
  }
  float bv = INFINITY;
  int br = INT_MAX;
  for (int r = 1 + tid; r <= H - 2; r += kThreads) {
    if (before(fin[r], r, bv, br)) {
      bv = fin[r];
      br = r;
    }
  }
  br = block_argmin(bv, br);
  if (tid >= 32) return;
  // The backtrace by warp 0, kCone steps a round: from row cur at column j
  // the rows of the next kCone steps lie within cur +- k at column j - k,
  // so the 1 + 3 + 5 + 7 + 9 codes that can be needed are loaded together
  // (lane l: step k, offset dk), and each step takes its own by a shuffle.
  constexpr int kCone = 5;
  int k = 0;
  while ((k + 1) * (k + 1) <= tid) ++k;  // lanes k^2 .. k^2 + 2k: step k
  const int dk = tid - k * k - k;
  int* out = rows + d.out;
  int cur = br, bad = 0;
  if (tid == 0) out[last] = cur - 1;
  for (int j = last; j >= 1 && !bad; j -= kCone) {
    int code = 3;  // 3: no code (outside the patch)
    int idx;
    if (k < kCone && j - k >= 1 && wrap(cur + dk, H, idx))
      code = codes[(size_t)(j - k - 1) * H + idx];
    int off = 0;
    for (int s = 0; s < kCone && j - s >= 1; ++s) {
      const int got = __shfl_sync(kFull, code, s * s + s + off);
      if (got == 3) {
        bad = 1;
        break;
      }
      off += got - 1;
      if (tid == 0) out[j - s - 1] = cur + off - 1;
    }
    cur += off;
  }
  if (tid == 0) status[d.index] = bad;
}

// blocks [0, n_block) take the block route, one patch each (descriptor
// slots 0 .. n_block - 1); each later block takes the group route, its
// four warps the four descriptor slots after them
template <bool kForward>
__global__ void __launch_bounds__(kThreads)
    seam_kernel(const float* __restrict__ buf, int n_block, int stage_floats, int region_bytes,
                int* __restrict__ rows, int* __restrict__ status,
                unsigned char* __restrict__ codes_g, float* __restrict__ col) {
  extern __shared__ __align__(128) unsigned char smem[];
  if ((int)blockIdx.x < n_block) {
    const Desc d = load_desc(buf, blockIdx.x);
    if (kForward || !d.map)
      block_patch<kForward, false>(buf, d, smem, kWarps * region_bytes, rows, status, codes_g,
                                   col);
    else
      block_patch<false, true>(buf, d, smem, kWarps * region_bytes, rows, status, codes_g, col);
    return;
  }
  const Desc d = load_desc(buf, n_block + (blockIdx.x - n_block) * kWarps + (threadIdx.x >> 5));
  const int g = d.group & 15;
  if (g == 0) return;  // no patch on this warp
  const int need = (d.height + 32 * g - 1) / (32 * g) | 1;  // rows a lane: the least odd count
#define SEAM_GROUP(R)                                                                      \
  if constexpr (kForward)                                                                  \
    group_patch<R, true, false, true>(buf, d, smem, region_bytes, stage_floats, rows, status, \
                                      codes_g, col);                                       \
  else if (d.map)                                                                          \
    group_patch<R, false, true, true>(buf, d, smem, region_bytes, stage_floats, rows, status, \
                                      codes_g, col);                                       \
  else if (g > 1)                                                                          \
    group_patch<R, false, false, true>(buf, d, smem, region_bytes, stage_floats, rows,       \
                                       status, codes_g, col);                              \
  else                                                                                     \
    group_patch<R, false, false, false>(buf, d, smem, region_bytes, stage_floats, rows,      \
                                        status, codes_g, col)
  switch (need) {
    case 1: SEAM_GROUP(1); break;
    case 3: SEAM_GROUP(3); break;
    case 5: SEAM_GROUP(5); break;
    case 7: SEAM_GROUP(7); break;
    case 9: SEAM_GROUP(9); break;
    case 11: SEAM_GROUP(11); break;
    case 13: SEAM_GROUP(13); break;
    default: SEAM_GROUP(15); break;
  }
#undef SEAM_GROUP
}

int region_bytes(int stage_floats, int code_slot) {
  const int bytes = kRegionHead + (int)sizeof(float) * kStages * stage_floats + code_slot;
  return (bytes + 127) & ~127;
}

template <bool kForward>
int launch(const void* buf, int n_slots, int n_block, int max_block_height, int stage_floats,
           int code_slot, void* rows, void* status, void* codes, void* col, int device,
           void* stream) {
  const int region = region_bytes(stage_floats, code_slot);
  const size_t smem = (size_t)kWarps * region;
  // the block route: the mbarriers, two cost columns and two energy columns
  const size_t block_smem =
      kRing * sizeof(uint64_t) + 4 * sizeof(float) * (size_t)((max_block_height + 3) & ~3);
  if (n_slots <= 0 || n_block < 0 || n_block > n_slots || (n_slots - n_block) % kWarps != 0 ||
      stage_floats < 4 * 15 * 32 || stage_floats % 4 != 0 || code_slot < 0 ||
      code_slot % 16 != 0 || (n_block > 0 && (max_block_height < 3 || block_smem > smem)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)limit - 64) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(seam_kernel<kForward>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = n_block + (n_slots - n_block) / kWarps;
  seam_kernel<kForward><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(buf), n_block, stage_floats, region, static_cast<int*>(rows),
      static_cast<int*>(status), static_cast<unsigned char*>(codes), static_cast<float*>(col));
  return (int)cudaGetLastError();
}

}  // namespace

// The carve (ops/seam.py:seam_carve). packed: the buffer on `device`
// (16-byte aligned) with n_slots descriptors, the first n_block on the
// block route (the tallest of them max_block_height rows); rows: int32 of
// the total width; status: int32, one a patch; codes: the global backtrack
// of the warps and blocks whose descriptor gives an offset.
extern "C" int seam_carve(const void* packed, void* rows, void* status, void* codes, int n_slots,
                          int n_block, int max_block_height, int stage_floats, int code_slot,
                          int device, void* stream) {
  return launch<false>(packed, n_slots, n_block, max_block_height, stage_floats, code_slot, rows,
                       status, codes, nullptr, device, stream);
}

// The forward mode (ops/seam.py:seam_forward): back, the int8 (N, W - 1, H)
// backtrack at each descriptor's offset; col, the fp32 (N, H) cost after
// each patch's last column at its index.
extern "C" int seam_forward(const void* packed, void* back, void* col, int n_slots, int n_block,
                            int max_block_height, int stage_floats, int code_slot, int device,
                            void* stream) {
  return launch<true>(packed, n_slots, n_block, max_block_height, stage_floats, code_slot,
                      nullptr, nullptr, back, col, device, stream);
}

// The launch's constants, for ops/seam.py's mirror: warps a block, column
// tiles in flight a warp, the group route's tallest patch, the bytes ahead
// of a warp's tiles, the block route's energy columns in flight at most.
extern "C" void seam_geometry(int* out) {
  out[0] = kWarps;
  out[1] = kStages;
  out[2] = kGroupRows;
  out[3] = kRegionHead;
  out[4] = kRing;
}
