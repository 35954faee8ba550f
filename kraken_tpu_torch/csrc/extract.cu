// The two gathers that build a recognition batch on the card, for Hopper
// (sm_90a).
//
// 1. extract_kernel, the gather-warp of device line extraction. Replaces
//    kraken_tpu/inference/extraction.py:486 extract_batch_jnp (the XLA
//    program fused into the recognition forward by make_extract_forward,
//    :594). It reads the line pixels from two uint8 buffers addressed as
//    one: the page resident on the card, then the batch's atlas of packed
//    line strips (an index at or past the page's length reads the atlas).
//    From them, each line's (129, 3, 3) grid of (x, y, row) knots, its
//    (65, 2) mask envelope and its meta row (offset, w, h, W_l, seq_len,
//    left pad, row stride, supersampling flag), it writes the padded
//    (n, 1, H, max_w) batch in the model's type, the cast the JAX forward
//    does next folded in. Per output pixel and each of the ss x ss
//    subsamples: column-lerp the three knots of the bracketing grid
//    columns, row-lerp piecewise about the middle knot, bilinear-sample the
//    buffer with the JAX clamps, test the mask envelope with its half pixel
//    of slack; average the subsamples (one centre sample, added ss^2
//    times, where the flag is 0), paint the pad columns 0 and invert the
//    ink as (255 - v) / 255.
//
//    What bounds it: the instructions dispatched. The bytes are few (the
//    output written once, each strip read from L1 and L2 about ss x 4
//    times; the fixture page is 2.2 MB, the L2 50 MB), but every subsample
//    runs a division, four clamps, two floors, four byte loads and the
//    bilinear weights, each step rounded on its own: about 70 instructions
//    a subsample in SASS (chip_smoke.py's EXTRACT_SLOTS_SAMPLE).
//
//    Design: a block of 32 x 8 threads takes 32 columns and 64 rows of one
//    line (grid: column tiles x row tiles x lines); lane x is a column, so
//    each store of a warp is 32 consecutive outputs, and a thread walks 8
//    rows. The column half of the map depends on the column and its
//    subsample only: a thread computes it once and keeps it in registers,
//    each piece of the row lerp ready to use (its start row, its divisor
//    clamped to 1e-3, its x and y start and step) and the envelope as its
//    two thresholds. A subsample tests the envelope first and samples only
//    inside it (outside, the plain version adds 0). It runs the division
//    of the piece its row lies in only: the quotient of the other piece is
//    never used, and a division is a pure function. Floors take no
//    float-to-int conversion: adding 2^23 rounded down leaves floor(v) in
//    the low mantissa bits (exact for 0 <= v < 2^23). The line's window,
//    every byte its samples can read ([off, off + (h - 1) stride + w - 1]),
//    is checked once a thread: where it lies inside the page or inside the
//    atlas (every line the engine builds), samples address it by 32-bit
//    offsets from its first byte with no clamp, the neighbours at +1 and
//    +stride; any other line takes the plain version's 64-bit indices into
//    the two buffers taken as one (a negative one counted from the end,
//    then each clamped, as jnp indexing takes them). The mean is a
//    multiply by 1 / ss^2 where ss^2 is a power of two (ss 1, 2, 4:
//    exact), a division for ss 3. Nothing is staged in shared memory, and
//    there is no barrier:
//    4 or 16 rows a thread, the column maps computed once a block and
//    shared behind a barrier, and the envelope test as a select after the
//    sample were each slower on the pipeline's widest batch.
//
//    Every step is rounded as the plain version (ops/extract.py) rounds it
//    on either device: each product and sum by its own intrinsic, so none
//    is contracted into an FMA, every quotient an IEEE division, the
//    clamps NaN-propagating as torch.clamp. The kernel equals its plain
//    version bit for bit.
//
// 2. packed_gather_kernel, the atlas gather of input_transfer='packed'.
//    Replaces the gather of kraken_tpu/inference/recognition.py:158
//    fwd_packed: out[i, c, r, x] = atlas[c, r, off[i] + x] / 255 for
//    x < wid[i] (the index clamped into the atlas), else 0, in the model's
//    type.
//
//    What bounds it: bytes. The lines' bytes are read once and the batch
//    written once, 4 or 2 bytes an element against 1 read: the stores are
//    the time (13.4 MB at the pipeline's widest fp32 batch, 4 us at the
//    card's 3.35 TB/s).
//
//    Design: a block takes one line and a group of rows (grid: row groups
//    x lines) and reads the line's offset and width once. A thread takes
//    runs of kRunBytes / sizeof(T) consecutive columns (8 fp32, 16 bf16 or
//    fp16) and writes each as two 16-byte stores; the runs of a row start
//    where its output is 16-byte aligned, and the columns before the first
//    run and after the last whole one (a row whose start is not aligned, a
//    max_w that is not a multiple of the run) take scalar stores in the
//    same kernel. A run wholly past the line's width, and every run of a
//    batch-pad line, stores zeros without a load. A run that lies inside
//    the atlas loads the aligned 32-bit words that hold its bytes (the
//    offset is arbitrary) and shifts them into place with
//    __funnelshift_r; the bytes past the width are masked to 0; a run that
//    reaches outside the atlas takes the plain version's clamped index and
//    a scalar store a column. A byte b becomes 2^23 + b by __byte_perm into
//    the exponent of 2^23, minus 2^23, exact; its quotient is b * r with
//    r = 1/255 rounded to fp32, then one correction q + r (b - 255 q) in
//    two FMAs: correctly rounded, so equal to the IEEE division by 255 that
//    the plain version and the 'uint8' route take, for every one of the 256
//    bytes (a CPU test holds the three steps to exact rationals). All three
//    agree bit for bit.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGrid = 129;          // knot columns of a line's grid (M_GRID)
constexpr int kMask = 65;           // envelope knots of a line (M_MASK)
constexpr int kTileC = 32;          // columns a block: a warp's lanes
constexpr int kRowThreads = 8;      // warps a block
constexpr int kRowsPerThread = 8;
constexpr int kTileR = kRowThreads * kRowsPerThread;  // rows a block
constexpr int kGatherThreads = 256;
constexpr int kRunBytes = 32;       // output bytes of a gather thread's run (16-byte stores)
constexpr int kGatherItems = 1024;  // runs a gather block aims at (4 a thread)
constexpr int kGatherMinBlocks = 264;  // blocks a launch keeps, rows allowing: 2 an SM
constexpr float kInv255 = 0x1.010102p-8f;  // 1/255 rounded to fp32
// the widest and tallest strip the direct route takes: its coordinates stay
// below 2^23, where the round-down add of 2^23 floors exactly
constexpr int kMaxSide = 1 << 22;
constexpr float kTwo23 = 8388608.f;
// the most bytes the two buffers may hold together (32-bit offsets)
constexpr long long kMaxBytes = 0x7fffffffLL;

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) { return __float2half_rn(v); }

// torch.maximum / torch.minimum: NaN if either is NaN (one instruction)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
// torch.clamp / jnp.clip: NaN stays NaN
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return min_nan(max_nan(v, lo), hi);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }
__device__ __forceinline__ int floor_int(float v) { return (int)floorf(v); }
__device__ __forceinline__ float lerp(float a, float b, float t) {
  return __fadd_rn(a, __fmul_rn(t, __fsub_rn(b, a)));
}
// the subsample offset ((k + 0.5) / ss - 0.5), as the plain version forms
// it (a double rounded to float)
__device__ __forceinline__ float sub_offset(int k, int ss) {
  return (float)(((double)k + 0.5) / ss - 0.5);
}

// the column half of the map at one column subsample: each piece of the
// row lerp (upper: rows above the middle knot's row `mid`; lower: from it
// on, starting at `mid`) as its start row, divisor and its x and y start
// and step; the envelope's two thresholds
struct Column {
  float mid;
  float r_up, den_up, x_up, dx_up, y_up, dy_up;
  float den_lo, x_lo, dx_lo, y_lo, dy_lo;
  float top, bottom;
};

__device__ __forceinline__ Column column_map(const float* __restrict__ grid,
                                             const float* __restrict__ mask, float cf,
                                             float stepg, float stepm) {
  const float g = __fdiv_rn(cf, stepg);
  const int gi = clampi(floor_int(g), 0, kGrid - 2);
  const float gf = clampf(__fsub_rn(g, (float)gi), 0.f, 1.f);
  const float* lo = grid + gi * 9;
  // knot k's coordinate j at 3 k + j: (x, y, row)
  float p[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) p[k] = lerp(__ldg(lo + k), __ldg(lo + 9 + k), gf);
  Column c;
  c.mid = p[5];
  c.r_up = p[2];
  c.den_up = max_nan(__fsub_rn(p[5], p[2]), 1e-3f);
  c.den_lo = max_nan(__fsub_rn(p[8], p[5]), 1e-3f);
  c.x_up = p[0];
  c.dx_up = __fsub_rn(p[3], p[0]);
  c.y_up = p[1];
  c.dy_up = __fsub_rn(p[4], p[1]);
  c.x_lo = p[3];
  c.dx_lo = __fsub_rn(p[6], p[3]);
  c.y_lo = p[4];
  c.dy_lo = __fsub_rn(p[7], p[4]);
  const float gm = __fdiv_rn(cf, stepm);
  const int mi = clampi(floor_int(gm), 0, kMask - 2);
  const float mf = clampf(__fsub_rn(gm, (float)mi), 0.f, 1.f);
  const float* ml = mask + mi * 2;
  c.top = __fsub_rn(lerp(__ldg(ml), __ldg(ml + 2), mf), 0.5f);
  c.bottom = __fadd_rn(lerp(__ldg(ml + 1), __ldg(ml + 3), mf), 0.5f);
  return c;
}

// the row lerp of one subsample, before the clamps: the piece the row
// lies in and its one division (where rf or mid is NaN, the lower piece,
// as torch.where takes it)
__device__ __forceinline__ void source_point(const Column& c, float rf, float& x, float& y) {
  const bool upper = rf < c.mid;
  const float t = clampf(__fdiv_rn(__fsub_rn(rf, upper ? c.r_up : c.mid),
                                   upper ? c.den_up : c.den_lo),
                         0.f, 1.f);
  x = __fadd_rn(upper ? c.x_up : c.x_lo, __fmul_rn(t, upper ? c.dx_up : c.dx_lo));
  y = __fadd_rn(upper ? c.y_up : c.y_lo, __fmul_rn(t, upper ? c.dy_up : c.dy_lo));
}

__device__ __forceinline__ float bilinear(float v00, float v01, float v10, float v11, float fx,
                                          float fy) {
  const float gx = __fsub_rn(1.f, fx);
  const float gy = __fsub_rn(1.f, fy);
  const float top = __fadd_rn(__fmul_rn(v00, gx), __fmul_rn(v01, fx));
  const float bottom = __fadd_rn(__fmul_rn(v10, gx), __fmul_rn(v11, fx));
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bottom, fy));
}

// a line whose window lies inside one buffer: `base` its first byte
struct Direct {
  const uint8_t* base;
  int stride, wm2, hm2;
  float wm1f, hm1f, wm2f, hm2f;
};

// floor(v) clamped to hi (as a float and as an int), for 0 <= v < 2^23 or
// NaN (then hi: the sample is NaN whatever it reads)
__device__ __forceinline__ float floor_to(float v, float hif, int hi, int& i) {
  const float t = __fadd_rd(v, kTwo23);
  i = (int)min((unsigned)(__float_as_int(t) - 0x4B000000), (unsigned)hi);
  return fminf(__fsub_rn(t, kTwo23), hif);
}

__device__ __forceinline__ float fetch(const Direct& s, float x, float y) {
  x = clampf(x, 0.f, s.wm1f);
  y = clampf(y, 0.f, s.hm1f);
  int ix, iy;
  const float fx = __fsub_rn(x, floor_to(x, s.wm2f, s.wm2, ix));
  const float fy = __fsub_rn(y, floor_to(y, s.hm2f, s.hm2, iy));
  const uint8_t* p = s.base + (iy * s.stride + ix);
  const uint8_t* q = p + s.stride;
  return bilinear((float)__ldg(p), (float)__ldg(p + 1), (float)__ldg(q), (float)__ldg(q + 1), fx,
                  fy);
}

// any other line: the plain version's indices into the two buffers taken
// as one, as jnp indexing takes them (a negative one counted from the end
// once, then each clamped into the buffer)
struct Clamped {
  const uint8_t* page;
  const uint8_t* atlas;
  long long page_len, last;
  int off, w, h, stride;
  float wm1f, hm1f;
};

__device__ __forceinline__ float pixel(const Clamped& s, long long idx) {
  idx = idx < 0 ? idx + s.last + 1 : idx;
  idx = idx < 0 ? 0 : (idx > s.last ? s.last : idx);
  return (float)__ldg(idx < s.page_len ? s.page + idx : s.atlas + (idx - s.page_len));
}

__device__ __forceinline__ float fetch(const Clamped& s, float x, float y) {
  x = clampf(x, 0.f, s.wm1f);
  y = clampf(y, 0.f, s.hm1f);
  const int ix = clampi(floor_int(x), 0, max(s.w - 2, 0));
  const int iy = clampi(floor_int(y), 0, max(s.h - 2, 0));
  const float fx = __fsub_rn(x, (float)ix);
  const float fy = __fsub_rn(y, (float)iy);
  const long long base = (long long)s.off + (long long)iy * s.stride + ix;
  const long long ix1 = min(ix + 1, s.w - 1) - ix;
  const long long iy1 = (long long)(min(iy + 1, s.h - 1) - iy) * s.stride;
  return bilinear(pixel(s, base), pixel(s, base + ix1), pixel(s, base + iy1),
                  pixel(s, base + iy1 + ix1), fx, fy);
}

// one subsample: 0 outside the envelope, else the sample at the row lerp's
// point
template <typename Src>
__device__ __forceinline__ float subsample(const Src& s, const Column& c, float rf) {
  if (!(rf >= c.top && rf <= c.bottom)) return 0.f;
  float x, y;
  source_point(c, rf, x, y);
  return fetch(s, x, y);
}

template <typename T, int SS, typename Src>
__device__ __forceinline__ void line_rows(const Src& s, const Column (&col)[SS], bool ss_on,
                                          float ssf, T* __restrict__ o, int r_begin, int r_end,
                                          int max_w) {
  const long long step = (long long)kRowThreads * max_w;
  o += (long long)r_begin * max_w;
  for (int r = r_begin; r < r_end; r += kRowThreads, o += step) {
    const float rowf = (float)r;
    float acc = 0.f;
    if (ss_on) {
      float rf[SS];
#pragma unroll
      for (int sj = 0; sj < SS; ++sj) rf[sj] = __fadd_rn(rowf, __fmul_rn(ssf, sub_offset(sj, SS)));
#pragma unroll
      for (int si = 0; si < SS; ++si) {
#pragma unroll
        for (int sj = 0; sj < SS; ++sj) acc = __fadd_rn(acc, subsample(s, col[si], rf[sj]));
      }
    } else {
      // every subsample is the pixel's centre (r + 0 * offset is r): one
      // sample, added ss^2 times
      const float v = subsample(s, col[0], rowf);
#pragma unroll
      for (int k = 0; k < SS * SS; ++k) acc = __fadd_rn(acc, v);
    }
    float mean;
    if constexpr ((SS & (SS - 1)) == 0) {
      mean = __fmul_rn(acc, 1.f / (SS * SS));
    } else {
      mean = __fdiv_rn(acc, (float)(SS * SS));
    }
    *o = from_float<T>(__fdiv_rn(__fsub_rn(255.f, mean), 255.f));
  }
}

template <typename T, int SS>
__global__ void __launch_bounds__(kTileC * kRowThreads)
    extract_kernel(const uint8_t* __restrict__ page, const uint8_t* __restrict__ atlas,
                   long long page_len, long long atlas_len, const float* __restrict__ grid,
                   const float* __restrict__ mask, const int* __restrict__ meta,
                   T* __restrict__ out, int height, int max_w) {
  const int i = blockIdx.z;
  const int c = blockIdx.x * kTileC + threadIdx.x;
  if (c >= max_w) return;
  const int r_end = min((int)(blockIdx.y + 1) * kTileR, height);
  const int r_begin = blockIdx.y * kTileR + threadIdx.y;
  const int* m = meta + i * 8;
  const int W_l = __ldg(m + 3), padl = __ldg(m + 5), ss_flag = __ldg(m + 7);
  T* o = out + (long long)i * height * max_w + c;
  const float c_rel = (float)(c - padl);
  if (!(c_rel >= 0.f && c_rel < (float)W_l)) {
    for (int r = r_begin; r < r_end; r += kRowThreads) o[(long long)r * max_w] = from_float<T>(0.f);
    return;
  }
  const int off = __ldg(m), w = __ldg(m + 1), h = __ldg(m + 2), stride = __ldg(m + 6);
  const float ssf = (float)ss_flag;
  const float span = (float)(max(W_l, 2) - 1);
  const float stepg = __fdiv_rn(span, (float)(kGrid - 1));
  const float stepm = __fdiv_rn(span, (float)(kMask - 1));
  const float* gl = grid + (long long)i * kGrid * 9;
  const float* ml = mask + (long long)i * kMask * 2;
  // where the flag is 0 every subsample is the pixel's centre
  const int n_sub = ss_flag ? SS : 1;
  Column col[SS] = {};
#pragma unroll
  for (int si = 0; si < SS; ++si) {
    if (si < n_sub) {
      col[si] = column_map(gl, ml, __fadd_rn(c_rel, __fmul_rn(ssf, sub_offset(si, SS))), stepg,
                           stepm);
    }
  }
  const float wm1f = (float)(w - 1), hm1f = (float)(h - 1);
  // the line's window: every byte a sample can read
  const long long lo = off;
  const long long hi = lo + (long long)(h - 1) * stride + (w - 1);
  const uint8_t* base = nullptr;
  if (w >= 2 && h >= 2 && w <= kMaxSide && h <= kMaxSide && stride >= 0) {
    if (lo >= 0 && hi < page_len) {
      base = page + lo;
    } else if (lo >= page_len && hi < page_len + atlas_len) {
      base = atlas + (lo - page_len);
    }
  }
  if (base != nullptr) {
    const Direct s{base, stride, w - 2, h - 2, wm1f, hm1f, (float)(w - 2), (float)(h - 2)};
    line_rows<T, SS>(s, col, ss_flag != 0, ssf, o, r_begin, r_end, max_w);
  } else {
    const Clamped s{page, atlas, page_len, page_len + atlas_len - 1, off, w, h, stride, wm1f,
                    hm1f};
    line_rows<T, SS>(s, col, ss_flag != 0, ssf, o, r_begin, r_end, max_w);
  }
}

// b / 255 correctly rounded for byte k of `word`: the byte as 2^23 + b
// minus 2^23 (exact), b * r, then q + r (b - 255 q) by two FMAs
__device__ __forceinline__ float byte_quotient(uint32_t word, int k) {
  const float b = __fsub_rn(__uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440u | k)), kTwo23);
  const float q = __fmul_rn(b, kInv255);
  return __fmaf_rn(__fmaf_rn(-q, 255.f, b), kInv255, q);
}

// the quotients of two adjacent bytes of `word` packed as two T in 32 bits
template <typename T>
__device__ __forceinline__ uint32_t pack_pair(uint32_t word, int k);
template <>
__device__ __forceinline__ uint32_t pack_pair<__nv_bfloat16>(uint32_t word, int k) {
  const __nv_bfloat162 v =
      __floats2bfloat162_rn(byte_quotient(word, k), byte_quotient(word, k + 1));
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack_pair<__half>(uint32_t word, int k) {
  const __half2 v = __floats2half2_rn(byte_quotient(word, k), byte_quotient(word, k + 1));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a whole run's quotients, its bytes in `w` (byte k of the run at bits
// 8 (k % 4) of w[k / 4]), as 16-byte stores at the aligned `dst`
template <typename T, int kWords>
__device__ __forceinline__ void store_run(T* dst, const uint32_t (&w)[kWords]) {
  uint4 v[kRunBytes / 16];
  uint32_t* o = reinterpret_cast<uint32_t*>(v);
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) o[4 * j + k] = __float_as_uint(byte_quotient(w[j], k));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      o[2 * j] = pack_pair<T>(w[j], 0);
      o[2 * j + 1] = pack_pair<T>(w[j], 2);
    }
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int m = 0; m < kRunBytes / 16; ++m) d[m] = v[m];
}

template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
    packed_gather_kernel(const uint8_t* __restrict__ atlas, const int* __restrict__ aux,
                         T* __restrict__ out, int n, int rows, int atlas_w, int max_w,
                         int rows_per_block, int runs) {
  constexpr int kRun = kRunBytes / sizeof(T);  // columns a run
  constexpr int kWords = kRun / 4;             // 32-bit words of a run's bytes
  const int i = blockIdx.y;
  const int off = __ldg(aux + i), wid = __ldg(aux + n + i);
  const int row0 = blockIdx.x * rows_per_block;
  const int items = min(rows_per_block, rows - row0) * runs;
  for (int t = threadIdx.x; t < items; t += kGatherThreads) {
    const int row = row0 + t / runs;
    const int j = t - (t / runs) * runs;
    T* const dst = out + ((long long)i * rows + row) * max_w;
    const uint8_t* const src = atlas + (long long)row * atlas_w;
    // the row's first run starts at its first 16-byte aligned column
    const int head =
        (int)((16u - (reinterpret_cast<uintptr_t>(dst) & 15u)) & 15u) / (int)sizeof(T);
    const int x0 = (head > 0 ? head - kRun : 0) + j * kRun;
    const bool whole = x0 >= 0 && x0 + kRun <= max_w;
    if (whole && x0 >= wid) {
      uint4* d = reinterpret_cast<uint4*>(dst + x0);
#pragma unroll
      for (int m = 0; m < kRunBytes / 16; ++m) d[m] = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    if (whole) {
      const int valid = min(kRun, wid - x0);
      const long long pos = (long long)off + x0;
      if (pos >= 0 && pos + valid <= atlas_w) {
        const uintptr_t addr = reinterpret_cast<uintptr_t>(src + pos);
        const uint32_t* wp = reinterpret_cast<const uint32_t*>(addr & ~(uintptr_t)3);
        const int s = (int)(addr & 3);
        // only the words that hold a byte of the run: none past the atlas
        uint32_t raw[kWords + 1], w[kWords];
#pragma unroll
        for (int m = 0; m <= kWords; ++m) raw[m] = 4 * m < s + valid ? __ldg(wp + m) : 0u;
#pragma unroll
        for (int m = 0; m < kWords; ++m) {
          w[m] = __funnelshift_r(raw[m], raw[m + 1], 8 * s);
          // the bytes past the width read as 0
          const int keep = valid - 4 * m;
          if (keep < 4) w[m] &= keep <= 0 ? 0u : (1u << (8 * keep)) - 1u;
        }
        store_run<T, kWords>(dst + x0, w);
        continue;
      }
    }
    // a row's ragged head or tail, or a run the plain version's clamp
    // reaches: scalar stores
    for (int k = 0; k < kRun; ++k) {
      const int x = x0 + k;
      if (x < 0 || x >= max_w) continue;
      float v = 0.f;
      if (x < wid) {
        long long idx = (long long)off + x;
        idx = idx < 0 ? 0 : (idx >= atlas_w ? atlas_w - 1 : idx);
        v = byte_quotient(__ldg(src + idx), 0);
      }
      dst[x] = from_float<T>(v);
    }
  }
}

struct ExtractArgs {
  const uint8_t* page;
  const uint8_t* atlas;
  long long page_len, atlas_len;
  const float* grid;
  const float* mask;
  const int* meta;
  void* out;
  int n, height, max_w;
};

template <typename T, int SS>
cudaError_t launch_extract(const ExtractArgs& a, cudaStream_t stream) {
  const dim3 blocks((a.max_w + kTileC - 1) / kTileC, (a.height + kTileR - 1) / kTileR, a.n);
  extract_kernel<T, SS><<<blocks, dim3(kTileC, kRowThreads), 0, stream>>>(
      a.page, a.atlas, a.page_len, a.atlas_len, a.grid, a.mask, a.meta, static_cast<T*>(a.out),
      a.height, a.max_w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t extract_ss(const ExtractArgs& a, int ss, cudaStream_t stream) {
  switch (ss) {
    case 1: return launch_extract<T, 1>(a, stream);
    case 2: return launch_extract<T, 2>(a, stream);
    case 3: return launch_extract<T, 3>(a, stream);
    case 4: return launch_extract<T, 4>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// runs a row (one more where rows do not all start 16-byte aligned) and
// rows a block: about kGatherItems runs, fewer rows while the launch would
// have under kGatherMinBlocks blocks
template <typename T>
cudaError_t launch_gather(const uint8_t* atlas, const int* aux, void* out, int n, int rows,
                          int atlas_w, int max_w, cudaStream_t stream) {
  constexpr int kRun = kRunBytes / (int)sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(out) & 15u) == 0 &&
                       ((long long)max_w * (long long)sizeof(T)) % 16 == 0;
  const int runs = (max_w + kRun - 1) / kRun + (aligned ? 0 : 1);
  int rows_per_block = max(1, min(rows, kGatherItems / runs));
  while (rows_per_block > 1 &&
         (long long)n * ((rows + rows_per_block - 1) / rows_per_block) < kGatherMinBlocks) {
    rows_per_block /= 2;
  }
  const dim3 blocks((rows + rows_per_block - 1) / rows_per_block, n);
  packed_gather_kernel<T><<<blocks, kGatherThreads, 0, stream>>>(
      atlas, aux, static_cast<T*>(out), n, rows, atlas_w, max_w, rows_per_block, runs);
  return cudaGetLastError();
}

}  // namespace

// page (page_len bytes), then atlas (atlas_len bytes): one flat uint8
// buffer in two pieces, either may be empty (and null), not both, together
// under 2^31 bytes; meta's offsets address the two as one. grid
// (n, 129, 3, 3) fp32; mask (n, 65, 2) fp32; meta (n, 8) int32; out
// (n, 1, height, max_w) of dtype 0 fp32 / 1 bf16 / 2 fp16; ss 1 to 4. All
// contiguous on `device`.
extern "C" int extract_forward(const void* page, const void* atlas, const void* grid,
                               const void* mask, const void* meta, void* out, long long page_len,
                               long long atlas_len, int n, int height, int max_w, int ss,
                               int dtype, int device, void* stream) {
  if (page_len < 0 || atlas_len < 0 || page_len + atlas_len <= 0 ||
      page_len + atlas_len > kMaxBytes || (page_len > 0 && page == nullptr) ||
      (atlas_len > 0 && atlas == nullptr) || n <= 0 || n > 65535 || height <= 0 || max_w <= 0 ||
      (height + kTileR - 1) / kTileR > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const ExtractArgs a{static_cast<const uint8_t*>(page),
                      static_cast<const uint8_t*>(atlas),
                      page_len,
                      atlas_len,
                      static_cast<const float*>(grid),
                      static_cast<const float*>(mask),
                      static_cast<const int*>(meta),
                      out,
                      n,
                      height,
                      max_w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)extract_ss<float>(a, ss, s);
    case 1: return (int)extract_ss<__nv_bfloat16>(a, ss, s);
    case 2: return (int)extract_ss<__half>(a, ss, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// atlas (c, h, atlas_w) uint8; aux (3, n) int32 (offsets, widths, seq_lens);
// out (n, c, h, max_w) of dtype 0 fp32 / 1 bf16 / 2 fp16. All contiguous
// on `device`.
extern "C" int packed_gather_forward(const void* atlas, const void* aux, void* out, int n, int c,
                                     int h, int atlas_w, int max_w, int dtype, int device,
                                     void* stream) {
  const long long rows = (long long)c * h;
  if (n <= 0 || n > 65535 || rows <= 0 || rows > 65535 || atlas_w <= 0 || max_w <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const uint8_t* a = static_cast<const uint8_t*>(atlas);
  const int* x = static_cast<const int*>(aux);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_gather<float>(a, x, out, n, (int)rows, atlas_w, max_w, s);
    case 1: return (int)launch_gather<__nv_bfloat16>(a, x, out, n, (int)rows, atlas_w, max_w, s);
    case 2: return (int)launch_gather<__half>(a, x, out, n, (int)rows, atlas_w, max_w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
