// The two gathers that build a recognition batch on the card, for Hopper
// (sm_90a).
//
// 1. extract_kernel, the gather-warp of device line extraction. Replaces
//    kraken_tpu/inference/extraction.py:486 extract_batch_jnp (the XLA
//    program fused into the recognition forward by make_extract_forward,
//    :594). From a flat uint8 buffer (the page resident on the card, then
//    an atlas of packed line strips), each line's (129, 3, 3) grid of
//    (x, y, row) knots, its (65, 2) mask envelope and its meta row (offset,
//    w, h, W_l, seq_len, left pad, row stride, supersampling flag) it
//    writes the padded (n, 1, H, max_w) batch in the model's type, the cast
//    the JAX forward does next folded in. Per output pixel and each of the
//    ss x ss subsamples: column-lerp the three knots of the bracketing grid
//    columns, row-lerp piecewise about the middle knot, bilinear-sample the
//    buffer with the JAX clamps, test the mask envelope with its half pixel
//    of slack; average the subsamples (one centre sample, added ss^2
//    times, where the flag is 0), paint the pad columns 0 and invert the
//    ink as (255 - v) / 255.
//
//    What bounds it: bytes. The output is written once and the lines'
//    strips are read (each pixel of a strip about (ss x 4) times, from L1
//    and L2: the fixture page is 2.2 MB, the L2 50 MB); the grids, masks
//    and meta are 5 KB a line. The least bytes are the output plus the
//    strips. A pixel's arithmetic is about 60 fp32 operations a subsample,
//    far below the card's rates at these byte counts.
//
//    Design: a block of 32 x 8 threads takes 32 columns and 32 rows of one
//    line (grid: column tiles x row tiles x lines); lane x is a column, so
//    each store of a warp is 32 consecutive outputs. The column half of
//    the map (the nine lerped knot values and the two envelope rows)
//    depends on the column and the column subsample only: a thread computes
//    it once for its column, keeps it in registers and walks its 4 rows
//    with it; only the row lerp, the sample and the envelope test are done
//    a pixel. The grids and masks are read through the read-only cache (a
//    warp's lanes read the same or neighbouring knots). Pad columns and
//    batch-pad rows only write zeros. Nothing is staged in shared memory,
//    and there is no barrier.
//
//    Every step is rounded as the plain version (ops/extract.py) rounds it
//    on either device: each product and sum by its own intrinsic, so none
//    is contracted into an FMA, and the divisions are IEEE divisions. The
//    kernel equals its plain version bit for bit.
//
// 2. packed_gather_kernel, the atlas gather of input_transfer='packed'.
//    Replaces the gather of kraken_tpu/inference/recognition.py:158
//    fwd_packed: out[i, c, r, x] = atlas[c, r, off[i] + x] / 255 for
//    x < wid[i] (the index clamped into the atlas), else 0, in the model's
//    type. The division is an IEEE division, as the plain version and the
//    'uint8' route divide, so all three agree bit for bit. Bound: bytes
//    (the lines' bytes read once, the batch written once). A thread an
//    output element, a block 256 of a row's columns (coalesced stores);
//    grid: column blocks x (c * h) rows x lines.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGrid = 129;       // knot columns of a line's grid (M_GRID)
constexpr int kMask = 65;        // envelope knots of a line (M_MASK)
constexpr int kTileC = 32;       // columns a block: a warp's lanes
constexpr int kRowThreads = 8;   // warps a block
constexpr int kTileR = 32;       // rows a block, 4 a thread
constexpr int kGatherThreads = 256;

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

// torch.clamp / jnp.clip: NaN stays NaN
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float max_nan(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
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

// the column half of the map at one column subsample: the nine lerped
// (x, y, row) values of the three row knots (knot k's coordinate j at
// 3 k + j) and the envelope's two rows
struct Column {
  float p[9];
  float env[2];
};

__device__ __forceinline__ void column_map(const float* __restrict__ grid,
                                           const float* __restrict__ mask, float cf, float stepg,
                                           float stepm, Column& col) {
  const float g = __fdiv_rn(cf, stepg);
  const int gi = clampi(floor_int(g), 0, kGrid - 2);
  const float gf = clampf(__fsub_rn(g, (float)gi), 0.f, 1.f);
  const float* lo = grid + gi * 9;
#pragma unroll
  for (int k = 0; k < 9; ++k) col.p[k] = lerp(__ldg(lo + k), __ldg(lo + 9 + k), gf);
  const float gm = __fdiv_rn(cf, stepm);
  const int mi = clampi(floor_int(gm), 0, kMask - 2);
  const float mf = clampf(__fsub_rn(gm, (float)mi), 0.f, 1.f);
  const float* ml = mask + mi * 2;
  col.env[0] = lerp(__ldg(ml), __ldg(ml + 2), mf);
  col.env[1] = lerp(__ldg(ml + 1), __ldg(ml + 3), mf);
}

struct Line {
  int off, w, h, stride;
};

__device__ __forceinline__ float pixel(const uint8_t* __restrict__ buf, long long last,
                                       long long idx) {
  idx = idx < 0 ? 0 : (idx > last ? last : idx);
  return (float)__ldg(buf + idx);
}

// one subsample: the row lerp, the bilinear sample, the envelope test
__device__ __forceinline__ float sample(const uint8_t* __restrict__ buf, long long last,
                                        const Line& l, const Column& col, float rf) {
  const float* p = col.p;
  const float t_up = clampf(__fdiv_rn(__fsub_rn(rf, p[2]), max_nan(__fsub_rn(p[5], p[2]), 1e-3f)),
                            0.f, 1.f);
  const float t_lo = clampf(__fdiv_rn(__fsub_rn(rf, p[5]), max_nan(__fsub_rn(p[8], p[5]), 1e-3f)),
                            0.f, 1.f);
  const bool upper = rf < p[5];
  float x = upper ? lerp(p[0], p[3], t_up) : lerp(p[3], p[6], t_lo);
  float y = upper ? lerp(p[1], p[4], t_up) : lerp(p[4], p[7], t_lo);
  x = clampf(x, 0.f, (float)(l.w - 1));
  y = clampf(y, 0.f, (float)(l.h - 1));
  const int ix = clampi(floor_int(x), 0, max(l.w - 2, 0));
  const int iy = clampi(floor_int(y), 0, max(l.h - 2, 0));
  const float fx = __fsub_rn(x, (float)ix);
  const float fy = __fsub_rn(y, (float)iy);
  const long long base = (long long)l.off + (long long)iy * l.stride + ix;
  const long long ix1 = min(ix + 1, l.w - 1) - ix;
  const long long iy1 = (long long)(min(iy + 1, l.h - 1) - iy) * l.stride;
  const float v00 = pixel(buf, last, base);
  const float v01 = pixel(buf, last, base + ix1);
  const float v10 = pixel(buf, last, base + iy1);
  const float v11 = pixel(buf, last, base + iy1 + ix1);
  const float gx = __fsub_rn(1.f, fx);
  const float gy = __fsub_rn(1.f, fy);
  const float top = __fadd_rn(__fmul_rn(v00, gx), __fmul_rn(v01, fx));
  const float bottom = __fadd_rn(__fmul_rn(v10, gx), __fmul_rn(v11, fx));
  const float val = __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bottom, fy));
  const bool inside =
      rf >= __fsub_rn(col.env[0], 0.5f) && rf <= __fadd_rn(col.env[1], 0.5f);
  return inside ? val : 0.f;
}

template <typename T, int SS>
__global__ void __launch_bounds__(kTileC * kRowThreads)
    extract_kernel(const uint8_t* __restrict__ buf, long long last, const float* __restrict__ grid,
                   const float* __restrict__ mask, const int* __restrict__ meta,
                   T* __restrict__ out, int height, int max_w) {
  const int i = blockIdx.z;
  const int c = blockIdx.x * kTileC + threadIdx.x;
  if (c >= max_w) return;
  const int r_end = min((int)(blockIdx.y + 1) * kTileR, height);
  const int r_begin = blockIdx.y * kTileR + threadIdx.y;
  const int* m = meta + i * 8;
  const int W_l = __ldg(m + 3), padl = __ldg(m + 5), ss_on = __ldg(m + 7);
  T* o = out + (long long)i * height * max_w + c;
  const float c_rel = (float)(c - padl);
  if (!(c_rel >= 0.f && c_rel < (float)W_l)) {
    for (int r = r_begin; r < r_end; r += kRowThreads) o[(long long)r * max_w] = from_float<T>(0.f);
    return;
  }
  const Line l{__ldg(m), __ldg(m + 1), __ldg(m + 2), __ldg(m + 6)};
  const float ssf = (float)ss_on;
  const float span = (float)(max(W_l, 2) - 1);
  const float stepg = __fdiv_rn(span, (float)(kGrid - 1));
  const float stepm = __fdiv_rn(span, (float)(kMask - 1));
  const float* gl = grid + (long long)i * kGrid * 9;
  const float* ml = mask + (long long)i * kMask * 2;
  // where the flag is 0 every subsample is the pixel's centre
  const int n_sub = ss_on ? SS : 1;
  Column col[SS];
#pragma unroll
  for (int si = 0; si < SS; ++si) {
    if (si < n_sub) {
      column_map(gl, ml, __fadd_rn(c_rel, __fmul_rn(ssf, sub_offset(si, SS))), stepg, stepm,
                 col[si]);
    }
  }
  for (int r = r_begin; r < r_end; r += kRowThreads) {
    float acc = 0.f;
    if (ss_on) {
#pragma unroll
      for (int si = 0; si < SS; ++si) {
#pragma unroll
        for (int sj = 0; sj < SS; ++sj) {
          const float rf = __fadd_rn((float)r, __fmul_rn(ssf, sub_offset(sj, SS)));
          acc = __fadd_rn(acc, sample(buf, last, l, col[si], rf));
        }
      }
    } else {
      const float v = sample(buf, last, l, col[0], (float)r);
#pragma unroll
      for (int k = 0; k < SS * SS; ++k) acc = __fadd_rn(acc, v);
    }
    const float mean = __fdiv_rn(acc, (float)(SS * SS));
    o[(long long)r * max_w] = from_float<T>(__fdiv_rn(__fsub_rn(255.f, mean), 255.f));
  }
}

template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
    packed_gather_kernel(const uint8_t* __restrict__ atlas, const int* __restrict__ aux,
                         T* __restrict__ out, int n, int rows, int atlas_w, int max_w) {
  const int x = blockIdx.x * kGatherThreads + threadIdx.x;
  if (x >= max_w) return;
  const int row = blockIdx.y;
  const int i = blockIdx.z;
  float v = 0.f;
  if (x < __ldg(aux + n + i)) {
    long long idx = (long long)__ldg(aux + i) + x;
    idx = idx < 0 ? 0 : (idx >= atlas_w ? atlas_w - 1 : idx);
    v = __fdiv_rn((float)__ldg(atlas + (long long)row * atlas_w + idx), 255.f);
  }
  out[((long long)i * rows + row) * max_w + x] = from_float<T>(v);
}

template <typename T, int SS>
cudaError_t launch_extract(const uint8_t* buf, long long last, const float* grid,
                           const float* mask, const int* meta, void* out, int n, int height,
                           int max_w, cudaStream_t stream) {
  const dim3 blocks((max_w + kTileC - 1) / kTileC, (height + kTileR - 1) / kTileR, n);
  extract_kernel<T, SS><<<blocks, dim3(kTileC, kRowThreads), 0, stream>>>(
      buf, last, grid, mask, meta, static_cast<T*>(out), height, max_w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t extract_ss(const uint8_t* buf, long long last, const float* grid, const float* mask,
                       const int* meta, void* out, int n, int height, int max_w, int ss,
                       cudaStream_t stream) {
  switch (ss) {
    case 1: return launch_extract<T, 1>(buf, last, grid, mask, meta, out, n, height, max_w, stream);
    case 2: return launch_extract<T, 2>(buf, last, grid, mask, meta, out, n, height, max_w, stream);
    case 3: return launch_extract<T, 3>(buf, last, grid, mask, meta, out, n, height, max_w, stream);
    case 4: return launch_extract<T, 4>(buf, last, grid, mask, meta, out, n, height, max_w, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_gather(const uint8_t* atlas, const int* aux, void* out, int n, int rows,
                          int atlas_w, int max_w, cudaStream_t stream) {
  const dim3 blocks((max_w + kGatherThreads - 1) / kGatherThreads, rows, n);
  packed_gather_kernel<T><<<blocks, kGatherThreads, 0, stream>>>(
      atlas, aux, static_cast<T*>(out), n, rows, atlas_w, max_w);
  return cudaGetLastError();
}

}  // namespace

// buf: flat uint8 (buf_len > 0); grid (n, 129, 3, 3) fp32; mask (n, 65, 2)
// fp32; meta (n, 8) int32; out (n, 1, height, max_w) of dtype 0 fp32 /
// 1 bf16 / 2 fp16; ss 1 to 4. All contiguous on `device`.
extern "C" int extract_forward(const void* buf, const void* grid, const void* mask,
                               const void* meta, void* out, long long buf_len, int n, int height,
                               int max_w, int ss, int dtype, int device, void* stream) {
  if (buf_len <= 0 || n <= 0 || n > 65535 || height <= 0 || max_w <= 0 ||
      (height + kTileR - 1) / kTileR > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const uint8_t* b = static_cast<const uint8_t*>(buf);
  const float* g = static_cast<const float*>(grid);
  const float* m = static_cast<const float*>(mask);
  const int* me = static_cast<const int*>(meta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long last = buf_len - 1;
  switch (dtype) {
    case 0: return (int)extract_ss<float>(b, last, g, m, me, out, n, height, max_w, ss, s);
    case 1: return (int)extract_ss<__nv_bfloat16>(b, last, g, m, me, out, n, height, max_w, ss, s);
    case 2: return (int)extract_ss<__half>(b, last, g, m, me, out, n, height, max_w, ss, s);
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
