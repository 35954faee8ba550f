// The forward pass of the batched minimum-energy seam DP of line
// polygonization, for Hopper (sm_90a).
//
// Replaces kraken_tpu/ops/seam.py:30 _seam_forward and :47
// _seam_forward_batch (a lax.scan over columns, vmapped over patches: an
// XLA program there), called by carve_seams_device (:51). Per patch of an
// (N, H, W) fp32 stack (+inf already replaced by 3.4e38 by the caller), the
// cost of column 0 is the patch's column 0; for column j >= 1 and row r
//   up = cost[r - 1] (3.4e38 at r = 0), stay = cost[r],
//   down = cost[r + 1] (3.4e38 at r = H - 1),
//   arg = the first minimum in the order up, stay, down (jnp.argmin of
//         stack([up, cost, down])), cost'[r] = patch[r, j] + min,
// and back[j - 1, r] = arg (0 up, 1 stay, 2 down). The additions are plain
// fp32 adds (__fadd_rn), so 3.4e38 + 3.4e38 overflows to inf as in XLA; the
// comparisons are strict, so ties keep the earlier candidate. No NaN can
// arise (the inputs are finite, and only +inf or -inf sums of finite
// values appear), so the first minimum is well defined.
//
// The kernel runs each patch only to its own last column, max(widths - 1,
// 1), and writes the int8 backtrack (N, W - 1, H) up to there (later
// columns are left unwritten: the host backtrace never reads them) and the
// one cost column the host's start selection reads, the cost after column
// max(widths - 1, 1) (the JAX code's costs[max(widths - 2, 0)]), as (N, H).
// The JAX program's full (N, W - 1, H) cost tensor is never formed.
//
// Design: one CTA a patch, threads over rows (up to 1024, a thread taking
// rows tid, tid + T, ...), the cost column double-buffered in shared
// memory (2 H floats), one barrier a column. A thread reads its rows'
// energies column after column (consecutive addresses of its row, held in
// L1); the backtrack stores of a column are consecutive bytes across the
// threads. What bounds it: latency. The columns are a dependent chain of
// barriers, a few operations a row each; the bytes (the patches read once,
// the backtrack written once) are far below what the chain takes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kMaxThreads = 1024;

__global__ void __launch_bounds__(kMaxThreads)
    seam_forward_kernel(const float* __restrict__ patches, const int* __restrict__ widths,
                        int8_t* __restrict__ back, float* __restrict__ col, int H, int W) {
  extern __shared__ float s_cost[];  // [2][H]
  const int n = blockIdx.x;
  const float* p = patches + (long long)n * H * W;
  int8_t* b = back + (long long)n * (W - 1) * H;
  const int T = blockDim.x;
  int last = __ldg(widths + n) - 1;
  last = last < 1 ? 1 : (last > W - 1 ? W - 1 : last);
  for (int r = threadIdx.x; r < H; r += T) s_cost[r] = __ldg(p + (long long)r * W);
  for (int j = 1; j <= last; ++j) {
    __syncthreads();
    const float* prev = s_cost + ((j - 1) & 1) * H;
    float* cur = s_cost + (j & 1) * H;
    int8_t* bj = b + (long long)(j - 1) * H;
    for (int r = threadIdx.x; r < H; r += T) {
      const float up = r > 0 ? prev[r - 1] : kBig;
      const float stay = prev[r];
      const float down = r < H - 1 ? prev[r + 1] : kBig;
      float best = up;
      int8_t arg = 0;
      if (stay < best) {
        best = stay;
        arg = 1;
      }
      if (down < best) {
        best = down;
        arg = 2;
      }
      cur[r] = __fadd_rn(__ldg(p + (long long)r * W + j), best);
      bj[r] = arg;
    }
  }
  __syncthreads();
  const float* fin = s_cost + (last & 1) * H;
  for (int r = threadIdx.x; r < H; r += T) col[(long long)n * H + r] = fin[r];
}

}  // namespace

// patches (N, H, W) fp32, widths (N,) int32 with 1 <= widths <= W, back
// (N, W - 1, H) int8, col (N, H) fp32; all contiguous on `device`; W >= 2.
extern "C" int seam_forward(const void* patches, const void* widths, void* back, void* col, int N,
                            int H, int W, int device, void* stream) {
  if (N <= 0 || H <= 0 || W < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(float) * (size_t)H;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  if (smem > (48 << 10)) {
    err = cudaFuncSetAttribute(seam_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = (H + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  seam_forward_kernel<<<N, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(patches), static_cast<const int*>(widths),
      static_cast<int8_t*>(back), static_cast<float*>(col), H, W);
  return (int)cudaGetLastError();
}
