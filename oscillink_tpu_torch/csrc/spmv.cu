// Gather-SpMV for Hopper (sm_90a): the k-sparse normalized-Laplacian matvec
//
//     out[i] = X[i] - sum_{k=0..K-1} wn[i,k] * X[idx[i,k]]
//
// idx [N,K] int32, wn [N,K] f32, X [N,D] f32, out [N,D] f32, all row-major
// and contiguous.  The sum is taken in f32, starting from X[i] and
// subtracting k = 0..K-1 in order, the order of the reference's gather loop.
//
// Replaces: oscillink_tpu/ops/pallas/spmv.py:_spmv_kernel (lap_matvec_pallas),
// which pulls each neighbour row into VMEM by one DMA per (row, k) and
// reduces over a B=256 row block.
//
// What bounds it on this card: bytes.  The function does 2*N*K*D flops on
// (2*N*D + 2*N*K)*4 unique bytes, about 0.25 flop per byte, far below the
// H100's ~20 f32 flop/byte balance point.  Its floor is those unique bytes
// over 3.35 TB/s.  Rows are gathered at random, so once X outgrows the
// 50 MB L2 (N*D*4 > 50 MB, e.g. 131072 x 768 = 403 MB) each gathered row
// comes from HBM again: the practical ceiling is then N*K*D*4 gathered
// bytes plus the streaming bytes.
//
// What the design does about it: the gather is latency-bound, so the kernel
// keeps many independent 16-byte loads in flight.  One warp owns one row.
// The warp loads up to 32 (index, weight) pairs with one coalesced load and
// hands them out by shuffle, so every lane knows all neighbour ids of the
// current group without a dependent load; the unrolled k loop then issues
// the neighbour loads back to back.  D is walked with float4 loads when
// D % 4 == 0 and both X and out are 16-byte aligned, with scalar loads
// otherwise; N, K and D may take any value.  There is no shared memory and
// no per-row DMA: the TPU kernel's SMEM index table and VMEM gather buffer
// have no purpose where every thread can address device memory directly.
// Later work: locality reordering (so gathered rows hit L2), skipping
// zero-weight slots, TMA bulk row copies.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // 8 warps, 256 threads per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void sub_scaled(float& acc, float w, float v) { acc -= w * v; }

__device__ __forceinline__ void sub_scaled(float4& acc, float w, const float4& v) {
  acc.x -= w * v.x;
  acc.y -= w * v.y;
  acc.z -= w * v.z;
  acc.w -= w * v.w;
}

// T is float4 (vector path, `cols` counted in float4 units) or float.
template <typename T>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
spmv_gather_kernel(const int* __restrict__ idx, const float* __restrict__ wn,
                   const T* __restrict__ X, T* __restrict__ out,
                   int64_t n, int k, int64_t cols) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x / kWarp);
  if (row >= n) return;  // whole warp leaves together: row is warp-uniform
  const int* idx_row = idx + row * k;
  const float* wn_row = wn + row * k;
  const T* x_row = X + row * cols;
  T* out_row = out + row * cols;

  // Every lane runs the same number of column steps so the shuffles below
  // always see the full warp; lanes past the last column only skip memory.
  for (int64_t c0 = 0; c0 < cols; c0 += kWarp) {
    const int64_t c = c0 + lane;
    const bool live = c < cols;
    T acc{};
    if (live) acc = x_row[c];
    for (int a0 = 0; a0 < k; a0 += kWarp) {
      const int group = min(kWarp, k - a0);
      int my_j = 0;
      float my_w = 0.f;
      if (lane < group) {
        my_j = idx_row[a0 + lane];
        my_w = wn_row[a0 + lane];
      }
#pragma unroll 8
      for (int a = 0; a < group; ++a) {
        const int j = __shfl_sync(kFull, my_j, a);
        const float w = __shfl_sync(kFull, my_w, a);
        if (live) sub_scaled(acc, w, X[static_cast<int64_t>(j) * cols + c]);
      }
    }
    if (live) out_row[c] = acc;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 on success).  It does not synchronise and allocates nothing.
int oscillink_spmv_gather(const void* idx, const void* wn, const void* X, void* out,
                          long long n, int k, long long d, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kWarp * kRowsPerBlock);
  const dim3 grid(static_cast<unsigned>((n + kRowsPerBlock - 1) / kRowsPerBlock));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(X) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (vec4) {
    spmv_gather_kernel<float4><<<grid, block, 0, s>>>(
        static_cast<const int*>(idx), static_cast<const float*>(wn),
        static_cast<const float4*>(X), static_cast<float4*>(out), n, k, d / 4);
  } else {
    spmv_gather_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const int*>(idx), static_cast<const float*>(wn),
        static_cast<const float*>(X), static_cast<float*>(out), n, k, d);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* oscillink_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
