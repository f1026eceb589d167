// Bucket gather for Hopper (sm_90a): stage 1 of the edge-centric
// "bucket-shuffle" matvec
//
//     out[e] = w[e] * X[(e / e_pad) * S + local_idx[e]]
//
// X [N,D] f32 holds N = n_buckets * S source rows, bucket-major; local_idx
// [E,1] int32 holds bucket-local row ids and w [E,1] f32 the edge weights,
// both bucket-major with E = n_buckets * e_pad; out [E,D] f32.  All are
// row-major and contiguous.  Each element is one IEEE multiply (__fmul_rn,
// never contracted), so the kernel is bit-equal to the plain version
// X.index_select(0, glob) * w.
//
// Replaces: benchmarks/probe_bucket_gather.py:_bucket_gather_kernel
// (bucket_gather), which pins one bucket's [S, D] block of X in VMEM for a
// grid row and gathers ETILE = 1024 edges a step from it.
//
// What bounds it on this card: bytes.  It does one multiply per output
// element against E*D*4 bytes written, N*D*4 read and 8*E of ids and
// weights: at the probe's shape (N = 126976, D = 768, E = 1015808) 3.52 GB,
// 1.05 ms at 3.35 TB/s.  The write stream is 8x the X stream.
//
// What the design does about it: a bucket (4096 x 768 x 4 B = 12.6 MB) does
// not fit an SM's 228 KB of shared memory; the on-chip store that holds it
// on this card is the 50 MB L2.  Blocks walk the edges in order and the
// edges are bucket-major, so the blocks in flight at any moment gather from
// one or two buckets, which stay L2-resident while their edges are
// gathered: X comes from HBM about once.  The output goes out with
// streaming stores (__stcs, evict-first).  With ordinary stores the 3.1 GB
// write stream would pass through L2 at the same priority as the bucket
// and push it out, and the gathers would go back to HBM.  One warp owns one
// edge row.  D is walked with float4 loads and stores when D % 4 == 0 and X
// and out are 16-byte aligned, with scalar ones otherwise; offsets are
// 64-bit.  ETILE is the TPU grid's tile and plays no part here; the wrapper
// keeps the reference's contract (e_pad % ETILE == 0) all the same.
// Later work: several edges a warp, TMA row copies.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kEdgesPerBlock = 8;  // 8 warps, 256 threads per block

__device__ __forceinline__ float scaled(float w, float v) { return __fmul_rn(w, v); }

__device__ __forceinline__ float4 scaled(float w, const float4& v) {
  return make_float4(__fmul_rn(w, v.x), __fmul_rn(w, v.y), __fmul_rn(w, v.z), __fmul_rn(w, v.w));
}

// T is float4 (vector path, `cols` counted in float4 units) or float.
template <typename T>
__global__ void __launch_bounds__(kWarp * kEdgesPerBlock)
bucket_gather_kernel(const int* __restrict__ local_idx, const float* __restrict__ w,
                     const T* __restrict__ X, T* __restrict__ out,
                     int64_t e_total, int64_t e_pad, int64_t s, int64_t cols) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kEdgesPerBlock + (threadIdx.x / kWarp);
  if (e >= e_total) return;
  const int64_t row = (e / e_pad) * s + local_idx[e];
  const float we = w[e];
  const T* x_row = X + row * cols;
  T* out_row = out + e * cols;
#pragma unroll 4
  for (int64_t c = lane; c < cols; c += kWarp) __stcs(out_row + c, scaled(we, x_row[c]));
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 on success).  It does not synchronise and allocates nothing.
int oscillink_bucket_gather(const void* local_idx, const void* w, const void* X, void* out,
                            long long e, long long e_pad, long long s, long long d,
                            void* stream) {
  if (e <= 0 || d <= 0) return 0;
  if (e_pad <= 0 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kWarp * kEdgesPerBlock);
  const dim3 grid(static_cast<unsigned>((e + kEdgesPerBlock - 1) / kEdgesPerBlock));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(X) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (vec4) {
    bucket_gather_kernel<float4><<<grid, block, 0, st>>>(
        static_cast<const int*>(local_idx), static_cast<const float*>(w),
        static_cast<const float4*>(X), static_cast<float4*>(out), e, e_pad, s, d / 4);
  } else {
    bucket_gather_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const int*>(local_idx), static_cast<const float*>(w),
        static_cast<const float*>(X), static_cast<float*>(out), e, e_pad, s, d);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* oscillink_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
