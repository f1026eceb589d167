// Windowed block-sparse Laplacian matvec for Hopper (sm_90a): kernels K2 and K3.
//
// For each row block i of R rows and each column c of X [Npad, D] f32:
//
//   K2  out = X_blk - sum_w OH[blk, w*W:(w+1)*W] @ X[cs[w,i]*W : +W]
//   K3  out = K2 - OH3[blk, :] @ contrib[strag_off[i] : +s_max]       (only if strag_cnt[i] > 0)
//
// K4, the fused operator, is csrc/window_spmv3f.cu: it gathers from the plan's in-window slots
// and reads no one-hot.
//
// OH [Npad, n_win*W] is f32, or bf16 under the oh16/dma16 tiers; OH3 [Npad, s_max] is an exact
// 0/1 bf16 one-hot; contrib [S, D] is f32, or bf16 under dma16; cs [n_win, B], strag_off [B] and
// strag_cnt [B] are int32.  All row-major and contiguous.
//
// Precision = the tier of oscillink_tpu/ops/pallas/window_spmv.py:_window_dot: each product is
// taken in bf16 passes with f32 accumulation.  With a = the one-hot, b = the X window, hi/lo the
// round-to-nearest bf16 split (hi = bf16(v), lo = bf16(v - hi)):
//   bf16x3       a_hi.b_hi + a_hi.b_lo + a_lo.b_hi      (alo = 1, blo = 1)
//   bf16x2       a_hi.b_hi + a_lo.b_hi                  (alo = 1, blo = 0)
//   oh16, dma16  a.b_hi + a.b_lo, a stored in bf16      (alo = 0, blo = 1)
//   bf16         a_hi.b_hi                              (alo = 0, blo = 0)
// The straggler product takes two passes (c_hi, c_lo), or one when contrib is stored in bf16.
//
// Replaces: oscillink_tpu/ops/pallas/window_spmv.py:_matmul_kernel (K2, _window_spmv) and
// :_matmul_kernel3 (K3, _window_spmv3).  Those walk the row blocks in order on one TensorCore,
// DMA each block's windows and one-hot rows into VMEM and run one MXU matmul per window and bf16
// pass.
//
// What bounds it on this card: bytes.  At the corpus shape (Npad 131328, n_win*W = 1152,
// s_max 384, D 768) one bf16x3 apply of K3 reads about 1.5 GB of unique bytes (0.45 ms at
// 3.35 TB/s): the one-hot, X, out and OH3; its 697 GFLOP of dense bf16 products take 0.70 ms at
// 989 TFLOP/s.  The useful work is k = 8 multiply-adds a row; the one-hot is more than 99 %
// zeros, so nearly all of those operations multiply by zero.
//
// What the design does about it: the dense products go to the tensor cores (WMMA m16n16k16,
// bf16 in, f32 accumulate: mma.sync on sm_90a).  One CUDA block owns one (row block, 64-column
// tile) pair, so the corpus shape gives 342 * 12 = 4104 blocks for 132 SMs; the column tiles of
// a row block are adjacent in the grid and share the block's one-hot rows through L2.  One warp
// owns 32 rows x 64 columns of the output and keeps them as 8 accumulator fragments in
// registers through the windows and the straggler correction.  Each step stages 32 one-hot
// columns [R, 32] and the matching 32 window rows [32, 64] in shared memory, split into bf16
// hi/lo on the way in, and the warps multiply them.  Blocks with no stragglers skip the
// straggler loop.
// What it leaves for later: no copy/compute overlap (no cp.async, TMA or wgmma pipeline), one
// staging pass per 32 columns of the one-hot for every column tile, and the dense one-hot
// itself: a kernel that reads idxl/wnl (k entries a row) in place of the one-hot would skip the
// multiplies by zero, as K4 (csrc/window_spmv3f.cu) does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kWarp = 32;
constexpr int kMaxRows = 512;  // R: one warp per 32 rows, at most 16 warps a block
constexpr int kDT = 64;        // output columns per CUDA block
constexpr int kKC = 32;        // one-hot columns (the k of the product) per staged step
constexpr int kLDA = kKC + 8;  // bf16 row stride of the staged A tiles (skews the banks)
constexpr int kLDB = kDT + 8;  // bf16 row stride of the staged B tiles

enum Kind { kWindows = 2, kStraggler = 3 };

struct Args {
  const int* cs;
  int n_win;
  int n_blocks;
  const void* oh;
  const bf16* oh3;
  const void* contrib;
  const int* strag_off;
  const int* strag_cnt;
  int s_max;
  const float* X;
  float* out;
  int d;
  int W;
  int R;
  int alo;
  int blo;
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Round-to-nearest bf16 split: hi = bf16(v), lo = bf16(v - hi).  A bf16 input gives lo = 0.
__device__ __forceinline__ void split(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// Stage rows [0, R) x columns [0, kKC) of a row-major matrix (row stride ld) as bf16 hi and,
// when want_lo, lo.  Consecutive threads read consecutive columns of one row.
template <typename T>
__device__ __forceinline__ void stage_a(const T* __restrict__ src, long long ld, int R,
                                        bf16* a_hi, bf16* a_lo, bool want_lo) {
  for (int e = threadIdx.x; e < R * kKC; e += blockDim.x) {
    const int r = e / kKC, c = e % kKC;
    bf16 hi, lo;
    split(to_f32(src[r * ld + c]), hi, lo);
    a_hi[r * kLDA + c] = hi;
    if (want_lo) a_lo[r * kLDA + c] = lo;
  }
}

// Stage rows [0, kKC) x columns [d0, d0 + kDT) of a row-major [*, d] matrix; columns past d
// read as 0 (the ragged tail of the last column tile).
template <typename T>
__device__ __forceinline__ void stage_b(const T* __restrict__ src, int d, int d0, bf16* b_hi,
                                        bf16* b_lo, bool want_lo) {
  for (int e = threadIdx.x; e < kKC * kDT; e += blockDim.x) {
    const int r = e / kDT, c = e % kDT;
    const int col = d0 + c;
    const float v = col < d ? to_f32(src[static_cast<long long>(r) * d + col]) : 0.f;
    bf16 hi, lo;
    split(v, hi, lo);
    b_hi[r * kLDB + c] = hi;
    if (want_lo) b_lo[r * kLDB + c] = lo;
  }
}

// acc[m][n] += A[warp rows] . B over one staged step of kKC, in the tier's passes.
__device__ __forceinline__ void mma_step(FragC (&acc)[2][4], const bf16* a_hi, const bf16* a_lo,
                                         const bf16* b_hi, const bf16* b_lo, int warp, bool alo,
                                         bool blo) {
#pragma unroll
  for (int kk = 0; kk < kKC; kk += 16) {
    FragA ah[2], al[2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      wmma::load_matrix_sync(ah[m], a_hi + (warp * 32 + m * 16) * kLDA + kk, kLDA);
      if (alo) wmma::load_matrix_sync(al[m], a_lo + (warp * 32 + m * 16) * kLDA + kk, kLDA);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      FragB bh;
      wmma::load_matrix_sync(bh, b_hi + kk * kLDB + n * 16, kLDB);
#pragma unroll
      for (int m = 0; m < 2; ++m) wmma::mma_sync(acc[m][n], ah[m], bh, acc[m][n]);
      if (alo) {
#pragma unroll
        for (int m = 0; m < 2; ++m) wmma::mma_sync(acc[m][n], al[m], bh, acc[m][n]);
      }
      if (blo) {
        FragB bl;
        wmma::load_matrix_sync(bl, b_lo + kk * kLDB + n * 16, kLDB);
#pragma unroll
        for (int m = 0; m < 2; ++m) wmma::mma_sync(acc[m][n], ah[m], bl, acc[m][n]);
      }
    }
  }
}

__host__ __device__ constexpr size_t smem_bytes(int R) {
  return (2 * static_cast<size_t>(R) * kLDA + 2 * kKC * kLDB) * sizeof(bf16) +
         static_cast<size_t>(R / kWarp) * 256 * sizeof(float);
}

// blockIdx.x = column tile, blockIdx.y = row block; blockDim.x = R (one warp per 32 rows).
template <int KIND, typename OhT, typename CT>
__global__ void __launch_bounds__(kMaxRows) window_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = a.R;
  bf16* a_hi = reinterpret_cast<bf16*>(smem);
  bf16* a_lo = a_hi + R * kLDA;
  bf16* b_hi = a_lo + R * kLDA;
  bf16* b_lo = b_hi + kKC * kLDB;
  float* scratch = reinterpret_cast<float*>(b_lo + kKC * kLDB);  // [R/32][16*16]

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int i = blockIdx.y, d0 = blockIdx.x * kDT;
  const long long row0 = static_cast<long long>(i) * R;
  const long long oh_ld = static_cast<long long>(a.n_win) * a.W;
  const OhT* oh = static_cast<const OhT*>(a.oh);
  const bool alo = a.alo != 0, blo = a.blo != 0;

  FragC acc[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[m][n], 0.f);

  for (int w = 0; w < a.n_win; ++w) {
    const long long win0 = static_cast<long long>(a.cs[w * a.n_blocks + i]) * a.W;
    for (int kc = 0; kc < a.W; kc += kKC) {
      __syncthreads();  // the previous step's tiles are consumed
      stage_a(oh + row0 * oh_ld + static_cast<long long>(w) * a.W + kc, oh_ld, R, a_hi, a_lo, alo);
      stage_b(a.X + (win0 + kc) * a.d, a.d, d0, b_hi, b_lo, blo);
      __syncthreads();
      mma_step(acc, a_hi, a_lo, b_hi, b_lo, warp, alo, blo);
    }
  }

  if (KIND != kWindows && a.strag_cnt[i] > 0) {  // block-uniform predicate
    const long long off = a.strag_off[i];
    const CT* c = static_cast<const CT*>(a.contrib);
    constexpr bool c_lo = sizeof(CT) == sizeof(float);  // bf16-stored contributions: one pass
    for (int kc = 0; kc < a.s_max; kc += kKC) {
      __syncthreads();
      stage_a(a.oh3 + row0 * a.s_max + kc, a.s_max, R, a_hi, a_lo, false);
      stage_b(c + (off + kc) * a.d, a.d, d0, b_hi, b_lo, c_lo);
      __syncthreads();
      mma_step(acc, a_hi, a_lo, b_hi, b_lo, warp, false, c_lo);
    }
  }

  // Epilogue: each warp moves one 16x16 fragment at a time through its own scratch tile.
  float* sc = scratch + warp * 256;
  const int c16 = lane & 15, r_lane = lane >> 4;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      wmma::store_matrix_sync(sc, acc[m][n], 16, wmma::mem_row_major);
      __syncwarp();
      const int col = d0 + n * 16 + c16;
      if (col < a.d) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = r_lane + 2 * j;
          const long long row = row0 + warp * 32 + m * 16 + r;
          const long long at = row * a.d + col;
          a.out[at] = a.X[at] - sc[r * 16 + c16];
        }
      }
      __syncwarp();
    }
  }
}

template <int KIND, typename OhT, typename CT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.R);
  auto kern = window_kernel<KIND, OhT, CT>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.d + kDT - 1) / kDT, a.n_blocks);
  kern<<<grid, a.R, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int KIND, typename CT>
cudaError_t launch_oh(const Args& a, int oh_bf16, cudaStream_t stream) {
  return oh_bf16 ? launch<KIND, bf16, CT>(a, stream) : launch<KIND, float, CT>(a, stream);
}

// Shape checks the kernel relies on; the wrapper has checked dtypes and devices.
bool geometry_ok(long long n_pad, int d, int W, int R, int n_win) {
  return R >= kWarp && R <= kMaxRows && R % kWarp == 0 && W >= kKC && W % kKC == 0 &&
         n_win >= 1 && d >= 1 && n_pad % R == 0 && n_pad % W == 0 && n_pad / R <= 65535;
}

Args make_args(const void* cs, int n_win, const void* oh, const void* X, void* out,
               long long n_pad, int d, int W, int R, int alo, int blo) {
  Args a{};
  a.cs = static_cast<const int*>(cs);
  a.n_win = n_win;
  a.n_blocks = static_cast<int>(n_pad / R);
  a.oh = oh;
  a.X = static_cast<const float*>(X);
  a.out = static_cast<float*>(out);
  a.d = d;
  a.W = W;
  a.R = R;
  a.alo = alo;
  a.blo = blo;
  return a;
}

void set_strag(Args& a, const void* oh3, const void* contrib, const void* strag_off,
               const void* strag_cnt, int s_max) {
  a.oh3 = static_cast<const bf16*>(oh3);
  a.contrib = contrib;
  a.strag_off = static_cast<const int*>(strag_off);
  a.strag_cnt = static_cast<const int*>(strag_cnt);
  a.s_max = s_max;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError() as an int (0 on
// success).  None synchronises or allocates.

int oscillink_window_spmv(const void* cs, int n_win, const void* oh, int oh_bf16, const void* X,
                          void* out, long long n_pad, int d, int W, int R, int alo, int blo,
                          void* stream) {
  if (n_pad <= 0) return 0;
  if (!geometry_ok(n_pad, d, W, R, n_win)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(cs, n_win, oh, X, out, n_pad, d, W, R, alo, blo);
  return static_cast<int>(launch_oh<kWindows, float>(a, oh_bf16, static_cast<cudaStream_t>(stream)));
}

int oscillink_window_spmv3(const void* cs, int n_win, const void* oh, int oh_bf16, const void* X,
                           void* out, long long n_pad, int d, int W, int R, int alo, int blo,
                           const void* oh3, const void* contrib, int c_bf16, const void* strag_off,
                           const void* strag_cnt, int s_max, void* stream) {
  if (n_pad <= 0) return 0;
  if (!geometry_ok(n_pad, d, W, R, n_win) || s_max < kKC || s_max % kKC)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(cs, n_win, oh, X, out, n_pad, d, W, R, alo, blo);
  set_strag(a, oh3, contrib, strag_off, strag_cnt, s_max);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(c_bf16 ? launch_oh<kStraggler, bf16>(a, oh_bf16, s)
                                 : launch_oh<kStraggler, float>(a, oh_bf16, s));
}

const char* oscillink_window_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
