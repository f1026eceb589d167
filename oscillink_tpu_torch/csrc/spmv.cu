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
// over 3.35 TB/s.  The gathers are the catch: the N*K gathered row segments
// (3.2 GB at 131072 x 768 x k8) come from L2 only if the rows they read are
// resident there.  A mutual-kNN graph of unordered rows has no locality, so
// once X outgrows the 50 MB L2 (131072 x 768 = 403 MB) a whole-row walk
// fetches every gathered row from HBM again, and runs at that "gather
// ceiling" (N*K*D*4 + unique bytes over the HBM rate).
//
// What the design does about it: it makes the locality itself, by walking
// the feature dimension in column slabs.  One launch covers work items
// (slab, row tile), numbered slab first, so the blocks in flight at any
// moment all read one slab: columns [s*S, s*S + S) of every row.  The slab
// width S comes from the wrapper (`slab_plan` in ops/kernels/spmv.py): 32
// columns, the fastest width the card's sweeps found from 131072 to 1M rows
// of 768, whether or not a slab with idx and wn fits the L2 (where it does,
// each slab is read from HBM about once and gathered K times from L2).  When
// all of X fits (e.g. 5000 x 128), S = D and the walk is the whole-row one.  `out` is
// written with streaming (evict-first) stores so it does not push the slab
// out of L2.  Slabbing changes no element's arithmetic: every element is
// still X[i] less the K products in slot order, the same bits at every S.
// What bounds it then: the slab walk reads X and writes out in S-wide pieces
// one row apart (128 bytes every 3 KB at the corpus shape), a slower HBM
// pattern than whole rows, and each slab's rows are first touched by the
// gathers, in random order.  On a graph whose neighbours already sit in L2
// for a whole-row walk, slabs save nothing and cost that pattern.
//
// Within a work item (a block of 4 warps), G lanes own two rows (G the
// slab's width in vectors, rounded up to a power of two, at most 32; at
// S = 32 floats a row's segment is one 128-byte line, 8 lanes of float4).
// For each row the group loads up to G (index, weight) pairs with one
// coalesced load and hands them out by shuffle, so every lane knows the
// neighbour ids without a dependent load, and the unrolled k loop issues
// both rows' neighbour loads back to back: two rows a group in small blocks
// keep more gathers in flight, and fewer blocks in their tails, than one
// row a group in blocks of 8 warps.  Columns are walked as float4 when D and
// S are multiples of 4 and X and out are 16-byte aligned, as scalars
// otherwise; N, K, D and S may take any value (a ragged last slab, K past a
// group's lanes).  There is no shared memory and no per-row DMA: every
// thread addresses device memory directly.
// Later work: skipping zero-weight slots (a semantic change, ROADMAP queue
// C), TMA bulk copies of row segments into a shared-memory ring.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 128;  // 4 warps per block
constexpr int kRows = 2;       // rows a lane group owns in a work item
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void sub_scaled(float& acc, float w, float v) { acc -= w * v; }

__device__ __forceinline__ void sub_scaled(float4& acc, float w, const float4& v) {
  acc.x -= w * v.x;
  acc.y -= w * v.y;
  acc.z -= w * v.z;
  acc.w -= w * v.w;
}

// st.global.cs: evict-first, so the output streams past the resident slab
__device__ __forceinline__ void store_streaming(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store_streaming(float4* p, const float4& v) { __stcs(p, v); }

// T is float4 (vector path, `cols` and `slab` counted in float4 units) or
// float.  G lanes own kRows rows, kPass rows apart; block b covers slab
// b / tiles, row tile b % tiles.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
spmv_gather_kernel(const int* __restrict__ idx, const float* __restrict__ wn,
                   const T* __restrict__ X, T* __restrict__ out,
                   int64_t n, int k, int64_t cols, int64_t slab, int64_t tiles) {
  constexpr int kPass = kThreads / G;
  const int64_t s = blockIdx.x / tiles;
  const int64_t first = (blockIdx.x - s * tiles) * kPass * kRows;
  // a warp whose rows all lie past N leaves whole; in the others every lane
  // stays for the shuffles and only lanes with a live row touch memory
  if (first + (threadIdx.x & ~(kWarp - 1)) / G >= n) return;
  const int sub = threadIdx.x & (G - 1);
  int64_t r[kRows];
  bool row_live[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int64_t row = first + q * kPass + threadIdx.x / G;
    row_live[q] = row < n;
    r[q] = row_live[q] ? row : 0;
  }
  const int64_t c_begin = s * slab;
  const int64_t width = cols - c_begin < slab ? cols - c_begin : slab;  // ragged last slab

  for (int64_t c0 = 0; c0 < width; c0 += G) {
    const int64_t c = c_begin + c0 + sub;
    bool live[kRows];
    T acc[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      live[q] = row_live[q] && c0 + sub < width;
      acc[q] = T{};
      if (live[q]) acc[q] = X[r[q] * cols + c];
    }
    for (int a0 = 0; a0 < k; a0 += G) {
      const int group = min(G, k - a0);
      int my_j[kRows];
      float my_w[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        my_j[q] = 0;
        my_w[q] = 0.f;
        if (row_live[q] && sub < group) {
          my_j[q] = idx[r[q] * k + a0 + sub];
          my_w[q] = wn[r[q] * k + a0 + sub];
        }
      }
#pragma unroll 8
      for (int a = 0; a < group; ++a) {
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const int j = __shfl_sync(kFull, my_j[q], a, G);
          const float w = __shfl_sync(kFull, my_w[q], a, G);
          if (live[q]) sub_scaled(acc[q], w, X[static_cast<int64_t>(j) * cols + c]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q)
      if (live[q]) store_streaming(out + r[q] * cols + c, acc[q]);
  }
}

template <typename T, int G>
int launch(const int* idx, const float* wn, const T* X, T* out, int64_t n, int k,
           int64_t cols, int64_t slab, cudaStream_t stream) {
  constexpr int64_t rows = kThreads / G * kRows;
  const int64_t tiles = (n + rows - 1) / rows;
  const int64_t blocks = tiles * ((cols + slab - 1) / slab);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  spmv_gather_kernel<T, G><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      idx, wn, X, out, n, k, cols, slab, tiles);
  return static_cast<int>(cudaGetLastError());
}

// G = the slab's width in T units rounded up to a power of two, at most 32
template <typename T>
int launch_slabs(const void* idx, const void* wn, const void* X, void* out, int64_t n, int k,
                 int64_t cols, int64_t slab, cudaStream_t s) {
  const int* i = static_cast<const int*>(idx);
  const float* w = static_cast<const float*>(wn);
  const T* x = static_cast<const T*>(X);
  T* o = static_cast<T*>(out);
  if (slab > 16) return launch<T, 32>(i, w, x, o, n, k, cols, slab, s);
  if (slab > 8) return launch<T, 16>(i, w, x, o, n, k, cols, slab, s);
  if (slab > 4) return launch<T, 8>(i, w, x, o, n, k, cols, slab, s);
  if (slab > 2) return launch<T, 4>(i, w, x, o, n, k, cols, slab, s);
  if (slab > 1) return launch<T, 2>(i, w, x, o, n, k, cols, slab, s);
  return launch<T, 1>(i, w, x, o, n, k, cols, slab, s);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`, `slab_cols` (1..d) columns a slab, and
// returns a cudaError_t as an int (0 on success).  It does not synchronise
// and allocates nothing.
int oscillink_spmv_gather(const void* idx, const void* wn, const void* X, void* out,
                          long long n, int k, long long d, long long slab_cols, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  if (k <= 0 || slab_cols <= 0 || slab_cols > d) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = (d % 4 == 0) && (slab_cols % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(X) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (vec4) return launch_slabs<float4>(idx, wn, X, out, n, k, d / 4, slab_cols / 4, s);
  return launch_slabs<float>(idx, wn, X, out, n, k, d, slab_cols, s);
}

const char* oscillink_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
