// Edge distances for Hopper (sm_90a): the squared distance along every
// graph edge, each side scaled by its own row's factor
//
//     out[i,a] = sum_c (s_i X[i,c] - s_j X[j,c])^2,   j = idx[i,a]
//
// idx [N,K] int32 and out [N,K] f32, row-major and contiguous; X [N,D] f32
// with unit column stride and a row stride `ld` >= D (a lane of a [N, Q, D]
// block is a view with ld = Q*D); s [N] f32, or none (s = 1).  Every term
// is rounded as the eager expression rounds it: each side scaled in f32,
// subtracted, squared, each step on its own (__fmul_rn, __fsub_rn, never
// contracted to an FMA).  Only the order of the sum over D differs from
// the eager `torch.sum`: within a lane in column order, across a lane group
// by a fixed shuffle tree, then over the column slabs in slab order.  No
// atomics: the same input gives the same bits on every run.
//
// Replaces no TPU kernel: XLA fused the JAX package's edge distances
// (oscillink_tpu/ops/receipts.py _edge_sq_dists) into its gather.  Eager
// PyTorch made three [rows, K, D] temporaries a row block (the gather, the
// scaled gather, the difference) and squared and summed them: 38 GB of
// traffic a call at 171332 x 768 x k8, more device time than the CG solve.
//
// What bounds it on this card: bytes, and where they come from.  The
// function does 3*N*K*D flops on (N*D + 2*N*K + N)*4 unique bytes (X once,
// idx, out and s), 0.16 ms at 171332 x 768 x k8 over 3.35 TB/s.  The N*K
// gathered row segments (4.2 GB there) are the catch, as in K1: a kNN graph
// of unordered rows has no locality, so a whole-row walk fetches each
// gathered row from HBM again.
//
// What the design does about it: kernel K1's column-slab walk (csrc/spmv.cu,
// `slab_plan` in ops/kernels/spmv.py).  Work items are (slab, row tile),
// numbered slab first, so the blocks in flight read one slab of every row
// and its K gathers hit L2.  Each item writes the per-edge sums over its
// slab's columns into a partials buffer [slabs, N, K] (streaming stores, so
// the partials do not push the slab out of L2); a second launch adds the
// slabs' partials of each edge in slab order.  With one slab (X with idx
// fits half the L2) the kernel writes `out` itself and there is no second
// launch.
//
// Within a work item (a block of 4 warps) G lanes own one row (G the
// slab's width in vectors, rounded up to a power of two, at most 32; at
// S = 32 floats a row's segment is one 128-byte line, 8 lanes of float4).
// The group loads the ids and scales of kEdges = 8 slots with one coalesced
// load and hands them out by shuffle, as K1 does, keeps one accumulator a
// slot, and each lane adds its columns' terms.  The group then sums the
// accumulators across its lanes by trading halves (a transpose: 4 + 2 + 1
// shuffles for 8 slots over 8 lanes, where a shuffle tree per slot takes
// 24), so lane a of a group of 8 ends holding slot a, and stores it.  One
// row a group, not K1's two: on the H100 at the corpus shapes two rows (56
// registers) took 4-7 % longer and four 76 %, and the first form, with
// every lane loading all 8 ids itself (126 registers), 57 %.  Columns are
// walked as float4 when D, S and ld are multiples of 4 and X is 16-byte
// aligned, as scalars otherwise; N, K, D and S may take any value (a ragged
// last slab, a ragged row tile, K past a multiple of 8).
// Later work: Y's half of the coherence drop is the same on every query
// over a standing corpus, and could be kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 128;  // 4 warps per block
constexpr int kEdges = 8;      // slots a group accumulates at once
constexpr int kSumThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float scaled(float v, float s) { return __fmul_rn(v, s); }

__device__ __forceinline__ float4 scaled(const float4& v, float s) {
  return make_float4(__fmul_rn(v.x, s), __fmul_rn(v.y, s), __fmul_rn(v.z, s), __fmul_rn(v.w, s));
}

// acc + (a - b)^2, each step rounded on its own
__device__ __forceinline__ float add_sq(float acc, float a, float b) {
  const float d = __fsub_rn(a, b);
  return __fadd_rn(acc, __fmul_rn(d, d));
}

__device__ __forceinline__ float add_sq(float acc, const float4& a, const float4& b) {
  acc = add_sq(acc, a.x, b.x);
  acc = add_sq(acc, a.y, b.y);
  acc = add_sq(acc, a.z, b.z);
  return add_sq(acc, a.w, b.w);
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ float4 add(const float4& a, const float4& b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// Sums Held accumulators over the G lanes of a group, from shuffle offset
// Off down.  While a lane holds more than one, partners at Off trade
// halves: the lane whose Off bit is clear keeps the lower half's sums, its
// partner the upper half's (in acc[0, Held/2)).  With one left, partners
// add whole.  `held_slot` names the slot each kept sum belongs to.
template <int G, int Held, int Off>
struct GroupSum {
  static __device__ __forceinline__ void run(float* acc, int sub) {
    if constexpr (Off > 0) {
      if constexpr (Held > 1) {
        constexpr int kHalf = Held / 2;
        const bool upper = (sub & Off) != 0;
#pragma unroll
        for (int e = 0; e < kHalf; ++e) {
          const float send = upper ? acc[e] : acc[e + kHalf];
          const float keep = upper ? acc[e + kHalf] : acc[e];
          acc[e] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, Off, G));
        }
        GroupSum<G, kHalf, Off / 2>::run(acc, sub);
      } else {
        acc[0] = __fadd_rn(acc[0], __shfl_xor_sync(kFull, acc[0], Off, G));
        GroupSum<G, 1, Off / 2>::run(acc, sub);
      }
    }
  }
};

// The slot of accumulator h in lane `sub` after GroupSum<G, kEdges, G/2>
template <int G>
__device__ __forceinline__ int held_slot(int h, int sub) {
  int slot = h;
  int held = kEdges;
#pragma unroll
  for (int off = G / 2; off >= 1; off >>= 1) {
    if (held > 1) {
      held >>= 1;
      if (sub & off) slot += held;
    }
  }
  return slot;
}

// T is float4 (vector path: `ld`, `cols` and `slab` counted in float4
// units) or float.  Block b covers slab b / tiles, row tile b % tiles, and
// writes that slab's [N, K] sums at part + slab * N * K.
template <typename T, int G, bool kScaled>
__global__ void __launch_bounds__(kThreads)
edge_dists_kernel(const int* __restrict__ idx, const float* __restrict__ scale,
                  const T* __restrict__ X, float* __restrict__ part, int64_t n, int k,
                  int64_t ld, int64_t cols, int64_t slab, int64_t tiles) {
  constexpr int kPer = (kEdges + G - 1) / G;           // slots a lane loads
  constexpr int kHeld = G >= kEdges ? 1 : kEdges / G;  // sums a lane ends with
  constexpr int kSame = G >= kEdges ? G / kEdges : 1;  // lanes that hold each
  const int64_t s = blockIdx.x / tiles;
  const int64_t first = (blockIdx.x - s * tiles) * (kThreads / G);
  // a warp whose rows all lie past N leaves whole; in the others every lane
  // stays for the shuffles and only lanes with a live row touch memory
  if (first + (threadIdx.x & ~(kWarp - 1)) / G >= n) return;
  const int sub = threadIdx.x & (G - 1);
  const int64_t row = first + threadIdx.x / G;
  const bool row_live = row < n;
  const int64_t r = row_live ? row : 0;
  const float si = (kScaled && row_live) ? scale[r] : 1.f;
  const int64_t c_begin = s * slab;
  const int64_t width = cols - c_begin < slab ? cols - c_begin : slab;  // ragged last slab
  float* out = part + s * n * k;

  for (int a0 = 0; a0 < k; a0 += kEdges) {
    // the group's lanes load the slots' ids and scales with one coalesced
    // load (slot a0 + p*G + sub in my_j[p]) and hand them out by shuffle
    int my_j[kPer];
    float my_s[kPer];
    float acc[kEdges];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int slot = p * G + sub;
      const bool load = row_live && slot < kEdges && a0 + slot < k;
      my_j[p] = load ? idx[r * k + a0 + slot] : 0;
      my_s[p] = (kScaled && load) ? scale[my_j[p]] : 1.f;
    }
#pragma unroll
    for (int e = 0; e < kEdges; ++e) acc[e] = 0.f;
    for (int64_t c0 = 0; c0 < width; c0 += G) {
      const int64_t c = c_begin + c0 + sub;
      const bool live = row_live && c0 + sub < width;
      T xi{};
      if (live) xi = X[r * ld + c];
      if constexpr (kScaled) xi = scaled(xi, si);
#pragma unroll
      for (int e = 0; e < kEdges; ++e) {
        if (a0 + e >= k) break;
        const int j = __shfl_sync(kFull, my_j[e / G], e % G, G);
        const float sj = kScaled ? __shfl_sync(kFull, my_s[e / G], e % G, G) : 1.f;
        if (live) {
          T xj = X[static_cast<int64_t>(j) * ld + c];
          if constexpr (kScaled) xj = scaled(xj, sj);
          acc[e] = add_sq(acc[e], xi, xj);
        }
      }
    }
    GroupSum<G, kEdges, G / 2>::run(acc, sub);
    if (row_live && sub % kSame == 0) {
#pragma unroll
      for (int h = 0; h < kHeld; ++h) {
        const int a = a0 + held_slot<G>(h, sub);
        // st.global.cs: evict-first, so the partials stream past the slab
        if (a < k) __stcs(out + r * k + a, acc[h]);
      }
    }
  }
}

// out[i] = part[0][i] + part[1][i] + ... in slab order; T float4 or float,
// m counted in T units
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
slab_sum_kernel(const T* __restrict__ part, T* __restrict__ out, int64_t m, int64_t slabs) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (i >= m) return;
  T acc = __ldcs(part + i);
  for (int64_t s = 1; s < slabs; ++s) acc = add(acc, __ldcs(part + s * m + i));
  out[i] = acc;
}

template <typename T, int G, bool kScaled>
int launch(const int* idx, const float* scale, const T* X, float* part, int64_t n, int k,
           int64_t ld, int64_t cols, int64_t slab, cudaStream_t stream) {
  constexpr int64_t rows = kThreads / G;
  const int64_t tiles = (n + rows - 1) / rows;
  const int64_t blocks = tiles * ((cols + slab - 1) / slab);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  edge_dists_kernel<T, G, kScaled><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      idx, scale, X, part, n, k, ld, cols, slab, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kScaled>
int launch_slabs(const int* idx, const float* scale, const void* X, float* part, int64_t n,
                 int k, int64_t ld, int64_t cols, int64_t slab, cudaStream_t s) {
  const T* x = static_cast<const T*>(X);
  if (slab > 16) return launch<T, 32, kScaled>(idx, scale, x, part, n, k, ld, cols, slab, s);
  if (slab > 8) return launch<T, 16, kScaled>(idx, scale, x, part, n, k, ld, cols, slab, s);
  if (slab > 4) return launch<T, 8, kScaled>(idx, scale, x, part, n, k, ld, cols, slab, s);
  if (slab > 2) return launch<T, 4, kScaled>(idx, scale, x, part, n, k, ld, cols, slab, s);
  if (slab > 1) return launch<T, 2, kScaled>(idx, scale, x, part, n, k, ld, cols, slab, s);
  return launch<T, 1, kScaled>(idx, scale, x, part, n, k, ld, cols, slab, s);
}

template <typename T>
int launch_sum(const void* part, void* out, int64_t m, int64_t slabs, cudaStream_t s) {
  const int64_t blocks = (m + kSumThreads - 1) / kSumThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  slab_sum_kernel<T><<<static_cast<unsigned>(blocks), kSumThreads, 0, s>>>(
      static_cast<const T*>(part), static_cast<T*>(out), m, slabs);
  return static_cast<int>(cudaGetLastError());
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

extern "C" {

// Launches on `stream` and returns a cudaError_t as an int (0 on success).
// It does not synchronise and allocates nothing.  `scale` may be null (s =
// 1).  With slabs = ceil(d / slab_cols) > 1, `part` is a [slabs, n, k] f32
// scratch buffer and a second launch sums it into `out`; with one slab the
// kernel writes `out` and `part` is not read.  The ids must lie in [0, n).
int oscillink_edge_sq_dists(const void* idx, const void* scale, const void* X, void* part,
                            void* out, long long n, int k, long long d, long long ld,
                            long long slab_cols, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  if (d <= 0 || ld < d || slab_cols <= 0 || slab_cols > d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t slabs = (d + slab_cols - 1) / slab_cols;
  if (slabs > 1 && part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(idx);
  const float* sc = static_cast<const float*>(scale);
  float* dst = static_cast<float*>(slabs > 1 ? part : out);
  const bool vec4 = d % 4 == 0 && slab_cols % 4 == 0 && ld % 4 == 0 && !misaligned(X);
  int rc;
  if (vec4) {
    rc = sc ? launch_slabs<float4, true>(i, sc, X, dst, n, k, ld / 4, d / 4, slab_cols / 4, s)
            : launch_slabs<float4, false>(i, sc, X, dst, n, k, ld / 4, d / 4, slab_cols / 4, s);
  } else {
    rc = sc ? launch_slabs<float, true>(i, sc, X, dst, n, k, ld, d, slab_cols, s)
            : launch_slabs<float, false>(i, sc, X, dst, n, k, ld, d, slab_cols, s);
  }
  if (rc != 0 || slabs == 1) return rc;
  const int64_t m = static_cast<int64_t>(n) * k;
  if (m % 4 == 0 && !misaligned(part) && !misaligned(out)) {
    return launch_sum<float4>(part, out, m / 4, slabs, s);
  }
  return launch_sum<float>(part, out, m, slabs, s);
}

const char* oscillink_edge_dists_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
