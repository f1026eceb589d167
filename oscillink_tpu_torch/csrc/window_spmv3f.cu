// Kernels K4, K3 and K2 for Hopper (sm_90a): the windowed operator in gather form.
//
// For a row block i of R rows, a row r in it and every column c of X [Npad, D] f32, with
//
//   win[r,c]  = sum_{w < n_win} sum_{a < K, wnl[w,r,a] != 0} A(wnl[w,r,a]) B(X[cs[w,i] W + idxl[w,r,a], c])
//   strag[r,c] = sum_{e in r's run of [off_i, off_i + min(cnt_i, s_max)), strag_w[e] != 0}
//                    C(strag_w[e] X[strag_src[e], c])
//
// the three entry points compute
//
//   K4 oscillink_window_spmv3f  out[r,c] = g[r] X[r,c] - win[r,c] - strag[r,c]
//                               pap[i,c] = sum over the rows r of block i of X[r,c] out[r,c]
//                                          (per block; the wrapper sums the blocks with torch.sum)
//   K3 oscillink_window_spmv3   out[r,c] = X[r,c] - win[r,c] - strag[r,c]
//   K2 oscillink_window_spmv    out[r,c] = X[r,c] - win[r,c]          (the stragglers are the
//                                                                    caller's epilogue)
//
// each term subtracted in the order written, the slots in slot order, a run's entries in entry
// order.  The three are compile-time variants (Kind) of one kernel: K3 reads no g and writes no
// partials, K2 besides reads no straggler entry.
//
// cs [n_win, B], idxl [n_win, Npad, K], strag_dst/src [S], strag_off/cnt [B] are int32; wnl,
// strag_w, g [Npad, 1], X, out and pap [B, D] are f32.  All row-major and contiguous.  The
// straggler list is sorted by destination row, so each row's entries form one run of its
// block's segment (padding entries carry w = 0).
//
// A, B and C are the precision tier's operand roundings, those of
// oscillink_tpu/ops/pallas/window_spmv.py:_window_dot on a one-hot whose nonzeros are the wnl
// entries (bf16(v) is round-to-nearest-even):
//   tier      A(wn)     B(x)      C
//   bf16x3    wn        x         w x
//   bf16x2    wn        bf16(x)   w x
//   oh16      bf16(wn)  x         w x
//   dma16     bf16(wn)  x         bf16(w x), as the TPU stores the weighted straggler rows
//   bf16      bf16(wn)  bf16(x)   w x
// A product of two bf16 values is exact in f32, so each tier agrees with the one-hot form to
// about 2^-16 a product.  Two live slots of a row that name the same column are one one-hot
// entry: their weights are summed in slot order onto the first before A rounds them.
//
// Replaces: oscillink_tpu/ops/pallas/window_spmv.py:_matmul_kernel3f (K4, _window_spmv3f),
// oscillink_tpu/ops/pallas/window_spmv.py:_matmul_kernel3 (K3, _window_spmv3) and
// oscillink_tpu/ops/pallas/window_spmv.py:_matmul_kernel (K2, _window_spmv).  Those walk the row
// blocks in order on one TensorCore, DMA each block's windows and its [R, n_win W] one-hot rows
// into VMEM, and run dense MXU products of the one-hot against the windows; K3 and K4 take the
// stragglers through a second one-hot [R, s_max] against the rows strag_w * X[strag_src],
// gathered into a buffer before the call (K2's caller scatters them after it).
//
// What bounds them on this card: bytes.  The useful work is k multiply-adds a row and column
// (k = 8 at the corpus tier), about 1.6 GFLOP of f32 at 131072 x 768: 0.03 ms at 67 TFLOP/s.
// The bytes are X read once (the straggler source rows are rows of X), out written once, idxl
// and wnl; K3 and K4 add the straggler entries, K4 g and the partials.  At the bench graph
// (131072 x 768 x k8, W = R = 384, 3 windows) that is about 0.83 GB for each of the three,
// 0.25 ms at 3.35 TB/s (K4 0.2489 ms, K3 and K2 a little less).  The one-hot design read a
// 605 MB one-hot besides, and computed 697 GFLOP of bf16x3 products of which 99 % multiplied by
// zero; this kernel reads no one-hot, builds no buffer of weighted straggler rows and does not
// use the tensor cores: a product on them would bring back the multiplies by zero that the
// gather removes.
//
// What the design does about it: one CUDA block of 32 warps per (row block, group of up to 8
// 32-column tiles).  The block starts the copy of its first tile's windows: n_win W rows of 128
// bytes, with cp.async (16-byte copies where D % 4 == 0 and X is 16-byte aligned, else 4-byte
// copies and zeros past D).  Neighbouring row blocks share windows, so most of those reads hit
// L2.  While they arrive, it marks each row's straggler run by one sweep of its segment (K2:
// none), and a warp a row (four rows' slot loads in flight) turns the row's n_win K slots into
// a list of its live ones, at most K, in slot order, as (staged row, A(weight)).  Every tile of
// the group then reuses those lists: a warp takes a row, a lane a column; each live slot is one
// broadcast read of the list, one conflict-free read of the staged row and one FMA.  The row's
// own X (prefetched a row ahead) is read once and its output written once with a streaming
// store; its stragglers' weights and source rows come from device memory, four loads in flight.
// Blocks whose count is 0 have no runs.  K4's column partials of x * out are summed per lane
// in row order and then over the warps in warp order; with no atomics, out and the CG
// denominator repeat to the bit from run to run.
//
// Any K: the lists of all R rows take R K 8 bytes beside the staged windows.  Where they do not
// fit (K > 24 at W = R = 384, three windows), the block walks its rows in passes of as many rows
// as fit, each pass building its rows' lists and walking the group's tiles again; K4 adds a
// pass's column sums to the earlier passes' in pass order.  A row's slots are walked in chunks
// of whole windows where K <= 32, else of 32 slots, and a live slot whose column an earlier
// chunk already listed adds its weight to that entry.
//
// Non-finite values (gather semantics): a row's output depends only on the rows it references,
// its own, its live slots' and its live stragglers' sources.  A NaN or an infinity in a window
// row that no row references stays out of the block's outputs; the dense one-hot product spread
// it through 0 * NaN to every row of the block.
// Left for later: the staged windows (147 KB at W = 384, three windows) allow one block an SM,
// and a block copies a tile's windows only after the last tile's gathers, so copies and gathers
// do not overlap past the first tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kDT = 32;          // columns per tile, one per lane
constexpr int kTileGroup = 8;    // at most this many column tiles a block walks
constexpr int kThreads = 1024;   // 32 warps; warp v takes rows v, v + 32, ... of a pass
constexpr int kWarps = kThreads / kWarp;
constexpr int kAhead = 4;        // rows whose slots a warp loads before it merges them
constexpr size_t kMaxSmem = 232448;  // what one block may use on sm_90
constexpr unsigned kFull = 0xffffffffu;

// the order of PRECISION_TIERS in ops/kernels/window_spmv.py
enum Tier { kBf16x3 = 0, kBf16x2 = 1, kBf16 = 2, kOh16 = 3, kDma16 = 4 };

// what a launch computes: K4 (g, windows, stragglers, partials), K3 (windows, stragglers) or K2
// (windows)
enum Kind { kFused = 0, kStragglers = 1, kWindowsOnly = 2 };

struct Args {
  const float* X;
  const float* g;  // K4 only
  const int* cs;
  const int* idxl;
  const float* wnl;
  const int* strag_dst;  // K4 and K3 only, as the other straggler arrays
  const int* strag_src;
  const float* strag_w;
  const int* strag_off;
  const int* strag_cnt;
  float* out;
  float* pap;  // K4 only
  long long n_pad;
  int d;
  int W;
  int R;
  int n_win;
  int K;
  int n_blocks;
  int s_max;
  int tiles_per_block;
  int rows_per_pass;
  int vec;  // D % 4 == 0 and X 16-byte aligned: stage with 16-byte copies
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int T>
__device__ __forceinline__ constexpr bool rounds_a() {
  return T == kOh16 || T == kDma16 || T == kBf16;
}

template <int T>
__device__ __forceinline__ float op_b(float x) {
  return (T == kBf16x2 || T == kBf16) ? bf16_round(x) : x;
}

template <int T>
__device__ __forceinline__ float op_c(float c) {
  return T == kDma16 ? bf16_round(c) : c;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared memory of one block: staged windows [n_win W][kDT] and, for K4, the warp column sums
// [kWarps][kDT] and the earlier passes' column sums [kTileGroup][kDT] (smem_fixed); then for
// each row of a pass its slot list [K] of (staged row, A(weight)), its count, straggler run and
// g (smem_row).
__host__ __device__ constexpr size_t sum_floats(int kind) {
  return kind == kFused ? static_cast<size_t>(kWarps + kTileGroup) * kDT : 0;
}

size_t smem_fixed(int kind, int n_win, int W) {
  return (static_cast<size_t>(n_win) * W * kDT + sum_floats(kind)) * sizeof(float);
}

size_t smem_row(int K) { return static_cast<size_t>(K) * sizeof(float2) + 4 * sizeof(int); }

// Copy the n_win windows' column tile at d0, 8 chunks of 4 columns a row; past D, zeros.
__device__ __forceinline__ void stage_windows(const Args& a, float* win, int i, int d0) {
  const int W = a.W, d = a.d;
  const int n_chunks = a.n_win * W * (kDT / 4);
  for (int e = threadIdx.x; e < n_chunks; e += kThreads) {
    const int r = e / (kDT / 4), q = e % (kDT / 4);
    const int w = r / W;
    const long long src_row = static_cast<long long>(a.cs[w * a.n_blocks + i]) * W + (r - w * W);
    const int col = d0 + 4 * q;
    const float* src = a.X + src_row * d + col;
    float* dst = win + r * kDT + 4 * q;
    if (a.vec && col + 4 <= d) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (col + t < d) {
          cp_async4(dst + t, src + t);
        } else {
          dst[t] = 0.f;
        }
      }
    }
  }
}

// blockIdx.x = group of column tiles, blockIdx.y = row block.  One block an SM (the staged
// windows fill its shared memory): the 1 lets ptxas take up to 64 registers, where it gave the K2
// variant 32 and a stack frame.
template <int TIER, int KIND>
__global__ void __launch_bounds__(kThreads, 1) window_spmv3f_kernel(Args a) {
  constexpr bool kFusedKind = KIND == kFused;
  constexpr bool kRuns = KIND != kWindowsOnly;
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = a.W, d = a.d, K = a.K, R = a.R, P = a.rows_per_pass;
  float* win = reinterpret_cast<float*>(smem);
  float* colsum = win + static_cast<size_t>(a.n_win) * W * kDT;  // K4 only
  float* pass_sum = colsum + kWarps * kDT;                        // K4 only
  float2* slots = reinterpret_cast<float2*>(colsum + sum_floats(KIND));
  int* n_live = reinterpret_cast<int*>(slots + static_cast<size_t>(P) * K);
  int* run_lo = n_live + P;
  int* run_hi = run_lo + P;
  float* g_row = reinterpret_cast<float*>(run_hi + P);

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int i = blockIdx.y;
  const int tile0 = blockIdx.x * a.tiles_per_block;
  const int n_tiles = min(a.tiles_per_block, (d + kDT - 1) / kDT - tile0);
  const long long row0 = static_cast<long long>(i) * R;
  int n_seg = 0, off = 0;  // block-uniform
  if constexpr (kRuns) {
    const int cnt = a.strag_cnt[i];
    n_seg = cnt < a.s_max ? cnt : a.s_max;
    off = a.strag_off[i];
  }
  // a chunk of a row's slots: whole windows where they fit one warp, else 32 slots
  const int spc = K <= kWarp ? (kWarp / K) * K : kWarp;
  const int n_slots = a.n_win * K;

  // 1. the copy of the first tile's windows
  stage_windows(a, win, i, tile0 * kDT);
  cp_async_commit();

  for (int p0 = 0; p0 < R; p0 += P) {
    const int np = min(P, R - p0);
    const long long prow0 = row0 + p0;
    const bool last_pass = p0 + P >= R;

    // 2. while the windows arrive: the pass's g and straggler runs.  An entry of the segment
    // that starts or ends its row's run marks it; rows with none keep the empty run [0, 0).
    if constexpr (kRuns) {
      for (int r = threadIdx.x; r < np; r += kThreads) {
        run_lo[r] = 0;
        run_hi[r] = 0;
        if constexpr (kFusedKind) g_row[r] = a.g[prow0 + r];
      }
      __syncthreads();
      for (int e = threadIdx.x; e < n_seg; e += kThreads) {
        const int dst = a.strag_dst[off + e];
        const long long r = dst - prow0;
        if (r < 0 || r >= np) continue;
        if (e == 0 || a.strag_dst[off + e - 1] != dst) run_lo[r] = off + e;
        if (e + 1 == n_seg || a.strag_dst[off + e + 1] != dst) run_hi[r] = off + e + 1;
      }
    }

    // 3. each row's live slots, once for all the block's tiles.  A lane takes one slot of a
    // chunk; the live ones are compacted in slot order as (staged row, weight).  Two live slots
    // naming one column are one one-hot entry: their weights are summed in slot order onto the
    // first, then A rounds the row's list.
    for (int rb = warp; rb < np; rb += kWarps * kAhead) {
      float wt_n[kAhead];
      int idx_n[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {  // the first chunks of kAhead rows, loaded together
        wt_n[j] = 0.f;
        idx_n[j] = 0;
        const int r = rb + j * kWarps;
        if (r < np && lane < spc && lane < n_slots) {
          const int w = lane / K;
          const long long at = (static_cast<long long>(w) * a.n_pad + prow0 + r) * K + (lane - w * K);
          wt_n[j] = a.wnl[at];
          idx_n[j] = a.idxl[at];
        }
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const int r = rb + j * kWarps;
        if (r >= np) break;  // warp-uniform
        const long long row = prow0 + r;
        float2* sl = slots + static_cast<size_t>(r) * K;
        int n = 0;
        for (int s0 = 0; s0 < n_slots; s0 += spc) {
          const int s = s0 + lane;
          float wt = wt_n[j];
          int idx = idx_n[j];
          if (s0 > 0) {
            wt = 0.f;
            if (lane < spc && s < n_slots) {
              const int w = s / K;
              const long long at = (static_cast<long long>(w) * a.n_pad + row) * K + (s - w * K);
              wt = a.wnl[at];
              idx = a.idxl[at];
            }
          }
          const bool live = wt != 0.f;
          const int key = live ? (s / K) * W + idx : -1 - lane;  // a dead slot matches no lane
          const unsigned peers = __match_any_sync(kFull, key);
          const bool first = live && __ffs(peers) - 1 == lane;
          int prev = -1;  // where an earlier chunk listed this column (K > 32 only)
          if (K > kWarp) {
            __syncwarp();
            const int listed = n < K ? n : K;
            for (int q = 0; first && q < listed; ++q) {
              if (__float_as_int(sl[q].x) == key) {
                prev = q;
                break;
              }
            }
          }
          const unsigned todo = __ballot_sync(kFull, first && prev < 0);
          if (__any_sync(kFull, (first && (peers & (peers - 1)) != 0) || prev >= 0)) {
            float sum = prev >= 0 ? sl[prev].y + wt : wt;
            for (int q = 0; q < kWarp; ++q) {
              const float t = __shfl_sync(kFull, wt, q);
              if (q > lane && ((peers >> q) & 1u)) sum += t;
            }
            wt = sum;
            if (prev >= 0) sl[prev].y = sum;
          }
          if ((todo >> lane) & 1u) {
            const int pos = n + __popc(todo & ((1u << lane) - 1u));
            if (pos < K) sl[pos] = make_float2(__int_as_float(key), wt);
          }
          n += __popc(todo);
        }
        n = n < K ? n : K;
        if (rounds_a<TIER>()) {
          __syncwarp();
          for (int q = lane; q < n; q += kWarp) sl[q].y = bf16_round(sl[q].y);
        }
        if (lane == 0) n_live[r] = n;
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // 4. the tiles: one row a warp at a time, a column a lane
    for (int t = 0; t < n_tiles; ++t) {
      const int d0 = (tile0 + t) * kDT;
      const int col = d0 + lane;
      const bool in = col < d;
      float part = 0.f;
      float x_next = (in && warp < np) ? a.X[(prow0 + warp) * d + col] : 0.f;
      for (int r = warp; r < np; r += kWarps) {
        const long long row = prow0 + r;
        const float x = x_next;
        if (in && r + kWarps < np) x_next = a.X[(row + kWarps) * d + col];
        float acc = x;
        if constexpr (kFusedKind) acc = g_row[r] * x;
        const float2* sl = slots + static_cast<size_t>(r) * K;
        const int n = n_live[r];
#pragma unroll 4
        for (int j = 0; j < n; ++j) {
          const float2 e = sl[j];
          acc = fmaf(-e.y, op_b<TIER>(win[__float_as_int(e.x) * kDT + lane]), acc);
        }
        if constexpr (kRuns) {
          const int hi = run_hi[r];
          for (int e = run_lo[r]; e < hi; e += 4) {
            float w[4], v[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              w[q] = e + q < hi ? a.strag_w[e + q] : 0.f;
              v[q] = (in && w[q] != 0.f)
                         ? a.X[static_cast<long long>(a.strag_src[e + q]) * d + col]
                         : 0.f;
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (w[q] != 0.f) acc -= op_c<TIER>(__fmul_rn(w[q], v[q]));
            }
          }
        }
        if (in) __stcs(a.out + row * d + col, acc);
        if constexpr (kFusedKind) part += x * acc;
      }
      if constexpr (kFusedKind) colsum[warp * kDT + lane] = part;
      __syncthreads();  // the tile's windows are consumed (K4: and its column sums written)
      // the next copy: the group's next tile, or its first again for the next pass
      const bool more = t + 1 < n_tiles;
      if (more) {
        stage_windows(a, win, i, d0 + kDT);
      } else if (!last_pass) {
        stage_windows(a, win, i, tile0 * kDT);
      }
      cp_async_commit();
      if constexpr (kFusedKind) {
        const int c = threadIdx.x;
        if (c < kDT && d0 + c < d) {
          float sum = 0.f;
          for (int v = 0; v < kWarps; ++v) sum += colsum[v * kDT + c];  // fixed order
          if (p0 > 0) sum = pass_sum[t * kDT + c] + sum;                 // passes in order
          if (last_pass) {
            a.pap[static_cast<long long>(i) * d + d0 + c] = sum;
          } else {
            pass_sum[t * kDT + c] = sum;
          }
        }
      }
      if (more) cp_async_wait_all();  // the next pass's first copy overlaps its list build
      __syncthreads();
    }
  }
}

template <int TIER, int KIND>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  auto kern = window_spmv3f_kernel<TIER, KIND>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int n_tiles = (a.d + kDT - 1) / kDT;
  const dim3 grid((n_tiles + a.tiles_per_block - 1) / a.tiles_per_block, a.n_blocks);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Checks the geometry, sets the launch's derived fields and launches KIND at `tier` on
// `stream`.  Returns cudaGetLastError() as an int (0 on success), or cudaErrorInvalidValue for a
// geometry the kernel does not take, without launching.
template <int KIND>
int run(Args a, int tier, void* stream) {
  if (a.n_pad <= 0 || a.d <= 0) return 0;
  const int W = a.W, R = a.R;
  if (W < 1 || R < 1 || a.n_win < 1 || a.K < 1 || (KIND != kWindowsOnly && a.s_max < 0) ||
      a.n_pad % R || a.n_pad % W || a.n_pad / R > 65535 || a.n_pad > INT_MAX ||
      static_cast<long long>(a.n_win) * a.K > INT_MAX / 2 || tier < kBf16x3 || tier > kDma16 ||
      smem_fixed(KIND, a.n_win, W) + smem_row(a.K) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t fits = (kMaxSmem - smem_fixed(KIND, a.n_win, W)) / smem_row(a.K);
  const int p_max = fits < static_cast<size_t>(R) ? static_cast<int>(fits) : R;
  const int n_pass = (R + p_max - 1) / p_max;
  a.n_blocks = static_cast<int>(a.n_pad / R);
  const int n_tiles = (a.d + kDT - 1) / kDT;
  const int groups = (n_tiles + kTileGroup - 1) / kTileGroup;
  a.tiles_per_block = (n_tiles + groups - 1) / groups;
  a.rows_per_pass = (R + n_pass - 1) / n_pass;
  a.vec = (a.d % 4 == 0) && (reinterpret_cast<uintptr_t>(a.X) % 16 == 0);
  const size_t smem = smem_fixed(KIND, a.n_win, W) + a.rows_per_pass * smem_row(a.K);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tier) {
    case kBf16x3: return static_cast<int>(launch<kBf16x3, KIND>(a, smem, s));
    case kBf16x2: return static_cast<int>(launch<kBf16x2, KIND>(a, smem, s));
    case kBf16: return static_cast<int>(launch<kBf16, KIND>(a, smem, s));
    case kOh16: return static_cast<int>(launch<kOh16, KIND>(a, smem, s));
    default: return static_cast<int>(launch<kDma16, KIND>(a, smem, s));
  }
}

Args plan_args(const void* X, const void* cs, int n_win, const void* idxl, const void* wnl, int K,
               void* out, long long n_pad, int d, int W, int R) {
  Args a{};
  a.X = static_cast<const float*>(X);
  a.cs = static_cast<const int*>(cs);
  a.n_win = n_win;
  a.idxl = static_cast<const int*>(idxl);
  a.wnl = static_cast<const float*>(wnl);
  a.K = K;
  a.out = static_cast<float*>(out);
  a.n_pad = n_pad;
  a.d = d;
  a.W = W;
  a.R = R;
  return a;
}

void set_stragglers(Args& a, const void* strag_dst, const void* strag_src, const void* strag_w,
                    const void* strag_off, const void* strag_cnt, int s_max) {
  a.strag_dst = static_cast<const int*>(strag_dst);
  a.strag_src = static_cast<const int*>(strag_src);
  a.strag_w = static_cast<const float*>(strag_w);
  a.strag_off = static_cast<const int*>(strag_off);
  a.strag_cnt = static_cast<const int*>(strag_cnt);
  a.s_max = s_max;
}

}  // namespace

extern "C" {

// Each entry launches its kernel on `stream` and returns cudaGetLastError() as an int (0 on
// success); none synchronises or allocates.  Each takes any K: where the R rows' slot lists do
// not fit beside the staged windows, a block walks its rows in passes.  A geometry it does not
// take (the staged windows and one row's list above the shared memory a block may use, or a
// row block count past the grid's limit) returns cudaErrorInvalidValue and launches nothing.
// `tier` is 0 bf16x3, 1 bf16x2, 2 bf16, 3 oh16, 4 dma16.

// K4: out = g X - windows - stragglers, pap [B, D] the per-block column sums of X * out.
int oscillink_window_spmv3f(const void* X, const void* g, const void* cs, int n_win,
                            const void* idxl, const void* wnl, int K, const void* strag_dst,
                            const void* strag_src, const void* strag_w, const void* strag_off,
                            const void* strag_cnt, int s_max, void* out, void* pap,
                            long long n_pad, int d, int W, int R, int tier, void* stream) {
  Args a = plan_args(X, cs, n_win, idxl, wnl, K, out, n_pad, d, W, R);
  set_stragglers(a, strag_dst, strag_src, strag_w, strag_off, strag_cnt, s_max);
  a.g = static_cast<const float*>(g);
  a.pap = static_cast<float*>(pap);
  return run<kFused>(a, tier, stream);
}

// K3: out = X - windows - stragglers.
int oscillink_window_spmv3(const void* X, const void* cs, int n_win, const void* idxl,
                           const void* wnl, int K, const void* strag_dst, const void* strag_src,
                           const void* strag_w, const void* strag_off, const void* strag_cnt,
                           int s_max, void* out, long long n_pad, int d, int W, int R, int tier,
                           void* stream) {
  Args a = plan_args(X, cs, n_win, idxl, wnl, K, out, n_pad, d, W, R);
  set_stragglers(a, strag_dst, strag_src, strag_w, strag_off, strag_cnt, s_max);
  return run<kStragglers>(a, tier, stream);
}

// K2: out = X - windows.
int oscillink_window_spmv(const void* X, const void* cs, int n_win, const void* idxl,
                          const void* wnl, int K, void* out, long long n_pad, int d, int W, int R,
                          int tier, void* stream) {
  return run<kWindowsOnly>(plan_args(X, cs, n_win, idxl, wnl, K, out, n_pad, d, W, R), tier,
                           stream);
}

const char* oscillink_window_spmv3f_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
