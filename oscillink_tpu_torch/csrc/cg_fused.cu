// The Jacobi CG iteration for Hopper (sm_90a): the gather route's CG body
// (ops/solver.py cg_solve_lanes) on an [N, C] f32 block, rows on dim 0, as
// three streaming passes an iteration and three small launches between them
//
//   pass 1  Ap = ((lamG p + lamC L) + lamQ (B p))   into L, K1's output
//           (settle form: Ap = p + dt * that)        Σ p Ap partials
//   alpha   alpha = rz / (Σ partials + 1e-18)
//   pass 2  x += p alpha,  r -= Ap alpha,  z = r inv_M in registers
//                                                    Σ r z, Σ r r partials
//   finish  rz' = Σ partials, beta = rz' / (rz + 1e-18), |r| a column;
//   lanemax res = max over a lane's columns of |r|   (the one host read)
//   pass 3  p = r inv_M + p beta
//
// and, for the start, pass 2 in its init form (r = b - Ax, p = z, Σ r z).
// An operator that hands back a plain block gets pass 1 in its dot form
// (Σ p Ap only).  C is D, or L*D for L lanes side by side.
//
// Replaces no TPU kernel: XLA fused the JAX package's CG body
// (oscillink_tpu/ops/solver.py cg_solve, inside its lax.while_loop) with
// the operator's terms, so the TPU needed none written by hand.  Eager
// PyTorch ran each term as its own [N, D] pass, about 25 kernels and 40-50
// block reads and writes an iteration.
//
// What bounds it on this card: bytes.  An element costs a few flops against
// 4-byte reads and writes.  Pass 1 moves 3 blocks (p, L in; Ap out), pass 2
// 6 (x, r, p, Ap in; x, r out), pass 3 3 (r, p in; p out): 12 blocks, 6.3
// GB at 171332 x 768 (1.89 ms at 3.35 TB/s), besides K1.  The launches in
// between move only [stripes, C] partials.
//
// What the design does about it: every pass streams its blocks once, with
// 16-byte loads and stores (float4) where C is a multiple of 4 and the
// blocks are 16-byte aligned, scalars otherwise; z and the updated r of
// pass 2 never leave registers.  A CTA of 256 threads owns a stripe of rows
// and a tile of tx vector columns (tx = 32 for D = 768: a warp reads 512
// contiguous bytes of a row); its ty = 256 / tx thread rows walk the stripe
// ty rows apart.  The wrapper sizes the grid (ops/kernels/cg_fused.py
// `plan`) to about eight CTAs an SM.  Each thread sums its column's
// products in f64 (the products of two f32 values are exact in f64), the
// CTA adds its thread rows in a fixed order through shared memory and
// writes one partial row; the finalize launches add the partial rows of a
// column in a fixed order, still in f64, and round once.  No atomics: the
// same input gives the same bits on every run.  Every elementwise result is
// rounded product by product and sum by sum (__fmul_rn, __fadd_rn,
// __fsub_rn, never contracted to an FMA), so x, r, p and Ap are those of
// the classic expressions (x + p * alpha, ...) bit for bit; only the column
// sums take another order, at higher precision.
// Later work: lamC and the combine in K1's epilogue (one block less), and
// a CUDA graph over the iteration.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFinCols = 32;                     // finalize: columns a CTA
constexpr int kFinRows = kThreads / kFinCols;    // finalize: partial-row slices

template <int V>
struct Vec {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load(const float* p) {
  Vec<V> o;
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o.v[0] = t.x;
    o.v[1] = t.y;
    o.v[2] = t.z;
    o.v[3] = t.w;
  } else {
    o.v[0] = *p;
  }
  return o;
}

template <int V>
__device__ __forceinline__ void store(float* p, const Vec<V>& a) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
  } else {
    *p = a.v[0];
  }
}

// The block geometry: n rows of c floats, `rows` rows a stripe (blockIdx.x),
// tx threads across a tile of vector columns (blockIdx.y).
struct Geo {
  int64_t n, c, rows;
  int tx;
};

// This thread's first float column (live when < c), its stripe's rows
// [r0 + ty, r1) and its row step.
struct Slot {
  int64_t col, row, end;
  int step;
};

template <int V>
__device__ __forceinline__ Slot slot(const Geo& g) {
  const int tx = threadIdx.x % g.tx;
  const int ty = threadIdx.x / g.tx;
  Slot s;
  s.col = (static_cast<int64_t>(blockIdx.y) * g.tx + tx) * V;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * g.rows;
  s.row = r0 + ty;
  s.end = r0 + g.rows < g.n ? r0 + g.rows : g.n;
  s.step = kThreads / g.tx;
  return s;
}

// The CTA's column sums of acc[K][V] into parts[k][blockIdx.x][col ...]:
// thread row ty = 0 adds the thread rows' sums of its columns in the order
// ty = 0, 1, ..., so the partial does not depend on timing.
template <int K, int V>
__device__ __forceinline__ void write_partials(const double (&acc)[K][V], const Geo& g,
                                               int64_t col, double* parts) {
  __shared__ double sm[K * V][kThreads];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < V; ++j) sm[k * V + j][threadIdx.x] = acc[k][j];
  }
  __syncthreads();
  if (threadIdx.x >= g.tx || col >= g.c) return;
  const int ty_n = kThreads / g.tx;
  const int64_t stripes = gridDim.x;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      double s = 0.0;
      for (int t = 0; t < ty_n; ++t) s += sm[k * V + j][t * g.tx + threadIdx.x];
      parts[(k * stripes + blockIdx.x) * g.c + col + j] = s;
    }
  }
}

// Pass 1.  kMode 0: Σ p Ap of the block `ap`; 1: ap = ((lamG p + lamC ap) +
// lamQ (B p)) over K1's output in ap; 2: the settle form p + dt * that.
template <int V, int kMode>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* p, float* ap, const float* B, const float* lam_g,
               const float* lam_c, const float* lam_q, float dt, Geo g, double* parts) {
  const Slot s = slot<V>(g);
  double acc[1][V] = {};
  if (s.col < g.c) {
    float lg = 0.f, lc = 0.f, lq = 0.f;
    if constexpr (kMode != 0) {
      lg = *lam_g;
      lc = *lam_c;
      lq = *lam_q;
    }
    for (int64_t row = s.row; row < s.end; row += s.step) {
      const int64_t off = row * g.c + s.col;
      const Vec<V> x = load<V>(p + off);
      Vec<V> a = load<V>(ap + off);
      if constexpr (kMode != 0) {
        const float b = B[row];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float t = __fadd_rn(__fadd_rn(__fmul_rn(lg, x.v[j]), __fmul_rn(lc, a.v[j])),
                              __fmul_rn(lq, __fmul_rn(b, x.v[j])));
          if constexpr (kMode == 2) t = __fadd_rn(x.v[j], __fmul_rn(dt, t));
          a.v[j] = t;
        }
        store<V>(ap + off, a);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc[0][j] += static_cast<double>(x.v[j]) * static_cast<double>(a.v[j]);
      }
    }
  }
  write_partials<1, V>(acc, g, s.col, parts);
}

// Pass 2.  kInit: r_out = r_in - ap (r_in = b, ap = A x0), p = z, Σ r z.
// Otherwise: x_out = x_in + p alpha, r_out = r_in - ap alpha (r_out may be
// r_in, x_out x_in), Σ r z and Σ r r.  z = r inv_M (kPre) or r.
template <int V, bool kInit, bool kPre>
__global__ void __launch_bounds__(kThreads)
update_kernel(const float* x_in, float* x_out, const float* r_in, float* r_out, float* p,
              const float* ap, const float* alpha, const float* inv_m, Geo g, double* parts) {
  constexpr int K = kInit ? 1 : 2;
  const Slot s = slot<V>(g);
  double acc[K][V] = {};
  if (s.col < g.c) {
    Vec<V> al;
    if constexpr (!kInit) al = load<V>(alpha + s.col);
    for (int64_t row = s.row; row < s.end; row += s.step) {
      const int64_t off = row * g.c + s.col;
      Vec<V> r = load<V>(r_in + off);
      const Vec<V> a = load<V>(ap + off);
      const float im = kPre ? inv_m[row] : 1.f;
      if constexpr (!kInit) {
        Vec<V> x = load<V>(x_in + off);
        const Vec<V> pp = load<V>(p + off);
#pragma unroll
        for (int j = 0; j < V; ++j) x.v[j] = __fadd_rn(x.v[j], __fmul_rn(pp.v[j], al.v[j]));
        store<V>(x_out + off, x);
      }
      Vec<V> z;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float rn = kInit ? __fsub_rn(r.v[j], a.v[j])
                               : __fsub_rn(r.v[j], __fmul_rn(a.v[j], al.v[j]));
        z.v[j] = kPre ? __fmul_rn(rn, im) : rn;
        r.v[j] = rn;
        acc[0][j] += static_cast<double>(rn) * static_cast<double>(z.v[j]);
        if constexpr (!kInit) acc[K - 1][j] += static_cast<double>(rn) * static_cast<double>(rn);
      }
      store<V>(r_out + off, r);
      if constexpr (kInit) store<V>(p + off, z);
    }
  }
  write_partials<K, V>(acc, g, s.col, parts);
}

// Pass 3: p = z + p beta, z = r inv_M (kPre) or r.
template <int V, bool kPre>
__global__ void __launch_bounds__(kThreads)
direction_kernel(float* p, const float* r, const float* beta, const float* inv_m, Geo g) {
  const Slot s = slot<V>(g);
  if (s.col >= g.c) return;
  const Vec<V> be = load<V>(beta + s.col);
  for (int64_t row = s.row; row < s.end; row += s.step) {
    const int64_t off = row * g.c + s.col;
    const Vec<V> rr = load<V>(r + off);
    Vec<V> pp = load<V>(p + off);
    const float im = kPre ? inv_m[row] : 1.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float z = kPre ? __fmul_rn(rr.v[j], im) : rr.v[j];
      pp.v[j] = __fadd_rn(z, __fmul_rn(pp.v[j], be.v[j]));
    }
    store<V>(p + off, pp);
  }
}

// Σ over the `stripes` partial rows of column col (live when < c): this
// thread's slice sy, sy + kFinRows, ..., then the slices in order.  Every
// thread of the CTA calls it (it synchronises); the total is thread row 0's.
__device__ __forceinline__ double column_total(const double* parts, int64_t stripes, int64_t c,
                                               int64_t col) {
  __shared__ double sm[kFinRows][kFinCols];
  const int cx = threadIdx.x % kFinCols, sy = threadIdx.x / kFinCols;
  double s = 0.0;
  if (col < c) {
    for (int64_t i = sy; i < stripes; i += kFinRows) s += parts[i * c + col];
  }
  __syncthreads();  // sm is reused by the caller's next total
  sm[sy][cx] = s;
  __syncthreads();
  double t = 0.0;
  if (sy == 0) {
    for (int y = 0; y < kFinRows; ++y) t += sm[y][cx];
  }
  return t;
}

__global__ void __launch_bounds__(kThreads)
alpha_kernel(const double* pap, int64_t stripes, int64_t c, const float* rz, float* alpha) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kFinCols + threadIdx.x % kFinCols;
  const double t = column_total(pap, stripes, c, col);
  if (threadIdx.x < kFinCols && col < c) {
    alpha[col] = __fdiv_rn(rz[col], __fadd_rn(__double2float_rn(t), 1e-18f));
  }
}

// rz_new = Σ rz partials; beta = rz_new / (rz_old + 1e-18) when rz_old is
// given; norm = sqrt(Σ rr partials) when those are given.
__global__ void __launch_bounds__(kThreads)
finish_kernel(const double* prz, const double* prr, int64_t stripes, int64_t c,
              const float* rz_old, float* rz_new, float* beta, float* norm) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kFinCols + threadIdx.x % kFinCols;
  const double t = column_total(prz, stripes, c, col);
  const double q = prr != nullptr ? column_total(prr, stripes, c, col) : 0.0;
  if (threadIdx.x >= kFinCols || col >= c) return;
  const float rzn = __double2float_rn(t);
  rz_new[col] = rzn;
  if (rz_old != nullptr) beta[col] = __fdiv_rn(rzn, __fadd_rn(rz_old[col], 1e-18f));
  if (prr != nullptr) norm[col] = __double2float_rn(sqrt(q));
}

// NaN-propagating max, as torch.amax: once a NaN is seen it stays.
__device__ __forceinline__ float max_nan(float m, float v) { return (v != v || v > m) ? v : m; }

// res[lane] = max over the lane's d columns of norm (one CTA a lane).
__global__ void __launch_bounds__(kThreads)
lane_max_kernel(const float* norm, int64_t d, float* res) {
  __shared__ float sm[kThreads];
  const float* row = norm + static_cast<int64_t>(blockIdx.x) * d;
  float m = -INFINITY;
  for (int64_t i = threadIdx.x; i < d; i += kThreads) m = max_nan(m, row[i]);
  sm[threadIdx.x] = m;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) sm[threadIdx.x] = max_nan(sm[threadIdx.x], sm[threadIdx.x + half]);
    __syncthreads();
  }
  if (threadIdx.x == 0) res[blockIdx.x] = sm[0];
}

bool bad_geometry(long long n, long long c, long long rows, int tx, int v) {
  return n <= 0 || c <= 0 || rows <= 0 || (v != 1 && v != 4) || c % v != 0 || tx <= 0 ||
         tx > kThreads || kThreads % tx != 0;
}

dim3 grid_of(const Geo& g, int v) {
  const int64_t tiles = (g.c / v + g.tx - 1) / g.tx;
  return dim3(static_cast<unsigned>((g.n + g.rows - 1) / g.rows), static_cast<unsigned>(tiles));
}

bool misaligned(const void* a) { return reinterpret_cast<uintptr_t>(a) % 16 != 0; }

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// Each function launches on `stream` and returns cudaGetLastError() as an
// int (0 on success).  None synchronises or allocates.  The geometry (rows
// a stripe, tx, the vector width v) is `plan`'s in ops/kernels/cg_fused.py;
// the partials buffers are [k][ceil(n / rows)][c] f64.

// Pass 1; mode 0 dot, 1 operator, 2 settle operator.  The lambdas are
// device pointers to f32 scalars (unused in mode 0).
int oscillink_cg_combine(const void* p, void* ap, const void* B, const void* lam_g,
                         const void* lam_c, const void* lam_q, float dt, int mode, long long n,
                         long long c, long long rows, int tx, int v, void* parts, void* stream) {
  if (bad_geometry(n, c, rows, tx, v) || mode < 0 || mode > 2 ||
      (v == 4 && (misaligned(p) || misaligned(ap)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geo g{n, c, rows, tx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* P = static_cast<const float*>(p);
  float* AP = static_cast<float*>(ap);
  const float* b = static_cast<const float*>(B);
  const float* lg = static_cast<const float*>(lam_g);
  const float* lc = static_cast<const float*>(lam_c);
  const float* lq = static_cast<const float*>(lam_q);
  double* out = static_cast<double*>(parts);
  const dim3 grid = grid_of(g, v);
#define OSC_COMBINE(VV, MM) \
  combine_kernel<VV, MM><<<grid, kThreads, 0, s>>>(P, AP, b, lg, lc, lq, dt, g, out)
  if (v == 4) {
    if (mode == 0) OSC_COMBINE(4, 0); else if (mode == 1) OSC_COMBINE(4, 1); else OSC_COMBINE(4, 2);
  } else {
    if (mode == 0) OSC_COMBINE(1, 0); else if (mode == 1) OSC_COMBINE(1, 1); else OSC_COMBINE(1, 2);
  }
#undef OSC_COMBINE
  return last_error();
}

// Pass 2; init != 0 is the start's form (x_in, x_out and alpha unused).
// inv_m may be null (no preconditioner).
int oscillink_cg_update(const void* x_in, void* x_out, const void* r_in, void* r_out, void* p,
                        const void* ap, const void* alpha, const void* inv_m, int init,
                        long long n, long long c, long long rows, int tx, int v, void* parts,
                        void* stream) {
  if (bad_geometry(n, c, rows, tx, v) ||
      (v == 4 && (misaligned(r_in) || misaligned(r_out) || misaligned(p) || misaligned(ap) ||
                  (!init && (misaligned(x_in) || misaligned(x_out) || misaligned(alpha)))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geo g{n, c, rows, tx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* XI = static_cast<const float*>(x_in);
  float* XO = static_cast<float*>(x_out);
  const float* RI = static_cast<const float*>(r_in);
  float* RO = static_cast<float*>(r_out);
  float* P = static_cast<float*>(p);
  const float* A = static_cast<const float*>(ap);
  const float* AL = static_cast<const float*>(alpha);
  const float* IM = static_cast<const float*>(inv_m);
  double* out = static_cast<double*>(parts);
  const dim3 grid = grid_of(g, v);
  const bool pre = inv_m != nullptr;
#define OSC_UPDATE(VV, II, PP) \
  update_kernel<VV, II, PP><<<grid, kThreads, 0, s>>>(XI, XO, RI, RO, P, A, AL, IM, g, out)
  if (v == 4) {
    if (init) { if (pre) OSC_UPDATE(4, true, true); else OSC_UPDATE(4, true, false); }
    else { if (pre) OSC_UPDATE(4, false, true); else OSC_UPDATE(4, false, false); }
  } else {
    if (init) { if (pre) OSC_UPDATE(1, true, true); else OSC_UPDATE(1, true, false); }
    else { if (pre) OSC_UPDATE(1, false, true); else OSC_UPDATE(1, false, false); }
  }
#undef OSC_UPDATE
  return last_error();
}

// Pass 3; inv_m may be null.
int oscillink_cg_direction(void* p, const void* r, const void* beta, const void* inv_m,
                           long long n, long long c, long long rows, int tx, int v,
                           void* stream) {
  if (bad_geometry(n, c, rows, tx, v) ||
      (v == 4 && (misaligned(p) || misaligned(r) || misaligned(beta)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geo g{n, c, rows, tx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* P = static_cast<float*>(p);
  const float* R = static_cast<const float*>(r);
  const float* BE = static_cast<const float*>(beta);
  const float* IM = static_cast<const float*>(inv_m);
  const dim3 grid = grid_of(g, v);
  if (v == 4) {
    if (IM) direction_kernel<4, true><<<grid, kThreads, 0, s>>>(P, R, BE, IM, g);
    else direction_kernel<4, false><<<grid, kThreads, 0, s>>>(P, R, BE, IM, g);
  } else {
    if (IM) direction_kernel<1, true><<<grid, kThreads, 0, s>>>(P, R, BE, IM, g);
    else direction_kernel<1, false><<<grid, kThreads, 0, s>>>(P, R, BE, IM, g);
  }
  return last_error();
}

// alpha [c] from the [stripes, c] partials of Σ p Ap and rz [c].
int oscillink_cg_alpha(const void* pap, long long stripes, long long c, const void* rz,
                       void* alpha, void* stream) {
  if (stripes <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((c + kFinCols - 1) / kFinCols));
  alpha_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(pap), stripes, c, static_cast<const float*>(rz),
      static_cast<float*>(alpha));
  return last_error();
}

// rz_new [c] (and beta [c] when rz_old is given) from the Σ r z partials;
// with the Σ r r partials, norm [c] and res [lanes], the max of norm over
// each lane's c / lanes columns.  rz_old, beta, prr, norm and res may be
// null together as described.
int oscillink_cg_finish(const void* prz, const void* prr, long long stripes, long long c,
                        const void* rz_old, void* rz_new, void* beta, void* norm, void* res,
                        long long lanes, void* stream) {
  if (stripes <= 0 || c <= 0 || (rz_old != nullptr && beta == nullptr) ||
      (prr != nullptr && (norm == nullptr || res == nullptr || lanes <= 0 || c % lanes != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((c + kFinCols - 1) / kFinCols));
  finish_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const double*>(prz), static_cast<const double*>(prr), stripes, c,
      static_cast<const float*>(rz_old), static_cast<float*>(rz_new), static_cast<float*>(beta),
      static_cast<float*>(norm));
  if (prr != nullptr) {
    const int rc = last_error();
    if (rc != 0) return rc;
    lane_max_kernel<<<static_cast<unsigned>(lanes), kThreads, 0, s>>>(
        static_cast<const float*>(norm), c / lanes, static_cast<float*>(res));
  }
  return last_error();
}

const char* oscillink_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
