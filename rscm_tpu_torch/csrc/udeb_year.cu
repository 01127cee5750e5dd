// One year of ClimateUDEB monthly sub-steps: two threads per ensemble member,
// one for each hemisphere's ocean column; beside it the year's tangent-linear
// kernel (forward mode) and its adjoint (reverse mode).
//
// udeb_year_kernel replaces the Pallas TPU kernel
// rscm_tpu/ops/udeb_month.py::udeb_year_update (pallas_call at
// udeb_month.py:400, body _month_body at :87-277).  The plain PyTorch version
// beside its wrapper (rscm_tpu_torch/ops/udeb_month.py, udeb_year_plain)
// performs the same operations in the same order; built with -fmad=false the
// two agree bit for bit.
//
// udeb_year_jvp_kernel and udeb_year_vjp_kernel replace the JAX package's
// derivative rule, which is not a pallas_call: custom_jvp differentiates the
// kernel's jnp reference (_year_jvp, rscm_tpu/ops/udeb_month.py:542-546), and
// XLA compiles that derivative into the program around the kernel.
// - The tangent kernel runs the month below on dual numbers (value,
//   tangent): the values repeat the forward's operations in its order, the
//   tangents follow each operation's derivative rule as PyTorch's forward
//   mode states it, and every predicate (where, minimum, maximum) decides on
//   the value.  Its plain version is plain_jvp of udeb_year_plain.
// - The adjoint kernel runs the year's forward once, with the forward's own
//   month code, writing a tape to device memory as it goes: each month's
//   starting scalars and, for every layer, the Thomas factors c' and d' and
//   the unclamped solution.  Then for month 12 down to 1 it runs the month's
//   adjoint (month_vjp) in reverse order, reading the tape back: the
//   coupling step, the clamp and the transposed tridiagonal solve, the
//   assembly, the ground heat.  No month is replayed.  Its plain version,
//   udeb_year_vjp_plain, performs the same operations in the same order.
//   At a tie, minimum and maximum send half the cotangent to each operand,
//   as PyTorch's and JAX's rules do.
//
// Layout: member-minor.  Row r of member m of a (rows, B) input is at
// r * B + m, so the threads of a warp read neighbouring addresses; the
// device-memory scratch of the derivative kernels is thread-minor (row r of
// thread 2m + h at r * 2B + 2m + h) for the same reason.
// init_prof (and its tangent) is addressed through explicit strides so a
// broadcast view (stride 0 over members) needs no copy.
//
// Bound on an H100: operations at a large batch.  A member-year is 2 columns
// x 12 months x n layers of a serial Thomas step, each ~40 additions and
// multiplications and 2 IEEE divisions, against ~(4n + 40) values in and
// out; the tangent kernel does ~2.5x the forward's arithmetic, the adjoint
// ~2.4x (one forward and the adjoint), which is what the function needs;
// the adjoint's tape, ~3n values a column-month, is written and read back
// once.  At the batches of a gradient (one member for a MAP gradient, eight
// for one walker's forward mode, 512 for 64 NUTS chains x 8) a launch is
// one serial chain of dependent operations per member: latency.  Design:
// - Threads 2k and 2k+1 of a block hold the northern and southern column of
//   one member.  The columns are independent within a month; they meet only
//   in the land / exchange / upwelling step, where the pair swaps its air
//   and land temperatures (in the adjoint: their cotangents) with
//   __shfl_xor_sync and both form the global mean in the plain version's
//   order.
// - Each thread's column (overwritten by d' in the forward sweep and by the
//   solution in the back sweep) lives in dynamic shared memory, laid out
//   [layer][thread] so that a warp's 32 values fall on consecutive banks;
//   the forward keeps its Thomas coefficients c' there too.  The tangent
//   kernel keeps its dual c' in device memory instead (unless one wave of
//   blocks holds the batch: then in shared memory, where the sweeps wait on
//   no load; the launch picks, jvp_kind), and the adjoint its tape, both in
//   a scratch buffer the caller allocates at the length the library states
//   (udeb_year_config_*): both read rows back through a ring
//   of RING slots a thread in shared memory, filled with cp.async RING rows
//   before a row is read, so the reads' latency overlaps the sweeps'
//   arithmetic.  The adjoint keeps
//   only the column's and the initial profile's cotangents in shared memory
//   (its forward pass uses the same rows for its column and c'); the scalar
//   rows' cotangents accumulate in registers.  Per-thread shared memory is
//   then about the forward's, and so is the occupancy: 8 warps per SM in
//   float64 at 50 layers.
// - The per-layer geometry (a device buffer) and a broadcast initial profile
//   are staged into shared memory once per block.
// - In float64 at 50 layers shared memory holds 8 warps per SM, too few to
//   hide the latency of the sweep's chain of IEEE divisions, so the forward
//   sweep forms row i+1's coefficients before row i's divisions and the back
//   sweep loads each row one ahead: the scheduler overlaps them.
// - The layer count n is a run-time argument.  A block of one warp must fit
//   its shared memory (smem_bytes, per kernel), which bounds n; the host
//   picks the block size with the most resident threads per SM.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace {

// Leading constants of the geometry, passed by value; the order matches
// _GEOM_SCALARS in ops/udeb_month.py.
enum GeomIndex {
  G_DT_SUB, G_INV_C_MIX, G_INV_DZMIX_DZ1, G_INV_DZ_MIX, G_INV_DZ, G_INV_DZ2,
  G_K_DT_DZMIX, G_K_DT_DZ, G_DSCALE,
  G_FL0, G_FL1, G_FO0, G_FO1, G_SAFE_FL0, G_SAFE_FL1, G_CMFO0, G_CMFO1,
  G_Q0, G_Q1, G_Q2, G_Q3, G_FGNO, G_FGNL, G_FGSO, G_FGSL, G_INV_FGNO, G_INV_FGSO,
  G_NSCALAR
};

template <typename T>
struct Consts {
  T s[G_NSCALAR];
};

// Scalar rows of the packed input, in the order of SCALAR_ROWS.
enum ScalarRow {
  S_LAM_O, S_LAM_L, S_KAPPA, S_KAPPA_DKDT, S_KAPPA_MIN, S_W_INITIAL, S_W_VAR_FRAC,
  S_K_LO, S_K_NS, S_K_LG, S_AMPLIFY, S_PI_RATIO, S_ADJ_ALPHA, S_ADJ_GAMMA,
  S_MAX_TEMP, S_C_GROUND, S_ERF_START, S_ERF_END, S_T_POLAR, S_W_THRESH_NH,
  S_W_THRESH_SH, S_ROWS
};
constexpr int S_SHARED = S_W_THRESH_NH;  // the rows both hemispheres read

// The kernels of this file: the forward, the tangent kernel in its two
// layouts (c' in device memory through a ring, or in shared memory), and
// the adjoint.
enum Kind { K_FORWARD = 0, K_JVP = 1, K_VJP = 2, K_JVP_SHARED = 3 };

constexpr int MAX_THREADS = 256;
constexpr int MIN_THREADS = 32;
constexpr size_t MAX_BLOCK_SMEM = 232448;  // 227 KB: the most one block may use
// Slots a thread of the tangent and adjoint kernels keeps in shared memory
// for each row array it reads back from device memory: a row is fetched
// RING rows before it is read.  A power of two; 4 keeps the adjoint's
// float64 block of 8 warps at 50 layers within MAX_BLOCK_SMEM.
constexpr int RING = 4;

// ---------------------------------------------------------------------------
// dual numbers for the tangent kernel
// ---------------------------------------------------------------------------

template <typename T>
struct Dual {
  T v, t;
};

template <typename T>
__device__ __forceinline__ Dual<T> dual(T v) { return {v, T(0)}; }

// Each tangent is PyTorch's forward-mode rule for the operation:
// mul a_t * b + a * b_t, div (a_t - b_t * (a / b)) / b.
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) { return {a.v + b.v, a.t + b.t}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, T b) { return {a.v + b, a.t}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator+(T a, Dual<T> b) { return {a + b.v, b.t}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) { return {a.v - b.v, a.t - b.t}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, T b) { return {a.v - b, a.t}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(T a, Dual<T> b) { return {a - b.v, -b.t}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a) { return {-a.v, -a.t}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, a.t * b.v + a.v * b.t};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, T b) { return {a.v * b, a.t * b}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator*(T a, Dual<T> b) { return {a * b.v, b.t * a}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T q = a.v / b.v;
  return {q, (a.t - b.t * q) / b.v};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, T b) { return {a.v / b, a.t / b}; }

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ double val(double x) { return x; }
template <typename T>
__device__ __forceinline__ T val(Dual<T> x) { return x.v; }

__device__ __forceinline__ float tabs(float x) { return fabsf(x); }
__device__ __forceinline__ double tabs(double x) { return fabs(x); }

// torch.minimum / torch.maximum: NaN propagates.  The tangent is PyTorch's,
// b_t + w (a_t - b_t), w 1 where a is taken, 0 where b is, 0.5 at a tie.
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename T>
__device__ __forceinline__ Dual<T> tmin(Dual<T> a, Dual<T> b) {
  const T w = a.v == b.v ? T(0.5) : (a.v < b.v ? T(1) : T(0));
  return {tmin(a.v, b.v), b.t + w * (a.t - b.t)};
}
template <typename T>
__device__ __forceinline__ Dual<T> tmax(Dual<T> a, Dual<T> b) {
  const T w = a.v == b.v ? T(0.5) : (a.v > b.v ? T(1) : T(0));
  return {tmax(a.v, b.v), b.t + w * (a.t - b.t)};
}
template <typename T>
__device__ __forceinline__ Dual<T> tmin(Dual<T> a, T b) { return tmin(a, dual(b)); }

// The cotangents of minimum(a, b) / maximum(a, b) from g: all to the operand
// taken, half to each at a tie (PyTorch's and JAX's rules).
template <typename T>
__device__ __forceinline__ void min_bar(T a, T b, T g, T& ga, T& gb) {
  if (a == b) {
    ga = g * T(0.5);
    gb = ga;
  } else if (a < b) {
    ga = g;
    gb = T(0);
  } else {
    ga = T(0);
    gb = g;
  }
}
template <typename T>
__device__ __forceinline__ void max_bar(T a, T b, T g, T& ga, T& gb) {
  if (a == b) {
    ga = g * T(0.5);
    gb = ga;
  } else if (a > b) {
    ga = g;
    gb = T(0);
  } else {
    ga = T(0);
    gb = g;
  }
}

template <typename T>
__device__ __forceinline__ T shfl(unsigned pair, T x) {
  return __shfl_xor_sync(pair, x, 1);
}
template <typename T>
__device__ __forceinline__ Dual<T> shfl(unsigned pair, Dual<T> x) {
  return {__shfl_xor_sync(pair, x.v, 1), __shfl_xor_sync(pair, x.t, 1)};
}

// ---------------------------------------------------------------------------
// one member's hemisphere, and its month
// ---------------------------------------------------------------------------

// Per-layer geometry rows of the device buffer: af_top[n], af_bot[n],
// af_diff[n], one_minus_rel[n-1], inv_dz_dzup[n-2].
__host__ __device__ inline int geom_len(int n) { return 5 * n - 3; }

template <typename T>
struct Geo {
  const T *af_top, *af_bot, *af_diff, *omr, *idzu;
};

// This thread's place: layers, block width, thread, hemisphere, pair mask.
struct Lane {
  int n, nt, tid, h;
  unsigned pair;
};

// The hemisphere's constants, in the working dtype.
template <typename T>
struct Hemi {
  T dt_sub, f_l, f_o, safe_fl, cmfo, q_ocean, q_land, fg_land, fg_ocean, inv_fg_ocean;
  T fg_other_ocean, fg_other_land;
};

template <typename T>
__device__ __forceinline__ Hemi<T> hemi_consts(const Consts<T>& g, int h) {
  Hemi<T> c;
  c.dt_sub = g.s[G_DT_SUB];
  c.f_l = h ? g.s[G_FL1] : g.s[G_FL0];
  c.f_o = h ? g.s[G_FO1] : g.s[G_FO0];
  c.safe_fl = h ? g.s[G_SAFE_FL1] : g.s[G_SAFE_FL0];
  c.cmfo = h ? g.s[G_CMFO1] : g.s[G_CMFO0];
  c.q_ocean = h ? g.s[G_Q2] : g.s[G_Q0];
  c.q_land = h ? g.s[G_Q3] : g.s[G_Q1];
  c.fg_land = h ? g.s[G_FGSL] : g.s[G_FGNL];
  c.fg_ocean = h ? g.s[G_FGSO] : g.s[G_FGNO];
  c.inv_fg_ocean = h ? g.s[G_INV_FGSO] : g.s[G_INV_FGNO];
  c.fg_other_ocean = h ? g.s[G_FGNO] : g.s[G_FGSO];
  c.fg_other_land = h ? g.s[G_FGNL] : g.s[G_FGSL];
  return c;
}

// The SST -> air map's constants (branch-free in gamma, as the plain version).
template <typename V>
struct Air {
  V alpha, gamma, gamma_safe, t_star, delta_max;
  bool nonzero;
};

template <typename T, typename V>
__device__ __forceinline__ Air<V> air_consts(const V (&sc)[S_ROWS]) {
  Air<V> a;
  a.alpha = sc[S_ADJ_ALPHA];
  a.gamma = sc[S_ADJ_GAMMA];
  a.nonzero = tabs(val(a.gamma)) > T(1e-15);
  a.gamma_safe = a.nonzero ? a.gamma : V{T(1)};
  a.t_star = -(a.alpha - T(1.0)) / (T(2.0) * a.gamma_safe);
  a.delta_max = a.alpha * a.t_star + a.gamma * a.t_star * a.t_star - a.t_star;
  return a;
}

template <typename T, typename V>
__device__ __forceinline__ V sst_to_air(const Air<V>& a, V sst) {
  const V quad = (val(sst) < val(a.t_star)) ? a.alpha * sst + a.gamma * sst * sst
                                            : sst + a.delta_max;
  return a.nonzero ? quad : a.alpha * sst;
}

// An initial profile (value or tangent; a missing tangent comes as a
// broadcast zero): staged in shared memory when it is broadcast over
// members, else read through its strides.
template <typename T>
struct Prof {
  const T* staged;  // the block's copy of a broadcast profile, or null
  const T* global;  // this thread's column in device memory (stride s0)
  int64_t s0;
  int off;          // h * n: this hemisphere's rows of the staged copy
  __device__ __forceinline__ T operator()(int i) const {
    return staged ? staged[off + i] : global[(int64_t)i * s0];
  }
};

template <typename T>
struct ProfDual {
  Prof<T> value, tangent;
  __device__ __forceinline__ Dual<T> operator()(int i) const { return {value(i), tangent(i)}; }
};

// ---------------------------------------------------------------------------
// where a month's Thomas coefficients c' go, and the adjoint's tape
// ---------------------------------------------------------------------------

// c' in shared memory, [layer][thread] (the forward, and the adjoint's
// forward pass).
template <typename V>
struct SmemRows {
  V* p;  // this thread's row 0
  int nt;
  __device__ __forceinline__ void put(int i, V v) { p[i * nt] = v; }
  __device__ __forceinline__ V get(int i) const { return p[i * nt]; }
  __device__ __forceinline__ void done(int) {}
};

// c' in device memory, read back by the back sweep (rows n-2 down to 0)
// through a ring of RING slots in shared memory.  The forward sweep writes
// each row to the ring too, so the last RING rows are there when the back
// sweep starts and never go to device memory; when the back sweep is done
// with row i (done), row i - RING is fetched into its slot with cp.async,
// one commit group per row, and get waits for the group RING - 1 rows
// back.  Every fetched row is read, so no copy is in flight when a sweep
// ends.
template <typename V>
struct RingRows {
  V* g;        // this thread's row 0 in device memory
  int64_t gs;  // elements between rows there
  V* ring;     // this thread's slot 0
  int nt, n;
  __device__ __forceinline__ V* slot(int i) const { return ring + (i & (RING - 1)) * nt; }
  __device__ __forceinline__ void put(int i, V v) {
    if (i < n - 1 - RING) g[i * gs] = v;
    *slot(i) = v;
  }
  __device__ __forceinline__ V get(int i) const {
    __pipeline_wait_prior(RING - 1);
    return *slot(i);
  }
  __device__ __forceinline__ void done(int i) {
    if (i >= RING) __pipeline_memcpy_async(slot(i), g + (i - RING) * gs, sizeof(V));
    __pipeline_commit();
  }
};

// The adjoint's tape of one month of this thread's column in device memory
// (rows `stride` elements apart): row i holds the unclamped solution x_i
// and the Thomas factors c'_{i-1} and d'_{i-1} (row 0 holds x_0 alone), so
// that each sweep of the adjoint reads the rows of one layer together.
template <typename T>
struct Tape {
  T *x, *cp, *dp;
  int64_t stride;
  __device__ __forceinline__ void factors(int i, T c, T d) const {  // c'_i, d'_i
    cp[(i + 1) * stride] = c;
    dp[(i + 1) * stride] = d;
  }
  __device__ __forceinline__ void solution(int i, T v) const { x[i * stride] = v; }
};

// The adjoint's reads of a month's tape: row r's planes (x, c', d' or the
// first two) fetched together into a ring of RING slots a plane in shared
// memory with cp.async, as one commit group; a sweep fetches RING rows
// ahead of the row it reads (each row's group waited for RING - 1 groups
// later), and reads every row it fetches.
template <typename T>
struct TapeRing {
  Tape<T> tape;
  T* ring;  // this thread's slot 0 of plane 0; plane k at ring + k * RING * nt
  int nt;
  __device__ __forceinline__ T* slot(int plane, int r) const {
    return ring + (plane * RING + (r & (RING - 1))) * nt;
  }
  __device__ __forceinline__ void fetch(int r, int planes, bool valid) {
    if (valid) {
      const int64_t o = r * tape.stride;
      __pipeline_memcpy_async(slot(0, r), tape.x + o, sizeof(T));
      __pipeline_memcpy_async(slot(1, r), tape.cp + o, sizeof(T));
      if (planes == 3) __pipeline_memcpy_async(slot(2, r), tape.dp + o, sizeof(T));
    }
    __pipeline_commit();
  }
  __device__ __forceinline__ void wait() const { __pipeline_wait_prior(RING - 1); }
  __device__ __forceinline__ T x(int r) const { return *slot(0, r); }
  __device__ __forceinline__ T cp(int r) const { return *slot(1, r); }  // c'_{r-1}
  __device__ __forceinline__ T dp(int r) const { return *slot(2, r); }  // d'_{r-1}
};

// One monthly sub-step of this thread's hemisphere, on values (V = T) or dual
// numbers (V = Dual<T>): the forward kernel's body.  col holds the column and
// cpr (SmemRows or RingRows) receives c'.  With TAPE (the adjoint's forward
// pass) the forward sweep also writes c' and d' to the tape, and the back
// substitution the unclamped solution.
template <typename T, typename V, bool TAPE, typename P, typename C>
__device__ __forceinline__ void month(const Consts<T>& g, const Hemi<T>& c, const Geo<T>& geo,
                                      const Lane& ln, const V (&sc)[S_ROWS], const Air<V>& air,
                                      V aeff, V w_thresh, const P& prof, T frac, int land_heat,
                                      V* col, C& cpr, const Tape<T>& tape, V& land, V& ground,
                                      V& hemi, V& upw) {
  const int n = ln.n, nt = ln.nt, tid = ln.tid, h = ln.h;
  const T dt_sub = c.dt_sub;
  const T* af_top = geo.af_top;
  const T* af_bot = geo.af_bot;
  const T* af_diff = geo.af_diff;
  const V max_temp = sc[S_MAX_TEMP];
  const V erf = sc[S_ERF_START] + frac * (sc[S_ERF_END] - sc[S_ERF_START]);

  // -- ground-heat damping ------------------------------------------------
  if (land_heat) {
    const V flux = sc[S_K_LG] * (land - ground);
    const V delta = flux / (c.safe_fl * sc[S_C_GROUND]) * dt_sub;
    ground = ground + ((c.f_l < T(1e-15)) ? V{T(0)} : delta);
  }

  // -- implicit ocean column update of this thread's hemisphere -----------
  const V w = upw;
  const V ocean0 = col[tid];
  const V dkdt_term = sc[S_KAPPA_DKDT] * (ocean0 - col[(n - 1) * nt + tid]);
  auto kappa = [&](int i) -> V {
    return tmax((geo.omr[i] * dkdt_term + sc[S_KAPPA]) * g.s[G_DSCALE], sc[S_KAPPA_MIN]);
  };
  const V denom_fb = c.f_o * (sc[S_K_LO] + c.f_l * sc[S_LAM_L]);
  const V term_feedback =
      aeff * g.s[G_INV_C_MIX] *
      (sc[S_LAM_O] + sc[S_LAM_L] * sc[S_K_LO] * sc[S_AMPLIFY] * c.f_l / denom_fb);
  const V term_diff0 = kappa(0) * g.s[G_INV_DZMIX_DZ1] * dt_sub;
  const V term_upwell0 = w * g.s[G_INV_DZ_MIX] * dt_sub;
  const V forcing_amp = T(1.0) + sc[S_K_LO] * c.f_l / denom_fb;
  const V tul = w * g.s[G_INV_DZ] * dt_sub;
  const V delta_w = w - sc[S_W_INITIAL];
  const V t_polar = sc[S_T_POLAR];
  const V pto = sc[S_PI_RATIO] * tul * ocean0;
  const V k_dw = g.s[G_K_DT_DZ] * delta_w;
  const V k_dw_tp = k_dw * t_polar;

  // row 0 (mixed layer)
  const V b0 = T(1.0) + term_feedback * dt_sub * af_top[0] + term_diff0 * af_bot[0] +
               term_upwell0 * sc[S_PI_RATIO] * af_bot[0];
  const V c0 = -(term_diff0 + term_upwell0) * af_bot[0];
  V d0 = ocean0 +
         (erf * c.q_ocean * forcing_amp + hemi) * g.s[G_INV_C_MIX] * dt_sub * af_top[0];
  if (land_heat) {
    d0 = d0 - sc[S_K_LG] * (land - ground) / c.cmfo * dt_sub * af_top[0];
  }
  d0 = d0 + g.s[G_K_DT_DZMIX] * delta_w * (prof(1) - t_polar) * af_bot[0];

  // forward sweep: c' to its own rows, d' over the consumed column.  The
  // rows' coefficients do not depend on the sweep, so row i+1's are formed
  // before row i's two divisions: the scheduler fills the divisions'
  // latency with them.
  V cp_prev = c0 / b0;
  V dp_prev = d0 / b0;
  cpr.put(0, cp_prev);
  col[tid] = dp_prev;
  if constexpr (TAPE) tape.factors(0, cp_prev, dp_prev);
  V kappa_prev = kappa(0);
  V prof_i = prof(1);
  V a_nx, b_nx, c_nx, d_nx;  // the next row's coefficients
  auto interior_row = [&](int i) {
    const V kappa_i = kappa(i);
    const V t_diff_up = kappa_prev * geo.idzu[i - 1] * dt_sub;
    const V t_diff_down = kappa_i * g.s[G_INV_DZ2] * dt_sub;
    kappa_prev = kappa_i;
    const T at = af_top[i], ab = af_bot[i], ad = af_diff[i];
    a_nx = -t_diff_up * at;
    b_nx = T(1.0) + t_diff_up * at + t_diff_down * ab + tul * at;
    c_nx = -(t_diff_down + tul) * ab;
    const V prof_next = prof(i + 1);
    V d_i = col[i * nt + tid] + pto * ad;
    d_i = d_i + k_dw * (prof_next * ab - prof_i * at);
    d_nx = d_i + k_dw_tp * ad;
    prof_i = prof_next;
  };
  auto last_row = [&]() {
    const int i = n - 1;
    const V term_diff_last = kappa_prev * g.s[G_INV_DZ2] * dt_sub;
    const T at = af_top[i];
    a_nx = -term_diff_last * at;
    b_nx = T(1.0) + (term_diff_last + tul) * at;
    const V d_l = col[i * nt + tid] + pto * at;
    d_nx = d_l + k_dw * (t_polar - prof(i)) * at;
  };
  auto eliminate = [&](int i, V a_i, V c_i, V d_i, V denom) {
    cp_prev = c_i / denom;
    dp_prev = (d_i - a_i * dp_prev) / denom;
    cpr.put(i, cp_prev);
    col[i * nt + tid] = dp_prev;
    if constexpr (TAPE) tape.factors(i, cp_prev, dp_prev);
  };
  if (n > 2) {
    interior_row(1);
    for (int i = 1; i < n - 2; ++i) {
      const V a_i = a_nx, c_i = c_nx, d_i = d_nx;
      const V denom = b_nx - a_i * cp_prev;
      interior_row(i + 1);
      eliminate(i, a_i, c_i, d_i, denom);
    }
    const V a_i = a_nx, c_i = c_nx, d_i = d_nx;
    const V denom = b_nx - a_i * cp_prev;
    last_row();
    eliminate(n - 2, a_i, c_i, d_i, denom);
  } else {
    last_row();
  }
  V x = (d_nx - a_nx * dp_prev) / (b_nx - a_nx * cp_prev);

  // back substitution on the unclamped solution, then the clamp; each
  // row's two values are loaded one row ahead
  if constexpr (TAPE) tape.solution(n - 1, x);
  col[(n - 1) * nt + tid] = tmin(x, max_temp);
  V col_i = col[(n - 2) * nt + tid], cpr_i = cpr.get(n - 2);
  for (int i = n - 2; i >= 0; --i) {
    const V d_prime = col_i, c_prime = cpr_i;
    cpr.done(i);
    const int j = i > 0 ? i - 1 : 0;
    col_i = col[j * nt + tid];
    cpr_i = cpr.get(j);
    x = d_prime - c_prime * x;
    if constexpr (TAPE) tape.solution(i, x);
    col[i * nt + tid] = tmin(x, max_temp);
  }
  const V sst = tmin(x, max_temp);

  // -- land / exchange / upwelling: the pair swaps its temperatures --------
  const V t_air_own = sst_to_air<T>(air, sst);
  const V t_air_other = shfl(ln.pair, t_air_own);
  const V t_air_nho = h ? t_air_other : t_air_own;
  const V t_air_sho = h ? t_air_own : t_air_other;
  land = tmin((erf * c.q_land * c.fg_land + sc[S_K_LO] * sc[S_AMPLIFY] * t_air_own) /
                  (sc[S_LAM_L] * c.fg_land + sc[S_K_LO]),
              max_temp);
  const V land_other = shfl(ln.pair, land);
  const V land_nh = h ? land_other : land;
  const V land_sh = h ? land : land_other;
  if (c.fg_ocean > T(1e-15)) hemi = sc[S_K_NS] * c.inv_fg_ocean * (t_air_other - t_air_own);

  const V global_temp = t_air_nho * g.s[G_FGNO] + land_nh * g.s[G_FGNL] +
                        t_air_sho * g.s[G_FGSO] + land_sh * g.s[G_FGSL];
  const V w_min = sc[S_W_INITIAL] * (T(1.0) - sc[S_W_VAR_FRAC]);
  const V ratio = tmin(global_temp / w_thresh, T(1));
  upw = tmax(sc[S_W_INITIAL] * (T(1.0) - sc[S_W_VAR_FRAC] * ratio), w_min);
}

// The scalar rows' cotangents this thread accumulates: the rows both
// hemispheres read, its own upwelling threshold, its alpha_eff, and the SST
// -> air map's delta_max (taken back to alpha and gamma once a year).
template <typename T>
struct ScalBar {
  T s[S_SHARED];
  T w_thresh, aeff, delta_max;
};

// The adjoint of one month of this thread's hemisphere (the twin of
// _month_vjp_plain in ops/udeb_month.py, the same operations in the same
// order).  tr reads the month's tape (the unclamped solution, c' and d', as
// the forward pass wrote them); ocean0 .. w are the month's starting values
// and ground1 its ground temperature after the damping.  bar holds the
// cotangents of the month's ocean column and receives those of its starting
// column; land_b .. upw_b likewise for the vector state; pb accumulates the
// initial profile's cotangents.
template <typename T>
__device__ __forceinline__ void month_vjp(const Consts<T>& g, const Hemi<T>& c, const Geo<T>& geo,
                                          const Lane& ln, const T (&sc)[S_ROWS],
                                          const Air<T>& air, T aeff, T w_thresh,
                                          const Prof<T>& prof, T frac, int land_heat, T ocean0,
                                          T ocean_last, T land, T ground, T ground1, T w,
                                          TapeRing<T>& tr, T* bar, T* pb, T& land_b,
                                          T& ground_b, T& hemi_b, T& upw_b, ScalBar<T>& sb) {
  const int n = ln.n, nt = ln.nt, tid = ln.tid, h = ln.h;
  const T dt = c.dt_sub;
  const T* at = geo.af_top;
  const T* ab = geo.af_bot;
  const T* ad = geo.af_diff;
  const T mt = sc[S_MAX_TEMP];
  const T t_polar = sc[S_T_POLAR];
  const T w_initial = sc[S_W_INITIAL], w_var = sc[S_W_VAR_FRAC];
  T* s = sb.s;
  auto row = [&](int i) { return i * nt + tid; };

  // the top-down sweep's first rows, fetched while the coupling step runs
  for (int r = 0; r < RING; ++r) tr.fetch(r, 2, r < n);
  tr.wait();

  // -- the coupling step's values, as the forward formed them ---------------
  const T erf = sc[S_ERF_START] + frac * (sc[S_ERF_END] - sc[S_ERF_START]);
  const T sst = tmin(tr.x(0), mt);
  const T t_own = sst_to_air<T>(air, sst);
  const T t_other = shfl(ln.pair, t_own);
  const T ka = sc[S_K_LO] * sc[S_AMPLIFY];
  const T num_l = erf * c.q_land * c.fg_land + ka * t_own;
  const T den_l = sc[S_LAM_L] * c.fg_land + sc[S_K_LO];
  const T land_pre = num_l / den_l;
  const T land_new = tmin(land_pre, mt);
  const T land_other = shfl(ln.pair, land_new);
  const T t_air_nho = h ? t_other : t_own;
  const T t_air_sho = h ? t_own : t_other;
  const T land_nh = h ? land_other : land_new;
  const T land_sh = h ? land_new : land_other;
  const T gt = t_air_nho * g.s[G_FGNO] + land_nh * g.s[G_FGNL] + t_air_sho * g.s[G_FGSO] +
               land_sh * g.s[G_FGSL];

  // -- upwelling ------------------------------------------------------------
  const T r0 = gt / w_thresh;
  const T ratio = tmin(r0, T(1));
  const T b2 = T(1.0) - w_var * ratio;
  const T w_min = w_initial * (T(1.0) - w_var);
  T g_a, g_b;
  max_bar(w_initial * b2, w_min, upw_b, g_a, g_b);
  s[S_W_INITIAL] += g_a * b2;
  const T b2_bar = g_a * w_initial;
  s[S_W_VAR_FRAC] += -(b2_bar * ratio);
  const T ratio_bar = -(b2_bar * w_var);
  s[S_W_INITIAL] += g_b * (T(1.0) - w_var);
  s[S_W_VAR_FRAC] += -(g_b * w_initial);
  T r0_bar, g_one;
  min_bar(r0, T(1), ratio_bar, r0_bar, g_one);
  const T gt_bar = r0_bar / w_thresh;
  sb.w_thresh = sb.w_thresh - gt_bar * r0;
  T t_own_bar = gt_bar * c.fg_ocean;
  T t_other_bar = gt_bar * c.fg_other_ocean;
  const T land_own_bar = gt_bar * c.fg_land;
  const T land_other_bar = gt_bar * c.fg_other_land;

  // -- interhemispheric exchange -------------------------------------------
  T hemi_in_b = hemi_b;
  if (c.fg_ocean > T(1e-15)) {
    const T dif = t_other - t_own;
    const T e = sc[S_K_NS] * c.inv_fg_ocean;
    s[S_K_NS] += (hemi_b * dif) * c.inv_fg_ocean;
    const T dif_bar = hemi_b * e;
    t_other_bar = t_other_bar + dif_bar;
    t_own_bar = t_own_bar - dif_bar;
    hemi_in_b = T(0);
  }

  // -- land temperature: the pair swaps its land cotangents -----------------
  const T lb = (land_b + land_own_bar) + shfl(ln.pair, land_other_bar);
  T g_l, g_mt;
  min_bar(land_pre, mt, lb, g_l, g_mt);
  s[S_MAX_TEMP] += g_mt;
  const T num_bar = g_l / den_l;
  const T den_bar = -(num_bar * land_pre);
  s[S_LAM_L] += den_bar * c.fg_land;
  s[S_K_LO] += den_bar;
  T erf_bar = (num_bar * c.fg_land) * c.q_land;
  const T ka_bar = num_bar * t_own;
  s[S_K_LO] += ka_bar * sc[S_AMPLIFY];
  s[S_AMPLIFY] += ka_bar * sc[S_K_LO];
  t_own_bar = t_own_bar + num_bar * ka;
  const T t_bar = t_own_bar + shfl(ln.pair, t_other_bar);

  // -- SST -> air: the branch the forward took --------------------------------
  T sst_bar;
  if (air.nonzero) {
    if (sst < air.t_star) {
      s[S_ADJ_ALPHA] += t_bar * sst;
      const T gs = air.gamma * sst;
      const T gs_bar = t_bar * sst;
      s[S_ADJ_GAMMA] += gs_bar * sst;
      sst_bar = (t_bar * air.alpha + t_bar * gs) + gs_bar * air.gamma;
    } else {
      sst_bar = t_bar;
      sb.delta_max = sb.delta_max + t_bar;
    }
  } else {
    s[S_ADJ_ALPHA] += t_bar * sst;
    sst_bar = t_bar * air.alpha;
  }

  // -- the clamp, then the back substitution's adjoint (top down) -----------
  // (a sum over the rows is taken within the month, then added to the
  // year's: one running sum over every row of the year rounds far more in
  // float32)
  T xb = T(0), mt_sum = T(0);
  for (int i = 0; i < n; ++i) {
    tr.wait();
    const T x_i = tr.x(i), cp_im1 = tr.cp(i);
    tr.fetch(i + RING, 2, i + RING < n);
    T gi = bar[row(i)];
    if (i == 0) gi = gi + sst_bar;
    T g_x, g_m;
    min_bar(x_i, mt, gi, g_x, g_m);
    mt_sum = mt_sum + g_m;
    xb = i == 0 ? g_x : g_x - xb * cp_im1;
    bar[row(i)] = xb;
  }
  s[S_MAX_TEMP] += mt_sum;

  // -- the forward sweep's and the assembly's adjoint, last row first -------
  const T dkdt_term = sc[S_KAPPA_DKDT] * (ocean0 - ocean_last);
  auto kappa_pre = [&](int i) -> T {
    return (geo.omr[i] * dkdt_term + sc[S_KAPPA]) * g.s[G_DSCALE];
  };
  auto kappa = [&](int i) -> T { return tmax(kappa_pre(i), sc[S_KAPPA_MIN]); };
  const T tul = w * g.s[G_INV_DZ] * dt;
  const T delta_w = w - w_initial;
  const T k_dw = g.s[G_K_DT_DZ] * delta_w;
  T dkdt_bar = T(0), tul_bar = T(0), pto_bar = T(0), k_dw_bar = T(0), k_dw_tp_bar = T(0);
  T kappa_sum = T(0), kmin_sum = T(0);
  auto kappa_bar_add = [&](int i, T kb) {
    T g_k, g_min;
    max_bar(kappa_pre(i), sc[S_KAPPA_MIN], kb, g_k, g_min);
    kmin_sum = kmin_sum + g_min;
    const T kp_bar = g_k * g.s[G_DSCALE];
    kappa_sum = kappa_sum + kp_bar;
    dkdt_bar = dkdt_bar + kp_bar * geo.omr[i];
  };

  // the last row; carried to the rows above: the pending cotangents of
  // d'_{i-1}, c'_{i-1} and kappa_{i-1}, and the tape's x_i, c'_{i-1},
  // d'_{i-1} (tape row i: each row above reads one new tape row)
  for (int r = 0; r < RING; ++r) tr.fetch(n - 1 - r, 3, n - 1 - r >= 1);
  int i = n - 1;
  T pend_dp, pend_cp, kappa_carry;
  tr.wait();
  T x_c = tr.x(i), cp_c = tr.cp(i), dp_c = tr.dp(i);
  tr.fetch(i - RING, 3, i - RING >= 1);
  {
    const T tdl = kappa(n - 2) * g.s[G_INV_DZ2] * dt;
    const T a_l = -tdl * at[i];
    const T b_l = T(1.0) + (tdl + tul) * at[i];
    const T den = b_l - a_l * cp_c;
    const T nb = bar[row(i)] / den;
    const T db = -(nb * x_c);
    T a_bar = -(nb * dp_c);
    pend_dp = -(nb * a_l);
    a_bar = a_bar - db * cp_c;
    pend_cp = -(db * a_l);
    bar[row(i)] = nb;
    pto_bar = pto_bar + nb * at[i];
    const T kq_bar = nb * at[i];
    k_dw_bar = k_dw_bar + kq_bar * (t_polar - prof(i));
    const T pq_bar = kq_bar * k_dw;
    s[S_T_POLAR] += pq_bar;
    pb[row(i)] = pb[row(i)] - pq_bar;
    const T s_bar = db * at[i];
    const T tdl_bar = s_bar - a_bar * at[i];
    tul_bar = tul_bar + s_bar;
    kappa_carry = (tdl_bar * dt) * g.s[G_INV_DZ2];
  }
  for (i = n - 2; i >= 1; --i) {
    tr.wait();
    const T x_ip1 = x_c, cp_i = cp_c, dp_i = dp_c;  // x_{i+1}, c'_i, d'_i
    x_c = tr.x(i);
    cp_c = tr.cp(i);  // c'_{i-1}
    dp_c = tr.dp(i);  // d'_{i-1}
    tr.fetch(i - RING, 3, i - RING >= 1);
    const T kappa_i = kappa(i);
    const T kappa_im1 = kappa(i - 1);
    const T tdu = kappa_im1 * geo.idzu[i - 1] * dt;
    const T tdd = kappa_i * g.s[G_INV_DZ2] * dt;
    const T a_i = -tdu * at[i];
    const T b_i = T(1.0) + tdu * at[i] + tdd * ab[i] + tul * at[i];
    const T den = b_i - a_i * cp_c;
    const T xb_i = bar[row(i)];
    const T dp_bar = xb_i + pend_dp;
    const T cp_bar = pend_cp - xb_i * x_ip1;
    const T nb = dp_bar / den;
    T db = -(nb * dp_i);
    T a_bar = -(nb * dp_c);
    pend_dp = -(nb * a_i);
    const T c_bar = cp_bar / den;
    db = db - c_bar * cp_i;
    const T b_bar = db;
    a_bar = a_bar - db * cp_c;
    pend_cp = -(db * a_i);
    bar[row(i)] = nb;
    pto_bar = pto_bar + nb * ad[i];
    const T dif = prof(i + 1) * ab[i] - prof(i) * at[i];
    k_dw_bar = k_dw_bar + nb * dif;
    const T dif_bar = nb * k_dw;
    pb[row(i + 1)] = pb[row(i + 1)] + dif_bar * ab[i];
    pb[row(i)] = pb[row(i)] - dif_bar * at[i];
    k_dw_tp_bar = k_dw_tp_bar + nb * ad[i];
    const T s_bar = -(c_bar * ab[i]);
    const T tdd_bar = s_bar + b_bar * ab[i];
    tul_bar = tul_bar + s_bar;
    tul_bar = tul_bar + b_bar * at[i];
    const T tdu_bar = b_bar * at[i] - a_bar * at[i];
    kappa_bar_add(i, kappa_carry + (tdd_bar * dt) * g.s[G_INV_DZ2]);
    kappa_carry = (tdu_bar * dt) * geo.idzu[i - 1];
  }

  // row 0 (mixed layer)
  const T denom_fb = c.f_o * (sc[S_K_LO] + c.f_l * sc[S_LAM_L]);
  const T p1 = sc[S_LAM_L] * sc[S_K_LO];
  const T p2 = p1 * sc[S_AMPLIFY];
  const T p4 = p2 * c.f_l / denom_fb;
  const T ae = aeff * g.s[G_INV_C_MIX];
  const T term_feedback = ae * (sc[S_LAM_O] + p4);
  const T term_diff0 = kappa(0) * g.s[G_INV_DZMIX_DZ1] * dt;
  const T tu0 = w * g.s[G_INV_DZ_MIX] * dt;
  const T b0 = T(1.0) + term_feedback * dt * at[0] + term_diff0 * ab[0] +
               tu0 * sc[S_PI_RATIO] * ab[0];
  const T xb0 = bar[row(0)];
  const T dp0_bar = xb0 + pend_dp;
  const T cp0_bar = pend_cp - xb0 * x_c;  // x_1; cp_c, dp_c are c'_0, d'_0
  const T d0_bar = dp0_bar / b0;
  T b0_bar = -(d0_bar * dp_c);
  const T c0_bar = cp0_bar / b0;
  b0_bar = b0_bar - c0_bar * cp_c;
  bar[row(0)] = d0_bar;
  const T kb_bar = d0_bar * ab[0];
  const T pp = prof(1) - t_polar;
  const T ka0 = g.s[G_K_DT_DZMIX] * delta_w;
  const T ka0_bar = kb_bar * pp;
  const T pp_bar = kb_bar * ka0;
  pb[row(1)] = pb[row(1)] + pp_bar;
  s[S_T_POLAR] += -pp_bar;
  T delta_w_bar = ka0_bar * g.s[G_K_DT_DZMIX];
  T land_in_b = T(0);
  T ground1_b = ground_b;
  if (land_heat) {
    const T lg2 = land - ground1;
    const T ga_bar = ((-d0_bar * at[0]) * dt) / c.cmfo;
    s[S_K_LG] += ga_bar * lg2;
    const T lg2_bar = ga_bar * sc[S_K_LG];
    land_in_b = lg2_bar;
    ground1_b = ground1_b - lg2_bar;
  }
  const T p6 = sc[S_K_LO] * c.f_l / denom_fb;
  const T forcing_amp = T(1.0) + p6;
  const T fa = erf * c.q_ocean;
  const T fc_bar = ((d0_bar * at[0]) * dt) * g.s[G_INV_C_MIX];
  hemi_in_b = hemi_in_b + fc_bar;
  const T fa_bar = fc_bar * forcing_amp;
  const T famp_bar = fc_bar * fa;
  erf_bar = erf_bar + fa_bar * c.q_ocean;
  const T s0_bar = -(c0_bar * ab[0]);
  T td0_bar = s0_bar;
  T tu0_bar = s0_bar;
  const T tf_bar = (b0_bar * at[0]) * dt;
  td0_bar = td0_bar + b0_bar * ab[0];
  const T tup_bar = b0_bar * ab[0];
  tu0_bar = tu0_bar + tup_bar * sc[S_PI_RATIO];
  s[S_PI_RATIO] += tup_bar * tu0;
  kappa_bar_add(0, kappa_carry + (td0_bar * dt) * g.s[G_INV_DZMIX_DZ1]);
  T w_bar = (tu0_bar * dt) * g.s[G_INV_DZ_MIX];

  // -- the rows' shared constants -------------------------------------------
  k_dw_bar = k_dw_bar + k_dw_tp_bar * t_polar;
  s[S_T_POLAR] += k_dw_tp_bar * k_dw;
  delta_w_bar = delta_w_bar + k_dw_bar * g.s[G_K_DT_DZ];
  const T pt = sc[S_PI_RATIO] * tul;
  const T pt_bar = pto_bar * ocean0;
  bar[row(0)] = bar[row(0)] + pto_bar * pt;
  s[S_PI_RATIO] += pt_bar * tul;
  tul_bar = tul_bar + pt_bar * sc[S_PI_RATIO];
  w_bar = w_bar + delta_w_bar;
  s[S_W_INITIAL] += -delta_w_bar;
  w_bar = w_bar + (tul_bar * dt) * g.s[G_INV_DZ];
  const T p5_bar = famp_bar / denom_fb;
  T dfb_bar = -(p5_bar * p6);
  s[S_K_LO] += p5_bar * c.f_l;
  const T ae_bar = tf_bar * (sc[S_LAM_O] + p4);
  sb.aeff = sb.aeff + ae_bar * g.s[G_INV_C_MIX];
  const T s2_bar = tf_bar * ae;
  s[S_LAM_O] += s2_bar;
  const T p3_bar = s2_bar / denom_fb;
  dfb_bar = dfb_bar - p3_bar * p4;
  const T p2_bar = p3_bar * c.f_l;
  const T p1_bar = p2_bar * sc[S_AMPLIFY];
  s[S_AMPLIFY] += p2_bar * p1;
  s[S_LAM_L] += p1_bar * sc[S_K_LO];
  s[S_K_LO] += p1_bar * sc[S_LAM_L];
  const T s1_bar = dfb_bar * c.f_o;
  s[S_K_LO] += s1_bar;
  s[S_LAM_L] += s1_bar * c.f_l;
  s[S_KAPPA_MIN] += kmin_sum;
  s[S_KAPPA] += kappa_sum;
  const T dd = ocean0 - ocean_last;
  s[S_KAPPA_DKDT] += dkdt_bar * dd;
  const T dd_bar = dkdt_bar * sc[S_KAPPA_DKDT];
  bar[row(0)] = bar[row(0)] + dd_bar;
  bar[row(n - 1)] = bar[row(n - 1)] - dd_bar;

  // -- ground-heat damping, and the month's forcing --------------------------
  T ground_in_b = ground1_b;
  if (land_heat) {
    const T lmg = land - ground;
    const T flux = sc[S_K_LG] * lmg;
    const T den_g = c.safe_fl * sc[S_C_GROUND];
    const T u_g = flux / den_g;
    const T flux_bar = ((c.f_l < T(1e-15)) ? T(0) : ground1_b * dt) / den_g;
    s[S_C_GROUND] += -(flux_bar * u_g) * c.safe_fl;
    s[S_K_LG] += flux_bar * lmg;
    const T lmg_bar = flux_bar * sc[S_K_LG];
    land_in_b = land_in_b + lmg_bar;
    ground_in_b = ground_in_b - lmg_bar;
  }
  s[S_ERF_START] += erf_bar;
  const T fr_bar = erf_bar * frac;
  s[S_ERF_END] += fr_bar;
  s[S_ERF_START] += -fr_bar;
  land_b = land_in_b;
  ground_b = ground_in_b;
  hemi_b = hemi_in_b;
  upw_b = w_bar;
}

// ---------------------------------------------------------------------------
// shared memory, limits and launch configuration
// ---------------------------------------------------------------------------

// Dynamic shared memory of a block of each kernel: the threads' arrays
// (forward: column and c'; tangent: the column as dual numbers and the
// ring of its c'; adjoint: the column's and the profile's cotangents, which
// its forward pass uses for its column and c', and the ring of the tape's
// three planes), the geometry, and the initial profile (the tangent kernel:
// and its tangent), each 2n.
template <typename T, int K>
__host__ __device__ inline size_t smem_bytes(int n, int threads) {
  const size_t geo = sizeof(T) * (geom_len(n) + 2 * n);
  if (K == K_JVP) return 2 * sizeof(T) * (size_t)threads * (n + RING) + geo + sizeof(T) * 2 * n;
  if (K == K_JVP_SHARED) {
    return 2 * sizeof(T) * (size_t)threads * (2 * n - 1) + geo + sizeof(T) * 2 * n;
  }
  if (K == K_VJP) return sizeof(T) * (size_t)threads * (2 * n + 3 * RING) + geo;
  return sizeof(T) * (size_t)threads * (2 * n - 1) + geo;
}

// The most layers a kernel takes: a block of one warp must fit the shared
// memory a block may use.  The wrapper asks for it (udeb_year_*max_layers_*).
template <typename T, int K>
int max_layers() {
  int n = 2;
  while (smem_bytes<T, K>(n + 1, MIN_THREADS) <= MAX_BLOCK_SMEM) ++n;
  return n;
}

// float32 keeps ~half the registers of float64 and fits twice the threads
// in shared memory: let two full blocks share an SM.
template <typename T> struct MinBlocks { static constexpr int value = 1; };
template <> struct MinBlocks<float> { static constexpr int value = 2; };

// What every kernel sets up for its member: the staged geometry and profile,
// its scalar rows, its thread's place and constants.
template <typename T>
struct Setup {
  Geo<T> geo;
  const T* prof_s;  // the staged profile (after the geometry)
  T* rest;          // the first shared address after them
};

template <typename T>
__device__ __forceinline__ Setup<T> stage(unsigned char* smem_raw, size_t thread_bytes, int n,
                                          const T* geom, const T* init, int64_t init_s0,
                                          bool prof_shared, const T* tinit, int64_t tinit_s0,
                                          bool tprof_shared) {
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  T* af_top = reinterpret_cast<T*>(smem_raw + thread_bytes);
  Setup<T> s;
  s.geo.af_top = af_top;
  s.geo.af_bot = af_top + n;
  s.geo.af_diff = af_top + 2 * n;
  s.geo.omr = af_top + 3 * n;
  s.geo.idzu = af_top + 4 * n - 1;
  T* prof_s = af_top + geom_len(n);
  s.prof_s = prof_s;
  s.rest = prof_s + 2 * n;
  for (int k = tid; k < geom_len(n); k += nt) af_top[k] = geom[k];
  if (prof_shared) {
    for (int k = tid; k < 2 * n; k += nt) prof_s[k] = init[(int64_t)k * init_s0];
  }
  if (tprof_shared) {
    for (int k = tid; k < 2 * n; k += nt) s.rest[k] = tinit[(int64_t)k * tinit_s0];
  }
  __syncthreads();
  return s;
}

template <typename T>
__device__ __forceinline__ Prof<T> prof_of(const T* staged, const T* init, int64_t s0,
                                           int64_t s1, int h, int n, int64_t m) {
  Prof<T> p;
  p.staged = s1 == 0 ? staged : nullptr;
  p.global = init + (int64_t)(h * n) * s0 + m * s1;
  p.s0 = s0;
  p.off = h * n;
  return p;
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, MinBlocks<T>::value) udeb_year_kernel(
    const Consts<T> g, int n, int steps, int land_heat, const T* __restrict__ geom,
    const T* __restrict__ scal, const T* __restrict__ ocean_in,
    const T* __restrict__ init, int64_t init_s0, int64_t init_s1,
    const T* __restrict__ vec_in, T* __restrict__ ocean_out,
    T* __restrict__ vec_out, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  T* col = reinterpret_cast<T*>(smem_raw);  // [n][nt]
  SmemRows<T> cpr{col + (size_t)n * nt + tid, nt};  // [n-1][nt]
  const Setup<T> su = stage<T>(smem_raw, sizeof(T) * (size_t)nt * (2 * n - 1), n, geom, init,
                               init_s0, init_s1 == 0, nullptr, 0, false);

  const int h = tid & 1;
  const int64_t m = blockIdx.x * (int64_t)(nt >> 1) + (tid >> 1);
  if (m >= B) return;  // both threads of a pair leave together
  const Lane ln{n, nt, tid, h, 3u << (tid & 30)};

  T sc[S_ROWS];
#pragma unroll
  for (int r = 0; r < S_ROWS; ++r) sc[r] = scal[r * B + m];

  for (int i = 0; i < n; ++i) col[i * nt + tid] = ocean_in[(int64_t)(h * n + i) * B + m];
  T land = vec_in[(0 + h) * B + m];
  T ground = vec_in[(2 + h) * B + m];
  T hemi = vec_in[(4 + h) * B + m];
  T upw = vec_in[(6 + h) * B + m];
  const T aeff = vec_in[(8 + h) * B + m];
  const Prof<T> prof = prof_of(su.prof_s, init, init_s0, init_s1, h, n, m);
  const Hemi<T> c = hemi_consts(g, h);
  const Air<T> air = air_consts<T>(sc);
  const T w_thresh = h ? sc[S_W_THRESH_SH] : sc[S_W_THRESH_NH];

  for (int step = 0; step < steps; ++step) {
    // the month's fraction of the year, (step + 1) / steps, as the plain
    // version's host float m / steps rounded to T
    const T frac = T(step + 1) / T(steps);
    month<T, T, false>(g, c, su.geo, ln, sc, air, aeff, w_thresh, prof, frac, land_heat, col,
                       cpr, Tape<T>{}, land, ground, hemi, upw);
  }

  for (int i = 0; i < n; ++i) ocean_out[(int64_t)(h * n + i) * B + m] = col[i * nt + tid];
  vec_out[(0 + h) * B + m] = land;
  vec_out[(2 + h) * B + m] = ground;
  vec_out[(4 + h) * B + m] = hemi;
  vec_out[(6 + h) * B + m] = upw;
}

// The tangent-linear year: the forward on dual numbers.  The tangents are
// dense (rows, B) but t_init, which has strides of its own.  The dual c'
// lives in shared memory (SHARED: the layout of the fewest threads a block,
// whose sweeps wait on nothing, for a batch that one wave of it holds) or
// in cscratch, (n - 1) rows of 2B dual numbers read back through a ring
// (the layout of the most resident warps, for a larger batch).
template <typename T, bool SHARED>
__global__ void __launch_bounds__(MAX_THREADS, 1) udeb_year_jvp_kernel(
    const Consts<T> g, int n, int steps, int land_heat, const T* __restrict__ geom,
    const T* __restrict__ scal, const T* __restrict__ t_scal, const T* __restrict__ ocean_in,
    const T* __restrict__ t_ocean, const T* __restrict__ init, int64_t init_s0,
    int64_t init_s1, const T* __restrict__ t_init, int64_t t_init_s0, int64_t t_init_s1,
    const T* __restrict__ vec_in, const T* __restrict__ t_vec, T* __restrict__ t_ocean_out,
    T* __restrict__ t_vec_out, T* __restrict__ cscratch, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using D = Dual<T>;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  D* col = reinterpret_cast<D*>(smem_raw);  // [n][nt]
  D* rows = col + (size_t)n * nt;           // c' [n-1][nt], or the ring [RING][nt]
  const Setup<T> su = stage<T>(smem_raw, sizeof(D) * (size_t)nt * (SHARED ? 2 * n - 1 : n + RING),
                               n, geom, init, init_s0, init_s1 == 0, t_init, t_init_s0,
                               t_init_s1 == 0);

  const int h = tid & 1;
  const int64_t m = blockIdx.x * (int64_t)(nt >> 1) + (tid >> 1);
  if (m >= B) return;
  const Lane ln{n, nt, tid, h, 3u << (tid & 30)};
  auto cpr = [&] {
    if constexpr (SHARED) {
      return SmemRows<D>{rows + tid, nt};
    } else {
      return RingRows<D>{reinterpret_cast<D*>(cscratch) + 2 * m + h, 2 * B, rows + tid, nt, n};
    }
  }();

  D sc[S_ROWS];
#pragma unroll
  for (int r = 0; r < S_ROWS; ++r) sc[r] = D{scal[r * B + m], t_scal[r * B + m]};

  for (int i = 0; i < n; ++i) {
    const int64_t k = (int64_t)(h * n + i) * B + m;
    col[i * nt + tid] = D{ocean_in[k], t_ocean[k]};
  }
  auto vrow = [&](int r) { return D{vec_in[r * B + m], t_vec[r * B + m]}; };
  D land = vrow(0 + h), ground = vrow(2 + h), hemi = vrow(4 + h), upw = vrow(6 + h);
  const D aeff = vrow(8 + h);
  ProfDual<T> prof;
  prof.value = prof_of(su.prof_s, init, init_s0, init_s1, h, n, m);
  prof.tangent = prof_of<T>(su.rest, t_init, t_init_s0, t_init_s1, h, n, m);
  const Hemi<T> c = hemi_consts(g, h);
  const Air<D> air = air_consts<T>(sc);
  const D w_thresh = h ? sc[S_W_THRESH_SH] : sc[S_W_THRESH_NH];

  for (int step = 0; step < steps; ++step) {
    const T frac = T(step + 1) / T(steps);
    month<T, D, false>(g, c, su.geo, ln, sc, air, aeff, w_thresh, prof, frac, land_heat, col,
                       cpr, Tape<T>{}, land, ground, hemi, upw);
  }

  for (int i = 0; i < n; ++i) t_ocean_out[(int64_t)(h * n + i) * B + m] = col[i * nt + tid].t;
  t_vec_out[(0 + h) * B + m] = land.t;
  t_vec_out[(2 + h) * B + m] = ground.t;
  t_vec_out[(4 + h) * B + m] = hemi.t;
  t_vec_out[(6 + h) * B + m] = upw.t;
}

// The adjoint year.  tape holds the forward pass's tape, three planes (x,
// c', d') of (steps x n) rows of 2B values (Tape); state each month's
// starting scalars, (steps x V_ROWS) rows of 2B: the column's top and
// bottom values, land, ground, ground after the damping, upwelling.
enum StateRow { V_OCEAN0, V_OCEAN_LAST, V_LAND, V_GROUND, V_GROUND1, V_UPW, V_ROWS };

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 1) udeb_year_vjp_kernel(
    const Consts<T> g, int n, int steps, int land_heat, const T* __restrict__ geom,
    const T* __restrict__ scal, const T* __restrict__ ocean_in, const T* __restrict__ init,
    int64_t init_s0, int64_t init_s1, const T* __restrict__ vec_in,
    const T* __restrict__ g_ocean, const T* __restrict__ g_vec, T* __restrict__ gs_out,
    T* __restrict__ go_out, T* __restrict__ gi_out, T* __restrict__ gv_out,
    T* __restrict__ tape, T* __restrict__ state, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  T* bar = reinterpret_cast<T*>(smem_raw);  // [n][nt]: the column's cotangents
  T* pb = bar + (size_t)n * nt;             // [n][nt]: the profile's cotangents
  T* ring = pb + (size_t)n * nt;            // [3][RING][nt]: the tape's rows
  const Setup<T> su = stage<T>(smem_raw, sizeof(T) * (size_t)nt * (2 * n + 3 * RING), n, geom,
                               init, init_s0, init_s1 == 0, nullptr, 0, false);

  const int h = tid & 1;
  const int64_t m = blockIdx.x * (int64_t)(nt >> 1) + (tid >> 1);
  if (m >= B) return;
  const Lane ln{n, nt, tid, h, 3u << (tid & 30)};

  T sc[S_ROWS];
#pragma unroll
  for (int r = 0; r < S_ROWS; ++r) sc[r] = scal[r * B + m];
  T land = vec_in[(0 + h) * B + m];
  T ground = vec_in[(2 + h) * B + m];
  T hemi = vec_in[(4 + h) * B + m];
  T upw = vec_in[(6 + h) * B + m];
  const T aeff = vec_in[(8 + h) * B + m];
  const Prof<T> prof = prof_of(su.prof_s, init, init_s0, init_s1, h, n, m);
  const Hemi<T> c = hemi_consts(g, h);
  const Air<T> air = air_consts<T>(sc);
  const T w_thresh = h ? sc[S_W_THRESH_SH] : sc[S_W_THRESH_NH];
  const int64_t tw = 2 * B, me = 2 * m + h;
  const int64_t plane = (int64_t)steps * n * tw;
  auto tape_of = [&](int step) {
    T* x = tape + (int64_t)step * n * tw + me;
    return Tape<T>{x, x + plane, x + 2 * plane, tw};
  };
  auto slot = [&](int step, int r) -> T& { return state[((int64_t)step * V_ROWS + r) * tw + me]; };

  // the forward pass, writing the tape; its column and c' use the
  // cotangents' rows
  T* col = bar;
  SmemRows<T> cpr{pb + tid, nt};
  for (int i = 0; i < n; ++i) col[i * nt + tid] = ocean_in[(int64_t)(h * n + i) * B + m];
  for (int step = 0; step < steps; ++step) {
    slot(step, V_OCEAN0) = col[tid];
    slot(step, V_OCEAN_LAST) = col[(n - 1) * nt + tid];
    slot(step, V_LAND) = land;
    slot(step, V_GROUND) = ground;
    slot(step, V_UPW) = upw;
    const T frac = T(step + 1) / T(steps);
    month<T, T, true>(g, c, su.geo, ln, sc, air, aeff, w_thresh, prof, frac, land_heat, col,
                      cpr, tape_of(step), land, ground, hemi, upw);
    slot(step, V_GROUND1) = ground;  // the damping is the month's only change to it
  }

  // the outputs' cotangents
  for (int i = 0; i < n; ++i) {
    bar[i * nt + tid] = g_ocean[(int64_t)(h * n + i) * B + m];
    pb[i * nt + tid] = T(0);
  }
  T land_b = g_vec[(0 + h) * B + m];
  T ground_b = g_vec[(2 + h) * B + m];
  T hemi_b = g_vec[(4 + h) * B + m];
  T upw_b = g_vec[(6 + h) * B + m];
  ScalBar<T> sb;
#pragma unroll
  for (int r = 0; r < S_SHARED; ++r) sb.s[r] = T(0);
  sb.w_thresh = sb.aeff = sb.delta_max = T(0);

  // the months in reverse, each from its tape
  for (int step = steps - 1; step >= 0; --step) {
    TapeRing<T> tr{tape_of(step), ring + tid, nt};
    const T frac = T(step + 1) / T(steps);
    month_vjp<T>(g, c, su.geo, ln, sc, air, aeff, w_thresh, prof, frac, land_heat,
                 slot(step, V_OCEAN0), slot(step, V_OCEAN_LAST), slot(step, V_LAND),
                 slot(step, V_GROUND), slot(step, V_GROUND1), slot(step, V_UPW), tr, bar, pb,
                 land_b, ground_b, hemi_b, upw_b, sb);
  }
  // the SST -> air map's constants, once a year
  T* s = sb.s;
  const T dm = sb.delta_max;
  s[S_ADJ_ALPHA] += dm * air.t_star;
  T ts_bar = dm * air.alpha;
  const T gts_bar = dm * air.t_star;
  ts_bar = ts_bar + dm * (air.gamma * air.t_star);
  s[S_ADJ_GAMMA] += gts_bar * air.t_star;
  ts_bar = ts_bar + gts_bar * air.gamma;
  ts_bar = ts_bar - dm;
  const T nm_bar = ts_bar / (T(2.0) * air.gamma_safe);
  s[S_ADJ_ALPHA] += -nm_bar;
  if (air.nonzero) s[S_ADJ_GAMMA] += -(nm_bar * air.t_star) * T(2.0);

  // the pair's sums: each thread writes every other row
#pragma unroll
  for (int r = 0; r < S_SHARED; ++r) {
    const T total = s[r] + shfl(ln.pair, s[r]);
    if ((r & 1) == h) gs_out[r * B + m] = total;
  }
  gs_out[(S_W_THRESH_NH + h) * B + m] = sb.w_thresh;
  for (int i = 0; i < n; ++i) {
    go_out[(int64_t)(h * n + i) * B + m] = bar[i * nt + tid];
    gi_out[(int64_t)(h * n + i) * B + m] = pb[i * nt + tid];
  }
  gv_out[(0 + h) * B + m] = land_b;
  gv_out[(2 + h) * B + m] = ground_b;
  gv_out[(4 + h) * B + m] = hemi_b;
  gv_out[(6 + h) * B + m] = upw_b;
  gv_out[(8 + h) * B + m] = sb.aeff;
}

template <typename T, int K>
const void* kernel_fn() {
  if (K == K_JVP) return (const void*)udeb_year_jvp_kernel<T, false>;
  if (K == K_JVP_SHARED) return (const void*)udeb_year_jvp_kernel<T, true>;
  if (K == K_VJP) return (const void*)udeb_year_vjp_kernel<T>;
  return (const void*)udeb_year_kernel<T>;
}

struct Config {
  int device = -1, n = -1, threads = 0, blocks_per_sm = 0, sms = 0;
  size_t smem = 0;
};

// The block size (a multiple of 32 up to MAX_THREADS) with the most resident
// threads per SM at n layers, the smallest of equals.  Cached per (device, n)
// in a small ring for each kernel, so that models of a few layer counts on
// one card each search once.
template <typename T, int K>
cudaError_t config(int n, Config* out) {
  constexpr int CACHE = 8;
  static Config cache[CACHE];
  static int next = 0;
  static std::mutex lock;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  for (const Config& c : cache) {
    if (c.device == device && c.n == n) {
      *out = c;
      return cudaSuccess;
    }
  }
  if (n < 2 || n > max_layers<T, K>()) return cudaErrorInvalidValue;
  const void* fn = kernel_fn<T, K>();
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)MAX_BLOCK_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  Config best;
  for (int threads = MIN_THREADS; threads <= MAX_THREADS; threads *= 2) {
    const size_t smem = smem_bytes<T, K>(n, threads);
    if (smem > MAX_BLOCK_SMEM) break;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
    if (err != cudaSuccess) return err;
    if (blocks * threads > best.blocks_per_sm * best.threads) {
      best.threads = threads;
      best.blocks_per_sm = blocks;
      best.smem = smem;
    }
  }
  if (best.blocks_per_sm == 0) return cudaErrorInvalidConfiguration;
  err = cudaDeviceGetAttribute(&best.sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  best.device = device;
  best.n = n;
  cache[next] = best;
  next = (next + 1) % CACHE;
  *out = best;
  return cudaSuccess;
}

// The grid of a launch, or an error: the geometry's constants copied in.
template <typename T, int K>
int prepare(const T* consts, int n_consts, int n, int steps, Consts<T>* g, Config* c) {
  if (n_consts != G_NSCALAR || steps < 1) return (int)cudaErrorInvalidValue;
  memcpy(g, consts, sizeof(*g));
  return (int)config<T, K>(n, c);
}

inline unsigned grid_of(long long B, const Config& c) {
  const long long members_per_block = c.threads / 2;
  return (unsigned)((B + members_per_block - 1) / members_per_block);
}

// The derivative kernels' block for a batch of B: the configuration's,
// halved (down to one warp) while its grid would leave SMs without a block,
// so that a gradient's small batch spreads its warps over the SMs instead
// of sharing the pipelines of a few.
template <typename T, int K>
void spread(long long B, int n, Config* c) {
  while (c->threads > MIN_THREADS && (long long)grid_of(B, *c) < c->sms) {
    c->threads /= 2;
    c->smem = smem_bytes<T, K>(n, c->threads);
  }
}

template <typename T>
int launch(const T* consts, int n_consts, int n, int steps, int land_heat, const T* geom,
           const T* scal, const T* ocean, const T* init, long long init_s0, long long init_s1,
           const T* vec, T* ocean_out, T* vec_out, long long B, void* stream) {
  Consts<T> g;
  Config c;
  const int err = prepare<T, K_FORWARD>(consts, n_consts, n, steps, &g, &c);
  if (err != 0) return err;
  if (B <= 0) return 0;
  udeb_year_kernel<T><<<grid_of(B, c), c.threads, c.smem, (cudaStream_t)stream>>>(
      g, n, steps, land_heat, geom, scal, ocean, init, init_s0, init_s1, vec, ocean_out,
      vec_out, B);
  return (int)cudaGetLastError();
}

// The tangent kernel's layout for a launch of B members at n layers: its
// dual c' in shared memory (K_JVP_SHARED: the fewest resident warps, but
// sweeps that wait on no device-memory round trip) when n fits that layout
// and one wave of it, every SM holding as many blocks as it can, holds the
// whole batch, as at a gradient's batch; else in device memory through the
// ring (K_JVP: the forward's occupancy, and about its layer limit).
template <typename T>
cudaError_t jvp_kind(int n, long long B, int* kind) {
  *kind = K_JVP;
  if (n > max_layers<T, K_JVP_SHARED>()) return cudaSuccess;
  Config c;
  const cudaError_t err = config<T, K_JVP_SHARED>(n, &c);
  if (err != cudaSuccess) return err;
  if (B <= (long long)c.sms * c.blocks_per_sm * (c.threads / 2)) *kind = K_JVP_SHARED;
  return cudaSuccess;
}

// Values of the device scratch buffer a launch of B members needs, which
// the caller allocates (udeb_year_config_*): the ring layout's dual c',
// (n - 1) rows of 2B value/tangent pairs; the adjoint's tape, three planes
// (x, c', d') of steps x n rows of 2B, then its months' starting scalars,
// steps x V_ROWS rows of 2B.
inline long long scratch_len(int kind, int n, int steps, long long B) {
  if (kind == K_JVP) return (long long)(n - 1) * 2 * B * 2;
  if (kind == K_VJP) return (long long)steps * (3 * n + V_ROWS) * 2 * B;
  return 0;
}

template <typename T, int K>
int launch_jvp_as(const T* consts, int n_consts, int n, int steps, int land_heat, const T* geom,
                  const T* scal, const T* t_scal, const T* ocean, const T* t_ocean,
                  const T* init, long long init_s0, long long init_s1, const T* t_init,
                  long long t_init_s0, long long t_init_s1, const T* vec, const T* t_vec,
                  T* t_ocean_out, T* t_vec_out, T* cscratch, long long B, void* stream) {
  Consts<T> g;
  Config c;
  const int err = prepare<T, K>(consts, n_consts, n, steps, &g, &c);
  if (err != 0) return err;
  if (B <= 0) return 0;
  spread<T, K>(B, n, &c);
  udeb_year_jvp_kernel<T, K == K_JVP_SHARED><<<grid_of(B, c), c.threads, c.smem,
                                               (cudaStream_t)stream>>>(
      g, n, steps, land_heat, geom, scal, t_scal, ocean, t_ocean, init, init_s0, init_s1,
      t_init, t_init_s0, t_init_s1, vec, t_vec, t_ocean_out, t_vec_out, cscratch, B);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_jvp(const T* consts, int n_consts, int n, int steps, int land_heat, const T* geom,
               const T* scal, const T* t_scal, const T* ocean, const T* t_ocean, const T* init,
               long long init_s0, long long init_s1, const T* t_init, long long t_init_s0,
               long long t_init_s1, const T* vec, const T* t_vec, T* t_ocean_out,
               T* t_vec_out, T* scratch, long long scratch_n, long long B, void* stream) {
  int kind = K_JVP;
  const cudaError_t err = jvp_kind<T>(n, B, &kind);
  if (err != cudaSuccess) return (int)err;
  if (scratch_n < scratch_len(kind, n, steps, B)) return (int)cudaErrorInvalidValue;
  auto as = kind == K_JVP_SHARED ? launch_jvp_as<T, K_JVP_SHARED> : launch_jvp_as<T, K_JVP>;
  return as(consts, n_consts, n, steps, land_heat, geom, scal, t_scal, ocean, t_ocean, init,
            init_s0, init_s1, t_init, t_init_s0, t_init_s1, vec, t_vec, t_ocean_out, t_vec_out,
            scratch, B, stream);
}

template <typename T>
int launch_vjp(const T* consts, int n_consts, int n, int steps, int land_heat, const T* geom,
               const T* scal, const T* ocean, const T* init, long long init_s0,
               long long init_s1, const T* vec, const T* g_ocean, const T* g_vec, T* gs_out,
               T* go_out, T* gi_out, T* gv_out, T* scratch, long long scratch_n, long long B,
               void* stream) {
  Consts<T> g;
  Config c;
  const int err = prepare<T, K_VJP>(consts, n_consts, n, steps, &g, &c);
  if (err != 0) return err;
  if (scratch_n < scratch_len(K_VJP, n, steps, B)) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  T* tape = scratch;
  T* state = scratch + (long long)3 * steps * n * 2 * B;
  spread<T, K_VJP>(B, n, &c);
  udeb_year_vjp_kernel<T><<<grid_of(B, c), c.threads, c.smem, (cudaStream_t)stream>>>(
      g, n, steps, land_heat, geom, scal, ocean, init, init_s0, init_s1, vec, g_ocean, g_vec,
      gs_out, go_out, gi_out, gv_out, tape, state, B);
  return (int)cudaGetLastError();
}

template <typename T>
int query(int kind, int n, int steps, long long B, int* threads, int* blocks_per_sm,
          long long* smem, long long* scratch) {
  Config c;
  cudaError_t err = cudaSuccess;
  if (kind == K_JVP && B > 0) err = jvp_kind<T>(n, B, &kind);
  if (err != cudaSuccess) return (int)err;
  if (kind == K_JVP) {
    err = config<T, K_JVP>(n, &c);
  } else if (kind == K_JVP_SHARED) {
    err = config<T, K_JVP_SHARED>(n, &c);
  } else if (kind == K_VJP) {
    err = config<T, K_VJP>(n, &c);
  } else if (kind == K_FORWARD) {
    err = config<T, K_FORWARD>(n, &c);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  *threads = c.threads;
  *blocks_per_sm = c.blocks_per_sm;
  *smem = (long long)c.smem;
  *scratch = scratch_len(kind, n, steps, B > 0 ? B : 0);
  return 0;
}

}  // namespace

extern "C" int udeb_year_f32(const float* consts, int n_consts, int n, int steps, int land_heat,
                             const float* geom, const float* scal, const float* ocean,
                             const float* init, long long init_s0, long long init_s1,
                             const float* vec, float* ocean_out, float* vec_out, long long B,
                             void* stream) {
  return launch<float>(consts, n_consts, n, steps, land_heat, geom, scal, ocean, init, init_s0,
                       init_s1, vec, ocean_out, vec_out, B, stream);
}

extern "C" int udeb_year_f64(const double* consts, int n_consts, int n, int steps, int land_heat,
                             const double* geom, const double* scal, const double* ocean,
                             const double* init, long long init_s0, long long init_s1,
                             const double* vec, double* ocean_out, double* vec_out, long long B,
                             void* stream) {
  return launch<double>(consts, n_consts, n, steps, land_heat, geom, scal, ocean, init, init_s0,
                        init_s1, vec, ocean_out, vec_out, B, stream);
}

// The tangent kernel, in the layout jvp_kind picks; scratch holds the
// ring layout's dual c' (scratch_n values, from udeb_year_config_*).
extern "C" int udeb_year_jvp_f32(const float* consts, int n_consts, int n, int steps,
                                 int land_heat, const float* geom, const float* scal,
                                 const float* t_scal, const float* ocean, const float* t_ocean,
                                 const float* init, long long init_s0, long long init_s1,
                                 const float* t_init, long long t_init_s0, long long t_init_s1,
                                 const float* vec, const float* t_vec, float* t_ocean_out,
                                 float* t_vec_out, float* scratch, long long scratch_n,
                                 long long B, void* stream) {
  return launch_jvp<float>(consts, n_consts, n, steps, land_heat, geom, scal, t_scal, ocean,
                           t_ocean, init, init_s0, init_s1, t_init, t_init_s0, t_init_s1, vec,
                           t_vec, t_ocean_out, t_vec_out, scratch, scratch_n, B, stream);
}

extern "C" int udeb_year_jvp_f64(const double* consts, int n_consts, int n, int steps,
                                 int land_heat, const double* geom, const double* scal,
                                 const double* t_scal, const double* ocean,
                                 const double* t_ocean, const double* init, long long init_s0,
                                 long long init_s1, const double* t_init, long long t_init_s0,
                                 long long t_init_s1, const double* vec, const double* t_vec,
                                 double* t_ocean_out, double* t_vec_out, double* scratch,
                                 long long scratch_n, long long B, void* stream) {
  return launch_jvp<double>(consts, n_consts, n, steps, land_heat, geom, scal, t_scal, ocean,
                            t_ocean, init, init_s0, init_s1, t_init, t_init_s0, t_init_s1, vec,
                            t_vec, t_ocean_out, t_vec_out, scratch, scratch_n, B, stream);
}

// The adjoint kernel; scratch holds its tape (scratch_n values, from
// udeb_year_config_*).
extern "C" int udeb_year_vjp_f32(const float* consts, int n_consts, int n, int steps,
                                 int land_heat, const float* geom, const float* scal,
                                 const float* ocean, const float* init, long long init_s0,
                                 long long init_s1, const float* vec, const float* g_ocean,
                                 const float* g_vec, float* gs_out, float* go_out,
                                 float* gi_out, float* gv_out, float* scratch,
                                 long long scratch_n, long long B, void* stream) {
  return launch_vjp<float>(consts, n_consts, n, steps, land_heat, geom, scal, ocean, init,
                           init_s0, init_s1, vec, g_ocean, g_vec, gs_out, go_out, gi_out,
                           gv_out, scratch, scratch_n, B, stream);
}

extern "C" int udeb_year_vjp_f64(const double* consts, int n_consts, int n, int steps,
                                 int land_heat, const double* geom, const double* scal,
                                 const double* ocean, const double* init, long long init_s0,
                                 long long init_s1, const double* vec, const double* g_ocean,
                                 const double* g_vec, double* gs_out, double* go_out,
                                 double* gi_out, double* gv_out, double* scratch,
                                 long long scratch_n, long long B, void* stream) {
  return launch_vjp<double>(consts, n_consts, n, steps, land_heat, geom, scal, ocean, init,
                            init_s0, init_s1, vec, g_ocean, g_vec, gs_out, go_out, gi_out,
                            gv_out, scratch, scratch_n, B, stream);
}

// The launch configuration of a kernel (0 forward, 1 tangent, 2 adjoint)
// at n layers: threads per block, resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), shared bytes a block,
// and the values of device scratch a launch needs.  With B > 0 the
// tangent's is that of the layout a launch of B members takes (jvp_kind:
// no scratch when its c' stays in shared memory), and the scratch is that
// of a launch of B members and steps months; B = 0 gives the tangent's
// ring layout and no scratch.  The block is before spread halves it.
extern "C" int udeb_year_config_f32(int kind, int n, int steps, long long B, int* threads,
                                    int* blocks_per_sm, long long* smem, long long* scratch) {
  return query<float>(kind, n, steps, B, threads, blocks_per_sm, smem, scratch);
}

extern "C" int udeb_year_config_f64(int kind, int n, int steps, long long B, int* threads,
                                    int* blocks_per_sm, long long* smem, long long* scratch) {
  return query<double>(kind, n, steps, B, threads, blocks_per_sm, smem, scratch);
}

// The most layers each kernel takes in each dtype (see max_layers).
extern "C" int udeb_year_max_layers_f32() { return max_layers<float, K_FORWARD>(); }
extern "C" int udeb_year_max_layers_f64() { return max_layers<double, K_FORWARD>(); }
extern "C" int udeb_year_jvp_max_layers_f32() { return max_layers<float, K_JVP>(); }
extern "C" int udeb_year_jvp_max_layers_f64() { return max_layers<double, K_JVP>(); }
extern "C" int udeb_year_jvp_shared_max_layers_f32() { return max_layers<float, K_JVP_SHARED>(); }
extern "C" int udeb_year_jvp_shared_max_layers_f64() { return max_layers<double, K_JVP_SHARED>(); }
extern "C" int udeb_year_vjp_max_layers_f32() { return max_layers<float, K_VJP>(); }
extern "C" int udeb_year_vjp_max_layers_f64() { return max_layers<double, K_VJP>(); }
