// LAMCALC: per-member hybrid step/secant iteration on lambda_ocean, one
// thread per ensemble member; beside it the iteration's tangent-linear kernel
// (forward mode) and its adjoint (reverse mode).
//
// lamcalc_kernel replaces the Pallas TPU kernel
// rscm_tpu/ops/lamcalc_kernel.py::lamcalc_scalars (pallas_call at
// lamcalc_kernel.py:252, body _iteration at :59-185).  The plain PyTorch
// version beside its wrapper (rscm_tpu_torch/ops/lamcalc_kernel.py,
// lamcalc_plain) performs the same operations in the same order with a fixed
// count of 39 steps; here each thread stops once its member has converged,
// which gives the same result because converged members are frozen.
//
// lamcalc_jvp_kernel and lamcalc_vjp_kernel replace the JAX package's
// derivative rule, which is not a pallas_call: custom_jvp differentiates the
// fixed-count jnp loop (_jvp differentiates _ref_jnp,
// rscm_tpu/ops/lamcalc_kernel.py:317-322).  Both differentiate the iteration
// as that loop unrolls it, through the iterate each member converged at, not
// the implicit-function derivative at the converged point; a member that
// takes the fallback gets zero.
// - The tangent kernel runs the iteration below on dual numbers (value,
//   tangent); convergence, the freeze and every branch decide on the value.
// - The adjoint kernel replays the iteration with the same code, taping each
//   iterate, its ratio and y = M^-1 v in local memory and its update's
//   branch in 2 bits of a register, then reverses the active iterations: the
//   update (step or secant), the ratio and the temperatures t = q y, whose
//   matrix cotangent is -(M^-T y_bar) y^T, with M^-T y_bar solved through M's
//   sparsity (Sparse) and not the cofactors.  y is taped, not solved again:
//   at a pole of the warming ratio the ocean mean cancels, and only the
//   forward's own y gives the forward's ratio back.  Its plain version,
//   lamcalc_vjp_plain, performs the same operations in the same order.
//
// Layout: member-minor, input (6, B) = ecs, q, k_lo, k_ns, rlo, alpha;
// output (3, B) = lam_o, lam_l, efficacy (the tangent kernel: its tangent;
// the adjoint: the input's cotangent (6, B) from the output's (3, B)).
//
// Bound on an H100: arithmetic (~350 floating-point operations an iteration,
// 6-7 iterations a typical member, against 72 bytes a member in float64; the
// tangent kernel ~2.6x that, the adjoint ~1.7x where the function needs ~1.4x,
// one forward and the adjoint: the replay and the reverse pass's ratio and
// solve for u are the kernel's own).  At a gradient's batch (1-512 members) a
// launch is one member's serial iterations: latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxIterations = 40;
// the iterations a member runs at most (the fixed-count loop's steps)
constexpr int kIterations = kMaxIterations - 1;
constexpr int kThreads = 128;

// Constants, in the order of _consts in ops/lamcalc_kernel.py.
enum Const {
  C_FGNO, C_FGNL, C_FGSO, C_FGSL, C_V0, C_V1, C_V2, C_V3, C_FRATIO,
  C_INV_FGOSUM, C_INV_FGLSUM, C_FB_LAM_O, C_FB_LAM_L, C_FB_EFF, C_COUNT
};

// Input rows.
enum Row { R_ECS, R_Q, R_K_LO, R_K_NS, R_RLO, R_ALPHA, R_COUNT };

template <typename T>
struct Consts {
  T c[C_COUNT];
};

// Dual numbers for the tangent kernel; each tangent is PyTorch's
// forward-mode rule (mul a_t * b + a * b_t, div (a_t - b_t * (a / b)) / b,
// reciprocal -b_t (r r)).
template <typename T>
struct Dual {
  T v, t;
};
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) { return {a.v + b.v, a.t + b.t}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, T b) { return {a.v + b, a.t}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) { return {a.v - b.v, a.t - b.t}; }
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
// a / b with a host constant a, as PyTorch takes it: reciprocal(b) * a.
template <typename T>
__device__ __forceinline__ Dual<T> operator/(T a, Dual<T> b) {
  const T r = T(1) / b.v;
  return {a / b.v, -(b.t * (r * r)) * a};
}

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ double val(double x) { return x; }
template <typename T>
__device__ __forceinline__ T val(Dual<T> x) { return x.v; }

__device__ __forceinline__ float tabs(float x) { return fabsf(x); }
__device__ __forceinline__ double tabs(double x) { return fabs(x); }

// The temperatures t = q M^-1 v of the 4x4 coupling matrix M, by cofactors,
// and y = M^-1 v (the forward's iteration; the adjoint's replay).
template <typename T, typename V>
__device__ __forceinline__ void temps_from(const Consts<T>& k, V q, V k_lo, V k_ns, V alpha,
                                           V lam_o, V lam_l, V (&y)[4], V (&t)[4]) {
  const V a_diag = k_lo * alpha + k_ns;
  const V z{T(0)};
  const V m[4][4] = {
      {k.c[C_FGNO] * lam_o + a_diag, -k_lo, -k_ns, z},
      {-k_lo * alpha, k.c[C_FGNL] * lam_l + k_lo, z, z},
      {-k_ns, z, k.c[C_FGSO] * lam_o + a_diag, -k_lo},
      {z, z, -k_lo * alpha, k.c[C_FGSL] * lam_l + k_lo},
  };
  auto det3 = [&](int r0, int r1, int r2, int c0, int c1, int c2) -> V {
    return m[r0][c0] * (m[r1][c1] * m[r2][c2] - m[r1][c2] * m[r2][c1]) -
           m[r0][c1] * (m[r1][c0] * m[r2][c2] - m[r1][c2] * m[r2][c0]) +
           m[r0][c2] * (m[r1][c0] * m[r2][c1] - m[r1][c1] * m[r2][c0]);
  };
  const int others[4][3] = {{1, 2, 3}, {0, 2, 3}, {0, 1, 3}, {0, 1, 2}};
  V cof[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const V d = det3(others[i][0], others[i][1], others[i][2], others[j][0], others[j][1],
                       others[j][2]);
      cof[i][j] = ((i + j) % 2 == 0) ? d : -d;
    }
  V det{T(0)};
#pragma unroll
  for (int j = 0; j < 4; ++j) det = det + m[0][j] * cof[0][j];
  const V inv_det = T(1) / det;
  const T v[4] = {k.c[C_V0], k.c[C_V1], k.c[C_V2], k.c[C_V3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    V s{T(0)};
#pragma unroll
    for (int j = 0; j < 4; ++j) s = s + (cof[j][i] * inv_det) * v[j];
    y[i] = s;
    t[i] = q * s;
  }
}

// M^T by M's sparsity, for the adjoint's reverse pass: with b = k_lo alpha,
//   M = [[a0, -k_lo, -k_ns, 0], [-b, a1, 0, 0], [-k_ns, 0, a2, -k_lo], [0, 0, -b, a3]],
// rows 1 and 3 of M^T u = w each tie one unknown to u0 or u2 (u1 = (w1 +
// k_lo u0) / a1, u3 = (w3 + k_lo u2) / a3); eliminating them leaves a 2x2
// system whose determinant, times a1 a3, is d = (a0 a1 - k_lo b)(a2 a3 - k_lo b)
// - k_ns^2 a1 a3.  One division, 1 / (a1 a3 d), gives 1 / d, 1 / a1 and
// 1 / a3, so a solve is 17 operations on w, against the cofactors' ~290.
// The same operations in the same order as _Sparse in ops/lamcalc_kernel.py.
template <typename T>
struct Sparse {
  T k_lo, b, a1, a3, r1, r3, c00, c02, c20, c22;

  __device__ __forceinline__ Sparse(const Consts<T>& k, T k_lo_, T k_ns, T alpha, T lam_o,
                                    T lam_l)
      : k_lo(k_lo_) {
    b = k_lo * alpha;
    const T a_diag = b + k_ns;
    const T a0 = k.c[C_FGNO] * lam_o + a_diag;
    a1 = k.c[C_FGNL] * lam_l + k_lo;
    const T a2 = k.c[C_FGSO] * lam_o + a_diag;
    a3 = k.c[C_FGSL] * lam_l + k_lo;
    const T kb = k_lo * b;
    const T p = a0 * a1 - kb;
    const T s = a2 * a3 - kb;
    const T a13 = a1 * a3;
    const T d = p * s - (k_ns * k_ns) * a13;
    const T rd = T(1) / (a13 * d);
    const T inv_d = a13 * rd;
    r1 = (a3 * d) * rd;
    r3 = (a1 * d) * rd;
    c00 = s * inv_d;
    c02 = (k_ns * a1) * inv_d;
    c20 = (k_ns * a3) * inv_d;
    c22 = p * inv_d;
  }

  // u = M^-T w
  __device__ __forceinline__ void solve_transposed(const T (&w)[4], T (&u)[4]) const {
    const T h0 = a1 * w[0] + b * w[1];
    const T h2 = a3 * w[2] + b * w[3];
    u[0] = c00 * h0 + c02 * h2;
    u[2] = c20 * h0 + c22 * h2;
    u[1] = (w[1] + k_lo * u[0]) * r1;
    u[3] = (w[3] + k_lo * u[2]) * r3;
  }
};

// The adjoint's tape of its replay, in the thread's local memory: each
// iteration's iterate, ratio and y = M^-1 v, and each update's branch code in
// 2 bits of two registers.
template <typename T>
struct IterTape {
  T lamo[kIterations], diff[kIterations], ys[4 * kIterations];
  uint64_t codes_lo = 0, codes_hi = 0;  // iterations 0-31, 32-38

  __device__ __forceinline__ void record(int it, T lamo_i, T diff_i, unsigned code,
                                         const T (&y)[4]) {
    lamo[it] = lamo_i;
    diff[it] = diff_i;
#pragma unroll
    for (int c = 0; c < 4; ++c) ys[4 * it + c] = y[c];
    const uint64_t c = (uint64_t)code << (2 * (it & 31));
    if (it < 32) codes_lo |= c; else codes_hi |= c;
  }
  __device__ __forceinline__ unsigned code(int it) const {
    return (unsigned)(((it < 32) ? codes_lo : codes_hi) >> (2 * (it & 31))) & 3u;
  }
};

// One member's iteration, on values (V = T) or dual numbers; with a tape
// (the adjoint's replay) each iteration's iterate, ratio and update branch
// (0 step, 1 and 2 the secants through the previous and the one before, 3 a
// secant whose denominator vanished) are kept.  Returns whether the member
// converged and, in *converged_at, the iteration it did.
template <typename T, typename V>
__device__ __forceinline__ bool iterate(const Consts<T>& k, const V (&x)[R_COUNT], V& best_lam_o,
                                        V& best_lam_l, V& best_eff,
                                        IterTape<T>* tape = nullptr,
                                        int* converged_at = nullptr) {
  const V ecs = x[R_ECS], q = x[R_Q], k_lo = x[R_K_LO];
  const V k_ns = x[R_K_NS], rlo = x[R_RLO], alpha = x[R_ALPHA];
  const V lam = q / ecs;
  const V zeros = lam * T(0.0);
  V lamo_im2 = lam + T(0.0), lamo_im1 = lam + T(0.0), lamo_i = lam + T(0.7);
  V diff_im2 = zeros, diff_im1 = zeros;
  V dlamo = zeros + T(0.7);
  int iflag = 0;
  bool found = false;
  best_lam_o = zeros;
  best_lam_l = zeros;
  best_eff = zeros;

  for (int it = 0; it < kIterations && !found; ++it) {
    const V lam_l = lam + k.c[C_FRATIO] * (lam - lamo_i) / rlo;
    V y[4], t[4];
    temps_from(k, q, k_lo, k_ns, alpha, lamo_i, lam_l, y, t);
    const V ocean_mean = (k.c[C_FGNO] * t[0] + k.c[C_FGSO] * t[2]) * k.c[C_INV_FGOSUM];
    const V land_mean = (k.c[C_FGNL] * t[1] + k.c[C_FGSL] * t[3]) * k.c[C_INV_FGLSUM];
    const V diff_i = rlo - land_mean / ocean_mean;
    const V t_global =
        k.c[C_FGNO] * t[0] + k.c[C_FGNL] * t[1] + k.c[C_FGSO] * t[2] + k.c[C_FGSL] * t[3];
    const V eff_i = t_global / ecs;

    if (tabs(val(diff_i)) < T(0.001)) {  // converged now (found is false here)
      best_lam_o = lamo_i;
      best_lam_l = lam_l;
      best_eff = eff_i;
      found = true;
      if (converged_at) *converged_at = it;
    }
    const bool sign_change = val(diff_i) * val(diff_im1) < T(0.0);
    if (sign_change) iflag = 1;
    const V dlamo_step = (tabs(val(diff_i)) > tabs(val(diff_im1))) ? -dlamo : dlamo;
    const V next_step = lamo_i + dlamo_step;
    auto secant = [&](V lamo_back, V diff_back, bool& small) -> V {
      const V denom = diff_i - diff_back;
      small = tabs(val(denom)) < T(1e-30);
      return small ? lamo_i + dlamo
                   : lamo_i - diff_i * (lamo_i - lamo_back) / (small ? V{T(1)} : denom);
    };
    bool small1, small2;
    const V secant1 = secant(lamo_im1, diff_im1, small1);
    const V secant2 = secant(lamo_im2, diff_im2, small2);
    V lamo_next = (iflag == 0) ? next_step : (sign_change ? secant1 : secant2);
    if constexpr (sizeof(V) == sizeof(T)) {
      if (tape) {
        tape->record(it, lamo_i, diff_i,
                     iflag == 0 ? 0u
                                : ((sign_change ? small1 : small2) ? 3u : (sign_change ? 1u : 2u)),
                     y);
      }
    }
    if (iflag == 0) dlamo = dlamo_step;
    if (found) lamo_next = lamo_i;
    lamo_im2 = lamo_im1;
    lamo_im1 = lamo_i;
    lamo_i = lamo_next;
    diff_im2 = diff_im1;
    diff_im1 = diff_i;
  }
  return found;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) lamcalc_kernel(
    const Consts<T> k, int rf_sum_zero, const T* __restrict__ in, T* __restrict__ out,
    int64_t B) {
  const int64_t m = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (m >= B) return;
  T x[R_COUNT];
#pragma unroll
  for (int r = 0; r < R_COUNT; ++r) x[r] = in[r * B + m];
  T best_lam_o, best_lam_l, best_eff;
  const bool found = iterate<T, T>(k, x, best_lam_o, best_lam_l, best_eff);
  const T eff = rf_sum_zero ? T(1) : best_eff;
  out[0 * B + m] = found ? best_lam_o : k.c[C_FB_LAM_O];
  out[1 * B + m] = found ? best_lam_l : k.c[C_FB_LAM_L];
  out[2 * B + m] = found ? eff : k.c[C_FB_EFF];
}

template <typename T>
__global__ void __launch_bounds__(kThreads) lamcalc_jvp_kernel(
    const Consts<T> k, int rf_sum_zero, const T* __restrict__ in, const T* __restrict__ t_in,
    T* __restrict__ t_out, int64_t B) {
  const int64_t m = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (m >= B) return;
  using D = Dual<T>;
  D x[R_COUNT];
#pragma unroll
  for (int r = 0; r < R_COUNT; ++r) x[r] = D{in[r * B + m], t_in[r * B + m]};
  D best_lam_o, best_lam_l, best_eff;
  const bool found = iterate<T, D>(k, x, best_lam_o, best_lam_l, best_eff);
  t_out[0 * B + m] = found ? best_lam_o.t : T(0);
  t_out[1 * B + m] = found ? best_lam_l.t : T(0);
  t_out[2 * B + m] = (found && !rf_sum_zero) ? best_eff.t : T(0);
}

// The adjoint (the twin of lamcalc_vjp_plain in ops/lamcalc_kernel.py, the
// same operations in the same order).  The replay is the forward's own
// iteration with a tape; the reverse pass holds the cotangents of
// iterations j + 1, j, j - 1 and j - 2 (all an update reaches) and the
// tape's iterates and ratios at j, j - 1 and j - 2 in registers, shifting
// them down an iteration a step, reverses the temperatures through M's
// sparsity, and divides by rlo, ecs, the ocean mean and a secant's
// denominator once, multiplying by the reciprocal after.
template <typename T>
__global__ void __launch_bounds__(kThreads) lamcalc_vjp_kernel(
    const Consts<T> k, int rf_sum_zero, const T* __restrict__ in, const T* __restrict__ g_out,
    T* __restrict__ g_in, int64_t B) {
  const int64_t m = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (m >= B) return;
  T x[R_COUNT];
#pragma unroll
  for (int r = 0; r < R_COUNT; ++r) x[r] = in[r * B + m];
  IterTape<T> tape;
  int kstar = 0;
  T best_lam_o, best_lam_l, best_eff;
  const bool found = iterate<T, T>(k, x, best_lam_o, best_lam_l, best_eff, &tape, &kstar);
  T bar[R_COUNT];
#pragma unroll
  for (int r = 0; r < R_COUNT; ++r) bar[r] = T(0);
  if (found) {
    const T ecs = x[R_ECS], q = x[R_Q], k_lo = x[R_K_LO];
    const T k_ns = x[R_K_NS], rlo = x[R_RLO], alpha = x[R_ALPHA];
    const T fgno = k.c[C_FGNO], fgnl = k.c[C_FGNL], fgso = k.c[C_FGSO], fgsl = k.c[C_FGSL];
    const T fg[4] = {fgno, fgnl, fgso, fgsl};
    const T lam = q / ecs;
    const T inv_rlo = T(1) / rlo, inv_ecs = T(1) / ecs;
    T lam_bar = T(0);
    // lamo's cotangent at j + 1, j, j - 1, j - 2; the ratio's at j, j - 1, j - 2
    T lb_next = T(0), lb0 = T(0), lb1 = T(0), lb2 = T(0);
    T db0 = T(0), db1 = T(0), db2 = T(0);
    auto lamo_at = [&](int j) { return j >= 0 ? tape.lamo[j] : T(0); };
    auto diff_at = [&](int j) { return j >= 0 ? tape.diff[j] : T(0); };
    T lo0 = lamo_at(kstar), lo1 = lamo_at(kstar - 1), lo2 = lamo_at(kstar - 2);
    T df0 = diff_at(kstar), df1 = diff_at(kstar - 1), df2 = diff_at(kstar - 2);
    for (int j = kstar; j >= 0; --j) {
      const T lamo_i = lo0, diff_i = df0;
      if (j < kstar) {
        // the update that made lamo_{j+1}: each branch adds lamo_i once
        const T big_l = lb_next;
        lb0 = lb0 + big_l;
        const unsigned code = tape.code(j);
        if (code == 1u || code == 2u) {
          const bool one = code == 1u;
          const T inv_den = T(1) / (diff_i - (one ? df1 : df2));
          const T r = lamo_i - (one ? lo1 : lo2);
          const T qv = (diff_i * r) * inv_den;
          const T p_bar = -big_l * inv_den;
          const T den_bar = -(p_bar * qv);
          db0 = db0 + p_bar * r;
          const T r_bar = p_bar * diff_i;
          lb0 = lb0 + r_bar;
          if (one) lb1 = lb1 - r_bar; else lb2 = lb2 - r_bar;
          db0 = db0 + den_bar;
          if (one) db1 = db1 - den_bar; else db2 = db2 - den_bar;
        }
      }
      // the iteration's ratio, efficacy and land feedback
      const T w = k.c[C_FRATIO] * (lam - lamo_i);
      const T wr = w / rlo;  // the forward's own quotient
      const Sparse<T> sp(k, k_lo, k_ns, alpha, lamo_i, lam + wr);
      const T* y = &tape.ys[4 * j];
      T t[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) t[c] = q * y[c];
      T ll_bar = T(0), t_bar[4] = {T(0), T(0), T(0), T(0)};
      if (j == kstar) {  // the output's cotangent enters at the iterate the member kept
        lb0 = lb0 + g_out[0 * B + m];
        ll_bar = g_out[1 * B + m];
        if (!rf_sum_zero) {
          const T tg = fgno * t[0] + fgnl * t[1] + fgso * t[2] + fgsl * t[3];
          const T tg_bar = g_out[2 * B + m] * inv_ecs;
          bar[R_ECS] += -(tg_bar * (tg * inv_ecs));
#pragma unroll
          for (int c = 0; c < 4; ++c) t_bar[c] = tg_bar * fg[c];
        }
      }
      const T om = (fgno * t[0] + fgso * t[2]) * k.c[C_INV_FGOSUM];
      const T lm = (fgnl * t[1] + fgsl * t[3]) * k.c[C_INV_FGLSUM];
      const T inv_om = T(1) / om;
      const T db = db0;
      bar[R_RLO] += db;
      const T lm_bar = -db * inv_om;
      const T om_bar = -(lm_bar * (lm * inv_om));
      const T s_l = lm_bar * k.c[C_INV_FGLSUM];
      t_bar[1] = t_bar[1] + s_l * fgnl;
      t_bar[3] = t_bar[3] + s_l * fgsl;
      const T s_o = om_bar * k.c[C_INV_FGOSUM];
      t_bar[0] = t_bar[0] + s_o * fgno;
      t_bar[2] = t_bar[2] + s_o * fgso;
      bar[R_Q] += ((t_bar[0] * y[0] + t_bar[1] * y[1]) + t_bar[2] * y[2]) + t_bar[3] * y[3];
      T yb[4], u[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) yb[c] = t_bar[c] * q;
      sp.solve_transposed(yb, u);
      // M's cotangent -(u y^T) at its non-zero entries
      auto m_bar = [&](int a, int b) -> T { return -(u[a] * y[b]); };
      lb0 = lb0 + m_bar(0, 0) * fgno;
      T ad_bar = m_bar(0, 0);
      bar[R_K_LO] += -m_bar(0, 1);
      bar[R_K_NS] += -m_bar(0, 2);
      bar[R_K_LO] += -(m_bar(1, 0) * alpha);
      bar[R_ALPHA] += -(m_bar(1, 0) * k_lo);
      ll_bar = ll_bar + m_bar(1, 1) * fgnl;
      bar[R_K_LO] += m_bar(1, 1);
      bar[R_K_NS] += -m_bar(2, 0);
      lb0 = lb0 + m_bar(2, 2) * fgso;
      ad_bar = ad_bar + m_bar(2, 2);
      bar[R_K_LO] += -m_bar(2, 3);
      bar[R_K_LO] += -(m_bar(3, 2) * alpha);
      bar[R_ALPHA] += -(m_bar(3, 2) * k_lo);
      ll_bar = ll_bar + m_bar(3, 3) * fgsl;
      bar[R_K_LO] += m_bar(3, 3);
      bar[R_K_LO] += ad_bar * alpha;
      bar[R_ALPHA] += ad_bar * k_lo;
      bar[R_K_NS] += ad_bar;
      // lam_l = lam + w / rlo, w = fratio * (lam - lamo_i)
      lam_bar = lam_bar + ll_bar;
      const T w_bar = ll_bar * inv_rlo;
      bar[R_RLO] += -(w_bar * wr);
      const T dl_bar = w_bar * k.c[C_FRATIO];
      lam_bar = lam_bar + dl_bar;
      lb0 = lb0 - dl_bar;
      // down one iteration
      lb_next = lb0;
      lb0 = lb1;
      lb1 = lb2;
      lb2 = T(0);
      db0 = db1;
      db1 = db2;
      db2 = T(0);
      lo0 = lo1;
      lo1 = lo2;
      lo2 = lamo_at(j - 3);
      df0 = df1;
      df1 = df2;
      df2 = diff_at(j - 3);
    }
    lam_bar = lam_bar + lb_next;
    const T lam_q = lam_bar * inv_ecs;
    bar[R_Q] += lam_q;
    bar[R_ECS] += -(lam_q * lam);
  }
#pragma unroll
  for (int r = 0; r < R_COUNT; ++r) g_in[r * B + m] = bar[r];
}

template <typename T>
int prepare(const T* consts, int n_consts, Consts<T>* k) {
  if (n_consts != C_COUNT) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < C_COUNT; ++i) k->c[i] = consts[i];
  return 0;
}

inline unsigned blocks_of(long long B) { return (unsigned)((B + kThreads - 1) / kThreads); }

template <typename T>
int launch(const T* consts, int n_consts, int rf_sum_zero, const T* in, T* out, long long B,
           void* stream) {
  Consts<T> k;
  if (prepare(consts, n_consts, &k) != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  lamcalc_kernel<T><<<blocks_of(B), kThreads, 0, (cudaStream_t)stream>>>(k, rf_sum_zero, in,
                                                                         out, B);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_jvp(const T* consts, int n_consts, int rf_sum_zero, const T* in, const T* t_in,
               T* t_out, long long B, void* stream) {
  Consts<T> k;
  if (prepare(consts, n_consts, &k) != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  lamcalc_jvp_kernel<T><<<blocks_of(B), kThreads, 0, (cudaStream_t)stream>>>(
      k, rf_sum_zero, in, t_in, t_out, B);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vjp(const T* consts, int n_consts, int rf_sum_zero, const T* in, const T* g_out,
               T* g_in, long long B, void* stream) {
  Consts<T> k;
  if (prepare(consts, n_consts, &k) != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  lamcalc_vjp_kernel<T><<<blocks_of(B), kThreads, 0, (cudaStream_t)stream>>>(
      k, rf_sum_zero, in, g_out, g_in, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lamcalc_f32(const float* consts, int n_consts, int rf_sum_zero, const float* in,
                           float* out, long long B, void* stream) {
  return launch<float>(consts, n_consts, rf_sum_zero, in, out, B, stream);
}

extern "C" int lamcalc_f64(const double* consts, int n_consts, int rf_sum_zero,
                           const double* in, double* out, long long B, void* stream) {
  return launch<double>(consts, n_consts, rf_sum_zero, in, out, B, stream);
}

extern "C" int lamcalc_jvp_f32(const float* consts, int n_consts, int rf_sum_zero,
                               const float* in, const float* t_in, float* t_out, long long B,
                               void* stream) {
  return launch_jvp<float>(consts, n_consts, rf_sum_zero, in, t_in, t_out, B, stream);
}

extern "C" int lamcalc_jvp_f64(const double* consts, int n_consts, int rf_sum_zero,
                               const double* in, const double* t_in, double* t_out, long long B,
                               void* stream) {
  return launch_jvp<double>(consts, n_consts, rf_sum_zero, in, t_in, t_out, B, stream);
}

extern "C" int lamcalc_vjp_f32(const float* consts, int n_consts, int rf_sum_zero,
                               const float* in, const float* g_out, float* g_in, long long B,
                               void* stream) {
  return launch_vjp<float>(consts, n_consts, rf_sum_zero, in, g_out, g_in, B, stream);
}

extern "C" int lamcalc_vjp_f64(const double* consts, int n_consts, int rf_sum_zero,
                               const double* in, const double* g_out, double* g_in, long long B,
                               void* stream) {
  return launch_vjp<double>(consts, n_consts, rf_sum_zero, in, g_out, g_in, B, stream);
}
