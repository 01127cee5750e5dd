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
// - The adjoint kernel replays the iteration with the same code, keeping each
//   iterate, its ratio and its update's branch in local memory, then reverses
//   the active iterations: the update (step or secant), the ratio and the
//   temperatures t = q M^-1 v, whose matrix cotangent is -(M^-T y_bar) y^T.
//   Its plain version, lamcalc_vjp_plain, performs the same operations in
//   the same order.
//
// Layout: member-minor, input (6, B) = ecs, q, k_lo, k_ns, rlo, alpha;
// output (3, B) = lam_o, lam_l, efficacy (the tangent kernel: its tangent;
// the adjoint: the input's cotangent (6, B) from the output's (3, B)).
//
// Bound on an H100: arithmetic (~350 floating-point operations an iteration,
// 6-7 iterations a typical member, against 72 bytes a member in float64; the
// tangent kernel ~2.6x that, the adjoint ~2.4x where the function needs ~1.4x,
// one forward and the adjoint).  At a gradient's batch (1-512
// members) a launch is one member's serial iterations: latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxIterations = 40;

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

// The temperatures t = q M^-1 v of the 4x4 coupling matrix M, by cofactors;
// y = M^-1 v, the cofactors and 1 / det M go to the adjoint.
template <typename T, typename V>
struct Temps {
  V t[4], y[4], cof[4][4], inv_det;
};

template <typename T, typename V>
__device__ __forceinline__ void temps_from(const Consts<T>& k, V q, V k_lo, V k_ns, V alpha,
                                           V lam_o, V lam_l, Temps<T, V>& out) {
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
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const V d = det3(others[i][0], others[i][1], others[i][2], others[j][0], others[j][1],
                       others[j][2]);
      out.cof[i][j] = ((i + j) % 2 == 0) ? d : -d;
    }
  V det{T(0)};
#pragma unroll
  for (int j = 0; j < 4; ++j) det = det + m[0][j] * out.cof[0][j];
  out.inv_det = T(1) / det;
  const T v[4] = {k.c[C_V0], k.c[C_V1], k.c[C_V2], k.c[C_V3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    V s{T(0)};
#pragma unroll
    for (int j = 0; j < 4; ++j) s = s + (out.cof[j][i] * out.inv_det) * v[j];
    out.y[i] = s;
    out.t[i] = q * s;
  }
}

// One member's iteration, on values (V = T) or dual numbers; with a tape
// (the adjoint's replay) each iteration's iterate, ratio and update branch
// (0 step, 1 and 2 the secants through the previous and the one before, 3 a
// secant whose denominator vanished) are kept.  Returns whether the member
// converged and, in *converged_at, the iteration it did.
template <typename T, typename V>
__device__ __forceinline__ bool iterate(const Consts<T>& k, const V (&x)[R_COUNT], V& best_lam_o,
                                        V& best_lam_l, V& best_eff, T* tape_lamo = nullptr,
                                        T* tape_diff = nullptr, int* tape_code = nullptr,
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

  for (int it = 0; it < kMaxIterations - 1 && !found; ++it) {
    const V lam_l = lam + k.c[C_FRATIO] * (lam - lamo_i) / rlo;
    Temps<T, V> tm;
    temps_from(k, q, k_lo, k_ns, alpha, lamo_i, lam_l, tm);
    const V* t = tm.t;
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
    if (tape_lamo) {
      if constexpr (sizeof(V) == sizeof(T)) {
        tape_lamo[it] = lamo_i;
        tape_diff[it] = diff_i;
        tape_code[it] = iflag == 0 ? 0 : ((sign_change ? small1 : small2) ? 3 : (sign_change ? 1 : 2));
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
__global__ void __launch_bounds__(128) lamcalc_kernel(
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
__global__ void __launch_bounds__(128) lamcalc_jvp_kernel(
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
// same operations in the same order).
template <typename T>
__global__ void __launch_bounds__(128) lamcalc_vjp_kernel(
    const Consts<T> k, int rf_sum_zero, const T* __restrict__ in, const T* __restrict__ g_out,
    T* __restrict__ g_in, int64_t B) {
  const int64_t m = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (m >= B) return;
  T x[R_COUNT];
#pragma unroll
  for (int r = 0; r < R_COUNT; ++r) x[r] = in[r * B + m];
  T lamo[kMaxIterations], diff[kMaxIterations];
  int code[kMaxIterations];
  int kstar = 0;
  T best_lam_o, best_lam_l, best_eff;
  const bool found = iterate<T, T>(k, x, best_lam_o, best_lam_l, best_eff, lamo, diff, code,
                                   &kstar);
  T bar[R_COUNT];
#pragma unroll
  for (int r = 0; r < R_COUNT; ++r) bar[r] = T(0);
  if (found) {
    const T ecs = x[R_ECS], q = x[R_Q], k_lo = x[R_K_LO];
    const T k_ns = x[R_K_NS], rlo = x[R_RLO], alpha = x[R_ALPHA];
    const T fgno = k.c[C_FGNO], fgnl = k.c[C_FGNL], fgso = k.c[C_FGSO], fgsl = k.c[C_FGSL];
    const T fg[4] = {fgno, fgnl, fgso, fgsl};
    const T lam = q / ecs;
    T lam_bar = T(0);
    T lamo_bar[kMaxIterations], diff_bar[kMaxIterations];
    for (int j = 0; j <= kstar; ++j) lamo_bar[j] = diff_bar[j] = T(0);
    for (int j = kstar; j >= 0; --j) {
      const T lamo_i = lamo[j], diff_i = diff[j];
      if (j < kstar) {
        // the update that made lamo_{j+1}: each branch adds lamo_i once
        const T big_l = lamo_bar[j + 1];
        lamo_bar[j] = lamo_bar[j] + big_l;
        if (code[j] == 1 || code[j] == 2) {
          const int back = j - code[j];
          const T den = diff_i - diff[back];
          const T r = lamo_i - lamo[back];
          const T qv = diff_i * r / den;
          const T p_bar = -big_l / den;
          const T den_bar = -(p_bar * qv);
          diff_bar[j] = diff_bar[j] + p_bar * r;
          const T r_bar = p_bar * diff_i;
          lamo_bar[j] = lamo_bar[j] + r_bar;
          lamo_bar[back] = lamo_bar[back] - r_bar;
          diff_bar[j] = diff_bar[j] + den_bar;
          diff_bar[back] = diff_bar[back] - den_bar;
        }
      }
      // the iteration's ratio, efficacy and land feedback
      T ll_bar = T(0), eff_bar = T(0);
      if (j == kstar) {
        lamo_bar[j] = lamo_bar[j] + g_out[0 * B + m];
        ll_bar = g_out[1 * B + m];
        if (!rf_sum_zero) eff_bar = g_out[2 * B + m];
      }
      const T lam_l = lam + k.c[C_FRATIO] * (lam - lamo_i) / rlo;
      Temps<T, T> tm;
      temps_from(k, q, k_lo, k_ns, alpha, lamo_i, lam_l, tm);
      const T* t = tm.t;
      const T* y = tm.y;
      const T om = (fgno * t[0] + fgso * t[2]) * k.c[C_INV_FGOSUM];
      const T lm = (fgnl * t[1] + fgsl * t[3]) * k.c[C_INV_FGLSUM];
      const T db = diff_bar[j];
      bar[R_RLO] += db;
      const T lm_bar = -db / om;
      const T om_bar = -(lm_bar * (lm / om));
      const T tg = fgno * t[0] + fgnl * t[1] + fgso * t[2] + fgsl * t[3];
      const T tg_bar = eff_bar / ecs;
      bar[R_ECS] += -(tg_bar * (tg / ecs));
      T t_bar[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) t_bar[c] = tg_bar * fg[c];
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
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        T acc = T(0);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc = acc + (tm.cof[a][c] * tm.inv_det) * yb[c];
        u[a] = acc;
      }
      auto m_bar = [&](int a, int b) -> T { return -(u[a] * y[b]); };
      lamo_bar[j] = lamo_bar[j] + m_bar(0, 0) * fgno;
      T ad_bar = m_bar(0, 0);
      bar[R_K_LO] += -m_bar(0, 1);
      bar[R_K_NS] += -m_bar(0, 2);
      bar[R_K_LO] += -(m_bar(1, 0) * alpha);
      bar[R_ALPHA] += -(m_bar(1, 0) * k_lo);
      ll_bar = ll_bar + m_bar(1, 1) * fgnl;
      bar[R_K_LO] += m_bar(1, 1);
      bar[R_K_NS] += -m_bar(2, 0);
      lamo_bar[j] = lamo_bar[j] + m_bar(2, 2) * fgso;
      ad_bar = ad_bar + m_bar(2, 2);
      bar[R_K_LO] += -m_bar(2, 3);
      bar[R_K_LO] += -(m_bar(3, 2) * alpha);
      bar[R_ALPHA] += -(m_bar(3, 2) * k_lo);
      ll_bar = ll_bar + m_bar(3, 3) * fgsl;
      bar[R_K_LO] += m_bar(3, 3);
      bar[R_K_LO] += ad_bar * alpha;
      bar[R_ALPHA] += ad_bar * k_lo;
      bar[R_K_NS] += ad_bar;
      // lam_l = lam + fratio * (lam - lamo_i) / rlo
      lam_bar = lam_bar + ll_bar;
      const T w = k.c[C_FRATIO] * (lam - lamo_i);
      const T w_bar = ll_bar / rlo;
      bar[R_RLO] += -(w_bar * (w / rlo));
      const T dl_bar = w_bar * k.c[C_FRATIO];
      lam_bar = lam_bar + dl_bar;
      lamo_bar[j] = lamo_bar[j] - dl_bar;
    }
    lam_bar = lam_bar + lamo_bar[0];
    const T lam_q = lam_bar / ecs;
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

constexpr int kThreads = 128;

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
