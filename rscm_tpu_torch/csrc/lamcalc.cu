// LAMCALC: per-member hybrid step/secant iteration on lambda_ocean, one
// thread per ensemble member.
//
// Replaces the Pallas TPU kernel rscm_tpu/ops/lamcalc_kernel.py::lamcalc_scalars
// (pallas_call at lamcalc_kernel.py:252, body _iteration at :59-185).  The plain
// PyTorch version beside its wrapper (rscm_tpu_torch/ops/lamcalc_kernel.py,
// lamcalc_plain) performs the same operations in the same order with a fixed
// count of 39 steps; here each thread stops once its member has converged,
// which gives the same result because converged members are frozen.
//
// Layout: member-minor, input (6, B) = ecs, q, k_lo, k_ns, rlo, alpha;
// output (3, B) = lam_o, lam_l, efficacy.
//
// Bound on an H100: arithmetic (~350 floating-point operations an iteration,
// 6-7 iterations a typical member, against 72 bytes a member in float64).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxIterations = 40;

// Constants, in the order of _consts in ops/lamcalc_kernel.py.
enum Const {
  C_FGNO, C_FGNL, C_FGSO, C_FGSL, C_V0, C_V1, C_V2, C_V3, C_FRATIO,
  C_INV_FGOSUM, C_INV_FGLSUM, C_FB_LAM_O, C_FB_LAM_L, C_FB_EFF, C_COUNT
};

__device__ __forceinline__ float tabs(float x) { return fabsf(x); }
__device__ __forceinline__ double tabs(double x) { return fabs(x); }

template <typename T>
struct Consts {
  T c[C_COUNT];
};

template <typename T>
__device__ __forceinline__ void temps_from(const Consts<T>& k, T q, T k_lo, T k_ns, T alpha,
                                           T lam_o, T lam_l, T t[4]) {
  const T a_diag = k_lo * alpha + k_ns;
  const T z = T(0);
  const T m[4][4] = {
      {k.c[C_FGNO] * lam_o + a_diag, -k_lo, -k_ns, z},
      {-k_lo * alpha, k.c[C_FGNL] * lam_l + k_lo, z, z},
      {-k_ns, z, k.c[C_FGSO] * lam_o + a_diag, -k_lo},
      {z, z, -k_lo * alpha, k.c[C_FGSL] * lam_l + k_lo},
  };
  auto det3 = [&](int r0, int r1, int r2, int c0, int c1, int c2) -> T {
    return m[r0][c0] * (m[r1][c1] * m[r2][c2] - m[r1][c2] * m[r2][c1]) -
           m[r0][c1] * (m[r1][c0] * m[r2][c2] - m[r1][c2] * m[r2][c0]) +
           m[r0][c2] * (m[r1][c0] * m[r2][c1] - m[r1][c1] * m[r2][c0]);
  };
  const int others[4][3] = {{1, 2, 3}, {0, 2, 3}, {0, 1, 3}, {0, 1, 2}};
  T cof[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const T d = det3(others[i][0], others[i][1], others[i][2], others[j][0], others[j][1],
                       others[j][2]);
      cof[i][j] = ((i + j) % 2 == 0) ? d : -d;
    }
  T det = T(0);
#pragma unroll
  for (int j = 0; j < 4; ++j) det = det + m[0][j] * cof[0][j];
  const T inv_det = T(1) / det;
  const T v[4] = {k.c[C_V0], k.c[C_V1], k.c[C_V2], k.c[C_V3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T s = T(0);
#pragma unroll
    for (int j = 0; j < 4; ++j) s = s + (cof[j][i] * inv_det) * v[j];
    t[i] = q * s;
  }
}

template <typename T>
__global__ void __launch_bounds__(128) lamcalc_kernel(
    const Consts<T> k, int rf_sum_zero, const T* __restrict__ in, T* __restrict__ out,
    int64_t B) {
  const int64_t m = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (m >= B) return;
  const T ecs = in[0 * B + m], q = in[1 * B + m], k_lo = in[2 * B + m];
  const T k_ns = in[3 * B + m], rlo = in[4 * B + m], alpha = in[5 * B + m];

  const T lam = q / ecs;
  const T zeros = lam * T(0.0);
  T lamo_im2 = lam + T(0.0), lamo_im1 = lam + T(0.0), lamo_i = lam + T(0.7);
  T diff_im2 = zeros, diff_im1 = zeros;
  T dlamo = zeros + T(0.7);
  int iflag = 0;
  bool found = false;
  T best_lam_o = zeros, best_lam_l = zeros, best_eff = zeros;

  for (int it = 0; it < kMaxIterations - 1 && !found; ++it) {
    const T lam_l = lam + k.c[C_FRATIO] * (lam - lamo_i) / rlo;
    T t[4];
    temps_from(k, q, k_lo, k_ns, alpha, lamo_i, lam_l, t);
    const T ocean_mean = (k.c[C_FGNO] * t[0] + k.c[C_FGSO] * t[2]) * k.c[C_INV_FGOSUM];
    const T land_mean = (k.c[C_FGNL] * t[1] + k.c[C_FGSL] * t[3]) * k.c[C_INV_FGLSUM];
    const T diff_i = rlo - land_mean / ocean_mean;
    const T t_global =
        k.c[C_FGNO] * t[0] + k.c[C_FGNL] * t[1] + k.c[C_FGSO] * t[2] + k.c[C_FGSL] * t[3];
    const T eff_i = t_global / ecs;

    if (tabs(diff_i) < T(0.001)) {  // converged now (found is false here)
      best_lam_o = lamo_i;
      best_lam_l = lam_l;
      best_eff = eff_i;
      found = true;
    }
    const bool sign_change = diff_i * diff_im1 < T(0.0);
    if (sign_change) iflag = 1;
    const T dlamo_step = (tabs(diff_i) > tabs(diff_im1)) ? -dlamo : dlamo;
    const T next_step = lamo_i + dlamo_step;
    auto secant = [&](T lamo_back, T diff_back) -> T {
      const T denom = diff_i - diff_back;
      const bool small = tabs(denom) < T(1e-30);
      return small ? lamo_i + dlamo
                   : lamo_i - diff_i * (lamo_i - lamo_back) / (small ? T(1) : denom);
    };
    const T secant1 = secant(lamo_im1, diff_im1);
    const T secant2 = secant(lamo_im2, diff_im2);
    T lamo_next = (iflag == 0) ? next_step : (sign_change ? secant1 : secant2);
    if (iflag == 0) dlamo = dlamo_step;
    if (found) lamo_next = lamo_i;
    lamo_im2 = lamo_im1;
    lamo_im1 = lamo_i;
    lamo_i = lamo_next;
    diff_im2 = diff_im1;
    diff_im1 = diff_i;
  }

  const T eff = rf_sum_zero ? T(1) : best_eff;
  out[0 * B + m] = found ? best_lam_o : k.c[C_FB_LAM_O];
  out[1 * B + m] = found ? best_lam_l : k.c[C_FB_LAM_L];
  out[2 * B + m] = found ? eff : k.c[C_FB_EFF];
}

template <typename T>
int launch(const T* consts, int n_consts, int rf_sum_zero, const T* in, T* out, long long B,
           void* stream) {
  Consts<T> k;
  if (n_consts != C_COUNT) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < C_COUNT; ++i) k.c[i] = consts[i];
  if (B <= 0) return 0;
  const int threads = 128;
  const long long blocks = (B + threads - 1) / threads;
  lamcalc_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(k, rf_sum_zero, in,
                                                                              out, B);
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
