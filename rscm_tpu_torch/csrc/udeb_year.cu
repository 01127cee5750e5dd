// One year of ClimateUDEB monthly sub-steps, one thread per ensemble member.
//
// Replaces the Pallas TPU kernel rscm_tpu/ops/udeb_month.py::udeb_year_update
// (pallas_call at udeb_month.py:400, body _month_body at :87-277).  The plain
// PyTorch version beside its wrapper (rscm_tpu_torch/ops/udeb_month.py,
// udeb_year_plain) performs the same operations in the same order; built with
// -fmad=false the two agree bit for bit.
//
// Layout: member-minor.  Row r of member m of a (rows, B) input is at
// r * B + m, so the threads of a warp read 32 neighbouring addresses.
// init_prof is addressed through explicit strides so a broadcast view (stride
// 0 over members) needs no copy.
//
// Bound on an H100: arithmetic (~46k floating-point operations per
// member-year against ~1.9 kB moved in float64).  Every intermediate stays in
// the thread; two 50-layer columns plus the Thomas scratch exceed the register
// file in float64 and spill to local memory (see PERF.md for the ptxas report).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// Leading constants of the geometry struct; the order matches
// _GEOM_SCALARS in ops/udeb_month.py.
enum GeomIndex {
  G_DT_SUB, G_INV_C_MIX, G_INV_DZMIX_DZ1, G_INV_DZ_MIX, G_INV_DZ, G_INV_DZ2,
  G_K_DT_DZMIX, G_K_DT_DZ, G_DSCALE,
  G_FL0, G_FL1, G_FO0, G_FO1, G_SAFE_FL0, G_SAFE_FL1, G_CMFO0, G_CMFO1,
  G_Q0, G_Q1, G_Q2, G_Q3, G_FGNO, G_FGNL, G_FGSO, G_FGSL, G_INV_FGNO, G_INV_FGSO,
  G_NSCALAR
};

template <typename T, int N>
struct Geom {
  T s[G_NSCALAR];
  T af_top[N];
  T af_bot[N];
  T af_diff[N];
  T one_minus_rel[N - 1];
  T inv_dz_dzup[N - 2];
};

// Scalar rows of the packed input, in the order of SCALAR_ROWS.
enum ScalarRow {
  S_LAM_O, S_LAM_L, S_KAPPA, S_KAPPA_DKDT, S_KAPPA_MIN, S_W_INITIAL, S_W_VAR_FRAC,
  S_K_LO, S_K_NS, S_K_LG, S_AMPLIFY, S_PI_RATIO, S_ADJ_ALPHA, S_ADJ_GAMMA,
  S_MAX_TEMP, S_C_GROUND, S_ERF_START, S_ERF_END, S_T_POLAR, S_W_THRESH_NH,
  S_W_THRESH_SH, S_ROWS
};

__device__ __forceinline__ float tabs(float x) { return fabsf(x); }
__device__ __forceinline__ double tabs(double x) { return fabs(x); }

// torch.minimum / torch.maximum: NaN propagates.
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

template <typename T, int N>
__global__ void __launch_bounds__(128) udeb_year_kernel(
    const Geom<T, N> g, int steps, int land_heat,
    const T* __restrict__ scal, const T* __restrict__ ocean_in,
    const T* __restrict__ init, int64_t init_s0, int64_t init_s1,
    const T* __restrict__ vec_in, T* __restrict__ ocean_out,
    T* __restrict__ vec_out, int64_t B) {
  const int64_t m = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (m >= B) return;

  T sc[S_ROWS];
#pragma unroll
  for (int r = 0; r < S_ROWS; ++r) sc[r] = scal[r * B + m];

  T oc[2][N];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < N; ++i) oc[h][i] = ocean_in[(h * N + i) * B + m];
  T land[2], ground[2], hemi[2], upw[2], aeff[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    land[h] = vec_in[(0 + h) * B + m];
    ground[h] = vec_in[(2 + h) * B + m];
    hemi[h] = vec_in[(4 + h) * B + m];
    upw[h] = vec_in[(6 + h) * B + m];
    aeff[h] = vec_in[(8 + h) * B + m];
  }
  auto prof = [&](int h, int i) -> T {
    return init[(int64_t)(h * N + i) * init_s0 + m * init_s1];
  };

  const T one = T(1);
  const T dt_sub = g.s[G_DT_SUB];
  const T f_l[2] = {g.s[G_FL0], g.s[G_FL1]};
  const T f_o[2] = {g.s[G_FO0], g.s[G_FO1]};
  const T safe_fl[2] = {g.s[G_SAFE_FL0], g.s[G_SAFE_FL1]};
  const T cmfo[2] = {g.s[G_CMFO0], g.s[G_CMFO1]};
  const T q_ocean[2] = {g.s[G_Q0], g.s[G_Q2]};

  // SST -> air map constants (branch-free in gamma, as the plain version)
  const T alpha = sc[S_ADJ_ALPHA], gamma = sc[S_ADJ_GAMMA];
  const bool gamma_nonzero = tabs(gamma) > T(1e-15);
  const T gamma_safe = gamma_nonzero ? gamma : one;
  const T t_star = -(alpha - T(1.0)) / (T(2.0) * gamma_safe);
  const T delta_max = alpha * t_star + gamma * t_star * t_star - t_star;
  auto sst_to_air = [&](T sst) -> T {
    const T quad = (sst < t_star) ? alpha * sst + gamma * sst * sst : sst + delta_max;
    return gamma_nonzero ? quad : alpha * sst;
  };

  for (int step = 0; step < steps; ++step) {
    // the month's fraction of the year, (step + 1) / steps, as the plain
    // version's host float m / steps rounded to T
    const T frac = T(step + 1) / T(steps);
    const T erf = sc[S_ERF_START] + frac * (sc[S_ERF_END] - sc[S_ERF_START]);

    // -- ground-heat damping ------------------------------------------------
    if (land_heat) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const T flux = sc[S_K_LG] * (land[h] - ground[h]);
        const T delta = flux / (safe_fl[h] * sc[S_C_GROUND]) * dt_sub;
        ground[h] = ground[h] + ((f_l[h] < T(1e-15)) ? T(0) : delta);
      }
    }

    // -- implicit ocean column update, hemisphere by hemisphere -------------
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const T w = upw[h];
      const T ocean0 = oc[h][0];
      const T dkdt_term = sc[S_KAPPA_DKDT] * (ocean0 - oc[h][N - 1]);
      auto kappa = [&](int i) -> T {
        return tmax((g.one_minus_rel[i] * dkdt_term + sc[S_KAPPA]) * g.s[G_DSCALE],
                    sc[S_KAPPA_MIN]);
      };
      const T denom_fb = f_o[h] * (sc[S_K_LO] + f_l[h] * sc[S_LAM_L]);
      const T term_feedback =
          aeff[h] * g.s[G_INV_C_MIX] *
          (sc[S_LAM_O] + sc[S_LAM_L] * sc[S_K_LO] * sc[S_AMPLIFY] * f_l[h] / denom_fb);
      const T term_diff0 = kappa(0) * g.s[G_INV_DZMIX_DZ1] * dt_sub;
      const T term_upwell0 = w * g.s[G_INV_DZ_MIX] * dt_sub;
      const T forcing_amp = T(1.0) + sc[S_K_LO] * f_l[h] / denom_fb;
      const T tul = w * g.s[G_INV_DZ] * dt_sub;
      const T delta_w = w - sc[S_W_INITIAL];
      const T t_polar = sc[S_T_POLAR];
      const T pto = sc[S_PI_RATIO] * tul * ocean0;
      const T k_dw = g.s[G_K_DT_DZ] * delta_w;
      const T k_dw_tp = k_dw * t_polar;

      // row 0 (mixed layer)
      const T b0 = T(1.0) + term_feedback * dt_sub * g.af_top[0] + term_diff0 * g.af_bot[0] +
                   term_upwell0 * sc[S_PI_RATIO] * g.af_bot[0];
      const T c0 = -(term_diff0 + term_upwell0) * g.af_bot[0];
      T d0 = ocean0 + (erf * q_ocean[h] * forcing_amp + hemi[h]) * g.s[G_INV_C_MIX] *
                          dt_sub * g.af_top[0];
      if (land_heat) {
        d0 = d0 - sc[S_K_LG] * (land[h] - ground[h]) / cmfo[h] * dt_sub * g.af_top[0];
      }
      d0 = d0 + g.s[G_K_DT_DZMIX] * delta_w * (prof(h, 1) - t_polar) * g.af_bot[0];

      // forward sweep: c' kept per layer, d' written over the consumed column
      T c_prime[N - 1];
      c_prime[0] = c0 / b0;
      oc[h][0] = d0 / b0;
      T kappa_prev = kappa(0);
#pragma unroll
      for (int i = 1; i < N - 1; ++i) {
        const T kappa_i = kappa(i);
        const T t_diff_up = kappa_prev * g.inv_dz_dzup[i - 1] * dt_sub;
        const T t_diff_down = kappa_i * g.s[G_INV_DZ2] * dt_sub;
        kappa_prev = kappa_i;
        const T a_i = -t_diff_up * g.af_top[i];
        const T b_i = T(1.0) + t_diff_up * g.af_top[i] + t_diff_down * g.af_bot[i] +
                      tul * g.af_top[i];
        const T c_i = -(t_diff_down + tul) * g.af_bot[i];
        T d_i = oc[h][i] + pto * g.af_diff[i];
        d_i = d_i + k_dw * (prof(h, i + 1) * g.af_bot[i] - prof(h, i) * g.af_top[i]);
        d_i = d_i + k_dw_tp * g.af_diff[i];
        const T denom = b_i - a_i * c_prime[i - 1];
        c_prime[i] = c_i / denom;
        oc[h][i] = (d_i - a_i * oc[h][i - 1]) / denom;
      }
      {
        const int i = N - 1;
        const T term_diff_last = kappa_prev * g.s[G_INV_DZ2] * dt_sub;
        const T a_l = -term_diff_last * g.af_top[i];
        const T b_l = T(1.0) + (term_diff_last + tul) * g.af_top[i];
        T d_l = oc[h][i] + pto * g.af_top[i];
        d_l = d_l + k_dw * (t_polar - prof(h, i)) * g.af_top[i];
        const T denom = b_l - a_l * c_prime[i - 1];
        oc[h][i] = (d_l - a_l * oc[h][i - 1]) / denom;
      }
      // back substitution on the unclamped solution, then the clamp
      T x = oc[h][N - 1];
      oc[h][N - 1] = tmin(x, sc[S_MAX_TEMP]);
#pragma unroll
      for (int i = N - 2; i >= 0; --i) {
        x = oc[h][i] - c_prime[i] * x;
        oc[h][i] = tmin(x, sc[S_MAX_TEMP]);
      }
    }

    // -- land / exchange / upwelling ----------------------------------------
    const T t_air_nho = sst_to_air(oc[0][0]);
    const T t_air_sho = sst_to_air(oc[1][0]);
    land[0] = tmin((erf * g.s[G_Q1] * g.s[G_FGNL] + sc[S_K_LO] * sc[S_AMPLIFY] * t_air_nho) /
                       (sc[S_LAM_L] * g.s[G_FGNL] + sc[S_K_LO]),
                   sc[S_MAX_TEMP]);
    land[1] = tmin((erf * g.s[G_Q3] * g.s[G_FGSL] + sc[S_K_LO] * sc[S_AMPLIFY] * t_air_sho) /
                       (sc[S_LAM_L] * g.s[G_FGSL] + sc[S_K_LO]),
                   sc[S_MAX_TEMP]);
    if (g.s[G_FGNO] > T(1e-15)) hemi[0] = sc[S_K_NS] * g.s[G_INV_FGNO] * (t_air_sho - t_air_nho);
    if (g.s[G_FGSO] > T(1e-15)) hemi[1] = sc[S_K_NS] * g.s[G_INV_FGSO] * (t_air_nho - t_air_sho);

    const T global_temp = t_air_nho * g.s[G_FGNO] + land[0] * g.s[G_FGNL] +
                          t_air_sho * g.s[G_FGSO] + land[1] * g.s[G_FGSL];
    const T w_min = sc[S_W_INITIAL] * (T(1.0) - sc[S_W_VAR_FRAC]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const T ratio = tmin(global_temp / sc[S_W_THRESH_NH + h], T(1));
      upw[h] = tmax(sc[S_W_INITIAL] * (T(1.0) - sc[S_W_VAR_FRAC] * ratio), w_min);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < N; ++i) ocean_out[(h * N + i) * B + m] = oc[h][i];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    vec_out[(0 + h) * B + m] = land[h];
    vec_out[(2 + h) * B + m] = ground[h];
    vec_out[(4 + h) * B + m] = hemi[h];
    vec_out[(6 + h) * B + m] = upw[h];
  }
}

template <typename T>
int launch(const T* geom, int n_geom, int steps, int land_heat, const T* scal,
           const T* ocean, const T* init, long long init_s0, long long init_s1,
           const T* vec, T* ocean_out, T* vec_out, long long B, void* stream) {
  constexpr int N = 50;
  Geom<T, N> g;
  if (n_geom * sizeof(T) != sizeof(g) || steps < 1) {
    return (int)cudaErrorInvalidValue;
  }
  memcpy(&g, geom, sizeof(g));
  if (B <= 0) return 0;
  const int threads = 128;
  const long long blocks = (B + threads - 1) / threads;
  udeb_year_kernel<T, N><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      g, steps, land_heat, scal, ocean, init, init_s0, init_s1, vec, ocean_out, vec_out, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int udeb_year_f32(const float* geom, int n_geom, int steps, int land_heat,
                             const float* scal, const float* ocean, const float* init,
                             long long init_s0, long long init_s1, const float* vec,
                             float* ocean_out, float* vec_out, long long B, void* stream) {
  return launch<float>(geom, n_geom, steps, land_heat, scal, ocean, init, init_s0, init_s1,
                       vec, ocean_out, vec_out, B, stream);
}

extern "C" int udeb_year_f64(const double* geom, int n_geom, int steps, int land_heat,
                             const double* scal, const double* ocean, const double* init,
                             long long init_s0, long long init_s1, const double* vec,
                             double* ocean_out, double* vec_out, long long B, void* stream) {
  return launch<double>(geom, n_geom, steps, land_heat, scal, ocean, init, init_s0, init_s1,
                        vec, ocean_out, vec_out, B, stream);
}
