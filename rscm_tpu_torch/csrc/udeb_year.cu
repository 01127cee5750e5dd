// One year of ClimateUDEB monthly sub-steps: two threads per ensemble member,
// one for each hemisphere's ocean column.
//
// Replaces the Pallas TPU kernel rscm_tpu/ops/udeb_month.py::udeb_year_update
// (pallas_call at udeb_month.py:400, body _month_body at :87-277).  The plain
// PyTorch version beside its wrapper (rscm_tpu_torch/ops/udeb_month.py,
// udeb_year_plain) performs the same operations in the same order; built with
// -fmad=false the two agree bit for bit.
//
// Layout: member-minor.  Row r of member m of a (rows, B) input is at
// r * B + m, so the threads of a warp read neighbouring addresses.
// init_prof is addressed through explicit strides so a broadcast view (stride
// 0 over members) needs no copy.
//
// Bound on an H100: operations.  A member-year is 2 columns x 12 months x n
// layers of a serial Thomas step, each ~40 additions and multiplications and
// 2 IEEE divisions, against ~(4n + 40) values in and out.  Design:
// - Threads 2k and 2k+1 of a block hold the northern and southern column of
//   one member.  The columns are independent within a month; they meet only
//   in the land / exchange / upwelling step, where the pair swaps its air
//   and land temperatures with __shfl_xor_sync and both form the global mean
//   in the plain version's order.
// - Each thread's column (overwritten by d' in the forward sweep and by the
//   solution in the back sweep) and its Thomas coefficients c' live in
//   dynamic shared memory, laid out [layer][thread] so that a warp's 32
//   values fall on consecutive banks.  Nothing is indexed in local memory.
// - The per-layer geometry (a device buffer) and a broadcast initial profile
//   are staged into shared memory once per block.
// - In float64 at 50 layers shared memory holds 8 warps per SM, too few to
//   hide the latency of the sweep's chain of IEEE divisions, so the forward
//   sweep forms row i+1's coefficients before row i's divisions and the back
//   sweep loads each row one ahead: the scheduler overlaps them.
// - The layer count n is a run-time argument.  A block of one warp must fit
//   its shared memory (smem_bytes), which bounds n; the host picks the block
//   size with the most resident threads per SM.

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

constexpr int MAX_THREADS = 256;
constexpr int MIN_THREADS = 32;
constexpr size_t MAX_BLOCK_SMEM = 232448;  // 227 KB: the most one block may use

// Per-layer geometry rows of the device buffer: af_top[n], af_bot[n],
// af_diff[n], one_minus_rel[n-1], inv_dz_dzup[n-2].
__host__ __device__ inline int geom_len(int n) { return 5 * n - 3; }

// Dynamic shared memory of a block: the threads' columns and c', the
// geometry, the initial profile (2n).
template <typename T>
__host__ __device__ inline size_t smem_bytes(int n, int threads) {
  return sizeof(T) * ((size_t)threads * (2 * n - 1) + geom_len(n) + 2 * n);
}

// The most layers the kernel takes: a block of one warp must fit the shared
// memory a block may use.  The wrapper asks for it (udeb_year_max_layers_*).
template <typename T>
int max_layers() {
  int n = 2;
  while (smem_bytes<T>(n + 1, MIN_THREADS) <= MAX_BLOCK_SMEM) ++n;
  return n;
}

// float32 keeps ~half the registers of float64 and fits twice the threads
// in shared memory: let two full blocks share an SM.
template <typename T> struct MinBlocks { static constexpr int value = 1; };
template <> struct MinBlocks<float> { static constexpr int value = 2; };

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
  T* cpr = col + (size_t)n * nt;            // [n-1][nt]
  T* af_top = cpr + (size_t)(n - 1) * nt;
  T* af_bot = af_top + n;
  T* af_diff = af_bot + n;
  T* omr = af_diff + n;      // one_minus_rel
  T* idzu = omr + (n - 1);   // inv_dz_dzup
  T* prof_s = idzu + (n - 2);

  const bool prof_shared = init_s1 == 0;
  for (int k = tid; k < geom_len(n); k += nt) af_top[k] = geom[k];
  if (prof_shared) {
    for (int k = tid; k < 2 * n; k += nt) prof_s[k] = init[(int64_t)k * init_s0];
  }
  __syncthreads();

  const int h = tid & 1;
  const int64_t m = blockIdx.x * (int64_t)(nt >> 1) + (tid >> 1);
  if (m >= B) return;  // both threads of a pair leave together
  const unsigned pair = 3u << (tid & 30);

  T sc[S_ROWS];
#pragma unroll
  for (int r = 0; r < S_ROWS; ++r) sc[r] = scal[r * B + m];

  for (int i = 0; i < n; ++i) col[i * nt + tid] = ocean_in[(int64_t)(h * n + i) * B + m];
  T land = vec_in[(0 + h) * B + m];
  T ground = vec_in[(2 + h) * B + m];
  T hemi = vec_in[(4 + h) * B + m];
  T upw = vec_in[(6 + h) * B + m];
  const T aeff = vec_in[(8 + h) * B + m];
  const T* prof_g = init + (int64_t)(h * n) * init_s0 + m * init_s1;
  auto prof = [&](int i) -> T {
    return prof_shared ? prof_s[h * n + i] : prof_g[(int64_t)i * init_s0];
  };

  const T one = T(1);
  const T dt_sub = g.s[G_DT_SUB];
  const T f_l = h ? g.s[G_FL1] : g.s[G_FL0];
  const T f_o = h ? g.s[G_FO1] : g.s[G_FO0];
  const T safe_fl = h ? g.s[G_SAFE_FL1] : g.s[G_SAFE_FL0];
  const T cmfo = h ? g.s[G_CMFO1] : g.s[G_CMFO0];
  const T q_ocean = h ? g.s[G_Q2] : g.s[G_Q0];
  const T q_land = h ? g.s[G_Q3] : g.s[G_Q1];
  const T fg_land = h ? g.s[G_FGSL] : g.s[G_FGNL];
  const T fg_ocean = h ? g.s[G_FGSO] : g.s[G_FGNO];
  const T inv_fg_ocean = h ? g.s[G_INV_FGSO] : g.s[G_INV_FGNO];
  const T w_thresh = h ? sc[S_W_THRESH_SH] : sc[S_W_THRESH_NH];
  const T max_temp = sc[S_MAX_TEMP];

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
      const T flux = sc[S_K_LG] * (land - ground);
      const T delta = flux / (safe_fl * sc[S_C_GROUND]) * dt_sub;
      ground = ground + ((f_l < T(1e-15)) ? T(0) : delta);
    }

    // -- implicit ocean column update of this thread's hemisphere -----------
    const T w = upw;
    const T ocean0 = col[tid];
    const T dkdt_term = sc[S_KAPPA_DKDT] * (ocean0 - col[(n - 1) * nt + tid]);
    auto kappa = [&](int i) -> T {
      return tmax((omr[i] * dkdt_term + sc[S_KAPPA]) * g.s[G_DSCALE], sc[S_KAPPA_MIN]);
    };
    const T denom_fb = f_o * (sc[S_K_LO] + f_l * sc[S_LAM_L]);
    const T term_feedback =
        aeff * g.s[G_INV_C_MIX] *
        (sc[S_LAM_O] + sc[S_LAM_L] * sc[S_K_LO] * sc[S_AMPLIFY] * f_l / denom_fb);
    const T term_diff0 = kappa(0) * g.s[G_INV_DZMIX_DZ1] * dt_sub;
    const T term_upwell0 = w * g.s[G_INV_DZ_MIX] * dt_sub;
    const T forcing_amp = T(1.0) + sc[S_K_LO] * f_l / denom_fb;
    const T tul = w * g.s[G_INV_DZ] * dt_sub;
    const T delta_w = w - sc[S_W_INITIAL];
    const T t_polar = sc[S_T_POLAR];
    const T pto = sc[S_PI_RATIO] * tul * ocean0;
    const T k_dw = g.s[G_K_DT_DZ] * delta_w;
    const T k_dw_tp = k_dw * t_polar;

    // row 0 (mixed layer)
    const T b0 = T(1.0) + term_feedback * dt_sub * af_top[0] + term_diff0 * af_bot[0] +
                 term_upwell0 * sc[S_PI_RATIO] * af_bot[0];
    const T c0 = -(term_diff0 + term_upwell0) * af_bot[0];
    T d0 = ocean0 + (erf * q_ocean * forcing_amp + hemi) * g.s[G_INV_C_MIX] * dt_sub * af_top[0];
    if (land_heat) {
      d0 = d0 - sc[S_K_LG] * (land - ground) / cmfo * dt_sub * af_top[0];
    }
    d0 = d0 + g.s[G_K_DT_DZMIX] * delta_w * (prof(1) - t_polar) * af_bot[0];

    // forward sweep: c' to its own rows, d' over the consumed column.  The
    // rows' coefficients do not depend on the sweep, so row i+1's are formed
    // before row i's two divisions: the scheduler fills the divisions'
    // latency with them.
    T cp_prev = c0 / b0;
    T dp_prev = d0 / b0;
    cpr[tid] = cp_prev;
    col[tid] = dp_prev;
    T kappa_prev = kappa(0);
    T prof_i = prof(1);
    T a_nx, b_nx, c_nx, d_nx;  // the next row's coefficients
    auto interior_row = [&](int i) {
      const T kappa_i = kappa(i);
      const T t_diff_up = kappa_prev * idzu[i - 1] * dt_sub;
      const T t_diff_down = kappa_i * g.s[G_INV_DZ2] * dt_sub;
      kappa_prev = kappa_i;
      const T at = af_top[i], ab = af_bot[i], ad = af_diff[i];
      a_nx = -t_diff_up * at;
      b_nx = T(1.0) + t_diff_up * at + t_diff_down * ab + tul * at;
      c_nx = -(t_diff_down + tul) * ab;
      const T prof_next = prof(i + 1);
      T d_i = col[i * nt + tid] + pto * ad;
      d_i = d_i + k_dw * (prof_next * ab - prof_i * at);
      d_nx = d_i + k_dw_tp * ad;
      prof_i = prof_next;
    };
    auto last_row = [&]() {
      const int i = n - 1;
      const T term_diff_last = kappa_prev * g.s[G_INV_DZ2] * dt_sub;
      const T at = af_top[i];
      a_nx = -term_diff_last * at;
      b_nx = T(1.0) + (term_diff_last + tul) * at;
      const T d_l = col[i * nt + tid] + pto * at;
      d_nx = d_l + k_dw * (t_polar - prof(i)) * at;
    };
    auto eliminate = [&](int i, T a_i, T c_i, T d_i, T denom) {
      cp_prev = c_i / denom;
      dp_prev = (d_i - a_i * dp_prev) / denom;
      cpr[i * nt + tid] = cp_prev;
      col[i * nt + tid] = dp_prev;
    };
    if (n > 2) {
      interior_row(1);
      for (int i = 1; i < n - 2; ++i) {
        const T a_i = a_nx, c_i = c_nx, d_i = d_nx;
        const T denom = b_nx - a_i * cp_prev;
        interior_row(i + 1);
        eliminate(i, a_i, c_i, d_i, denom);
      }
      const T a_i = a_nx, c_i = c_nx, d_i = d_nx;
      const T denom = b_nx - a_i * cp_prev;
      last_row();
      eliminate(n - 2, a_i, c_i, d_i, denom);
    } else {
      last_row();
    }
    T x = (d_nx - a_nx * dp_prev) / (b_nx - a_nx * cp_prev);

    // back substitution on the unclamped solution, then the clamp; each
    // row's two values are loaded one row ahead
    col[(n - 1) * nt + tid] = tmin(x, max_temp);
    T col_i = col[(n - 2) * nt + tid], cpr_i = cpr[(n - 2) * nt + tid];
    for (int i = n - 2; i >= 0; --i) {
      const T d_prime = col_i, c_prime = cpr_i;
      const int j = i > 0 ? i - 1 : 0;
      col_i = col[j * nt + tid];
      cpr_i = cpr[j * nt + tid];
      x = d_prime - c_prime * x;
      col[i * nt + tid] = tmin(x, max_temp);
    }
    const T sst = tmin(x, max_temp);

    // -- land / exchange / upwelling: the pair swaps its temperatures --------
    const T t_air_own = sst_to_air(sst);
    const T t_air_other = __shfl_xor_sync(pair, t_air_own, 1);
    const T t_air_nho = h ? t_air_other : t_air_own;
    const T t_air_sho = h ? t_air_own : t_air_other;
    land = tmin((erf * q_land * fg_land + sc[S_K_LO] * sc[S_AMPLIFY] * t_air_own) /
                    (sc[S_LAM_L] * fg_land + sc[S_K_LO]),
                max_temp);
    const T land_other = __shfl_xor_sync(pair, land, 1);
    const T land_nh = h ? land_other : land;
    const T land_sh = h ? land : land_other;
    if (fg_ocean > T(1e-15)) hemi = sc[S_K_NS] * inv_fg_ocean * (t_air_other - t_air_own);

    const T global_temp = t_air_nho * g.s[G_FGNO] + land_nh * g.s[G_FGNL] +
                          t_air_sho * g.s[G_FGSO] + land_sh * g.s[G_FGSL];
    const T w_min = sc[S_W_INITIAL] * (T(1.0) - sc[S_W_VAR_FRAC]);
    const T ratio = tmin(global_temp / w_thresh, T(1));
    upw = tmax(sc[S_W_INITIAL] * (T(1.0) - sc[S_W_VAR_FRAC] * ratio), w_min);
  }

  for (int i = 0; i < n; ++i) ocean_out[(int64_t)(h * n + i) * B + m] = col[i * nt + tid];
  vec_out[(0 + h) * B + m] = land;
  vec_out[(2 + h) * B + m] = ground;
  vec_out[(4 + h) * B + m] = hemi;
  vec_out[(6 + h) * B + m] = upw;
}

struct Config {
  int device = -1, n = -1, threads = 0, blocks_per_sm = 0;
  size_t smem = 0;
};

// The block size (a multiple of 32 up to MAX_THREADS) with the most resident
// threads per SM at n layers, the smallest of equals.  Cached per (device, n)
// in a small ring, so that models of a few layer counts on one card each
// search once.
template <typename T>
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
  if (n < 2 || n > max_layers<T>()) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(udeb_year_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)MAX_BLOCK_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(udeb_year_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  Config best;
  for (int threads = MIN_THREADS; threads <= MAX_THREADS; threads *= 2) {
    const size_t smem = smem_bytes<T>(n, threads);
    if (smem > MAX_BLOCK_SMEM) break;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, udeb_year_kernel<T>, threads,
                                                        smem);
    if (err != cudaSuccess) return err;
    if (blocks * threads > best.blocks_per_sm * best.threads) {
      best.threads = threads;
      best.blocks_per_sm = blocks;
      best.smem = smem;
    }
  }
  if (best.blocks_per_sm == 0) return cudaErrorInvalidConfiguration;
  best.device = device;
  best.n = n;
  cache[next] = best;
  next = (next + 1) % CACHE;
  *out = best;
  return cudaSuccess;
}

template <typename T>
int launch(const T* consts, int n_consts, int n, int steps, int land_heat, const T* geom,
           const T* scal, const T* ocean, const T* init, long long init_s0, long long init_s1,
           const T* vec, T* ocean_out, T* vec_out, long long B, void* stream) {
  Consts<T> g;
  if (n_consts != G_NSCALAR || steps < 1) return (int)cudaErrorInvalidValue;
  memcpy(&g, consts, sizeof(g));
  Config c;
  cudaError_t err = config<T>(n, &c);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return 0;
  const long long members_per_block = c.threads / 2;
  const long long blocks = (B + members_per_block - 1) / members_per_block;
  udeb_year_kernel<T><<<(unsigned)blocks, c.threads, c.smem, (cudaStream_t)stream>>>(
      g, n, steps, land_heat, geom, scal, ocean, init, init_s0, init_s1, vec, ocean_out,
      vec_out, B);
  return (int)cudaGetLastError();
}

template <typename T>
int query(int n, int* threads, int* blocks_per_sm, long long* smem) {
  Config c;
  const cudaError_t err = config<T>(n, &c);
  if (err != cudaSuccess) return (int)err;
  *threads = c.threads;
  *blocks_per_sm = c.blocks_per_sm;
  *smem = (long long)c.smem;
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

// The launch configuration at n layers: threads per block, resident blocks
// per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), shared bytes a block.
extern "C" int udeb_year_config_f32(int n, int* threads, int* blocks_per_sm, long long* smem) {
  return query<float>(n, threads, blocks_per_sm, smem);
}

extern "C" int udeb_year_config_f64(int n, int* threads, int* blocks_per_sm, long long* smem) {
  return query<double>(n, threads, blocks_per_sm, smem);
}

// The most layers the kernel takes in each dtype (see max_layers).
extern "C" int udeb_year_max_layers_f32() { return max_layers<float>(); }

extern "C" int udeb_year_max_layers_f64() { return max_layers<double>(); }
