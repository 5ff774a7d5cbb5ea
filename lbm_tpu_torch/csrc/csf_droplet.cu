// Kernel 13: one moment-space MRT + CSF static-droplet step,
// (20, R, C) -> (20, R, C), state [red f (9), blue f (9), fs (2)].
//
// Replaces the TPU kernel lbm_tpu/kernels/csf_droplet_pallas.py:66
// make_csf_droplet_fused_step.  The arithmetic is the plain version
// kernels/csf_droplet.py::make_plain_step, operation for operation in the
// same order, built with -fmad=false (kernels/_build.py UNIT_FLAGS), so the
// two agree bit for bit.  That matters more here than elsewhere: the normal
// is thresholded (|grad psi| >= 0.1), a discontinuous select that one ulp
// of |grad| can flip.
//
// Design: one thread per output cell, PUSH streaming (fully periodic: each
// thread writes its 18 post-collision values to the wrapped destinations, a
// bijection, so every entry has one writer), and one shared tile of derived
// scalars.  The stencil chain psi -> grad -> n -> grad n -> K is two 3x3
// stages, so a TY x TX block first computes, on the tile plus a halo of 2,
// psi and the correction fields q = (1.8 alpha - 0.8) rho_k u of both
// colours (stage 1), then the normal n on the tile plus a halo of 1 (stage
// 2), each stage ended by __syncthreads(); then each tile cell collides and
// pushes.  The window is indexed in "virtual" coordinates around the tile:
// virtual (vr, vc) holds the cell at global (wrap(vr), wrap(vc)), as the
// periodic stream needs; a stencil tap of that cell clamps in GLOBAL
// coordinates (replicate edges, gradients.correlate2d_replicate) and the
// clamped offset, which is -1, 0 or +1, is applied to the virtual index.
// So the stencils replicate at the global edges while the stream wraps,
// with no seam: lbm_tpu had to reconcile the two in its halo rows
// (csf_droplet_pallas.py:107-113).
//
// Bound: device-memory bytes.  160 B/cell in float32 (20 planes read once,
// 20 written once), 320 in float64, against 813 operations per cell
// counted on the plain version (chip_smoke.py phase 6).  What the design
// pays over that: the 20 planes of each halo cell are read again by the
// neighbour tiles (a 12x36 window for an 8x32 tile, from L2), the tile's
// own planes twice, two barriers per tile, and no multiply-add.

#include "mrtcg.cuh"

namespace {

using lbm::cx;
using lbm::cy;
using lbm::pair_km;
using lbm::pair_kp;
using lbm::THREADS;
using lbm::TX;
using lbm::TY;
using lbm::weight;
using lbm::wrap_any;
namespace mc = lbm::mrtcg;

constexpr int H = 2;  // psi's halo: n needs 1 more row than the tile, K 1 more
constexpr int VR = TY + 2 * H;
constexpr int VC = TX + 2 * H;
constexpr int VN = VR * VC;

// Scalars of the step, in the order kernels/csf_droplet.py::kernel_params
// writes them; COLOUR is the offset of the blue block of six.
enum P { INV_R0, INV_B0, DELTA, R_VAL, B_VAL, S1, S2, S3, T2, T3, HALF_SIGMA,
         C1, C2, A2, ACORR, PREF, BETA, NPARAM = BETA + 7 };
constexpr int COLOUR = 6;

template <typename T>
struct Params {
  T v[NPARAM];
};

// The driver's 3x3 kernels (ops/gradients.py KERNEL_X3 / KERNEL_Y3, the
// reference-swapped orientation: DIR 0 differentiates along the columns).
__host__ __device__ constexpr double k3(int dir, int a, int b) {
  constexpr double x[3][3] = {{3.0 * (-1.0 / 36.0), 3.0 * 0.0, 3.0 * (1.0 / 36.0)},
                              {3.0 * (-1.0 / 9.0), 3.0 * 0.0, 3.0 * (1.0 / 9.0)},
                              {3.0 * (-1.0 / 36.0), 3.0 * 0.0, 3.0 * (1.0 / 36.0)}};
  constexpr double y[3][3] = {{-3.0 * (1.0 / 36.0), -3.0 * (1.0 / 9.0), -3.0 * (1.0 / 36.0)},
                              {-3.0 * 0.0, -3.0 * 0.0, -3.0 * 0.0},
                              {-3.0 * (-1.0 / 36.0), -3.0 * (-1.0 / 9.0), -3.0 * (-1.0 / 36.0)}};
  return dir == 0 ? x[a][b] : y[a][b];
}

// 3x3 cross-correlation of a window field at virtual (vr, vc), the cell at
// global (gr, gc): taps in row-major order, zero weights skipped, each tap
// clamped at the global edges.
template <int DIR, typename T>
__device__ __forceinline__ T corr3(const T* field, int vr, int vc, int64_t gr, int64_t gc,
                                   int64_t R, int64_t C) {
  T acc = T(0);
  bool have = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int dr = static_cast<int>(mc::clamp_index(gr + a - 1, R) - gr);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const double wt = k3(DIR, a, b);
      if (wt == 0.0) continue;
      const int dc = static_cast<int>(mc::clamp_index(gc + b - 1, C) - gc);
      const T term = T(wt) * field[(vr + dr) * VC + (vc + dc)];
      acc = have ? acc + term : term;
      have = true;
    }
  }
  return acc;
}

// The macroscopic fields of one cell (csf_droplet_pallas.py:115-136).
template <typename T>
struct Cell {
  T rf[9], bf[9];
  T r_rho, b_rho, inv_rho, ux, uy, psi;
};

template <typename T>
__device__ __forceinline__ void load_cell(const T* __restrict__ in, int64_t n, int64_t cell,
                                          const Params<T>& p, Cell<T>& m) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    m.rf[k] = in[k * n + cell];
    m.bf[k] = in[(9 + k) * n + cell];
  }
  m.r_rho = m.rf[0];
  m.b_rho = m.bf[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    m.r_rho = m.r_rho + m.rf[k];
    m.b_rho = m.b_rho + m.bf[k];
  }
  const T rho = m.r_rho + m.b_rho;
  m.inv_rho = T(1.0) / rho;
  T ft[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) ft[k] = m.rf[k] + m.bf[k];
  const T mom_x = ft[1] - ft[3] + ft[5] - ft[6] - ft[7] + ft[8];
  const T mom_y = ft[2] - ft[4] + ft[5] + ft[6] - ft[7] - ft[8];
  m.ux = (mom_x + T(0.5) * in[18 * n + cell]) * m.inv_rho;
  m.uy = (mom_y + T(0.5) * in[19 * n + cell]) * m.inv_rho;
  const T a = m.r_rho * p.v[INV_R0];
  const T b = m.b_rho * p.v[INV_B0];
  m.psi = (a - b) / (a + b);
}

// s_nu = 1 / tau(psi), tau the relaxation function of the taus: three
// selects in models/mrt_cg.py's order, as comparisons, so a NaN stays a NaN.
template <typename T>
__device__ __forceinline__ T relax_tau(T psi, const Params<T>& p) {
  const T pos = p.v[S1] + p.v[S2] * psi + p.v[S3] * psi * psi;
  const T neg = p.v[S1] + p.v[T2] * psi + p.v[T3] * psi * psi;
  T out = psi > p.v[DELTA] ? p.v[R_VAL] : pos;
  out = psi <= T(0.0) ? neg : out;
  return psi < -p.v[DELTA] ? p.v[B_VAL] : out;
}

// Row `row` of M (or Mi) times `vec`, zero weights skipped, a weight of 1
// taken as the term itself; `have` marks the entries of vec that exist
// (csf_droplet.py::_mmul).
template <bool INVERSE, typename T>
__device__ __forceinline__ T mmul_row(int row, const T vec[9], unsigned have) {
  T acc = T(0);
  bool any = false;
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const double wt = INVERSE ? mc::mi_mrt(row, q) : mc::m_mrt(row, q);
    if (wt == 0.0 || !((have >> q) & 1u)) continue;
    const T term = wt == 1.0 ? vec[q] : T(wt) * vec[q];
    acc = any ? acc + term : term;
    any = true;
  }
  return acc;
}

constexpr unsigned ALL = 0x1FFu;
constexpr unsigned RELAXED = (1u << 1) | (1u << 2) | (1u << 4) | (1u << 6) | (1u << 7) | (1u << 8);

// One colour's post-collision populations (csf_droplet.py colour()).
template <typename T>
__device__ __forceinline__ void colour(const T f[9], T rho_k, T other_rho, T ratio, T ux, T uy,
                                       T uu, T s_nu, const T F_m[9], const T nc_p[4],
                                       const T* s_qx, const T* s_qy, int vr, int vc, int64_t gr,
                                       int64_t gc, int64_t R, int64_t C, const Params<T>& p,
                                       int off, T coll[9]) {
  T m[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) m[r] = mmul_row<false>(r, f, ALL);
  T meq[9];
  meq[1] = rho_k * (p.v[C1 + off] + T(3.0) * uu);
  meq[2] = rho_k * (p.v[C2 + off] - T(3.0) * uu);
  meq[4] = rho_k * (p.v[A2 + off] * ux);
  meq[6] = rho_k * (p.v[A2 + off] * uy);
  meq[7] = rho_k * (ux * ux - uy * uy);
  meq[8] = rho_k * (ux * uy);
  const T pref = p.v[PREF + off];
  T relaxed[9] = {};
  relaxed[1] = T(1.25) * (meq[1] - m[1] + pref * F_m[1]);
  relaxed[2] = T(1.14) * (meq[2] - m[2] + pref * F_m[2]);
  relaxed[4] = T(1.6) * (meq[4] - m[4] + pref * F_m[4]);
  relaxed[6] = T(1.6) * (meq[6] - m[6] + pref * F_m[6]);
  relaxed[7] = s_nu * (meq[7] - m[7] + pref * F_m[7]);
  relaxed[8] = s_nu * (meq[8] - m[8] + pref * F_m[8]);
  const T dqx = corr3<0>(s_qx, vr, vc, gr, gc, R, C);
  const T dqy = corr3<1>(s_qy, vr, vc, gr, gc, R, C);
  relaxed[1] = relaxed[1] + T(3.0 * (1.0 - 0.5 * 1.25)) * (dqx + dqy);
  relaxed[7] = relaxed[7] + (T(1.0) - T(0.5) * s_nu) * (dqx - dqy);
  T mrtp[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) mrtp[r] = mmul_row<true>(r, relaxed, RELAXED);
  const T br = p.v[BETA + off] * ratio * other_rho;
  coll[0] = f[0] + ratio * mrtp[0];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = pair_kp(i), km = pair_km(i);
    const T reco_odd = br * (T(weight(kp)) * (-nc_p[i]));
    coll[kp] = f[kp] + ratio * mrtp[kp] + reco_odd;
    coll[km] = f[km] + ratio * mrtp[km] - reco_odd;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    csf_droplet_kernel(const T* __restrict__ in, T* __restrict__ out, int64_t R, int64_t C,
                       const Params<T> p) {
  __shared__ T s_psi[VN], s_qxr[VN], s_qyr[VN], s_qxb[VN], s_qyb[VN], s_n0[VN], s_n1[VN];
  const int64_t n = R * C;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * TY;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * TX;
  const int tid = threadIdx.x;

  // stage 1: psi and the correction fields on the tile plus a halo of 2
  for (int i = tid; i < VN; i += THREADS) {
    const int vr = i / VC, vc = i % VC;
    const int64_t gr = wrap_any(r0 - H + vr, R), gc = wrap_any(c0 - H + vc, C);
    Cell<T> m;
    load_cell(in, n, gr * C + gc, p, m);
    s_psi[i] = m.psi;
    const T kr = p.v[ACORR] * m.r_rho, kb = p.v[ACORR + COLOUR] * m.b_rho;
    s_qxr[i] = kr * m.ux;
    s_qyr[i] = kr * m.uy;
    s_qxb[i] = kb * m.ux;
    s_qyb[i] = kb * m.uy;
  }
  __syncthreads();

  // stage 2: the thresholded inward normal on the tile plus a halo of 1
  for (int i = tid; i < (VR - 2) * (VC - 2); i += THREADS) {
    const int vr = 1 + i / (VC - 2), vc = 1 + i % (VC - 2);
    const int64_t gr = wrap_any(r0 - H + vr, R), gc = wrap_any(c0 - H + vc, C);
    const T g0 = corr3<0>(s_psi, vr, vc, gr, gc, R, C);
    const T g1 = corr3<1>(s_psi, vr, vc, gr, gc, R, C);
    const T gn = sqrt(g0 * g0 + g1 * g1);
    const T inv_safe = T(1.0) / (gn == T(0.0) ? T(1.0) : gn);
    const bool thr = gn >= T(1e-1);
    s_n0[vr * VC + vc] = -(thr ? g0 * inv_safe : T(0.0));
    s_n1[vr * VC + vc] = -(thr ? g1 * inv_safe : T(0.0));
  }
  __syncthreads();

  // stage 3: collide each tile cell and push
  const int ty = tid / TX, tx = tid % TX;
  const int64_t gr = r0 + ty, gc = c0 + tx;
  if (gr >= R || gc >= C) return;
  const int vr = ty + H, vc = tx + H;
  const int64_t cell = gr * C + gc;
  Cell<T> m;
  load_cell(in, n, cell, p, m);
  const T ux = m.ux, uy = m.uy;
  const T uu = ux * ux + uy * uy;
  const T s_nu = T(1.0) / relax_tau(m.psi, p);

  const T g0 = corr3<0>(s_psi, vr, vc, gr, gc, R, C);
  const T g1 = corr3<1>(s_psi, vr, vc, gr, gc, R, C);
  const T n0 = s_n0[vr * VC + vc], n1 = s_n1[vr * VC + vc];
  const T d0n0 = corr3<0>(s_n0, vr, vc, gr, gc, R, C);
  const T d1n0 = corr3<1>(s_n0, vr, vc, gr, gc, R, C);
  const T d0n1 = corr3<0>(s_n1, vr, vc, gr, gc, R, C);
  const T d1n1 = corr3<1>(s_n1, vr, vc, gr, gc, R, C);
  const T K = n0 * n1 * (d1n0 + d0n1) - n0 * n0 * d1n1 - n1 * n1 * d0n0;
  const T fsx = p.v[HALF_SIGMA] * (K * g0);
  const T fsy = p.v[HALF_SIGMA] * (K * g1);

  // the CSF force per direction, then in moment space
  const T cu_p[4] = {ux, uy, ux + uy, ux - uy};
  const T cF_p[4] = {fsx, fsy, fsx + fsy, fsx - fsy};
  const T uF3 = T(3.0) * (ux * fsx + uy * fsy);
  T Fq[9];
  Fq[0] = T(weight(0)) * (-uF3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T wk = T(weight(pair_kp(i)));
    const T even = wk * (T(9.0) * cu_p[i] * cF_p[i] - uF3);
    const T odd = wk * (T(3.0) * cF_p[i]);
    Fq[pair_kp(i)] = even + odd;
    Fq[pair_km(i)] = even - odd;
  }
  T F_m[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) F_m[r] = mmul_row<false>(r, Fq, ALL);
  const T nc_p[4] = {n0, n1, n0 + n1, n0 - n1};

  T coll_r[9], coll_b[9];
  colour(m.rf, m.r_rho, m.b_rho, m.r_rho * m.inv_rho, ux, uy, uu, s_nu, F_m, nc_p, s_qxr, s_qyr,
         vr, vc, gr, gc, R, C, p, 0, coll_r);
  colour(m.bf, m.b_rho, m.r_rho, m.b_rho * m.inv_rho, ux, uy, uu, s_nu, F_m, nc_p, s_qxb, s_qyb,
         vr, vc, gr, gc, R, C, p, COLOUR, coll_b);

  // fully periodic push; fs is carried, not streamed
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int64_t dst = wrap_any(gr + cx(k), R) * C + wrap_any(gc + cy(k), C);
    out[k * n + dst] = coll_r[k];
    out[(9 + k) * n + dst] = coll_b[k];
  }
  out[18 * n + cell] = fsx;
  out[19 * n + cell] = fsy;
}

template <typename T>
int launch(const void* in, void* out, long long R, long long C, const double* params,
           cudaStream_t stream) {
  if (R <= 0 || C <= 0) return 0;
  Params<T> p;
  for (int i = 0; i < NPARAM; ++i) p.v[i] = static_cast<T>(params[i]);
  const dim3 grid(static_cast<unsigned>((C + TX - 1) / TX),
                  static_cast<unsigned>((R + TY - 1) / TY));
  csf_droplet_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(in),
                                                       static_cast<T*>(out), R, C, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One step in -> out (distinct buffers) on `stream`; `params` are the
// NPARAM doubles of kernels/csf_droplet.py::kernel_params.  Returns the
// cudaError_t of the launch (0 = accepted).
extern "C" int lbm_csf_droplet(const void* in, void* out, long long R, long long C,
                               const double* params, int is_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(in, out, R, C, params, s)
                : launch<float>(in, out, R, C, params, s);
}
