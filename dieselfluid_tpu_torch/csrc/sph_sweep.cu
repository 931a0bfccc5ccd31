// SPH stencil sweeps over the dense cell planes, forward and backward, for
// sm_90a.
//
// Replaces the Pallas TPU kernel `_sweep` (dieselfluid_tpu/ops/pallas_sph.py,
// pallas_call at :370) in these instantiations:
//   density            _density_pair     (pallas_sph.py:454)
//   fused force        _force_fold_pair  (pallas_sph.py:564), with and
//                      without the viscosity term (mu == 0)
//   viscosity          _visc_pair        (pallas_sph.py:729)
//   prefolded pressure _press_pq_pair    (pallas_sph.py:806)
//   pressure           _press_pair       (pallas_sph.py:660, `_press_sum`):
//                      the fused force's mu == 0 pair with mass2 = 1, its
//                      pq folded as staged (ForceFold<false>)
//   and the backward sweeps `_density_sum_bwd` (:484), `_press_sum_bwd`
//   (:699), `_visc_sum_bwd` (:765) and the fused force's `_force_bwd`
//   (:624, with and without viscosity), whose pair functions the JAX
//   package derives with jax.vjp (`_bwd_pair`, :415) and which are written
//   out by hand here (DensityBwdPair, PressBwdFoldPair, ViscBwdPair,
//   ForceBwdPair);
//   and, gated per (x, y-patch) by an int32 activity grid (`_sweep`'s
//   `active=`, gate at :216-251), density, pressure and prefolded pressure:
//   `density_planes_active` (:855), `pressure_force_planes_active` (:862),
//   `pressure_force_pq_planes(active=)` (:825) — K10:
//   compact_sweep_kernel<Pair, true> for all three.
//
// Every sweep computes, for each occupied slot i of the (rows, sub, 128)
// float32 planes,
//     out_c[i] = mask_i * sum_j pair(own_i, cand_j)_c
// over the slots j of the 27 cells around i's cell. One templated kernel
// with a pair functor serves all of them. A backward pair for forward pair
// g returns  d_own g(u_i, u_j)^T ct_i + d_cand g(u_j, u_i)^T ct_j: the
// stencil is symmetric, so the adjoint is another gather, with no atomics.
//
// Layout (ops/cellops.py): row = (i+1)*py + (j+1), col = (k + z_block)*cap
// + rank. A z-cell's `cap` slots are contiguous, so the candidates of slot i
// in z-cell k are the 3*cap contiguous slots of cells k-1..k+1 in each of the
// 9 rows row + dx*py + dy. The ghost ring of rows and the ghost 128-slot
// block at each end of a row keep every index inside the plane.
//
// Candidate set: exactly the 27-cell stencil. (The Pallas kernel sweeps a
// 64/128-slot window widened by cap on each side and relies on d2 < h^2 to
// drop farther cells; under a fresh binning both sets give the same pairs.)
//
// The work: at the 1M-particle bench spec (101^3 cells, cap 16, sub 15,
// 10,609 rows) a plane is 81.5 MB, and 18,068 of its 132,613 interior
// 128-slot blocks hold a particle. The dam break has ~200M occupied
// candidate pairs (~200 per particle, of 432 candidate slots). A sweep's
// bound on the H100 is its bytes (the outputs written in full, the inputs
// read over occupied blocks: 0.057 ms for density, 0.11 ms for the
// prefolded pressure) for the forward sweeps, and its pair arithmetic
// (0.13-0.48 ms) for the fused force and the larger adjoints. Both bodies
// below sit far above that (PERF.md has the measured times).
//
// Two bodies. Outputs of slots a body does not write stay at the zeros the
// caller allocated. No fast-math: rsqrtf where the JAX pair uses
// lax.rsqrt, IEEE divides elsewhere. Every masked branch is a select, never
// a multiply by a mask, so no 0 * inf reaches an output.
//
// sweep_block (the backward sweeps K6, K7 in both forms, and K9): one
// 128-thread CTA per 128-slot own block of one row, launched for every
// interior block of every column; a CTA with no occupied own slot exits
// after reading its mask. Otherwise it stages the (128 + 2*cap)-slot window
// of the 9 stencil rows for every input channel in dynamic shared memory
// ([C][9][W] words, 69.1 KB for the fused force backward at cap 16, hence
// cudaFuncSetAttribute), and each thread sums the pair function over all
// its 9 x 3*cap candidate slots, occupied or not, masked by the candidate's
// mask channel. What holds it back (measured on K1-K5, K8 and K10,
// PERF.md): the grid of mostly empty CTAs, which reserve their shared
// memory; the 432 (cap 16) or 864 (cap 32) candidate iterations per thread
// whatever the occupancy; half of each warp idle on empty own slots; scalar
// staging. Its sweeps take 5-12 channels in.
//
// compact_sweep_kernel (K1 density, K2 fused force in both forms, K3
// viscosity, K4 prefolded pressure, K5 pressure, the pressure backward K8,
// and K10: K1, K4 and K5 gated): a persistent grid of as many 128-thread
// CTAs as fit on the SMs. Each fetches kBatch own blocks at a time from its
// launch's work counter (blocks fetch, fetch + n_fetch, ..., so one fetch
// spans the domain and the tail balances) and keeps those whose 128 own
// mask words hold an occupied slot (and, gated, whose column's canonical
// patch is active): no CTA is launched for an empty block. For a kept block
// it
//   * ranks the occupied own slots by ballots and maps them onto threads
//     0..n-1 in slot order, so warps are full;
//   * stages the 9-row window with one float4 load per input plane, and
//     stores each occupied candidate as one or two float4s (the pair's
//     channels but the mask: x y z [pq] for K1, K4, K5 and K2 at mu = 0;
//     x y z vx vy vz rho for K3, x y z vx vy vz pq iv for K2, x y z pq ct0
//     ct1 ct2 for K8) at [half][cell][rank], counting the cell's occupied
//     slots. K2, K5 and K8 read rho and press and fold pq (and K2 iv) as
//     they stage (ForceFold, PressBwdFold);
//   * sums each own slot's pair over only the occupied candidates: a
//     cell's occupied slots are its first ranks (dense_indices ranks by a
//     stable sort, build_planes writes exactly those slots, the solvers
//     keep the mask frozen), so the cell's count bounds the loop.
// Candidates are visited in sweep_block's order (stencil rows 0..8, then
// slots ascending) with the empty ones skipped. A skipped term adds +-0 to
// an accumulator that starts at +0, so each sum is bit for bit
// sweep_block's. The epilogue writes (acc * own_m) * scale: the mass (K1),
// mass^2 (K4, K5) or mu * mass (K3) the caller would apply, with the same
// two float32 roundings (K2 keeps mass^2 and mu * mass in its pair, K8 has
// none: scale 1). It writes only occupied own slots, so every slot whose
// mask is not > 0 keeps the caller's 0. Shared memory per CTA is 9 * ncw *
// cap * 16 bytes per float4 of a candidate (ncw = 128 / cap + 2): 23,040 B
// for one float4 at cap 16, 46,080 B for two. Each launch has its own work
// counter in memory the caller allocates zeroed; the last CTA to leave
// zeroes it again, so launches on different streams never share a walk.
//
// K5 on the fused force's pair: JAX's `_press_pair` sums (p_i / r_i^2 +
// p_j / r_j^2) * B q1^2 / d * d, r = max(rho, eps), which is term for term
// ForceFoldPair<false> with mass2 = 1 (the same live test, rsqrtf, dist / h
// and b * q1 * q1) on pq = p / r^2, and ForceFold<false> folds pq with
// press_coeff's roundings (a multiply and an IEEE divide, nothing to
// contract). mass2 * coeff with mass2 = 1 is exact, so the pair's terms are
// the old pressure pair's bit for bit; mass^2 is the epilogue's scale.
//
// K8 and the role swap. An adjoint pair reads the candidate's cotangent,
// rho and press when the own slot is the source (bb = near && own_mask > 0),
// whatever the candidate's mask. sweep_block visited empty candidates too;
// the compacted body skips them, which is exact because every such term is
// +-0 on the planes the callers pass: the cotangents at empty slots are 0
// on sweep_block's route (the wrapper masks them, as JAX's
// `_press_sum_bwd` does), rho is 0 there (density_planes writes only
// occupied slots, to_plane scatters into zeros) and so is press
// (dense_step.py's where(mask > 0, ., 0) and to_plane). Then e = 0, and
// every term is a product with e or with e.d. A non-zero press at an
// empty slot would make coeff = p_i / r_i^2 + p_j / eps^2 (eps^2 = 1e-24:
// 5e25 for p_j = 50); coeff * phi or 2 * coeff * dphi may then overflow to
// inf, and sweep_block's term becomes inf * 0 = NaN (p_j above ~3.4e14
// makes coeff itself inf). The compacted body reads no input, cotangents
// included, at an empty slot, so its wrapper masks neither the cotangents
// nor the outputs.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;       // own slots per CTA (= slots per sub row)
constexpr float kEps = 1e-12f;

// Sized per sweep: one struct as wide as the widest sweep (11 in, 7 out)
// made the 9-channel force kernel 15% slower on an H100 than with its own
// 9 + 3 pointers (tools/torch_serving_ab.py).
template <int kIn, int kOut>
struct SweepArgs {
  const float* in[kIn];
  float* out[kOut];
  int ny;    // interior cell columns in y
  int py;    // ny + 2
  int sub;   // 128-slot blocks per row, ghosts included
  int cap;   // slots per cell
};

// Pair functors: `o` and `c` hold the own and candidate channel values in
// the order the launcher passes the planes; results are added into `acc`.
// Each mirrors its plain torch pair (ops/sph_sweep.py) term for term.

struct DensityPair {  // x y z mask -> rho-sum (self term included)
  static constexpr int kIn = 4, kOut = 1, kMask = 3;
  float h2, a;
  __device__ __forceinline__ void operator()(const float* o, const float* c,
                                             float* acc) const {
    const float dx = c[0] - o[0], dy = c[1] - o[1], dz = c[2] - o[2];
    const float d2 = dx * dx + dy * dy + dz * dz;
    const float q = 1.0f - d2 / h2;
    const float w = (d2 < h2) ? a * q * q : 0.0f;
    acc[0] += w * c[kMask];
  }
};

template <bool kVisc>
struct ForceFoldPair {  // x y z [vx vy vz] mask pq [iv] -> fx fy fz
  static constexpr int kIn = kVisc ? 9 : 5, kOut = 3;
  static constexpr int kMask = kVisc ? 6 : 3, kPq = kMask + 1;
  float h, h2, b, cw, mass2, mu_mass;
  __device__ __forceinline__ void operator()(const float* o, const float* c,
                                             float* acc) const {
    const float dx = c[0] - o[0], dy = c[1] - o[1], dz = c[2] - o[2];
    const float d2 = dx * dx + dy * dy + dz * dz;
    const bool live = (d2 > kEps) && (d2 < h2) && (c[kMask] > 0.0f);
    const float inv_d = rsqrtf(live ? d2 : 1.0f);
    const float dist = d2 * inv_d;
    const float q1 = 1.0f - dist / h;
    const float o1d = b * q1 * q1;
    const float coeff = o[kPq] + c[kPq];
    const float s_p = live ? mass2 * coeff * o1d * inv_d : 0.0f;
    if constexpr (kVisc) {
      const float o2d = cw * q1;
      const float s_v = live ? mu_mass * o2d * c[kPq + 1] : 0.0f;  // iv
      acc[0] += s_p * dx + s_v * (c[3] - o[3]);
      acc[1] += s_p * dy + s_v * (c[4] - o[4]);
      acc[2] += s_p * dz + s_v * (c[5] - o[5]);
    } else {
      acc[0] += s_p * dx;
      acc[1] += s_p * dy;
      acc[2] += s_p * dz;
    }
  }
};

struct ViscPair {  // x y z vx vy vz mask rho -> 3 (mu*mass: the scale)
  static constexpr int kIn = 8, kOut = 3, kMask = 6, kRho = 7;
  float h, h2, cw;
  __device__ __forceinline__ void operator()(const float* o, const float* c,
                                             float* acc) const {
    const float dx = c[0] - o[0], dy = c[1] - o[1], dz = c[2] - o[2];
    const float d2 = dx * dx + dy * dy + dz * dz;
    const bool live = (d2 > kEps) && (d2 < h2) && (c[kMask] > 0.0f);
    const float inv_d = rsqrtf(live ? d2 : 1.0f);
    const float dist = d2 * inv_d;
    const float rho_j = fmaxf(c[kRho], kEps);
    const float o2d = cw * (1.0f - dist / h);
    const float s_v = live ? o2d / rho_j : 0.0f;
    acc[0] += s_v * (c[3] - o[3]);
    acc[1] += s_v * (c[4] - o[4]);
    acc[2] += s_v * (c[5] - o[5]);
  }
};

struct PressPqPair {  // x y z mask pq -> 3 (mass^2: the scale)
  static constexpr int kIn = 5, kOut = 3, kMask = 3, kPq = 4;
  float h2, inv_h, b;
  __device__ __forceinline__ void operator()(const float* o, const float* c,
                                             float* acc) const {
    const float dx = c[0] - o[0], dy = c[1] - o[1], dz = c[2] - o[2];
    const float d2 = dx * dx + dy * dy + dz * dz;
    const bool live = (d2 > kEps) && (d2 < h2) && (c[kMask] > 0.0f);
    const float inv_d = rsqrtf(live ? d2 : 1.0f);
    const float q1 = 1.0f - d2 * inv_d * inv_h;
    const float s_p = live ? (o[kPq] + c[kPq]) * (b * q1 * q1) * inv_d : 0.0f;
    acc[0] += s_p * dx;
    acc[1] += s_p * dy;
    acc[2] += s_p * dz;
  }
};

// p_i / max(rho_i, eps)^2 + p_j / max(rho_j, eps)^2 (the pressure adjoint's
// coeff; K5's forward and the folded K8 fold each term as they stage it).
__device__ __forceinline__ float press_coeff(float rho_i, float p_i,
                                             float rho_j, float p_j) {
  return p_i / (rho_i * rho_i) + p_j / (rho_j * rho_j);
}

// value * d max(x, eps)/dx, with jnp.maximum's half at the tie.
__device__ __forceinline__ float max_eps_grad(float x, float value) {
  return (x > kEps) ? value : ((x == kEps) ? 0.5f * value : 0.0f);
}

// Backward pairs. `a` marks the pair live with own as receiver (cand's
// mask), `bb` with own as source (own's mask: the role swap).

// For W(d2) m_j both roles give W'(d2) (-2 d) (ct_i m_j + ct_j m_i) with
// W' = -2 A q / h^2; the self pair has d = 0.
struct DensityBwdPair {  // x y z mask ct -> dx dy dz
  static constexpr int kIn = 5, kOut = 3, kMask = 3, kCt = 4;
  float h2, a;
  __device__ __forceinline__ void operator()(const float* o, const float* c,
                                             float* acc) const {
    const float dx = c[0] - o[0], dy = c[1] - o[1], dz = c[2] - o[2];
    const float d2 = dx * dx + dy * dy + dz * dz;
    const float q = 1.0f - d2 / h2;
    const float s = (d2 < h2) ? (4.0f * a / h2) * q *
                                    (o[kCt] * c[kMask] + c[kCt] * o[kMask])
                              : 0.0f;
    acc[0] += s * dx;
    acc[1] += s * dy;
    acc[2] += s * dz;
  }
};

// The two adjoints below are written once, as terms over channel positions
// (input mask, rho, press and first cotangent; output rho and press), with
// the positions x y z at 0..2 and the velocities at 3..5, in and out. Each
// adds `s` times its gradients into `acc`: the sweeps K8 and K9 take s = 1,
// the fused force's adjoint (K7) takes s = mass^2 and s = mu * mass.

// g = coeff * phi(d2) * d, phi = B q1^2 / r. With e = bb ct_j - a ct_i:
//   d/dx_i = coeff (2 phi'(d2) (e.d) d + phi e)
//   d/dp_i = -phi (e.d) / rho_i^2,  d/drho_i = 2 phi (e.d) p_i / rho_i^3.
// coeff = p_i / max(rho_i, eps)^2 + p_j / max(rho_j, eps)^2, formed from
// both slots' rho and press at kRho and kPress, or, where kPq >= 0, as
// pq_i + pq_j from pq = p / max(rho, eps)^2 folded as staged (which rounds
// as press_coeff; kRho and kPress then index the own slot's raw values).
template <int kMask, int kRho, int kPress, int kCt, int kOutRho, int kOutPress,
          int kPq = -1>
struct PressBwdTerms {
  float h, h2, b;
  __device__ __forceinline__ void operator()(const float* o, const float* c,
                                             float s, float* acc) const {
    const float dx = c[0] - o[0], dy = c[1] - o[1], dz = c[2] - o[2];
    const float d2 = dx * dx + dy * dy + dz * dz;
    const bool near = (d2 > kEps) && (d2 < h2);
    const bool a = near && (c[kMask] > 0.0f);
    const bool bb = near && (o[kMask] > 0.0f);
    const float inv_d = rsqrtf(near ? d2 : 1.0f);
    const float dist = d2 * inv_d;
    const float q1 = 1.0f - dist / h;
    const float o1d = b * q1 * q1;
    const float phi = o1d * inv_d;
    const float inv_d2 = inv_d * inv_d;
    const float dphi = -(b / h) * q1 * inv_d2 - 0.5f * o1d * inv_d2 * inv_d;
    const float rho_i = fmaxf(o[kRho], kEps);
    float coeff;
    if constexpr (kPq < 0)
      coeff = press_coeff(rho_i, o[kPress], fmaxf(c[kRho], kEps), c[kPress]);
    else
      coeff = o[kPq] + c[kPq];
    const float ex = (bb ? c[kCt] : 0.0f) - (a ? o[kCt] : 0.0f);
    const float ey = (bb ? c[kCt + 1] : 0.0f) - (a ? o[kCt + 1] : 0.0f);
    const float ez = (bb ? c[kCt + 2] : 0.0f) - (a ? o[kCt + 2] : 0.0f);
    const float ed = ex * dx + ey * dy + ez * dz;
    const float g = 2.0f * coeff * dphi * ed;
    const float sp = coeff * phi;
    const float t = phi * ed;
    const float inv_r2 = 1.0f / (rho_i * rho_i);
    acc[0] += s * (g * dx + sp * ex);
    acc[1] += s * (g * dy + sp * ey);
    acc[2] += s * (g * dz + sp * ez);
    acc[kOutRho] +=
        s * max_eps_grad(o[kRho], 2.0f * t * o[kPress] * inv_r2 / rho_i);
    acc[kOutPress] += s * (-t * inv_r2);
  }
};

// g = o2d(d2) / rho_j * (v_j - v_i). With e = bb ct_j / rho_i - a ct_i /
// rho_j:  d/dx_i = 2 o2d'(d2) (e.dv) d,  d/dv_i = o2d e,
// d/drho_i = bb o2d (ct_j.dv) / rho_i^2 (i's rho as the source's).
template <int kMask, int kRho, int kCt, int kOutRho>
struct ViscBwdTerms {
  float h, h2, cw;
  __device__ __forceinline__ void operator()(const float* o, const float* c,
                                             float s, float* acc) const {
    const float dx = c[0] - o[0], dy = c[1] - o[1], dz = c[2] - o[2];
    const float d2 = dx * dx + dy * dy + dz * dz;
    const bool near = (d2 > kEps) && (d2 < h2);
    const bool a = near && (c[kMask] > 0.0f);
    const bool bb = near && (o[kMask] > 0.0f);
    const float inv_d = rsqrtf(near ? d2 : 1.0f);
    const float dist = d2 * inv_d;
    const float o2d = cw * (1.0f - dist / h);
    const float do2d = -0.5f * (cw / h) * inv_d;
    const float inv_ri = 1.0f / fmaxf(o[kRho], kEps);
    const float inv_rj = 1.0f / fmaxf(c[kRho], kEps);
    const float ex = (bb ? c[kCt] * inv_ri : 0.0f) - (a ? o[kCt] * inv_rj : 0.0f);
    const float ey =
        (bb ? c[kCt + 1] * inv_ri : 0.0f) - (a ? o[kCt + 1] * inv_rj : 0.0f);
    const float ez =
        (bb ? c[kCt + 2] * inv_ri : 0.0f) - (a ? o[kCt + 2] * inv_rj : 0.0f);
    const float dvx = c[3] - o[3], dvy = c[4] - o[4], dvz = c[5] - o[5];
    const float g = 2.0f * do2d * (ex * dvx + ey * dvy + ez * dvz);
    const float wdv =
        bb ? (c[kCt] * dvx + c[kCt + 1] * dvy + c[kCt + 2] * dvz) * inv_ri
           : 0.0f;
    acc[0] += s * (g * dx);
    acc[1] += s * (g * dy);
    acc[2] += s * (g * dz);
    acc[3] += s * (o2d * ex);
    acc[4] += s * (o2d * ey);
    acc[5] += s * (o2d * ez);
    acc[kOutRho] += s * max_eps_grad(o[kRho], o2d * wdv * inv_ri);
  }
};

// K8, on the compacted body with each candidate's pq = p / max(rho, eps)^2
// folded as staged (PressBwdFold): x y z mask pq ct0..2, and after them the
// own slot's raw rho and press, read once per own slot. coeff = pq_i + pq_j
// rounds as press_coeff, so the sums are those of the pair on raw rho and
// press (PressBwdTerms<3, 4, 5, 6, 3, 4>, which K8 ran on sweep_block) bit
// for bit, with one IEEE divide a pair fewer; staging raw rho and press
// took 13% longer on an H100 (PERF.md). nvcc hoists the own slot's p_i /
// r_i^2 and 1 / r_i^2 out of the candidate loop: two divides a pair
// remain, dist / h and the drho term's / rho_i.
struct PressBwdFoldPair {  // x y z mask pq ct0..2 [own rho press] -> 5
  static constexpr int kIn = 8, kOut = 5, kMask = 3;
  PressBwdTerms<3, 8, 9, 5, 3, 4, 4> terms;
  __device__ __forceinline__ void operator()(const float* o, const float* c,
                                             float* acc) const {
    terms(o, c, 1.0f, acc);
  }
};

struct ViscBwdPair {  // x y z vx vy vz mask rho ct0..2 -> 7
  static constexpr int kIn = 11, kOut = 7, kMask = 6;
  ViscBwdTerms<6, 7, 8, 6> terms;
  __device__ __forceinline__ void operator()(const float* o, const float* c,
                                             float* acc) const {
    terms(o, c, 1.0f, acc);
  }
};

// The adjoint of the unfolded fused force pair (JAX `_force_pair`, K7). That
// pair is exactly mass^2 * the pressure pair + mu * mass * the viscosity
// pair, with the same live test and eps clamps, so its adjoint is the two
// adjoints scaled and summed: x, y, z and rho take both, v the viscosity
// part, press the pressure part. kVisc = false is the mu == 0 form, which
// reads no velocities.
template <bool kVisc>
struct ForceBwdPair;

template <>
struct ForceBwdPair<true> {  // x y z vx vy vz mask rho press ct0..2 -> 8
  static constexpr int kIn = 12, kOut = 8, kMask = 6;
  PressBwdTerms<6, 7, 8, 9, 6, 7> press;
  ViscBwdTerms<6, 7, 9, 6> visc;
  float mass2, mu_mass;
  __device__ __forceinline__ void operator()(const float* o, const float* c,
                                             float* acc) const {
    press(o, c, mass2, acc);
    visc(o, c, mu_mass, acc);
  }
};

template <>
struct ForceBwdPair<false> {  // x y z mask rho press ct0..2 -> 5
  static constexpr int kIn = 9, kOut = 5, kMask = 3;
  PressBwdTerms<3, 4, 5, 6, 3, 4> press;
  float mass2;
  __device__ __forceinline__ void operator()(const float* o, const float* c,
                                             float* acc) const {
    press(o, c, mass2, acc);
  }
};

// The body of one CTA: the 128-slot own block blockIdx.y + 1 of the cell
// column blockIdx.x.
template <class Pair>
__device__ __forceinline__ void sweep_block(
    const Pair pair, const SweepArgs<Pair::kIn, Pair::kOut> args) {
  constexpr int C = Pair::kIn;
  extern __shared__ float smem[];  // [C][9][W]

  const int cap = args.cap;
  const int W = kBlock + 2 * cap;
  const int col = blockIdx.x;
  const int row = (col / args.ny + 1) * args.py + (col % args.ny + 1);
  const long long row_len = static_cast<long long>(args.sub) * kBlock;
  const int lo = kBlock * (blockIdx.y + 1);      // first own slot in the row
  const int t = threadIdx.x;
  const long long own_idx = row * row_len + lo + t;

  const float own_m = args.in[Pair::kMask][own_idx];
  if (!__syncthreads_or(own_m > 0.0f)) return;

  // Stage the 9 stencil rows' window [lo - cap, lo + 128 + cap).
  for (int e = t; e < 9 * W; e += kBlock) {
    const int s = e / W;
    const int w = e - s * W;
    const int nrow = row + (s / 3 - 1) * args.py + (s % 3 - 1);
    const long long g = nrow * row_len + (lo - cap) + w;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) smem[(ch * 9 + s) * W + w] = args.in[ch][g];
  }
  __syncthreads();
  if (!(own_m > 0.0f)) return;

  float own[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) own[ch] = smem[(ch * 9 + 4) * W + cap + t];

  float acc[Pair::kOut];
#pragma unroll
  for (int o = 0; o < Pair::kOut; ++o) acc[o] = 0.0f;

  // Window offset of the first slot of cell k-1 for own cell k.
  const int base = (t / cap) * cap;
  const int span = 3 * cap;
  for (int s = 0; s < 9; ++s) {
    for (int w = base; w < base + span; ++w) {
      float cand[C];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) cand[ch] = smem[(ch * 9 + s) * W + w];
      pair(own, cand, acc);
    }
  }
#pragma unroll
  for (int o = 0; o < Pair::kOut; ++o) args.out[o][own_idx] = acc[o] * own_m;
}

// grid = (nx * ny interior columns, sub - 2 interior blocks), block = 128.
template <class Pair>
__global__ void __launch_bounds__(kBlock)
sweep_kernel(const Pair pair, const SweepArgs<Pair::kIn, Pair::kOut> args) {
  sweep_block(pair, args);
}

// K10, the active-gated sweeps (JAX `_sweep(..., active=)`, pallas_sph.py:107,
// gate at :216-251): the PCISPH convergence-gated loop re-sweeps only the
// (x, y-patch) cells of an int32 grid, one entry per patch of `patch` =
// min(8, ny) consecutive y-columns at one x, `nyp` = ceil(ny / patch)
// patches per x (JAX active_patch_shape). A column is gated by its canonical
// patch y / patch. (JAX's last grid program is clamped to cover columns
// [ny - P, ny) and so sweeps some columns twice, with the same values; its
// callers select each column by the canonical patch, as this gate does.)
struct ActiveGate {
  const int* active;
  int nyp;
  int patch;
};

template <class Pair, class Kernel, class... Extra>
int launch_kernel(Kernel kernel, const Pair& pair, const float* const* in,
                  float* const* out, int nx, int ny, int sub, int cap,
                  void* stream, Extra... extra) {
  SweepArgs<Pair::kIn, Pair::kOut> args{};
  for (int i = 0; i < Pair::kIn; ++i) args.in[i] = in[i];
  for (int o = 0; o < Pair::kOut; ++o) args.out[o] = out[o];
  args.ny = ny;
  args.py = ny + 2;
  args.sub = sub;
  args.cap = cap;
  const int smem = Pair::kIn * 9 * (kBlock + 2 * cap) *
                   static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(nx * ny),
                  static_cast<unsigned>(sub - 2));
  kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      pair, args, extra...);
  return static_cast<int>(cudaGetLastError());
}

template <class Pair>
int launch(const Pair& pair, const float* const* in, float* const* out,
           int nx, int ny, int sub, int cap, void* stream) {
  return launch_kernel(sweep_kernel<Pair>, pair, in, out, nx, ny, sub, cap,
                       stream);
}

// ---------------------------------------------------------------------------
// The compacted body: K1-K5, K8 and the gated K1/K4/K5 (see the header).
// ---------------------------------------------------------------------------

// Tuning, each the faster of the variants tools/torch_sweep_variants.py
// timed on an H100 (PERF.md): 8 own blocks per work fetch (16 and 32 were
// slower); no padding after a staged cell (a float4 of pad puts
// neighbouring cells' candidates on other banks but costs a CTA per SM:
// 5% slower); the candidate loop unrolled by 4 (overlaps independent
// pairs; 2 was slower for density); a two-float4 candidate's halves in two
// arrays, [half][cell][rank] (kInterleave false), not side by side.
constexpr int kBatch = 8;       // own blocks per work fetch
constexpr int kCellPad = 0;     // float4s of padding after each staged cell
constexpr bool kInterleave = false;
constexpr int kWarps = kBlock / 32;

// How the compacted body stages a candidate. Of the `kIn` input planes the
// mask is at `kMask`; the others, in order, fold into `kVals` floats: the
// pair functor's channels without its mask. `own` reads `kOwn` more values
// of the own slot from the input planes, which the pair finds after its
// channels (none but for PressBwdFold).
template <class Pair>
struct AsIs {
  static constexpr int kIn = Pair::kIn, kMask = Pair::kMask,
                       kVals = Pair::kIn - 1, kOwn = 0;
  static __device__ __forceinline__ void fold(const float* raw, float* v) {
#pragma unroll
    for (int i = 0; i < kVals; ++i) v[i] = raw[i];
  }
  static __device__ __forceinline__ void own(const float* const*, long long,
                                             float*) {}
};

// K2: x y z [vx vy vz] mask rho press in; pq = press / max(rho, eps)^2 and
// iv = 1 / max(rho, eps) folded per staged slot, a multiply and IEEE
// divides rounded as ops/sph_sweep.py's _fold_force rounds them, so no
// plane of pq or iv is built.
template <bool kVisc>
struct ForceFold {
  static constexpr int kMask = ForceFoldPair<kVisc>::kMask, kIn = kMask + 3,
                       kVals = ForceFoldPair<kVisc>::kIn - 1, kOwn = 0;
  static __device__ __forceinline__ void fold(const float* raw, float* v) {
#pragma unroll
    for (int i = 0; i < kMask; ++i) v[i] = raw[i];
    const float r = fmaxf(raw[kMask], kEps);
    v[kMask] = raw[kMask + 1] / (r * r);
    if constexpr (kVisc) v[kMask + 1] = 1.0f / r;
  }
  static __device__ __forceinline__ void own(const float* const*, long long,
                                             float*) {}
};

// K8 folded: x y z mask rho press ct0..2 in; each candidate staged as x y z
// pq ct0..2 (pq rounded as ForceFold's), and the own slot's raw rho and
// press read from their planes for the drho and dpress terms.
struct PressBwdFold {
  static constexpr int kIn = 9, kMask = 3, kVals = 7, kOwn = 2;
  static __device__ __forceinline__ void fold(const float* raw, float* v) {
    v[0] = raw[0];
    v[1] = raw[1];
    v[2] = raw[2];
    const float r = fmaxf(raw[3], kEps);
    v[3] = raw[4] / (r * r);
    v[4] = raw[5];
    v[5] = raw[6];
    v[6] = raw[7];
  }
  static __device__ __forceinline__ void own(const float* const* in,
                                             long long idx, float* e) {
    e[0] = in[4][idx];
    e[1] = in[5][idx];
  }
};

struct CompactGeom {
  long long n_items;   // nx * ny * (sub - 2) own blocks
  unsigned n_fetch;    // ceil(n_items / kBatch)
  int lcap;            // log2(cap)
  int ncw;             // window cells per stencil row: 128 / cap + 2
  int margin;          // slots staged before the own block: max(cap, 4)
  int w4;              // float4 chunks per stencil row
};

// Float4s per staged candidate: one for up to 4 values, two for up to 8.
template <class Stage>
__host__ __device__ constexpr int n_vec() { return (Stage::kVals + 3) / 4; }

// Shared-memory float4 index of half `k` of the candidate at `cell`, `rank`
// (cs = cap + kCellPad float4s per cell, n_cells = 9 * ncw).
template <int NV>
__device__ __forceinline__ int cand_at(int k, int cell, int rank, int cs,
                                       int n_cells) {
  if constexpr (kInterleave) return (cell * cs + rank) * NV + k;
  return k * n_cells * cs + cell * cs + rank;
}

__device__ __forceinline__ float lane_of(const float4& a, int j) {
  return j == 0 ? a.x : (j == 1 ? a.y : (j == 2 ? a.z : a.w));
}

// A staged candidate (NV float4s, the pair's channels but the mask, in
// order) into the pair's channel array; the mask reads 1 (every staged
// candidate is occupied).
template <class Pair, int NV>
__device__ __forceinline__ void unpack(const float4* q, float* c) {
  float f[4 * NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    f[4 * k] = q[k].x;
    f[4 * k + 1] = q[k].y;
    f[4 * k + 2] = q[k].z;
    f[4 * k + 3] = q[k].w;
  }
#pragma unroll
  for (int i = 0; i < Pair::kIn - 1; ++i)
    c[i < Pair::kMask ? i : i + 1] = f[i];
  c[Pair::kMask] = 1.0f;
}

// One own block at `off` (row * row_len + lo): rank, stage, sum, write.
// Starts and ends with every thread past a barrier.
template <class Pair, class Stage>
__device__ __forceinline__ void compact_block(
    const Pair& pair, const SweepArgs<Stage::kIn, Pair::kOut>& args,
    const CompactGeom& geo, float scale, long long off, float4* cand,
    int* cnt, long long* row_off, int* own_slot, float* own_mask,
    int* warp_count) {
  constexpr int NV = n_vec<Stage>();
  constexpr int kRaw = Stage::kIn - 1;     // input planes but the mask
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int cap = args.cap, cs = cap + kCellPad, ncw = geo.ncw;
  const int n_cells = 9 * ncw;
  const long long row_len = static_cast<long long>(args.sub) * kBlock;
  const float* mask = args.in[Stage::kMask];

  const float own_m = mask[off + t];
  const bool occ = own_m > 0.0f;
  const unsigned bal = __ballot_sync(0xffffffffu, occ);
  if (lane == 0) warp_count[warp] = __popc(bal);
  for (int i = t; i < n_cells; i += kBlock) cnt[i] = 0;
  if (t < 9)
    row_off[t] = off - geo.margin +
                 static_cast<long long>((t / 3 - 1) * args.py + (t % 3 - 1)) *
                     row_len;
  __syncthreads();

  int n_own = 0, first = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_count[w];
    first += (w < warp) ? c : 0;
    n_own += c;
  }
  if (occ) {
    const int pos = first + __popc(bal & ((1u << lane) - 1u));
    own_slot[pos] = t;
    own_mask[pos] = own_m;
  }

  // Stage: chunk e = t + i * 128 of the 9 * w4 float4 chunks is row s = e /
  // w4, chunk w = e % w4, walked without a divide. One float4 load per
  // input plane; each occupied slot in the window is folded and stored as
  // NV float4s.
  const int w4 = geo.w4, skew = geo.margin - cap, win = kBlock + 2 * cap;
  const int dq = kBlock / w4, dr = kBlock - dq * w4;
  int s = t / w4, w = t - (t / w4) * w4;
  while (s < 9) {
    const long long g = row_off[s] + 4 * w;
    const float4 m4 = *reinterpret_cast<const float4*>(mask + g);
    float4 ch[kRaw];
#pragma unroll
    for (int i = 0; i < kRaw; ++i)
      ch[i] = *reinterpret_cast<const float4*>(
          args.in[i < Stage::kMask ? i : i + 1] + g);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = 4 * w + j - skew;           // slot in the stencil window
      if (lane_of(m4, j) > 0.0f && p >= 0 && p < win) {
        float raw[kRaw], v[4 * NV];
#pragma unroll
        for (int i = 0; i < kRaw; ++i) raw[i] = lane_of(ch[i], j);
#pragma unroll
        for (int i = Stage::kVals; i < 4 * NV; ++i) v[i] = 0.0f;
        Stage::fold(raw, v);
        const int cell = s * ncw + (p >> geo.lcap);
        const int rank = p & (cap - 1);
#pragma unroll
        for (int k = 0; k < NV; ++k)
          cand[cand_at<NV>(k, cell, rank, cs, n_cells)] =
              make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
        atomicAdd(&cnt[cell], 1);
      }
    }
    w += dr;
    s += dq;
    if (w >= w4) {
      w -= w4;
      ++s;
    }
  }
  __syncthreads();

  if (t < n_own) {
    const int slot = own_slot[t];
    const int kw = (slot >> geo.lcap) + 1;     // own cell in the window
    float o[Pair::kIn + Stage::kOwn];
    {
      float4 q[NV];
#pragma unroll
      for (int k = 0; k < NV; ++k)
        q[k] = cand[cand_at<NV>(k, 4 * ncw + kw, slot & (cap - 1), cs,
                                n_cells)];
      unpack<Pair, NV>(q, o);
      Stage::own(args.in, off + slot, o + Pair::kIn);
    }
    float acc[Pair::kOut];
#pragma unroll
    for (int q = 0; q < Pair::kOut; ++q) acc[q] = 0.0f;
    for (int r = 0; r < 9; ++r) {
      for (int dz = 0; dz < 3; ++dz) {
        const int cell = r * ncw + kw - 1 + dz;
        const int n = cnt[cell];
#pragma unroll 4
        for (int j = 0; j < n; ++j) {
          float4 q[NV];
#pragma unroll
          for (int k = 0; k < NV; ++k)
            q[k] = cand[cand_at<NV>(k, cell, j, cs, n_cells)];
          float c[Pair::kIn];
          unpack<Pair, NV>(q, c);
          pair(o, c, acc);
        }
      }
    }
    const float m = own_mask[t];
#pragma unroll
    for (int q = 0; q < Pair::kOut; ++q)
      args.out[q][off + slot] = (acc[q] * m) * scale;
  }
  __syncthreads();
}

// `work` is this launch's counter [fetch, CTAs done], zero when the launch
// starts; the last CTA to leave sets it to zero again.
template <class Pair, bool kGated, class Stage>
__global__ void __launch_bounds__(kBlock)
compact_sweep_kernel(const Pair pair,
                     const SweepArgs<Stage::kIn, Pair::kOut> args,
                     const CompactGeom geo, const ActiveGate gate,
                     float scale, unsigned* work) {
  static_assert(Stage::kVals == Pair::kIn - 1,
                "the staged values are the pair's channels but the mask");
  static_assert(Stage::kVals <= 8, "candidates must fit two float4s");
  extern __shared__ float4 smem4[];
  __shared__ long long item_off[kBatch];
  __shared__ long long row_off[9];
  __shared__ int own_slot[kBlock];
  __shared__ float own_mask[kBlock];
  __shared__ int warp_count[kWarps];
  __shared__ unsigned fetch_s, keep_s;

  float4* cand = smem4;
  int* cnt = reinterpret_cast<int*>(
      smem4 + n_vec<Stage>() * 9 * geo.ncw * (args.cap + kCellPad));
  const int t = threadIdx.x;
  const float* mask = args.in[Stage::kMask];
  const long long row_len = static_cast<long long>(args.sub) * kBlock;

  for (;;) {
    if (t == 0) {
      fetch_s = atomicAdd(&work[0], 1u);
      keep_s = 0u;
    }
    __syncthreads();
    const unsigned fetch = fetch_s;
    if (fetch >= geo.n_fetch) break;
    if (t < kBatch) {
      const long long id = fetch + static_cast<long long>(t) * geo.n_fetch;
      long long off = -1;
      if (id < geo.n_items) {
        const int nblk = args.sub - 2;
        const long long col = id / nblk;
        const int blk = static_cast<int>(id - col * nblk);
        const int cx = static_cast<int>(col / args.ny);
        const int cy = static_cast<int>(col - static_cast<long long>(cx) *
                                                  args.ny);
        bool on = true;
        if constexpr (kGated)
          on = gate.active[cx * gate.nyp + cy / gate.patch] != 0;
        if (on)
          off = (static_cast<long long>(cx + 1) * args.py + cy + 1) *
                    row_len + static_cast<long long>(kBlock) * (blk + 1);
      }
      item_off[t] = off;
    }
    __syncthreads();
    unsigned keep = 0u;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const long long off = item_off[j];
      if (off >= 0 && mask[off + t] > 0.0f) keep |= 1u << j;
    }
    keep = __reduce_or_sync(0xffffffffu, keep);
    if ((t & 31) == 0) atomicOr(&keep_s, keep);
    __syncthreads();
    keep = keep_s;
    while (keep) {
      const int j = __ffs(keep) - 1;
      keep &= keep - 1u;
      compact_block<Pair, Stage>(pair, args, geo, scale, item_off[j], cand,
                                 cnt, row_off, own_slot, own_mask,
                                 warp_count);
    }
    __syncthreads();
  }
  if (t == 0) {
    __threadfence();
    if (atomicAdd(&work[1], 1u) == gridDim.x - 1) {
      work[0] = 0u;
      work[1] = 0u;
      __threadfence();
    }
  }
}

constexpr ActiveGate kNoGate{nullptr, 1, 1};

// The dynamic shared memory of one compacted instantiation at `cap`, set
// as its limit, and how many of its CTAs fit on an SM.
template <class Pair, bool kGated, class Stage>
cudaError_t compact_occupancy(int cap, int* smem, int* per_sm) {
  const int ncw = kBlock / cap + 2;
  *smem = 9 * ncw * (n_vec<Stage>() * (cap + kCellPad) *
                         static_cast<int>(sizeof(float4)) +
                     static_cast<int>(sizeof(int)));
  auto kernel = compact_sweep_kernel<Pair, kGated, Stage>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kBlock, *smem);
}

template <class Pair, bool kGated, class Stage = AsIs<Pair>>
int launch_compact(const Pair& pair, const float* const* in,
                   float* const* out, int nx, int ny, int sub, int cap,
                   float scale, unsigned* work, const ActiveGate gate,
                   void* stream) {
  SweepArgs<Stage::kIn, Pair::kOut> args{};
  for (int i = 0; i < Stage::kIn; ++i) args.in[i] = in[i];
  for (int o = 0; o < Pair::kOut; ++o) args.out[o] = out[o];
  args.ny = ny;
  args.py = ny + 2;
  args.sub = sub;
  args.cap = cap;
  CompactGeom geo{};
  while ((1 << geo.lcap) < cap) ++geo.lcap;
  geo.ncw = kBlock / cap + 2;
  geo.margin = cap < 4 ? 4 : cap;
  geo.w4 = (kBlock + 2 * geo.margin) / 4;
  geo.n_items = static_cast<long long>(nx) * ny * (sub - 2);
  geo.n_fetch = static_cast<unsigned>((geo.n_items + kBatch - 1) / kBatch);
  if (geo.n_items <= 0) return static_cast<int>(cudaSuccess);
  int smem = 0, dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err;
  if ((err = compact_occupancy<Pair, kGated, Stage>(cap, &smem, &per_sm)) !=
          cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long grid = static_cast<long long>(per_sm) * n_sm;
  if (grid > geo.n_fetch) grid = geo.n_fetch;
  auto kernel = compact_sweep_kernel<Pair, kGated, Stage>;
  kernel<<<static_cast<unsigned>(grid), kBlock, smem,
           static_cast<cudaStream_t>(stream)>>>(pair, args, geo, gate,
                                                scale, work);
  return static_cast<int>(cudaGetLastError());
}

template <class Pair, class Stage = AsIs<Pair>>
int launch_compact_active(const Pair& pair, const float* const* in,
                          float* const* out, int nx, int ny, int sub,
                          int cap, float scale, unsigned* work,
                          const int* active, void* stream) {
  const int patch = ny < 8 ? ny : 8;
  const ActiveGate gate{active, (ny + patch - 1) / patch, patch};
  return launch_compact<Pair, true, Stage>(pair, in, out, nx, ny, sub, cap,
                                           scale, work, gate, stream);
}

}  // namespace

// C interface, one launcher per sweep. `in` and `out` are host arrays of
// device pointers to contiguous float32 planes of shape (rows, sub, 128), in
// the channel order of each functor above (K2, K5: of its ForceFold; K8: x
// y z mask rho press ct0..2); outputs must be zero-filled by the caller.
// Returns the cudaError_t of the launch.
//
// The compacted sweeps (density, fused force in both forms, viscosity,
// prefolded pressure, pressure, the pressure backward, and the gated
// density, pressure and prefolded pressure) also take `scale`, applied to
// every output as (acc * own_m) * scale, and
// `work`, a device pointer to this launch's own counter: two uint32 words,
// zero when the launch is enqueued, which the kernel leaves zero again. So
// a counter may serve the launches of one stream in turn, and launches
// with counters of their own may run at once on any streams. They need a
// mask plane of 0 and 1 in which each cell's occupied slots are its first
// ranks (as build_planes writes it).
#define DFT_SWEEP_ARGS                                                    \
  const float* const* in, float* const* out, int nx, int ny, int sub, \
      int cap
#define DFT_SWEEP_PASS in, out, nx, ny, sub, cap, stream
#define DFT_COMPACT_PASS in, out, nx, ny, sub, cap, scale, work

extern "C" {

int dft_density_sweep(DFT_SWEEP_ARGS, float h2, float a, float scale,
                      unsigned* work, void* stream) {
  return launch_compact<DensityPair, false>(
      DensityPair{h2, a}, DFT_COMPACT_PASS, kNoGate, stream);
}

int dft_force_sweep(DFT_SWEEP_ARGS, float h, float h2, float b, float cw,
                    float mass2, float mu_mass, float scale, unsigned* work,
                    void* stream) {
  return launch_compact<ForceFoldPair<true>, false, ForceFold<true>>(
      ForceFoldPair<true>{h, h2, b, cw, mass2, mu_mass}, DFT_COMPACT_PASS,
      kNoGate, stream);
}

int dft_force_p_sweep(DFT_SWEEP_ARGS, float h, float h2, float b,
                      float mass2, float scale, unsigned* work,
                      void* stream) {
  return launch_compact<ForceFoldPair<false>, false, ForceFold<false>>(
      ForceFoldPair<false>{h, h2, b, 0.0f, mass2, 0.0f}, DFT_COMPACT_PASS,
      kNoGate, stream);
}

int dft_visc_sweep(DFT_SWEEP_ARGS, float h, float h2, float cw, float scale,
                   unsigned* work, void* stream) {
  return launch_compact<ViscPair, false>(ViscPair{h, h2, cw},
                                         DFT_COMPACT_PASS, kNoGate, stream);
}

int dft_press_pq_sweep(DFT_SWEEP_ARGS, float h2, float inv_h, float b,
                       float scale, unsigned* work, void* stream) {
  return launch_compact<PressPqPair, false>(
      PressPqPair{h2, inv_h, b}, DFT_COMPACT_PASS, kNoGate, stream);
}

// K5: the fused force's mu == 0 pair with mass2 = 1 (mass^2: `scale`).
int dft_press_sweep(DFT_SWEEP_ARGS, float h, float h2, float b, float scale,
                    unsigned* work, void* stream) {
  return launch_compact<ForceFoldPair<false>, false, ForceFold<false>>(
      ForceFoldPair<false>{h, h2, b, 0.0f, 1.0f, 0.0f}, DFT_COMPACT_PASS,
      kNoGate, stream);
}

// K10: the gated forms of density, pressure and the prefolded pressure.
// `active` is a device pointer to the contiguous int32 (nx, ceil(ny / P))
// activity grid, P = min(8, ny).

int dft_density_active_sweep(DFT_SWEEP_ARGS, float h2, float a, float scale,
                             const int* active, unsigned* work,
                             void* stream) {
  return launch_compact_active(DensityPair{h2, a}, DFT_COMPACT_PASS, active,
                               stream);
}

int dft_press_active_sweep(DFT_SWEEP_ARGS, float h, float h2, float b,
                           float scale, const int* active, unsigned* work,
                           void* stream) {
  return launch_compact_active<ForceFoldPair<false>, ForceFold<false>>(
      ForceFoldPair<false>{h, h2, b, 0.0f, 1.0f, 0.0f}, DFT_COMPACT_PASS,
      active, stream);
}

int dft_press_pq_active_sweep(DFT_SWEEP_ARGS, float h2, float inv_h, float b,
                              float scale, const int* active, unsigned* work,
                              void* stream) {
  return launch_compact_active(PressPqPair{h2, inv_h, b}, DFT_COMPACT_PASS,
                               active, stream);
}

int dft_density_bwd_sweep(DFT_SWEEP_ARGS, float h2, float a, void* stream) {
  return launch(DensityBwdPair{h2, a}, DFT_SWEEP_PASS);
}

int dft_press_bwd_sweep(DFT_SWEEP_ARGS, float h, float h2, float b,
                        float scale, unsigned* work, void* stream) {
  return launch_compact<PressBwdFoldPair, false, PressBwdFold>(
      PressBwdFoldPair{{h, h2, b}}, DFT_COMPACT_PASS, kNoGate, stream);
}

int dft_visc_bwd_sweep(DFT_SWEEP_ARGS, float h, float h2, float cw,
                       void* stream) {
  return launch(ViscBwdPair{{h, h2, cw}}, DFT_SWEEP_PASS);
}

int dft_force_bwd_sweep(DFT_SWEEP_ARGS, float h, float h2, float b, float cw,
                        float mass2, float mu_mass, void* stream) {
  return launch(ForceBwdPair<true>{{h, h2, b}, {h, h2, cw}, mass2, mu_mass},
                DFT_SWEEP_PASS);
}

int dft_force_p_bwd_sweep(DFT_SWEEP_ARGS, float h, float h2, float b,
                          float mass2, void* stream) {
  return launch(ForceBwdPair<false>{{h, h2, b}, mass2}, DFT_SWEEP_PASS);
}

}  // extern "C"
