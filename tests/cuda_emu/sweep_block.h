// The old sweep body and the old pairs, appended by
// tests/test_torch_sweep_emulated*.py to csrc/sph_sweep.cu (which they then
// compile for the CPU against cuda_runtime.h here) as the oracle the
// compacted body is held to bit for bit.
//
// sweep_block, sweep_kernel, launch_kernel and launch: the body every sweep
// ran before the compacted one (one 128-thread CTA per interior 128-slot
// own block; every candidate slot of the 27 cells visited, occupied or not,
// masked by the candidate's mask channel), as the library had them. Then
// the old pressure pair, the old adjoint pairs on raw rho and press (K7 in
// both forms, K8, K9) and the old gated kernel (sweep_block behind a
// per-CTA read of the activity grid), and `emu_block_*` launchers of
// sweep_block for every sweep, with the emulator's controls.

namespace {

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

// p_i / max(rho_i, eps)^2 + p_j / max(rho_j, eps)^2 from raw rho and press.
__device__ __forceinline__ float press_coeff(float rho_i, float p_i,
                                             float rho_j, float p_j) {
  return p_i / (rho_i * rho_i) + p_j / (rho_j * rho_j);
}
struct PressPair {  // x y z mask rho press -> 3 (mass^2 applied outside)
  static constexpr int kIn = 6, kOut = 3, kMask = 3, kRho = 4, kPress = 5;
  float h, h2, b;
  void operator()(const float* o, const float* c, float* acc) const {
    const float dx = c[0] - o[0], dy = c[1] - o[1], dz = c[2] - o[2];
    const float d2 = dx * dx + dy * dy + dz * dz;
    const bool live = (d2 > kEps) && (d2 < h2) && (c[kMask] > 0.0f);
    const float inv_d = rsqrtf(live ? d2 : 1.0f);
    const float dist = d2 * inv_d;
    const float q1 = 1.0f - dist / h;
    const float o1d = b * q1 * q1;
    const float coeff = press_coeff(fmaxf(o[kRho], kEps), o[kPress],
                                    fmaxf(c[kRho], kEps), c[kPress]);
    const float s_p = live ? coeff * o1d * inv_d : 0.0f;
    acc[0] += s_p * dx;
    acc[1] += s_p * dy;
    acc[2] += s_p * dz;
  }
};
// The adjoint terms on raw rho and press planes, read at both slots, as
// sweep_block ran K7, K8 and K9 (the library's terms read folded pq and iv).
template <int kMask, int kRho, int kPress, int kCt, int kOutRho,
          int kOutPress>
struct RawPressBwdTerms {
  float h, h2, b;
  void operator()(const float* o, const float* c, float s, float* acc) const {
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
    const float coeff =
        press_coeff(rho_i, o[kPress], fmaxf(c[kRho], kEps), c[kPress]);
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
template <int kMask, int kRho, int kCt, int kOutRho>
struct RawViscBwdTerms {
  float h, h2, cw;
  void operator()(const float* o, const float* c, float s, float* acc) const {
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
    const float ex =
        (bb ? c[kCt] * inv_ri : 0.0f) - (a ? o[kCt] * inv_rj : 0.0f);
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
struct PressBwdPair {  // x y z mask rho press ct0..2 -> dx dy dz drho dpress
  static constexpr int kIn = 9, kOut = 5, kMask = 3;
  RawPressBwdTerms<3, 4, 5, 6, 3, 4> terms;
  void operator()(const float* o, const float* c, float* acc) const {
    terms(o, c, 1.0f, acc);
  }
};
struct ViscBwdPair {  // x y z vx vy vz mask rho ct0..2 -> 7
  static constexpr int kIn = 11, kOut = 7, kMask = 6;
  RawViscBwdTerms<6, 7, 8, 6> terms;
  void operator()(const float* o, const float* c, float* acc) const {
    terms(o, c, 1.0f, acc);
  }
};
struct ForceBwdPair {  // x y z vx vy vz mask rho press ct0..2 -> 8
  static constexpr int kIn = 12, kOut = 8, kMask = 6;
  RawPressBwdTerms<6, 7, 8, 9, 6, 7> press;
  RawViscBwdTerms<6, 7, 9, 6> visc;
  float mass2, mu_mass;
  void operator()(const float* o, const float* c, float* acc) const {
    press(o, c, mass2, acc);
    visc(o, c, mu_mass, acc);
  }
};
struct ForceBwdPPair {  // x y z mask rho press ct0..2 -> 5 (mu == 0)
  static constexpr int kIn = 9, kOut = 5, kMask = 3;
  RawPressBwdTerms<3, 4, 5, 6, 3, 4> press;
  float mass2;
  void operator()(const float* o, const float* c, float* acc) const {
    press(o, c, mass2, acc);
  }
};
template <class Pair>
void sweep_active_kernel(const Pair pair,
                         const SweepArgs<Pair::kIn, Pair::kOut> args,
                         const ActiveGate gate) {
  const int col = blockIdx.x;
  if (gate.active[(col / args.ny) * gate.nyp + (col % args.ny) / gate.patch]
      == 0)
    return;
  sweep_block(pair, args);
}
template <class Pair>
int launch_active(const Pair& pair, const float* const* in,
                  float* const* out, int nx, int ny, int sub, int cap,
                  const int* active, void* stream) {
  const int patch = ny < 8 ? ny : 8;
  const ActiveGate gate{active, (ny + patch - 1) / patch, patch};
  return launch_kernel(sweep_active_kernel<Pair>, pair, in, out, nx, ny, sub,
                       cap, stream, gate);
}
}  // namespace
#define DFT_SWEEP_PASS in, out, nx, ny, sub, cap, stream
#define DFT_ACTIVE_PASS in, out, nx, ny, sub, cap, active, stream
extern "C" {
void emu_set_sms(int n) { emu_sms = n; }
void emu_defer(int on) { emu_deferred = on != 0; }
void emu_run_deferred() { emu_flush(); }
int emu_block_force(DFT_SWEEP_ARGS, float h, float h2, float b, float cw,
                    float mass2, float mu_mass, void* stream) {
  return launch(ForceFoldPair<true>{h, h2, b, cw, mass2, mu_mass},
                DFT_SWEEP_PASS);
}
int emu_block_force_p(DFT_SWEEP_ARGS, float h, float h2, float b,
                      float mass2, void* stream) {
  return launch(ForceFoldPair<false>{h, h2, b, 0.0f, mass2, 0.0f},
                DFT_SWEEP_PASS);
}
int emu_block_visc(DFT_SWEEP_ARGS, float h, float h2, float cw,
                   void* stream) {
  return launch(ViscPair{h, h2, cw}, DFT_SWEEP_PASS);
}
int emu_block_density(DFT_SWEEP_ARGS, float h2, float a, void* stream) {
  return launch(DensityPair{h2, a}, DFT_SWEEP_PASS);
}
int emu_block_press_pq(DFT_SWEEP_ARGS, float h2, float inv_h, float b,
                       void* stream) {
  return launch(PressPqPair{h2, inv_h, b}, DFT_SWEEP_PASS);
}
int emu_block_density_active(DFT_SWEEP_ARGS, float h2, float a,
                             const int* active, void* stream) {
  return launch_active(DensityPair{h2, a}, DFT_ACTIVE_PASS);
}
int emu_block_press_pq_active(DFT_SWEEP_ARGS, float h2, float inv_h,
                              float b, const int* active, void* stream) {
  return launch_active(PressPqPair{h2, inv_h, b}, DFT_ACTIVE_PASS);
}
int emu_block_press(DFT_SWEEP_ARGS, float h, float h2, float b,
                    void* stream) {
  return launch(PressPair{h, h2, b}, DFT_SWEEP_PASS);
}
int emu_block_press_active(DFT_SWEEP_ARGS, float h, float h2, float b,
                           const int* active, void* stream) {
  return launch_active(PressPair{h, h2, b}, DFT_ACTIVE_PASS);
}
int emu_block_press_bwd(DFT_SWEEP_ARGS, float h, float h2, float b,
                        void* stream) {
  return launch(PressBwdPair{{h, h2, b}}, DFT_SWEEP_PASS);
}
int emu_block_visc_bwd(DFT_SWEEP_ARGS, float h, float h2, float cw,
                       void* stream) {
  return launch(ViscBwdPair{{h, h2, cw}}, DFT_SWEEP_PASS);
}
int emu_block_force_bwd(DFT_SWEEP_ARGS, float h, float h2, float b, float cw,
                        float mass2, float mu_mass, void* stream) {
  return launch(ForceBwdPair{{h, h2, b}, {h, h2, cw}, mass2, mu_mass},
                DFT_SWEEP_PASS);
}
int emu_block_force_p_bwd(DFT_SWEEP_ARGS, float h, float h2, float b,
                          float mass2, void* stream) {
  return launch(ForceBwdPPair{{h, h2, b}, mass2}, DFT_SWEEP_PASS);
}
int emu_block_density_bwd(DFT_SWEEP_ARGS, float h2, float a, void* stream) {
  return launch(DensityBwdPair{h2, a}, DFT_SWEEP_PASS);
}
}
