// The plane-resident step's epilogue in one pass, for sm_90a: the
// accelerations, the semi-implicit Euler step, the wall collision and the
// skin trigger's displacement, over the dense (rows, sub, 128) float32
// planes of ops/cellops.py.
//
// Replaces the torch passes of solvers/dense_resident.py's plain route
// (`_epilogue_plain`: the accelerations, `_integrate_collide` and the
// displacement max), which the JAX package's dense_resident.py writes as
// the same jnp expressions. For each slot i whose mask is > 0 and whose `bnd`
// is 0 (a fluid slot), per axis:
//     a  = f * (1 / mass) + g          (WCSPH, ForceAccel)
//        | (e + f) * (1 / mass)        (PCISPH, SplitAccel)
//     v' = v + a * dt,   x' = x + v' * dt
//     hit = x' < lo | x' > hi                    (on the unclamped x')
//     x' = clamp(x', lo, hi),   v' = hit ? -restitution * v' : v'
// then, where some axis hit, v' = (1 - friction) * v' on the axes that did
// not; and the slot's displacement since the last rebuild is
// max_axis |x' - ref|. Every other slot keeps its x y z vx vy vz. One
// 0-d output holds the largest displacement over the fluid slots (0 when
// there is none; NaN when one is NaN, as torch.max gives it).
//
// Bit for bit with the torch route on the card. Each operation rounds once
// as torch's CUDA kernel for it does: __fmul_rn / __fadd_rn / __fsub_rn,
// so nvcc contracts no multiply and add into an FMA; every scalar is the
// float32 torch makes of the Python number, and a division by a Python
// number is a multiply by its float32 reciprocal (torch's div with a CPU
// scalar on the card); clamp keeps a NaN and otherwise takes
// min(max(x, lo), hi) as torch's clamp kernel does. The torch route on
// the CPU divides, so a mass whose reciprocal is inexact may move a slot
// by an ulp there.
//
// The walk: a grid of as many 256-thread CTAs as fit on the SMs, each warp
// taking one 128-slot block at a time (blocks warp, warp + warps, ...),
// each lane four slots as one float4 of each plane. A lane reads the mask;
// where none of its four slots is occupied it copies the six carried
// planes through, else it reads bnd, the state, the forces and the
// reference positions and computes. The six outputs are written in full,
// so the caller allocates them empty. The displacement max is a max of
// the floats' bits: |d| is never negative, and a non-negative float's bits
// order as an unsigned int does, +NaN above +inf. Each warp reduces its
// lanes', each CTA its warps', and one atomicMax a CTA goes into the
// 0-d output, which the launcher zeroes first.
//
// Bytes at the 1M dam break (101^3 cells, cap 16: 159,135 blocks, 18,068
// holding a particle): the mask read and the six outputs written in full,
// the six carried planes read in full, and bnd, three forces (six for
// PCISPH) and three reference planes read over the occupied blocks, about
// 1.1 GB: 0.34 ms at 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// CTAs an SM must hold: 85 registers a thread at most (no spills in
// either form), 24 warps an SM to keep HBM's rate.
constexpr int kMinCtas = 3;

struct PlaneAdvanceArgs {
  const float4* mask;
  const float4* bnd;
  const float4* pos[3];
  const float4* vel[3];
  const float4* force[3];
  const float4* ext[3];  // SplitAccel's external forces; unread otherwise
  const float4* ref[3];
  float4* out_pos[3];
  float4* out_vel[3];
  unsigned* max_disp;    // the 0-d float32 output, as its bits
  long long n_vec;       // float4s of a plane
  float inv_mass, dt, neg_rest, keep;
  float gravity[3], lo[3], hi[3];
};

// WCSPH: the fused force sweep's force, f * (1 / mass) + g.
struct ForceAccel {
  static constexpr bool kExt = false;
  __device__ static float accel(float f, float, float inv_mass, float g) {
    return __fadd_rn(__fmul_rn(f, inv_mass), g);
  }
};

// PCISPH: the external force plus the correction loop's pressure force,
// (e + f) * (1 / mass).
struct SplitAccel {
  static constexpr bool kExt = true;
  __device__ static float accel(float f, float e, float inv_mass, float) {
    return __fmul_rn(__fadd_rn(e, f), inv_mass);
  }
};

__device__ __forceinline__ float& lane_of(float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

template <class Accel, bool kWalls>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    plane_advance_kernel(const PlaneAdvanceArgs a) {
  __shared__ unsigned warp_most[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  unsigned most = 0u;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     warp * 32 + lane;
       i < a.n_vec; i += stride) {
    float4 m = a.mask[i];
    if (!(m.x > 0.0f || m.y > 0.0f || m.z > 0.0f || m.w > 0.0f)) {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        a.out_pos[ax][i] = a.pos[ax][i];
        a.out_vel[ax][i] = a.vel[ax][i];
      }
      continue;
    }
    float4 b = a.bnd[i];
    float4 x[3], v[3], acc[3], r[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      x[ax] = a.pos[ax][i];
      v[ax] = a.vel[ax][i];
      r[ax] = a.ref[ax][i];
      float4 f = a.force[ax][i];
      float4 e = Accel::kExt ? a.ext[ax][i] : float4{};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        lane_of(acc[ax], c) = Accel::accel(lane_of(f, c), lane_of(e, c),
                                           a.inv_mass, a.gravity[ax]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!(lane_of(m, c) > 0.0f && lane_of(b, c) == 0.0f)) continue;
      bool hit[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        float& vn = lane_of(v[ax], c);
        float& xn = lane_of(x[ax], c);
        vn = __fadd_rn(vn, __fmul_rn(lane_of(acc[ax], c), a.dt));
        xn = __fadd_rn(xn, __fmul_rn(vn, a.dt));
        hit[ax] = false;
        if (kWalls) {
          hit[ax] = xn < a.lo[ax] || xn > a.hi[ax];
          if (xn == xn) xn = fminf(fmaxf(xn, a.lo[ax]), a.hi[ax]);
          if (hit[ax]) vn = __fmul_rn(a.neg_rest, vn);
        }
      }
      const bool any_hit = hit[0] || hit[1] || hit[2];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        float& vn = lane_of(v[ax], c);
        if (kWalls && any_hit && !hit[ax]) vn = __fmul_rn(a.keep, vn);
        const float d =
            fabsf(__fsub_rn(lane_of(x[ax], c), lane_of(r[ax], c)));
        const unsigned bits = __float_as_uint(d);
        most = bits > most ? bits : most;
      }
    }
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      a.out_pos[ax][i] = x[ax];
      a.out_vel[ax][i] = v[ax];
    }
  }
  most = __reduce_max_sync(0xffffffffu, most);
  if (lane == 0) warp_most[warp] = most;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w)
      most = warp_most[w] > most ? warp_most[w] : most;
    if (most != 0u) atomicMax(a.max_disp, most);
  }
}

// CTAs of one instantiation an SM of the current device holds at once.
template <class Accel, bool kWalls>
cudaError_t ctas_per_sm(int* per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, plane_advance_kernel<Accel, kWalls>, kThreads, 0);
}

// One launch on `stream`: as many CTAs as fit on the current device's SMs
// at once, or fewer where the planes need fewer.
template <class Accel, bool kWalls>
int launch(const PlaneAdvanceArgs& args, cudaStream_t stream) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = ctas_per_sm<Accel, kWalls>(&per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long need = (args.n_vec + kThreads - 1) / kThreads;
  long long grid = static_cast<long long>(per_sm) * n_sm;
  if (grid > need) grid = need;
  auto kernel = plane_advance_kernel<Accel, kWalls>;
  kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch of the epilogue on `stream`. `planes` is a host array of 24
// device pointers to contiguous, 16-byte aligned float32 planes of `n_slots`
// slots (a multiple of 4): mask, bnd, x y z, vx vy vz, the three forces,
// the three external forces (SplitAccel; null with `split` 0), ref_x ref_y
// ref_z, then the outputs x y z vx vy vz, then the 0-d float32 output of
// the displacement max. `consts` is a host array of 13 floats: 1 / mass,
// dt, -restitution, 1 - friction, gravity xyz, lo xyz, hi xyz (each the
// float32 of the Python number). `split` picks (e + f) / mass over
// f / mass + g; `walls` 0 leaves out the wall block (bounds=None). Returns
// the cudaError_t of the launch.
int dft_plane_advance(const void* const* planes, const float* consts,
                      long long n_slots, int split, int walls,
                      void* stream) {
  PlaneAdvanceArgs args{};
  auto in = [&](int k) { return static_cast<const float4*>(planes[k]); };
  auto out = [&](int k) { return static_cast<float4*>(
                              const_cast<void*>(planes[k])); };
  args.mask = in(0);
  args.bnd = in(1);
  for (int ax = 0; ax < 3; ++ax) {
    args.pos[ax] = in(2 + ax);
    args.vel[ax] = in(5 + ax);
    args.force[ax] = in(8 + ax);
    args.ext[ax] = in(11 + ax);
    args.ref[ax] = in(14 + ax);
    args.out_pos[ax] = out(17 + ax);
    args.out_vel[ax] = out(20 + ax);
    args.gravity[ax] = consts[4 + ax];
    args.lo[ax] = consts[7 + ax];
    args.hi[ax] = consts[10 + ax];
  }
  args.max_disp = static_cast<unsigned*>(const_cast<void*>(planes[23]));
  args.n_vec = n_slots / 4;
  args.inv_mass = consts[0];
  args.dt = consts[1];
  args.neg_rest = consts[2];
  args.keep = consts[3];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(args.max_disp, 0, sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (args.n_vec <= 0) return static_cast<int>(cudaSuccess);
  if (split)
    return walls ? launch<SplitAccel, true>(args, s)
                 : launch<SplitAccel, false>(args, s);
  return walls ? launch<ForceAccel, true>(args, s)
               : launch<ForceAccel, false>(args, s);
}

// CTAs per SM of the instantiation a launch with these `split` and
// `walls` runs, for reports; a negative cudaError_t on failure.
int dft_plane_advance_ctas_per_sm(int split, int walls) {
  int per_sm = 0;
  const cudaError_t err =
      split ? (walls ? ctas_per_sm<SplitAccel, true>(&per_sm)
                     : ctas_per_sm<SplitAccel, false>(&per_sm))
            : (walls ? ctas_per_sm<ForceAccel, true>(&per_sm)
                     : ctas_per_sm<ForceAccel, false>(&per_sm));
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

}  // extern "C"
