// The PCISPH correction iteration's plane math in two passes, for sm_90a,
// over the dense (rows, sub, 128) float32 planes of ops/cellops.py: the
// prediction of the positions the density sweep reads, and the update of
// the pressure, of the prefolded pq plane the pressure sweep reads and of
// the largest density error the loop's exit test reads.
//
// Replaces the torch passes of ops/pcisph_iter.py's plain route
// (`predict_plain`, `update_plain`), the jnp expressions of the JAX
// package's `plane_loop` (dieselfluid_tpu/solvers/dense_step.py:315-335).
// No TPU kernel: XLA fuses those expressions there. For each slot i whose
// `fluid` byte is 1 (mask > 0 and bnd == 0):
//   pcisph_predict_kernel, per axis:
//     a = (e + f) * (1 / mass),   x* = x + (v + a * dt) * dt
//   every other slot keeps its carried x y z;
//   pcisph_update_kernel:
//     err = rho* - d0,   p' = clamp(p + delta * err, min=0)
//     rff = clamp(rho*, min=0.5 * d0),   pq = p' / (rff * rff)
//   every other slot gets p' = pq = 0 (and err = 0). One 0-d output holds
//   max(err) over the plane, so never below 0; NaN where an err is NaN,
//   as torch.max gives it.
//
// Bit for bit with the torch route on the card. Each operation rounds once
// as torch's CUDA kernel for it does: __fmul_rn / __fadd_rn / __fsub_rn,
// so nvcc contracts no multiply and add into an FMA, and __fdiv_rn for the
// tensor-by-tensor divide; every scalar is the float32 torch makes of the
// Python number, and the division by a Python number (mass) is a multiply
// by its float32 reciprocal (torch's div with a CPU scalar on the card);
// clamp keeps a NaN and otherwise takes fmaxf, as torch's clamp kernel
// does. The torch route on the CPU divides, so a mass whose reciprocal is
// inexact may move a slot by an ulp there.
//
// The walk (plane_advance.cu's): a grid of as many 256-thread CTAs as fit
// on the SMs, each lane taking four slots at a time: one 32-bit word of
// the bool `fluid` plane and one float4 of each float plane. A lane reads
// its fluid word; where one of its four slots is fluid it reads the other
// inputs, computes and writes its outputs' float4s. Where none is, it
// writes only with `fill`: the carried positions (predict) or zeros
// (update). A loop's first launch of each kernel fills new outputs, so the
// caller allocates them empty; its later launches write into the same
// outputs without `fill`, whose other slots already hold what they would
// write (the loop's update reads the carried pressure from its output
// plane then, a lane reading each float4 before it writes it). The error
// max is a max of float bits: a negative err maps to +0 and a NaN to the
// canonical +NaN, and a non-negative float's bits order as an unsigned
// int does, +NaN above +inf. Each warp reduces its lanes', each CTA its
// warps', and one atomicMax a CTA goes into the 0-d output, which the
// launcher zeroes first.
//
// Bytes at the 1M dam break (101^3 cells, cap 16; a float plane 81.5 MB,
// the fluid plane 20.4 MB; 143,511 of its 2,546,160 32-byte sectors hold
// a fluid slot, 4.6 MB of a float plane): both read the fluid plane in
// full. With `fill`, predict reads the three positions and writes three in
// full, and reads the velocities, the external forces and the forces over
// the fluid sectors, ~0.55 GB: 0.164 ms at 3.35 TB/s; update writes two
// planes in full and reads rho* and the pressure over those sectors,
// ~0.19 GB: 0.057 ms. Without it, every other plane is read or written
// over those sectors only: predict ~0.09 GB, 0.027 ms; update ~0.04 GB,
// 0.012 ms.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// CTAs an SM must hold: 64 registers a thread at most, 32 warps an SM to
// keep HBM's rate.
constexpr int kMinCtas = 4;
// The canonical quiet NaN's bits: above +inf's as an unsigned int.
constexpr unsigned kNanBits = 0x7fc00000u;

struct PcisphPredictArgs {
  const unsigned* fluid;  // 4 bool slots a word
  const float4* pos[3];
  const float4* vel[3];
  const float4* ext[3];
  const float4* force[3];
  float4* out[3];
  long long n_vec;         // float4s of a plane
  float inv_mass, dt;
  int fill;                // write the words with no fluid slot too
};

struct PcisphUpdateArgs {
  const unsigned* fluid;
  const float4* rho;
  const float4* press;     // may be out_press: read before it is written
  float4* out_press;
  float4* out_pq;
  unsigned* max_err;       // the 0-d float32 output, as its bits
  long long n_vec;
  float d0, delta, rff_min;
  int fill;
};

__device__ __forceinline__ float& lane_of(float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ bool is_fluid(unsigned word, int c) {
  return ((word >> (8 * c)) & 0xffu) != 0u;
}

__global__ void __launch_bounds__(kThreads, kMinCtas)
    pcisph_predict_kernel(const PcisphPredictArgs a) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < a.n_vec; i += stride) {
    const unsigned fl = a.fluid[i];
    if (fl == 0u && !a.fill) continue;
    float4 x[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) x[ax] = a.pos[ax][i];
    if (fl != 0u) {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        float4 v = a.vel[ax][i];
        float4 e = a.ext[ax][i];
        float4 f = a.force[ax][i];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (!is_fluid(fl, c)) continue;
          const float acc = __fmul_rn(
              __fadd_rn(lane_of(e, c), lane_of(f, c)), a.inv_mass);
          const float vn = __fadd_rn(lane_of(v, c), __fmul_rn(acc, a.dt));
          lane_of(x[ax], c) = __fadd_rn(lane_of(x[ax], c),
                                        __fmul_rn(vn, a.dt));
        }
      }
    }
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) a.out[ax][i] = x[ax];
  }
}

__global__ void __launch_bounds__(kThreads, kMinCtas)
    pcisph_update_kernel(const PcisphUpdateArgs a) {
  __shared__ unsigned warp_most[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  unsigned most = 0u;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < a.n_vec; i += stride) {
    const unsigned fl = a.fluid[i];
    if (fl == 0u && !a.fill) continue;
    float4 p{}, q{};
    if (fl != 0u) {
      float4 r = a.rho[i];
      float4 p0 = a.press[i];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!is_fluid(fl, c)) continue;
        const float rho = lane_of(r, c);
        const float err = __fsub_rn(rho, a.d0);
        float pn = __fadd_rn(lane_of(p0, c), __fmul_rn(err, a.delta));
        if (pn == pn) pn = fmaxf(pn, 0.0f);
        float rff = rho;
        if (rff == rff) rff = fmaxf(rff, a.rff_min);
        lane_of(p, c) = pn;
        lane_of(q, c) = __fdiv_rn(pn, __fmul_rn(rff, rff));
        const unsigned bits = err != err      ? kNanBits
                              : err > 0.0f    ? __float_as_uint(err)
                                              : 0u;
        most = bits > most ? bits : most;
      }
    }
    a.out_press[i] = p;
    a.out_pq[i] = q;
  }
  most = __reduce_max_sync(0xffffffffu, most);
  if (lane == 0) warp_most[warp] = most;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w)
      most = warp_most[w] > most ? warp_most[w] : most;
    if (most != 0u) atomicMax(a.max_err, most);
  }
}

// One launch on `stream`: as many CTAs as fit on the current device's SMs
// at once, or fewer where the planes need fewer; with `per_sm_out`, only
// the CTAs an SM holds.
template <class Kernel, class Args>
int launch(Kernel kernel, const Args& args, cudaStream_t stream,
           int* per_sm_out = nullptr) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm_out != nullptr) {
    *per_sm_out = per_sm;
    return static_cast<int>(cudaSuccess);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long need = (args.n_vec + kThreads - 1) / kThreads;
  long long grid = static_cast<long long>(per_sm) * n_sm;
  if (grid > need) grid = need;
  if (grid < 1) return static_cast<int>(cudaSuccess);
  kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The prediction on `stream`. `planes` is a host array of 16 device
// pointers: the bool fluid plane, then contiguous, 16-byte aligned float32
// planes of `n_slots` slots (a multiple of 4): x y z, vx vy vz, the three
// external forces, the three pressure forces, then the outputs x* y* z*.
// `consts` is a host array of 2 floats: 1 / mass, dt (each the float32 of
// the Python number). `fill`: write every output slot; else only the
// words that hold a fluid slot. Returns the cudaError_t of the launch.
int dft_pcisph_predict(const void* const* planes, const float* consts,
                       long long n_slots, int fill, void* stream) {
  PcisphPredictArgs args{};
  auto in = [&](int k) { return static_cast<const float4*>(planes[k]); };
  args.fluid = static_cast<const unsigned*>(planes[0]);
  for (int ax = 0; ax < 3; ++ax) {
    args.pos[ax] = in(1 + ax);
    args.vel[ax] = in(4 + ax);
    args.ext[ax] = in(7 + ax);
    args.force[ax] = in(10 + ax);
    args.out[ax] = static_cast<float4*>(const_cast<void*>(planes[13 + ax]));
  }
  args.n_vec = n_slots / 4;
  args.inv_mass = consts[0];
  args.dt = consts[1];
  args.fill = fill;
  return launch(pcisph_predict_kernel, args,
                static_cast<cudaStream_t>(stream));
}

// The update on `stream`. `planes` is a host array of 6 device pointers:
// the bool fluid plane, rho*, the carried pressure, the outputs pressure
// and pq (float32 planes as above; the carried pressure may be the output
// pressure), then the 0-d float32 output of the error max. `consts` is a
// host array of 3 floats: d0, delta, 0.5 * d0. `fill` as the prediction's.
// Returns the cudaError_t of the launch.
int dft_pcisph_update(const void* const* planes, const float* consts,
                      long long n_slots, int fill, void* stream) {
  PcisphUpdateArgs args{};
  args.fluid = static_cast<const unsigned*>(planes[0]);
  args.rho = static_cast<const float4*>(planes[1]);
  args.press = static_cast<const float4*>(planes[2]);
  args.out_press = static_cast<float4*>(const_cast<void*>(planes[3]));
  args.out_pq = static_cast<float4*>(const_cast<void*>(planes[4]));
  args.max_err = static_cast<unsigned*>(const_cast<void*>(planes[5]));
  args.n_vec = n_slots / 4;
  args.d0 = consts[0];
  args.delta = consts[1];
  args.rff_min = consts[2];
  args.fill = fill;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(args.max_err, 0, sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch(pcisph_update_kernel, args, s);
}

// CTAs per SM of a kernel, for reports: `which` 0 the prediction, 1 the
// update; a negative cudaError_t on failure.
int dft_pcisph_iter_ctas_per_sm(int which) {
  int per_sm = 0;
  const int err =
      which == 0 ? launch(pcisph_predict_kernel, PcisphPredictArgs{},
                          nullptr, &per_sm)
                 : launch(pcisph_update_kernel, PcisphUpdateArgs{}, nullptr,
                          &per_sm);
  return err == 0 ? per_sm : -err;
}

}  // extern "C"
