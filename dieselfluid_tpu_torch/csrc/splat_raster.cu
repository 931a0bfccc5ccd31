// Tile splat rasterizer, forward and backward, for sm_90a.
//
// Replaces the two Pallas TPU kernels of dieselfluid_tpu/render/
// splat_pallas.py: `_fwd_kernel` (pallas_call at :348, K11 of PERF.md) and
// `_bwd_kernel` (pallas_call at :372, K12), whose pair function the JAX
// package derives with jax.vjp (`_bwd_splat_pair`, :244) and which is
// written out by hand here. Each has a plain torch version beside it
// (render/splat_tiled.py), term for term.
//
// Data. The image is cut into 8 x 128-pixel tiles. Each tile owns K slots of
// (u, v, z, r): tile-local pixel coordinates of a splat's center, its
// normalized depth and its pixel radius, as float32 planes (n_tiles, K/128,
// 128). Occupied slots have r >= 0.75, empty ones r = 0: occupancy is
// r >= 0.5.
//
// The prefix invariant K11 relies on: a tile's occupied slots are its first
// ranks 0..n-1. bin_tile_entries (render/splat_tiled.py) writes each valid
// entry of a tile at its rank among the tile's entries (a stable sort; the
// valid ones are ranks below K), each with r = pixel_radius >= 0.75
// (render/splat.py clips it), into planes of zeros, and parks every other
// entry past the plane. So K11 stops at the first 128-slot chunk whose
// first slot is empty (r < 0.5), and still tests r >= 0.5 per slot inside a
// chunk. tests/test_torch_prefix_invariant.py checks the planes.
//
// The pair. For slot s and pixel (px, py) of its tile, with the pixel center
// c = (px + 0.5, py + 0.5), o = (c - (u, v)) / max(r, 0.5), r2 = |o|^2:
//   cov = sigmoid(sharpness (1 - r2)),  w = cov exp(-falloff z),
//   n = (o_x, -o_y, sqrt(1 - r2) inside the disc, else 0) / |.|,
// and the pixel sums w (n / 2 + 1/2) RGB, w, cov, w z (+ w n with normals).
// A pair counts only inside the slot's patch box, |px - floor(u)| <= half
// and |py - floor(v)| <= half (render/splat_tiled.py explains why this is
// the integer form of the JAX kernel's float test). Outside the box every
// output term of the JAX kernel carries live = 0, and so does every
// gradient term, so skipping those pairs changes only the order of the
// sums, never their value. K11 sums each pixel's live pairs in ascending
// slot order, in one thread, so any walk that visits a superset of them in
// that order gives the same bits.
//
// What bounds them on the H100. At 1080p with K = 8192 a slot plane is
// 66.4 MB and a tile plane 8.3 MB, but only the occupied 128-slot rows are
// read: the bench's 512k-particle frame has 1.09M entries in 8,689 of the
// 129,600 rows and 41.5M live (slot, pixel) pairs, of ~44 (forward) or
// ~104 (backward) operations each: 0.03 and 0.06 ms of operations at
// 67 TFLOP/s, and K12's 265 MB of gradient planes alone 0.08 ms of bytes
// (chip_smoke.py raster_bounds). Neither bounds them in practice. K11's
// time is set by its tail: the strips of the heaviest tiles (~8k entries,
// 64 chunks), each one warp walking its ~700 listed slots one dependent
// pair chain after another (an IEEE divide, expf, sqrtf and rsqrtf each);
// the frame's heaviest tile alone takes over half the frame's time, the
// staging and the lists a tenth (PERF.md). K12's time is set by divergence
// and the same imbalance.
//
// Design (simple first).
//  K11: each tile is split by pixel column into kStrips strips of kStripW
//  columns, one CTA each, so a heavy tile's work spreads over kStrips SMs
//  (32 strips of 4 columns: 64,800 one-warp CTAs at 1080p; 8 and 16 were
//  slower, PERF.md). A CTA has kStripW / 4 warps; each warp owns an
//  8-row x 4-column pixel block, one lane per pixel, so a pixel's sum stays
//  in one thread (no atomics, no change of order). The CTA walks the tile's
//  occupied prefix in chunks of 128 slots: its threads stage the chunk's u,
//  v, z, r, floor(u), floor(v), 1/max(r, 0.5) and exp(-falloff z) in shared
//  memory (each strip stages the chunk, so the staging grows with
//  kStrips); each warp then builds, by four ballots, the list of the
//  chunk's occupied slots whose patch box meets its 4 columns (the rows
//  always meet: binning puts an entry only in tiles its box overlaps, and
//  the warp spans the tile's 8 rows), and walks the list in ascending slot
//  order (__ffs). Each lane tests its own pixel against the box (the same
//  integer test) and sums the pair. A 9-wide box thus lights most of a
//  warp's 32 lanes, where one thread per pixel of a 128-wide row lit at
//  most 9 of 32. The box tests come before any transcendental.
//  K12: one 256-thread CTA per tile. The tile's 6 or 9 cotangent planes are
//  staged in shared memory (24 or 36 KB); each thread owns slots t, t + 256,
//  ... (each slot one owner, so no atomics), writes 0 for an empty slot and
//  for a live one walks its patch box clipped to the tile (<= 9 x 8
//  pixels), summing the four gradients. The per-slot factors of the chain
//  (d/d inv_r and d/d exp(-falloff z)) are summed over the box and applied
//  once.
// No fast-math: expf, sqrtf and IEEE divides; rsqrtf where the JAX pair
// uses lax.rsqrt. Every masked branch is a select, never a multiply by a
// mask.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kTh = 8;            // tile rows
constexpr int kTw = 128;          // tile columns
constexpr int kPix = kTh * kTw;   // pixels per tile
constexpr int kChunk = 128;       // slots staged per step of K11
constexpr int kBwdThreads = 256;
// K11's split, the fastest of tools/torch_sweep_variants.py's strip counts
// on an H100 (PERF.md).
constexpr int kStrips = 32;                  // CTAs per tile
constexpr int kStripW = kTw / kStrips;       // pixel columns per CTA
constexpr int kWarpW = 4;                    // pixel columns per warp
constexpr int kFwdThreads = 32 * kStripW / kWarpW;
static_assert(kTh * kWarpW == 32, "a warp owns an 8 x 4 pixel block");
// Slots of a chunk each thread stages (4 at one warp a CTA).
constexpr int kStage = (kChunk + kFwdThreads - 1) / kFwdThreads;
static_assert(kStage == 1 || kStage * kFwdThreads == kChunk,
              "the CTA stages a chunk in kStage steps");

struct RasterArgs {
  const float* in[13];  // u v z r, then K12's 6 or 9 cotangent planes
  float* out[9];        // K11: 6 or 9 tile planes; K12: 4 slot planes
  int k;                // slots per tile
  int half;             // patch // 2
  float sharpness;
  float falloff;
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// r2 = ox^2 + oy^2 rounded op by op, with o = (pixel center - center) *
// inv_r rounded the same way (no FMA contraction), as the plain torch
// version rounds them: the `inside` test and sqrt(1 - r2) then agree bit for
// bit with it. That matters at the disc's rim, where the gradient of
// sqrt(1 - r2) is 0.5 / sqrt(1 - r2) and the where-trick switches it off: a
// one-ulp difference in r2 there moves a slot's gradient by up to ~1%.
__device__ __forceinline__ float disc_r2(float ox, float oy) {
  return __fadd_rn(__fmul_rn(ox, ox), __fmul_rn(oy, oy));
}

// value * d max(x, at)/dx, with jnp.maximum's half at the tie.
__device__ __forceinline__ float tie_grad(float x, float at, float value) {
  return (x > at) ? value : ((x == at) ? 0.5f * value : 0.0f);
}

// CTA blockIdx.x: strip blockIdx.x % kStrips of tile blockIdx.x / kStrips.
template <bool kNormals>
__global__ void __launch_bounds__(kFwdThreads)
splat_fwd_kernel(const RasterArgs a) {
  constexpr int kOut = kNormals ? 9 : 6;
  constexpr int kWords = kChunk / 32;
  __shared__ float s_u[kChunk], s_v[kChunk], s_z[kChunk], s_r[kChunk];
  __shared__ float s_fu[kChunk], s_fv[kChunk], s_ir[kChunk], s_ez[kChunk];

  const int t = threadIdx.x, lane = t & 31;
  const int tile = blockIdx.x / kStrips;
  const int col0 = (blockIdx.x - tile * kStrips) * kStripW + (t >> 5) * kWarpW;
  const float px = static_cast<float>(col0 + (lane & (kWarpW - 1)));
  const float py = static_cast<float>(lane / kWarpW);
  const float pxc = px + 0.5f, pyc = py + 0.5f;
  const float half = static_cast<float>(a.half);
  // A slot's box meets the warp's columns [col0, col0 + kWarpW) unless
  // floor(u) < lo or floor(u) > hi (a NaN passes, as it passes the box test).
  const float lo = static_cast<float>(col0) - half;
  const float hi = static_cast<float>(col0 + kWarpW - 1) + half;
  const long long base = static_cast<long long>(tile) * a.k;

  float acc[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) acc[o] = 0.0f;

  for (int c0 = 0; c0 < a.k; c0 += kChunk) {
    // Thread t stages slots t, t + kFwdThreads, ... of the chunk.
    float u[kStage], v[kStage], z[kStage], r[kStage];
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int j = t + i * kFwdThreads;
      if (j < kChunk) {
        u[i] = a.in[0][base + c0 + j];
        v[i] = a.in[1][base + c0 + j];
        z[i] = a.in[2][base + c0 + j];
        r[i] = a.in[3][base + c0 + j];
      }
    }
    // The occupied prefix ends at a chunk whose first slot is empty (one
    // address for every thread, so the whole CTA leaves together).
    if (!(a.in[3][base + c0] >= 0.5f)) break;
    __syncthreads();  // the previous chunk's reads of shared memory are done
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int j = t + i * kFwdThreads;
      if (j < kChunk) {
        s_u[j] = u[i];
        s_v[j] = v[i];
        s_z[j] = z[i];
        s_r[j] = r[i];
        s_fu[j] = floorf(u[i]);
        s_fv[j] = floorf(v[i]);
        s_ir[j] = 1.0f / fmaxf(r[i], 0.5f);
        s_ez[j] = expf(-a.falloff * z[i]);
      }
    }
    __syncthreads();
    unsigned list[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const int j = 32 * w + lane;
      list[w] = __ballot_sync(0xffffffffu, s_r[j] >= 0.5f &&
                                               !(s_fu[j] < lo) &&
                                               !(s_fu[j] > hi));
    }
    for (int w = 0; w < kWords; ++w) {  // not unrolled: one copy of the pair
      unsigned m = list[0];
#pragma unroll
      for (int i = 1; i < kWords; ++i) m = (w == i) ? list[i] : m;
      for (; m != 0u; m &= m - 1u) {
        const int j = 32 * w + __ffs(m) - 1;
        if (fabsf(px - s_fu[j]) > half || fabsf(py - s_fv[j]) > half)
          continue;
        const float ir = s_ir[j];
        const float ox = __fmul_rn(__fsub_rn(pxc, s_u[j]), ir);
        const float oy = __fmul_rn(__fsub_rn(pyc, s_v[j]), ir);
        const float r2 = disc_r2(ox, oy);
        const float cov = sigmoid(a.sharpness * (1.0f - r2));
        const bool inside = (1.0f - r2) > 1e-6f;
        const float oz = inside ? sqrtf(1.0f - r2) : 0.0f;
        const float inl = rsqrtf(fmaxf(ox * ox + oy * oy + oz * oz, 1e-12f));
        const float nx = ox * inl, ny = -(oy * inl), nz = oz * inl;
        const float wt = cov * s_ez[j];
        acc[0] += (nx * 0.5f + 0.5f) * wt;
        acc[1] += (ny * 0.5f + 0.5f) * wt;
        acc[2] += (nz * 0.5f + 0.5f) * wt;
        acc[3] += wt;
        acc[4] += cov;
        acc[5] += wt * s_z[j];
        if constexpr (kNormals) {
          acc[6] += wt * nx;
          acc[7] += wt * ny;
          acc[8] += wt * nz;
        }
      }
    }
  }
  const long long pix = static_cast<long long>(tile) * kPix +
                        static_cast<int>(py) * kTw + static_cast<int>(px);
#pragma unroll
  for (int o = 0; o < kOut; ++o) a.out[o][pix] = acc[o];
}

template <bool kNormals>
__global__ void __launch_bounds__(kBwdThreads)
splat_bwd_kernel(const RasterArgs a) {
  constexpr int kCt = kNormals ? 9 : 6;
  __shared__ float s_ct[kCt][kPix];

  const long long tile_pix = static_cast<long long>(blockIdx.x) * kPix;
  for (int e = threadIdx.x; e < kCt * kPix; e += kBwdThreads)
    s_ct[e / kPix][e % kPix] = a.in[4 + e / kPix][tile_pix + e % kPix];
  __syncthreads();

  const long long base = static_cast<long long>(blockIdx.x) * a.k;
  for (int s = threadIdx.x; s < a.k; s += kBwdThreads) {
    const long long idx = base + s;
    const float r = a.in[3][idx];
    float gu = 0.0f, gv = 0.0f, gz = 0.0f, gr = 0.0f;
    if (r >= 0.5f) {
      const float u = a.in[0][idx], v = a.in[1][idx], z = a.in[2][idx];
      const float ir = 1.0f / fmaxf(r, 0.5f);
      const float ez = expf(-a.falloff * z);
      const int fu = static_cast<int>(floorf(u));
      const int fv = static_cast<int>(floorf(v));
      const int x0 = max(0, fu - a.half), x1 = min(kTw - 1, fu + a.half);
      const int y0 = max(0, fv - a.half), y1 = min(kTh - 1, fv + a.half);
      float g_ir = 0.0f, g_ez = 0.0f;
      for (int py = y0; py <= y1; ++py) {
        for (int px = x0; px <= x1; ++px) {
          const int p = py * kTw + px;
          // Forward, recomputed.
          const float dxp = __fsub_rn(static_cast<float>(px) + 0.5f, u);
          const float dyp = __fsub_rn(static_cast<float>(py) + 0.5f, v);
          const float ox = __fmul_rn(dxp, ir), oy = __fmul_rn(dyp, ir);
          const float r2 = disc_r2(ox, oy);
          const float cov = sigmoid(a.sharpness * (1.0f - r2));
          const bool inside = (1.0f - r2) > 1e-6f;
          const float oz = inside ? sqrtf(1.0f - r2) : 0.0f;
          const float len2 = ox * ox + oy * oy + oz * oz;
          const float len2c = fmaxf(len2, 1e-12f);
          const float inl = rsqrtf(len2c);
          const float nx = ox * inl, ny = -(oy * inl), nz = oz * inl;
          const float w = cov * ez;
          // Outputs -> w, cov, z and the normal.
          const float c0 = s_ct[0][p], c1 = s_ct[1][p], c2 = s_ct[2][p];
          const float c5 = s_ct[5][p];
          float g_w = c0 * (nx * 0.5f + 0.5f) + c1 * (ny * 0.5f + 0.5f) +
                      c2 * (nz * 0.5f + 0.5f) + s_ct[3][p] + c5 * z;
          float g_nx = 0.5f * (c0 * w), g_ny = 0.5f * (c1 * w);
          float g_nz = 0.5f * (c2 * w);
          if constexpr (kNormals) {
            const float c6 = s_ct[6][p], c7 = s_ct[7][p], c8 = s_ct[8][p];
            g_w += c6 * nx + c7 * ny + c8 * nz;
            g_nx += c6 * w;
            g_ny += c7 * w;
            g_nz += c8 * w;
          }
          const float g_cov = g_w * ez + s_ct[4][p];
          gz += c5 * w;
          g_ez += g_w * cov;
          // n = (ox, -oy, oz) * rsqrt(max(|.|^2, 1e-12)).
          const float g_inl = g_nx * ox - g_ny * oy + g_nz * oz;
          const float g_len = tie_grad(len2, 1e-12f,
                                       g_inl * (-0.5f * inl / len2c));
          float g_ox = g_nx * inl + 2.0f * ox * g_len;
          float g_oy = -g_ny * inl + 2.0f * oy * g_len;
          const float g_oz = g_nz * inl + 2.0f * oz * g_len;
          // oz = sqrt(1 - r2) inside, 0 outside; cov = sigmoid(s (1 - r2)).
          float g_r2 = inside ? -(g_oz * (0.5f / oz)) : 0.0f;
          g_r2 -= a.sharpness * (g_cov * (cov * (1.0f - cov)));
          g_ox += 2.0f * ox * g_r2;
          g_oy += 2.0f * oy * g_r2;
          // o = (pixel - center) * inv_r.
          g_ir += g_ox * dxp + g_oy * dyp;
          gu -= g_ox * ir;
          gv -= g_oy * ir;
        }
      }
      gz += g_ez * ez * (-a.falloff);
      gr = tie_grad(r, 0.5f, -g_ir * ir * ir);
    }
    a.out[0][idx] = gu;
    a.out[1][idx] = gv;
    a.out[2][idx] = gz;
    a.out[3][idx] = gr;
  }
}

template <bool kNormals>
int launch_fwd(const float* const* in, float* const* out, int n_tiles, int k,
               int half, float sharpness, float falloff, void* stream) {
  RasterArgs a{};
  for (int i = 0; i < 4; ++i) a.in[i] = in[i];
  for (int o = 0; o < (kNormals ? 9 : 6); ++o) a.out[o] = out[o];
  a.k = k;
  a.half = half;
  a.sharpness = sharpness;
  a.falloff = falloff;
  splat_fwd_kernel<kNormals><<<n_tiles * kStrips, kFwdThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kNormals>
int launch_bwd(const float* const* in, float* const* out, int n_tiles, int k,
               int half, float sharpness, float falloff, void* stream) {
  RasterArgs a{};
  for (int i = 0; i < 4 + (kNormals ? 9 : 6); ++i) a.in[i] = in[i];
  for (int o = 0; o < 4; ++o) a.out[o] = out[o];
  a.k = k;
  a.half = half;
  a.sharpness = sharpness;
  a.falloff = falloff;
  splat_bwd_kernel<kNormals><<<n_tiles, kBwdThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Each launcher's kernel and threads per CTA, by its C symbol, for
// dft_splat_ctas_per_sm.
struct Occupancy {
  const char* symbol;
  const void* kernel;
  int threads;
};
const Occupancy kOccupancy[] = {
    {"dft_splat_fwd6", reinterpret_cast<const void*>(splat_fwd_kernel<false>),
     kFwdThreads},
    {"dft_splat_fwd9", reinterpret_cast<const void*>(splat_fwd_kernel<true>),
     kFwdThreads},
    {"dft_splat_bwd6", reinterpret_cast<const void*>(splat_bwd_kernel<false>),
     kBwdThreads},
    {"dft_splat_bwd9", reinterpret_cast<const void*>(splat_bwd_kernel<true>),
     kBwdThreads},
};

}  // namespace

// C interface. `in` and `out` are host arrays of device pointers to
// contiguous float32 planes: in = u v z r slot planes (n_tiles, k/128, 128)
// [+ the 6 or 9 cotangent tile planes (n_tiles, 8, 128) for the backward];
// out = the 6 or 9 accumulator tile planes (forward) or the d/du d/dv d/dz
// d/dr slot planes (backward), every element written. Returns the
// cudaError_t of the launch.
#define DFT_SPLAT_ARGS                                                    \
  const float* const* in, float* const* out, int n_tiles, int k, int half, \
      float sharpness, float falloff, void* stream
#define DFT_SPLAT_PASS in, out, n_tiles, k, half, sharpness, falloff, stream

extern "C" {

int dft_splat_fwd6(DFT_SPLAT_ARGS) { return launch_fwd<false>(DFT_SPLAT_PASS); }
int dft_splat_fwd9(DFT_SPLAT_ARGS) { return launch_fwd<true>(DFT_SPLAT_PASS); }
int dft_splat_bwd6(DFT_SPLAT_ARGS) { return launch_bwd<false>(DFT_SPLAT_PASS); }
int dft_splat_bwd9(DFT_SPLAT_ARGS) { return launch_bwd<true>(DFT_SPLAT_PASS); }

// CTAs per SM of the kernel the launcher `symbol` runs (its threads per CTA
// in *threads), for reports; a negative cudaError_t on failure, -1 for an
// unknown symbol.
int dft_splat_ctas_per_sm(const char* symbol, int* threads) {
  for (const Occupancy& o : kOccupancy) {
    if (std::strcmp(o.symbol, symbol) != 0) continue;
    int per_sm = 0;
    *threads = o.threads;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, o.kernel, o.threads, 0);
    return err == cudaSuccess ? per_sm : -static_cast<int>(err);
  }
  return -1;
}

}  // extern "C"
