// The tile rasterizer's old forward body, appended by
// tests/test_torch_raster_emulated.py to csrc/splat_raster.cu (which it then
// compiles for the CPU against cuda_runtime.h here) as the oracle the
// strip-split K11 is held to bit for bit: splat_fwd_tile_kernel, one
// 1024-thread CTA per tile, one thread per pixel, walking every 128-slot
// chunk of the tile (a chunk with no occupied slot skipped as one) and
// testing every slot of the others, as the library had it.

namespace {

template <bool kNormals>
__global__ void __launch_bounds__(kPix)
splat_fwd_tile_kernel(const RasterArgs a) {
  constexpr int kOut = kNormals ? 9 : 6;
  __shared__ float s_u[kChunk], s_v[kChunk], s_z[kChunk], s_r[kChunk];
  __shared__ float s_fu[kChunk], s_fv[kChunk], s_ir[kChunk], s_ez[kChunk];

  const int t = threadIdx.x;
  const float px = static_cast<float>(t % kTw);
  const float py = static_cast<float>(t / kTw);
  const float pxc = px + 0.5f, pyc = py + 0.5f;
  const float half = static_cast<float>(a.half);
  const long long base = static_cast<long long>(blockIdx.x) * a.k;

  float acc[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) acc[o] = 0.0f;

  for (int c0 = 0; c0 < a.k; c0 += kChunk) {
    const float r_t = (t < kChunk) ? a.in[3][base + c0 + t] : 0.0f;
    // Also the barrier after the previous chunk's reads of shared memory.
    if (!__syncthreads_or(r_t >= 0.5f)) continue;
    if (t < kChunk) {
      const float u = a.in[0][base + c0 + t];
      const float v = a.in[1][base + c0 + t];
      const float z = a.in[2][base + c0 + t];
      s_u[t] = u;
      s_v[t] = v;
      s_z[t] = z;
      s_r[t] = r_t;
      s_fu[t] = floorf(u);
      s_fv[t] = floorf(v);
      s_ir[t] = 1.0f / fmaxf(r_t, 0.5f);
      s_ez[t] = expf(-a.falloff * z);
    }
    __syncthreads();
    for (int j = 0; j < kChunk; ++j) {
      if (!(s_r[j] >= 0.5f) || fabsf(px - s_fu[j]) > half ||
          fabsf(py - s_fv[j]) > half)
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
      const float w = cov * s_ez[j];
      acc[0] += (nx * 0.5f + 0.5f) * w;
      acc[1] += (ny * 0.5f + 0.5f) * w;
      acc[2] += (nz * 0.5f + 0.5f) * w;
      acc[3] += w;
      acc[4] += cov;
      acc[5] += w * s_z[j];
      if constexpr (kNormals) {
        acc[6] += w * nx;
        acc[7] += w * ny;
        acc[8] += w * nz;
      }
    }
  }
  const long long pix = static_cast<long long>(blockIdx.x) * kPix + t;
#pragma unroll
  for (int o = 0; o < kOut; ++o) a.out[o][pix] = acc[o];
}

template <bool kNormals>
int launch_fwd_tile(const float* const* in, float* const* out, int n_tiles,
                    int k, int half, float sharpness, float falloff,
                    void* stream) {
  RasterArgs a{};
  for (int i = 0; i < 4; ++i) a.in[i] = in[i];
  for (int o = 0; o < (kNormals ? 9 : 6); ++o) a.out[o] = out[o];
  a.k = k;
  a.half = half;
  a.sharpness = sharpness;
  a.falloff = falloff;
  splat_fwd_tile_kernel<kNormals><<<n_tiles, kPix, 0,
                                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {
int emu_tile_fwd6(DFT_SPLAT_ARGS) {
  return launch_fwd_tile<false>(DFT_SPLAT_PASS);
}
int emu_tile_fwd9(DFT_SPLAT_ARGS) {
  return launch_fwd_tile<true>(DFT_SPLAT_PASS);
}
}
