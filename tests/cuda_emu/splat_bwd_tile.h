// The tile rasterizer's old backward body, appended by
// tests/test_torch_raster_emulated.py to csrc/splat_raster.cu (which it then
// compiles for the CPU against cuda_runtime.h here) as the oracle the
// chunked K12 is held to bit for bit: splat_bwd_tile_kernel, one 256-thread
// CTA per tile that stages the tile's 6 or 9 cotangent planes and walks all
// k slots of it, each thread owning slots t, t + 256, ..., writing 0 for an
// empty one and summing a live one's gradients over its clipped patch box,
// as the library had it.

namespace {

constexpr int kTileBwdThreads = 256;

template <bool kNormals>
__global__ void __launch_bounds__(kTileBwdThreads)
splat_bwd_tile_kernel(const RasterArgs a) {
  constexpr int kCt = kNormals ? 9 : 6;
  __shared__ float s_ct[kCt][kPix];

  const long long tile_pix = static_cast<long long>(blockIdx.x) * kPix;
  for (int e = threadIdx.x; e < kCt * kPix; e += kTileBwdThreads)
    s_ct[e / kPix][e % kPix] = a.in[4 + e / kPix][tile_pix + e % kPix];
  __syncthreads();

  const long long base = static_cast<long long>(blockIdx.x) * a.k;
  for (int s = threadIdx.x; s < a.k; s += kTileBwdThreads) {
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
int launch_bwd_tile(const float* const* in, float* const* out, int n_tiles,
                    int k, int half, float sharpness, float falloff,
                    void* stream) {
  RasterArgs a{};
  for (int i = 0; i < 4 + (kNormals ? 9 : 6); ++i) a.in[i] = in[i];
  for (int o = 0; o < 4; ++o) a.out[o] = out[o];
  a.k = k;
  a.half = half;
  a.sharpness = sharpness;
  a.falloff = falloff;
  splat_bwd_tile_kernel<kNormals><<<n_tiles, kTileBwdThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {
int emu_tile_bwd6(DFT_SPLAT_ARGS) {
  return launch_bwd_tile<false>(DFT_SPLAT_PASS);
}
int emu_tile_bwd9(DFT_SPLAT_ARGS) {
  return launch_bwd_tile<true>(DFT_SPLAT_PASS);
}
}
