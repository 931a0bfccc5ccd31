// A CPU emulation of the CUDA features csrc/sph_sweep.cu,
// csrc/splat_raster.cu, csrc/plane_advance.cu and csrc/pcisph_iter.cu use,
// for tests/test_torch_sweep_emulated*.py, tests/test_torch_raster_emulated.py,
// tests/test_torch_plane_advance_emulated.py and
// tests/test_torch_pcisph_iter_emulated.py: one std::thread per CUDA thread, a
// std::barrier for __syncthreads and per warp for the warp collectives,
// shared memory as static storage, CTAs run one at a time, `emu_sms`
// streaming multiprocessors of one resident CTA each. Arithmetic is the
// host's (rsqrtf is 1 / sqrtf), so it checks a kernel's logic, not its
// rounding on the card.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __shared__ static
#define __forceinline__ inline
#define __launch_bounds__(...)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
inline thread_local uint3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidConfiguration = 9,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaDevAttrMultiProcessorCount = 16
};
inline int emu_sms = 2;
template <class K>
cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = emu_sms;
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int,
                                                          int) {
  *n = 1;
  return cudaSuccess;
}

inline std::barrier<>* emu_block_bar;
inline std::barrier<>* emu_warp_bar[32];
inline unsigned emu_warp_vals[32][32];
inline int emu_block_or;
inline std::mutex emu_mu;
inline char* emu_dyn_smem;

inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }
inline int __syncthreads_or(int p) {
  emu_block_bar->arrive_and_wait();
  if (threadIdx.x == 0) emu_block_or = 0;
  emu_block_bar->arrive_and_wait();
  if (p) {
    std::lock_guard<std::mutex> lock(emu_mu);
    emu_block_or = 1;
  }
  emu_block_bar->arrive_and_wait();
  const int r = emu_block_or;
  emu_block_bar->arrive_and_wait();
  return r;
}
// Every lane of the warp posts v; returns the OR of the posts (as bits of
// the lanes whose post is nonzero, for a ballot).
inline unsigned emu_warp_collect(unsigned v, bool ballot) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_warp_vals[w][l] = v;
  emu_warp_bar[w]->arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i)
    r |= ballot ? (emu_warp_vals[w][i] ? 1u << i : 0u) : emu_warp_vals[w][i];
  emu_warp_bar[w]->arrive_and_wait();
  return r;
}
inline unsigned __ballot_sync(unsigned, int p) {
  return emu_warp_collect(p ? 1u : 0u, true);
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  return emu_warp_collect(v, false);
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_warp_vals[w][l] = v;
  emu_warp_bar[w]->arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r = std::max(r, emu_warp_vals[w][i]);
  emu_warp_bar[w]->arrive_and_wait();
  return r;
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(unsigned v) { return __builtin_ffs(static_cast<int>(v)); }
inline void __threadfence() {}
template <class T>
T atomicAdd(T* p, T v) {
  std::lock_guard<std::mutex> lock(emu_mu);
  const T o = *p;
  *p += v;
  return o;
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
  std::lock_guard<std::mutex> lock(emu_mu);
  const unsigned o = *p;
  *p |= v;
  return o;
}
inline unsigned atomicMax(unsigned* p, unsigned v) {
  std::lock_guard<std::mutex> lock(emu_mu);
  const unsigned o = *p;
  *p = std::max(o, v);
  return o;
}
inline unsigned __float_as_uint(float x) {
  unsigned u;
  std::memcpy(&u, &x, sizeof u);
  return u;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline float fmaxf(float a, float b) { return std::fmax(a, b); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
using std::max;
using std::min;

// kernel<<<grid, block, smem, stream>>>(...) becomes emu_launch(grid,
// block, smem, [=] { kernel(...); }): every CTA in turn, its dynamic shared
// memory filled with garbage first, as it may hold on the card. While
// `emu_deferred` is set, launches queue instead, and emu_flush() runs the
// queued launches' CTAs in turns (CTA 0 of each, then CTA 1 of each, ...),
// as launches on two streams may share the card.
struct EmuLaunch {
  dim3 grid, block;
  size_t smem;
  std::function<void()> fn;
  std::vector<char> dyn;
};
inline bool emu_deferred = false;
inline std::vector<EmuLaunch> emu_queue;

inline void emu_run_cta(EmuLaunch& launch, unsigned bx, unsigned by) {
  gridDim = launch.grid;
  blockDim = launch.block;
  emu_dyn_smem = launch.dyn.data();
  const int nt = static_cast<int>(launch.block.x), nw = (nt + 31) / 32;
  std::barrier<> bb(nt);
  emu_block_bar = &bb;
  std::vector<std::unique_ptr<std::barrier<>>> wb;
  for (int w = 0; w < nw; ++w) {
    wb.emplace_back(new std::barrier<>(32));
    emu_warp_bar[w] = wb.back().get();
  }
  std::memset(emu_dyn_smem, 0xff, launch.smem);
  std::vector<std::thread> th;
  const std::function<void()>& fn = launch.fn;
  for (int t = 0; t < nt; ++t)
    th.emplace_back([=, &fn] {
      threadIdx = {static_cast<unsigned>(t), 0, 0};
      blockIdx = {bx, by, 0};
      fn();
    });
  for (auto& x : th) x.join();
}

inline void emu_launch(dim3 grid, dim3 block, size_t smem,
                       std::function<void()> fn) {
  EmuLaunch launch{grid, block, smem, std::move(fn),
                   std::vector<char>(smem + 16)};
  if (emu_deferred) {
    emu_queue.push_back(std::move(launch));
    return;
  }
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) emu_run_cta(launch, bx, by);
}

inline void emu_flush() {
  unsigned most = 0;
  for (auto& l : emu_queue) most = std::max(most, l.grid.x * l.grid.y);
  for (unsigned i = 0; i < most; ++i)
    for (auto& l : emu_queue)
      if (i < l.grid.x * l.grid.y) emu_run_cta(l, i % l.grid.x, i / l.grid.x);
  emu_queue.clear();
}
