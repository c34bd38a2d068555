// Host emulation of the CUDA features the MQ kernels (grok_tpu_torch/csrc/
// mq_{encode,decode}.cu) use, so that their sources compile with g++ and
// run on the CPU in tests/test_torch_mq_host_kernels.py.  A CTA is 32 host
// threads, one a lane, and CTAs run one after another: __syncwarp is a
// barrier of the 32 threads, the warp shuffles and reductions go through a
// shared array between two barriers, and the kernel's dynamic shared memory
// is one static buffer, filled with garbage before each CTA.
#pragma once

#include <barrier>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __align__(n)
#define __launch_bounds__(n)

struct Dim {
  int x = 0;
};
static thread_local Dim threadIdx;
static Dim blockIdx;
static std::barrier<>* g_warp;
static uint64_t g_lanes[32];
namespace {
alignas(16) uint8_t smem[232448];
}

static inline void __syncwarp(unsigned = 0xFFFFFFFFu) {
  g_warp->arrive_and_wait();
}
template <class T>
static inline T exchange(T v, int src) {
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  g_lanes[threadIdx.x] = u;
  g_warp->arrive_and_wait();
  const uint64_t r = g_lanes[src];
  g_warp->arrive_and_wait();
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}
template <class T>
static inline T __shfl_sync(unsigned, T v, int src) {
  return exchange(v, src);
}
template <class T>
static inline T __shfl_xor_sync(unsigned, T v, int off) {
  return exchange(v, threadIdx.x ^ off);
}
static inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  g_lanes[threadIdx.x] = v;
  g_warp->arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i)
    if (g_lanes[i] > m) m = static_cast<unsigned>(g_lanes[i]);
  g_warp->arrive_and_wait();
  return m;
}
static inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
static inline int __ffs(int x) { return __builtin_ffs(x); }
static inline unsigned long long atomicAdd(unsigned long long* p,
                                           unsigned long long v) {
  const unsigned long long old = *p;
  *p += v;
  return old;
}
template <class T>
static inline T min(T a, T b) {
  return a < b ? a : b;
}
template <class T>
static inline T max(T a, T b) {
  return a > b ? a : b;
}

// Run `kernel` on a grid of n CTAs of one warp each.
template <class F>
static void run_grid(int n, F kernel) {
  for (int b = 0; b < n; ++b) {
    blockIdx.x = b;
    std::memset(smem, 0xA5, sizeof smem);
    std::barrier<> warp(32);
    g_warp = &warp;
    std::vector<std::thread> lanes;
    for (int l = 0; l < 32; ++l)
      lanes.emplace_back([&, l] {
        threadIdx.x = l;
        kernel();
      });
    for (auto& t : lanes) t.join();
  }
}
