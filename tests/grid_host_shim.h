// Host emulation of the CUDA features the 2-D transform kernels
// (grok_tpu_torch/csrc/dwt97_level.cu, ict.cu) and the HT decode kernels
// (ht_decode.cu) use, so that their sources compile with g++ and run on the
// CPU in tests/test_torch_dwt97_host_kernels.py and
// tests/test_torch_ht_host_kernels.py.  A CTA is blockDim.x * blockDim.y
// fibers (ucontext) on one host thread, and the grid's CTAs run in order: a
// fiber runs until it reaches a barrier, __syncthreads being one of all the
// CTA's fibers and __syncwarp one of a warp's 32, and the warp shuffles go
// through a shared array between two warp barriers; a barrier that can
// never complete fails the launch.  (Host threads would do the same, but
// every barrier would wait on the OS scheduler, minutes of a test run on a
// busy machine.)  The kernel's dynamic shared memory is one static buffer,
// filled with NaN bytes before each CTA, so that a stored value that
// depended on a word the CTA never wrote shows.  The cp.async primitives
// (<cuda_pipeline.h>) are a plain copy, their commit and wait no-ops: a
// copy is done when it is issued.  The float intrinsics are the plain
// IEEE operations: the test compiles with -ffp-contract=off, so none is
// fused into a multiply-add; the conversions saturate and send NaN to 0, as
// the card's do.  The warp votes and reduction (__ballot_sync,
// __any_sync, __reduce_add_sync) go through the shuffles' array too; atomicMax is a
// plain read-modify-write, since one fiber runs at a time; the integer
// intrinsics are their definitions.
#pragma once

#include <ucontext.h>

#include <bit>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __align__(n)
#define __launch_bounds__(...)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct Idx {
  unsigned x = 0, y = 0, z = 0;
};
static Idx threadIdx;  // the running fiber's
static Idx blockIdx;
static unsigned g_tid;  // the running fiber's linear index in the CTA
static dim3 gridDim, blockDim;
static std::vector<uint64_t> g_lanes;  // a value a thread, for shuffles

struct Fiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  bool blocked = false, done = false;
};
struct Barrier {
  unsigned need = 0, arrived = 0;
  std::vector<Fiber*> waiting;
};
static std::vector<Fiber> g_fibers;
static Fiber* g_cur;
static ucontext_t g_scheduler;
static Barrier g_cta;
static std::vector<Barrier> g_warps;
static void (*g_call)(void*);  // the kernel launch the fibers run
static void* g_arg;

// The running fiber arrives at `b`: the last to arrive releases the others
// and goes on; the others wait for it.
static inline void arrive(Barrier& b) {
  if (++b.arrived == b.need) {
    for (Fiber* f : b.waiting) f->blocked = false;
    b.waiting.clear();
    b.arrived = 0;
    return;
  }
  g_cur->blocked = true;
  b.waiting.push_back(g_cur);
  swapcontext(&g_cur->ctx, &g_scheduler);
}

namespace {
// the kernels' dynamic shared memory (`extern __shared__ float smem[]`)
alignas(16) float smem[232448 / 4];
}  // namespace

using cudaError_t = int;
using cudaStream_t = void*;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;

// The runtime queries of a launcher's planning: there is no device here,
// and the tests' launchers plan for a capacity they choose.
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
enum cudaFuncAttribute { cudaFuncAttributePreferredSharedMemoryCarveout };
constexpr int cudaSharedmemCarveoutMaxShared = 100;
static inline cudaError_t cudaGetDevice(int*) { return cudaErrorInvalidValue; }
static inline cudaError_t cudaDeviceGetAttribute(int*, cudaDeviceAttr, int) {
  return cudaErrorInvalidValue;
}
static inline cudaError_t cudaFuncSetAttribute(const void*,
                                               cudaFuncAttribute, int) {
  return cudaErrorInvalidValue;
}
static inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int*, const void*, int, size_t) {
  return cudaErrorInvalidValue;
}

struct alignas(8) float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(8) int2 {
  int x, y;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
static inline float2 make_float2(float x, float y) { return {x, y}; }
static inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
static inline int2 make_int2(int x, int y) { return {x, y}; }

static inline void __syncthreads() { arrive(g_cta); }
static inline void __syncwarp(unsigned = 0xFFFFFFFFu) {
  arrive(g_warps[g_tid / 32]);
}

// lane `src` of this thread's warp's v (a value of at most 8 bytes), or the
// thread's own v when `src` lies outside the warp (as __shfl_up_sync /
// __shfl_down_sync give it)
template <class T>
static inline T shuffle(T v, int src) {
  static_assert(sizeof(T) <= sizeof(uint64_t));
  const unsigned base = g_tid / 32 * 32;
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  g_lanes[g_tid] = u;
  __syncwarp();
  const uint64_t r = g_lanes[src >= 0 && src < 32 ? base + src : g_tid];
  __syncwarp();
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}
template <class T>
static inline T __shfl_up_sync(unsigned, T v, unsigned d) {
  return shuffle(v, static_cast<int>(g_tid % 32) - static_cast<int>(d));
}
template <class T>
static inline T __shfl_down_sync(unsigned, T v, unsigned d) {
  return shuffle(v, static_cast<int>(g_tid % 32 + d));
}
template <class T>
static inline T __shfl_sync(unsigned, T v, int src) {
  return shuffle(v, src & 31);
}
static inline unsigned __ballot_sync(unsigned, int pred) {
  const unsigned base = g_tid / 32 * 32;
  g_lanes[g_tid] = pred != 0;
  __syncwarp();
  unsigned m = 0;
  for (unsigned i = 0; i < 32; ++i)
    if (g_lanes[base + i]) m |= 1u << i;
  __syncwarp();
  return m;
}
static inline int __any_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) != 0;
}
template <class T>
static inline T __reduce_add_sync(unsigned, T v) {
  static_assert(sizeof(T) == 4);
  const unsigned base = g_tid / 32 * 32;
  g_lanes[g_tid] = static_cast<uint32_t>(v);
  __syncwarp();
  uint32_t sum = 0;  // wraps, as the card's
  for (unsigned i = 0; i < 32; ++i)
    sum += static_cast<uint32_t>(g_lanes[base + i]);
  __syncwarp();
  return static_cast<T>(sum);
}

static inline int __popc(unsigned x) { return __builtin_popcount(x); }
static inline int __clz(int x) {
  return x ? __builtin_clz(static_cast<unsigned>(x)) : 32;
}
static inline int __clzll(long long x) {
  return x ? __builtin_clzll(static_cast<unsigned long long>(x)) : 64;
}
static inline int __ffs(int x) { return __builtin_ffs(x); }
// byte s<4i+2:4i> of the eight bytes y:x is byte i of the result
static inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t b = (static_cast<uint64_t>(y) << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    r |= static_cast<unsigned>((b >> (8 * ((s >> (4 * i)) & 7))) & 0xFF)
         << (8 * i);
  return r;
}
static inline unsigned __funnelshift_r(unsigned lo, unsigned hi,
                                       unsigned shift) {
  return static_cast<unsigned>(
      ((static_cast<uint64_t>(hi) << 32) | lo) >> (shift & 31));
}
static inline unsigned __funnelshift_l(unsigned lo, unsigned hi,
                                       unsigned shift) {
  return static_cast<unsigned>(
      (((static_cast<uint64_t>(hi) << 32) | lo) << (shift & 31)) >> 32);
}
template <class T>
static inline T atomicMax(T* p, T v) {
  const T old = *p;
  if (v > old) *p = v;
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

static inline void __pipeline_memcpy_async(void* dst, const void* src,
                                           size_t bytes) {
  std::memcpy(dst, src, bytes);
}
static inline void __pipeline_commit() {}
static inline void __pipeline_wait_prior(size_t) {}

static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __int2float_rn(int v) { return static_cast<float>(v); }
static inline float __int_as_float(int v) { return std::bit_cast<float>(v); }

static inline int saturate(float v) {
  if (std::isnan(v)) return 0;
  if (v >= 2147483648.0f) return INT32_MAX;
  if (v < -2147483648.0f) return INT32_MIN;
  return static_cast<int>(v);
}
static inline int __float2int_rz(float v) { return saturate(std::trunc(v)); }
static inline int __float2int_rn(float v) {
  return saturate(std::nearbyint(v));  // to nearest, ties to even
}

template <class F>
static void call(void* kernel) {
  (*static_cast<F*>(kernel))();
}
static void fiber_main() {
  g_call(g_arg);
  g_cur->done = true;  // and back to the scheduler (uc_link)
}

// Run `kernel` on `grid` CTAs of `block` threads; 0, or 1 when a CTA's
// fibers all wait on barriers that cannot complete.
template <class F>
static int run_grid(dim3 grid, dim3 block, F kernel) {
  constexpr size_t kStack = 1 << 16;
  const unsigned n = block.x * block.y;
  g_call = &call<F>;
  g_arg = &kernel;
  g_fibers = std::vector<Fiber>(n);
  for (Fiber& f : g_fibers) f.stack.reset(new char[kStack]);
  g_cta = Barrier{n};
  g_warps.assign((n + 31) / 32, Barrier{});
  for (unsigned w = 0; w < g_warps.size(); ++w)
    g_warps[w].need = n - 32 * w < 32 ? n - 32 * w : 32;
  g_lanes.assign(n, 0);
  gridDim = grid;
  blockDim = block;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = {x, y, z};
        std::memset(smem, 0xFF, sizeof smem);
        for (Fiber& f : g_fibers) {
          f.blocked = f.done = false;
          getcontext(&f.ctx);
          f.ctx.uc_stack.ss_sp = f.stack.get();
          f.ctx.uc_stack.ss_size = kStack;
          f.ctx.uc_link = &g_scheduler;
          makecontext(&f.ctx, fiber_main, 0);
        }
        for (unsigned left = n; left > 0;) {
          bool ran = false;
          for (unsigned t = 0; t < n; ++t) {
            Fiber& f = g_fibers[t];
            if (f.done || f.blocked) continue;
            g_cur = &f;
            g_tid = t;
            threadIdx = {t % block.x, t / block.x, 0};
            swapcontext(&g_scheduler, &f.ctx);
            ran = true;
            left -= f.done;
          }
          if (!ran) return 1;
        }
      }
  return 0;
}
