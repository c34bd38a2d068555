// Host emulation of the CUDA features the 2-D transform kernels
// (grok_tpu_torch/csrc/dwt97_level.cu, ict.cu) use, so that their sources
// compile with g++ and run on the CPU in
// tests/test_torch_dwt97_host_kernels.py.  A CTA is blockDim.x * blockDim.y
// host threads that walk the grid's CTAs in order, a barrier between two:
// __syncthreads is a barrier of those threads and a kernel's static
// __shared__ array is one static array.  The float intrinsics are the plain
// IEEE operations: the test compiles with -ffp-contract=off, so none is
// fused into a multiply-add; the conversions saturate and send NaN to 0, as
// the card's do.
#pragma once

#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(n)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct Idx {
  unsigned x = 0, y = 0, z = 0;
};
static thread_local Idx threadIdx;
static thread_local Idx blockIdx;
static dim3 gridDim, blockDim;
static std::barrier<>* g_cta;

using cudaError_t = int;
using cudaStream_t = void*;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;

static inline void __syncthreads() { g_cta->arrive_and_wait(); }

static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __int2float_rn(int v) { return static_cast<float>(v); }

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

// Run `kernel` on `grid` CTAs of `block` threads.
template <class F>
static void run_grid(dim3 grid, dim3 block, F kernel) {
  const unsigned n = block.x * block.y;
  std::barrier<> cta(n);
  g_cta = &cta;
  gridDim = grid;
  blockDim = block;
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < n; ++t)
    threads.emplace_back([&, t] {
      threadIdx.x = t % block.x;
      threadIdx.y = t / block.x;
      for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = 0; y < grid.y; ++y)
          for (unsigned x = 0; x < grid.x; ++x) {
            blockIdx.x = x;
            blockIdx.y = y;
            blockIdx.z = z;
            kernel();
            cta.arrive_and_wait();  // the CTA's shared array is free again
          }
    });
  for (auto& t : threads) t.join();
}
