// One level of the irreversible 9/7 DWT of a stack of float32 planes, both
// axes in one launch, with the dead-zone quantizer fused into the forward
// level's stores and the dequantizer into the inverse level's loads.
//
// Replaces what grok_tpu runs as XLA outside Pallas (ROADMAP B5):
//   fwd_level + fwd_97_axis (grok_tpu/ops/dwt.py:119, :79), and quantize
//   (grok_tpu/ops/mct.py:71) on its stores          ->  grk_fwd97_level
//   inv_level + inv_97_axis (dwt.py:129, :95), and dequantize (mct.py:76)
//   on its loads                                    ->  grk_inv97_level
//
// What bounds it: device-memory bytes.  A level reads every sample once and
// writes every coefficient once (8 bytes a sample) for about 18 float
// operations a sample (per axis four lifting steps of three operations on
// half the samples, and a scaling; the quantizer's four), about 2 a byte,
// far below the card's ratio of float32 rate to memory rate (20).  So, as in
// dwt53_level.cu, one block owns a tile of kTY x kTX output sample pairs:
//   1. it loads the tile's input plus a halo of kHalo = 4 samples a side
//      (the reach of four lifting steps) into shared memory once, each
//      thread issuing all of its loads before it stores any; the inverse
//      dequantizes and applies the horizontal scaling as it loads;
//   2. it lifts there: forward vertically, then horizontally; inverse
//      horizontally, then vertically (float lifting does not commute, and
//      grok_tpu/ops/dwt.py runs the axes in that order);
//   3. it writes each output once, the forward level scaling, quantizing
//      and converting as it stores.
// The halo costs (2 kTY + 8)(2 kTX + 8) / (4 kTY kTX) - 1, about 22% more
// loads than samples; neighbouring blocks share it through L2.
//
// Numerics: each product and sum is rounded to float32 on its own, as
// grok_tpu/ops/dwt.py writes them: __fadd_rn, __fsub_rn and __fmul_rn are
// never contracted into a fused multiply-add, whatever nvcc's -fmad.  The
// lifting constants and steps come from the host, rounded to float32 from
// grok_tpu's float64 values.  The quantizer divides |v| by the step
// (__fdiv_rn, IEEE), floors, and converts with saturation (NaN to 0), as
// XLA's float-to-int32 conversion does.
//
// Edges: whole-sample symmetric extension, applied to the indices when the
// tile is loaded.  Every lifting step updates a position from its two
// neighbours of the other parity, and a mirrored position has the same
// parity and mirrored neighbours, so the extended signal stays symmetric
// through the four steps and the lifting gives exactly the mirrored
// neighbours of grok_tpu/ops/dwt.py (_ev_right, _d_pair) for n >= 2.  A
// length of 1 skips the lifting along that axis; the scaling then makes the
// low band x / K forward and x K inverse, as the reference does.
//
// Layout: `planes` contiguous (h, w) planes; the four band stacks are
// ll (ceil(h/2), ceil(w/2)), hl (ceil(h/2), w/2), lh (h/2, ceil(w/2)),
// hh (h/2, w/2).  A band with a step of 0 is float32; with a step, int32
// (forward: quantized; inverse: doubled-domain Tier-1 output).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTX = 60;   // output sample pairs a block, along a row
constexpr int kTY = 28;   // output sample pairs a block, down a column
constexpr int kHalo = 4;  // the reach of the four lifting steps
// The shared tile: local index k holds global index 2 * (first pair) - kHalo
// + k on each axis, so local parity equals global parity; the block's own
// samples sit at local kHalo .. kHalo + 2 T - 1.
constexpr int kRows = 2 * kTY + 2 * kHalo;  // 64
constexpr int kCols = 2 * kTX + 2 * kHalo;  // 128
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kColSlots = kCols / 32;      // a lane's loaded columns
constexpr int kRowSlots = kRows / kWarps;  // a warp's loaded rows
static_assert(kCols % 32 == 0 && kRows % kWarps == 0, "whole slots");

// The lifting constants and the four bands' steps, float32 from the host:
// forward, the quantizer step; inverse, half the step; 0 marks a float32
// band.
struct Consts {
  float alpha, beta, gamma, delta, k, inv_k;
  float step[4];  // ll, hl, lh, hh
};

// Whole-sample symmetric reflection of index k into [0, n).
__device__ __forceinline__ int reflect(int k, int n) {
  if (k >= 0 && k < n) return k;
  if (n == 1) return 0;
  const int period = 2 * n - 2;
  k = abs(k) % period;
  return k < n ? k : period - k;
}

// a + c (l + r) and a - c (l + r), each operation rounded on its own
__device__ __forceinline__ float lift(float a, float c, float l, float r) {
  return __fadd_rn(a, __fmul_rn(c, __fadd_rn(l, r)));
}
__device__ __forceinline__ float unlift(float a, float c, float l, float r) {
  return __fsub_rn(a, __fmul_rn(c, __fadd_rn(l, r)));
}

// sign(v) floor(|v| / step), converted with saturation, NaN to 0
__device__ __forceinline__ int32_t quantize(float v, float step) {
  const int32_t q = __float2int_rz(floorf(__fdiv_rn(fabsf(v), step)));
  return v < 0.0f ? -q : q;
}

__device__ __forceinline__ void store_band(void* band, long long i, float v,
                                           float step) {
  if (step > 0.0f) {
    static_cast<int32_t*>(band)[i] = quantize(v, step);
  } else {
    static_cast<float*>(band)[i] = v;
  }
}

__device__ __forceinline__ float load_band(const void* band, long long i,
                                           float half_step) {
  if (half_step > 0.0f) {
    return __fmul_rn(__int2float_rn(static_cast<const int32_t*>(band)[i]),
                     half_step);
  }
  return static_cast<const float*>(band)[i];
}

// One lifting step down the columns [c0, c1) of the shared tile: every
// other row from `first` to `last` from its neighbours above and below,
// which the step does not write; a barrier follows.
template <bool kForward>
__device__ __forceinline__ void vertical_step(float (*t)[kCols], int first,
                                              int last, int c0, int c1,
                                              float coef) {
  for (int r = first + 2 * threadIdx.y; r <= last; r += 2 * kWarps) {
    for (int c = c0 + threadIdx.x; c < c1; c += 32) {
      t[r][c] = kForward ? lift(t[r][c], coef, t[r - 1][c], t[r + 1][c])
                         : unlift(t[r][c], coef, t[r - 1][c], t[r + 1][c]);
    }
  }
  __syncthreads();
}

// One lifting step along the rows [r0, r1): every other column from
// `first` to `last`; a barrier follows.
template <bool kForward>
__device__ __forceinline__ void horizontal_step(float (*t)[kCols], int first,
                                                int last, int r0, int r1,
                                                float coef) {
  for (int r = r0 + threadIdx.y; r < r1; r += kWarps) {
    for (int c = first + 2 * threadIdx.x; c <= last; c += 64) {
      t[r][c] = kForward ? lift(t[r][c], coef, t[r][c - 1], t[r][c + 1])
                         : unlift(t[r][c], coef, t[r][c - 1], t[r][c + 1]);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
fwd97_level_kernel(const float* __restrict__ x, void* __restrict__ ll,
                   void* __restrict__ hl, void* __restrict__ lh,
                   void* __restrict__ hh, int h, int w, Consts k) {
  __shared__ float t[kRows][kCols];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int ne_h = (h + 1) >> 1, no_h = h >> 1;
  const int ne_w = (w + 1) >> 1, no_w = w >> 1;
  const int i0 = blockIdx.y * kTY, j0 = blockIdx.x * kTX;  // first pair
  const long long plane = blockIdx.z;
  x += plane * h * w;

  // 1. input rows [2 i0 - 4, 2 i0 + 2 kTY + 4), columns likewise
  int gc[kColSlots];
#pragma unroll
  for (int s = 0; s < kColSlots; ++s) {
    gc[s] = reflect(2 * j0 - kHalo + lane + 32 * s, w);
  }
  float v[kRowSlots][kColSlots];
#pragma unroll
  for (int q = 0; q < kRowSlots; ++q) {
    const float* row =
        x + static_cast<long long>(
                reflect(2 * i0 - kHalo + warp + kWarps * q, h)) * w;
#pragma unroll
    for (int s = 0; s < kColSlots; ++s) v[q][s] = row[gc[s]];
  }
#pragma unroll
  for (int q = 0; q < kRowSlots; ++q) {
#pragma unroll
    for (int s = 0; s < kColSlots; ++s) {
      t[warp + kWarps * q][lane + 32 * s] = v[q][s];
    }
  }
  __syncthreads();

  // 2. vertical on every loaded column: the four steps, each reaching one
  //    row further in from the tile's edge, then the scaling of the rows
  //    the horizontal pass reads (even rows by 1/K, odd rows by K)
  if (h > 1) {
    vertical_step<true>(t, 1, kRows - 3, 0, kCols, k.alpha);
    vertical_step<true>(t, 2, kRows - 4, 0, kCols, k.beta);
    vertical_step<true>(t, 3, kRows - 5, 0, kCols, k.gamma);
    vertical_step<true>(t, 4, kRows - 6, 0, kCols, k.delta);
  }
  for (int r = kHalo + warp; r < kHalo + 2 * kTY; r += kWarps) {
    const float f = r & 1 ? k.k : k.inv_k;
    for (int c = lane; c < kCols; c += 32) t[r][c] = __fmul_rn(t[r][c], f);
  }
  __syncthreads();
  // horizontal on the rows that hold this tile's coefficients
  if (w > 1) {
    const int r0 = kHalo, r1 = kHalo + 2 * kTY;
    horizontal_step<true>(t, 1, kCols - 3, r0, r1, k.alpha);
    horizontal_step<true>(t, 2, kCols - 4, r0, r1, k.beta);
    horizontal_step<true>(t, 3, kCols - 5, r0, r1, k.gamma);
    horizontal_step<true>(t, 4, kCols - 6, r0, r1, k.delta);
  }

  // 3. the four bands, the horizontal scaling (even columns by 1/K, odd by
  //    K) applied here: pair (a, b) of the tile sits at local (2a + kHalo +
  //    dy, 2b + kHalo + dx), dy/dx 0 for low and 1 for high
  for (int a = warp; a < kTY; a += kWarps) {
    const long long bi = i0 + a;
    const int r = 2 * a + kHalo;
    for (int b = lane; b < kTX; b += 32) {
      const int bj = j0 + b, c = 2 * b + kHalo;
      if (bi < ne_h) {
        if (bj < ne_w) {
          store_band(ll, (plane * ne_h + bi) * ne_w + bj,
                     __fmul_rn(t[r][c], k.inv_k), k.step[0]);
        }
        if (bj < no_w) {
          store_band(hl, (plane * ne_h + bi) * no_w + bj,
                     __fmul_rn(t[r][c + 1], k.k), k.step[1]);
        }
      }
      if (bi < no_h) {
        if (bj < ne_w) {
          store_band(lh, (plane * no_h + bi) * ne_w + bj,
                     __fmul_rn(t[r + 1][c], k.inv_k), k.step[2]);
        }
        if (bj < no_w) {
          store_band(hh, (plane * no_h + bi) * no_w + bj,
                     __fmul_rn(t[r + 1][c + 1], k.k), k.step[3]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
inv97_level_kernel(const void* __restrict__ ll, const void* __restrict__ hl,
                   const void* __restrict__ lh, const void* __restrict__ hh,
                   float* __restrict__ out, int h, int w, Consts k) {
  __shared__ float t[kRows][kCols];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int ne_h = (h + 1) >> 1, no_h = h >> 1;
  const int ne_w = (w + 1) >> 1, no_w = w >> 1;
  const int i0 = blockIdx.y * kTY, j0 = blockIdx.x * kTX;  // first pair
  const long long plane = blockIdx.z;

  // 1. the interleaved signal (even rows from ll/hl, odd from lh/hh; even
  //    columns from the low bands, odd from the high), global rows and
  //    columns from 2 T0 - 4 on, dequantized, then scaled for the
  //    horizontal inverse (even columns by K, odd by 1/K)
  int bc[kColSlots];
  bool odd_c[kColSlots];
#pragma unroll
  for (int s = 0; s < kColSlots; ++s) {
    const int gc = reflect(2 * j0 - kHalo + lane + 32 * s, w);
    bc[s] = gc >> 1;
    odd_c[s] = gc & 1;
  }
  float v[kRowSlots][kColSlots];
#pragma unroll
  for (int q = 0; q < kRowSlots; ++q) {
    const int gr = reflect(2 * i0 - kHalo + warp + kWarps * q, h);
    const bool odd_r = gr & 1;
    const long long row = plane * (odd_r ? no_h : ne_h) + (gr >> 1);
    const void* lo = odd_r ? lh : ll;
    const void* hi = odd_r ? hh : hl;
    const float s_lo = k.step[odd_r ? 2 : 0], s_hi = k.step[odd_r ? 3 : 1];
#pragma unroll
    for (int s = 0; s < kColSlots; ++s) {
      v[q][s] = odd_c[s]
                    ? __fmul_rn(load_band(hi, row * no_w + bc[s], s_hi),
                                k.inv_k)
                    : __fmul_rn(load_band(lo, row * ne_w + bc[s], s_lo),
                                k.k);
    }
  }
#pragma unroll
  for (int q = 0; q < kRowSlots; ++q) {
#pragma unroll
    for (int s = 0; s < kColSlots; ++s) {
      t[warp + kWarps * q][lane + 32 * s] = v[q][s];
    }
  }
  __syncthreads();

  // 2. horizontal on every loaded row: the four steps in reverse, each
  //    reaching one column further in
  if (w > 1) {
    horizontal_step<false>(t, 2, kCols - 2, 0, kRows, k.delta);
    horizontal_step<false>(t, 3, kCols - 3, 0, kRows, k.gamma);
    horizontal_step<false>(t, 4, kCols - 4, 0, kRows, k.beta);
    horizontal_step<false>(t, 5, kCols - 5, 0, kRows, k.alpha);
  }
  // vertical on this tile's columns: the scaling (even rows by K, odd by
  // 1/K), then the four steps in reverse
  const int c0 = kHalo, c1 = kHalo + 2 * kTX;
  for (int r = warp; r < kRows; r += kWarps) {
    const float f = r & 1 ? k.inv_k : k.k;
    for (int c = c0 + lane; c < c1; c += 32) t[r][c] = __fmul_rn(t[r][c], f);
  }
  __syncthreads();
  if (h > 1) {
    vertical_step<false>(t, 2, kRows - 2, c0, c1, k.delta);
    vertical_step<false>(t, 3, kRows - 3, c0, c1, k.gamma);
    vertical_step<false>(t, 4, kRows - 4, c0, c1, k.beta);
    vertical_step<false>(t, 5, kRows - 5, c0, c1, k.alpha);
  }

  // 3. the (2 kTY, 2 kTX) output tile
  for (int r = warp; r < 2 * kTY; r += kWarps) {
    const long long gr = 2LL * i0 + r;
    if (gr >= h) break;
    float* row = out + (plane * h + gr) * w + 2 * j0;
    for (int c = lane; c < 2 * kTX; c += 32) {
      if (2 * j0 + c < w) row[c] = t[r + kHalo][c + kHalo];
    }
  }
}

// Grid for one level of `planes` (h, w) planes, or an error when the shape
// does not fit one launch.
cudaError_t grid_for(int h, int w, int planes, dim3* grid) {
  if (h <= 0 || w <= 0 || planes <= 0 || planes > 65535)
    return cudaErrorInvalidValue;
  const int by = ((h + 1) / 2 + kTY - 1) / kTY;
  const int bx = ((w + 1) / 2 + kTX - 1) / kTX;
  if (by > 65535) return cudaErrorInvalidValue;
  *grid = dim3(static_cast<unsigned>(bx), static_cast<unsigned>(by),
               static_cast<unsigned>(planes));
  return cudaSuccess;
}

Consts consts_from(const float* f) {
  Consts c;
  c.alpha = f[0];
  c.beta = f[1];
  c.gamma = f[2];
  c.delta = f[3];
  c.k = f[4];
  c.inv_k = f[5];
  for (int i = 0; i < 4; ++i) c.step[i] = f[6 + i];
  return c;
}

}  // namespace

// consts: ten float32 on the host: ALPHA, BETA, GAMMA, DELTA, K, 1/K, then
// the quantizer step of ll, hl, lh and hh (0: a float32 band).
extern "C" int grk_fwd97_level(const void* x, void* ll, void* hl, void* lh,
                               void* hh, int h, int w, int planes,
                               const float* consts, void* stream) {
  dim3 grid;
  cudaError_t err = grid_for(h, w, planes, &grid);
  if (err != cudaSuccess) return err;
  fwd97_level_kernel<<<grid, dim3(32, kWarps), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), ll, hl, lh, hh, h, w,
      consts_from(consts));
  return cudaGetLastError();
}

// consts: as for grk_fwd97_level, with half the quantizer step of each
// band (0: a float32 band; else the band is doubled-domain int32).
extern "C" int grk_inv97_level(const void* ll, const void* hl, const void* lh,
                               const void* hh, void* out, int h, int w,
                               int planes, const float* consts,
                               void* stream) {
  dim3 grid;
  cudaError_t err = grid_for(h, w, planes, &grid);
  if (err != cudaSuccess) return err;
  inv97_level_kernel<<<grid, dim3(32, kWarps), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      ll, hl, lh, hh, static_cast<float*>(out), h, w, consts_from(consts));
  return cudaGetLastError();
}
