// Irreversible colour transform (ICT) of the 9/7 path, fused with the DC
// level shift and the float conversions on each side, over a (C, count)
// stack of planes.
//
// Replaces what grok_tpu runs as XLA outside Pallas (ROADMAP B6):
//   dc_shift + .astype(float32) + ict_forward (grok_tpu/ops/mct.py:23, :46;
//   ops/pipeline.py:43-54)                            ->  grk_ict_fwd
//   ict_inverse + jnp.round + .astype(int32) + dc_unshift (mct.py:54, :29;
//   pipeline.py:78-87)                                ->  grk_ict_inv
// With a tile of one resolution there is no DWT level to fuse the
// quantizer into, so grk_ict_fwd quantizes its stores and grk_ict_inv
// dequantizes its loads when given a step (mct.py quantize / dequantize).
//
// What bounds it: device-memory bytes.  Each sample moves 8 bytes (4 in,
// 4 out) for about 6 operations, far below the card's ratio of operations
// to bytes.  Design: one thread an element index in a grid-stride loop,
// doing the element of every component; neighbouring threads touch
// neighbouring elements of each plane, so every load and store coalesces.
//
// Numerics, as grok_tpu computes them: the shift is an int32 subtraction
// that wraps; the cast rounds to nearest; the forward sums are left to
// right, (m0 r + m1 g) + m2 b, and the inverse uses only m02, m11, m12 and
// m21; each product and sum is rounded on its own (__fadd_rn and __fmul_rn
// are never contracted into a fused multiply-add); the coefficients come
// from the host, rounded to float32 from grok_tpu's float64 matrices.  The
// inverse rounds half to even and converts with saturation, NaN to 0
// (__float2int_rn, as XLA's round and conversion do), then adds the shift
// as int32 with wrap and clips.  The quantizer divides |v| by its step
// (__fdiv_rn, IEEE), floors and converts with saturation.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;

struct FwdConsts {
  float m[9];  // ICT_FWD, row-major
  float step;  // quantizer step; 0: store float32
};

struct InvConsts {
  float m02, m11, m12, m21;  // the nonzero off-diagonal terms of ICT_INV
  float half_step;           // dequantizer; 0: the input is float32
};

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t clamp(int32_t v, int32_t lo, int32_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void put(void* out, long long i, float v,
                                    float step) {
  if (step > 0.0f) {
    const int32_t q = __float2int_rz(floorf(__fdiv_rn(fabsf(v), step)));
    static_cast<int32_t*>(out)[i] = v < 0.0f ? -q : q;
  } else {
    static_cast<float*>(out)[i] = v;
  }
}

__device__ __forceinline__ float get(const void* in, long long i,
                                     float half_step) {
  if (half_step > 0.0f) {
    return __fmul_rn(__int2float_rn(static_cast<const int32_t*>(in)[i]),
                     half_step);
  }
  return static_cast<const float*>(in)[i];
}

// (m0 r + m1 g) + m2 b
__device__ __forceinline__ float dot3(const float* m, float r, float g,
                                      float b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(m[0], r), __fmul_rn(m[1], g)),
                   __fmul_rn(m[2], b));
}

__global__ void ict_fwd_kernel(const int32_t* __restrict__ x,
                               void* __restrict__ out, int ncomp,
                               long long count, int32_t shift, int ict,
                               FwdConsts c) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < count; i += step) {
    int comp = 0;
    if (ict) {
      const float r = __int2float_rn(wsub(x[i], shift));
      const float g = __int2float_rn(wsub(x[count + i], shift));
      const float b = __int2float_rn(wsub(x[2 * count + i], shift));
      put(out, i, dot3(c.m, r, g, b), c.step);
      put(out, count + i, dot3(c.m + 3, r, g, b), c.step);
      put(out, 2 * count + i, dot3(c.m + 6, r, g, b), c.step);
      comp = 3;
    }
    for (; comp < ncomp; ++comp) {
      const long long j = comp * count + i;
      put(out, j, __int2float_rn(wsub(x[j], shift)), c.step);
    }
  }
}

__global__ void ict_inv_kernel(const void* __restrict__ x,
                               int32_t* __restrict__ out, int ncomp,
                               long long count, int32_t shift, int32_t lo,
                               int32_t hi, int ict, InvConsts c) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < count; i += step) {
    int comp = 0;
    if (ict) {
      const float y = get(x, i, c.half_step);
      const float cb = get(x, count + i, c.half_step);
      const float cr = get(x, 2 * count + i, c.half_step);
      const float r = __fadd_rn(y, __fmul_rn(c.m02, cr));
      const float g = __fadd_rn(__fadd_rn(y, __fmul_rn(c.m11, cb)),
                                __fmul_rn(c.m12, cr));
      const float b = __fadd_rn(y, __fmul_rn(c.m21, cb));
      out[i] = clamp(wadd(__float2int_rn(r), shift), lo, hi);
      out[count + i] = clamp(wadd(__float2int_rn(g), shift), lo, hi);
      out[2 * count + i] = clamp(wadd(__float2int_rn(b), shift), lo, hi);
      comp = 3;
    }
    for (; comp < ncomp; ++comp) {
      const long long j = comp * count + i;
      out[j] = clamp(wadd(__float2int_rn(get(x, j, c.half_step)), shift),
                     lo, hi);
    }
  }
}

cudaError_t blocks_for(int ncomp, long long count, int ict,
                       unsigned* blocks) {
  if (count <= 0 || ncomp <= 0 || (ict && ncomp < 3))
    return cudaErrorInvalidValue;
  long long n = (count + kThreads - 1) / kThreads;
  *blocks = static_cast<unsigned>(n < kMaxBlocks ? n : kMaxBlocks);
  return cudaSuccess;
}

}  // namespace

// DC shift (by `shift`: 2^(prec-1), or 0 for signed components), cast to
// float32 and, when `ict` is nonzero, the forward ICT of components 0-2, on
// `ncomp` contiguous int32 planes of `count` samples.  consts: ten float32
// on the host, ICT_FWD row-major and the quantizer step (0:
// float32 out; else int32 quantized out).
extern "C" int grk_ict_fwd(const void* x, void* out, int ncomp,
                           long long count, int shift, int ict,
                           const float* consts, void* stream) {
  unsigned blocks;
  cudaError_t err = blocks_for(ncomp, count, ict, &blocks);
  if (err != cudaSuccess) return err;
  FwdConsts c;
  for (int i = 0; i < 9; ++i) c.m[i] = consts[i];
  c.step = consts[9];
  ict_fwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), out, ncomp, count, shift, ict, c);
  return cudaGetLastError();
}

// When `ict` is nonzero the inverse ICT of components 0-2, then for every
// component rounding half to even, the saturating conversion to int32, the
// DC unshift and the clip of precision `prec` (1..31), signed when `sgnd`
// is nonzero.  consts: five float32 on the host, m02, m11, m12 and m21 of
// ICT_INV and the half quantizer step (0: the input is float32; else it is
// doubled-domain int32, dequantized on load).
extern "C" int grk_ict_inv(const void* x, void* out, int ncomp,
                           long long count, int prec, int sgnd, int ict,
                           const float* consts, void* stream) {
  if (prec < 1 || prec > 31) return cudaErrorInvalidValue;
  unsigned blocks;
  cudaError_t err = blocks_for(ncomp, count, ict, &blocks);
  if (err != cudaSuccess) return err;
  const long long half = 1LL << (prec - 1);
  const int32_t shift = sgnd ? 0 : static_cast<int32_t>(half);
  const int32_t lo = sgnd ? static_cast<int32_t>(-half) : 0;
  const int32_t hi = static_cast<int32_t>(sgnd ? half - 1 : 2 * half - 1);
  InvConsts c{consts[0], consts[1], consts[2], consts[3], consts[4]};
  ict_inv_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<int32_t*>(out), ncomp, count, shift, lo, hi, ict, c);
  return cudaGetLastError();
}
