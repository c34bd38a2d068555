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
// operations a sample, about 2 a byte, far below the card's ratio of
// float32 rate to memory rate (20).  So the design keeps the memory busy:
//
// - Work: the plane is cut into strips of kTX output sample pairs (a
//   128-column input window: the strip's 120 columns and a halo of kHalo =
//   4, the reach of four lifting steps, a side) and each strip into
//   segments of whole chunks of kTY pair rows.  One CTA of 128 threads
//   walks one segment down its strip, chunk by chunk; the host sizes the
//   segments so that the grid is about one wave of resident CTAs.
// - Overlap: a two-stage ring of chunks in dynamic shared memory (24 KB,
//   so that 8 or 9 CTAs share an SM: chunks of 8 pair rows beat 12 and 16
//   on the card); the next chunk's rows are copied in with cp.async while
//   the current one lifts.
//   Interior columns go as one 16-byte (forward) or 8-byte (inverse) copy a
//   lane when the host finds the width a multiple of 4 and the pointers
//   aligned (the kVec variant); edge columns, whose indices reflect, and
//   other widths go as 4-byte copies.  Two CTA barriers a chunk.
// - The vertical pass is one thread a column walking down the rows: the
//   four lifting steps of a column are a pipeline with five floats of
//   state in registers, and that state carries from one chunk to the next,
//   so the vertical halo (8 rows) is loaded once a segment, not once a
//   chunk.  The forward writes its results in place; the inverse stores
//   its output rows straight from registers.
// - The horizontal pass is one warp a row: lane l holds columns 4l .. 4l+3
//   of the window, two (low, high) sample pairs, and takes its two
//   neighbours of the other parity with one shuffle a step.  No barrier
//   between steps, no bank conflict (every shared access is consecutive
//   words across lanes; a warp interleaves two rows' chains).  The forward
//   quantizes and stores each lane's two pairs of each band from registers
//   (8-byte stores in kVec).  The inverse's stage row holds a row of the
//   two bands it reads (even rows: ll and hl; odd rows: lh and hh) as 64
//   low then 64 high words, so each lane loads two words of each band, and
//   dequantizes them with the row's step, uniform across the warp: no
//   per-element band selection.
//
// Numerics: each product and sum is rounded to float32 on its own, as
// grok_tpu/ops/dwt.py writes them: __fadd_rn, __fsub_rn and __fmul_rn are
// never contracted into a fused multiply-add, whatever nvcc's -fmad.  The
// lifting constants and steps come from the host, rounded to float32 from
// grok_tpu's float64 values.  The quantizer divides |v| by the step
// (__fdiv_rn, IEEE), floors, and converts with saturation (NaN to 0), as
// XLA's float-to-int32 conversion does.  Forward: vertical steps, the
// vertical scaling, horizontal steps, the horizontal scaling, quantizer.
// Inverse: dequantizer, horizontal scaling, horizontal steps, vertical
// scaling, vertical steps.
//
// Edges: whole-sample symmetric extension, applied to the indices when a
// chunk is loaded.  Every lifting step updates a position from its two
// neighbours of the other parity, and a mirrored position has the same
// parity and mirrored neighbours, so the extended signal stays symmetric
// through the four steps and the lifting gives exactly the mirrored
// neighbours of grok_tpu/ops/dwt.py (_ev_right, _d_pair) for n >= 2.  Both
// passes compute every position of the window by the same formula, the
// ones near its edges from values that are not yet (or never) right; four
// steps reach two pairs, so those never feed a sample the CTA stores.  A
// length of 1 skips the lifting along that axis; the scaling then makes the
// low band x / K forward and x K inverse, as the reference does.
//
// Layout: `planes` contiguous (h, w) planes; the four band stacks are
// ll (ceil(h/2), ceil(w/2)), hl (ceil(h/2), w/2), lh (h/2, ceil(w/2)),
// hh (h/2, w/2).  A band with a step of 0 is float32; with a step, int32
// (forward: quantized; inverse: doubled-domain Tier-1 output).

#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTX = 60;   // output sample pairs a strip, along a row
constexpr int kTY = 8;    // output sample pairs a chunk, down a column
constexpr int kHalo = 4;  // the reach of the four lifting steps
constexpr int kCols = 2 * kTX + 2 * kHalo;  // 128: a lane 4 columns
constexpr int kPairs = kCols / 2;           // 64 (low, high) pairs a row
// A stage holds a chunk's 2 kTY input rows after kHalo * 2 rows that only
// the first chunk of a segment loads (the vertical halo above it).
constexpr int kLead = 2 * kHalo;          // 8
constexpr int kRows = 2 * kTY + kLead;    // 24
constexpr int kThreads = kCols;           // one thread a column
constexpr int kWarps = kThreads / 32;
constexpr int kStageFloats = kRows * kCols;
constexpr int kSmemBytes = 2 * kStageFloats * 4;  // the two-stage ring
static_assert(kCols == 128 && kPairs == 64, "a warp covers a row");
static_assert(kSmemBytes <= 48 * 1024, "no opt-in shared memory needed");

// The lifting constants and the four bands' steps, float32 from the host:
// forward, the quantizer step; inverse, half the step; 0 marks a float32
// band.
struct Consts {
  float alpha, beta, gamma, delta, k, inv_k;
  float step[4];  // ll, hl, lh, hh
};

// How a launch cuts its planes: sx strips of kTX pairs across, sy segments
// of seg pair rows (a multiple of kTY) down; CTA b takes strip b % sx of
// segment (b / sx) % sy of plane b / (sx sy).
struct Plan {
  int sx, sy, seg;
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

// A word of a band as a float: doubled-domain int32 times the half step,
// or the float32 itself.
__device__ __forceinline__ float dequantize(int32_t v, float half_step) {
  return half_step > 0.0f ? __fmul_rn(__int2float_rn(v), half_step)
                          : __int_as_float(v);
}

// Band pairs j and j + 1 of the row at `base` (lanes 1 .. 30 of a warp;
// the strip's pairs end before `end`), quantized when the band has a step.
template <bool kVec>
__device__ __forceinline__ void store_pair(void* band, long long base, int j,
                                           int end, float v0, float v1,
                                           float step) {
  if (step > 0.0f) {
    int32_t* p = static_cast<int32_t*>(band) + base + j;
    const int32_t q0 = quantize(v0, step), q1 = quantize(v1, step);
    if (kVec && j + 1 < end) {
      *reinterpret_cast<int2*>(p) = make_int2(q0, q1);
    } else {
      if (j < end) p[0] = q0;
      if (j + 1 < end) p[1] = q1;
    }
  } else {
    float* p = static_cast<float*>(band) + base + j;
    if (kVec && j + 1 < end) {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    } else {
      if (j < end) p[0] = v0;
      if (j + 1 < end) p[1] = v1;
    }
  }
}

// The rows of a CTA's segment and chunk: local row k of the stage holds
// input row g0 + k (reflected), g0 = 2 s0 - kHalo + 2 kTY c; the first
// chunk fills rows 0 .. kRows, the later ones kLead .. kRows (their halo
// above is the state carried in registers).  Rows past `last` (the last
// input row the segment needs) are neither loaded nor stored.
struct Chunk {
  int g0, first, last;
};

__device__ __forceinline__ Chunk chunk_rows(int s0, int s1, int c) {
  return {2 * s0 - kHalo + 2 * kTY * c, c == 0 ? 0 : kLead,
          2 * s1 + kHalo - 1};
}

// Copy a chunk of input rows, columns 2 j0 - kHalo .. + kCols, into a
// stage (cp.async; the caller commits).
template <bool kVec>
__device__ __forceinline__ void load_fwd(float* t, const float* x, int h,
                                         int w, int j0, Chunk ch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = 2 * j0 - kHalo + 4 * lane;  // this lane's 4 columns
  const bool whole = kVec && c0 >= 0 && c0 + 3 < w;
  int gc[4];  // otherwise one at a time, reflected
#pragma unroll
  for (int e = 0; e < 4; ++e) gc[e] = reflect(c0 + e, w);
  for (int k = ch.first + warp; k < kRows && ch.g0 + k <= ch.last;
       k += kWarps) {
    const float* row = x + static_cast<long long>(reflect(ch.g0 + k, h)) * w;
    float* dst = t + k * kCols + 4 * lane;
    if (whole) {
      __pipeline_memcpy_async(dst, row + c0, 16);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        __pipeline_memcpy_async(dst + e, row + gc[e], 4);
      }
    }
  }
}

// Copy a chunk of band rows into a stage: input row g is row g / 2 of ll
// and hl (g even) or lh and hh (g odd), pairs j0 - 2 .. + kPairs; a stage
// row holds the kPairs low-band words, then the kPairs high-band words.
template <bool kVec>
__device__ __forceinline__ void load_inv(float* t, const void* ll,
                                         const void* hl, const void* lh,
                                         const void* hh, long long plane,
                                         int h, int w, int j0, Chunk ch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ne_h = (h + 1) >> 1, no_h = h >> 1;
  const int ne_w = (w + 1) >> 1, no_w = w >> 1;
  const int j = j0 - kHalo / 2 + 2 * lane;  // this lane's two pairs
  const bool whole_lo = kVec && j >= 0 && j + 1 < ne_w;
  const bool whole_hi = kVec && j >= 0 && j + 1 < no_w;
  int lc[2], hc[2];  // otherwise one at a time: their band columns
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int col = 2 * (j + e);  // the pair's low column
    lc[e] = reflect(col, w) >> 1;
    hc[e] = reflect(col + 1, w) >> 1;
  }
  for (int k = ch.first + warp; k < kRows && ch.g0 + k <= ch.last;
       k += kWarps) {
    const int gr = reflect(ch.g0 + k, h);
    const bool odd = gr & 1;
    const long long row = plane * (odd ? no_h : ne_h) + (gr >> 1);
    const int32_t* lo = static_cast<const int32_t*>(odd ? lh : ll) +
                        row * ne_w;
    const int32_t* hi = static_cast<const int32_t*>(odd ? hh : hl) +
                        row * no_w;
    float* dst = t + k * kCols + 2 * lane;
    if (whole_lo) {
      __pipeline_memcpy_async(dst, lo + j, 8);
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        __pipeline_memcpy_async(dst + e, lo + lc[e], 4);
      }
    }
    if (no_w == 0) continue;  // w == 1: no high band
    if (whole_hi) {
      __pipeline_memcpy_async(dst + kPairs, hi + j, 8);
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        __pipeline_memcpy_async(dst + kPairs + e, hi + hc[e], 4);
      }
    }
  }
}

// This CTA's plane, strip (first pair j0) and segment (pair rows [s0, s1)).
struct Work {
  long long plane;
  int j0, s0, s1;
};

__device__ __forceinline__ Work work_of(Plan p, int ne_h) {
  int b = blockIdx.x;
  const int strip = b % p.sx;
  b /= p.sx;
  const int seg = b % p.sy;
  const int s0 = seg * p.seg;
  return {b / p.sy, strip * kTX, s0, s0 + p.seg < ne_h ? s0 + p.seg : ne_h};
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fwd97_level_kernel(const float* __restrict__ x, void* __restrict__ ll,
                   void* __restrict__ hl, void* __restrict__ lh,
                   void* __restrict__ hh, int h, int w, Plan p, Consts k) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ne_h = (h + 1) >> 1, no_h = h >> 1;
  const int ne_w = (w + 1) >> 1, no_w = w >> 1;
  const Work wk = work_of(p, ne_h);
  x += wk.plane * h * w;
  const int chunks = (wk.s1 - wk.s0 + kTY - 1) / kTY;
  // the column pipeline's state before iteration m (which reads input rows
  // 2m and 2m + 1): x[2m-2], x[2m-1], od1[2m-3], ev2[2m-4], od3[2m-5]
  float xe = 0.0f, xo = 0.0f, o1 = 0.0f, e2 = 0.0f, o3 = 0.0f;

  load_fwd<kVec>(smem, x, h, w, wk.j0, chunk_rows(wk.s0, wk.s1, 0));
  __pipeline_commit();
  for (int c = 0; c < chunks; ++c) {
    float* t = smem + (c & 1) * kStageFloats;
    const Chunk ch = chunk_rows(wk.s0, wk.s1, c);
    __pipeline_wait_prior(0);
    __syncthreads();  // chunk c landed; chunk c - 1's stage is free
    if (c + 1 < chunks) {
      load_fwd<kVec>(smem + ((c + 1) & 1) * kStageFloats, x, h, w, wk.j0,
                     chunk_rows(wk.s0, wk.s1, c + 1));
      __pipeline_commit();
    }

    // 1. vertical, down this thread's column: iteration m finishes pair row
    //    m - 2 (ev4[2m-4] low, od3[2m-3] high) and writes it, scaled, over
    //    the two rows it read
#pragma unroll 4
    for (int r = ch.first; r < kRows; r += 2) {
      float* a = t + r * kCols + tid;
      const float en = a[0], on = a[kCols];
      if (h > 1) {
        const float od1 = lift(xo, k.alpha, xe, en);   // od1[2m-1]
        const float ev2 = lift(xe, k.beta, o1, od1);   // ev2[2m-2]
        const float od3 = lift(o1, k.gamma, e2, ev2);  // od3[2m-3]
        const float ev4 = lift(e2, k.delta, o3, od3);  // ev4[2m-4]
        a[0] = __fmul_rn(ev4, k.inv_k);
        a[kCols] = __fmul_rn(od3, k.k);
        xe = en;
        xo = on;
        o1 = od1;
        e2 = ev2;
        o3 = od3;
      } else {  // every row reflects to row 0
        a[0] = __fmul_rn(en, k.inv_k);
      }
    }
    __syncthreads();

    // 2. horizontal, a warp a row: stage row r >= kLead holds pair row
    //    s0 + kTY c + (r - kLead) / 2 of the low (r even) or high rows
#pragma unroll 2  // two rows' lifting chains interleaved
    for (int r = kLead + warp; r < kRows; r += kWarps) {
      const int pr = ch.g0 / 2 + r / 2 - kHalo / 2;
      const bool odd = r & 1;
      if (pr >= wk.s1 || pr >= (odd ? no_h : ne_h)) continue;
      const float4 v = *reinterpret_cast<const float4*>(t + r * kCols +
                                                        4 * lane);
      // pairs 2 lane and 2 lane + 1 of the window: (e0, o0), (e1, o1)
      float e0 = v.x, o0 = v.y, e1 = v.z, o1h = v.w;
      if (w > 1) {
        const unsigned all = 0xFFFFFFFFu;
        float n = __shfl_down_sync(all, e0, 1);  // the next lane's e0
        o0 = lift(o0, k.alpha, e0, e1);
        o1h = lift(o1h, k.alpha, e1, n);
        n = __shfl_up_sync(all, o1h, 1);  // the previous lane's o1
        e0 = lift(e0, k.beta, n, o0);
        e1 = lift(e1, k.beta, o0, o1h);
        n = __shfl_down_sync(all, e0, 1);
        o0 = lift(o0, k.gamma, e0, e1);
        o1h = lift(o1h, k.gamma, e1, n);
        n = __shfl_up_sync(all, o1h, 1);
        e0 = lift(e0, k.delta, n, o0);
        e1 = lift(e1, k.delta, o0, o1h);
      }
      if (lane == 0 || lane == 31) continue;  // the halo pairs
      const int j = wk.j0 - kHalo / 2 + 2 * lane;
      const int end = wk.j0 + kTX;
      const long long row = wk.plane * (odd ? no_h : ne_h) + pr;
      store_pair<kVec>(odd ? lh : ll, row * ne_w, j, end < ne_w ? end : ne_w,
                       __fmul_rn(e0, k.inv_k), __fmul_rn(e1, k.inv_k),
                       odd ? k.step[2] : k.step[0]);
      store_pair<kVec>(odd ? hh : hl, row * no_w, j, end < no_w ? end : no_w,
                       __fmul_rn(o0, k.k), __fmul_rn(o1h, k.k),
                       odd ? k.step[3] : k.step[1]);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
inv97_level_kernel(const void* __restrict__ ll, const void* __restrict__ hl,
                   const void* __restrict__ lh, const void* __restrict__ hh,
                   float* __restrict__ out, int h, int w, Plan p, Consts k) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ne_h = (h + 1) >> 1;
  const Work wk = work_of(p, ne_h);
  const int chunks = (wk.s1 - wk.s0 + kTY - 1) / kTY;
  // this thread's output column, stored when it lies in the strip's own
  // columns and in the plane
  const int gc = 2 * wk.j0 - kHalo + tid;
  const bool own = tid >= kHalo && tid < kHalo + 2 * kTX && gc < w;
  float* col = out + wk.plane * h * w + gc;
  const int r_lo = 2 * wk.s0, r_hi = 2 * wk.s1 < h ? 2 * wk.s1 : h;
  // the column pipeline's state before iteration m (which reads rows 2m and
  // 2m + 1): x[2m-1], E1[2m-2], O2[2m-3], E3[2m-4]
  float x_o = 0.0f, e1 = 0.0f, o2 = 0.0f, e3 = 0.0f;

  load_inv<kVec>(smem, ll, hl, lh, hh, wk.plane, h, w, wk.j0,
                 chunk_rows(wk.s0, wk.s1, 0));
  __pipeline_commit();
  for (int c = 0; c < chunks; ++c) {
    float* t = smem + (c & 1) * kStageFloats;
    const Chunk ch = chunk_rows(wk.s0, wk.s1, c);
    __pipeline_wait_prior(0);
    __syncthreads();  // chunk c landed; chunk c - 1's stage is free
    if (c + 1 < chunks) {
      load_inv<kVec>(smem + ((c + 1) & 1) * kStageFloats, ll, hl, lh, hh,
                     wk.plane, h, w, wk.j0, chunk_rows(wk.s0, wk.s1, c + 1));
      __pipeline_commit();
    }

    // 1. horizontal, a warp a row, every loaded row: dequantize and scale
    //    (low by K, high by 1/K), the four steps in reverse, the vertical
    //    scaling (even rows by K, odd by 1/K), and the row written back
    //    interleaved over its band words
#pragma unroll 2
    for (int r = ch.first + warp; r < kRows && ch.g0 + r <= ch.last;
         r += kWarps) {
      const int gr = reflect(ch.g0 + r, h);
      // (constant indices: a run-time index into a kernel parameter's
      // array copies the parameter to the stack)
      const float s_lo = gr & 1 ? k.step[2] : k.step[0];
      const float s_hi = gr & 1 ? k.step[3] : k.step[1];
      float* row = t + r * kCols;
      const int2 lo = *reinterpret_cast<const int2*>(row + 2 * lane);
      const int2 hi = *reinterpret_cast<const int2*>(row + kPairs + 2 * lane);
      float e0 = __fmul_rn(dequantize(lo.x, s_lo), k.k);
      float e1h = __fmul_rn(dequantize(lo.y, s_lo), k.k);
      float o0 = __fmul_rn(dequantize(hi.x, s_hi), k.inv_k);
      float o1 = __fmul_rn(dequantize(hi.y, s_hi), k.inv_k);
      if (w > 1) {
        const unsigned all = 0xFFFFFFFFu;
        float n = __shfl_up_sync(all, o1, 1);  // the previous lane's o1
        e0 = unlift(e0, k.delta, n, o0);
        e1h = unlift(e1h, k.delta, o0, o1);
        n = __shfl_down_sync(all, e0, 1);  // the next lane's e0
        o0 = unlift(o0, k.gamma, e0, e1h);
        o1 = unlift(o1, k.gamma, e1h, n);
        n = __shfl_up_sync(all, o1, 1);
        e0 = unlift(e0, k.beta, n, o0);
        e1h = unlift(e1h, k.beta, o0, o1);
        n = __shfl_down_sync(all, e0, 1);
        o0 = unlift(o0, k.alpha, e0, e1h);
        o1 = unlift(o1, k.alpha, e1h, n);
      }
      const float f = r & 1 ? k.inv_k : k.k;
      __syncwarp();  // every lane has read its band words
      *reinterpret_cast<float4*>(row + 4 * lane) =
          make_float4(__fmul_rn(e0, f), __fmul_rn(o0, f), __fmul_rn(e1h, f),
                      __fmul_rn(o1, f));
    }
    __syncthreads();

    // 2. vertical, down this thread's column: iteration m (rows 2m, 2m + 1)
    //    finishes output rows 2m - 2 (E3) and 2m - 3 (O4) and stores them
#pragma unroll 4
    for (int r = ch.first; r < kRows; r += 2) {
      const float en = t[r * kCols + tid], on = t[(r + 1) * kCols + tid];
      const int m2 = ch.g0 + r;  // 2m
      float ev, od = 0.0f;
      if (h > 1) {
        const float e1n = unlift(en, k.delta, x_o, on);  // E1[2m]
        const float o2n = unlift(x_o, k.gamma, e1, e1n);  // O2[2m-1]
        ev = unlift(e1, k.beta, o2, o2n);                 // E3[2m-2]
        od = unlift(o2, k.alpha, e3, ev);                 // O4[2m-3]
        x_o = on;
        e1 = e1n;
        o2 = o2n;
        e3 = ev;
      } else {  // every row reflects to row 0
        ev = en;
      }
      if (own) {
        if (m2 - 3 >= r_lo && m2 - 3 < r_hi) {
          col[static_cast<long long>(m2 - 3) * w] = od;
        }
        if (m2 - 2 >= r_lo && m2 - 2 < r_hi) {
          col[static_cast<long long>(m2 - 2) * w] = ev;
        }
      }
    }
  }
}

// How to cut one level of `planes` (h, w) planes for `capacity` resident
// CTAs: every strip cut into as few segments of whole chunks as give about
// `capacity` CTAs; or an error when the shape does not fit one launch.
cudaError_t plan_for(int h, int w, int planes, int capacity, Plan* p,
                     unsigned* ctas) {
  if (h <= 0 || w <= 0 || planes <= 0 || capacity <= 0)
    return cudaErrorInvalidValue;
  const long long ne_h = (h + 1) / 2, ne_w = (w + 1) / 2;
  const long long strips = planes * ((ne_w + kTX - 1) / kTX);
  const long long chunks = (ne_h + kTY - 1) / kTY;  // a strip's
  long long per_seg = (strips * chunks + capacity - 1) / capacity;
  if (per_seg > chunks) per_seg = chunks;
  p->sx = static_cast<int>((ne_w + kTX - 1) / kTX);
  p->seg = static_cast<int>(per_seg * kTY);
  p->sy = static_cast<int>((ne_h + p->seg - 1) / p->seg);
  const long long n = strips * p->sy;
  if (n > 0x7FFFFFFF) return cudaErrorInvalidValue;
  *ctas = static_cast<unsigned>(n);
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

bool aligned(const void* ptr, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// Plan a launch of `kernel` for the current device: as many CTAs as fit
// it at once, the shared-memory carve-out at its largest.
cudaError_t plan_launch(const void* kernel, int h, int w, int planes,
                        Plan* p, unsigned* ctas) {
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, kSmemBytes);
  if (err != cudaSuccess) return err;
  return plan_for(h, w, planes, sms * per_sm, p, ctas);
}

}  // namespace

// consts: ten float32 on the host: ALPHA, BETA, GAMMA, DELTA, K, 1/K, then
// the quantizer step of ll, hl, lh and hh (0: a float32 band).
extern "C" int grk_fwd97_level(const void* x, void* ll, void* hl, void* lh,
                               void* hh, int h, int w, int planes,
                               const float* consts, void* stream) {
  const bool vec = w % 4 == 0 && aligned(x, 16) && aligned(ll, 8) &&
                   aligned(hl, 8) && aligned(lh, 8) && aligned(hh, 8);
  const auto kernel =
      vec ? fwd97_level_kernel<true> : fwd97_level_kernel<false>;
  Plan p;
  unsigned ctas;
  const cudaError_t err = plan_launch(reinterpret_cast<const void*>(kernel),
                                      h, w, planes, &p, &ctas);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), ll, hl, lh, hh, h, w, p,
      consts_from(consts));
  return cudaGetLastError();
}

// consts: as for grk_fwd97_level, with half the quantizer step of each
// band (0: a float32 band; else the band is doubled-domain int32).
extern "C" int grk_inv97_level(const void* ll, const void* hl, const void* lh,
                               const void* hh, void* out, int h, int w,
                               int planes, const float* consts,
                               void* stream) {
  const bool vec = w % 4 == 0 && aligned(ll, 8) && aligned(hl, 8) &&
                   aligned(lh, 8) && aligned(hh, 8);
  const auto kernel =
      vec ? inv97_level_kernel<true> : inv97_level_kernel<false>;
  Plan p;
  unsigned ctas;
  const cudaError_t err = plan_launch(reinterpret_cast<const void*>(kernel),
                                      h, w, planes, &p, &ctas);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      ll, hl, lh, hh, static_cast<float*>(out), h, w, p, consts_from(consts));
  return cudaGetLastError();
}
