// Shared pieces of the MQ Tier-1 kernels (mq_encode.cu, mq_decode.cu): the
// per-sample flag bits, the tables the wrapper passes in (built by
// grok_tpu_torch/ops/mq_tables.py, one uint8 buffer, see
// ops/mq_encode.py device_tables), and the neighbour context formation of
// ISO/IEC 15444-1 Annex D for styles NONE and LAZY.

#pragma once

#include <cstdint>

namespace grk_mq {

// flags of a sample in a block's scratch, (h + 2) x (w + 2) bytes with a
// border of insignificant samples
constexpr uint8_t kSig = 1;
constexpr uint8_t kNeg = 2;
constexpr uint8_t kVis = 4;
constexpr uint8_t kRef = 8;

constexpr int kNumCtx = 19;
constexpr int kCtxMag = 14;
constexpr int kCtxRl = 17;
constexpr int kCtxUni = 18;

// offsets in the table buffer
constexpr int kTabZc = 0;          // 4 x 256: ZC context by orient, pattern
constexpr int kTabScCn = 1024;     // 256: SC context
constexpr int kTabScXor = 1280;    // 256: SC XOR bit
constexpr int kTabNmps = 1536;     // 94: successor si after an MPS
constexpr int kTabNlps = 1630;     // 94: successor si after an LPS
constexpr int kTabInit = 1724;     // 19: initial si of each context
constexpr int kTabQe = 1743;       // 94 x uint16 little-endian: Qe by si
constexpr int kTabBytes = 1931;

struct Tables {
  uint8_t zc[1024];
  uint8_t sc_cn[256];
  uint8_t sc_xor[256];
  uint8_t nmps[94];
  uint8_t nlps[94];
  uint8_t init[kNumCtx];
  uint16_t qe[94];
};

// Copy the tables into shared memory, all threads of the CTA together.
__device__ inline void load_tables(Tables* t, const uint8_t* src) {
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    t->zc[i] = src[kTabZc + i];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    t->sc_cn[i] = src[kTabScCn + i];
    t->sc_xor[i] = src[kTabScXor + i];
  }
  for (int i = threadIdx.x; i < 94; i += blockDim.x) {
    t->nmps[i] = src[kTabNmps + i];
    t->nlps[i] = src[kTabNlps + i];
    t->qe[i] = static_cast<uint16_t>(src[kTabQe + 2 * i] |
                                     (src[kTabQe + 2 * i + 1] << 8));
  }
  for (int i = threadIdx.x; i < kNumCtx; i += blockDim.x)
    t->init[i] = src[kTabInit + i];
  __syncthreads();
}

// The 8-bit neighbour significance pattern of the sample at flag index f
// (bits NW N NE W E SW S SE from bit 0), row pitch p.
__device__ __forceinline__ int zc_pattern(const uint8_t* fl, int f, int p) {
  return (fl[f - p - 1] & kSig) | ((fl[f - p] & kSig) << 1) |
         ((fl[f - p + 1] & kSig) << 2) | ((fl[f - 1] & kSig) << 3) |
         ((fl[f + 1] & kSig) << 4) | ((fl[f + p - 1] & kSig) << 5) |
         ((fl[f + p] & kSig) << 6) | ((fl[f + p + 1] & kSig) << 7);
}

// The SC table index: bits W-sig W-neg E-sig E-neg N-sig N-neg S-sig S-neg.
__device__ __forceinline__ int sc_index(const uint8_t* fl, int f, int p) {
  // kSig is bit 0 and kNeg bit 1: a significant negative neighbour gives
  // 3, an insignificant one 0 whatever its sign
  const auto two = [](uint8_t v) { return (v & kSig) ? (v & 3) : 0; };
  return two(fl[f - 1]) | (two(fl[f + 1]) << 2) | (two(fl[f - p]) << 4) |
         (two(fl[f + p]) << 6);
}

}  // namespace grk_mq
