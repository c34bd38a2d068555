// EBCOT Tier-1 MQ decoder (ISO/IEC 15444-1 Annex C and D, styles NONE and
// LAZY): every codeblock of a batch, mixed shapes, in one launch, each block
// written at its place in its destination tensor.
//
// Replaces grok_tpu/ops/mq_decode.py decode_cblks_mq_device / decode_batch:
// one scan step a (plane, pass, stripe, column) with the whole coding state
// in the carry, vmapped across blocks, which runs as XLA code, not Pallas,
// on the TPU.  Here one warp a codeblock runs, on its lane 0, the standard
// bit-plane decoder (t1/coder.py decode_cblk): SPP, MRP and CUP with
// run-length aggregation, the MQ decoder and the raw reader of the bypass
// passes.  The
// host hands over what depends only on the packet headers, as the
// reference's host does: each block's bytes, its segments' byte ranges and
// the segment and bypass flag of every pass (ops/mq_decode.py layout).
//
// Corrupt and truncated streams decode exactly as the reference's device
// decoder decodes them: a segment reads 0xFF past its end; a segment the
// headers do not give is empty; a segment that reaches past its block's
// bytes reads zeros up to the reference's padded batch length Lb and 0xFF
// beyond; the readers switch segments at pass starts as the pass map says,
// the MQ contexts kept; the visited flags clear after each cleanup pass.
// The registers are unsigned 32-bit and the reconstruction stays below
// 2^27, so no signed arithmetic overflows.
//
// What bounds it: the serial chain of decisions of the longest codeblock,
// not bytes (well under 1 B a coefficient in, 4 B a coefficient out): each
// decision's context needs the significance the decisions before it set.
// As in mq_encode.cu, a codeblock has a warp of its own and runs on lane 0,
// so no chain waits out another's branches and a tile's blocks spread over
// the SMs.  The tables sit in shared memory, the context states in
// registers, the per-sample flags ((h + 2) x (w + 2) bytes) in a per-block
// scratch slab in device memory that L1 and L2 hold, and the
// reconstruction in the destination itself, signed once at the end.

#include <cstdint>

#include <cuda_runtime.h>

#include "mq_common.cuh"

namespace {

using namespace grk_mq;

constexpr int kDesc = 14;  // out_ptr, out_stride, h, w, orient, numbps,
                           // passes, data_off, data_len, lb, seg_off, nseg,
                           // pass_off, scratch_off
constexpr int kRawFlag = 0x80;
constexpr int kWarps = 4;  // codeblocks (warps) a CTA, one on each lane 0

// A block's bytes as the reference reads them.
struct Bytes {
  const uint8_t* data;
  int64_t len, lb;
  // byte i (relative to the block) of a segment ending at e
  __device__ __forceinline__ uint32_t at(int64_t i, int64_t e) const {
    if (i < 0 || i >= e || i >= lb) return 0xFF;
    return i < len ? data[i] : 0;
  }
};

// The MQ decoder (t1/mq.py MQDecoder).
struct MQ {
  uint32_t a, c;
  int ct;
  int64_t bp, e;

  __device__ void bytein(const Bytes& by) {
    if (by.at(bp, e) == 0xFF) {
      if (by.at(bp + 1, e) > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += by.at(bp, e) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += by.at(bp, e) << 8;
      ct = 8;
    }
  }

  __device__ void init(const Bytes& by, int64_t s, int64_t end) {
    e = end;
    bp = s;
    c = by.at(s, e) << 16;
    bytein(by);
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }

  __device__ int decode(int cx, uint8_t* states, const Tables& t,
                        const Bytes& by) {
    const int si = states[cx];
    const uint32_t qe = t.qe[si];
    const int mps = si & 1;
    int d;
    a -= qe;
    if (((c >> 16) & 0xFFFF) < qe) {
      if (a < qe) {
        d = mps;
        states[cx] = t.nmps[si];
      } else {
        d = 1 - mps;
        states[cx] = t.nlps[si];
      }
      a = qe;
    } else {
      c -= qe << 16;
      if (a & 0x8000) return mps;
      if (a < qe) {
        d = 1 - mps;
        states[cx] = t.nlps[si];
      } else {
        d = mps;
        states[cx] = t.nmps[si];
      }
    }
    do {
      if (ct == 0) bytein(by);
      a <<= 1;
      c <<= 1;
      --ct;
    } while (!(a & 0x8000));
    return d;
  }
};

// The raw reader of the bypass passes (t1/mq.py RawDecoder).
struct Raw {
  uint32_t acc;
  int avail;
  bool prev_ff;
  int64_t bp, e;

  __device__ void init(int64_t s, int64_t end) {
    acc = 0;
    avail = 0;
    prev_ff = false;
    bp = s;
    e = end;
  }
  __device__ int decode(const Bytes& by) {
    if (avail == 0) {
      const uint32_t b = by.at(bp, e);
      ++bp;
      acc = b;
      avail = prev_ff ? 7 : 8;
      prev_ff = b == 0xFF;
    }
    --avail;
    return (acc >> avail) & 1;
  }
};

__global__ void __launch_bounds__(32 * kWarps)
    mq_decode_kernel(const int64_t* __restrict__ desc,
                     const uint8_t* __restrict__ tables,
                     const int32_t* __restrict__ segs,
                     const uint8_t* __restrict__ pmap,
                     const uint8_t* __restrict__ data,
                     uint8_t* __restrict__ scratch, int nblocks) {
  __shared__ Tables t;
  load_tables(&t, tables);
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if ((threadIdx.x & 31) != 0 || b >= nblocks) return;
  const int64_t* d = desc + kDesc * static_cast<int64_t>(b);
  int32_t* out = reinterpret_cast<int32_t*>(static_cast<uintptr_t>(d[0]));
  const int64_t ostride = d[1];
  const int h = static_cast<int>(d[2]);
  const int w = static_cast<int>(d[3]);
  const int orient = static_cast<int>(d[4]);
  const int numbps = static_cast<int>(d[5]);
  const int npass = static_cast<int>(d[6]);
  const Bytes by{data + d[7], d[8], d[9]};
  const int32_t* seg = segs + 2 * d[10];
  const int nseg = static_cast<int>(d[11]);
  const uint8_t* pm = pmap + d[12];
  const int p = w + 2;
  uint8_t* fl = scratch + d[13];
  for (int i = 0; i < (h + 2) * p; ++i) fl[i] = 0;
  for (int yy = 0; yy < h; ++yy)
    for (int xx = 0; xx < w; ++xx) out[yy * ostride + xx] = 0;
  if (numbps <= 0 || npass <= 0) return;

  uint8_t states[kNumCtx];
  for (int i = 0; i < kNumCtx; ++i) states[i] = t.init[i];
  MQ mq{0x8000, 0, 0, 0, 0};
  Raw raw;
  raw.init(0, 0);
  int cur = -1;
  const uint8_t* zc = t.zc + 256 * orient;
  int passno = 0;
#define REC(yy, xx) out[(yy) * ostride + (xx)]

  for (int bp = numbps - 1; bp >= 0 && passno < npass; --bp) {
    // reconstruction one plane up: the doubled domain
    const int bq = bp + 1;
    const uint32_t first_rec = (1u << bq) | (1u << bq >> 1);
    for (int pt = (bp == numbps - 1 ? 2 : 0); pt <= 2 && passno < npass;
         ++pt, ++passno) {
      const int code = pm[passno];
      const int si = code & 0x7F;
      const bool is_raw = (code & kRawFlag) != 0;
      if (si != cur) {
        const int64_t s = si < nseg ? seg[2 * si] : 0;
        const int64_t e = si < nseg ? seg[2 * si + 1] : 0;
        if (is_raw) raw.init(s, e);
        else mq.init(by, s, e);
        cur = si;
      }
      for (int sy = 0; sy < h; sy += 4) {
        const int rows = min(4, h - sy);
        for (int xx = 0; xx < w; ++xx) {
          int k0 = 0;
          if (pt == 2 && rows == 4) {
            bool agg = true;
            for (int k = 0; k < 4 && agg; ++k) {
              const int f = (sy + k + 1) * p + xx + 1;
              if ((fl[f] & (kSig | kVis)) || zc_pattern(fl, f, p)) agg = false;
            }
            if (agg) {
              if (!mq.decode(kCtxRl, states, t, by)) continue;
              int first = mq.decode(kCtxUni, states, t, by) << 1;
              first |= mq.decode(kCtxUni, states, t, by);
              const int f = (sy + first + 1) * p + xx + 1;
              const int sci = sc_index(fl, f, p);
              const int sg = mq.decode(t.sc_cn[sci], states, t, by) ^
                             t.sc_xor[sci];
              fl[f] |= kSig | (sg ? kNeg : 0);
              REC(sy + first, xx) = static_cast<int32_t>(first_rec);
              k0 = first + 1;
            }
          }
          for (int k = k0; k < rows; ++k) {
            const int f = (sy + k + 1) * p + xx + 1;
            const uint8_t g = fl[f];
            if (pt == 1) {  // magnitude refinement
              if (!(g & kSig) || (g & kVis)) continue;
              int bit;
              if (is_raw) {
                bit = raw.decode(by);
              } else {
                const int cx = (g & kRef) ? kCtxMag + 2
                               : kCtxMag + (zc_pattern(fl, f, p) ? 1 : 0);
                bit = mq.decode(cx, states, t, by);
              }
              fl[f] = g | kRef;
              uint32_t v = static_cast<uint32_t>(REC(sy + k, xx));
              if (bq > 0) {
                const uint32_t half = 1u << (bq - 1);
                v = bit ? v + half : v - half;
              } else if (!bit) {
                v -= 1;
              }
              REC(sy + k, xx) = static_cast<int32_t>(v);
              continue;
            }
            if (g & kSig) continue;
            if (pt == 2 && (g & kVis)) continue;
            const int zp = zc_pattern(fl, f, p);
            if (pt == 0 && !zp) continue;
            const int bit = is_raw ? raw.decode(by)
                                   : mq.decode(zc[zp], states, t, by);
            if (bit) {
              int sg;
              if (is_raw) {
                sg = raw.decode(by);
              } else {
                const int sci = sc_index(fl, f, p);
                sg = mq.decode(t.sc_cn[sci], states, t, by) ^ t.sc_xor[sci];
              }
              fl[f] |= kSig | (sg ? kNeg : 0);
              REC(sy + k, xx) = static_cast<int32_t>(first_rec);
            }
            if (pt == 0) fl[f] |= kVis;
          }
        }
      }
      if (pt == 2)
        for (int i = 0; i < (h + 2) * p; ++i) fl[i] &= ~kVis;
    }
  }
  for (int yy = 0; yy < h; ++yy)
    for (int xx = 0; xx < w; ++xx)
      if (fl[(yy + 1) * p + xx + 1] & kNeg)
        REC(yy, xx) = static_cast<int32_t>(
            0u - static_cast<uint32_t>(REC(yy, xx)));
#undef REC
}

}  // namespace

// desc: (nblocks, 14) int64 (see kDesc); tables: ops/mq_encode.py
// device_tables; segs: (S, 2) int32 [start, end) of each block's segments
// within its bytes, block b's from desc[b][10]; pmap: a byte a pass
// (segment | 0x80 for a bypass pass), block b's from desc[b][12]; data: the
// joined bytes; scratch: each block's (h + 2) x (w + 2) flag bytes from
// desc[b][13].
extern "C" int grk_mq_decode(const void* desc, const void* tables,
                             const void* segs, const void* pmap,
                             const void* data, void* scratch, int nblocks,
                             void* stream) {
  if (nblocks <= 0) return cudaErrorInvalidValue;
  mq_decode_kernel<<<(nblocks + kWarps - 1) / kWarps, 32 * kWarps, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(desc), static_cast<const uint8_t*>(tables),
      static_cast<const int32_t*>(segs), static_cast<const uint8_t*>(pmap),
      static_cast<const uint8_t*>(data), static_cast<uint8_t*>(scratch),
      nblocks);
  return cudaGetLastError();
}
