// EBCOT Tier-1 MQ decoder (ISO/IEC 15444-1 Annex C and D, styles NONE and
// LAZY): every codeblock of a batch, mixed shapes, in one launch, each block
// written at its place in its destination tensor.
//
// Replaces grok_tpu/ops/mq_decode.py decode_cblks_mq_device / decode_batch:
// one scan step a (plane, pass, stripe, column) with the whole coding state
// in the carry, vmapped across blocks, which runs as XLA code, not Pallas,
// on the TPU.  Here a codeblock runs the standard bit-plane decoder
// (t1/coder.py decode_cblk, native/t1.cc): SPP, MRP and CUP with run-length
// aggregation, the MQ decoder and the raw reader of the bypass passes.  The
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
// The design is mq_encode.cu's: a codeblock a warp (a CTA); its flag words
// (native/t1.cc's layout: a context is one load of the word and one table
// lookup), its 19 context states (fused table entries) and a plane map in
// shared memory, 13.4 KB for 64 x 64; renormalisation by
// count-leading-zeros, split where a byte comes in; stripe columns with
// nothing to decode passed with one test, SPP and MRP skipped while no
// sample is significant; loops not unrolled, so many resident chains share
// the instruction cache; the whole warp runs the decoder in step and only
// lane 0's stores land (mq_common.cuh Lead), so its branches stay
// warp-uniform.  The decoder takes a plane
// at a time and never touches a sample: it records in the plane map what
// each sample saw (turned significant, refined with a 0 or a 1), and after
// the plane the whole warp applies that to the reconstruction's magnitude
// in the destination, one lane a stripe column, and clears the visited
// flags.  The warp also zeroes the state and the destination first and
// writes the signs last.

#include <cstdint>

#include <cuda_runtime.h>

#include "mq_common.cuh"

namespace {

using namespace grk_mq;

constexpr int kDesc = 13;  // out_ptr, out_stride, h, w, orient, numbps,
                           // passes, data_off, data_len, lb, seg_off, nseg,
                           // pass_off
constexpr int kRawFlag = 0x80;

// A block's bytes as the reference reads them.
struct Bytes {
  const uint8_t* data;
  int len, lb;  // a block's bytes and Lb stay below 2^31
  // byte i (relative to the block) of a segment ending at e
  __device__ __forceinline__ uint32_t at(int i, int e) const {
    if (i < 0 || i >= e || i >= lb) return 0xFF;
    return i < len ? data[i] : 0;
  }
};

// The MQ decoder (t1/mq.py MQDecoder).
struct MQ {
  uint32_t a, c;
  int ct;
  int bp, e;

  __device__ __forceinline__ void bytein(const Bytes& by) {
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

  __device__ __forceinline__ void init(const Bytes& by, int s, int end) {
    e = end;
    bp = s;
    c = by.at(s, e) << 16;
    bytein(by);
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }

  // Decode a decision in context cx; st: the context states, qt: the fused
  // table.  The renormalisation shifts a and c by the leading zeros of a
  // at once, split where ct is 0: there the bit loop puts a BYTEIN.
  __device__ __forceinline__ uint32_t decode(int cx, uint32_t* st,
                                             const uint32_t* qt,
                                             const Bytes& by,
                                             const Lead& ld) {
    const uint32_t e = st[cx];
    const uint32_t qe = e & 0x7FFF;
    const uint32_t mps = (e >> 15) & 1;
    uint32_t d;
    a -= qe;
    if ((c >> 16) < qe) {
      d = a < qe ? mps : mps ^ 1;
      a = qe;
    } else {
      c -= qe << 16;
      if (a & 0x8000) return mps;
      d = a < qe ? mps ^ 1 : mps;
    }
    // the successor state: after an LPS the switch is folded into it
    const uint32_t next = qt[d == mps ? (e >> 16) & 0xFF : e >> 24];
    *ld.at(st + cx) = next;
    int n = __clz(a) - 16;
    while (n > ct) {
      a <<= ct;
      c <<= ct;
      n -= ct;
      bytein(by);
    }
    a <<= n;
    c <<= n;
    ct -= n;
    return d;
  }
};

// The raw reader of the bypass passes (t1/mq.py RawDecoder).
struct Raw {
  uint32_t acc;
  int avail;
  bool prev_ff;
  int bp, e;

  __device__ __forceinline__ void init(int s, int end) {
    acc = 0;
    avail = 0;
    prev_ff = false;
    bp = s;
    e = end;
  }
  __device__ __forceinline__ uint32_t decode(const Bytes& by) {
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

// The warp's decoder (lane 0 leads, mq_common.cuh Lead): the block's
// flag words and plane map in shared memory, the context states, the
// readers.  A pass records what its
// samples saw in the plane map, 2 bits a row: 1 turned significant, 2
// refined with a 0, 3 refined with a 1; the warp applies them to the
// reconstruction after the plane.
struct Decoder {
  Layout L;
  const Tables* t;
  uint32_t* st;
  const uint8_t* zc;
  Bytes by;
  MQ mq;
  Raw raw;
  int nsig;
  Lead ld;

  __device__ __forceinline__ uint32_t mq_bit(int cx) {
    return mq.decode(cx, st, t->qe, by, ld);
  }
  template <bool RAW>
  __device__ __forceinline__ uint32_t bit(int cx) {
    return RAW ? raw.decode(by) : mq_bit(cx);
  }
  __device__ __forceinline__ void store(uint16_t* fc, uint64_t col) {
    *ld.at(reinterpret_cast<uint64_t*>(fc)) = col;
  }
  __device__ __forceinline__ void add_events(uint16_t* mp, uint32_t ev) {
    ld.or_into(mp, ev);
  }

  // The sample of word f at row k turned significant: decode its sign.
  template <bool RAW>
  __device__ __forceinline__ void sig(uint16_t* fc, uint64_t& col,
                                      uint64_t& nxt, int k, uint32_t f) {
    uint32_t neg;
    if (RAW) {
      neg = raw.decode(by);
    } else {
      const uint32_t sc = t->sc[sc_index(f)];
      neg = mq_bit(sc & 0x7F) ^ (sc >> 7);
    }
    if (neg) col |= static_cast<uint64_t>(kNeg) << (16 * k);
    set_sig(fc, L.ss, col, nxt, k, neg, ld);
    ++nsig;
  }

  // Significance propagation pass.
  template <bool RAW>
  __device__ __forceinline__ void spp() {
    const uint64_t all_sig = rep4(kSig);
    for (int s = 0; s < L.ns; ++s) {
      const int rows = min(4, L.h - 4 * s);
      uint16_t* fc = L.fl + (s + 1) * L.ss + 4;
      uint16_t* mp = L.map + s * L.w;
      // the next column's flags are loaded while this one is coded (the
      // last column's next is the border)
      uint64_t nxt = *reinterpret_cast<const uint64_t*>(fc);
      for (int x = 0; x < L.w; ++x, fc += 4, ++mp) {
        uint64_t col = nxt;
        nxt = *reinterpret_cast<const uint64_t*>(fc + 4);
        if (!(col & rep4(kNbr)) || (col & all_sig) == all_sig) continue;
        const uint64_t was = col;
        uint32_t ev = 0;
#pragma unroll 1
        for (int k = 0; k < rows; ++k) {
          const uint32_t f = static_cast<uint32_t>(col >> (16 * k)) & 0xFFFF;
          if ((f & kSig) || !(f & kNbr)) continue;
          if (bit<RAW>(zc[f & 0xFF])) {
            sig<RAW>(fc, col, nxt, k, f);
            ev |= 1u << (2 * k);
          }
          col |= static_cast<uint64_t>(kVis) << (16 * k);
        }
        if (col != was) store(fc, col);
        if (ev) add_events(mp, ev);
      }
    }
  }

  // Magnitude refinement pass.
  template <bool RAW>
  __device__ __forceinline__ void mrp() {
    for (int s = 0; s < L.ns; ++s) {
      const int rows = min(4, L.h - 4 * s);
      uint16_t* fc = L.fl + (s + 1) * L.ss + 4;
      uint16_t* mp = L.map + s * L.w;
      // the next column's flags are loaded while this one is coded (the
      // last column's next is the border)
      uint64_t nxt = *reinterpret_cast<const uint64_t*>(fc);
      for (int x = 0; x < L.w; ++x, fc += 4, ++mp) {
        uint64_t col = nxt;
        nxt = *reinterpret_cast<const uint64_t*>(fc + 4);
        if (!(col & rep4(kSig))) continue;
        const uint64_t was = col;
        uint32_t ev = 0;
#pragma unroll 1
        for (int k = 0; k < rows; ++k) {
          const uint32_t f = static_cast<uint32_t>(col >> (16 * k)) & 0xFFFF;
          if (!(f & kSig) || (f & kVis)) continue;
          const int cx = (f & kRef) ? kCtxMag + 2
                                    : kCtxMag + ((f & kNbr) ? 1 : 0);
          ev |= (2u | bit<RAW>(cx)) << (2 * k);
          col |= static_cast<uint64_t>(kRef) << (16 * k);
        }
        if (col != was) store(fc, col);
        if (ev) add_events(mp, ev);
      }
    }
  }

  // Cleanup pass.
  __device__ __forceinline__ void cup() {
    const uint64_t all_sig = rep4(kSig);
    for (int s = 0; s < L.ns; ++s) {
      const int rows = min(4, L.h - 4 * s);
      uint16_t* fc = L.fl + (s + 1) * L.ss + 4;
      uint16_t* mp = L.map + s * L.w;
      // the next column's flags are loaded while this one is coded (the
      // last column's next is the border)
      uint64_t nxt = *reinterpret_cast<const uint64_t*>(fc);
      for (int x = 0; x < L.w; ++x, fc += 4, ++mp) {
        uint64_t col = nxt;
        nxt = *reinterpret_cast<const uint64_t*>(fc + 4);
        const uint64_t sv = col & rep4(kSig | kVis);
        // every sample decoded in an earlier pass
        if (rows == 4 && ((sv | (sv >> 1)) & all_sig) == all_sig) continue;
        int k = 0;
        int forced = -1;  // the run's first sample: significant
        if (rows == 4 && !(col & rep4(kSig | kVis | kNbr))) {
          // run-length aggregation of a clean column
          if (!mq_bit(kCtxRl)) continue;
#pragma unroll 1
          for (int j = 0; j < 2; ++j)
            k = k << 1 | static_cast<int>(mq_bit(kCtxUni));
          forced = k;
        }
        const uint64_t was = col;
        uint32_t ev = 0;
#pragma unroll 1
        for (; k < rows; ++k) {
          const uint32_t f = static_cast<uint32_t>(col >> (16 * k)) & 0xFFFF;
          if (k != forced) {
            if (f & (kSig | kVis)) continue;
            if (!mq_bit(zc[f & 0xFF])) continue;
          }
          sig<false>(fc, col, nxt, k, f);
          ev |= 1u << (2 * k);
        }
        if (col != was) store(fc, col);
        if (ev) add_events(mp, ev);
      }
    }
  }
};

__global__ void __launch_bounds__(32)
    mq_decode_kernel(const int64_t* __restrict__ desc,
                     const uint8_t* __restrict__ tables,
                     const int32_t* __restrict__ segs,
                     const uint8_t* __restrict__ pmap,
                     const uint8_t* __restrict__ data) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  load_tables(smem, tables);
  const int64_t* d = desc + kDesc * static_cast<int64_t>(b);
  int32_t* out = reinterpret_cast<int32_t*>(static_cast<uintptr_t>(d[0]));
  const int64_t ostride = d[1];
  const int h = static_cast<int>(d[2]);
  const int w = static_cast<int>(d[3]);
  const int orient = static_cast<int>(d[4]);
  const int numbps = static_cast<int>(d[5]);
  const int npass = static_cast<int>(d[6]);
  const Layout L(smem, h, w);

  // the whole warp: zero the flags and the destination, which holds the
  // reconstruction's magnitude until the signs go in at the end
  uint64_t* fl64 = reinterpret_cast<uint64_t*>(L.fl);
  for (int i = lane; i < L.words() / 4; i += 32) fl64[i] = 0;
  for (int i = lane; i < h * w; i += 32) {
    const int yy = i / w;
    out[yy * ostride + (i - yy * w)] = 0;
  }

  // the warp runs the decoder in step, a plane at a time, lane 0 storing;
  // between planes it applies the plane's events to the reconstruction and
  // clears the visited flags
  Decoder dc;
  dc.L = L;
  dc.t = reinterpret_cast<const Tables*>(smem);
  dc.st = reinterpret_cast<uint32_t*>(smem + kTablesBytes);
  dc.zc = dc.t->zc + 256 * orient;
  // Lb is a power of two up to 2^31; no segment reaches 2^31 - 1
  dc.by = Bytes{data + d[7], static_cast<int>(d[8]),
                d[9] < 0x7FFFFFFF ? static_cast<int>(d[9]) : 0x7FFFFFFF};
  dc.mq = MQ{0x8000, 0, 0, 0, 0};
  dc.raw.init(0, 0);
  dc.nsig = 0;
  dc.ld = make_lead(smem, lane);
  const int32_t* seg = segs + 2 * d[10];
  const int nseg = static_cast<int>(d[11]);
  const uint8_t* pm = pmap + d[12];
  const int area = h * w;
  int cur = -1;
  int passno = 0;
  for (int bp = numbps - 1; bp >= 0 && passno < npass; --bp) {
    __syncwarp();
    for (int c = lane; c < L.ns * w; c += 32) L.map[c] = 0;
    __syncwarp();
    const int pt0 = bp == numbps - 1 ? 2 : 0;
    const int np = min(3 - pt0, npass - passno);
    for (int pt = pt0; pt < pt0 + np; ++pt) {
      const int code = pm[passno + pt - pt0];
      const int si = code & 0x7F;
      const bool is_raw = (code & kRawFlag) != 0;
      if (si != cur) {
        const int s = si < nseg ? seg[2 * si] : 0;
        const int e = si < nseg ? seg[2 * si + 1] : 0;
        if (is_raw) dc.raw.init(s, e);
        else dc.mq.init(dc.by, s, e);
        cur = si;
      }
      if (pt == 0) {
        // no significant sample has no neighbourhood; all significant
        // leaves nothing to decode
        if (dc.nsig != 0 && dc.nsig != area) {
          if (is_raw) dc.spp<true>();
          else dc.spp<false>();
        }
      } else if (pt == 1) {
        if (dc.nsig != 0) {
          if (is_raw) dc.mrp<true>();
          else dc.mrp<false>();
        }
      } else {
        dc.cup();
      }
    }
    passno += np;
    __syncwarp();
    // significant: 3 << bp (the doubled domain's (1 << bp + 1) plus half
    // of it); refined: 1 << bp down or up
    for (int c = lane; c < L.ns * w; c += 32) {
      const uint32_t ev = L.map[c];
      if (!ev) continue;
      const int s = c / w;
      int32_t* oc = out + 4 * s * ostride + (c - s * w);
      for (int k = 0; k < 4; ++k) {
        const uint32_t e = (ev >> (2 * k)) & 3;
        if (!e) continue;
        const uint32_t v = static_cast<uint32_t>(oc[k * ostride]);
        oc[k * ostride] = static_cast<int32_t>(
            e == 1 ? 3u << bp : e == 2 ? v - (1u << bp) : v + (1u << bp));
      }
    }
    clear_visited(L, lane);
  }
  __syncwarp();
  // the whole warp: the signs
  for (int i = lane; i < h * w; i += 32) {
    const int yy = i / w;
    const int xx = i - yy * w;
    if (L.fl[L.idx(yy, xx)] & kNeg) {
      int32_t* o = out + yy * ostride + xx;
      *o = static_cast<int32_t>(0u - static_cast<uint32_t>(*o));
    }
  }
}

}  // namespace

// desc: (nblocks, 13) int64 (see kDesc); tables: ops/mq_encode.py
// device_tables; segs: (S, 2) int32 [start, end) of each block's segments
// within its bytes, block b's from desc[b][10]; pmap: a byte a pass
// (segment | 0x80 for a bypass pass), block b's from desc[b][12]; data: the
// joined bytes; smem_bytes: the dynamic shared memory of the launch's
// largest block (ops/mq_tables.py smem_bytes; at most 31,376 bytes, under
// the 48 KB a launch gets without opting in).
extern "C" int grk_mq_decode(const void* desc, const void* tables,
                             const void* segs, const void* pmap,
                             const void* data, int nblocks, int smem_bytes,
                             void* stream) {
  if (nblocks <= 0 || smem_bytes < kSmemFixed) return cudaErrorInvalidValue;
  mq_decode_kernel<<<nblocks, 32, smem_bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(desc), static_cast<const uint8_t*>(tables),
      static_cast<const int32_t*>(segs), static_cast<const uint8_t*>(pmap),
      static_cast<const uint8_t*>(data));
  return cudaGetLastError();
}
