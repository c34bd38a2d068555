// EBCOT Tier-1 MQ encoder (ISO/IEC 15444-1 Annex C and D, styles NONE and
// LAZY): every codeblock of a batch, mixed shapes and styles, in one launch,
// each block's finished codeword packed into one pool.
//
// Replaces grok_tpu/ops/mq_encode.py encode_cblks_mq_device: build_streams
// (the significance-time wavefront, the context slots and their
// compaction), mq_scan (the MQ automaton with byte-out and carry) and
// _dists_fn, which run as XLA code, not Pallas, on the TPU, and the host
// half around them (_assemble_one and _raw_payload: segment splicing, the
// bypass writer's 0xFF stuffing, the rates of passes that are not
// terminated).  The wavefront fixpoint and the slot compaction are there
// because a TPU cannot run a serial coder per lane; here one warp a
// codeblock runs, on its lane 0, the standard bit-plane coder
// (t1/coder.py encode_cblk, native/t1.cc): SPP, MRP and CUP with
// run-length aggregation, the MQ writer with its last byte in a register,
// and the raw writer of the bypass passes.
//
// Output per block: its codeword in the packed pool (every MQ segment
// without its fake lead byte and a trailing 0xFF, every raw segment
// stuffed 7 bits after a 0xFF and without a trailing 0xFF), and (offset,
// length, numbps, status, sum of squared magnitudes, the count of MQ and
// raw decisions coded: the length of its chain), every pass's rate
// (the host coder's: a terminated pass its length, an MQ pass that is not
// terminated the bytes so far + 4, a raw one the writer's completed bytes +
// 1, clamped to the total and to be monotone), termination flag and, with
// need_dist, exact cumulative distortion as an int64 (the wrapper converts
// it to double once; with numbps <= 20 every partial sum is below 2^53, so
// it equals the host coder's float sums).
//
// What bounds it: the serial chain of decisions of the longest codeblock,
// not bytes (4 B a coefficient in, well under 1 B a coefficient out).  A
// block's decisions run one after another, each a few dependent table and
// flag reads and branches, so a launch takes about as long as the longest
// chain times the time of one decision.  The first design ran a codeblock a
// thread, 32 blocks a warp: the lanes' chains take different branches at
// almost every decision, so each waited out the others', and a tile's few
// hundred blocks filled a handful of SMs.  Here a codeblock has a warp of
// its own and runs on lane 0 (the other lanes only load the tables), so a
// chain never waits on another's branches and a tile's blocks spread over
// the SMs; with thousands of blocks a launch, the warps of an SM then share
// its instruction slots.  The tables sit in shared memory, the context states
// in registers, and the per-sample flags (significant, negative, visited,
// refined; (h + 2) x (w + 2) bytes, 4.2 KB for 64 x 64) in a per-block scratch
// slab in device memory that L1 and L2 hold.  Each block writes its codeword
// into its own slot first (the native coder's bound, h w numbps / 3 + 1024
// bytes), then reserves its place in the packed pool with one atomicAdd and
// copies it there.  A block whose numbps is beyond its limit (26, or 20 with
// need_dist) or whose codeword outgrows its slot writes nothing and reports it
// in its status; the wrapper raises.

#include <cstdint>

#include <cuda_runtime.h>

#include "mq_common.cuh"

namespace {

using namespace grk_mq;

constexpr int kDesc = 10;  // ptr, stride, h, w, orient, lazy, need_dist,
                           // slot_off, slot_cap, scratch_off
constexpr int kMeta = 6;   // out_off, out_len, numbps, status, sumsq,
                           // decisions
constexpr int kMaxPasses = 76;
constexpr int kStatusRange = 1;
constexpr int kStatusSlot = 2;
constexpr int kWarps = 4;  // codeblocks (warps) a CTA, one on each lane 0

struct Out {
  uint8_t* buf;
  int64_t pos, cap;
  bool overflow;
  int64_t decisions;  // MQ and raw decisions coded
  __device__ void put(uint32_t b) {
    if (pos < cap) buf[pos] = static_cast<uint8_t>(b);
    else overflow = true;
    ++pos;
  }
};

// The MQ writer (t1/mq.py MQEncoder), the last byte held in a register:
// BYTEOUT writes the byte it finishes, except the fake lead byte of a
// segment.
struct MQ {
  uint32_t a, c, last;
  int ct;
  bool fresh;
  int64_t nbo, start;  // BYTEOUTs since the segment started, its first byte

  __device__ void restart(int64_t pos) {
    a = 0x8000;
    c = 0;
    ct = 12;
    last = 0;
    fresh = true;
    nbo = 0;
    start = pos;
  }

  __device__ void byteout(Out& o) {
    const uint32_t carry = (last != 0xFF && c >= 0x8000000u) ? 1u : 0u;
    const uint32_t done = last + carry;
    const bool ff = done == 0xFF;
    c -= carry << 27;
    const int sh = ff ? 20 : 19;
    if (!fresh) o.put(done);
    fresh = false;
    last = (c >> sh) & 0xFF;
    c &= (1u << sh) - 1;
    ct = ff ? 7 : 8;
    ++nbo;
  }

  __device__ void encode(int d, int cx, uint8_t* states, const Tables& t,
                         Out& o) {
    ++o.decisions;
    int si = states[cx];
    const uint32_t qe = t.qe[si];
    a -= qe;
    if ((d ^ si) & 1) {  // LPS
      if (a < qe) c += qe;
      else a = qe;
      states[cx] = t.nlps[si];
    } else {
      if (a & 0x8000) {
        c += qe;
        return;
      }
      if (a < qe) a = qe;
      else c += qe;
      states[cx] = t.nmps[si];
    }
    do {
      a <<= 1;
      c <<= 1;
      if (--ct == 0) byteout(o);
    } while (!(a & 0x8000));
  }

  // The standard flush; the last byte is dropped when it is 0xFF.
  __device__ void flush(Out& o) {
    const uint32_t tempc = c + a;
    c |= 0xFFFF;
    if (c >= tempc) c -= 0x8000;
    c <<= ct;
    byteout(o);
    c <<= ct;
    byteout(o);
    if (last != 0xFF) o.put(last);
  }
};

// The bypass writer (t1/mq.py RawEncoder): 8 bits a byte, 7 after 0xFF.
struct Raw {
  uint32_t acc;
  int used, cap;
  int64_t start;

  __device__ void restart(int64_t pos) {
    acc = 0;
    used = 0;
    cap = 8;
    start = pos;
  }
  __device__ void encode(int d, Out& o) {
    ++o.decisions;
    acc = (acc << 1) | (d & 1);
    if (++used == cap) {
      o.put(acc);
      cap = acc == 0xFF ? 7 : 8;
      acc = 0;
      used = 0;
    }
  }
  __device__ int64_t num_bytes(const Out& o) const {
    return o.pos - start + (used ? 1 : 0);
  }
  __device__ void flush(Out& o) {
    if (used) o.put(acc << (cap - used));
    if (o.pos > start && o.pos <= o.cap && o.buf[o.pos - 1] == 0xFF) --o.pos;
  }
};

__device__ __forceinline__ uint32_t uabs(int32_t v) {
  const uint32_t u = static_cast<uint32_t>(v);
  return v < 0 ? 0u - u : u;
}

// Distortion decrease when a sample of magnitude m turns significant at
// plane bp, and when it is refined at plane bp (t1/coder.py on_sig,
// on_ref; the reconstruction after plane bp is trunc + half).
__device__ __forceinline__ int64_t d_sig(int64_t m, int bp) {
  const int64_t one = int64_t{1} << bp;
  const int64_t nr = one | (one >> 1);
  return m * m - (m - nr) * (m - nr);
}
__device__ __forceinline__ int64_t d_ref(int64_t m, int bp) {
  const int64_t one = int64_t{1} << bp;
  const int64_t old = ((m >> (bp + 1)) << (bp + 1)) + one;
  const int64_t nw = bp >= 1 ? ((m >> bp) << bp) + (one >> 1) : m;
  return (m - old) * (m - old) - (m - nw) * (m - nw);
}

__global__ void __launch_bounds__(32 * kWarps)
    mq_encode_kernel(const int64_t* __restrict__ desc,
                     const uint8_t* __restrict__ tables,
                     uint8_t* __restrict__ slots, uint8_t* __restrict__ packed,
                     unsigned long long* __restrict__ used,
                     int64_t* __restrict__ meta, int32_t* __restrict__ rates,
                     uint8_t* __restrict__ terms, int64_t* __restrict__ dists,
                     uint8_t* __restrict__ scratch, int nblocks) {
  __shared__ Tables t;
  load_tables(&t, tables);
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if ((threadIdx.x & 31) != 0 || b >= nblocks) return;
  const int64_t* d = desc + kDesc * static_cast<int64_t>(b);
  const int32_t* x = reinterpret_cast<const int32_t*>(
      static_cast<uintptr_t>(d[0]));
  const int64_t stride = d[1];
  const int h = static_cast<int>(d[2]);
  const int w = static_cast<int>(d[3]);
  const int orient = static_cast<int>(d[4]);
  const bool lazy = d[5] != 0;
  const bool need_dist = d[6] != 0;
  int64_t* m = meta + kMeta * static_cast<int64_t>(b);
  int32_t* rate = rates + kMaxPasses * static_cast<int64_t>(b);
  uint8_t* term = terms + kMaxPasses * static_cast<int64_t>(b);
  int64_t* dist = dists + kMaxPasses * static_cast<int64_t>(b);
  for (int i = 0; i < kMaxPasses; ++i) {
    rate[i] = 0;
    term[i] = 0;
    dist[i] = 0;
  }
  const int p = w + 2;
  uint8_t* fl = scratch + d[9];
  for (int i = 0; i < (h + 2) * p; ++i) fl[i] = 0;
  uint32_t maxmag = 0;
  int64_t sumsq = 0;
  for (int yy = 0; yy < h; ++yy)
    for (int xx = 0; xx < w; ++xx) {
      const int32_t v = x[yy * stride + xx];
      const uint32_t u = uabs(v);
      maxmag = max(maxmag, u);
      sumsq += static_cast<int64_t>(u) * u;
      if (v < 0) fl[(yy + 1) * p + xx + 1] = kNeg;
    }
  const int numbps = 32 - __clz(maxmag);
  m[0] = 0;
  m[1] = 0;
  m[2] = numbps;
  m[3] = 0;
  m[4] = sumsq;
  m[5] = 0;
  if (numbps > (need_dist ? 20 : 26)) {
    m[3] = kStatusRange;
    return;
  }
  if (numbps == 0) return;

  Out o{slots + d[7], 0, d[8], false, 0};
  uint8_t states[kNumCtx];
  for (int i = 0; i < kNumCtx; ++i) states[i] = t.init[i];
  MQ mq;
  mq.restart(0);
  Raw raw;
  raw.restart(0);
  bool raw_active = false;
  const uint8_t* zc = t.zc + 256 * orient;
  const int npass = 3 * numbps - 2;
  int passno = 0;
  int64_t dacc = 0;
#define MAG(yy, xx) uabs(x[(yy) * stride + (xx)])

  for (int bp = numbps - 1; bp >= 0; --bp) {
    for (int pt = (bp == numbps - 1 ? 2 : 0); pt <= 2; ++pt) {
      const bool is_raw = lazy && pt < 2 && bp <= numbps - 5;
      if (is_raw && !raw_active) {
        raw.restart(o.pos);
        raw_active = true;
      }
      const uint32_t one = 1u << bp;
      for (int sy = 0; sy < h; sy += 4) {
        const int rows = min(4, h - sy);
        for (int xx = 0; xx < w; ++xx) {
          int k0 = 0;
          if (pt == 2 && rows == 4) {
            // run-length aggregation of a clean column
            bool agg = true;
            for (int k = 0; k < 4 && agg; ++k) {
              const int f = (sy + k + 1) * p + xx + 1;
              if ((fl[f] & (kSig | kVis)) || zc_pattern(fl, f, p)) agg = false;
            }
            if (agg) {
              int first = 4;
              for (int k = 0; k < 4; ++k)
                if (MAG(sy + k, xx) & one) {
                  first = k;
                  break;
                }
              mq.encode(first < 4, kCtxRl, states, t, o);
              if (first == 4) continue;
              mq.encode((first >> 1) & 1, kCtxUni, states, t, o);
              mq.encode(first & 1, kCtxUni, states, t, o);
              const int f = (sy + first + 1) * p + xx + 1;
              const int sci = sc_index(fl, f, p);
              mq.encode(((fl[f] & kNeg) ? 1 : 0) ^ t.sc_xor[sci],
                        t.sc_cn[sci], states, t, o);
              fl[f] |= kSig;
              if (need_dist) dacc += d_sig(MAG(sy + first, xx), bp);
              k0 = first + 1;
            }
          }
          for (int k = k0; k < rows; ++k) {
            const int f = (sy + k + 1) * p + xx + 1;
            const uint8_t g = fl[f];
            const uint32_t mg = MAG(sy + k, xx);
            const int bit = (mg & one) ? 1 : 0;
            if (pt == 1) {  // magnitude refinement
              if (!(g & kSig) || (g & kVis)) continue;
              if (is_raw) {
                raw.encode(bit, o);
              } else {
                const int cx = (g & kRef) ? kCtxMag + 2
                               : kCtxMag + (zc_pattern(fl, f, p) ? 1 : 0);
                mq.encode(bit, cx, states, t, o);
              }
              fl[f] = g | kRef;
              if (need_dist) dacc += d_ref(mg, bp);
              continue;
            }
            if (g & kSig) continue;
            if (pt == 2 && (g & kVis)) continue;
            const int zp = zc_pattern(fl, f, p);
            if (pt == 0 && !zp) continue;
            if (is_raw) raw.encode(bit, o);
            else mq.encode(bit, zc[zp], states, t, o);
            if (bit) {
              if (is_raw) {
                raw.encode((g & kNeg) ? 1 : 0, o);
              } else {
                const int sci = sc_index(fl, f, p);
                mq.encode(((g & kNeg) ? 1 : 0) ^ t.sc_xor[sci], t.sc_cn[sci],
                          states, t, o);
              }
              fl[f] |= kSig;
              if (need_dist) dacc += d_sig(mg, bp);
            }
            if (pt == 0) fl[f] |= kVis;
          }
        }
      }
      if (pt == 2)
        for (int i = 0; i < (h + 2) * p; ++i) fl[i] &= ~kVis;
      const bool last = passno == npass - 1;
      const bool is_term =
          last || (lazy && ((pt == 2 && bp <= numbps - 4) ||
                            (pt == 1 && bp <= numbps - 5)));
      int64_t r;
      if (is_term) {
        if (is_raw) {
          raw.flush(o);
          raw_active = false;
        } else {
          mq.flush(o);
          mq.restart(o.pos);
        }
        r = o.pos;
      } else if (is_raw) {
        r = raw.start + raw.num_bytes(o) + 1;
      } else {
        r = mq.start + mq.nbo + 4;
      }
      rate[passno] = static_cast<int32_t>(r);
      term[passno] = is_term;
      if (need_dist) dist[passno] = dacc;
      ++passno;
    }
  }
#undef MAG
  m[5] = o.decisions;
  if (o.overflow || o.pos > o.cap) {
    m[3] = kStatusSlot;
    return;
  }
  const int64_t total = o.pos;
  int32_t next = static_cast<int32_t>(total);
  for (int i = npass - 1; i >= 0; --i) {
    next = min(next, rate[i]);
    rate[i] = next;
  }
  const int64_t at = static_cast<int64_t>(
      atomicAdd(used, static_cast<unsigned long long>(total)));
  for (int64_t i = 0; i < total; ++i) packed[at + i] = o.buf[i];
  m[0] = at;
  m[1] = total;
}

}  // namespace

// desc: (nblocks, 10) int64 (see kDesc); tables: ops/mq_encode.py
// device_tables; slots: pool_cap bytes, block b's slot at desc[b][7];
// packed: pool_cap bytes, the codewords one after another; used: one uint64
// set to 0, the packed bytes on return; meta: (nblocks, 5) int64; rates,
// terms, dists: (nblocks, 76) int32, uint8, int64; scratch: each block's
// (h + 2) x (w + 2) flag bytes from desc[b][9].
extern "C" int grk_mq_encode(const void* desc, const void* tables,
                             void* slots, void* packed, void* used,
                             void* meta, void* rates, void* terms, void* dists,
                             void* scratch, int nblocks, long long pool_cap,
                             void* stream) {
  if (nblocks <= 0 || pool_cap < 0) return cudaErrorInvalidValue;
  mq_encode_kernel<<<(nblocks + kWarps - 1) / kWarps, 32 * kWarps, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(desc), static_cast<const uint8_t*>(tables),
      static_cast<uint8_t*>(slots), static_cast<uint8_t*>(packed),
      static_cast<unsigned long long*>(used), static_cast<int64_t*>(meta),
      static_cast<int32_t*>(rates), static_cast<uint8_t*>(terms),
      static_cast<int64_t*>(dists), static_cast<uint8_t*>(scratch), nblocks);
  return cudaGetLastError();
}
