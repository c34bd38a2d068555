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
// because a TPU cannot run a serial coder per lane; here a codeblock runs
// the standard bit-plane coder (t1/coder.py encode_cblk, native/t1.cc):
// SPP, MRP and CUP with run-length aggregation, the MQ writer with its last
// byte in a register, and the raw writer of the bypass passes.
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
// decision's context needs the significance the decisions before it set,
// so a launch takes about the longest chain times the latency of one
// decision; with thousands of blocks a launch, the chains resident on an SM
// also share its issue slots and instruction cache, so what counts there
// is how many fit at once and how few instructions a decision takes.  The
// design:
// - a codeblock has a warp (a CTA of 32 threads) of its own, so no chain
//   waits out another's branches and a tile's blocks spread over the SMs;
// - its coding state is in shared memory, 13.4 KB for 64 x 64 (about 17
//   blocks an SM): one 16-bit flag word a sample in native/t1.cc's layout
//   (8 neighbour significance bits, 4 neighbour signs, own SIG/VIS/REF/NEG;
//   stripe-contiguous, so a stripe column is one 64-bit load), which makes
//   a ZC context one table lookup of the word and an SC context a gather
//   of 8 of its bits; the 19 context states, each the fused table entry of
//   its si (qe, MPS, both successors), so a decision makes one dependent
//   load; and a plane map, a 16-bit entry a stripe column;
// - the whole warp runs the coder in step on the same data and only lane
//   0's stores land (the others' go to a sink, mq_common.cuh Lead), so its
//   branches stay warp-uniform: a coder on lane 0 alone paid the
//   compiler's divergence bookkeeping at every branch; a result depends on
//   lane 0 alone;
// - the coder takes a plane at a time and never touches a coefficient:
//   before each plane the warp writes the plane's bits of every stripe
//   column into the plane map, one lane a column; after it, the warp sums
//   the plane's distortions from the events the coder recorded there (with
//   need_dist) and clears the visited flags;
// - the coder forms a stripe column's contexts first, queueing its up to
//   10 decisions in one 64-bit register, then runs the MQ writer over the
//   queue: the context lookups leave the writer's chain, and the kernel
//   has one inlined writer a pass, loops not unrolled, so many resident
//   chains share the instruction cache;
// - the MQ renormalisation shifts by count-leading-zeros, in at most a few
//   steps split where a byte goes out;
// - a pass skips a stripe column with one test of its 4 words, and SPP and
//   MRP are skipped while no sample is significant;
// - the whole warp also loads the block once (numbps by warp max, the
//   int64 sum of squares by warp sum, the signs into the flag words),
//   zeroes the state and the pass arrays, and copies the codeword into the
//   packed pool.
// Dynamic shared memory is sized by the wrapper from the launch's largest
// block (ops/mq_tables.py smem_bytes).  Each block writes its codeword into
// its own slot in device memory first (the native coder's bound,
// h w numbps / 3 + 1024 bytes), then reserves its place in the packed pool
// with one atomicAdd.  A block whose numbps is beyond its limit (26, or 20
// with need_dist) or whose codeword outgrows its slot writes nothing and
// reports it in its status; the wrapper raises.

#include <cstdint>

#include <cuda_runtime.h>

#include "mq_common.cuh"

namespace {

using namespace grk_mq;

constexpr int kDesc = 9;  // ptr, stride, h, w, orient, lazy, need_dist,
                          // slot_off, slot_cap
constexpr int kMeta = 6;  // out_off, out_len, numbps, status, sumsq,
                          // decisions
constexpr int kMaxPasses = 76;
constexpr int kStatusRange = 1;
constexpr int kStatusSlot = 2;

struct Out {
  uint8_t* buf;
  int pos, cap;  // a slot holds at most 4096 * 26 / 3 + 1024 bytes
  bool overflow;
  int decisions;  // MQ and raw decisions coded
  bool lead;      // this lane's stores land (mq_common.cuh Lead)
  uint32_t last;  // the byte put last
  __device__ __forceinline__ void put(uint32_t b) {
    if (pos < cap) {
      if (lead) buf[pos] = static_cast<uint8_t>(b);
    } else {
      overflow = true;
    }
    last = b & 0xFF;
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
  int nbo, start;  // BYTEOUTs since the segment started, its first byte

  __device__ __forceinline__ void restart(int pos) {
    a = 0x8000;
    c = 0;
    ct = 12;
    last = 0;
    fresh = true;
    nbo = 0;
    start = pos;
  }

  __device__ __forceinline__ void byteout(Out& o) {
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

  // Code decision d in context cx; st: the context states, qt: the fused
  // table.  The renormalisation shifts a and c by the leading zeros of a
  // at once, split where ct reaches 0: there the bit loop puts a BYTEOUT.
  __device__ __forceinline__ void encode(uint32_t d, int cx, uint32_t* st,
                                         const uint32_t* qt, Out& o,
                                         const Lead& ld) {
    ++o.decisions;
    const uint32_t e = st[cx];
    const uint32_t qe = e & 0x7FFF;
    uint32_t next;
    a -= qe;
    if (d != ((e >> 15) & 1)) {  // LPS
      if (a < qe) c += qe;
      else a = qe;
      next = qt[e >> 24];
    } else {
      if (a & 0x8000) {
        c += qe;
        return;
      }
      if (a < qe) a = qe;
      else c += qe;
      next = qt[(e >> 16) & 0xFF];
    }
    *ld.at(st + cx) = next;
    int n = __clz(a) - 16;
    while (n >= ct) {
      a <<= ct;
      c <<= ct;
      n -= ct;
      byteout(o);
    }
    a <<= n;
    c <<= n;
    ct -= n;
  }

  // The standard flush; the last byte is dropped when it is 0xFF.
  __device__ __forceinline__ void flush(Out& o) {
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
  int start;

  __device__ __forceinline__ void restart(int pos) {
    acc = 0;
    used = 0;
    cap = 8;
    start = pos;
  }
  __device__ __forceinline__ void encode(uint32_t d, Out& o) {
    ++o.decisions;
    acc = (acc << 1) | (d & 1);
    if (++used == cap) {
      o.put(acc);
      cap = acc == 0xFF ? 7 : 8;
      acc = 0;
      used = 0;
    }
  }
  __device__ __forceinline__ int num_bytes(const Out& o) const {
    return o.pos - start + (used ? 1 : 0);
  }
  __device__ __forceinline__ void flush(Out& o) {
    if (used) o.put(acc << (cap - used));
    if (o.pos > start && o.pos <= o.cap && o.last == 0xFF) --o.pos;
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

// Decisions of a stripe column, queued while its contexts are formed and
// coded after: 6 bits each, (context + 1) << 1 | bit, the first in the low
// bits; at most 10 a column (CUP: run length, 2 uniform, a sign, then 3
// samples with their signs).
struct Queue {
  uint64_t q;
  int n;
  __device__ __forceinline__ void push(uint32_t d, uint32_t cx) {
    q |= static_cast<uint64_t>((cx + 1) << 1 | d) << n;
    n += 6;
  }
};

// The warp's coder (lane 0 leads): the block's flag words and plane map in
// shared memory, the context states, the writers.
struct Coder {
  Layout L;
  const Tables* t;
  uint32_t* st;
  const uint8_t* zc;
  MQ mq;
  Raw raw;
  Out o;
  int nsig;
  bool need_dist;  // record the events of the plane for its distortions
  Lead ld;

  __device__ __forceinline__ void store(uint16_t* fc, uint64_t col) {
    *ld.at(reinterpret_cast<uint64_t*>(fc)) = col;
  }
  __device__ __forceinline__ void store(uint16_t* mp, uint32_t v) {
    *ld.at(mp) = static_cast<uint16_t>(v);
  }

  // Code the queued decisions of a column, in order.
  __device__ __forceinline__ void flush(Queue& qu) {
    for (uint64_t q = qu.q; q; q >>= 6) {
      const uint32_t code = static_cast<uint32_t>(q) & 63;
      mq.encode(code & 1, (code >> 1) - 1, st, t->qe, o, ld);
    }
    qu.q = 0;
    qu.n = 0;
  }

  // The sign of the sample of word f (queued, or raw) and its turning
  // significant at row k.
  template <bool RAW>
  __device__ __forceinline__ void sig(Queue& qu, uint16_t* fc,
                                      uint64_t& col, uint64_t& nxt, int k,
                                      uint32_t f) {
    const uint32_t neg = (f >> 15) & 1;
    if (RAW) {
      raw.encode(neg, o);
    } else {
      const uint32_t sc = t->sc[sc_index(f)];
      qu.push(neg ^ (sc >> 7), sc & 0x7F);
    }
    set_sig(fc, L.ss, col, nxt, k, neg, ld);
    ++nsig;
  }

  // Significance propagation pass.  Events: 1, turned significant.
  template <bool RAW>
  __device__ __forceinline__ void spp() {
    const uint64_t all_sig = rep4(kSig);
    Queue qu{0, 0};
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
        const uint32_t bits = *mp;
        uint32_t ev = 0;
#pragma unroll 1
        for (int k = 0; k < rows; ++k) {
          const uint32_t f = static_cast<uint32_t>(col >> (16 * k)) & 0xFFFF;
          if ((f & kSig) || !(f & kNbr)) continue;
          const uint32_t bit = (bits >> k) & 1;
          if (RAW) raw.encode(bit, o);
          else qu.push(bit, zc[f & 0xFF]);
          if (bit) {
            sig<RAW>(qu, fc, col, nxt, k, f);
            ev |= 1u << (2 * k);
          }
          col |= static_cast<uint64_t>(kVis) << (16 * k);
        }
        if (col != was) store(fc, col);
        if (need_dist && ev) store(mp, bits | ev << kEvShift);
        if (!RAW) flush(qu);
      }
    }
  }

  // Magnitude refinement pass.  Events: 2, refined.
  template <bool RAW>
  __device__ __forceinline__ void mrp() {
    Queue qu{0, 0};
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
        const uint32_t bits = *mp;
        uint32_t ev = 0;
#pragma unroll 1
        for (int k = 0; k < rows; ++k) {
          const uint32_t f = static_cast<uint32_t>(col >> (16 * k)) & 0xFFFF;
          if (!(f & kSig) || (f & kVis)) continue;
          const uint32_t bit = (bits >> k) & 1;
          if (RAW) {
            raw.encode(bit, o);
          } else {
            qu.push(bit, (f & kRef) ? kCtxMag + 2
                                    : kCtxMag + ((f & kNbr) ? 1 : 0));
          }
          col |= static_cast<uint64_t>(kRef) << (16 * k);
          ev |= 2u << (2 * k);
        }
        if (col != was) store(fc, col);
        if (need_dist) store(mp, bits | ev << kEvShift);
        if (!RAW) flush(qu);
      }
    }
  }

  // Cleanup pass.  Events: 3, turned significant.
  __device__ __forceinline__ void cup() {
    const uint64_t all_sig = rep4(kSig);
    Queue qu{0, 0};
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
        // every sample coded in an earlier pass
        if (rows == 4 && ((sv | (sv >> 1)) & all_sig) == all_sig) continue;
        const uint64_t was = col;
        const uint32_t bits = *mp;
        int k = 0;
        int forced = -1;  // the run's first sample: its bit is coded
        if (rows == 4 && !(col & rep4(kSig | kVis | kNbr))) {
          // run-length aggregation of a clean column
          const uint32_t b4 = bits & 15;
          qu.push(b4 != 0, kCtxRl);
          if (!b4) {
            flush(qu);
            continue;
          }
          k = forced = __ffs(b4) - 1;
          qu.push((k >> 1) & 1, kCtxUni);
          qu.push(k & 1, kCtxUni);
        }
        uint32_t ev = 0;
#pragma unroll 1
        for (; k < rows; ++k) {
          const uint32_t f = static_cast<uint32_t>(col >> (16 * k)) & 0xFFFF;
          uint32_t bit = 1;
          if (k != forced) {
            if (f & (kSig | kVis)) continue;
            bit = (bits >> k) & 1;
            qu.push(bit, zc[f & 0xFF]);
          }
          if (bit) {
            sig<false>(qu, fc, col, nxt, k, f);
            ev |= 3u << (2 * k);
          }
        }
        if (col != was) store(fc, col);
        if (need_dist && ev) store(mp, bits | ev << kEvShift);
        flush(qu);
      }
    }
  }
};

// The distortion decrease of a plane's three passes from its events
// (1 significant in SPP, 2 refined in MRP, 3 significant in CUP), summed
// over the warp's samples; every lane gets the sums.
__device__ __forceinline__ void plane_dists(const Layout& L, const int32_t* x,
                                            int64_t stride, int bp, int lane,
                                            int64_t& spp, int64_t& mrp,
                                            int64_t& cup) {
  unsigned long long s0 = 0, s1 = 0, s2 = 0;
  for (int c = lane; c < L.ns * L.w; c += 32) {
    const uint32_t ev = L.map[c] >> kEvShift;
    if (!ev) continue;
    const int s = c / L.w;
    const int32_t* xc = x + 4 * s * stride + (c - s * L.w);
    for (int k = 0; k < 4; ++k) {
      const uint32_t e = (ev >> (2 * k)) & 3;
      if (!e) continue;
      const int64_t m = uabs(xc[k * stride]);
      if (e == 2) s1 += d_ref(m, bp);
      else if (e == 1) s0 += d_sig(m, bp);
      else s2 += d_sig(m, bp);
    }
  }
  for (int off = 16; off; off >>= 1) {
    s0 += __shfl_xor_sync(0xFFFFFFFFu, s0, off);
    s1 += __shfl_xor_sync(0xFFFFFFFFu, s1, off);
    s2 += __shfl_xor_sync(0xFFFFFFFFu, s2, off);
  }
  spp = static_cast<int64_t>(s0);
  mrp = static_cast<int64_t>(s1);
  cup = static_cast<int64_t>(s2);
}

__global__ void __launch_bounds__(32)
    mq_encode_kernel(const int64_t* __restrict__ desc,
                     const uint8_t* __restrict__ tables,
                     uint8_t* __restrict__ slots, uint8_t* __restrict__ packed,
                     unsigned long long* __restrict__ used,
                     int64_t* __restrict__ meta, int32_t* __restrict__ rates,
                     uint8_t* __restrict__ terms, int64_t* __restrict__ dists) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  load_tables(smem, tables);
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
  uint8_t* slot = slots + d[7];
  const Layout L(smem, h, w);

  // the whole warp: zero the pass arrays and the flags, then mark the
  // negative samples and reduce numbps and the sum of squares
  for (int i = lane; i < kMaxPasses; i += 32) {
    rate[i] = 0;
    term[i] = 0;
    dist[i] = 0;
  }
  uint64_t* fl64 = reinterpret_cast<uint64_t*>(L.fl);
  for (int i = lane; i < L.words() / 4; i += 32) fl64[i] = 0;
  __syncwarp();
  uint32_t maxmag = 0;
  unsigned long long sumsq = 0;
  for (int i = lane; i < h * w; i += 32) {
    const int yy = i / w;
    const int xx = i - yy * w;
    const int32_t v = x[yy * stride + xx];
    const uint32_t u = uabs(v);
    maxmag = max(maxmag, u);
    sumsq += static_cast<unsigned long long>(u) * u;
    if (v < 0) L.fl[L.idx(yy, xx)] = static_cast<uint16_t>(kNeg);
  }
  maxmag = __reduce_max_sync(0xFFFFFFFFu, maxmag);
  for (int off = 16; off; off >>= 1)
    sumsq += __shfl_xor_sync(0xFFFFFFFFu, sumsq, off);
  const int numbps = 32 - __clz(maxmag);
  if (lane == 0) {
    m[0] = 0;
    m[1] = 0;
    m[2] = numbps;
    m[3] = numbps > (need_dist ? 20 : 26) ? kStatusRange : 0;
    m[4] = static_cast<int64_t>(sumsq);
    m[5] = 0;
  }
  if (numbps > (need_dist ? 20 : 26) || numbps == 0) return;

  // the warp runs the coder in step, a plane at a time, lane 0 storing;
  // between planes it writes the next plane's bits into the plane map, sums
  // the distortions of the plane coded and clears the visited flags
  Coder cd;
  cd.L = L;
  cd.t = reinterpret_cast<const Tables*>(smem);
  cd.st = reinterpret_cast<uint32_t*>(smem + kTablesBytes);
  cd.zc = cd.t->zc + 256 * orient;
  cd.mq.restart(0);
  cd.raw.restart(0);
  cd.o = Out{slot, 0, static_cast<int>(d[8]), false, 0, lane == 0, 0};
  cd.nsig = 0;
  cd.need_dist = need_dist;
  cd.ld = make_lead(smem, lane);
  const int area = h * w;
  const int npass = 3 * numbps - 2;
  bool raw_active = false;
  int passno = 0;
  int64_t dacc = 0;
  for (int bp = numbps - 1; bp >= 0; --bp) {
    __syncwarp();
    for (int c = lane; c < L.ns * w; c += 32) {
      const int s = c / w;
      const int xx = c - s * w;
      const int32_t* xc = x + 4 * s * stride + xx;
      const int rows = min(4, h - 4 * s);
      uint32_t bits = 0;
      for (int k = 0; k < rows; ++k)
        bits |= ((uabs(xc[k * stride]) >> bp) & 1) << k;
      L.map[c] = static_cast<uint16_t>(bits);
    }
    __syncwarp();
    const int pt0 = bp == numbps - 1 ? 2 : 0;
    for (int pt = pt0; pt <= 2; ++pt) {
      const bool is_raw = lazy && pt < 2 && bp <= numbps - 5;
      if (is_raw && !raw_active) {
        cd.raw.restart(cd.o.pos);
        raw_active = true;
      }
      if (pt == 0) {
        // no significant sample has no neighbourhood; all significant
        // leaves nothing to code
        if (cd.nsig != 0 && cd.nsig != area) {
          if (is_raw) cd.spp<true>();
          else cd.spp<false>();
        }
      } else if (pt == 1) {
        if (cd.nsig != 0) {
          if (is_raw) cd.mrp<true>();
          else cd.mrp<false>();
        }
      } else {
        cd.cup();
      }
      const bool last = passno == npass - 1;
      const bool is_term =
          last || (lazy && ((pt == 2 && bp <= numbps - 4) ||
                            (pt == 1 && bp <= numbps - 5)));
      int r;
      if (is_term) {
        if (is_raw) {
          cd.raw.flush(cd.o);
          raw_active = false;
        } else {
          cd.mq.flush(cd.o);
          cd.mq.restart(cd.o.pos);
        }
        r = cd.o.pos;
      } else if (is_raw) {
        r = cd.raw.start + cd.raw.num_bytes(cd.o) + 1;
      } else {
        r = cd.mq.start + cd.mq.nbo + 4;
      }
      if (lane == 0) {
        rate[passno] = r;
        term[passno] = is_term;
      }
      ++passno;
    }
    __syncwarp();
    if (need_dist) {
      int64_t spp, mrp, cup;
      plane_dists(L, x, stride, bp, lane, spp, mrp, cup);
      if (lane == 0) {
        if (pt0 == 0) {
          dist[passno - 3] = dacc += spp;
          dist[passno - 2] = dacc += mrp;
        }
        dist[passno - 1] = dacc += cup;
      }
    }
    clear_visited(L, lane);
  }

  // lane 0: the result, the codeword's length or -1
  long long total = -1;
  if (lane == 0) {
    m[5] = cd.o.decisions;
    if (cd.o.overflow || cd.o.pos > cd.o.cap) {
      m[3] = kStatusSlot;
    } else {
      total = cd.o.pos;
      int32_t next = cd.o.pos;
      for (int i = npass - 1; i >= 0; --i) {
        next = min(next, rate[i]);
        rate[i] = next;
      }
    }
  }
  // the whole warp: reserve the codeword's place and copy it there
  total = __shfl_sync(0xFFFFFFFFu, total, 0);
  if (total < 0) return;
  unsigned long long at = 0;
  if (lane == 0) {
    at = atomicAdd(used, static_cast<unsigned long long>(total));
    m[0] = static_cast<int64_t>(at);
    m[1] = total;
  }
  at = __shfl_sync(0xFFFFFFFFu, at, 0);
  for (long long i = lane; i < total; i += 32) packed[at + i] = slot[i];
}

}  // namespace

// desc: (nblocks, 9) int64 (see kDesc); tables: ops/mq_encode.py
// device_tables; slots: pool_cap bytes, block b's slot at desc[b][7];
// packed: pool_cap bytes, the codewords one after another; used: one uint64
// set to 0, the packed bytes on return; meta: (nblocks, 6) int64; rates,
// terms, dists: (nblocks, 76) int32, uint8, int64; smem_bytes: the dynamic
// shared memory of the launch's largest block (ops/mq_tables.py
// smem_bytes; at most 31,376 bytes, under the 48 KB a launch gets without
// opting in).
extern "C" int grk_mq_encode(const void* desc, const void* tables,
                             void* slots, void* packed, void* used,
                             void* meta, void* rates, void* terms, void* dists,
                             int nblocks, long long pool_cap, int smem_bytes,
                             void* stream) {
  if (nblocks <= 0 || pool_cap < 0 || smem_bytes < kSmemFixed)
    return cudaErrorInvalidValue;
  mq_encode_kernel<<<nblocks, 32, smem_bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(desc), static_cast<const uint8_t*>(tables),
      static_cast<uint8_t*>(slots), static_cast<uint8_t*>(packed),
      static_cast<unsigned long long*>(used), static_cast<int64_t*>(meta),
      static_cast<int32_t*>(rates), static_cast<uint8_t*>(terms),
      static_cast<int64_t*>(dists));
  return cudaGetLastError();
}
