// Shared pieces of the MQ Tier-1 kernels (mq_encode.cu, mq_decode.cu): the
// per-sample flag word, the tables the wrapper passes in (built by
// grok_tpu_torch/ops/mq_tables.py, one uint8 buffer, see ops/mq_encode.py
// device_tables), the layout of a codeblock's state in shared memory, and
// the neighbour context formation of ISO/IEC 15444-1 Annex D for styles
// NONE and LAZY.

#pragma once

#include <cstdint>

namespace grk_mq {

// The flag word of a sample (native/t1.cc T1State), 16 bits: the
// significance of its 8 neighbours, the signs of its 4 direct neighbours
// (set together with their significance), and its own state.
constexpr uint32_t kNW = 1u << 0, kN = 1u << 1, kNE = 1u << 2, kW = 1u << 3,
                   kE = 1u << 4, kSW = 1u << 5, kS = 1u << 6, kSE = 1u << 7;
constexpr uint32_t kWNeg = 1u << 8, kENeg = 1u << 9, kNNeg = 1u << 10,
                   kSNeg = 1u << 11;
constexpr uint32_t kSig = 1u << 12, kVis = 1u << 13, kRef = 1u << 14,
                   kNeg = 1u << 15;
constexpr uint32_t kNbr = 0xFF;  // any neighbour significant

// A stripe column: the flag words of its 4 rows, adjacent, as one uint64.
__host__ __device__ __forceinline__ constexpr uint64_t rep4(uint32_t m) {
  return static_cast<uint64_t>(m) * 0x0001000100010001ull;
}

constexpr int kNumCtx = 19;
constexpr int kCtxMag = 14;
constexpr int kCtxRl = 17;
constexpr int kCtxUni = 18;
constexpr int kNumSi = 94;

// offsets in the table buffer
constexpr int kTabQe = 0;      // 94 x uint32: qe | mps << 15 | nmps << 16 |
                               // nlps << 24 by si (mq_tables.QE_FUSED)
constexpr int kTabZc = 376;    // 4 x 256: ZC context by orient, word & 0xFF
constexpr int kTabSc = 1400;   // 256: SC context | XOR bit << 7 by
                               // sc_index (mq_tables.SC_WORD)
constexpr int kTabInit = 1656; // 19: initial si of each context
constexpr int kTabBytes = 1675;

// The head of a block's dynamic shared memory: the tables, then the 19
// context states, each the fused table entry of its si, then the sink the
// lanes other than the lead store into (Lead).
struct Tables {
  uint32_t qe[kNumSi];
  uint8_t zc[1024];
  uint8_t sc[256];
};
constexpr int kTablesBytes = (sizeof(Tables) + 15) / 16 * 16;
constexpr int kStatesBytes = (4 * kNumCtx + 15) / 16 * 16;
constexpr int kSinkBytes = kStatesBytes;
// ops/mq_tables.py SMEM_FIXED: the flag words start here
constexpr int kSmemFixed = kTablesBytes + kStatesBytes + kSinkBytes;
static_assert(kSmemFixed == 1824, "ops/mq_tables.py SMEM_FIXED");

// A codeblock of h x w samples in shared memory (ops/mq_tables.py
// smem_bytes): the flag words stripe by stripe, with a border stripe above
// and below and a border column left and right, 4 words a stripe column;
// then one uint16 a stripe column, the plane map: the current plane's bits
// of its samples (bits 0-3, the encoder's) and the events its samples saw
// in the current plane (2 bits a row from bit 8).
struct Layout {
  int h, w, ss;  // ss: words a stripe row, (w + 2) * 4
  int ns;        // stripes, ceil(h / 4)
  uint16_t* fl;
  uint16_t* map;
  Layout() = default;
  __device__ Layout(uint8_t* smem, int hh, int ww) : h(hh), w(ww) {
    ss = (w + 2) * 4;
    ns = (h + 3) >> 2;
    fl = reinterpret_cast<uint16_t*>(smem + kSmemFixed);
    map = reinterpret_cast<uint16_t*>(smem + kSmemFixed +
                                      ((ns + 2) * ss * 2 + 15) / 16 * 16);
  }
  __device__ int words() const { return (ns + 2) * ss; }
  // the flag word of sample (y, x)
  __device__ int idx(int y, int x) const {
    return ((y >> 2) + 1) * ss + (x + 1) * 4 + (y & 3);
  }
};

// Events in the plane map, 2 bits a row from bit kEvShift.
constexpr int kEvShift = 8;

// Zero the visited flags of the whole block, all lanes.
__device__ __forceinline__ void clear_visited(const Layout& L, int lane) {
  uint64_t* fl64 = reinterpret_cast<uint64_t*>(L.fl);
  for (int i = lane; i < L.words() / 4; i += 32) fl64[i] &= ~rep4(kVis);
}

// Copy the tables into shared memory and set the context states, all
// lanes of the warp; ends with __syncwarp().
__device__ inline void load_tables(uint8_t* smem, const uint8_t* src) {
  Tables* t = reinterpret_cast<Tables*>(smem);
  uint32_t* st = reinterpret_cast<uint32_t*>(smem + kTablesBytes);
  const int lane = threadIdx.x & 31;
  const uint32_t* q = reinterpret_cast<const uint32_t*>(src + kTabQe);
  for (int i = lane; i < kNumSi; i += 32) t->qe[i] = q[i];
  const uint32_t* z = reinterpret_cast<const uint32_t*>(src + kTabZc);
  uint32_t* zd = reinterpret_cast<uint32_t*>(t->zc);
  for (int i = lane; i < 256; i += 32) zd[i] = z[i];
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src + kTabSc);
  uint32_t* sd = reinterpret_cast<uint32_t*>(t->sc);
  for (int i = lane; i < 64; i += 32) sd[i] = s[i];
  if (lane < kNumCtx) st[lane] = q[src[kTabInit + lane]];
  __syncwarp();
}

// Lane 0 leads a warp's coder.  The whole warp runs the coder in step on
// the same data, so that its branches stay warp-uniform: a coder on lane 0
// alone makes the compiler pay divergence bookkeeping at every branch.
// Only the lead lane's stores land; the other lanes store into the sink,
// the address chosen, not the store, so that no branch depends on the lane.
// A result therefore depends on lane 0 alone, however the lanes are
// scheduled.
struct Lead {
  bool lead;
  uint8_t* sink;  // kSinkBytes, after the context states
  // where this lane's store to p goes
  template <class T>
  __device__ __forceinline__ T* at(T* p) const {
    return lead ? p : reinterpret_cast<T*>(sink);
  }
  template <class T>
  __device__ __forceinline__ void or_into(T* p, uint64_t m) const {
    *at(p) = static_cast<T>(*p | m);
  }
};

__device__ __forceinline__ Lead make_lead(uint8_t* smem, int lane) {
  return Lead{lane == 0, smem + kTablesBytes + kStatesBytes};
}

// The SC table index of a flag word: bits N W E S WNEG ENEG NNEG SNEG from
// bit 0 (native/t1.cc sc_index).
__device__ __forceinline__ uint32_t sc_index(uint32_t f) {
  return ((f >> 1) & 1) | ((f >> 2) & 6) | ((f >> 3) & 8) | ((f >> 4) & 0xF0);
}

// Sample k (0-3) of the stripe column whose 4 words start at fc turns
// significant, with sign neg: its own column (held in col) gains SIG and
// the N/S bits of its vertical neighbours, the columns left and right and
// the stripes above and below their bits in shared memory (native/t1.cc
// set_sig); nxt, the column on the right as already loaded, gains them
// too.  Only the lead lane's stores land (Lead).
__device__ __forceinline__ void set_sig(uint16_t* fc, int ss, uint64_t& col,
                                        uint64_t& nxt, int k, uint32_t neg,
                                        const Lead& ld) {
  const int sh = 16 * k;
  // own column: SIG at k, S (+SNEG) at k - 1, N (+NNEG) at k + 1
  const uint64_t up = kS | (neg ? kSNeg : 0u);
  const uint64_t dn = kN | (neg ? kNNeg : 0u);
  col |= static_cast<uint64_t>(kSig) << sh;
  if (k > 0) col |= up << (sh - 16);
  if (k < 3) col |= dn << (sh + 16);
  // the columns left and right: words k - 1, k, k + 1 of each, as one
  // 48-bit pattern placed at word k - 1
  const uint64_t pl = kSE | static_cast<uint64_t>(kE | (neg ? kENeg : 0u))
                                << 16 |
                      static_cast<uint64_t>(kNE) << 32;
  const uint64_t pr = kSW | static_cast<uint64_t>(kW | (neg ? kWNeg : 0u))
                                << 16 |
                      static_cast<uint64_t>(kNW) << 32;
  uint64_t* left = reinterpret_cast<uint64_t*>(fc - 4);
  uint64_t* right = reinterpret_cast<uint64_t*>(fc + 4);
  const uint64_t r = k ? pr << (sh - 16) : pr >> 16;
  ld.or_into(left, k ? pl << (sh - 16) : pl >> 16);
  ld.or_into(right, r);
  nxt |= r;
  if (k == 0 || k == 3) {  // row 3 of the stripe above, row 0 below
    uint16_t* v = k ? fc + ss : fc - ss + 3;
    ld.or_into(v - 4, k ? kNE : kSE);
    ld.or_into(v, k ? dn : up);
    ld.or_into(v + 4, k ? kNW : kSW);
  }
}

}  // namespace grk_mq
