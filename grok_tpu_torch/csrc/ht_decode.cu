// HT (Part 15) cleanup-pass decoder: every codeblock of a batch, mixed shapes,
// in three launches, each block written at its place in its destination
// tensor.
//
// Replaces grok_tpu/ops/ht_decode.py decode_cblks_ht_device (decode_batch_device
// / _decode_one: one scan over the quads carrying the MEL state, the VLC and
// MagSgn cursors and the u predictor), which runs as XLA code, not Pallas, on
// the TPU, and the host half around it (Scup parsing and 0xFF destuffing of
// the three streams, `_destuff`, with L).  Its input is the segments as
// Tier-2 hands them over, joined into one byte buffer by the host, with a
// descriptor a block.
//
// grk_ht_destuff: parses Scup (a segment with fewer than 2 bytes, a Scup
// below 2 or above its length has three empty streams), destuffs the MagSgn
// prefix, the MEL suffix read forward and the VLC suffix read backward into
// the block's scratch as big-endian 32-bit words, each stream followed by two
// zero words, and records the batch's longest destuffed stream.  A byte after
// a 0xFF gives its low 7 bits, the others 8.  What bounded the first cut (a
// warp a block, a CTA a warp): one byte a lane a round, so a 3,410-byte
// segment took about 107 dependent rounds, each a warp scan, three
// __syncwarp and two shared atomicOr a byte, with the next round's bytes
// loaded only one round ahead; the three streams one after another, the VLC
// one a byte at a time backward; and 32 resident CTAs of one warp on an SM.
// This design:
//  - a CTA is kDsWarps warps, a block each, so registers and not the cap of
//    32 CTAs an SM set how many warps an SM keeps, and the batch's longest
//    goes out as one atomicMax a CTA after a reduction in shared memory;
//  - a lane takes 16 bytes a round, one aligned 16-byte chunk: a round is
//    512 bytes (about 7 rounds for such a segment); bytes outside the
//    stream are masked, so segments need no alignment (the host pads the
//    joined buffer to whole 16-byte chunks);
//  - the backward VLC stream is read forward, 16 bytes at a time, and the
//    chunk's words taken in reverse order without their byte swap;
//  - inside a lane the chunk is a 128-bit big-endian value: the 0xFF bytes
//    are found with a SWAR test of each word, and the most significant bit
//    of every byte after one is dropped (one 128-bit shift-and-merge each,
//    the last first, so usually none or one); the only input from outside
//    the lane is the previous lane's last byte (one shuffle);
//  - one warp scan of the lanes' bit counts (at most 128) places each lane's
//    bits; the lane funnel-shifts them into its words in registers and
//    stores the words it completes; the one word a lane shares with the next
//    goes to that lane by a shuffle (middle lanes hold at least 112 bits, so
//    no word takes bits from three lanes), the round's last partial word is
//    carried: no shared staging and no atomics;
//  - the three streams are one sequence of rounds, each lane's chunks copied
//    by cp.async into a ring of kDsSlots slots kDsAhead rounds ahead, across
//    the streams' boundaries, so a round waits on a trip to DRAM only at the
//    start of the block.
//
// grk_ht_decode, one thread a block: the serial MEL + VLC chain (each quad's
// context needs the rho decoded before it), which bounds the decode: its
// time is the chain's length times the latency of one step.  A warp a block
// with the chain on lane 0 leaves 31 lanes waiting and, with the 15 KB of
// shared memory that staging a block's MEL and VLC streams takes, keeps only
// 14 chains on an SM at a time.  Here every lane of a warp runs the chain of
// its own block, so a warp keeps 32 chains in flight in lockstep, and a
// batch of thousands of blocks is one wave.  Each stream is read through a
// 64-bit register window, refilled from the scratch with words loaded four
// words ahead, so a window is a shift; the previous quad row's rho sits in
// shared memory, a column of 32 lanes a byte each; the cursors are 32-bit.
// rho and umax of every quad go to device memory.
//
// grk_ht_magsgn: reads rho and umax back; the MagSgn bit offset of each quad
// is an exclusive prefix sum of popcount(rho) * (umax + 1) over the raster
// order; each lane reads the windows of its quad's four samples (two words
// each from the scratch) and writes the samples, sign * (2m + 1), into the
// block's place in the output.  It derives grok_tpu's padded length L from
// the batch's longest stream in device memory: no host round trip between
// the launches.  What bounded the first cut (a warp a block, a CTA a warp):
// the sum ran chunk by chunk of 32 quads through a carry, and each chunk's
// window loads waited on its own rho and umax loads from device memory, so a
// 64x64 block was 32 chunks of two dependent trips to memory in a row; each
// sample went out as its own 4-byte store at a stride of 8 bytes; and its
// instructions: 64-bit cursors, windows and shifts and a division a quad.
// This design:
//  - a CTA is kMsWarps warps on one block, chunk c (32 quads) on warp
//    c % kMsWarps, so a 64x64 block's 32 chunks are 8 a warp and a launch of
//    a few hundred blocks (a tile) waits on a quarter of the chain; it is
//    built for kMsCtas CTAs an SM (64 registers);
//  - the block's rho and umax (at most 1 KB and 4 KB) are copied into shared
//    memory at once by cp.async, 16 bytes a thread a copy (the host pads
//    both arrays by 16 bytes);
//  - the cursors are 32-bit and the carry chain is gone: one warp reduction
//    a chunk puts each chunk's bits in shared memory, one warp scan of
//    those gives every warp the chunks' first cursors, and a warp scan
//    within a chunk the rest, so no chunk waits on another and kMsIlp
//    chunks' window loads are in flight together;
//  - where the destination's rows are 8-byte aligned (a uniform test a
//    block), each lane writes a row of its quad as one 8-byte store: 256
//    contiguous bytes a warp a row;
//  - few instructions a sample, since with the chain broken the launch is
//    bound by instruction issue: the cursor itself is the funnel shift's
//    offset and an unsigned word index; only a chunk where a cursor is
//    negative (a warp vote; corrupt streams alone make one) takes the path
//    with the 64-bit move by L; a quad's row is a multiply by a reciprocal;
//  - the MagSgn words are read from the scratch through L1, not staged: a
//    chunk's windows lie within a few cache lines, and a corrupt stream has
//    no bound on its length.
// The 32-bit cursors hold: grk_ht_decode restarts the u predictor at 1 on
// each quad row and moves it by diff, |diff| <= 65 (zz <= 3 + 127), so a
// quad at column qx has |umax - 1| <= 65 * (qx + 1) <= 65 * 512 (at most 512
// quads a row), whatever the bytes; a quad's bits are at most
// 4 * (umax + 1) in size, 133,128, and a block has at most 1,024 quads, so
// every cursor and sum stays within 136,323,072 + 3 * 33,282 < 2^31.  The
// move of a negative cursor by L (up to 2^63) is made in 64 bits.
//
// Whatever the bytes, nothing is read or written outside the block's segment
// (with its 16-byte chunks), scratch regions and output, and the padded rho
// and umax arrays: windows past a stream's end read its zero words.  Corrupt
// streams decode exactly as grok_tpu's device decoder decodes them: an int32
// right shift by a count outside [0, 31] fills with the sign bit (sar32), a
// negative MagSgn cursor is moved by L and clamped to 0 (JAX's
// dynamic_slice), and sums wrap as int32.

#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxQuads = 1024;
constexpr int kMaxQw = 512;
constexpr int kNumCtx = 8;
constexpr int kMaxCwdLen = 7;
constexpr int kDesc = 8;     // out_ptr, out_stride, h, w, seg_off, seg_len,
                             // scratch_off (words), quad_off
constexpr int kStreams = 6;  // (word offset, bits) of MagSgn, MEL, VLC
constexpr int kRefPad = 64;         // grok_tpu's cursor overrun guard, bits
constexpr int kMsWin = 31;
constexpr int kVlcWin = 17;
constexpr int kMelRunWin = 5;

// MEL exponent E[k] for k = 0..12, a nibble each: 0,0,0,1,1,1,2,2,2,3,3,4,5
constexpr uint64_t kMelE = 0x5433222111000ull;

// ---------------------------------------------------------------- destuff

constexpr int kDsWarps = 4;               // blocks a CTA
constexpr int kDsAhead = 4;               // rounds whose copies are in flight
constexpr int kDsSlots = kDsAhead + 1;    // ring slots a lane
constexpr int kRoundBytes = 512;          // a warp's bytes a round

// 128 bits, the first bit the most significant of hi
struct U128 {
  uint64_t hi, lo;
};

__device__ __forceinline__ U128 shl128(U128 v, int n) {  // 0 <= n < 128
  if (n == 0) return v;
  if (n < 64) return {(v.hi << n) | (v.lo >> (64 - n)), v.lo << n};
  return {v.lo << (n - 64), 0};
}

// the first n bits of v (0 < n < 128), the rest zero
__device__ __forceinline__ U128 first_bits(U128 v, int n) {
  if (n <= 64) return {v.hi & (~0ull << (64 - n)), 0};
  return {v.hi, v.lo & (~0ull << (128 - n))};
}

// v without its bit p (0 <= p < 128, from the first), a zero appended
__device__ __forceinline__ U128 drop_bit(U128 v, int p) {
  const U128 s = {(v.hi << 1) | (v.lo >> 63), v.lo << 1};
  if (p < 64) {
    const uint64_t keep = p ? ~0ull << (64 - p) : 0;
    return {(v.hi & keep) | (s.hi & ~keep), s.lo};
  }
  const uint64_t keep = p > 64 ? ~0ull << (128 - p) : 0;
  return {v.hi, (v.lo & keep) | (s.lo & ~keep)};
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// bit 3 - i set where byte i of x (from the most significant) is 0xFF
__device__ __forceinline__ uint32_t ff_bytes(uint32_t x) {
  const uint32_t t = ~x;
  const uint32_t z = ~(((t & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | t | 0x7F7F7F7Fu);
  return (((z >> 7) * 0x00204081u) >> 21) & 0xFu;
}

// Stream k of a segment: MagSgn (k = 0) is the first len - scup bytes read
// forward, MEL (1) the next scup - 2 read forward, VLC (2) the same bytes
// read backward from byte len - 3.  A lane's chunk in round r is the aligned
// 16 bytes at chunk + dir * (512 r + 16 lane); its byte j (in stream order)
// is stream byte 512 r + 16 lane - skew + j.
struct Geo {
  uintptr_t chunk;
  int64_t n;
  int skew, dir;

  __device__ int64_t rounds() const {
    return n > 0 ? (n + skew + kRoundBytes - 1) / kRoundBytes : 0;
  }
};

struct Segment {
  uintptr_t seg;
  int64_t len, scup, n_ms, n_sfx;

  __device__ Geo geo(int k) const {
    if (k == 2) {
      const uintptr_t e = seg + len - 3;
      return {e & ~uintptr_t{15}, n_sfx, 15 - static_cast<int>(e & 15), -1};
    }
    const uintptr_t a = k == 0 ? seg : seg + len - scup;
    return {a & ~uintptr_t{15}, k == 0 ? n_ms : n_sfx,
            static_cast<int>(a & 15), 1};
  }
};

// Copy this lane's chunk of round g of the block's sequence of rounds (the
// streams' rounds one after another: r0 of MagSgn, then MEL to r01, then
// VLC to rall) into `slot`, if it holds a byte of its stream; one commit
// group a round, empty or not.
__device__ __forceinline__ void fetch(const Segment& sg, int64_t r0,
                                      int64_t r01, int64_t rall, int64_t g,
                                      int lane, uint4* slot) {
  if (g < rall) {
    const int k = g < r0 ? 0 : g < r01 ? 1 : 2;
    const int64_t r = g - (k == 0 ? 0 : k == 1 ? r0 : r01);
    const Geo geo = sg.geo(k);
    const int64_t at = kRoundBytes * r + 16 * lane;
    if (at - geo.skew < geo.n && at - geo.skew + 16 > 0)
      __pipeline_memcpy_async(
          slot, reinterpret_cast<const void*>(geo.chunk + geo.dir * at), 16);
  }
  __pipeline_commit();
}

// A stream's destuffing so far: `words` complete words written, `held` bits
// of the next in `carry`, `prev` the byte before the next round's first
struct Run {
  uint32_t words, held, carry, prev;
};

// One round of a stream: this lane's chunk `raw` (as loaded, memory order),
// destuffed and placed at `out` after what `run` holds.
__device__ __forceinline__ void destuff_round(uint4 raw, const Geo& geo,
                                              int64_t r, int lane,
                                              uint32_t* out, Run& run) {
  const int64_t lo = kRoundBytes * r + 16 * lane - geo.skew;
  const int j0 = lo >= 0 ? 0 : lo <= -16 ? 16 : static_cast<int>(-lo);
  const int64_t left = geo.n - lo;
  const int j1 = left <= 0 ? 0 : left >= 16 ? 16 : static_cast<int>(left);
  // bit 15 - j: byte j lies in the stream
  const uint32_t valid = (0xFFFFu >> j0) & ~(0xFFFFu >> j1) & 0xFFFFu;
  U128 v = geo.dir > 0
               ? U128{(uint64_t{bswap32(raw.x)} << 32) | bswap32(raw.y),
                      (uint64_t{bswap32(raw.z)} << 32) | bswap32(raw.w)}
               : U128{(uint64_t{raw.w} << 32) | raw.z,
                      (uint64_t{raw.y} << 32) | raw.x};
  if (!valid)
    v = {0, 0};
  else if (j1 < 16)
    v = first_bits(v, 8 * j1);
  const uint32_t ff =
      ((ff_bytes(static_cast<uint32_t>(v.hi >> 32)) << 12) |
       (ff_bytes(static_cast<uint32_t>(v.hi)) << 8) |
       (ff_bytes(static_cast<uint32_t>(v.lo >> 32)) << 4) |
       ff_bytes(static_cast<uint32_t>(v.lo))) & valid;
  const uint32_t last = static_cast<uint32_t>(v.lo) & 0xFF;  // 0 unless valid
  uint32_t before = __shfl_up_sync(kFull, last, 1);
  if (lane == 0) before = run.prev;
  // bit 15 - j: byte j follows a 0xFF of the stream and gives 7 bits
  const uint32_t after =
      ((ff >> 1) | (before == 0xFF ? 0x8000u : 0u)) & valid;
  for (uint32_t m = after; m; m &= m - 1)  // the last such byte first
    v = drop_bit(v, 8 * (16 - __ffs(static_cast<int>(m))));
  if (j0 > 0 && j0 < 16) v = shl128(v, 8 * j0);
  const uint32_t c = 8 * __popc(valid) - __popc(after);  // at most 128
  uint32_t incl = c;
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  const uint32_t total = __shfl_sync(kFull, incl, 31);
  const uint32_t p = run.held + incl - c;  // the lane's first bit
  const uint32_t ph = p & 31;
  const uint32_t v0 = static_cast<uint32_t>(v.hi >> 32);
  const uint32_t v1 = static_cast<uint32_t>(v.hi);
  const uint32_t v2 = static_cast<uint32_t>(v.lo >> 32);
  const uint32_t v3 = static_cast<uint32_t>(v.lo);
  uint32_t w0 = v0 >> ph;
  const uint32_t w1 = __funnelshift_r(v1, v0, ph);
  const uint32_t w2 = __funnelshift_r(v2, v1, ph);
  const uint32_t w3 = __funnelshift_r(v3, v2, ph);
  const uint32_t w4 = __funnelshift_r(0u, v3, ph);
  const uint32_t end = p + c;
  const uint32_t nfull = (end >> 5) - (p >> 5);  // words the lane completes
  const uint32_t own = (end & 31) ? (nfull == 0   ? w0
                                     : nfull == 1 ? w1
                                     : nfull == 2 ? w2
                                     : nfull == 3 ? w3
                                                  : w4)
                                  : 0u;
  // the word the previous lane began (or the carry) is this lane's first
  uint32_t in = __shfl_up_sync(kFull, own, 1);
  if (lane == 0) in = run.carry;
  w0 |= in;
  uint32_t* dst = out + run.words + (p >> 5);
  if (nfull > 0) dst[0] = w0;
  if (nfull > 1) dst[1] = w1;
  if (nfull > 2) dst[2] = w2;
  if (nfull > 3) dst[3] = w3;
  // the round's partial word, from its last lane with bits
  const uint32_t part = nfull == 0 ? w0 : own;
  const unsigned busy = __ballot_sync(kFull, c != 0);
  const uint32_t tail =
      __shfl_sync(kFull, part, busy ? 31 - __clz(static_cast<int>(busy)) : 0);
  const uint32_t bits = run.held + total;
  run.words += bits >> 5;
  run.held = bits & 31;
  run.carry = run.held ? tail : 0u;
  run.prev = __shfl_sync(kFull, last, 31);
}

// The stream's last partial word and its two zero words; its bit count.
__device__ __forceinline__ uint32_t finish(uint32_t* out, const Run& run,
                                           int lane) {
  if (lane == 0 && run.held) out[run.words] = run.carry;
  const uint32_t data = run.words + (run.held ? 1 : 0);
  if (lane < 2) out[data + lane] = 0;
  return 32 * run.words + run.held;
}

__global__ void __launch_bounds__(32 * kDsWarps)
    ht_destuff_kernel(const int64_t* __restrict__ desc,
                      const uint8_t* __restrict__ data,
                      uint32_t* __restrict__ scratch,
                      int64_t* __restrict__ streams,
                      unsigned long long* __restrict__ longest, int nblocks) {
  __shared__ uint4 ring[kDsWarps][kDsSlots][32];
  __shared__ uint32_t most_w[kDsWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kDsWarps + warp;
  uint32_t most = 0;
  if (b < nblocks) {  // the whole warp: no lane leaves before the barrier
    const int64_t* d = desc + kDesc * b;
    const uint8_t* seg = data + d[4];
    const int64_t len = d[5];
    int64_t scup = 0;
    if (len >= 2) scup = (static_cast<int64_t>(seg[len - 1]) << 4) |
                         (seg[len - 2] & 0x0F);
    const bool ok = len >= 2 && scup >= 2 && scup <= len;
    const Segment sg{reinterpret_cast<uintptr_t>(seg), len, scup,
                     ok ? len - scup : 0, ok ? scup - 2 : 0};
    const int64_t r0 = sg.geo(0).rounds();
    const int64_t r01 = r0 + sg.geo(1).rounds();
    const int64_t rall = r01 + sg.geo(2).rounds();
    uint4* slots = &ring[warp][0][lane];  // slot i at slots[32 * i]
    for (int i = 0; i < kDsAhead; ++i)
      fetch(sg, r0, r01, rall, i, lane, slots + 32 * i);
    int64_t* s = streams + kStreams * b;
    int64_t off = d[6];
    int64_t g = 0;  // the block's rounds so far
    int slot = 0;   // round g's
    for (int k = 0; k < 3; ++k) {
      const Geo geo = sg.geo(k);
      const int64_t rounds = geo.rounds();
      uint32_t* out = scratch + off;
      Run run = {0, 0, 0, 0};
      for (int64_t r = 0; r < rounds; ++r, ++g) {
        __pipeline_wait_prior(kDsAhead - 1);
        const uint4 raw = slots[32 * slot];
        // round g + kDsAhead goes to the slot round g - 1 used
        fetch(sg, r0, r01, rall, g + kDsAhead, lane,
              slots + 32 * (slot ? slot - 1 : kDsSlots - 1));
        slot = slot + 1 == kDsSlots ? 0 : slot + 1;
        destuff_round(raw, geo, r, lane, out, run);
      }
      const uint32_t bits = finish(out, run, lane);
      if (lane == 0) {
        s[2 * k] = off;
        s[2 * k + 1] = bits;
      }
      most = max(most, bits);
      off += (geo.n + 3) / 4 + 2;  // 8 bits a byte at most, two zero words
    }
  }
  if (lane == 0) most_w[warp] = most;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t m = 0;
    for (int i = 0; i < kDsWarps; ++i) m = max(m, most_w[i]);
    if (m) atomicMax(longest, static_cast<unsigned long long>(m));
  }
}

// int32 >> s with XLA's semantics: a count outside [0, 31] fills with the
// sign bit.
__device__ __forceinline__ int32_t sar32(int32_t x, int32_t s) {
  if (static_cast<uint32_t>(s) > 31u) return x < 0 ? -1 : 0;
  return x >> s;
}

__device__ __forceinline__ bool shape_ok(int h, int w) {
  return h > 0 && w > 0 && h % 2 == 0 && w % 2 == 0 && w / 2 <= kMaxQw &&
         (h / 2) * (w / 2) <= kMaxQuads;
}

// A forward reader of a destuffed stream (nw words, then two zero words):
// a 64-bit window from word i in a register, and the kAhead words after it
// loaded ahead, so a read is a shift and a refill uses a word whose load was
// issued kAhead refills earlier (enough to cover a trip to L2).  Reads past
// the end give zeros.
constexpr int kAhead = 4;

struct Reader {
  const uint32_t* s;
  int nw, i;  // a suffix stream has at most 1,024 words
  uint64_t win;
  uint32_t ahead[kAhead];

  __device__ uint32_t word(int k) const { return k <= nw + 1 ? s[k] : 0u; }

  __device__ void init(const uint32_t* stream, int words) {
    s = stream;
    nw = words;
    i = 0;
    win = (static_cast<uint64_t>(s[0]) << 32) | s[1];
    for (int j = 0; j < kAhead; ++j) ahead[j] = word(2 + j);
  }

  // n (1..32) bits at bit `pos`, which never moves back
  __device__ uint32_t peek(int pos, int n) {
    while (pos - 32 * i >= 32) {
      win = (win << 32) | ahead[0];
      for (int j = 0; j + 1 < kAhead; ++j) ahead[j] = ahead[j + 1];
      ++i;
      ahead[kAhead - 1] = word(i + 1 + kAhead);
    }
    return static_cast<uint32_t>((win >> (64 - (pos - 32 * i) - n)) &
                                 ((1ull << n) - 1));
  }
};

__global__ void __launch_bounds__(32)
    ht_decode_kernel(const int64_t* __restrict__ desc,
                     const int64_t* __restrict__ streams,
                     const uint32_t* __restrict__ scratch,
                     const uint8_t* __restrict__ lut_rho,
                     const uint8_t* __restrict__ lut_len,
                     uint8_t* __restrict__ rho_out,
                     int32_t* __restrict__ umax_out, int nblocks, int maxc,
                     int max_qw) {
  extern __shared__ uint8_t rows[];  // rows[qx * 32 + lane]: rho above
  __shared__ uint8_t t_rho[kNumCtx << kMaxCwdLen];
  __shared__ uint8_t t_len[kNumCtx << kMaxCwdLen];
  const int lane = threadIdx.x;
  for (int i = lane; i < (kNumCtx << maxc); i += 32) {
    t_rho[i] = lut_rho[i];
    t_len[i] = lut_len[i];
  }
  __syncwarp();
  const int64_t b = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  if (b >= nblocks) return;
  const int64_t* d = desc + kDesc * b;
  const int h = static_cast<int>(d[2]);
  const int w = static_cast<int>(d[3]);
  if (!shape_ok(h, w) || w / 2 > max_qw) return;  // the wrapper refuses them
  const int64_t* s = streams + kStreams * b;
  uint8_t* rho_q = rho_out + d[7];
  int32_t* umax_q = umax_out + d[7];
  Reader mel, vlc;
  mel.init(scratch + s[2], static_cast<int>((s[3] + 31) >> 5));
  vlc.init(scratch + s[4], static_cast<int>((s[5] + 31) >> 5));
  const int qh = h / 2;
  const int qw = w / 2;
  int k = 0, pz = 0;
  bool pone = false;
  int mpos = 0, vpos = 0;  // each moves at most 17 bits a quad
  for (int q = 0, qy = 0; qy < qh; ++qy) {
    int upred = 1, left = 0, upleft = 0;
    for (int qx = 0; qx < qw; ++qx, ++q) {
      uint8_t* above = rows + qx * 32 + lane;
      const int up = qy ? *above : 0;
      const int ctx = (left != 0) | ((up != 0) << 1) | ((upleft != 0) << 2);
      // one MEL event (t1/ht.py MELDecoder)
      bool ev;
      if (pz == 0 && !pone) {
        const int e = static_cast<int>((kMelE >> (4 * k)) & 0xF);
        const uint32_t win = mel.peek(mpos, 1 + kMelRunWin);
        const int bit = win >> kMelRunWin;
        const int run = bit ? 0
                            : (win & ((1 << kMelRunWin) - 1)) >>
                                  (kMelRunWin - e);
        ev = !bit && run == 0;
        k = bit ? min(12, k + 1) : max(0, k - 1);
        pz = bit ? (1 << e) - 1 : max(run - 1, 0);
        pone = !bit && run > 0;
        mpos += bit ? 1 : 1 + e;
      } else {
        ev = pz == 0;
        pone = pone && pz > 0;
        pz = max(pz - 1, 0);
      }
      // the VLC quad parse through the CxtVLC decode LUT
      const int32_t win = static_cast<int32_t>(vlc.peek(vpos, kVlcWin));
      const int cw = win >> (kVlcWin - maxc);
      int rho = t_rho[(ctx << maxc) | cw];
      const int clen = t_len[(ctx << maxc) | cw];
      const int uw = sar32(win, kVlcWin - clen - 10) & 0x3FF;
      int zz, ulen;
      if (!((uw >> 9) & 1)) {
        zz = 0, ulen = 1;
      } else if (!((uw >> 8) & 1)) {
        zz = 1, ulen = 2;
      } else if (!((uw >> 7) & 1)) {
        zz = 2, ulen = 3;
      } else {
        zz = 3 + (uw & 0x7F), ulen = 10;
      }
      const int diff = (zz & 1) ? -((zz + 1) >> 1) : zz >> 1;
      const int umax = upred + diff;
      if (ev) {
        vpos += clen + ulen;
        upred = umax;
      } else {
        rho = 0;
      }
      rho_q[q] = static_cast<uint8_t>(rho);
      umax_q[q] = umax;
      *above = static_cast<uint8_t>(rho);
      left = rho;
      upleft = up;
    }
  }
}

// ----------------------------------------------------------------- MagSgn

constexpr int kMsWarps = 4;     // warps a block (a CTA)
constexpr int kMsCtas = 8;      // CTAs an SM is built for (64 registers)
constexpr int kRhoVecs = 66;    // 16-byte copies of a block's rho (1,024 B
                                // from any byte)
constexpr int kUmaxVecs = 257;  // and of its umax (4,096 B from any word)
constexpr int kMsIlp = 2;       // chunks whose windows are loaded together

// What a block's chunks share.
struct MsBlock {
  const uint32_t* ms;  // the MagSgn stream: nw words, then two zero words
  int32_t nw;          // clamped to 2^31 - 1, as no cursor reaches it
  int64_t wrap_bits;   // grok_tpu's L
  const uint8_t* rho;  // the block's rho and umax in shared memory
  const int32_t* umax;
  int nq, qw;
  int32_t qw_inv;  // q / qw = (q * qw_inv) >> 20, exact as q * qw < 2^20
};

// A chunk of 32 quads, a lane each: its quad, rho and umax, and each
// significant sample's two MagSgn words and bit cursor (the window starts at
// bit cursor & 31 of the first word).
struct Chunk {
  int q, rho, umax;
  int32_t at[4];
  uint32_t hi[4], lo[4];
};

// Chunk c's windows; every lane takes part (a warp scan and vote).
// `base`: lane c holds chunk c's first cursor.
__device__ __forceinline__ Chunk load_chunk(const MsBlock& bk, int c,
                                            int lane, int32_t base) {
  Chunk k;
  k.q = 32 * c + lane;
  const bool in = k.q < bk.nq;
  k.rho = in ? bk.rho[k.q] : 0;
  k.umax = in ? bk.umax[k.q] : 0;
  const int32_t step = k.umax + 1;
  const int32_t bits = __popc(k.rho) * step;
  int32_t incl = bits;
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  int32_t p = __shfl_sync(kFull, base, c) + incl - bits;
  // only a corrupt stream makes a cursor negative, and a chunk where one is
  // takes the exact path (JAX's dynamic_slice: moved by L, clamped to 0);
  // a quad's later cursors fall only where umax < -1, which puts both of
  // its shift counts out of range: its samples are 3 whatever they read
  if (__any_sync(kFull, k.rho && p < 0)) {
    for (int i = 0; i < 4; ++i) {
      const bool sig = (k.rho >> i) & 1;
      int32_t word = p >> 5;
      k.at[i] = p;  // L is a multiple of 32: the same bit of a word
      if (p < 0) {
        const int64_t at = p + bk.wrap_bits;
        word = at < 0 ? 0
                      : static_cast<int32_t>(min(at >> 5,
                                                 int64_t{bk.nw}));
        if (at < 0) k.at[i] = 0;
      }
      word = min(word, bk.nw);
      k.hi[i] = sig ? bk.ms[word] : 0u;
      k.lo[i] = sig ? bk.ms[word + 1] : 0u;
      p += sig ? step : 0;
    }
    return k;
  }
  for (int i = 0; i < 4; ++i) {  // TL, BL, TR, BR: every window at once
    const bool sig = (k.rho >> i) & 1;
    const uint32_t word =
        min(static_cast<uint32_t>(p) >> 5, static_cast<uint32_t>(bk.nw));
    k.at[i] = p;
    k.hi[i] = sig ? bk.ms[word] : 0u;
    k.lo[i] = sig ? bk.ms[word + 1] : 0u;
    p += sig ? step : 0;
  }
  return k;
}

// chunk k's samples, sign * (2m + 1), into the block's output; `vec`: rows
// 8-byte aligned, a row of a quad one store
__device__ __forceinline__ void store_chunk(const MsBlock& bk,
                                            const Chunk& k, int32_t* out,
                                            int64_t ostride, bool vec) {
  if (k.q >= bk.nq) return;
  // sar32 of a 31-bit window (never negative): 0 for a count outside
  // [0, 31]
  const int s1 = kMsWin - k.umax, s2 = kMsWin - k.umax - 1;
  const bool ok1 = static_cast<unsigned>(s1) <= 31u;
  const bool ok2 = static_cast<unsigned>(s2) <= 31u;
  int32_t v[4];
  for (int i = 0; i < 4; ++i) {
    const uint32_t win =
        __funnelshift_l(k.lo[i], k.hi[i], k.at[i]) >> 1;
    const uint32_t m = (ok1 ? win >> s1 : 0u) + 1u;
    const uint32_t x = 2u * m + 1u;
    const bool neg = ok2 && ((win >> s2) & 1);
    v[i] = (k.rho >> i) & 1 ? static_cast<int32_t>(neg ? 0u - x : x) : 0;
  }
  const int qy = (k.q * bk.qw_inv) >> 20;
  const int qx = k.q - qy * bk.qw;
  int32_t* top = out + 2 * qy * ostride + 2 * qx;
  if (vec) {
    *reinterpret_cast<int2*>(top) = make_int2(v[0], v[2]);
    *reinterpret_cast<int2*>(top + ostride) = make_int2(v[1], v[3]);
  } else {
    top[0] = v[0];
    top[ostride] = v[1];
    top[1] = v[2];
    top[ostride + 1] = v[3];
  }
}

__global__ void __launch_bounds__(32 * kMsWarps, kMsCtas)
    ht_magsgn_kernel(const int64_t* __restrict__ desc,
                     const int64_t* __restrict__ streams,
                     const uint32_t* __restrict__ scratch,
                     const uint8_t* __restrict__ rho_in,
                     const int32_t* __restrict__ umax_in,
                     const unsigned long long* __restrict__ longest) {
  __shared__ uint4 stage[kRhoVecs + kUmaxVecs];
  __shared__ int32_t totals[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t* d = desc + kDesc * static_cast<int64_t>(blockIdx.x);
  int32_t* out = reinterpret_cast<int32_t*>(static_cast<uintptr_t>(d[0]));
  const int64_t ostride = d[1];
  const int h = static_cast<int>(d[2]);
  const int w = static_cast<int>(d[3]);
  if (!shape_ok(h, w)) return;  // the whole CTA; the wrapper refuses them
  const int64_t* s = streams + kStreams * static_cast<int64_t>(blockIdx.x);
  // grok_tpu's L: 1 << bit_length(max(longest, 1) + 64 - 1)
  const unsigned long long most = max(*longest, 1ull);
  MsBlock bk;
  bk.ms = scratch + s[0];
  bk.nw = static_cast<int32_t>(min((s[1] + 31) >> 5, int64_t{0x7FFFFFFF}));
  bk.wrap_bits = 1ll << (64 - __clzll(most + kRefPad - 1));
  bk.qw = w / 2;
  bk.nq = (h / 2) * bk.qw;
  bk.qw_inv = (1 << 20) / bk.qw + 1;

  // the block's rho and umax into shared memory, 16 bytes a copy
  const uintptr_t ra = reinterpret_cast<uintptr_t>(rho_in + d[7]);
  const uintptr_t ua = reinterpret_cast<uintptr_t>(umax_in + d[7]);
  const int rskew = static_cast<int>(ra & 15);
  const int uskew = static_cast<int>(ua & 15);
  for (int i = threadIdx.x; i < (rskew + bk.nq + 15) >> 4; i += 32 * kMsWarps)
    __pipeline_memcpy_async(stage + i, reinterpret_cast<const void*>(
                                           (ra & ~uintptr_t{15}) + 16 * i),
                            16);
  for (int i = threadIdx.x; i < (uskew + 4 * bk.nq + 15) >> 4;
       i += 32 * kMsWarps)
    __pipeline_memcpy_async(stage + kRhoVecs + i,
                            reinterpret_cast<const void*>(
                                (ua & ~uintptr_t{15}) + 16 * i), 16);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  bk.rho = reinterpret_cast<const uint8_t*>(stage) + rskew;
  bk.umax = reinterpret_cast<const int32_t*>(
      reinterpret_cast<const uint8_t*>(stage + kRhoVecs) + uskew);

  // cursor = exclusive prefix sum of each quad's bits, popcount(rho) *
  // (umax + 1), over the raster order, 32 quads a chunk, chunk c on warp
  // c % kMsWarps: each chunk's bits into shared memory, then in every warp
  // lane c gets chunk c's first cursor
  const int nch = (bk.nq + 31) >> 5;
  for (int c = warp; c < nch; c += kMsWarps) {
    const int q = 32 * c + lane;
    const int32_t bits =
        q < bk.nq ? __popc(bk.rho[q]) * (bk.umax[q] + 1) : 0;
    const int32_t t = __reduce_add_sync(kFull, bits);
    if (lane == 0) totals[c] = t;
  }
  __syncthreads();
  const int32_t mine = lane < nch ? totals[lane] : 0;
  int32_t incl = mine;
  for (int dd = 1; dd < 32; dd <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, incl, dd);
    if (lane >= dd) incl += y;
  }
  const int32_t base = incl - mine;

  const bool vec = ((reinterpret_cast<uintptr_t>(out) & 7) | (ostride & 1))
                   == 0;
  for (int c0 = warp; c0 < nch; c0 += kMsWarps * kMsIlp) {
    Chunk k[kMsIlp];
#pragma unroll
    for (int i = 0; i < kMsIlp; ++i)
      if (c0 + kMsWarps * i < nch)
        k[i] = load_chunk(bk, c0 + kMsWarps * i, lane, base);
#pragma unroll
    for (int i = 0; i < kMsIlp; ++i)
      if (c0 + kMsWarps * i < nch) store_chunk(bk, k[i], out, ostride, vec);
  }
}

}  // namespace

// desc: (nblocks, 8) int64 (see kDesc); data: the joined segments, from a
// 16-byte aligned address and padded to whole 16-byte chunks; scratch: int32
// words, a region of seg_len / 2 + 12 words a block from its scratch_off;
// streams: (nblocks, 6) int64, written; longest: one uint64 set to 0, the
// batch's longest destuffed stream in bits on return.
extern "C" int grk_ht_destuff(const void* desc, const void* data,
                              void* scratch, void* streams, void* longest,
                              int nblocks, void* stream) {
  if (nblocks <= 0 || reinterpret_cast<uintptr_t>(data) & 15)
    return cudaErrorInvalidValue;
  ht_destuff_kernel<<<(nblocks + kDsWarps - 1) / kDsWarps, 32 * kDsWarps, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(desc), static_cast<const uint8_t*>(data),
      static_cast<uint32_t*>(scratch), static_cast<int64_t*>(streams),
      static_cast<unsigned long long*>(longest), nblocks);
  return cudaGetLastError();
}

// desc, streams, scratch: as grk_ht_destuff left them; lut_rho, lut_len: the
// (8, 2^maxc) CxtVLC decode tables; rho, umax: uint8 and int32, a quad each,
// block b's from desc[b][7]; max_qw: the launch's widest quad row.
extern "C" int grk_ht_decode(const void* desc, const void* streams,
                             const void* scratch, const void* lut_rho,
                             const void* lut_len, void* rho, void* umax,
                             int nblocks, int maxc, int max_qw,
                             void* stream) {
  if (nblocks <= 0 || maxc < 1 || maxc > kMaxCwdLen || max_qw < 1 ||
      max_qw > kMaxQw)
    return cudaErrorInvalidValue;
  ht_decode_kernel<<<(nblocks + 31) / 32, 32, 32 * max_qw,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(desc),
      static_cast<const int64_t*>(streams),
      static_cast<const uint32_t*>(scratch),
      static_cast<const uint8_t*>(lut_rho),
      static_cast<const uint8_t*>(lut_len), static_cast<uint8_t*>(rho),
      static_cast<int32_t*>(umax), nblocks, maxc, max_qw);
  return cudaGetLastError();
}

// desc, streams, scratch, longest: as grk_ht_destuff left them; rho, umax:
// as grk_ht_decode left them, from 16-byte aligned addresses, each array
// followed by 16 bytes it may read and never uses.
extern "C" int grk_ht_magsgn(const void* desc, const void* streams,
                             const void* scratch, const void* rho,
                             const void* umax, const void* longest,
                             int nblocks, void* stream) {
  if (nblocks <= 0 || (reinterpret_cast<uintptr_t>(rho) |
                       reinterpret_cast<uintptr_t>(umax)) & 15)
    return cudaErrorInvalidValue;
  ht_magsgn_kernel<<<nblocks, 32 * kMsWarps, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(desc),
      static_cast<const int64_t*>(streams),
      static_cast<const uint32_t*>(scratch),
      static_cast<const uint8_t*>(rho), static_cast<const int32_t*>(umax),
      static_cast<const unsigned long long*>(longest));
  return cudaGetLastError();
}
