// HT (Part 15) cleanup-pass decoder: every codeblock of a batch, mixed shapes,
// in three launches, each block written at its place in its destination
// tensor.
//
// Replaces grok_tpu/ops/ht_decode.py decode_cblks_ht_device (decode_batch_device
// / _decode_one: one scan over the quads carrying the MEL state, the VLC and
// MagSgn cursors and the u predictor), which runs as XLA code, not Pallas, on
// the TPU, and the host half around it (Scup parsing and 0xFF destuffing of
// the three streams, `_destuff`).  Its input is the segments as Tier-2 hands
// them over, joined into one byte buffer by the host, with a descriptor a
// block.
//
// grk_ht_destuff, one warp a block: parses Scup (a segment with fewer than 2
// bytes, a Scup below 2 or above its length has three empty streams),
// destuffs the MagSgn prefix, the MEL suffix read forward and the VLC suffix
// read backward into the block's scratch as big-endian 32-bit words, each
// stream followed by two zero words, and records the batch's longest
// destuffed stream with atomicMax.  Lanes take 32 bytes at a time (the next
// 32 loaded before this round is placed): a byte after a 0xFF gives its low
// 7 bits, the others 8; a warp prefix sum of the widths places each byte's
// bits, which are OR-ed into a 10-word staging buffer in shared memory; the
// complete words go out, coalesced, and the partial one is carried.
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
// grk_ht_magsgn, one warp a block: reads rho and umax back, 32 quads at a
// time; the MagSgn bit offset of each quad is an exclusive prefix sum of
// popcount(rho) * (umax + 1) (a warp scan with a carry); each lane loads the
// windows of its quad's four samples at once (two words each from the
// scratch) and writes the samples, sign * (2m + 1), into the block's place in
// the output.  It derives grok_tpu's padded length L from the batch's longest
// stream in device memory: no host round trip between the launches.
//
// Whatever the bytes, nothing is read or written outside the block's segment,
// scratch regions and output: windows past a stream's end read its zero
// words.  Corrupt streams decode exactly as grok_tpu's device decoder decodes
// them: an int32 right shift by a count outside [0, 31] fills with the sign
// bit (sar32), a negative MagSgn cursor is moved by L and clamped to 0 (JAX's
// dynamic_slice), and sums wrap as int32.

#include <cstdint>

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

// Exclusive prefix sum over the warp; *total gets the warp's sum.
__device__ __forceinline__ uint32_t warp_exclusive(uint32_t v,
                                                   uint32_t* total) {
  const int lane = threadIdx.x;
  uint32_t x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  *total = __shfl_sync(kFull, x, 31);
  return x - v;
}

// Destuff `n` bytes from `first`, walking by `step`, into big-endian words
// at `out`, then two zero words; returns the bit count.  `stage`: 10 words
// of this warp's shared memory.
__device__ uint32_t destuff(const uint8_t* first, int64_t n, int step,
                           uint32_t* out, uint32_t* stage) {
  const int lane = threadIdx.x;
  uint32_t carry = 0;       // the partial word, its first `held` bits
  uint32_t held = 0;
  uint32_t words = 0;
  uint32_t prev = 0;        // the byte before this round's first
  uint32_t next = lane < n ? first[step * lane] : 0;
  for (int64_t i0 = 0; i0 < n; i0 += 32) {
    const int64_t i = i0 + lane;
    const bool in = i < n;
    const uint32_t b = next;
    if (i + 32 < n) next = first[step * (i + 32)];
    uint32_t before = __shfl_up_sync(kFull, b, 1);
    if (lane == 0) before = prev;
    const bool after_ff = in && i > 0 && before == 0xFF;
    const uint32_t width = in ? (after_ff ? 7 : 8) : 0;
    uint32_t total;
    const uint32_t at = held + warp_exclusive(width, &total);
    if (lane < 10) stage[lane] = lane ? 0 : carry;
    __syncwarp();
    if (width) {
      const uint32_t val = after_ff ? (b & 0x7F) : b;
      const uint64_t x = static_cast<uint64_t>(val)
                         << (64 - (at & 31) - width);
      atomicOr(stage + (at >> 5), static_cast<uint32_t>(x >> 32));
      if (static_cast<uint32_t>(x))
        atomicOr(stage + (at >> 5) + 1, static_cast<uint32_t>(x));
    }
    __syncwarp();
    const uint32_t bits = held + total;
    const uint32_t full = bits >> 5;
    if (lane < static_cast<int>(full)) out[words + lane] = stage[lane];
    carry = stage[full];
    held = bits & 31;
    words += full;
    prev = __shfl_sync(kFull, b, 31);
    __syncwarp();
  }
  if (lane == 0 && held) out[words] = carry;
  const uint32_t data = words + (held ? 1 : 0);
  if (lane < 2) out[data + lane] = 0;
  return 32 * words + held;
}

__global__ void __launch_bounds__(32)
    ht_destuff_kernel(const int64_t* __restrict__ desc,
                      const uint8_t* __restrict__ data,
                      uint32_t* __restrict__ scratch,
                      int64_t* __restrict__ streams,
                      unsigned long long* __restrict__ longest) {
  __shared__ uint32_t stage[10];
  const int lane = threadIdx.x;
  const int64_t* d = desc + kDesc * static_cast<int64_t>(blockIdx.x);
  const uint8_t* seg = data + d[4];
  const int64_t len = d[5];
  int64_t scup = 0;
  if (len >= 2) scup = (static_cast<int64_t>(seg[len - 1]) << 4) |
                       (seg[len - 2] & 0x0F);
  const bool ok = len >= 2 && scup >= 2 && scup <= len;
  const int64_t n[3] = {ok ? len - scup : 0, ok ? scup - 2 : 0,
                        ok ? scup - 2 : 0};
  const uint8_t* first[3] = {seg, seg + len - scup, seg + len - 3};
  const int step[3] = {1, 1, -1};
  int64_t* s = streams + kStreams * static_cast<int64_t>(blockIdx.x);
  int64_t off = d[6];
  uint32_t most = 0;
  for (int k = 0; k < 3; ++k) {
    const uint32_t bits = destuff(first[k], n[k], step[k], scratch + off,
                                  stage);
    if (lane == 0) {
      s[2 * k] = off;
      s[2 * k + 1] = bits;
    }
    most = max(most, bits);
    off += (n[k] + 3) / 4 + 2;  // 8 bits a byte at most, two zero words
  }
  if (lane == 0) atomicMax(longest, static_cast<unsigned long long>(most));
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

// n (1..32) bits MSB-first at bit `pos` (>= 0) of a stream of `nw` words
// followed by two zero words, from its two words; zeros past its end.
__device__ __forceinline__ uint32_t window(uint32_t hi, uint32_t lo,
                                           int64_t pos, int n) {
  const uint64_t w = (static_cast<uint64_t>(hi) << 32) | lo;
  return static_cast<uint32_t>((w >> (64 - (pos & 31) - n)) &
                               ((1ull << n) - 1));
}

__global__ void __launch_bounds__(32)
    ht_magsgn_kernel(const int64_t* __restrict__ desc,
                     const int64_t* __restrict__ streams,
                     const uint32_t* __restrict__ scratch,
                     const uint8_t* __restrict__ rho_in,
                     const int32_t* __restrict__ umax_in,
                     const unsigned long long* __restrict__ longest) {
  const int lane = threadIdx.x;
  const int64_t* d = desc + kDesc * static_cast<int64_t>(blockIdx.x);
  int32_t* out = reinterpret_cast<int32_t*>(static_cast<uintptr_t>(d[0]));
  const int64_t ostride = d[1];
  const int h = static_cast<int>(d[2]);
  const int w = static_cast<int>(d[3]);
  if (!shape_ok(h, w)) return;  // the wrapper refuses such shapes
  const int64_t* s = streams + kStreams * static_cast<int64_t>(blockIdx.x);
  const uint32_t* ms = scratch + s[0];
  const int64_t ms_nw = (s[1] + 31) >> 5;
  const uint8_t* rho_q = rho_in + d[7];
  const int32_t* umax_q = umax_in + d[7];
  // grok_tpu's L: 1 << bit_length(max(longest, 1) + 64 - 1)
  const unsigned long long most = max(*longest, 1ull);
  const int64_t wrap_bits = 1ll << (64 - __clzll(most + kRefPad - 1));
  const int qw = w / 2;
  const int nq = (h / 2) * qw;

  // cursor = exclusive prefix sum of each quad's bits, popcount(rho) *
  // (umax + 1), over the raster order
  int64_t carry = 0;
  for (int q0 = 0; q0 < nq; q0 += 32) {
    const int q = q0 + lane;
    const bool in = q < nq;
    const int rho = in ? rho_q[q] : 0;
    const int32_t umax = in ? umax_q[q] : 0;
    const int64_t step = static_cast<int64_t>(umax) + 1;
    const int64_t bits = __popc(rho) * step;
    int64_t incl = bits;
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int64_t pos = carry + incl - bits;
    carry += __shfl_sync(kFull, incl, 31);
    if (!in) continue;
    int64_t at[4];
    uint32_t hi[4], lo[4];
    int before = 0;
    for (int i = 0; i < 4; ++i) {  // TL, BL, TR, BR: every window at once
      int64_t p = pos + before * step;
      if (p < 0) p = p + wrap_bits < 0 ? 0 : p + wrap_bits;
      at[i] = p;
      int64_t word = p >> 5;
      if (word > ms_nw) word = ms_nw;
      hi[i] = (rho >> i) & 1 ? ms[word] : 0;
      lo[i] = (rho >> i) & 1 ? ms[word + 1] : 0;
      before += (rho >> i) & 1;
    }
    const int qy = q / qw;
    const int qx = q - qy * qw;
    for (int i = 0; i < 4; ++i) {
      uint32_t v = 0;
      if ((rho >> i) & 1) {
        const int32_t win =
            static_cast<int32_t>(window(hi[i], lo[i], at[i], kMsWin));
        const uint32_t m = static_cast<uint32_t>(sar32(win, kMsWin - umax)) +
                           1u;
        const int32_t sgn = sar32(win, kMsWin - umax - 1) & 1;
        v = 2u * m + 1u;
        if (sgn) v = 0u - v;
      }
      out[(2 * qy + (i & 1)) * ostride + 2 * qx + (i >> 1)] =
          static_cast<int32_t>(v);
    }
  }
}

}  // namespace

// desc: (nblocks, 8) int64 (see kDesc); data: the joined segments; scratch:
// int32 words, a region of seg_len / 2 + 12 words a block from its
// scratch_off; streams: (nblocks, 6) int64, written; longest: one uint64 set
// to 0, the batch's longest destuffed stream in bits on return.
extern "C" int grk_ht_destuff(const void* desc, const void* data,
                              void* scratch, void* streams, void* longest,
                              int nblocks, void* stream) {
  if (nblocks <= 0) return cudaErrorInvalidValue;
  ht_destuff_kernel<<<nblocks, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(desc), static_cast<const uint8_t*>(data),
      static_cast<uint32_t*>(scratch), static_cast<int64_t*>(streams),
      static_cast<unsigned long long*>(longest));
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
// as grk_ht_decode left them.
extern "C" int grk_ht_magsgn(const void* desc, const void* streams,
                             const void* scratch, const void* rho,
                             const void* umax, const void* longest,
                             int nblocks, void* stream) {
  if (nblocks <= 0) return cudaErrorInvalidValue;
  ht_magsgn_kernel<<<nblocks, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(desc),
      static_cast<const int64_t*>(streams),
      static_cast<const uint32_t*>(scratch),
      static_cast<const uint8_t*>(rho), static_cast<const int32_t*>(umax),
      static_cast<const unsigned long long*>(longest));
  return cudaGetLastError();
}
