// HT (Part 15) cleanup-pass encoder: every codeblock of a batch, mixed shapes,
// in one launch, each block's finished segment written into one pool.
//
// Replaces grok_tpu/ops/ht_encode.py encode_cblks_ht_device (encode_batch_device
// / _encode_one: quad metadata, MEL scan, u-predictor scan, CxtVLC and MagSgn
// codes, gather packing), which runs as XLA code, not Pallas, on the TPU, and
// the host half around it (0xFF stuffing of the three streams, VLC reversal,
// Scup, segment assembly).  Output per block: its segment, contiguous in the
// pool (MagSgn stuffed, MEL stuffed, VLC stuffed and byte-reversed, the two
// Scup bytes), and (segment offset, length, numbps, exact sum of squared
// magnitudes, status).  The host copies the used part of the pool once and
// slices it.
//
// What bounds it: latency, not device memory (4 B a coefficient in, about
// 1-2 B a coefficient out).  Each block is a chain of dependent steps on one
// warp: quad rows in order, lane 0's MEL coder, then the stuffing scans; an
// SM runs as many chains at once as their shared memory allows.  So the
// design keeps each chain short and its footprint small:
// - one warp (one CTA) a codeblock.  Lanes take 32 quads of a quad row at a
//   time, in raster order; numbps and the sum of squares are accumulated in
//   that loop (no first pass), and the next chunk's four samples a lane are
//   loaded before the current chunk is coded, so the loads overlap the work;
// - each lane forms rho, umax and the CxtVLC context (left from a shuffle,
//   up and up-left from the previous quad row's rho in shared memory); the
//   u predictor is a warp last-nonempty scan with a carry across chunks;
//   each lane's VLC and MagSgn codes are placed by warp exclusive prefix
//   sums of their lengths and OR-ed into zeroed bit buffers in shared memory
//   (a code may straddle two words; neighbouring lanes may share one);
// - the MEL events of a chunk come from one ballot; lane 0 codes them with
//   the exponent table in a register and a 64-bit accumulator that stores
//   whole words, so the MEL buffer needs no zeroing;
// - shared memory is dynamic, sized by the launch's largest block (quads
//   and quad-row width), not the largest possible one;
// - stuffing: the warp scans each stream 32 output bytes a round.  Lane i
//   forms the byte at its assumed offset (8 bits apart, the first 7 bits
//   wide after a 0xFF, which can then never be 0xFF itself), a ballot finds
//   the first 0xFF, every byte up to it is final, and the next round starts
//   after it.  A first scan of the three streams counts the stuffed bytes,
//   so lane 0 reserves exactly the segment with one atomicAdd; a second
//   scan writes the bytes straight to the pool, 32 consecutive bytes a
//   round, the VLC stream from the end of its place backwards.
//
// Blocks with numbps 0 emit nothing; blocks with numbps above 25 (outside the
// device range, INT32_MIN included: magnitudes are taken unsigned) are not
// placed and report their numbps, and the wrapper raises.  A suffix longer
// than scup_max, or a pool too small for a segment, is reported in the
// block's status and not written; the wrapper raises on either.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxQuads = 1024;  // 4096 samples, the largest codeblock
constexpr int kMaxQw = 512;      // 1024 columns, the widest codeblock
constexpr int kMaxNumbps = 25;
constexpr int kMsMaxLen = kMaxNumbps + 1;
constexpr int kVlcMaxLen = 7 + 10;
constexpr int kMelMaxLen = 6;
constexpr int kNumCtx = 8;
constexpr int kMeta = 5;  // seg_off, seg_len, numbps, sumsq, status
constexpr int kStatusScup = 1;
constexpr int kStatusPool = 2;
// MEL exponent E[k] for k = 0..12, a nibble each: 0,0,0,1,1,1,2,2,2,3,3,4,5
constexpr uint64_t kMelE = 0x5433222111000ull;

// One warp's shared memory, in 32-bit words: the three bit buffers (each
// with two zero words past its longest stream) and two rows of rho bytes.
struct Layout {
  int vlc, mel, rho, words;
};

Layout layout(int max_quads, int max_qw) {
  Layout l;
  l.vlc = (4 * max_quads * kMsMaxLen + 31) / 32 + 2;
  l.mel = l.vlc + (max_quads * kVlcMaxLen + 31) / 32 + 2;
  l.rho = l.mel + (max_quads * kMelMaxLen + 1 + 31) / 32 + 2;
  l.words = l.rho + (2 * max_qw + 3) / 4;
  return l;
}

__device__ __forceinline__ uint32_t uabs(int32_t v) {
  const uint32_t u = static_cast<uint32_t>(v);
  return v < 0 ? 0u - u : u;
}

__device__ __forceinline__ int bit_len(uint32_t m) { return 32 - __clz(m); }

// OR the low `len` (1..32) bits of `val`, MSB first, at bit `pos` of a
// buffer of big-endian 32-bit words; bits past `cap` are dropped.
__device__ __forceinline__ void put_bits(uint32_t* buf, uint32_t cap,
                                         uint32_t pos, uint32_t val,
                                         int len) {
  if (len <= 0 || pos + len > cap) return;
  const uint64_t x = static_cast<uint64_t>(val) << (64 - (pos & 31) - len);
  uint32_t* w = buf + (pos >> 5);
  atomicOr(w, static_cast<uint32_t>(x >> 32));
  if (static_cast<uint32_t>(x)) atomicOr(w + 1, static_cast<uint32_t>(x));
}

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

// Zero words [0, n) of a buffer.
__device__ void zero_words(uint32_t* buf, int n) {
  for (int i = threadIdx.x; i < n; i += 32) buf[i] = 0;
}

// The 8 bits at bit `pos` of a buffer of big-endian words.
__device__ __forceinline__ uint32_t bits8(const uint32_t* buf, uint32_t pos) {
  const uint32_t* w = buf + (pos >> 5);
  const uint64_t x = (static_cast<uint64_t>(w[0]) << 32) | w[1];
  return static_cast<uint32_t>(x >> (56 - (pos & 31))) & 0xFFu;
}

// 0xFF stuffing of the first `nbits` bits of `buf` (zero past them, for at
// least two words): 8 bits a byte, 7 after a 0xFF byte, the last byte
// zero-padded, a 0x00 guard after a trailing 0xFF, nothing for 0 bits.
// Returns the stuffed length; with `dst`, also writes the bytes there, or
// with `reverse` the i-th at dst[len - 1 - i] (len from a counting call).
__device__ uint32_t stuff(const uint32_t* buf, uint32_t nbits, uint8_t* dst,
                          bool reverse, uint32_t len) {
  const int lane = threadIdx.x;
  uint32_t pos = 0, n = 0;
  bool seven = false;  // this round's first byte follows a 0xFF
  while (pos < nbits) {
    const uint32_t p = pos + 8 * lane - (seven && lane ? 1 : 0);
    const bool in = p < nbits;
    uint32_t b = in ? bits8(buf, p) : 0;
    if (seven && lane == 0) b >>= 1;
    const unsigned ff = __ballot_sync(kFull, in && b == 0xFF);
    const unsigned valid = __ballot_sync(kFull, in);
    const int last = ff ? __ffs(ff) - 1 : 31 - __clz(valid);
    if (dst && lane <= last)
      dst[reverse ? len - 1 - (n + lane) : n + lane] = static_cast<uint8_t>(b);
    n += last + 1;
    pos += 8 * (last + 1) - (seven ? 1 : 0);
    seven = ff != 0;
  }
  if (seven) {  // the stream ended on a 0xFF byte
    if (dst && lane == 0) dst[reverse ? len - 1 - n : n] = 0;
    ++n;
  }
  return n;
}

__global__ void __launch_bounds__(32)
    ht_encode_kernel(const int64_t* __restrict__ desc,
                     const uint8_t* __restrict__ enc_cwd,
                     const uint8_t* __restrict__ enc_len,
                     uint8_t* __restrict__ pool,
                     unsigned long long* __restrict__ pool_used,
                     int64_t* __restrict__ meta, long long pool_cap,
                     Layout lay, int max_quads, int max_qw, int scup_max) {
  extern __shared__ uint32_t smem[];
  __shared__ uint8_t t_cwd[kNumCtx * 16];
  __shared__ uint8_t t_len[kNumCtx * 16];
  uint32_t* ms = smem;
  uint32_t* vlc = smem + lay.vlc;
  uint32_t* mel = smem + lay.mel;
  uint8_t* rho_rows = reinterpret_cast<uint8_t*>(smem + lay.rho);

  const int lane = threadIdx.x;
  const int64_t* d = desc + 4 * static_cast<int64_t>(blockIdx.x);
  const int32_t* src =
      reinterpret_cast<const int32_t*>(static_cast<uintptr_t>(d[0]));
  const int64_t stride = d[1];
  const int h = static_cast<int>(d[2]);
  const int w = static_cast<int>(d[3]);
  int64_t* out = meta + kMeta * static_cast<int64_t>(blockIdx.x);
  const int qh = h / 2;
  const int qw = w / 2;
  const int nq = qh * qw;
  if (h <= 0 || w <= 0 || h % 2 || w % 2 || qw > max_qw || nq > max_quads) {
    if (lane == 0) {  // the wrapper refuses such shapes
      out[0] = out[1] = out[3] = 0;
      out[2] = -1;
      out[4] = 0;
    }
    return;
  }

  const uint32_t ms_cap = 4u * nq * kMsMaxLen;
  const uint32_t vlc_cap = static_cast<uint32_t>(nq) * kVlcMaxLen;
  zero_words(ms, (ms_cap + 31) / 32 + 2);
  zero_words(vlc, (vlc_cap + 31) / 32 + 2);
  for (int i = lane; i < kNumCtx * 16; i += 32) {
    t_cwd[i] = enc_cwd[i];
    t_len[i] = enc_len[i];
  }

  // chunk c: quad row c / per_row, quads (c % per_row) * 32 + lane
  const int per_row = (qw + 31) / 32;
  const int chunks = qh * per_row;
  auto load = [&](int c, int32_t* v) {
    const int qy = c / per_row;
    const int qx = (c - qy * per_row) * 32 + lane;
    if (qx < qw) {
      const int32_t* r0 = src + (2 * qy) * stride + 2 * qx;
      v[0] = r0[0];       // TL
      v[1] = r0[stride];  // BL
      v[2] = r0[1];       // TR
      v[3] = r0[stride + 1];
    } else {
      v[0] = v[1] = v[2] = v[3] = 0;
    }
  };
  int32_t next[4];
  load(0, next);
  __syncwarp();

  uint32_t any = 0;
  unsigned long long sumsq = 0;
  uint32_t ms_pos = 0, vlc_pos = 0;
  int mel_k = 0, mel_run = 0;  // lane 0's MEL coder
  uint64_t mel_acc = 0;        // its pending bits, the last mel_n of them
  int mel_n = 0, mel_words = 0;
  int left_carry = 0, upred_carry = 1;
  for (int c = 0; c < chunks; ++c) {
    const int32_t v[4] = {next[0], next[1], next[2], next[3]};
    if (c + 1 < chunks) load(c + 1, next);
    const int qy = c / per_row;
    const int qx0 = (c - qy * per_row) * 32;
    const int qx = qx0 + lane;
    const bool in = qx < qw;
    if (qx0 == 0) left_carry = 0, upred_carry = 1;  // a new quad row
    uint8_t* cur = rho_rows + (qy & 1) * max_qw;
    const uint8_t* prev = rho_rows + ((qy + 1) & 1) * max_qw;

    uint32_t m[4], sgn[4];
    int rho = 0, umax = 0;
    for (int i = 0; i < 4; ++i) {
      m[i] = uabs(v[i]);
      sgn[i] = v[i] < 0;
      any |= m[i];
      sumsq += static_cast<unsigned long long>(m[i]) * m[i];
      if (m[i]) rho |= 1 << i;
      umax = max(umax, bit_len(m[i]));
    }
    int left = __shfl_up_sync(kFull, rho, 1);
    if (lane == 0) left = left_carry;
    const int up = (in && qy > 0) ? prev[qx] : 0;
    const int upleft = (in && qy > 0 && qx > 0) ? prev[qx - 1] : 0;
    const int ctx = (left != 0) | ((up != 0) << 1) | ((upleft != 0) << 2);
    const bool ne = in && rho != 0;
    const uint32_t ball = __ballot_sync(kFull, ne);
    // u predictor: umax of the nearest nonempty quad to the left
    const uint32_t below = ball & ((1u << lane) - 1);
    const int from = __shfl_sync(kFull, umax, below ? 31 - __clz(below) : 0);
    const int upred = below ? from : upred_carry;

    uint32_t vval = 0;
    int vlen = 0;
    if (ne) {
      const int diff = umax - upred;
      const int zz = diff >= 0 ? diff << 1 : ((-diff) << 1) - 1;
      uint32_t ucode;
      int ulen;
      if (zz == 0) {
        ucode = 0, ulen = 1;
      } else if (zz == 1) {
        ucode = 0x2, ulen = 2;
      } else if (zz == 2) {
        ucode = 0x6, ulen = 3;
      } else {
        ucode = (0x7u << 7) | static_cast<uint32_t>(zz - 3), ulen = 10;
      }
      const int t = ctx * 16 + rho;
      vval = (static_cast<uint32_t>(t_cwd[t]) << ulen) | ucode;
      vlen = t_len[t] + ulen;
    }
    const uint32_t mbits = ne ? __popc(rho) * (umax + 1) : 0;
    uint32_t vtotal, mtotal;
    const uint32_t vex = warp_exclusive(vlen, &vtotal);
    const uint32_t mex = warp_exclusive(mbits, &mtotal);
    if (ne) {
      put_bits(vlc, vlc_cap, vlc_pos + vex, vval, vlen);
      uint32_t p = ms_pos + mex;
      for (int i = 0; i < 4; ++i) {
        if (rho & (1 << i)) {
          put_bits(ms, ms_cap, p, ((m[i] - 1) << 1) | sgn[i], umax + 1);
          p += umax + 1;
        }
      }
    }
    vlc_pos += vtotal;
    ms_pos += mtotal;
    if (in) cur[qx] = static_cast<uint8_t>(rho);
    if (lane == 0) {  // the MEL coder over this chunk's events, in order
      const int n = min(32, qw - qx0);
      for (int i = 0; i < n; ++i) {
        const int e = static_cast<int>((kMelE >> (4 * mel_k)) & 0xF);
        if ((ball >> i) & 1) {
          // '0' then the run in E[k] bits
          mel_acc = (mel_acc << (e + 1)) | static_cast<uint32_t>(mel_run);
          mel_n += e + 1;
          mel_run = 0;
          mel_k = max(0, mel_k - 1);
        } else if (++mel_run == (1 << e)) {
          mel_acc = (mel_acc << 1) | 1u;
          mel_n += 1;
          mel_run = 0;
          mel_k = min(12, mel_k + 1);
        }
        if (mel_n >= 32) {
          mel[mel_words++] = static_cast<uint32_t>(mel_acc >> (mel_n - 32));
          mel_n -= 32;
        }
      }
    }
    left_carry = __shfl_sync(kFull, rho, 31);
    if (ball) upred_carry = __shfl_sync(kFull, umax, 31 - __clz(ball));
    __syncwarp();
  }
  if (lane == 0) {
    if (mel_run) {  // flush: close the pending run
      mel_acc = (mel_acc << 1) | 1u;
      mel_n += 1;
      if (mel_n >= 32) {
        mel[mel_words++] = static_cast<uint32_t>(mel_acc >> (mel_n - 32));
        mel_n -= 32;
      }
    }
    mel[mel_words] =
        mel_n ? static_cast<uint32_t>(mel_acc << (32 - mel_n)) : 0u;
    mel[mel_words + 1] = 0;  // the word a scan reads past the last bit
  }
  const uint32_t mel_pos =
      static_cast<uint32_t>(__shfl_sync(kFull, mel_words * 32 + mel_n, 0));
  for (int o = 16; o > 0; o >>= 1) {
    any |= __shfl_xor_sync(kFull, any, o);
    sumsq += __shfl_xor_sync(kFull, sumsq, o);
  }
  __syncwarp();

  const int numbps = bit_len(any);
  int64_t seg_off = 0, seg_len = 0;
  int status = 0;
  if (numbps > 0 && numbps <= kMaxNumbps) {
    const uint32_t ms_len = stuff(ms, ms_pos, nullptr, false, 0);
    const uint32_t mel_len = stuff(mel, mel_pos, nullptr, false, 0);
    const uint32_t vlc_len = stuff(vlc, vlc_pos, nullptr, false, 0);
    const uint32_t scup = mel_len + vlc_len + 2;
    seg_len = ms_len + scup;
    if (scup > static_cast<uint32_t>(scup_max)) {
      status = kStatusScup;
    } else {
      unsigned long long base = 0;
      if (lane == 0)
        base = atomicAdd(pool_used, static_cast<unsigned long long>(seg_len));
      base = __shfl_sync(kFull, base, 0);
      if (base + seg_len > static_cast<unsigned long long>(pool_cap)) {
        status = kStatusPool;
      } else {
        uint8_t* dst = pool + base;
        stuff(ms, ms_pos, dst, false, ms_len);
        stuff(mel, mel_pos, dst + ms_len, false, mel_len);
        stuff(vlc, vlc_pos, dst + ms_len + mel_len, true, vlc_len);
        if (lane == 0) {
          dst[seg_len - 2] = static_cast<uint8_t>(scup & 0x0F);
          dst[seg_len - 1] = static_cast<uint8_t>((scup >> 4) & 0xFF);
        }
        seg_off = static_cast<int64_t>(base);
      }
    }
    if (status) seg_len = 0;
  }
  if (lane == 0) {
    out[0] = seg_off;
    out[1] = seg_len;
    out[2] = numbps;
    out[3] = static_cast<int64_t>(sumsq);
    out[4] = status;
  }
}

}  // namespace

// desc: (nblocks, 4) int64 per block: address of its top-left sample, row
// stride in samples, h, w (even; h * w <= 4096, w <= 1024).  enc_cwd and
// enc_len: the (8, 16) CxtVLC tables.  pool: pool_cap bytes; pool_used: one
// uint64 set to 0 (bytes reserved on return); meta: (nblocks, 5) int64.
// max_quads, max_qw: the largest (h/2)*(w/2) and w/2 of the launch, which
// size the dynamic shared memory.  scup_max: the largest Scup allowed.
extern "C" int grk_ht_encode(const void* desc, const void* enc_cwd,
                             const void* enc_len, void* pool, void* pool_used,
                             void* meta, int nblocks, long long pool_cap,
                             int max_quads, int max_qw, int scup_max,
                             void* stream) {
  if (nblocks <= 0 || pool_cap < 0 || max_quads <= 0 ||
      max_quads > kMaxQuads || max_qw <= 0 || max_qw > kMaxQw)
    return cudaErrorInvalidValue;
  const Layout lay = layout(max_quads, max_qw);
  const size_t smem = 4 * static_cast<size_t>(lay.words);
  ht_encode_kernel<<<nblocks, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(desc), static_cast<const uint8_t*>(enc_cwd),
      static_cast<const uint8_t*>(enc_len), static_cast<uint8_t*>(pool),
      static_cast<unsigned long long*>(pool_used),
      static_cast<int64_t*>(meta), pool_cap, lay, max_quads, max_qw,
      scup_max);
  return cudaGetLastError();
}
