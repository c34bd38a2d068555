// HT (Part 15) cleanup-pass encoder: every codeblock of a batch, mixed shapes,
// in one launch.
//
// Replaces grok_tpu/ops/ht_encode.py encode_cblks_ht_device (encode_batch_device
// / _encode_one: quad metadata, MEL scan, u-predictor scan, CxtVLC and MagSgn
// codes, gather packing), which runs as XLA code, not Pallas, on the TPU.
// Output per block: the three UNSTUFFED bit streams (MagSgn, MEL, VLC) in a
// byte pool with their bit counts, numbps and the exact sum of squared
// magnitudes; the host does the 0xFF stuffing and the segment assembly
// (ops/ht_encode.py assemble_segments).
//
// What bounds it: the serial MEL automaton and the bit placement, not device
// memory (4 B a coefficient in, about 1-2 B a coefficient out).  Design: one
// warp (one CTA) a codeblock.  Lanes take 32 quads of a quad row at a time, in
// raster order: each lane loads its quad's four samples (TL, BL, TR, BR),
// forms rho, umax and the CxtVLC context (left from a shuffle, up and up-left
// from the previous quad row's rho in shared memory), the u predictor is a
// warp last-nonempty scan with a carry across chunks, and each lane's VLC and
// MagSgn codes are placed by warp exclusive prefix sums of their lengths and
// OR-ed into zeroed bit buffers in shared memory (a code may straddle two
// 32-bit words).  The MEL events of a chunk come from one ballot and lane 0
// runs the 13-state MEL coder over them.  At the end lane 0 reserves the
// block's bytes in the pool with one atomicAdd and the warp copies them out.
//
// Blocks with numbps 0 emit nothing; blocks with numbps above 25 (outside the
// device range, INT32_MIN included: magnitudes are taken unsigned) are not
// coded and report their numbps, and the wrapper raises.

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
constexpr int kMsWords = (4 * kMaxQuads * kMsMaxLen + 31) / 32 + 1;
constexpr int kVlcWords = (kMaxQuads * kVlcMaxLen + 31) / 32 + 1;
constexpr int kMelWords = (kMaxQuads * kMelMaxLen + 1 + 31) / 32 + 1;
constexpr int kNumCtx = 8;
constexpr int kMeta = 8;  // ms_off, ms_bits, mel_off, mel_bits, vlc_off,
                          // vlc_bits, numbps, sumsq

__constant__ int kMelE[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};

__device__ __forceinline__ uint32_t uabs(int32_t v) {
  const uint32_t u = static_cast<uint32_t>(v);
  return v < 0 ? 0u - u : u;
}

__device__ __forceinline__ int bit_len(uint32_t m) { return 32 - __clz(m); }

// OR the low `len` (1..32) bits of `val`, MSB first, at bit `pos` of a
// buffer of big-endian 32-bit words; bits past `cap` are dropped.
template <bool kAtomic>
__device__ __forceinline__ void put_bits(uint32_t* buf, uint32_t cap,
                                         uint32_t pos, uint32_t val,
                                         int len) {
  if (len <= 0 || pos + len > cap) return;
  const uint64_t x = static_cast<uint64_t>(val) << (64 - (pos & 31) - len);
  const uint32_t hi = static_cast<uint32_t>(x >> 32);
  const uint32_t lo = static_cast<uint32_t>(x);
  uint32_t* w = buf + (pos >> 5);
  if (kAtomic) {
    atomicOr(w, hi);
    if (lo) atomicOr(w + 1, lo);
  } else {
    w[0] |= hi;
    if (lo) w[1] |= lo;
  }
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

__device__ __forceinline__ uint8_t byte_at(const uint32_t* buf, uint32_t i) {
  return static_cast<uint8_t>(buf[i >> 2] >> (24 - 8 * (i & 3)));
}

// Zero the words that bits [0, bits) of a buffer occupy.
__device__ void zero_words(uint32_t* buf, uint32_t bits) {
  for (uint32_t i = threadIdx.x; i < (bits + 31) / 32; i += 32) buf[i] = 0;
}

__global__ void __launch_bounds__(32)
    ht_encode_kernel(const int64_t* __restrict__ desc,
                     const uint8_t* __restrict__ enc_cwd,
                     const uint8_t* __restrict__ enc_len,
                     uint8_t* __restrict__ pool,
                     unsigned long long* __restrict__ pool_used,
                     int64_t* __restrict__ meta, long long pool_cap) {
  __shared__ uint32_t ms[kMsWords];
  __shared__ uint32_t vlc[kVlcWords];
  __shared__ uint32_t mel[kMelWords];
  __shared__ uint8_t rho_row[2][kMaxQw];
  __shared__ uint8_t t_cwd[kNumCtx * 16];
  __shared__ uint8_t t_len[kNumCtx * 16];

  const int lane = threadIdx.x;
  const int64_t* d = desc + 4 * static_cast<int64_t>(blockIdx.x);
  const int32_t* src =
      reinterpret_cast<const int32_t*>(static_cast<uintptr_t>(d[0]));
  const int64_t stride = d[1];
  const int h = static_cast<int>(d[2]);
  const int w = static_cast<int>(d[3]);
  int64_t* out = meta + kMeta * static_cast<int64_t>(blockIdx.x);

  // pass 1: numbps (bit length of the OR of all magnitudes) and the exact
  // sum of squares (below 2^62 for numbps <= 25)
  uint32_t any = 0;
  unsigned long long sumsq = 0;
  const bool shape_ok = h > 0 && w > 0 && h % 2 == 0 && w % 2 == 0 &&
                        w / 2 <= kMaxQw && (h / 2) * (w / 2) <= kMaxQuads;
  if (shape_ok) {
    for (int y = 0; y < h; ++y) {
      const int32_t* row = src + y * stride;
      for (int x = lane; x < w; x += 32) {
        const uint32_t m = uabs(row[x]);
        any |= m;
        sumsq += static_cast<unsigned long long>(m) * m;
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    any |= __shfl_xor_sync(kFull, any, o);
    sumsq += __shfl_xor_sync(kFull, sumsq, o);
  }
  const int numbps = shape_ok ? bit_len(any) : -1;
  if (numbps <= 0 || numbps > kMaxNumbps) {
    if (lane == 0) {
      for (int i = 0; i < 6; ++i) out[i] = 0;
      out[6] = numbps;
      out[7] = static_cast<int64_t>(sumsq);
    }
    return;
  }

  const int qh = h / 2;
  const int qw = w / 2;
  const uint32_t nq = static_cast<uint32_t>(qh) * qw;
  const uint32_t ms_cap = 4 * nq * (numbps + 1);
  const uint32_t vlc_cap = nq * kVlcMaxLen;
  const uint32_t mel_cap = nq * kMelMaxLen + 1;
  zero_words(ms, ms_cap);
  zero_words(vlc, vlc_cap);
  zero_words(mel, mel_cap);
  for (int i = lane; i < kNumCtx * 16; i += 32) {
    t_cwd[i] = enc_cwd[i];
    t_len[i] = enc_len[i];
  }
  __syncwarp();

  uint32_t ms_pos = 0, vlc_pos = 0, mel_pos = 0;
  int mel_k = 0, mel_run = 0;  // lane 0's MEL coder
  for (int qy = 0; qy < qh; ++qy) {
    uint8_t* cur = rho_row[qy & 1];
    const uint8_t* prev = rho_row[(qy + 1) & 1];
    int left_carry = 0;   // rho of the quad before this chunk
    int upred_carry = 1;  // umax of the row's last nonempty quad so far
    const int32_t* r0 = src + (2 * qy) * stride;
    const int32_t* r1 = r0 + stride;
    for (int qx0 = 0; qx0 < qw; qx0 += 32) {
      const int qx = qx0 + lane;
      const bool in = qx < qw;
      uint32_t m[4] = {0, 0, 0, 0};
      uint32_t sgn[4] = {0, 0, 0, 0};
      int rho = 0, umax = 0;
      if (in) {
        const int32_t v[4] = {r0[2 * qx], r1[2 * qx], r0[2 * qx + 1],
                              r1[2 * qx + 1]};  // TL, BL, TR, BR
        for (int i = 0; i < 4; ++i) {
          m[i] = uabs(v[i]);
          sgn[i] = v[i] < 0;
          if (m[i]) rho |= 1 << i;
          umax = max(umax, bit_len(m[i]));
        }
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
        put_bits<true>(vlc, vlc_cap, vlc_pos + vex, vval, vlen);
        uint32_t p = ms_pos + mex;
        for (int i = 0; i < 4; ++i) {
          if (rho & (1 << i)) {
            put_bits<true>(ms, ms_cap, p, ((m[i] - 1) << 1) | sgn[i],
                           umax + 1);
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
          const int e = kMelE[mel_k];
          if ((ball >> i) & 1) {
            // '0' then the run in E[k] bits
            put_bits<false>(mel, mel_cap, mel_pos, mel_run, e + 1);
            mel_pos += e + 1;
            mel_run = 0;
            mel_k = max(0, mel_k - 1);
          } else if (++mel_run == (1 << e)) {
            put_bits<false>(mel, mel_cap, mel_pos, 1, 1);
            mel_pos += 1;
            mel_run = 0;
            mel_k = min(12, mel_k + 1);
          }
        }
      }
      left_carry = __shfl_sync(kFull, rho, 31);
      if (ball) upred_carry = __shfl_sync(kFull, umax, 31 - __clz(ball));
      __syncwarp();
    }
  }
  if (lane == 0 && mel_run) {  // flush: close the pending run
    put_bits<false>(mel, mel_cap, mel_pos, 1, 1);
    mel_pos += 1;
  }
  mel_pos = __shfl_sync(kFull, mel_pos, 0);
  __syncwarp();

  const uint32_t ms_bytes = (ms_pos + 7) / 8;
  const uint32_t mel_bytes = (mel_pos + 7) / 8;
  const uint32_t vlc_bytes = (vlc_pos + 7) / 8;
  const unsigned long long total = ms_bytes + mel_bytes + vlc_bytes;
  unsigned long long base = 0;
  if (lane == 0) base = atomicAdd(pool_used, total);
  base = __shfl_sync(kFull, base, 0);
  if (base + total > static_cast<unsigned long long>(pool_cap)) {
    if (lane == 0) out[6] = -1;  // the wrapper sized the pool too small
    return;
  }
  uint8_t* dst = pool + base;
  for (uint32_t i = lane; i < ms_bytes; i += 32) dst[i] = byte_at(ms, i);
  dst += ms_bytes;
  for (uint32_t i = lane; i < mel_bytes; i += 32) dst[i] = byte_at(mel, i);
  dst += mel_bytes;
  for (uint32_t i = lane; i < vlc_bytes; i += 32) dst[i] = byte_at(vlc, i);
  if (lane == 0) {
    out[0] = static_cast<int64_t>(base);
    out[1] = ms_pos;
    out[2] = static_cast<int64_t>(base + ms_bytes);
    out[3] = mel_pos;
    out[4] = static_cast<int64_t>(base + ms_bytes + mel_bytes);
    out[5] = vlc_pos;
    out[6] = numbps;
    out[7] = static_cast<int64_t>(sumsq);
  }
}

}  // namespace

// desc: (nblocks, 4) int64 per block: address of its top-left sample, row
// stride in samples, h, w (even; h * w <= 4096, w <= 1024).  enc_cwd and
// enc_len: the (8, 16) CxtVLC tables.  pool: pool_cap bytes; pool_used: one
// uint64 set to 0 (bytes used on return); meta: (nblocks, 8) int64.
extern "C" int grk_ht_encode(const void* desc, const void* enc_cwd,
                             const void* enc_len, void* pool, void* pool_used,
                             void* meta, int nblocks, int pool_cap,
                             void* stream) {
  if (nblocks <= 0 || pool_cap < 0) return cudaErrorInvalidValue;
  ht_encode_kernel<<<nblocks, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(desc), static_cast<const uint8_t*>(enc_cwd),
      static_cast<const uint8_t*>(enc_len), static_cast<uint8_t*>(pool),
      static_cast<unsigned long long*>(pool_used),
      static_cast<int64_t*>(meta), pool_cap);
  return cudaGetLastError();
}
