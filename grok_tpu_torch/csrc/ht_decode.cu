// HT (Part 15) cleanup-pass decoder: every codeblock of a batch, mixed shapes,
// in one launch, each block written at its place in its destination tensor.
//
// Replaces grok_tpu/ops/ht_decode.py decode_cblks_ht_device
// (decode_batch_device / _decode_one: one scan over the quads carrying the
// MEL state, the VLC and MagSgn cursors and the u predictor), which runs as
// XLA code, not Pallas, on the TPU.  Its input here is the host's destuffed
// streams, packed 8 bits a byte, each followed by 8 zero bytes
// (ops/ht_decode.py prepare).
//
// What bounds it: the serial MEL/VLC chain (each quad's context needs the
// rho decoded before it), not device memory (the stream bytes in, 4 B a
// sample out).  Design: one warp (one CTA) a codeblock.  Lane 0 replays the
// MEL automaton and the VLC quad parse quad by quad in raster order and
// leaves rho and umax of every quad in shared memory.  Then the warp takes 32
// quads at a time: the MagSgn bit offset of each quad is an exclusive prefix
// sum of popcount(rho) * (umax + 1) (a warp scan with a carry), and each lane
// reads its quad's samples from a 40-bit window and writes them,
// sign * (2m + 1), into the block's place in the output.
//
// Whatever the bytes, nothing is read or written outside the block's streams
// and output: windows past a stream's end read its zero pad.  Corrupt streams
// decode exactly as grok_tpu's device decoder decodes them: an int32 right
// shift by a count outside [0, 31] fills with the sign bit (sar32), a
// negative MagSgn cursor is moved by wrap_bits and clamped to 0 (JAX's
// dynamic_slice), and sums wrap as int32.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxQuads = 1024;
constexpr int kMaxQw = 512;
constexpr int kNumCtx = 8;
constexpr int kMaxCwdLen = 7;
constexpr int kDesc = 10;  // out_ptr, out_stride, h, w, then (offset,
                           // bytes) of the MagSgn, MEL and VLC streams
constexpr int kMsWin = 31;
constexpr int kVlcWin = 17;
constexpr int kMelRunWin = 5;

__constant__ int kMelE[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};

// int32 >> s with XLA's semantics: a count outside [0, 31] fills with the
// sign bit.
__device__ __forceinline__ int32_t sar32(int32_t x, int32_t s) {
  if (static_cast<uint32_t>(s) > 31u) return x < 0 ? -1 : 0;
  return x >> s;
}

// n (1..32) bits MSB-first at bit `pos` (>= 0) of a stream of `len` bytes
// followed by at least 5 zero bytes; zeros past its end.
__device__ __forceinline__ uint32_t peek(const uint8_t* s, int64_t len,
                                         int64_t pos, int n) {
  int64_t byte = pos >> 3;
  if (byte > len) byte = len;
  const uint8_t* p = s + byte;
  const uint64_t w = (static_cast<uint64_t>(p[0]) << 32) |
                     (static_cast<uint64_t>(p[1]) << 24) |
                     (static_cast<uint64_t>(p[2]) << 16) |
                     (static_cast<uint64_t>(p[3]) << 8) | p[4];
  return static_cast<uint32_t>((w >> (40 - (pos & 7) - n)) &
                               ((1ull << n) - 1));
}

__global__ void __launch_bounds__(32)
    ht_decode_kernel(const int64_t* __restrict__ desc,
                     const uint8_t* __restrict__ pool,
                     const uint8_t* __restrict__ lut_rho,
                     const uint8_t* __restrict__ lut_len, int maxc,
                     int wrap_bits) {
  __shared__ uint8_t rho_s[kMaxQuads];
  __shared__ int32_t umax_s[kMaxQuads];
  __shared__ uint8_t t_rho[kNumCtx << kMaxCwdLen];
  __shared__ uint8_t t_len[kNumCtx << kMaxCwdLen];

  const int lane = threadIdx.x;
  const int64_t* d = desc + kDesc * static_cast<int64_t>(blockIdx.x);
  int32_t* out = reinterpret_cast<int32_t*>(static_cast<uintptr_t>(d[0]));
  const int64_t ostride = d[1];
  const int h = static_cast<int>(d[2]);
  const int w = static_cast<int>(d[3]);
  const uint8_t* ms = pool + d[4];
  const int64_t ms_len = d[5];
  const uint8_t* mel = pool + d[6];
  const int64_t mel_len = d[7];
  const uint8_t* vlc = pool + d[8];
  const int64_t vlc_len = d[9];
  if (h <= 0 || w <= 0 || h % 2 || w % 2 || w / 2 > kMaxQw ||
      (h / 2) * (w / 2) > kMaxQuads)
    return;  // the wrapper refuses such shapes
  const int qh = h / 2;
  const int qw = w / 2;
  const int nq = qh * qw;
  for (int i = lane; i < (kNumCtx << maxc); i += 32) {
    t_rho[i] = lut_rho[i];
    t_len[i] = lut_len[i];
  }
  __syncwarp();

  if (lane == 0) {  // the serial MEL + VLC chain
    int k = 0, pz = 0, upred = 1;
    bool pone = false;
    int64_t mpos = 0, vpos = 0;
    for (int q = 0, qy = 0; qy < qh; ++qy) {
      upred = 1;
      for (int qx = 0; qx < qw; ++qx, ++q) {
        const int up = qy ? rho_s[q - qw] : 0;
        const int left = qx ? rho_s[q - 1] : 0;
        const int upleft = (qx && qy) ? rho_s[q - qw - 1] : 0;
        const int ctx = (left != 0) | ((up != 0) << 1) | ((upleft != 0) << 2);
        // one MEL event (t1/ht.py MELDecoder)
        bool ev;
        if (pz == 0 && !pone) {
          const int e = kMelE[k];
          const int bit = peek(mel, mel_len, mpos, 1);
          const int run = bit ? 0
                              : peek(mel, mel_len, mpos + 1, kMelRunWin) >>
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
        const int32_t win =
            static_cast<int32_t>(peek(vlc, vlc_len, vpos, kVlcWin));
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
        rho_s[q] = static_cast<uint8_t>(rho);
        umax_s[q] = umax;
      }
    }
  }
  __syncwarp();

  // MagSgn: 32 quads at a time; cursor = exclusive prefix sum of each
  // quad's bits, popcount(rho) * (umax + 1), over the raster order
  int64_t carry = 0;
  for (int q0 = 0; q0 < nq; q0 += 32) {
    const int q = q0 + lane;
    const bool in = q < nq;
    const int rho = in ? rho_s[q] : 0;
    const int32_t umax = in ? umax_s[q] : 0;
    const int64_t step = static_cast<int64_t>(umax) + 1;
    const int64_t bits = __popc(rho) * step;
    int64_t incl = bits;
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    int64_t pos = carry + incl - bits;
    carry += __shfl_sync(kFull, incl, 31);
    if (!in) continue;
    const int qy = q / qw;
    const int qx = q - qy * qw;
    for (int i = 0; i < 4; ++i) {  // TL, BL, TR, BR
      uint32_t v = 0;
      if ((rho >> i) & 1) {
        int64_t p = pos;
        if (p < 0) p = p + wrap_bits < 0 ? 0 : p + wrap_bits;
        const int32_t win = static_cast<int32_t>(peek(ms, ms_len, p, kMsWin));
        const uint32_t m = static_cast<uint32_t>(sar32(win, kMsWin - umax)) +
                           1u;
        const int32_t sgn = sar32(win, kMsWin - umax - 1) & 1;
        v = 2u * m + 1u;
        if (sgn) v = 0u - v;
        pos += step;
      }
      out[(2 * qy + (i & 1)) * ostride + 2 * qx + (i >> 1)] =
          static_cast<int32_t>(v);
    }
  }
}

}  // namespace

// desc: (nblocks, 10) int64 (see kDesc); pool: the destuffed streams;
// lut_rho, lut_len: the (8, 2^maxc) CxtVLC decode tables; wrap_bits: the
// batch's padded stream length in bits (see ops/ht_decode.py prepare).
extern "C" int grk_ht_decode(const void* desc, const void* pool,
                             const void* lut_rho, const void* lut_len,
                             int nblocks, int maxc, int wrap_bits,
                             void* stream) {
  if (nblocks <= 0 || maxc < 1 || maxc > kMaxCwdLen || wrap_bits < 0)
    return cudaErrorInvalidValue;
  ht_decode_kernel<<<nblocks, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(desc), static_cast<const uint8_t*>(pool),
      static_cast<const uint8_t*>(lut_rho),
      static_cast<const uint8_t*>(lut_len), maxc, wrap_bits);
  return cudaGetLastError();
}
