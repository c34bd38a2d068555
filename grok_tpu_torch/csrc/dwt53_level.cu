// One level of the reversible 5/3 DWT of a stack of int32 planes, both axes
// in one launch.
//
// Replaces the TPU kernels in grok_tpu/ops/pallas_dwt.py, fused with the
// horizontal pass that grok_tpu runs outside Pallas:
//   fwd_53_vertical (:78, body _v53_fwd_kernel)  ->  grk_fwd53_level
//   inv_53_vertical (:105, body _v53_inv_kernel) ->  grk_inv53_level
//
// What bounds it: device-memory bytes.  A level reads every sample once and
// writes every coefficient once (8 bytes a sample) for about a dozen integer
// ops a sample, far below the card's ops-per-byte balance.  Three 1-D passes
// a level would move 16 bytes a sample, since the vertical pass writes its
// halves to device memory and the horizontal passes read them back.  Here
// one block owns a tile of kTY x kTX output sample pairs:
//   1. it loads the tile's input plus the 5/3 halo into shared memory once,
//      each thread issuing all of its loads before it stores any;
//   2. it lifts there, vertically first and then horizontally (integer
//      lifting does not commute, and grok_tpu/ops/dwt.py lifts in that
//      order); the inverse runs the mirror image, horizontal first;
//   3. it writes each output once.
// The halo costs (2 kTY + 3)(2 kTX + 3) / (4 kTY kTX) - 1, about 9% more
// loads than samples, and neighbouring blocks share it through L2.
//
// The byte bound leaves a block about as many instructions a sample as a
// 132-SM card issues in the time, so the loops are lean: a warp takes 32
// neighbouring columns of a row and the block's eight warps take rows in
// turn (every load, store and shared access of a warp is contiguous, and
// no loop divides); each lane reflects its columns once.  kTX = 61 makes a
// loaded row 125 columns, four warps' width.
//
// Edges: whole-sample symmetric extension, applied to the indices when the
// tile is loaded (x[-k] = x[k], x[n - 1 + k] = x[n - 1 - k]; for the inverse,
// on the interleaved low/high signal).  Lifting the extended signal gives
// exactly the mirrored neighbours of grok_tpu/ops/dwt.py (_ev_right,
// _d_pair) for n >= 2; a length of 1 skips the lifting along that axis and
// passes the sample through as the low band.  Odd lengths need nothing
// else: the extension supplies the missing neighbour.
//
// Arithmetic wraps like numpy/JAX int32 (corrupt streams reach it, see
// tests/test_dwt.py test_native53_inverse_wraps_like_numpy): sums are taken
// in uint32 and cast back, and >> is an arithmetic shift of the int32.
//
// Layout: `planes` contiguous (h, w) planes in, and for the forward level
// four contiguous band stacks out: ll (ceil(h/2), ceil(w/2)),
// hl (ceil(h/2), w/2), lh (h/2, ceil(w/2)), hh (h/2, w/2).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTX = 61;  // output sample pairs a block, along a row
constexpr int kTY = 22;  // output sample pairs a block, down a column
// The shared tile: local index k holds global index 2 * (first pair) - 2 + k
// on each axis, so local parity equals global parity.  The forward level
// loads k in [0, 2T + 3), the inverse k in [1, 2T + 4).
constexpr int kRows = 2 * kTY + 4;
constexpr int kCols = 2 * kTX + 4;
constexpr int kLoadR = 2 * kTY + 3;  // rows a block loads
constexpr int kLoadC = 2 * kTX + 3;  // columns a block loads
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kColSlots = (kLoadC + 31) / 32;       // a lane's loaded columns
constexpr int kRowSlots = (kLoadR + kWarps - 1) / kWarps;  // a warp's rows

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

// predict term: (left + right) >> 1
__device__ __forceinline__ int32_t half_sum(int32_t a, int32_t b) {
  return wadd(a, b) >> 1;
}

// update term: (left + right + 2) >> 2
__device__ __forceinline__ int32_t quarter_sum(int32_t a, int32_t b) {
  return wadd(wadd(a, b), 2) >> 2;
}

// Whole-sample symmetric reflection of index k into [0, n).
__device__ __forceinline__ int reflect(int k, int n) {
  if (k >= 0 && k < n) return k;
  if (n == 1) return 0;
  const int period = 2 * n - 2;
  k = abs(k) % period;
  return k < n ? k : period - k;
}

// The lifting passes below each update every other row (or column) of a
// band of the shared tile from its two neighbours, which that pass does not
// write; a barrier follows each pass.

__global__ void __launch_bounds__(kThreads)
fwd53_level_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ ll,
                   int32_t* __restrict__ hl, int32_t* __restrict__ lh,
                   int32_t* __restrict__ hh, int h, int w) {
  __shared__ int32_t t[kRows][kCols];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int ne_h = (h + 1) >> 1, no_h = h >> 1;
  const int ne_w = (w + 1) >> 1, no_w = w >> 1;
  const int i0 = blockIdx.y * kTY, j0 = blockIdx.x * kTX;  // first pair
  const long long plane = blockIdx.z;
  x += plane * h * w;

  // 1. input rows [2 i0 - 2, 2 i0 + 2 kTY], columns [2 j0 - 2, 2 j0 + 2 kTX]
  int gc[kColSlots];
#pragma unroll
  for (int k = 0; k < kColSlots; ++k) {
    gc[k] = reflect(2 * j0 - 2 + lane + 32 * k, w);
  }
  int32_t v[kRowSlots][kColSlots];
#pragma unroll
  for (int q = 0; q < kRowSlots; ++q) {
    const int r = warp + kWarps * q;
    if (r < kLoadR) {
      const int32_t* row =
          x + static_cast<long long>(reflect(2 * i0 - 2 + r, h)) * w;
#pragma unroll
      for (int k = 0; k < kColSlots; ++k) {
        if (lane + 32 * k < kLoadC) v[q][k] = row[gc[k]];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kRowSlots; ++q) {
    const int r = warp + kWarps * q;
#pragma unroll
    for (int k = 0; k < kColSlots; ++k) {
      if (r < kLoadR && lane + 32 * k < kLoadC) t[r][lane + 32 * k] = v[q][k];
    }
  }
  __syncthreads();

  // 2. vertical, on every loaded column: details d at odd local rows
  //    1 .. 2 kTY + 1, then smooth samples at even rows 2 .. 2 kTY
  if (h > 1) {
    for (int r = 1 + 2 * warp; r <= 2 * kTY + 1; r += 2 * kWarps) {
#pragma unroll
      for (int c = lane; c < kLoadC; c += 32) {
        t[r][c] = wsub(t[r][c], half_sum(t[r - 1][c], t[r + 1][c]));
      }
    }
    __syncthreads();
    for (int r = 2 + 2 * warp; r <= 2 * kTY; r += 2 * kWarps) {
#pragma unroll
      for (int c = lane; c < kLoadC; c += 32) {
        t[r][c] = wadd(t[r][c], quarter_sum(t[r - 1][c], t[r + 1][c]));
      }
    }
    __syncthreads();
  }
  // horizontal, on the rows that hold this tile's coefficients (2 .. 2 kTY
  // + 1): details at odd local columns 1 .. 2 kTX + 1, then smooth samples
  if (w > 1) {
    for (int r = 2 + warp; r < 2 * kTY + 2; r += kWarps) {
#pragma unroll
      for (int c = 1 + 2 * lane; c <= 2 * kTX + 1; c += 64) {
        t[r][c] = wsub(t[r][c], half_sum(t[r][c - 1], t[r][c + 1]));
      }
    }
    __syncthreads();
    for (int r = 2 + warp; r < 2 * kTY + 2; r += kWarps) {
#pragma unroll
      for (int c = 2 + 2 * lane; c <= 2 * kTX; c += 64) {
        t[r][c] = wadd(t[r][c], quarter_sum(t[r][c - 1], t[r][c + 1]));
      }
    }
    __syncthreads();
  }

  // 3. the four bands: pair (a, b) of the tile sits at local (2a + 2 + dy,
  //    2b + 2 + dx), dy/dx 0 for low and 1 for high
  for (int a = warp; a < kTY; a += kWarps) {
    const int bi = i0 + a, r = 2 * a + 2;
    int32_t* ll_row = ll + (plane * ne_h + bi) * ne_w + j0;
    int32_t* hl_row = hl + (plane * ne_h + bi) * no_w + j0;
    int32_t* lh_row = lh + (plane * no_h + bi) * ne_w + j0;
    int32_t* hh_row = hh + (plane * no_h + bi) * no_w + j0;
#pragma unroll
    for (int b = lane; b < kTX; b += 32) {
      const int bj = j0 + b, c = 2 * b + 2;
      if (bi < ne_h) {
        if (bj < ne_w) ll_row[b] = t[r][c];
        if (bj < no_w) hl_row[b] = t[r][c + 1];
      }
      if (bi < no_h) {
        if (bj < ne_w) lh_row[b] = t[r + 1][c];
        if (bj < no_w) hh_row[b] = t[r + 1][c + 1];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
inv53_level_kernel(const int32_t* __restrict__ ll,
                   const int32_t* __restrict__ hl,
                   const int32_t* __restrict__ lh,
                   const int32_t* __restrict__ hh, int32_t* __restrict__ out,
                   int h, int w) {
  __shared__ int32_t t[kRows][kCols];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int ne_h = (h + 1) >> 1, no_h = h >> 1;
  const int ne_w = (w + 1) >> 1, no_w = w >> 1;
  const int i0 = blockIdx.y * kTY, j0 = blockIdx.x * kTX;  // first pair
  const long long plane = blockIdx.z;

  // 1. the interleaved signal (even rows from ll/hl, odd from lh/hh; even
  //    columns from the low bands, odd from the high), global rows and
  //    columns [2 i0 - 1, 2 i0 + 2 kTY + 1] at local 1 .. kRows - 1
  int bc[kColSlots];
  bool odd_c[kColSlots];
#pragma unroll
  for (int k = 0; k < kColSlots; ++k) {
    const int gc = reflect(2 * j0 - 1 + lane + 32 * k, w);
    bc[k] = gc >> 1;
    odd_c[k] = gc & 1;
  }
  int32_t v[kRowSlots][kColSlots];
#pragma unroll
  for (int q = 0; q < kRowSlots; ++q) {
    const int r = warp + kWarps * q;  // local row r + 1
    if (r < kLoadR) {
      const int gr = reflect(2 * i0 - 1 + r, h);
      const long long br = gr >> 1;
      const int32_t* lo_row = gr & 1 ? lh + (plane * no_h + br) * ne_w
                                     : ll + (plane * ne_h + br) * ne_w;
      const int32_t* hi_row = gr & 1 ? hh + (plane * no_h + br) * no_w
                                     : hl + (plane * ne_h + br) * no_w;
#pragma unroll
      for (int k = 0; k < kColSlots; ++k) {
        if (lane + 32 * k < kLoadC) {
          v[q][k] = odd_c[k] ? hi_row[bc[k]] : lo_row[bc[k]];
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kRowSlots; ++q) {
    const int r = warp + kWarps * q;
#pragma unroll
    for (int k = 0; k < kColSlots; ++k) {
      if (r < kLoadR && lane + 32 * k < kLoadC) {
        t[r + 1][lane + 32 * k + 1] = v[q][k];
      }
    }
  }
  __syncthreads();

  // 2. horizontal, on every loaded row: even samples at local columns
  //    2 .. 2 kTX + 2, then odd samples at 3 .. 2 kTX + 1
  if (w > 1) {
    for (int r = 1 + warp; r < kRows; r += kWarps) {
#pragma unroll
      for (int c = 2 + 2 * lane; c <= 2 * kTX + 2; c += 64) {
        t[r][c] = wsub(t[r][c], quarter_sum(t[r][c - 1], t[r][c + 1]));
      }
    }
    __syncthreads();
    for (int r = 1 + warp; r < kRows; r += kWarps) {
#pragma unroll
      for (int c = 3 + 2 * lane; c <= 2 * kTX + 1; c += 64) {
        t[r][c] = wadd(t[r][c], half_sum(t[r][c - 1], t[r][c + 1]));
      }
    }
    __syncthreads();
  }
  // vertical, on this tile's columns 2 .. 2 kTX + 1: even rows
  // 2 .. 2 kTY + 2, then odd rows 3 .. 2 kTY + 1
  if (h > 1) {
    for (int r = 2 + 2 * warp; r <= 2 * kTY + 2; r += 2 * kWarps) {
#pragma unroll
      for (int c = 2 + lane; c < 2 * kTX + 2; c += 32) {
        t[r][c] = wsub(t[r][c], quarter_sum(t[r - 1][c], t[r + 1][c]));
      }
    }
    __syncthreads();
    for (int r = 3 + 2 * warp; r <= 2 * kTY + 1; r += 2 * kWarps) {
#pragma unroll
      for (int c = 2 + lane; c < 2 * kTX + 2; c += 32) {
        t[r][c] = wadd(t[r][c], half_sum(t[r - 1][c], t[r + 1][c]));
      }
    }
    __syncthreads();
  }

  // 3. the (2 kTY, 2 kTX) output tile
  for (int r = warp; r < 2 * kTY; r += kWarps) {
    const int gr = 2 * i0 + r;
    if (gr >= h) break;
    int32_t* row = out + (plane * h + gr) * w + 2 * j0;
#pragma unroll
    for (int c = lane; c < 2 * kTX; c += 32) {
      if (2 * j0 + c < w) row[c] = t[r + 2][c + 2];
    }
  }
}

// Grid for one level of `planes` (h, w) planes, or an error when the shape
// does not fit one launch.
cudaError_t grid_for(int h, int w, int planes, dim3* grid) {
  if (h <= 0 || w <= 0 || planes <= 0 || planes > 65535)
    return cudaErrorInvalidValue;
  const int by = ((h + 1) / 2 + kTY - 1) / kTY;
  const int bx = ((w + 1) / 2 + kTX - 1) / kTX;
  if (by > 65535) return cudaErrorInvalidValue;
  *grid = dim3(static_cast<unsigned>(bx), static_cast<unsigned>(by),
               static_cast<unsigned>(planes));
  return cudaSuccess;
}

}  // namespace

extern "C" int grk_fwd53_level(const void* x, void* ll, void* hl, void* lh,
                               void* hh, int h, int w, int planes,
                               void* stream) {
  dim3 grid;
  cudaError_t err = grid_for(h, w, planes, &grid);
  if (err != cudaSuccess) return err;
  fwd53_level_kernel<<<grid, dim3(32, kWarps), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(ll),
      static_cast<int32_t*>(hl), static_cast<int32_t*>(lh),
      static_cast<int32_t*>(hh), h, w);
  return cudaGetLastError();
}

extern "C" int grk_inv53_level(const void* ll, const void* hl, const void* lh,
                               const void* hh, void* out, int h, int w,
                               int planes, void* stream) {
  dim3 grid;
  cudaError_t err = grid_for(h, w, planes, &grid);
  if (err != cudaSuccess) return err;
  inv53_level_kernel<<<grid, dim3(32, kWarps), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ll), static_cast<const int32_t*>(hl),
      static_cast<const int32_t*>(lh), static_cast<const int32_t*>(hh),
      static_cast<int32_t*>(out), h, w);
  return cudaGetLastError();
}
