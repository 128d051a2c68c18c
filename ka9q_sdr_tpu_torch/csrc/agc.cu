// Hang AGC: the per-sample gain recurrence of the AM and linear demodulators.
//
// Replaces the serial `lax.scan` of ka9q_sdr_tpu/ops/agc.py `agc_block`
// (not a Pallas kernel: eager PyTorch has no scan, and a loop of small
// torch ops costs about ten launches per sample).  For each channel b:
//
//     clamp = headroom / lev[t]
//     over  = lev[t] * gain > headroom
//     bad   = isnan(gain)
//     gain  = (bad | over) ? clamp : (hang > 0 ? gain : gain * recovery)
//     hang  = (over & !bad) ? hangmax : max(hang - 1, 0)
//     out[b, t] = gain
//
// Design for Hopper: the recurrence is serial in time and independent per
// channel, so one thread runs one channel with its carry in registers.  A
// warp owns 32 channels (one warp per block; 4096-8192 channels give
// 128-256 warps).  Global reads and writes stay coalesced by going through
// a 32-channel x 32-sample tile in shared memory: the warp loads the tile
// row by row (lane = sample), each lane then walks its own channel along
// the tile (row stride 33, so no bank conflicts), writes its gains back
// into the tile, and the warp stores the tile row by row.  The next tile's
// loads are issued into registers before the current tile is walked, so
// they overlap the serial chain.
//
// Bound: the serial chain per sample, not device memory (8 bytes per
// sample).  Measured on an H100 80GB HBM3 at 700 W: ~250-320 cycles per
// sample, 0.16 ms at (4096, 960); each step waits on its shared-memory
// load and the correctly rounded division, with at most a warp or two per
// scheduler to hide them.
//
// Exactness: the division and multiplies use the round-to-nearest
// intrinsics, so no flag (-use_fast_math, -fmad) can change them; there is
// no a*b+c to contract.  The result is bit-equal to the plain PyTorch loop.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;

__global__ void __launch_bounds__(kTile)
agc_rows(const float* __restrict__ level, const float* __restrict__ gain_in,
         const int* __restrict__ hang_in, float* __restrict__ out,
         float* __restrict__ gain_out, int* __restrict__ hang_out, int B,
         int T, float headroom, float recovery, int hangmax) {
  __shared__ float tile[kTile][kTile + 1];
  const int lane = threadIdx.x;
  const int b0 = blockIdx.x * kTile;
  const int rows = min(kTile, B - b0);
  const bool live = lane < rows;
  float gain = live ? gain_in[b0 + lane] : 0.0f;
  int hang = live ? hang_in[b0 + lane] : 0;

  float next[kTile];
  auto load = [&](int t0) {
    const int t = t0 + lane;
#pragma unroll
    for (int r = 0; r < kTile; ++r)
      next[r] = (r < rows && t < T) ? level[(size_t)(b0 + r) * T + t] : 1.0f;
  };

  load(0);
  for (int t0 = 0; t0 < T; t0 += kTile) {
#pragma unroll
    for (int r = 0; r < kTile; ++r) tile[r][lane] = next[r];
    __syncwarp();
    if (t0 + kTile < T) load(t0 + kTile);
    const int n = min(kTile, T - t0);
    for (int j = 0; j < n; ++j) {
      const float lev = tile[lane][j];
      const float clamp_gain = __fdiv_rn(headroom, lev);
      const bool over = __fmul_rn(lev, gain) > headroom;
      const bool bad = isnan(gain);
      gain = (bad || over) ? clamp_gain
                           : (hang > 0 ? gain : __fmul_rn(gain, recovery));
      hang = (over && !bad) ? hangmax : max(hang - 1, 0);
      tile[lane][j] = gain;
    }
    __syncwarp();
    const int t = t0 + lane;
#pragma unroll
    for (int r = 0; r < kTile; ++r)
      if (r < rows && t < T) out[(size_t)(b0 + r) * T + t] = tile[r][lane];
    __syncwarp();
  }
  if (live) {
    gain_out[b0 + lane] = gain;
    hang_out[b0 + lane] = hang;
  }
}

}  // namespace

// Host entry, bound with ctypes.  All pointers are device pointers; the
// launch goes on `stream` and does not synchronise.  Returns the
// cudaError_t of the launch (0 = success); 1000 flags bad arguments.
extern "C" int agc_launch(const void* level, const void* gain_in,
                          const void* hang_in, void* out, void* gain_out,
                          void* hang_out, int B, int T, float headroom,
                          float recovery, int hangmax, void* stream) {
  if (B <= 0 || T <= 0) return 1000;
  const int blocks = (B + kTile - 1) / kTile;
  agc_rows<<<blocks, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(level), static_cast<const float*>(gain_in),
      static_cast<const int*>(hang_in), static_cast<float*>(out),
      static_cast<float*>(gain_out), static_cast<int*>(hang_out), B, T,
      headroom, recovery, hangmax);
  return static_cast<int>(cudaGetLastError());
}
