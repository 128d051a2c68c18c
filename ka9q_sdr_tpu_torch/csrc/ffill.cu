// Forward fill ("last valid wins") for the FM threshold-extension blanking.
//
// Replaces the TPU kernel ka9q_sdr_tpu/ops/ffill.py `_fill_pallas` (a
// log2(T)-round lane-roll scan in VMEM, gridded over 64-row blocks).  For
// each row b of one or more (B, T) value arrays sharing one bool mask:
//
//     out[b, n] = v[b, k]  for the last k <= n with mask[b, k],
//     out[b, n] = init[b]  where no such k exists.
//
// Design for Hopper: one thread block per row (B is 4096-8192 on the main
// path, which keeps all 132 SMs busy).  The row is walked in tiles of
// blockDim.x positions.  Each thread holds one position; a block-wide
// inclusive max-scan of (mask ? n : -1) - warp shuffles, then one pass over
// the per-warp totals in shared memory - gives the last valid index inside
// the tile, and a carry (the running max) joins the tiles.  A strong
// position copies its own value (a coalesced load); a weak one reads the
// value at its last valid index, which lies in this or an earlier tile of
// the same row and is still in L1/L2.
//
// Bound: a pure copy/select, limited by device memory.  Per element it
// reads the 1-byte mask and each value (4 or 8 bytes) once and writes each
// output once: at (4096, 960) complex that is about 4M x (1 + 8 + 8) bytes.
// The output is bit-exact against the plain PyTorch version (selects only).
//
// Complex values arrive as interleaved float2 (complex64 storage), so no
// plane split or re-join is needed.  All value arrays sharing the mask are
// filled in one launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxValues = 4;
constexpr unsigned kFull = 0xffffffffu;

struct FillArgs {
  const void* v[kMaxValues];
  void* out[kMaxValues];
  const void* init[kMaxValues];
  int width[kMaxValues];  // 1: float, 2: float2 (complex64)
  int n_values;
};

__device__ __forceinline__ int warp_incl_max(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x = max(x, y);
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
ffill_rows(const unsigned char* __restrict__ mask, int T, FillArgs args) {
  __shared__ int warp_tot[2][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * (size_t)T;
  const unsigned char* m = mask + row;

  int carry = -1;  // last valid index of the row before this tile
  int buf = 0;
  for (int t0 = 0; t0 < T; t0 += kThreads, buf ^= 1) {
    const int t = t0 + threadIdx.x;
    const bool in_row = t < T;
    const bool strong = in_row && m[t] != 0;
    int x = warp_incl_max(strong ? t : -1, lane);
    if (lane == 31) warp_tot[buf][warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < kWarps ? warp_tot[buf][lane] : -1;
      w = warp_incl_max(w, lane);
      if (lane < kWarps) warp_tot[buf][lane] = w;
    }
    __syncthreads();
    // warp_tot[buf] is rewritten two tiles later, behind the next tile's
    // first __syncthreads, so no third barrier is needed here.
    if (warp > 0) x = max(x, warp_tot[buf][warp - 1]);
    const int last = max(x, carry);
    carry = max(carry, warp_tot[buf][kWarps - 1]);

    if (in_row) {
      // constant trip count: args.v[i] etc. stay kernel-parameter loads
#pragma unroll
      for (int i = 0; i < kMaxValues; ++i) {
        if (i >= args.n_values) break;
        if (args.width[i] == 2) {
          const float2* v = static_cast<const float2*>(args.v[i]) + row;
          float2* o = static_cast<float2*>(args.out[i]) + row;
          o[t] = last >= 0 ? v[last]
                           : static_cast<const float2*>(args.init[i])[blockIdx.x];
        } else {
          const float* v = static_cast<const float*>(args.v[i]) + row;
          float* o = static_cast<float*>(args.out[i]) + row;
          o[t] = last >= 0 ? v[last]
                           : static_cast<const float*>(args.init[i])[blockIdx.x];
        }
      }
    }
  }
}

}  // namespace

// Host entry, bound with ctypes.  Pointer arrays are host arrays of device
// pointers; the launch goes on `stream` and does not synchronise.  Returns
// the cudaError_t of the launch (0 = success); 1000 flags bad arguments.
extern "C" int ffill_launch(const void* mask, int B, int T, int n_values,
                            const uint64_t* values, const uint64_t* outs,
                            const uint64_t* inits, const int* widths,
                            void* stream) {
  if (B <= 0 || T <= 0 || n_values < 1 || n_values > kMaxValues) return 1000;
  FillArgs args{};
  for (int i = 0; i < n_values; ++i) {
    if (widths[i] != 1 && widths[i] != 2) return 1000;
    args.v[i] = reinterpret_cast<const void*>(values[i]);
    args.out[i] = reinterpret_cast<void*>(outs[i]);
    args.init[i] = reinterpret_cast<const void*>(inits[i]);
    args.width[i] = widths[i];
  }
  args.n_values = n_values;
  ffill_rows<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(mask), T, args);
  return static_cast<int>(cudaGetLastError());
}
