// Hang AGC: the per-sample gain recurrence of the AM and linear demodulators.
//
// Replaces the serial `lax.scan` of ka9q_sdr_tpu/ops/agc.py:73 `agc_block`
// (not a Pallas kernel: eager PyTorch has no scan, and a loop of small
// torch ops costs about ten launches per sample).  For each channel b:
//
//     clamp = headroom / lev[t]                 (needs lev only)
//     over  = lev[t] * gain > headroom
//     bad   = isnan(gain)
//     gain  = (bad | over) ? clamp : (hang > 0 ? gain : gain * recovery)
//     hang  = (over & !bad) ? hangmax : max(hang - 1, 0)
//     out[b, t] = gain
//
// What bounds it.  The recurrence is serial in t and independent per
// channel, so one thread carries one channel, and the time is the larger
// of two floors: the chain, T steps of the function's dependent path
// (mul.rn -> setp.gt.or -> selp, see `step`: 12 cycles a step at the
// ALU's 4-cycle latency), and the bytes, 8 per sample (levels in, gains
// out) over 3.35 TB/s.  At 1980 MHz the bytes set it at (4096, 960) (0.0094
// against 0.0058 ms) and (8192, 7104) (0.139 against 0.043 ms); the chain
// where B is small ((512, 960), (1, 960)).  The walk as built takes about
// 30 cycles a step, the per-tile waits included.  chip_smoke.py phase 3
// prints both floors, and the cycles per step it measures, for every
// timed shape.
//
// Design for Hopper.  A block of 288 threads owns 32 channels: warp 0 is
// the walker, one lane per channel, and warps 1-8 are helpers.  They
// share a ring of kStages stages in shared memory (104 KB, so two blocks
// fit an SM); a stage holds one tile of S = 64 samples x 32 channels three
// times over: the levels, their clamps, the gains.
//
// - The helpers copy the levels in with 16-byte `cp.async`, kAhead tiles
//   ahead of the one they prepare (16 KB in flight per block), so device
//   memory stays busy while the walker runs.  A chunk of 4 samples that is
//   cut by the row's end, starts off a 16-byte boundary (odd T, or a view
//   with a storage offset) or lies in a dead row (B not a multiple of 32)
//   goes sample by sample: 4-byte copies inside the row, 1.0 past it.
// - Each helper divides the chunks it copied itself (`__fdiv_rn`), so the
//   division is never on the chain, and arrives on the stage's `full`
//   mbarrier.  Eight helper warps, not two, because each division's
//   slow-path branch serialises a thread's divisions: with two, the walker
//   waited on them (58 cycles a sample against 34 with four).
// - The walker waits on `full` and walks the tile fully unrolled, a
//   compile-time trip count: its 16-byte shared-memory reads (conflict-free
//   at a row stride of S + 4) depend on nothing it computes, so they issue
//   ahead.  No branch depends on the data.  It writes the gains into the
//   stage and arrives on the stage's `walked` mbarrier.
// - A helper that needs a stage back waits on `walked`, stores that tile's
//   gains with 16-byte stores (sample by sample where the copy in was), and
//   copies the next tile's levels in.
// - A last tile shorter than S goes through a second instantiation of the
//   walk that keeps the carry past the row's end, so the main walk's trip
//   count stays a constant.
//
// Times on an "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi), cold L2, by
// compare_trees.py and chip_smoke.py phase 3: (4096, 960) 0.0206 ms,
// (8192, 7104) 0.181 ms, (512, 960) 0.019 ms, (1, 960) 0.019-0.020 ms; the
// walk 29.8 cycles a sample.  The kernel this one replaced (one thread per
// channel, the division and a shared-memory load on the chain, one warp
// per block) took 0.158 / 1.132 / 0.157 / 0.139 ms in the same call, 314
// cycles a sample.  PERF.md section 6 keeps the measurements.
//
// Exactness: the division and multiplies are round-to-nearest (`__fdiv_rn`,
// `mul.rn`), so no flag (-use_fast_math, -fmad) changes them, and there is
// no a*b+c to contract.  The quotient is the same wherever it is computed,
// so the result is bit-equal to the plain PyTorch loop.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;           // samples per tile (S)
constexpr int kLanes = 32;          // channels per block: the walker warp
constexpr int kHelpers = 256;       // eight helper warps
constexpr int kThreads = kLanes + kHelpers;
constexpr int kStages = 4;          // ring depth
constexpr int kAhead = 2;           // tiles in flight ahead of the one prepared

static_assert(kAhead < kStages, "a stage must be walked before it is refilled");

constexpr int kRow = kTile + 4;            // floats per channel row
constexpr int kPlane = kLanes * kRow;       // one tile
constexpr int kQuads = kTile / 4;           // 16-byte chunks per row
constexpr int kPerHelper = kLanes * kQuads / kHelpers;
constexpr size_t kSharedBytes =
    2 * kStages * sizeof(uint64_t) + 3 * kStages * kPlane * sizeof(float);
static_assert(kTile % 4 == 0 && (kLanes * kQuads) % kHelpers == 0, "tile");

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(smem(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most kAhead committed groups are still in flight
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kAhead) : "memory");
}

// One step of one channel.  The carry is the gain, the hang count and
// `mult`, the factor of the next step's ramp: 1 while the hang count is
// above zero, else `recovery` (gain * 1 is the gain exactly, NaN and inf
// included).  So the hang test is no select or compare on the chain:
// `mult` for the next step is one select on this step's `over`, between
// constants and a compare of the hang count that runs beside the chain.
// `over` is false when the gain is NaN (the product is NaN), so the
// reference's `over & !bad` is `over`.
//
// It is PTX so that the NaN test is its own `setp`, off the chain, folded
// into the compare by `setp.gt.or`: written in C++ the compiler tests the
// gain for NaN after the compare (`FSETP.GTU.OR |gain|, +INF`), one more
// instruction on the dependent path.
__device__ __forceinline__ void step(float lev, float clamp, float& gain,
                                     int& hang, float& mult, float headroom,
                                     float recovery, float mult_set,
                                     int hangmax) {
  asm("{\n\t"
      ".reg .pred bad, over, take, longer;\n\t"
      ".reg .f32 prod, held, decay;\n\t"
      ".reg .s32 left;\n\t"
      "mul.rn.f32 held, %0, %2;\n\t"
      "setp.nan.f32 bad, %0, %0;\n\t"
      "setp.gt.s32 longer, %1, 1;\n\t"
      "sub.s32 left, %1, 1;\n\t"
      "mul.rn.f32 prod, %3, %0;\n\t"
      "setp.gt.f32 over, prod, %5;\n\t"
      "setp.gt.or.f32 take, prod, %5, bad;\n\t"
      "selp.f32 %0, %4, held, take;\n\t"
      "selp.f32 decay, 0f3F800000, %6, longer;\n\t"
      "selp.f32 %2, %7, decay, over;\n\t"
      "max.s32 left, left, 0;\n\t"
      "selp.s32 %1, %8, left, over;\n\t"
      "}"
      : "+f"(gain), "+r"(hang), "+f"(mult)
      : "f"(lev), "f"(clamp), "f"(headroom), "f"(recovery), "f"(mult_set),
        "r"(hangmax));
}

// One tile of one channel: S steps from the stage's row `lev`/`clamp`,
// gains into `gains`.  kMasked keeps the carry from step n on.
template <bool kMasked>
__device__ __forceinline__ void walk(const float* lev, const float* clamp,
                                     float* gains, int n, float& gain,
                                     int& hang, float& mult, float headroom,
                                     float recovery, int hangmax) {
  const float mult_set = hangmax > 0 ? 1.0f : recovery;
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const float4 l4 = reinterpret_cast<const float4*>(lev)[q];
    const float4 c4 = reinterpret_cast<const float4*>(clamp)[q];
    const float l[4] = {l4.x, l4.y, l4.z, l4.w};
    const float c[4] = {c4.x, c4.y, c4.z, c4.w};
    float g[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kMasked) {
        float next_gain = gain, next_mult = mult;
        int next_hang = hang;
        step(l[i], c[i], next_gain, next_hang, next_mult, headroom,
             recovery, mult_set, hangmax);
        const bool on = 4 * q + i < n;
        gain = on ? next_gain : gain;
        hang = on ? next_hang : hang;
        mult = on ? next_mult : mult;
      } else {
        step(l[i], c[i], gain, hang, mult, headroom, recovery, mult_set,
             hangmax);
      }
      g[i] = gain;
    }
    reinterpret_cast<float4*>(gains)[q] = make_float4(g[0], g[1], g[2], g[3]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
agc_ring(const float* __restrict__ level, const float* __restrict__ gain_in,
         const int* __restrict__ hang_in, float* __restrict__ out,
         float* __restrict__ gain_out, int* __restrict__ hang_out, int B,
         int T, float headroom, float recovery, int hangmax) {
  extern __shared__ __align__(16) unsigned char shared[];
  uint64_t* full = reinterpret_cast<uint64_t*>(shared);
  uint64_t* walked = full + kStages;
  float* levs = reinterpret_cast<float*>(walked + kStages);
  float* clamps = levs + kStages * kPlane;
  float* gains = clamps + kStages * kPlane;
  const int b0 = blockIdx.x * kLanes;
  const int rows = min(kLanes, B - b0);
  const int ntiles = (T + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], kHelpers);
      bar_init(&walked[s], kLanes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kLanes) {
    // the walker: one lane per channel, the carry in registers
    const int lane = threadIdx.x;
    const bool live = lane < rows;
    float gain = live ? gain_in[b0 + lane] : 0.0f;
    int hang = live ? hang_in[b0 + lane] : 0;
    float mult = hang > 0 ? 1.0f : recovery;
    const int whole = T / kTile;
    for (int k = 0; k < ntiles; ++k) {
      const int s = k % kStages;
      const int at = s * kPlane + lane * kRow;
      bar_wait(&full[s], (k / kStages) & 1);
      if (k < whole)
        walk<false>(levs + at, clamps + at, gains + at, kTile, gain, hang,
                    mult, headroom, recovery, hangmax);
      else
        walk<true>(levs + at, clamps + at, gains + at, T - k * kTile,
                   gain, hang, mult, headroom, recovery, hangmax);
      bar_arrive(&walked[s]);
    }
    if (live) {
      gain_out[b0 + lane] = gain;
      hang_out[b0 + lane] = hang;
    }
    return;
  }

  // the helpers: chunk c = h + i * kHelpers of a tile is row c / kQuads,
  // samples 4 (c % kQuads) .. + 3; neighbouring threads take neighbouring
  // 16-byte chunks of a row
  const int h = threadIdx.x - kLanes;
  auto chunk = [&](int i, int& r, int& q) {
    const int c = h + i * kHelpers;
    r = c / kQuads;
    q = c % kQuads;
  };
  auto load = [&](int k) {
    float* stage = levs + (k % kStages) * kPlane;
#pragma unroll
    for (int i = 0; i < kPerHelper; ++i) {
      int r, q;
      chunk(i, r, q);
      const int t = k * kTile + 4 * q;
      float* dst = stage + r * kRow + 4 * q;
      const float* src = level + (size_t)(b0 + r) * T + t;
      if (r < rows && t + 4 <= T &&
          (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        copy16(dst, src);
      } else {
        for (int e = 0; e < 4; ++e) {
          if (r < rows && t + e < T)
            copy4(dst + e, src + e);
          else
            dst[e] = 1.0f;
        }
      }
    }
  };
  auto divide = [&](int k) {
    const int base = (k % kStages) * kPlane;
#pragma unroll
    for (int i = 0; i < kPerHelper; ++i) {
      int r, q;
      chunk(i, r, q);
      const int at = base + r * kRow + 4 * q;
      const float4 l = *reinterpret_cast<const float4*>(levs + at);
      *reinterpret_cast<float4*>(clamps + at) =
          make_float4(__fdiv_rn(headroom, l.x), __fdiv_rn(headroom, l.y),
                      __fdiv_rn(headroom, l.z), __fdiv_rn(headroom, l.w));
    }
  };
  auto store = [&](int k) {
    bar_wait(&walked[k % kStages], (k / kStages) & 1);
    const float* stage = gains + (k % kStages) * kPlane;
#pragma unroll
    for (int i = 0; i < kPerHelper; ++i) {
      int r, q;
      chunk(i, r, q);
      const int t = k * kTile + 4 * q;
      const float* src = stage + r * kRow + 4 * q;
      float* dst = out + (size_t)(b0 + r) * T + t;
      if (r < rows && t + 4 <= T &&
          (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        *reinterpret_cast<float4*>(dst) =
            *reinterpret_cast<const float4*>(src);
      } else {
        for (int e = 0; e < 4; ++e)
          if (r < rows && t + e < T) dst[e] = src[e];
      }
    }
  };

  for (int k = 0; k < kAhead; ++k) {     // one commit group per tile
    if (k < ntiles) load(k);
    copy_commit();
  }
  for (int k = 0; k < ntiles; ++k) {
    const int next = k + kAhead;
    if (next < ntiles) {
      if (next >= kStages) store(next - kStages);   // frees the stage
      load(next);
    }
    copy_commit();
    copy_wait();                         // tile k's group has landed
    divide(k);
    bar_arrive(&full[k % kStages]);
  }
  for (int k = ntiles > kStages ? ntiles - kStages : 0; k < ntiles; ++k)
    store(k);
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
  cudaError_t err = cudaFuncSetAttribute(
      agc_ring, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSharedBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kLanes - 1) / kLanes;
  agc_ring<<<blocks, kThreads, kSharedBytes,
             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(level), static_cast<const float*>(gain_in),
      static_cast<const int*>(hang_in), static_cast<float*>(out),
      static_cast<float*>(gain_out), static_cast<int*>(hang_out), B, T,
      headroom, recovery, hangmax);
  return static_cast<int>(cudaGetLastError());
}
