// Forward fill ("last valid wins") for the FM threshold-extension blanking.
//
// Replaces the TPU kernel ka9q_sdr_tpu/ops/ffill.py `_fill_pallas` (a
// log2(T)-round lane-roll scan in VMEM, gridded over 64-row blocks).  For
// each row b of one to four (B, T) value arrays sharing one bool mask:
//
//     out[b, n] = v[b, k]  for the last k <= n with mask[b, k],
//     out[b, n] = init[b]  where no such k exists.
//
// Design for Hopper: one warp per row, eight rows per block, no shared
// memory and no barrier.  The flat (B*T) arrays are cut into runs of 8
// positions aligned to the start of the arrays: a lane loads a run's mask as
// one 8-byte word and each value as 16-byte vectors (four per complex value,
// two per float one).  The few runs that a row boundary cuts, and every run
// when a base pointer is misaligned, go position by position.  The warp
// walks its row 32 runs at a time.  Each lane loads its run's mask and values
// together, then scans the run serially in registers: a strong position
// takes its own value, a weak one the last strong value before it.  That
// value comes from the lane's own registers, or from the nearest earlier
// lane whose run has a strong position (a ballot and one shuffle per float),
// or from the carry: the last strong value of the earlier chunks, which
// starts as the row's init.  A complex value may be a conjugate view: its
// flag makes the load negate the imaginary part.
//
// Bound: a pure copy/select, limited by device memory.  Per element it reads
// the 1-byte mask and each value (4 or 8 bytes) once and writes each output
// once: 17 bytes per complex position, 9 per float one.  The output is
// bit-exact against the plain PyTorch version (selects and sign flips only).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRun = 8;     // positions per lane per chunk
constexpr int kSlots = 16;  // floats of one value array a lane holds
constexpr int kWarps = 8;   // rows per block
constexpr int kMaxValues = 4;
constexpr unsigned kFull = 0xffffffffu;

struct FillArgs {
  const void* v[kMaxValues];
  void* out[kMaxValues];
  const void* init[kMaxValues];
  int width[kMaxValues];  // 1: float, 2: float2 (complex64)
  int conj[kMaxValues];   // 1: negate the imaginary part on load
};

// The run of positions [g0, g0 + kRun) of one value array into x (w floats
// per position); positions outside [lo, hi) stay 0 and are not read.
__device__ __forceinline__ void load_run(const float* __restrict__ v, int w,
                                         bool full, long long g0,
                                         long long lo, long long hi,
                                         float (&x)[kSlots]) {
  if (full) {
    const float4* p = reinterpret_cast<const float4*>(v + g0 * w);
#pragma unroll
    for (int q = 0; q < kSlots / 4; ++q) {
      if (q < 2 * w) {
        const float4 a = __ldg(p + q);
        x[4 * q] = a.x;
        x[4 * q + 1] = a.y;
        x[4 * q + 2] = a.z;
        x[4 * q + 3] = a.w;
      }
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kSlots; ++k) x[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const long long g = g0 + k;
    if (g >= lo && g < hi) {
      if (w == 2) {
        x[2 * k] = __ldg(v + 2 * g);
        x[2 * k + 1] = __ldg(v + 2 * g + 1);
      } else {
        x[k] = __ldg(v + g);
      }
    }
  }
}

__device__ __forceinline__ void store_run(float* __restrict__ o, int w,
                                          bool full, long long g0,
                                          long long lo, long long hi,
                                          const float (&x)[kSlots]) {
  if (full) {
    float4* p = reinterpret_cast<float4*>(o + g0 * w);
#pragma unroll
    for (int q = 0; q < kSlots / 4; ++q)
      if (q < 2 * w)
        p[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const long long g = g0 + k;
    if (g >= lo && g < hi) {
      if (w == 2) {
        o[2 * g] = x[2 * k];
        o[2 * g + 1] = x[2 * k + 1];
      } else {
        o[g] = x[k];
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kWarps * 32)
ffill_rows(const unsigned char* __restrict__ mask, int B, int T, bool vec,
           FillArgs args) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;  // whole warps only
  const long long lo = (long long)row * T, hi = lo + T;

  float carry[N][2];  // last strong value so far (the init before any)
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (args.width[i] == 2) {
      const float2 c = static_cast<const float2*>(args.init[i])[row];
      carry[i][0] = c.x;
      carry[i][1] = c.y;
    } else {
      carry[i][0] = static_cast<const float*>(args.init[i])[row];
      carry[i][1] = 0.0f;
    }
  }

  for (long long r0 = lo / kRun; r0 * kRun < hi; r0 += 32) {
    const long long g0 = (r0 + lane) * kRun;
    const bool full = vec && g0 >= lo && g0 + kRun <= hi;
    unsigned bits = 0;  // bit k: position g0 + k lies in the row and is strong
    float x[N][kSlots];
    if (full) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(mask + g0));
#pragma unroll
      for (int k = 0; k < kRun; ++k)
        bits |= ((((k < 4 ? q.x : q.y) >> (8 * (k % 4))) & 0xffu) != 0) << k;
    } else {
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        const long long g = g0 + k;
        if (g >= lo && g < hi && __ldg(mask + g)) bits |= 1u << k;
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
      load_run(static_cast<const float*>(args.v[i]), args.width[i], full, g0,
               lo, hi, x[i]);

    const unsigned has = __ballot_sync(kFull, bits != 0);
    const unsigned below = has & ((1u << lane) - 1u);
    const int src = below ? 31 - __clz(below) : lane;
    const int top = has ? 31 - __clz(has) : 0;

#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool cplx = args.width[i] == 2;
      if (cplx && args.conj[i]) {
#pragma unroll
        for (int k = 0; k < kRun; ++k) x[i][2 * k + 1] = -x[i][2 * k + 1];
      }
      // this run's last strong value, then the one before this run
      float lr = 0.0f, li = 0.0f;
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        if (bits & (1u << k)) {
          lr = cplx ? x[i][2 * k] : x[i][k];
          li = cplx ? x[i][2 * k + 1] : 0.0f;
        }
      }
      float pr = __shfl_sync(kFull, lr, src);
      float pi = __shfl_sync(kFull, li, src);
      if (!below) {
        pr = carry[i][0];
        pi = carry[i][1];
      }
      const float cr = __shfl_sync(kFull, lr, top);
      const float ci = __shfl_sync(kFull, li, top);
      if (has) {
        carry[i][0] = cr;
        carry[i][1] = ci;
      }
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        const bool strong = bits & (1u << k);
        if (cplx) {
          if (strong) {
            pr = x[i][2 * k];
            pi = x[i][2 * k + 1];
          }
          x[i][2 * k] = pr;
          x[i][2 * k + 1] = pi;
        } else {
          if (strong) pr = x[i][k];
          x[i][k] = pr;
        }
      }
      store_run(static_cast<float*>(args.out[i]), args.width[i], full, g0, lo,
                hi, x[i]);
    }
  }
}

bool aligned(const void* p, uintptr_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

}  // namespace

// Host entry, bound with ctypes.  Pointer arrays are host arrays of device
// pointers; the launch goes on `stream` and does not synchronise.  Returns
// the cudaError_t of the launch (0 = success); 1000 flags bad arguments.
extern "C" int ffill_launch(const void* mask, int B, int T, int n_values,
                            const uint64_t* values, const uint64_t* outs,
                            const uint64_t* inits, const int* widths,
                            const int* conjs, void* stream) {
  if (B <= 0 || T <= 0 || n_values < 1 || n_values > kMaxValues) return 1000;
  FillArgs args{};
  bool vec = aligned(mask, kRun);
  for (int i = 0; i < n_values; ++i) {
    if (widths[i] != 1 && widths[i] != 2) return 1000;
    if (conjs[i] && widths[i] != 2) return 1000;
    args.v[i] = reinterpret_cast<const void*>(values[i]);
    args.out[i] = reinterpret_cast<void*>(outs[i]);
    args.init[i] = reinterpret_cast<const void*>(inits[i]);
    args.width[i] = widths[i];
    args.conj[i] = conjs[i];
    vec = vec && aligned(args.v[i], 16) && aligned(args.out[i], 16);
  }
  const unsigned blocks = (B + kWarps - 1) / kWarps;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const unsigned char*>(mask);
#define FFILL_CASE(N)                                                    \
  case N:                                                                \
    ffill_rows<N><<<blocks, kWarps * 32, 0, st>>>(m, B, T, vec, args); \
    break;
  switch (n_values) {
    FFILL_CASE(1) FFILL_CASE(2) FFILL_CASE(3) FFILL_CASE(4)
  }
#undef FFILL_CASE
  return static_cast<int>(cudaGetLastError());
}
