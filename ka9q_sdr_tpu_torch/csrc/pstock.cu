// Column FFT: radix-2 autosorting Stockham FFT along axis 0 of (Q, P)
// float32 re/im planes.
//
// Replaces the TPU kernel ka9q_sdr_tpu/ops/pstock.py `make_fft_cols`
// (Pallas, a (Q, CW = 256) column slab in VMEM per grid step; the slab is
// 8 MB at Q = 4096, far beyond a Hopper block's 227 KB of shared memory).
//
// The recurrence, per stage with current length n, half m = n/2 and stride
// s (s*n = Q): view the tile y as (n, w) with w = s*tw, split rows into
// a = y[:m], b = y[m:], and write y' = stack([a + b, (a - b) * W_p],
// axis=1) with W_p = exp(-2 pi i p / n).  After log2(Q) stages y holds the
// DFT of every column in natural order.
//
// Design for Hopper: one thread block takes a tile of tw columns (all Q
// rows, re and im) into dynamic shared memory, at most 16384 complex values
// = 128 KB: tw = 4 at Q = 4096, tw = 64 (the cap) for Q <= 256, tw = 1 at
// the largest Q, 16384.  1024 threads each own up to 8 butterflies per
// stage; a stage reads all its inputs into registers, passes a barrier,
// and writes its outputs in place, so one buffer suffices.  Twiddles are
// sincospif of the exact ratio -2p/n.  Columns past P are loaded as zeros
// and not stored.
//
// Bound: every element is read and written once in device memory (268 MB
// for (4096, 4096)), but a tile's 16-byte row segments fill half a 32-byte
// sector, and the 12 stages of shared-memory traffic with two barriers each
// are the larger cost: 0.44 ms at (4096, 4096) against cuFFT's 0.11 ms on
// an H100 80GB HBM3 at 700 W.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kPer = 8;                        // butterflies per thread
constexpr int kMaxElems = 2 * kPer * kThreads;  // complex values per tile
constexpr int kMaxCols = 64;

__global__ void __launch_bounds__(kThreads, 1)
fft_cols(const float* __restrict__ xr, const float* __restrict__ xi,
         float* __restrict__ yr, float* __restrict__ yi, int Q, int P,
         int log2q, int log2tw) {
  extern __shared__ float smem[];
  const int tw = 1 << log2tw;
  const int n_el = Q << log2tw;
  float* sr = smem;
  float* si = smem + n_el;
  const int c0 = blockIdx.x * tw;

  for (int e = threadIdx.x; e < n_el; e += kThreads) {
    const int c = c0 + (e & (tw - 1));
    float vr = 0.0f, vi = 0.0f;
    if (c < P) {
      const size_t g = (size_t)(e >> log2tw) * P + c;
      vr = xr[g];
      vi = xi[g];
    }
    sr[e] = vr;
    si[e] = vi;
  }
  __syncthreads();

  const int nb = n_el >> 1;  // butterflies per stage
  int log2w = log2tw;        // row width of the (n, w) view is s * tw
  for (int st = 0; st < log2q; ++st, ++log2w) {
    const int log2m = log2q - st - 1;  // m = n / 2
    float ar[kPer], ai[kPer], br[kPer], bi[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int u = threadIdx.x + k * kThreads;
      if (u < nb) {
        ar[k] = sr[u];
        ai[k] = si[u];
        br[k] = sr[u + nb];  // b = v[m:], m * w = n_el / 2 = nb places on
        bi[k] = si[u + nb];
      }
    }
    __syncthreads();
    // W_p = exp(-2 pi i p / n) = cospi(-2p/n) + i sinpi(-2p/n); 2/n is a
    // power of two, so the ratio is exact.
    const float scale = -2.0f / (float)(2 << log2m);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int u = threadIdx.x + k * kThreads;
      if (u < nb) {
        const int p = u >> log2w;
        const int j = u & ((1 << log2w) - 1);
        float wi, wr;
        sincospif((float)p * scale, &wi, &wr);
        const int o = (p << (log2w + 1)) + j;
        const float tr = ar[k] - br[k];
        const float ti = ai[k] - bi[k];
        sr[o] = ar[k] + br[k];
        si[o] = ai[k] + bi[k];
        sr[o + (1 << log2w)] = tr * wr - ti * wi;
        si[o + (1 << log2w)] = tr * wi + ti * wr;
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < n_el; e += kThreads) {
    const int c = c0 + (e & (tw - 1));
    if (c < P) {
      const size_t g = (size_t)(e >> log2tw) * P + c;
      yr[g] = sr[e];
      yi[g] = si[e];
    }
  }
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

// Column count of one tile at this Q (0 if Q does not fit).
int tile_cols(int Q) {
  if (Q <= 0 || Q > kMaxElems || log2_exact(Q) < 0) return 0;
  const int tw = kMaxElems / Q;
  return tw < kMaxCols ? tw : kMaxCols;
}

}  // namespace

// Host entry, bound with ctypes.  All pointers are device pointers; the
// launch goes on `stream` and does not synchronise.  Returns the
// cudaError_t of the launch (0 = success); 1000 flags bad arguments.
extern "C" int pstock_launch(const void* xr, const void* xi, void* yr,
                             void* yi, int Q, int P, void* stream) {
  const int tw = tile_cols(Q);
  if (tw == 0 || P <= 0) return 1000;
  const int log2tw = log2_exact(tw);
  const size_t smem = 2 * sizeof(float) * (size_t)Q * tw;
  cudaError_t err = cudaFuncSetAttribute(
      fft_cols, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (P + tw - 1) / tw;
  fft_cols<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<float*>(yr), static_cast<float*>(yi), Q, P, log2_exact(Q),
      log2tw);
  return static_cast<int>(cudaGetLastError());
}
