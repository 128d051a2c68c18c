// Column FFT: mixed-radix autosorting Stockham FFT along axis 0 of (Q, P)
// float32 re/im planes, radix-16 butterflies in registers.
//
// Replaces the TPU kernel ka9q_sdr_tpu/ops/pstock.py `make_fft_cols`
// (Pallas, a (Q, CW = 256) column slab in VMEM per grid step, log2(Q)
// radix-2 stages; the slab is 8 MB at Q = 4096, far beyond a Hopper block's
// 227 KB of shared memory).
//
// The recurrence, per pass with radix r, stride s (the product of the
// earlier radices) and m = Q / (s r): butterfly b in [0, Q/r), with
// p = b / s and j = b % s, takes the r inputs x[q (Q/r) + b], q < r, forms
// their r-point DFT Y_k = sum_q x_q exp(-2 pi i q k / r), multiplies Y_k by
// the twiddle exp(-2 pi i p k s / Q), and writes it to y[(p r + k) s + j].
// After the last pass (s r = Q, p = 0, no twiddle) y holds each column's DFT
// in natural order.  The plan (PlanOf) is radix 16 for every pass, and one
// pass of 2, 4 or 8 last where Q is not a power of 16 (three passes at
// Q = 4096 instead of twelve radix-2 stages); ops/pstock.py radix_plan
// writes the same plan for the numpy model of this schedule.  The kernel is
// compiled once per Q, so the plan, the tile (TileOf) and every size, stride
// and register index are constants.  The wrapper passes the twiddle table
// exp(-2 pi i t / Q), t < Q, from float64 cos/sin rounded to float32, which
// the passes read through the read-only cache (4 entries per 16-point
// butterfly, the other twiddles their products): no transcendental runs in
// the kernel.
//
// Design for Hopper.  A 32-byte sector is the unit of a device-memory
// access, and a tile of all Q rows must fit one SM: at Q = 4096 a thread
// block holds only 2-4 columns, whose 8- or 16-byte row segments use a
// quarter or half of each sector, and that, not the arithmetic, bounded the
// earlier kernels.  So the kernel splits Q = 16 M.  The first pass (16-point DFTs
// at stride M, then the twiddles exp(-2 pi i b k2 / Q)) leaves, for each
// k2 < 16, M points whose M-point DFT is the output rows k2 + 16 kk.  A
// cluster of CL thread blocks (CTAs) takes W columns (8 or 16: whole 32- or
// 64-byte sectors).  CTA r runs the first pass for the butterflies
// b in [r M/CL, (r+1) M/CL) of all W columns, reading row segments W
// columns wide, and writes each output k2 into the shared memory of the CTA
// that owns k2: the one all-to-all exchange, through distributed shared
// memory.  Each CTA then runs the remaining passes (the M-point FFTs of its
// 16/CL * W sub-columns) in its own shared memory and writes output rows
// k2 + 16 kk, again W columns wide.  So each SM holds 1/CL of the
// cluster's tile (8192 complex values, 70 KB, at Q = 4096: two CTAs share an
// SM), and every device-memory access is a whole sector.  A thread owns 16
// points of a sub-column; a pass loads them into registers, runs its r-point
// DFTs there (the radix-2 Stockham recurrence, fully unrolled, 16th roots as
// constants), twiddles and writes back; a padding float every 16 keeps the
// stride-16 writes on distinct banks, and one more bank per sub-column keeps
// neighbouring threads on neighbouring banks.  Columns past P are loaded as
// zeros and not stored.  Q <= 16 is one pass: a thread per column, straight
// from device memory to registers and back.
//
// Bound: every element is read and written once in device memory (268 MB
// for (4096, 4096) re/im planes), 0.080 ms at 3.35 TB/s; the arithmetic
// (about 1 GFLOP) is far below the float32 peak.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxQ = 16384;
constexpr int kLog2CtaElems = 13;  // complex values a CTA holds: 8192, 70 KB
constexpr int kSmemPerSm = 228 * 1024;
constexpr int kSmallThreads = 128;  // Q <= 16: a thread per column

// cos(2 pi e / 16)
__device__ __forceinline__ float cos16(int e) {
  constexpr float c1 = 0.923879532511286756f;  // cos(pi / 8)
  constexpr float c2 = 0.707106781186547524f;  // cos(pi / 4)
  constexpr float c3 = 0.382683432365089772f;  // cos(3 pi / 8)
  switch (e & 15) {
    case 0: return 1.0f;
    case 1: case 15: return c1;
    case 2: case 14: return c2;
    case 3: case 13: return c3;
    case 4: case 12: return 0.0f;
    case 5: case 11: return -c3;
    case 6: case 10: return -c2;
    case 7: case 9: return -c1;
    default: return -1.0f;
  }
}

// In-register DFT of R points (R a power of two up to 16) in natural order:
// the radix-2 autosorting Stockham recurrence, one stage per template level
// (length N, stride S = R / N: a = x[p S + j], b = x[(p + N/2) S + j],
// y[2p S + j] = a + b, y[(2p + 1) S + j] = (a - b) W_N^p).  Every index and
// twiddle is a compile-time constant, so nothing leaves the registers.
template <int R, int N = R>
__device__ __forceinline__ void dft(float (&re)[R], float (&im)[R]) {
  if constexpr (N >= 2) {
    constexpr int M = N / 2, S = R / N;
    float yr[R], yi[R];
#pragma unroll
    for (int p = 0; p < M; ++p) {
      const int e = p * (16 / N);  // W_N^p = W16^e
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int a = p * S + j, b = (p + M) * S + j;
        const int y0 = 2 * p * S + j, y1 = y0 + S;
        const float tr = re[a] - re[b], ti = im[a] - im[b];
        yr[y0] = re[a] + re[b];
        yi[y0] = im[a] + im[b];
        if (e == 0) {
          yr[y1] = tr;
          yi[y1] = ti;
        } else if (e == 4) {  // times -i
          yr[y1] = ti;
          yi[y1] = -tr;
        } else {
          const float c = cos16(e), sn = -cos16(e + 12);  // cos, -sin
          yr[y1] = tr * c - ti * sn;
          yi[y1] = tr * sn + ti * c;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      re[k] = yr[k];
      im[k] = yi[k];
    }
    dft<R, M>(re, im);
  }
}

// Points each thread holds: 16, or Q below 16.
template <int LOG2Q>
constexpr int kPerOf = 1 << (LOG2Q < 4 ? LOG2Q : 4);

// The plan (ops/pstock.py radix_plan writes the same): radix 16 for passes
// 0 .. N16 - 1, then one pass of 2^REM (of 1, a copy, at Q = 1).
template <int LOG2Q>
struct PlanOf {
  static constexpr int N16 = LOG2Q / 4, REM = LOG2Q % 4;
  static constexpr int NP = N16 + (REM != 0 || LOG2Q == 0 ? 1 : 0);
  __host__ __device__ static constexpr int log2r(int ps) {
    return ps < N16 ? 4 : REM;
  }
};

constexpr int round_banks(int n) { return (n + 31) & ~31; }

// The tile at Q = 2^LOG2Q >= 32, Q = 16 M: a cluster of CL = 2^LOG2CL CTAs
// takes W = 2^LOG2W columns.  16 columns (64-byte row segments) where one
// CTA holds them in 2^kLog2CtaElems complex values (Q <= 512), else 8 (32
// bytes, a whole sector) over as many CTAs as keep each near that, at most
// 8 and at most M.  A thread owns 16 points (M below M = 16) of one of the
// CTA's 16/CL * W sub-columns.
template <int LOG2Q>
struct TileOf {
  static constexpr int LOG2M = LOG2Q - 4, M = 1 << LOG2M;
  static constexpr int LOG2W = LOG2Q + 4 <= kLog2CtaElems ? 4 : 3;
  static constexpr int LOG2CL_FIT = LOG2Q + LOG2W - kLog2CtaElems;
  static constexpr int LOG2CL_MAX = LOG2M < 3 ? LOG2M : 3;
  static constexpr int LOG2CL = LOG2CL_FIT < 0 ? 0
                                : LOG2CL_FIT > LOG2CL_MAX ? LOG2CL_MAX
                                                          : LOG2CL_FIT;
  static constexpr int LOG2K = 4 - LOG2CL;     // k2 values each CTA owns
  static constexpr int LOG2SUB = LOG2K + LOG2W;  // its sub-columns
  static constexpr int THREADS = (1 << LOG2SUB) * (M / kPerOf<LOG2M>);
  // a float of padding every 16, rounded to whole banks, plus one bank so
  // that neighbouring sub-columns fall on neighbouring banks
  static constexpr int COL_STRIDE = round_banks(M + M / 16) + 1;
  static constexpr int PLANE = (1 << LOG2SUB) * COL_STRIDE;  // floats
  static constexpr int SMEM = 2 * 4 * PLANE;                 // bytes
  // two CTAs per SM where their threads and shared memory fit (which holds
  // ptxas to 64 registers at 512 threads), else one
  static constexpr int MIN_BLOCKS =
      THREADS <= 512 && 2 * (SMEM + 1024) <= kSmemPerSm ? 2 : 1;
  static_assert(THREADS <= 1024, "a CTA holds at most 1024 threads");
};

// Where the last pass writes: global row rowbase + (e << 4) of column col.
struct Out {
  float* yr;
  float* yi;
  size_t P;
  int rowbase, col;
  bool live;
};

__device__ __forceinline__ int pad(int e) { return e + (e >> 4); }

__device__ __forceinline__ float* smem_base() {
  extern __shared__ float smem[];
  return smem;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// exp(-2 pi i base k / Q) for k < R from the table: the entries at
// base 2^m, one per bit m of k, multiplied together (at most LOG2R - 1
// products).
template <int LOG2R>
__device__ __forceinline__ void twiddle_mul(float (&ar)[1 << LOG2R],
                                            float (&ai)[1 << LOG2R],
                                            const float2* __restrict__ tw,
                                            int base) {
  float2 wb[LOG2R];
#pragma unroll
  for (int m = 0; m < LOG2R; ++m) wb[m] = __ldg(tw + (base << m));
#pragma unroll
  for (int k = 1; k < (1 << LOG2R); ++k) {
    float2 w = make_float2(1.0f, 0.0f);
    bool first = true;
#pragma unroll
    for (int m = 0; m < LOG2R; ++m) {
      if (k & (1 << m)) {
        w = first ? wb[m] : cmul(w, wb[m]);
        first = false;
      }
    }
    const float2 y = cmul(make_float2(ar[k], ai[k]), w);
    ar[k] = y.x;
    ai[k] = y.y;
  }
}

// One pass of radix R = 2^LOG2R at stride S = 2^LOG2S of an N = 2^LOG2N
// point FFT over a sub-column in shared memory (sr, si): thread t takes the
// butterflies b = t + u T, u < PER / R (T = N / PER threads per
// sub-column), inputs of butterfly u in slots u R .. u R + R - 1.  A middle
// pass twiddles its outputs (exp(-2 pi i p S k / N), the table's entry
// p S k << TWS) and writes them back in place, after a barrier; the last
// pass writes each output e to device memory (`out`).  Every size and
// stride is a compile-time constant, so a thread's shared-memory addresses
// are one base plus constant offsets.
template <int LOG2N, int LOG2R, int LOG2S, int TWS, bool LAST>
__device__ __forceinline__ void run_pass(const float2* __restrict__ twiddle,
                                         float* sr, float* si, int t,
                                         const Out& out) {
  constexpr int N = 1 << LOG2N, R = 1 << LOG2R, S = 1 << LOG2S;
  constexpr int PER = kPerOf<LOG2N>, T = N / PER, U = PER / R, IN = N / R;
  float vr[PER], vi[PER];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int e = pad(q * IN + u * T + t);
      vr[u * R + q] = sr[e];
      vi[u * R + q] = si[e];
    }
  if (!LAST) __syncthreads();  // every load done before the tile is rewritten
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float ar[R], ai[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      ar[q] = vr[u * R + q];
      ai[q] = vi[u * R + q];
    }
    dft<R>(ar, ai);
    const int b = t + u * T;
    const int p = b >> LOG2S;
    const int j = b & (S - 1);
    if (LAST) {  // p = 0: output e = k S + j
      if (out.live) {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const size_t g = (size_t)(out.rowbase + ((k * S + j) << 4)) * out.P +
                           out.col;
          out.yr[g] = ar[k];
          out.yi[g] = ai[k];
        }
      }
    } else {
      twiddle_mul<LOG2R>(ar, ai, twiddle, (p * S) << TWS);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int e = ((p * R + k) << LOG2S) + j;
        sr[pad(e)] = ar[k];
        si[pad(e)] = ai[k];
      }
    }
  }
}

template <int LOG2N, int TWS, int PS>
__device__ __forceinline__ void run_passes(const float2* __restrict__ tw,
                                           float* sr, float* si, int t,
                                           const Out& out) {
  using Pl = PlanOf<LOG2N>;
  constexpr bool last = PS == Pl::NP - 1;
  run_pass<LOG2N, Pl::log2r(PS), 4 * PS, TWS, last>(tw, sr, si, t, out);
  if constexpr (!last) {
    __syncthreads();  // this pass's stores are visible to the next
    run_passes<LOG2N, TWS, PS + 1>(tw, sr, si, t, out);
  }
}

// Q >= 32, as Q = 16 M: the first pass's 16-point DFTs (over stride M)
// give, for each k2 < 16, a sequence of M points whose M-point DFT is the
// output rows k2 + 16 kk.  A cluster of CL CTAs takes W neighbouring
// columns.  CTA r runs the first pass for the butterflies b in
// [r M/CL, (r+1) M/CL) of all W columns: it reads rows q M + b, each a
// segment of W columns (32 bytes at W = 8), twiddles, and writes each
// output k2 into the shared memory of the CTA that owns k2 (16/CL of them
// each): the one all-to-all exchange, through distributed shared memory.
// Then each CTA runs the M-point FFTs of its 16/CL * W sub-columns from its
// own shared memory and writes output rows k2 + 16 kk, again W columns
// wide.  So every device-memory access spans W columns while each SM holds
// only 1/CL of the cluster's tile.
template <int LOG2Q>
__global__ void __launch_bounds__(TileOf<LOG2Q>::THREADS,
                                  TileOf<LOG2Q>::MIN_BLOCKS)
fft_cols(const float* __restrict__ xr, const float* __restrict__ xi,
         float* __restrict__ yr, float* __restrict__ yi,
         const float2* __restrict__ twiddle, int P) {
  using Tl = TileOf<LOG2Q>;
  constexpr int M = Tl::M, W = 1 << Tl::LOG2W;
  constexpr int log2bl = Tl::LOG2M - Tl::LOG2CL;  // first-pass butterflies
                                                  // per column
  float* smem = smem_base();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int col0 = (blockIdx.x >> Tl::LOG2CL) << Tl::LOG2W;

  // first pass: thread i takes butterfly b of column c (threads past the
  // butterflies, where M < 16, only join the barriers)
  const int i = threadIdx.x;
  const bool act = i < 1 << (log2bl + Tl::LOG2W);
  const int c = i & (W - 1);
  const int b = (rank << log2bl) + (i >> Tl::LOG2W);
  const bool live = act && col0 + c < P;
  const int mstride = M * P;  // Q P < 2^31: 32-bit offsets
  float ar[16], ai[16];
  {
    const size_t g = (size_t)b * P + col0 + c;
    const float* px = xr + g;
    const float* py = xi + g;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      ar[q] = live ? __ldg(px + q * mstride) : 0.0f;
      ai[q] = live ? __ldg(py + q * mstride) : 0.0f;
    }
  }
  // every CTA of the cluster runs before any writes to it (the loads are
  // in flight meanwhile)
  cluster.sync();
  if (act) {
    dft<16>(ar, ai);
    twiddle_mul<4>(ar, ai, twiddle, b);  // exp(-2 pi i b k2 / Q)
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int sc = ((k & ((1 << Tl::LOG2K) - 1)) << Tl::LOG2W) + c;
      float* d = cluster.map_shared_rank(smem, k >> Tl::LOG2K) +
                 sc * Tl::COL_STRIDE + pad(b);
      d[0] = ar[k];
      d[Tl::PLANE] = ai[k];
    }
  }
  cluster.sync();  // every first-pass output has landed

  const int sc = threadIdx.x & ((1 << Tl::LOG2SUB) - 1);
  Out out;
  out.yr = yr;
  out.yi = yi;
  out.P = P;
  out.rowbase = (rank << Tl::LOG2K) + (sc >> Tl::LOG2W);
  out.col = col0 + (sc & (W - 1));
  out.live = out.col < P;
  float* sr = smem + sc * Tl::COL_STRIDE;
  run_passes<Tl::LOG2M, 4, 0>(twiddle, sr, sr + Tl::PLANE,
                              threadIdx.x >> Tl::LOG2SUB, out);
}

// Q <= 16: one pass, a thread per column, straight from device memory to
// registers and back.
template <int LOG2Q>
__global__ void __launch_bounds__(kSmallThreads)
fft_cols_small(const float* __restrict__ xr, const float* __restrict__ xi,
               float* __restrict__ yr, float* __restrict__ yi, int P) {
  constexpr int Q = 1 << LOG2Q;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= P) return;
  float ar[Q], ai[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    ar[q] = __ldg(xr + (size_t)q * P + col);
    ai[q] = __ldg(xi + (size_t)q * P + col);
  }
  dft<Q>(ar, ai);
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    yr[(size_t)k * P + col] = ar[k];
    yi[(size_t)k * P + col] = ai[k];
  }
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

template <int LOG2Q>
int launch(const float* xr, const float* xi, float* yr, float* yi,
           const float* twiddle, int P, cudaStream_t stream) {
  if constexpr (PlanOf<LOG2Q>::NP == 1) {
    fft_cols_small<LOG2Q>
        <<<(P + kSmallThreads - 1) / kSmallThreads, kSmallThreads, 0,
           stream>>>(xr, xi, yr, yi, P);
    return static_cast<int>(cudaGetLastError());
  } else {
    using Tl = TileOf<LOG2Q>;
    constexpr int W = 1 << Tl::LOG2W, CL = 1 << Tl::LOG2CL;
    cudaError_t err = cudaFuncSetAttribute(
        fft_cols<LOG2Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tl::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(((P + W - 1) / W) * CL);
    cfg.blockDim = dim3(Tl::THREADS);
    cfg.dynamicSmemBytes = Tl::SMEM;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, fft_cols<LOG2Q>, xr, xi, yr, yi,
                             reinterpret_cast<const float2*>(twiddle), P);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

// Host entry, bound with ctypes.  xr/xi/yr/yi and twiddle (Q complex64,
// ops/pstock.py twiddle_table) are device pointers.  The launch goes on
// `stream` and does not synchronise.  Returns the cudaError_t of the launch
// (0 = success); 1000 flags bad arguments.
extern "C" int pstock_launch(const void* xr, const void* xi, void* yr,
                             void* yi, const void* twiddle, int Q, int P,
                             void* stream) {
  if (Q < 1 || Q > kMaxQ || P <= 0 || (long long)Q * P >= (1LL << 31))
    return 1000;
  const auto* a = static_cast<const float*>(xr);
  const auto* b = static_cast<const float*>(xi);
  auto* c = static_cast<float*>(yr);
  auto* d = static_cast<float*>(yi);
  const auto* w = static_cast<const float*>(twiddle);
  auto st = static_cast<cudaStream_t>(stream);
#define PSTOCK_CASE(L) \
  case L: return launch<L>(a, b, c, d, w, P, st);
  switch (log2_exact(Q)) {
    PSTOCK_CASE(0) PSTOCK_CASE(1) PSTOCK_CASE(2) PSTOCK_CASE(3)
    PSTOCK_CASE(4) PSTOCK_CASE(5) PSTOCK_CASE(6) PSTOCK_CASE(7)
    PSTOCK_CASE(8) PSTOCK_CASE(9) PSTOCK_CASE(10) PSTOCK_CASE(11)
    PSTOCK_CASE(12) PSTOCK_CASE(13) PSTOCK_CASE(14)
    default: return 1000;
  }
#undef PSTOCK_CASE
}
