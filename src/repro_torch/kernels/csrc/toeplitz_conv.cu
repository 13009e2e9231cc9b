// Chunked block-Toeplitz causal convolution for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/toeplitz_conv.py::_toeplitz_kernel.
// The depthwise causal conv y[b, t, d] = sum_{t' <= t} h[d, t - t'] u[b, t', d]
// is cut into chunks of C rows.  Output chunk i gathers the chunk diagonals
// r = 0 .. min(i, K-1), each a C x C Toeplitz product per channel,
//
//   y_i[d] += T_r[d] @ u_{i-r}[d],    T_r[d][a, b] = h[d][rC + a - b],
//
// where a negative lag reads 0 (causality inside the diagonal block) and a
// lag >= L reads 0 (the zero-padded tail chunk).  K = n_chunks is the exact
// conv; a smaller K keeps only the first K chunk diagonals (the banded
// approximation for exponentially decaying Hyena filters).  The epilogue is
// that of repro.core.fftconv._fused_epilogue and of the TPU kernel's
// finalize: skip*u added in fp32, downcast to the output dtype, THEN the
// gate multiplied in the output dtype, so a gated call equals gate * the
// ungated call bit for bit (both instances below sum in one fixed order and
// apply the gate only in the epilogue).
//
// Bound.  The chunked form does C^2 multiply-adds per (chunk pair, row,
// channel): 1.02 GFLOP at B=1, L=1024, D=864, C=128, while the function's
// least time is set by its bytes (~2.6 us at 3.35 TB/s).  On the CUDA
// cores (67 TFLOP/s fp32) the products alone take 15 us; on the tensor
// cores a few.
//
// ---------------------------------------------------------------------------
// bf16 path (tc::toeplitz_tc_kernel): every chunk diagonal as a GEMM on the
// tensor cores.  For channel d and diagonal r,
//
//   Y_d[:, (b, i)] += T_r[d] . U_d[:, (b, i - r)]     for all b, i >= r,
//
// M = C output rows, K = C input rows, N = the B*n columns (b, i), as
// mma.sync.m16n8k8.row.col.f32.tf32 tiles with fp32 sums.  u is bf16, which
// TF32 holds exactly; the taps are rounded to TF32 by cvt.rna (relative
// error <= 2^-11, kernels/toeplitz_conv.py::TOLERANCE derives the bound).
// C is padded to CP = 16, 32, 64, 128 or 256 rows (zero input rows, output
// rows past C dropped), so each instance is fixed at compile time.
//
// A fragments from the tap window.  In the m16n8k8 A layout (lane: g =
// lane / 4, t = lane % 4) a0, a1, a2, a3 hold (row g, k-slot t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4).  The order of a sum is free, so k-slot t
// stands for input row 2t of the k-tile and slot t + 4 for row 2t + 1 (the
// B fragments use the same order).  Then the fragment of tile (m-tile mi,
// k-tile ki) holds the taps x, x + 8, x - 1, x + 7 with
// x = rC + 16 mi - 8 ki + g - 2t: it depends only on s = 2 mi - ki, so a
// 128 x 128 block needs 30 distinct fragments, not 128.  Each warp keeps a
// window of its channel's taps in shared memory, already rounded to TF32,
// as pairs P[w] = (h[W0 + w - 1], h[W0 + w]), so a fragment is two 8-byte
// loads, P[x - W0] = (a2, a0) and P[x + 8 - W0] = (a3, a1); the lanes of a
// quad read overlapping pairs, which are broadcasts.  The next diagonal's
// taps are loaded into registers during this one's products, and paired
// and rounded after them.  The window start W0 and the lane offset are
// kernels/toeplitz_conv.py::tc_window_start and ::tc_fragment_index,
// which the CPU tests replay in numpy.  The warp walks
// s from high to low, loads each fragment once and runs every (mi, ki)
// product with that s; on r = 0 it skips the s whose tiles see only
// negative lags (half of them on the diagonal block).
//
// B fragments from the ring.  A block owns G consecutive channels
// (chosen on the host so that D / G blocks fill the SMs in one wave: G = 7,
// 124 blocks at D = 864) and all B*n columns.  Each channel keeps a ring of
// 16 chunk slots in shared memory: a slot holds one input chunk as CP bf16
// rows, two rows a 32-bit word, so lane (g, t) takes rows 2t and 2t + 1 of
// its column's chunk with one 4-byte load (b0 = the low half << 16, b1 =
// the high half), and slots sit 4 banks apart, which keeps the warp's loads
// conflict-free; each is loaded at the s of its first use, so that about
// 2 MW are live.  The columns go in passes of eight (one n8 tile): a pass
// stages the chunks of its columns, then walks r = 0 .. min(K - 1, its
// largest i); at r, column (b, i) reads chunk (b, i - r), a zero column
// where i < r.  Going from r to r + 1 needs only one new chunk, which is
// loaded during r and stored after it; its slot is one that r does not
// read.  u is staged with the block's threads spread over channels first,
// so global reads stay coalesced over channels, and transposed into the
// per-channel rows on the store.
//
// Accumulators and the epilogue.  A warp owns one channel and a strip of
// MW <= 4 m-tiles (64 rows: 2 warps a channel at CP = 128; 2 m-tiles, 8
// warps at CP = 256): MW x 4 fp32 registers a pass.  After the pass each
// warp writes its tile into a shared-memory buffer (per channel, column
// and row, padded so that both the fragment writes and the reads are
// conflict-free), and the block writes the output rows with consecutive
// channels: every thread starts all its u and gate loads of half the
// pass's columns first, then skip*u in fp32, downcast, gate.
//
// Memory latency.  A diagonal's compute is shorter than a trip to device
// memory, and the barriers keep the block's warps in step, so no other
// warp hides a miss.  The kernel therefore asks L2 for what it will read
// before it needs it (prefetch.global.L2, a hint that holds no register):
// the block's taps at the start, and at the start of each pass the u rows
// of the next pass and the gate rows of its epilogue.
//
// Shared memory: G rings (16 slots of CP/2 + pad words), G output buffers
// (8 columns of CP + pad floats) and one tap window per warp (2 CP + pad
// pairs at most): 82 KB at CP = 128, G = 7 and 69 KB at CP = 256, G = 2,
// one block of up to 16 warps an SM.  kernels/toeplitz_conv.py::
// tc_launch_shape computes the same plan, and toeplitz_tc_smem_bytes lets
// it check.
//
// What bounds it: the rate of mma.sync and of the shared-memory loads
// that feed it (per warp and diagonal 22 A fragments and 16 B-operand
// words for 64 products at CP = 128), and the latency left at each diagonal's
// barrier.  PERF.md has the measurements.
//
// ---------------------------------------------------------------------------
// fp32 path (toeplitz_conv_kernel): the CUDA-core kernel, kept for its
// 1e-4 agreement, which TF32 would not hold.  One block per (channel tile
// of TD = 32, output chunk i, batch row) loops over its diagonals, stages
// u_{i-r} (Cp x TD, Cp = C rounded up to 16) and the 2Cp-1 taps
// h[rC - Cp + 1 .. rC + Cp - 1] of each channel in shared memory as fp32;
// thread (tx, ty) owns channel tx and the ROWS = 16 consecutive output rows
// 16*ty .., whose sums stay in fp32 registers across every diagonal.  For
// a block of BB = 16 input rows the taps a thread needs are one window of
// 31 values, so 16 + 31 shared loads feed 256 FMAs.  It is bound by its own
// fp32 FMAs.
//
// Strides.  u and gate may be any view whose channel dim is unit-stride
// (torch.split's views of the projection, on the model path); h may be a
// view of wider rows (the max_len filter sliced to L).  The kernels launch
// on the caller's stream and allocate nothing.  The C entry points return
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

#define MAX_C 256  // largest chunk
#define MAX_DEVICES 64

// Raise a kernel's dynamic shared-memory limit on the current device, once
// per device and again only for a launch that needs more; `raised` is that
// kernel instance's own record per device.
static cudaError_t allow_smem(const void* kernel, int bytes, int* raised) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  static std::mutex mu;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(mu);
  if (bytes > raised[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    raised[dev] = bytes;
  }
  return cudaSuccess;
}

// ------------------------------------------------------------ CUDA-core path

#define TD 32    // channels per block, one per lane
#define ROWS 16  // output rows per thread
#define BB 16    // input rows per register block

// u[b, t, d] at b*su_b + t*su_t + d; gate likewise; h[d, lag] at d*sh_d + lag;
// out is contiguous (B, L, D).
__global__ void __launch_bounds__(MAX_C / ROWS * TD)
toeplitz_conv_kernel(const float* __restrict__ u, const float* __restrict__ h,
                     const float* __restrict__ skip, const float* __restrict__ gate,
                     float* __restrict__ out, int L, int D, int C, int Cp, int K,
                     int64_t su_b, int64_t su_t, int64_t sg_b, int64_t sg_t,
                     int64_t sh_d) {
  extern __shared__ float smem[];
  float* us = smem;              // [Cp][TD]      u chunk i - r
  float* ts = smem + Cp * TD;    // [2Cp-1][TD+1] taps, s = a - b + Cp - 1
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TD + tx;
  const int nthreads = TD * blockDim.y;
  const int d0 = blockIdx.x * TD;
  const int i = blockIdx.y;
  const int b = blockIdx.z;
  const int a0 = ty * ROWS;
  const int n_taps = 2 * Cp - 1;
  const float* ub = u + (int64_t)b * su_b;

  float acc[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) acc[j] = 0.f;

  const int last = min(i, K - 1);
  for (int r = 0; r <= last; ++r) {
    const int j0 = (i - r) * C;  // first row of input chunk i - r
    __syncthreads();             // the previous diagonal's reads are done
    for (int e = tid; e < Cp * TD; e += nthreads) {
      const int q = e / TD, c = e - q * TD;
      const int t = j0 + q, d = d0 + c;
      us[e] = (q < C && t < L && d < D) ? ub[(int64_t)t * su_t + d] : 0.f;
    }
    for (int e = tid; e < n_taps * TD; e += nthreads) {
      const int c = e / n_taps, s = e - c * n_taps;
      const int lag = r * C + s - (Cp - 1), d = d0 + c;
      ts[s * (TD + 1) + c] =
          (lag >= 0 && lag < L && d < D) ? __ldg(h + (int64_t)d * sh_d + lag) : 0.f;
    }
    __syncthreads();
    // on the diagonal block (r = 0) input rows past a thread's last row
    // meet only negative lags
    const int b_end = (r == 0) ? min(Cp, a0 + ROWS) : Cp;
    for (int b0 = 0; b0 < b_end; b0 += BB) {
      float uv[BB];
#pragma unroll
      for (int q = 0; q < BB; ++q) uv[q] = us[(b0 + q) * TD + tx];
      // tap index of (row a0 + jj, input row b0 + q) is base + jj - q + BB - 1
      const int base = a0 - b0 - (BB - 1) + Cp - 1;
      float w[ROWS + BB - 1];
#pragma unroll
      for (int m = 0; m < ROWS + BB - 1; ++m) w[m] = ts[(base + m) * (TD + 1) + tx];
#pragma unroll
      for (int q = 0; q < BB; ++q) {
#pragma unroll
        for (int jj = 0; jj < ROWS; ++jj) acc[jj] = fmaf(w[jj - q + BB - 1], uv[q], acc[jj]);
      }
    }
  }

  const int d = d0 + tx;
  if (d >= D) return;
  const float* gb = gate == nullptr ? nullptr : gate + (int64_t)b * sg_b;
  float* ob = out + (int64_t)b * L * D;
  const float sk = skip == nullptr ? 0.f : skip[d];
#pragma unroll
  for (int jj = 0; jj < ROWS; ++jj) {
    const int a = a0 + jj;
    const int t = i * C + a;
    if (a < C && t < L) {
      float y = acc[jj];
      if (skip != nullptr) y = y + ub[(int64_t)t * su_t + d] * sk;
      if (gb != nullptr) y = y * gb[(int64_t)t * sg_t + d];
      ob[(int64_t)t * D + d] = y;
    }
  }
}

static int core_smem_bytes(int Cp) {
  return (Cp * TD + (2 * Cp - 1) * (TD + 1)) * (int)sizeof(float);
}

static int launch_core(const void* u, const float* h, const float* skip, const void* gate,
                       void* out, int B, int L, int D, int C, int K, int64_t su_b,
                       int64_t su_t, int64_t sg_b, int64_t sg_t, int64_t sh_d,
                       void* stream) {
  if (C < 1 || C > MAX_C || K < 1 || B < 1 || L < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const int Cp = (C + BB - 1) / BB * BB;
  const int smem = core_smem_bytes(Cp);
  static int raised[MAX_DEVICES] = {0};
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(toeplitz_conv_kernel), smem, raised);
  if (e != cudaSuccess) return (int)e;
  const int n_chunks = (L + C - 1) / C;
  dim3 grid((D + TD - 1) / TD, n_chunks, B);
  dim3 block(TD, Cp / ROWS);
  toeplitz_conv_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)u, h, skip, (const float*)gate, (float*)out, L, D, C, Cp, K, su_b,
      su_t, sg_b, sg_t, sh_d);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------- tensor-core path

namespace tc {

constexpr int RING = 16;       // chunk slots per channel
constexpr int COLS = 8;        // output columns per pass: one n8 tile
constexpr int MAX_WARPS = 16;  // warps a block
constexpr int MW_MAX = 4;      // m-tiles a warp
constexpr unsigned FULL = 0xffffffffu;

// the smallest m >= n with m = 4 (mod 32): a row stride that puts eight
// consecutive rows, or slots, 4 banks apart
__host__ __device__ constexpr int pad4(int n) { return (n + 27) / 32 * 32 + 4; }

// The plan of an instance with CP padded rows (kernels/toeplitz_conv.py
// tc_launch_shape computes the same numbers).
template <int CP> struct Plan {
  static constexpr int KT = CP / 8;                     // k-tiles
  // m-tiles a warp: MW_MAX, 2 at CP = 256, where 32 k-tiles need the
  // registers (4 spills), and CP / 16 below 64 rows
  static constexpr int MW = CP == 256 ? 2 : CP / 16 < MW_MAX ? CP / 16 : MW_MAX;
  static constexpr int STRIPS = CP / 16 / MW;           // warps a channel
  static constexpr int CW = pad4(CP / 2);               // words a ring slot
  static constexpr int CHS = RING * CW + 4;             // words a ring
  static constexpr int RS = pad4(CP);                   // floats an output column
  static constexpr int PL = COLS * RS + 4;              // floats a channel's output
  static constexpr int S_LO = -(KT - 1), S_HI = 2 * (MW - 1);
  static constexpr int WSP = (8 * (S_HI - S_LO) + 22 + 31) / 32 * 32;  // window pairs
  static constexpr int NQ = WSP / 32;                   // window pairs a lane
  static constexpr int EPT = (CP + 32 * STRIPS - 1) / (32 * STRIPS);  // chunk rows a thread
  static int smem_bytes(int G) {
    return 4 * G * (CHS + PL) + 8 * WSP * G * STRIPS;
  }
};

__device__ __forceinline__ float rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// c (16 x 8, fp32) += a (16 x 8, tf32, row-major) . b (8 x 8, tf32, col-major)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_f32(uint16_t x) { return __uint_as_float((uint32_t)x << 16); }

// ask L2 for the line of p ahead of its use (a hint: it holds no register
// and never faults)
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// u[b, t, d] at b*su_b + t*su_t + d; gate likewise; h[d, lag] at d*sh_d + lag;
// out is contiguous (B, L, D).  One block per G channels d0 = blockIdx.x*G ..;
// warp w owns channel w / STRIPS and row strip w % STRIPS.
template <int CP>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
toeplitz_tc_kernel(const uint16_t* __restrict__ u, const float* __restrict__ h,
                   const float* __restrict__ skip, const uint16_t* __restrict__ gate,
                   uint16_t* __restrict__ out, int B, int L, int D, int C, int K, int G,
                   int64_t su_b, int64_t su_t, int64_t sg_b, int64_t sg_t, int64_t sh_d) {
  using P = Plan<CP>;
  constexpr int MW = P::MW, KT = P::KT, STRIPS = P::STRIPS;
  constexpr int CW = P::CW, CHS = P::CHS, RS = P::RS, PL = P::PL;
  constexpr int S_LO = P::S_LO, S_HI = P::S_HI, WSP = P::WSP, NQ = P::NQ, EPT = P::EPT;

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ring = smem;                                // [G][CHS] words
  float* obuf = reinterpret_cast<float*>(smem + G * CHS);  // [G][PL]
  float2* wins = reinterpret_cast<float2*>(smem + G * (CHS + PL));  // [warps][WSP]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ch = warp / STRIPS;
  const int mi0 = (warp - ch * STRIPS) * MW;  // the strip's first m-tile
  const int d0 = blockIdx.x * G;
  const bool live = d0 + ch < D;
  const float* hd = h + (int64_t)(live ? d0 + ch : 0) * sh_d;
  const int n = (L + C - 1) / C;
  const int BN = B * n;
  float2* win = wins + warp * WSP;
  const float2* frag = win + (g - 2 * t + 6);  // tc_fragment_index
  uint16_t* ring16 = reinterpret_cast<uint16_t*>(ring);

  // the chunk rows this thread stages: element e = tid + k*nthreads of a
  // chunk's CP x G values, channels fastest (coalesced global reads)
  auto load_chunk = [&](int q, uint16_t (&v)[EPT]) {
    const int b = q / n, t0 = (q - b * n) * C;
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      const int e = tid + k * nthreads, a = e / G, d = d0 + e - a * G, tt = t0 + a;
      v[k] = (a < C && tt < L && d < D) ? __ldg(u + b * su_b + tt * su_t + d) : (uint16_t)0;
    }
  };
  auto store_chunk = [&](int q, const uint16_t (&v)[EPT]) {
    const int slot = q & (RING - 1);
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      const int e = tid + k * nthreads, a = e / G;
      if (a < CP) ring16[(e - a * G) * 2 * CHS + slot * 2 * CW + a] = v[k];
    }
  };

  // the tap window of diagonal r: pairs (h[x - 1], h[x]) for
  // x = W0 + w, W0 = tc_window_start; zero outside 0 <= x < L.  Lane l
  // loads h[W0 + l + 32q] into registers, and the pairs are built with
  // shuffles when they are stored
  float tv[NQ], tedge;
  auto load_taps = [&](int r) {
    const int w0 = r * C + 16 * mi0 + 8 * S_LO - 6;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int x = w0 + lane + 32 * q;
      tv[q] = (live && x >= 0 && x < L) ? __ldg(hd + x) : 0.f;
    }
    tedge = (live && w0 >= 1 && w0 <= L) ? __ldg(hd + w0 - 1) : 0.f;
  };
  auto store_taps = [&]() {
    float carry = rna(tedge);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float hi = rna(tv[q]);
      float lo = __shfl_up_sync(FULL, hi, 1);
      if (lane == 0) lo = carry;
      carry = __shfl_sync(FULL, hi, 31);
      win[lane + 32 * q] = make_float2(lo, hi);
    }
  };

  // the block's taps into L2 (the lags the diagonals read, 32 floats a
  // line), so that each diagonal's window loads hit L2
  {
    const int lags = min(L, K * C + CP), lines = (lags + 31) / 32;
    for (int i = tid; i < G * lines; i += nthreads) {
      const int c = i / lines, line = i - c * lines;
      if (d0 + c < D) prefetch_l2(h + (int64_t)(d0 + c) * sh_d + 32 * line);
    }
  }
  // the rows of pass c0's columns: u's (to stage) and the gate's (for the
  // epilogue), one line a row of the block's channels
  auto prefetch_rows = [&](int c0, bool with_u) {
    for (int i = tid; i < COLS * C; i += nthreads) {
      const int j = i / C, a = i - j * C, c = c0 + j;
      if (c >= BN) break;
      const int b = c / n, tt = (c - b * n) * C + a;
      if (tt >= L) continue;
      if (with_u) prefetch_l2(u + b * su_b + tt * su_t + d0);
      if (gate != nullptr) prefetch_l2(gate + b * sg_b + tt * sg_t + d0);
    }
  };
  prefetch_rows(0, false);

  for (int c0 = 0; c0 < BN; c0 += COLS) {
    if (c0 + COLS < BN) prefetch_rows(c0 + COLS, true);
    // this lane's output column (b, i) = c0 + g, and the pass's last diagonal
    const int cg = c0 + g;
    const bool col_ok = cg < BN;
    const int ig = cg % n;
    const int ic0 = c0 % n;
    int i_max = 0;
    for (int j = 0; j < COLS && c0 + j < BN; ++j) i_max = max(i_max, (c0 + j) % n);
    const int r_last = min(K - 1, i_max);

    {  // stage the pass's chunks c0 .. c0 + 7 and diagonal 0's taps
      uint16_t v[COLS][EPT];
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        if (c0 + j < BN) load_chunk(c0 + j, v[j]);
      load_taps(0);
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        if (c0 + j < BN) store_chunk(c0 + j, v[j]);
      store_taps();
    }
    float acc[MW][4];
#pragma unroll
    for (int mm = 0; mm < MW; ++mm)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mm][k] = 0.f;
    __syncthreads();

    for (int r = 0; r <= r_last; ++r) {
      const bool more = r < r_last;
      // the one chunk that diagonal r + 1 adds: c0 - r - 1, read by column
      // c0 only, when it lies in c0's batch row
      const bool fetch = more && ic0 >= r + 1;
      uint16_t pv[EPT];
      if (fetch) load_chunk(c0 - r - 1, pv);
      if (more) load_taps(r + 1);

      // B fragments: rows 2t, 2t + 1 of each k-tile of chunk cg - r, each
      // loaded at the s of its first use (k-tile 2(MW - 1) - s), so that
      // about 2 MW of them are live at once
      uint32_t bq[KT];
      const bool bok = col_ok && ig >= r;
      const uint32_t* col = ring + ch * CHS + ((cg - r) & (RING - 1)) * CW + t;

#pragma unroll
      for (int s = S_HI; s >= S_LO; --s) {
        // on the diagonal block, tiles with 2 mi - ki <= -2 see only
        // negative lags (and so do those of every smaller s)
        if (r == 0 && 2 * mi0 + s < -1) continue;
        const int kn = 2 * (MW - 1) - s;
        if (kn < KT) bq[kn] = bok ? col[4 * kn] : 0u;
        const float2 p0 = frag[8 * (s - S_LO)];
        const float2 p1 = frag[8 * (s - S_LO) + 8];
        const uint32_t a[4] = {__float_as_uint(p0.y), __float_as_uint(p1.y),
                               __float_as_uint(p0.x), __float_as_uint(p1.x)};
#pragma unroll
        for (int mm = 0; mm < MW; ++mm) {
          const int ki = 2 * mm - s;
          if (ki >= 0 && ki < KT) mma(acc[mm], a, bq[ki] << 16, bq[ki] & 0xffff0000u);
        }
      }

      if (more) {
        __syncwarp();
        store_taps();
      }
      if (fetch) store_chunk(c0 - r - 1, pv);
      __syncthreads();
    }

    // the tile through shared memory: obuf[ch][column][row]
    float* ob = obuf + ch * PL;
#pragma unroll
    for (int mm = 0; mm < MW; ++mm) {
      const int row = 16 * (mi0 + mm) + g;
      ob[(2 * t) * RS + row] = acc[mm][0];
      ob[(2 * t + 1) * RS + row] = acc[mm][1];
      ob[(2 * t) * RS + row + 8] = acc[mm][2];
      ob[(2 * t + 1) * RS + row + 8] = acc[mm][3];
    }
    __syncthreads();
    // the output rows, channels fastest (element e = tid + k*nthreads of a
    // column's C x G, as in staging), half a pass's columns at a time: every
    // load of the half first, then skip*u in fp32, downcast, gate
    constexpr int HALF = COLS / 2;
    float sk[EPT];
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      const int e = tid + k * nthreads, d = d0 + e - e / G * G;
      sk[k] = (skip != nullptr && d < D) ? skip[d] : 0.f;
    }
#pragma unroll
    for (int j0 = 0; j0 < COLS; j0 += HALF) {
      uint16_t uv[HALF][EPT], gv[HALF][EPT];
#pragma unroll
      for (int j = 0; j < HALF; ++j) {
        const int c = c0 + j0 + j, b = c / n, t0 = (c - b * n) * C;
#pragma unroll
        for (int k = 0; k < EPT; ++k) {
          const int e = tid + k * nthreads, a = e / G, d = d0 + e - a * G, tt = t0 + a;
          const bool ok = c < BN && a < C && tt < L && d < D;
          uv[j][k] = (ok && skip != nullptr) ? u[b * su_b + tt * su_t + d] : (uint16_t)0;
          gv[j][k] = (ok && gate != nullptr) ? gate[b * sg_b + tt * sg_t + d] : (uint16_t)0;
        }
      }
#pragma unroll
      for (int j = 0; j < HALF; ++j) {
        const int c = c0 + j0 + j, b = c / n, t0 = (c - b * n) * C;
#pragma unroll
        for (int k = 0; k < EPT; ++k) {
          const int e = tid + k * nthreads, a = e / G, cc = e - a * G, tt = t0 + a;
          if (c >= BN || a >= C || tt >= L || d0 + cc >= D) continue;
          float y = obuf[cc * PL + (j0 + j) * RS + a];
          if (skip != nullptr) y = y + bf16_f32(uv[j][k]) * sk[k];
          uint16_t o = __bfloat16_as_ushort(__float2bfloat16_rn(y));
          if (gate != nullptr)
            o = __bfloat16_as_ushort(__float2bfloat16_rn(bf16_f32(o) * bf16_f32(gv[j][k])));
          out[((int64_t)b * L + tt) * D + d0 + cc] = o;
        }
      }
    }
    // the next pass's staging writes the rings and windows, which no thread
    // reads after the last diagonal's barrier; its barrier orders this
    // epilogue's reads of obuf before the next tile's writes
  }
}

template <int CP>
static int launch(const void* u, const float* h, const float* skip, const void* gate,
                  void* out, int B, int L, int D, int C, int K, int G, int64_t su_b,
                  int64_t su_t, int64_t sg_b, int64_t sg_t, int64_t sh_d, void* stream) {
  using P = Plan<CP>;
  if (G < 1 || G * P::STRIPS > MAX_WARPS) return (int)cudaErrorInvalidValue;
  const int smem = P::smem_bytes(G);
  static int raised[MAX_DEVICES] = {0};
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(toeplitz_tc_kernel<CP>), smem, raised);
  if (e != cudaSuccess) return (int)e;
  const int grid = (D + G - 1) / G;
  toeplitz_tc_kernel<CP><<<grid, 32 * G * P::STRIPS, smem, (cudaStream_t)stream>>>(
      (const uint16_t*)u, h, skip, (const uint16_t*)gate, (uint16_t*)out, B, L, D, C, K, G,
      su_b, su_t, sg_b, sg_t, sh_d);
  return (int)cudaGetLastError();
}

// CP of a chunk of C rows: the power of two >= max(C, 16)
static int padded_rows(int C) {
  int cp = 16;
  while (cp < C) cp *= 2;
  return cp;
}

}  // namespace tc

extern "C" {

int toeplitz_conv_f32(const void* u, const float* h, const float* skip, const void* gate,
                      void* out, int B, int L, int D, int C, int K, int64_t su_b,
                      int64_t su_t, int64_t sg_b, int64_t sg_t, int64_t sh_d,
                      void* stream) {
  return launch_core(u, h, skip, gate, out, B, L, D, C, K, su_b, su_t, sg_b, sg_t, sh_d,
                     stream);
}

int toeplitz_tc_bf16(const void* u, const float* h, const float* skip, const void* gate,
                     void* out, int B, int L, int D, int C, int K, int G, int64_t su_b,
                     int64_t su_t, int64_t sg_b, int64_t sg_t, int64_t sh_d, void* stream) {
  if (C < 1 || C > MAX_C || K < 1 || B < 1 || L < 1 || D < 1) return (int)cudaErrorInvalidValue;
  switch (tc::padded_rows(C)) {
#define TC_CASE(CP)                                                                       \
  case CP:                                                                                \
    return tc::launch<CP>(u, h, skip, gate, out, B, L, D, C, K, G, su_b, su_t, sg_b, sg_t, \
                          sh_d, stream);
    TC_CASE(16)
    TC_CASE(32)
    TC_CASE(64)
    TC_CASE(128)
    TC_CASE(256)
#undef TC_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of the tensor-core instance for chunks of C rows
// and G channels a block (-1 past MAX_C)
int toeplitz_tc_smem_bytes(int C, int G) {
  switch (tc::padded_rows(C)) {
    case 16: return tc::Plan<16>::smem_bytes(G);
    case 32: return tc::Plan<32>::smem_bytes(G);
    case 64: return tc::Plan<64>::smem_bytes(G);
    case 128: return tc::Plan<128>::smem_bytes(G);
    case 256: return tc::Plan<256>::smem_bytes(G);
  }
  return -1;
}

const char* toeplitz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int toeplitz_max_chunk(void) { return MAX_C; }

}  // extern "C"
