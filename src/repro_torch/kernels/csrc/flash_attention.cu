// Causal / windowed GQA attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call in flash_attention()).  For q (B, H, Lq, Dh) and k, v
// (B, Hkv, Lk, Dh), query head h reads KV head h / (H / Hkv), and
//
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, hk, j] + mask) v[b, hk, j]
//
// where query row i sits at position qpos = q_offset + i and sees key j iff
// j <= qpos (causal) and j > qpos - window (a window; 0 = none).  The
// running max, sum and accumulator are fp32, and a row that sees no key
// gives 0 (the TPU kernel's l == 0 guard).  The output is written in the
// input dtype.  Both paths below share the grid: the TPU grid (B, H,
// q_block, kv_block) runs its kv blocks in order on one core and carries
// (m, l, acc) across them in VMEM; CUDA blocks run in parallel and share
// nothing, so one block owns 64 query rows of one (query head, batch row)
// and loops over the key tiles itself.  Key tiles that the causal or window
// mask covers completely for every row of the block are never loaded (the
// TPU kernel's pl.when(valid)), so the work scales with the unmasked area;
// under a causal mask the last query blocks see the most keys, so the grid
// puts the query block on its slowest axis, reversed, and the heaviest
// blocks start first.
//
// Bound.  A causal call does 4 * Dh * B * H * (Lq * Lk - Lq^2 / 2)
// operations (two products of a multiply and an add per visible (i, j)); at
// B = 4, H = 24, L = 1024, Dh = 128 that is 25.8 GFLOP, 26 us on the bf16
// tensor cores at 989 TFLOP/s, while q, k, v and o move 67 MB (20 us at
// 3.35 TB/s).  So the function is bound by operations, and only the tensor
// cores come near its bound.
//
// bf16 path (tc::attention_kernel): the two products on the tensor cores.
// A block is one warpgroup, 4 warps of 16 query rows each.  q is staged
// once in shared memory and, for Dh <= 128, its mma A-fragments are kept in
// registers (Dh = 256 reads them by ldmatrix per k-step).  K and V come in
// tiles of 64 keys (32 at Dh = 256, for registers) through a two-stage ring
// in shared memory, in bf16, copied by cp.async.cg 16 bytes a thread; the
// copy of tile t + 1 is issued before the math of tile t.  Every tile
// (q, K, V, the output staging) is laid out as Dh / 64 panels of 128-byte
// rows whose 16-byte chunks are XOR-swizzled by row % 8: TMA's 128-byte
// swizzle, so that ldmatrix reads and the copies are free of bank conflicts
// and a later TMA load fills the same layout.  S = q . K^T runs as
// mma.sync m16n8k16 bf16 x bf16 -> fp32 with K fragments from ldmatrix.
// The products are of unscaled bf16 q; the fp32 scores are multiplied by
// scale * log2(e) and exponentiated by ex2.approx (relative error ~2^-22),
// the same function as the plain version's "scale q in fp32, then dot" up
// to fp32 rounding.  The online softmax works on the accumulator fragment:
// a thread holds two rows' scores, and a row max takes two shuffles within
// the quad that shares the row (the row sum is kept per thread and reduced
// once at the end).  The mask is evaluated only on tiles it cuts.  P is
// rounded to bf16 in registers, and the m16n8k16 C-fragment layout is used
// directly as the A-fragment of O += P . V, with V fragments from
// ldmatrix.trans of the row-major V tile; O is rescaled by
// exp2(m_old - m_new) only when a row max of the warp moved.  The epilogue
// divides by l (0 where l == 0), converts to bf16, stages the rows in
// shared memory where q was, and stores 16 bytes a thread.  The kernel
// rounds P to bf16 (relative error <= 2^-8) before P . V, as every
// tensor-core flash kernel does, so it differs from the plain version by up
// to 2^-8 * sum_j p_j |v_j| plus the output's own bf16 rounding
// (kernels/flash_attention.py::TOLERANCE).  Where a q, k or v view's row
// starts or strides are not 16-byte aligned, the wrapper picks the
// ALIGNED = false instance, which stages the same tiles element by element
// into the same layout.
//
// What bounds the bf16 path now: with 16 rows a warp, each ldmatrix.x4 of K
// or V (512 bytes) feeds two mma, so the shared-memory operand reads (128
// bytes a clock per SM) weigh as much as the mma.sync work itself, and two
// blocks an SM (shared memory and ~230 registers a thread) leave 8 warps
// to hide latency.  It runs at about a fifth of the operations bound and a
// few times SDPA's time (PERF.md, chip_smoke.py phase 4).  A three-stage
// ring with one barrier a tile showed no clear gain on the H100, so the
// ring keeps two stages.
//
// fp32 path (flash_attention_kernel): the CUDA-core kernel.  The block's
// eight warps own 8 query rows each; it stages its rows of q, scaled, and
// per tile 32 rows of K and V as fp32 in shared memory.  For q.k^T lane j
// takes key j of the tile: per four head-dim columns it reads one float4 of
// its key (the K tile's rows are padded to Dh + 4 floats so that a
// quarter-warp's float4 reads hit 32 distinct banks) and one broadcast
// float4 of q per row, for 32 FMAs.  The online-softmax update is a warp
// max and a warp sum per row.  For p.v the lanes own head-dim columns
// lane + 32c: the warp writes its probabilities to shared memory transposed
// (p[j][r]), and per key a lane reads them as two broadcast float4 and one
// V value per column, for R FMAs each.  Shared-memory bandwidth and the FMA
// rate bound it; fp32 inputs keep their 1e-5 agreement with the plain
// version.
//
// Left for later on the bf16 path: wgmma with shared-memory descriptors,
// TMA loads with mbarriers, producer/consumer warp specialisation, packing
// the G query heads of one KV head into a block, and a backward pass.
//
// Strides.  q, k, v and o may be any views whose head-dim is unit-stride:
// the model passes its (B, L, H, Dh) projections transposed to (B, H, L, Dh)
// without a copy, and the wrapper allocates o as (B, Lq, H, Dh) so that the
// output projection reads it without one.  The kernel launches on the
// caller's stream and allocates nothing; the C entry points return
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#define BQ 64      // query rows per block
#define BK 32      // keys per tile, one per lane for q.k^T
#define R 8        // query rows per warp
#define NWARPS (BQ / R)
#define NTHREADS (NWARPS * 32)
#define MAX_DEVICES 64

static constexpr float NEG_INF = -1e30f;
static_assert(R == 8, "p.v reads a row's 8 probabilities as two float4");

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DH>
struct Smem {
  static constexpr int KSTRIDE = DH + 4;  // padded K rows: conflict-free float4 reads
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * DH;
  static constexpr int V = K + BK * KSTRIDE;
  static constexpr int P = V + BK * DH;
  static constexpr int FLOATS = P + NWARPS * BK * R;
  static constexpr int BYTES = FLOATS * (int)sizeof(float);
};

// x[b, h, t, d] at b*s_b + h*s_h + t*s_t + d, for q, k, v and o alike
template <typename T, int DH>
__global__ void __launch_bounds__(NTHREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int G, int Lq,
                       int Lk, float scale, int causal, int window, int q_offset,
                       int64_t sq_b, int64_t sq_h, int64_t sq_t, int64_t sk_b,
                       int64_t sk_h, int64_t sk_t, int64_t sv_b, int64_t sv_h,
                       int64_t sv_t, int64_t so_b, int64_t so_h, int64_t so_t) {
  constexpr int NV = DH / 32;  // head-dim columns per lane in p.v
  using S = Smem<DH>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem + S::Q;  // [BQ][DH]          scaled q
  float* ks = smem + S::K;  // [BK][DH + 4]      K tile
  float* vs = smem + S::V;  // [BK][DH]          V tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* ps = smem + S::P + warp * BK * R;  // [BK][R] this warp's p, transposed

  const int h = blockIdx.x, b = blockIdx.y;
  const int iq = gridDim.z - 1 - blockIdx.z;  // heaviest query blocks first
  const int hk = h / G;
  const int row0 = iq * BQ;
  const int rows = min(BQ, Lq - row0);
  const T* qb = q + (int64_t)b * sq_b + (int64_t)h * sq_h;
  const T* kb = k + (int64_t)b * sk_b + (int64_t)hk * sk_h;
  const T* vb = v + (int64_t)b * sv_b + (int64_t)hk * sv_h;

  // the keys any row of the block can see
  const int qpos_first = q_offset + row0;
  const int qpos_last = q_offset + row0 + rows - 1;
  const int k_begin = window > 0 ? max(0, qpos_first - window + 1) : 0;
  const int k_end = causal ? min(Lk, qpos_last + 1) : Lk;
  const int t_begin = k_begin / BK;
  const int t_end = k_end > k_begin ? (k_end + BK - 1) / BK : t_begin;

  for (int e = tid; e < BQ * DH; e += NTHREADS) {
    const int r = e / DH, d = e - r * DH;
    qs[e] = r < rows ? to_f32(qb[(int64_t)(row0 + r) * sq_t + d]) * scale : 0.f;
  }

  const int wr0 = warp * R;  // this warp's first row in the block
  const bool warp_active = wr0 < rows;
  float m[R], l[R], acc[R][NV];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) acc[r][c] = 0.f;
  }

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // q is staged; the previous tile's reads are done
    for (int e = tid; e < BK * DH; e += NTHREADS) {
      const int j = e / DH, d = e - j * DH;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < Lk) {
        kv = to_f32(kb[(int64_t)key * sk_t + d]);
        vv = to_f32(vb[(int64_t)key * sv_t + d]);
      }
      ks[j * S::KSTRIDE + d] = kv;
      vs[j * DH + d] = vv;
    }
    __syncthreads();
    if (!warp_active) continue;

    // scores: lane j takes key k0 + j against the warp's R rows
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(ks + lane * S::KSTRIDE);
    const float4* qrow = reinterpret_cast<const float4*>(qs + wr0 * DH);
#pragma unroll 4
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      const float4 kk = krow[d4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qq = qrow[r * (DH / 4) + d4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    // online softmax, one row at a time across the warp
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qpos = qpos_first + wr0 + r;
      const bool seen = key < Lk && (!causal || key <= qpos) &&
                        (window <= 0 || key > qpos - window);
      const float sv = seen ? s[r] : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float p = seen ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NV; ++c) acc[r][c] *= alpha;
      ps[lane * R + r] = p;
    }
    __syncwarp();

    // p.v: lanes own head-dim columns lane + 32c
    for (int j = 0; j < BK; ++j) {
      const float4 p0 = reinterpret_cast<const float4*>(ps + j * R)[0];
      const float4 p1 = reinterpret_cast<const float4*>(ps + j * R)[1];
      const float pr[R] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const float vv = vs[j * DH + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][c] = fmaf(pr[r], vv, acc[r][c]);
      }
    }
    __syncwarp();  // the next tile overwrites ps
  }

  if (!warp_active) return;
  T* ob = o + (int64_t)b * so_b + (int64_t)h * so_h;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (wr0 + r >= rows) break;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    T* orow = ob + (int64_t)(row0 + wr0 + r) * so_t;
#pragma unroll
    for (int c = 0; c < NV; ++c) orow[lane + 32 * c] = from_f32<T>(acc[r][c] / denom);
  }
}

// Raise a kernel's dynamic shared-memory limit once per device, on the
// first launch that needs more than the default 48 KB; `raised` is that
// kernel instance's own flag per device.
static cudaError_t allow_smem(const void* kernel, int bytes, bool* raised) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  static std::mutex mu;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(mu);
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    raised[dev] = true;
  }
  return cudaSuccess;
}

static bool shape_ok(int B, int H, int Hkv, int Lq, int Lk, int window) {
  return B >= 1 && H >= 1 && Hkv >= 1 && H % Hkv == 0 && Lq >= 1 && Lk >= 1 && window >= 0 &&
         H <= 65535 && B <= 65535 && (Lq + 63) / 64 <= 65535;
}

template <typename T, int DH>
static int launch_dh(const void* q, const void* k, const void* v, void* o, int B, int H,
                     int G, int Lq, int Lk, float scale, int causal, int window,
                     int q_offset, const int64_t* st, void* stream) {
  static bool raised[MAX_DEVICES] = {false};
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(flash_attention_kernel<T, DH>),
                             Smem<DH>::BYTES, raised);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B, (Lq + BQ - 1) / BQ);
  flash_attention_kernel<T, DH><<<grid, NTHREADS, Smem<DH>::BYTES, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, G, Lq, Lk, scale, causal, window,
      q_offset, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11]);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                  int Hkv, int Lq, int Lk, int Dh, float scale, int causal, int window,
                  int q_offset, const int64_t* st, void* stream) {
  if (!shape_ok(B, H, Hkv, Lq, Lk, window)) return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  switch (Dh) {
    case 64:
      return launch_dh<T, 64>(q, k, v, o, B, H, G, Lq, Lk, scale, causal, window, q_offset, st, stream);
    case 128:
      return launch_dh<T, 128>(q, k, v, o, B, H, G, Lq, Lk, scale, causal, window, q_offset, st, stream);
    case 256:
      return launch_dh<T, 256>(q, k, v, o, B, H, G, Lq, Lk, scale, causal, window, q_offset, st, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#undef BQ
#undef BK
#undef R
#undef NWARPS
#undef NTHREADS

// ---------------------------------------------------------------- bf16 path

namespace tc {

constexpr int WARPS = 4;  // one warpgroup
constexpr int THREADS = WARPS * 32;
constexpr int QROWS = WARPS * 16;  // query rows per block, 16 per warp
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Shape {
  static constexpr int KEYS = DH == 256 ? 32 : 64;  // keys per K / V tile
  static constexpr int STAGES = 2;                   // depth of the K / V ring
  static constexpr int Q_BYTES = QROWS * DH * 2;
  static constexpr int TILE_BYTES = KEYS * DH * 2;
  static constexpr int BYTES = Q_BYTES + 2 * STAGES * TILE_BYTES;
  static_assert(Q_BYTES % 1024 == 0 && TILE_BYTES % 1024 == 0,
                "every tile starts on a 1024-byte swizzle atom");
};

// Byte offset of 16-byte chunk c (head-dim columns 8c .. 8c + 7) of row r
// in a tile of ROWS rows.  The tile is DH / 64 panels of ROWS rows of 128
// bytes; inside a panel the chunk sits at (c % 8) ^ (r % 8): TMA's 128-byte
// swizzle.  The 8 rows an ldmatrix reads at one logical chunk land in 8
// distinct chunks, all 32 banks.
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((((c >> 3) * ROWS + r) << 7) | (((c & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 fills zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row-major) . b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit; 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 -> one register of two bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows r0 .. r0 + ROWS - 1 of g (row stride `stride` elements) into a tile
// at smem; rows from `valid` on are zero-filled.  ALIGNED: one 16-byte
// cp.async per chunk (the caller commits); else element by element.
template <int ROWS, int DH, bool ALIGNED>
__device__ __forceinline__ void load_tile(uint8_t* smem, const uint16_t* g, int64_t stride,
                                          int r0, int valid, int tid) {
  if constexpr (ALIGNED) {
    constexpr int CH = DH / 8, N = ROWS * CH / THREADS;
    static_assert(ROWS * CH % THREADS == 0, "whole chunks per thread");
    const uint32_t base = smem_u32(smem);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int e = tid + j * THREADS, r = e / CH, c = e % CH;
      const bool in = r < valid;
      const uint16_t* src = in ? g + (int64_t)(r0 + r) * stride + c * 8 : g;
      cp_async16(base + swz<ROWS>(r, c), src, in ? 16 : 0);
    }
  } else {
    constexpr int N = ROWS * DH / THREADS;
#pragma unroll 8
    for (int j = 0; j < N; ++j) {
      const int e = tid + j * THREADS, r = e / DH, d = e % DH;
      const uint16_t x = r < valid ? g[(int64_t)(r0 + r) * stride + d] : (uint16_t)0;
      *reinterpret_cast<uint16_t*>(smem + swz<ROWS>(r, d >> 3) + ((d & 7) << 1)) = x;
    }
  }
}

// x[b, h, t, d] at b*s_b + h*s_h + t*s_t + d, for q, k, v and o alike
template <int DH, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, uint16_t* __restrict__ o, int G, int Lq,
                 int Lk, float scale_log2, int causal, int window, int q_offset,
                 int64_t sq_b, int64_t sq_h, int64_t sq_t, int64_t sk_b, int64_t sk_h,
                 int64_t sk_t, int64_t sv_b, int64_t sv_h, int64_t sv_t, int64_t so_b,
                 int64_t so_h, int64_t so_t) {
  using S = Shape<DH>;
  constexpr int KEYS = S::KEYS;
  constexpr int KSTEPS = DH / 16;  // k-steps of q . K^T
  constexpr int NS = KEYS / 8;     // 8-key n-tiles of the scores
  constexpr int ND = DH / 8;       // 8-column n-tiles of the output
  constexpr int CH = DH / 8;       // 16-byte chunks per row
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* qs = smem;                                 // [QROWS x DH], later the output
  uint8_t* ks = smem + S::Q_BYTES;                    // [STAGES][KEYS x DH]
  uint8_t* vs = ks + S::STAGES * S::TILE_BYTES;       // [STAGES][KEYS x DH]
  const uint32_t qs_a = smem_u32(qs), ks_a = smem_u32(ks), vs_a = smem_u32(vs);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tq = lane & 3;  // fragment rows gr, gr + 8; columns 2tq, 2tq + 1
  const int lrow = lane & 7, lm = lane >> 3;  // ldmatrix: this lane addresses row lrow of matrix lm

  const int h = blockIdx.x, b = blockIdx.y;
  const int iq = gridDim.z - 1 - blockIdx.z;  // heaviest query blocks first
  const int hk = h / G;
  const int row0 = iq * QROWS;
  const int rows = min(QROWS, Lq - row0);
  const uint16_t* qb = q + (int64_t)b * sq_b + (int64_t)h * sq_h;
  const uint16_t* kb = k + (int64_t)b * sk_b + (int64_t)hk * sk_h;
  const uint16_t* vb = v + (int64_t)b * sv_b + (int64_t)hk * sv_h;

  // the keys any row of the block can see
  const int qpos_first = q_offset + row0;
  const int qpos_last = q_offset + row0 + rows - 1;
  const int k_begin = window > 0 ? max(0, qpos_first - window + 1) : 0;
  const int k_end = causal ? min(Lk, qpos_last + 1) : Lk;
  const int t_begin = k_begin / KEYS;
  const int t_end = k_end > k_begin ? (k_end + KEYS - 1) / KEYS : t_begin;

  // q, then the first K / V tile, as two copy groups
  load_tile<QROWS, DH, ALIGNED>(qs, qb, sq_t, row0, rows, tid);
  cp_async_commit();
  if (t_begin < t_end) {
    const int k0 = t_begin * KEYS, kn = min(KEYS, Lk - k0);
    load_tile<KEYS, DH, ALIGNED>(ks, kb, sk_t, k0, kn, tid);
    load_tile<KEYS, DH, ALIGNED>(vs, vb, sv_t, k0, kn, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();  // q has landed
  __syncthreads();

  const int wrow = warp * 16;  // the warp's first row in the block
  const bool warp_active = wrow < rows;
  const int wq_first = q_offset + row0 + wrow, wq_last = wq_first + 15;
  const int qp0 = wq_first + gr, qp1 = qp0 + 8;  // positions of this thread's two rows

  uint32_t qf[DH <= 128 ? KSTEPS : 1][4];  // q's A-fragments, kept for Dh <= 128
  if constexpr (DH <= 128) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      ldsm_x4(qf[kk], qs_a + swz<QROWS>(wrow + (lm & 1) * 8 + lrow, 2 * kk + (lm >> 1)));
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // row max in units of scale * log2(e) * score, and this thread's share of the row sum
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int stage = (tile - t_begin) & 1;
    if (tile + 1 < t_end) {  // the next tile's copy, before this tile's math
      const int k1 = (tile + 1) * KEYS, kn = min(KEYS, Lk - k1);
      const int off = (stage ^ 1) * S::TILE_BYTES;
      load_tile<KEYS, DH, ALIGNED>(ks + off, kb, sk_t, k1, kn, tid);
      load_tile<KEYS, DH, ALIGNED>(vs + off, vb, sv_t, k1, kn, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();

    const int k0 = tile * KEYS;
    const bool sees = warp_active && (!causal || k0 <= wq_last) &&
                      (window <= 0 || k0 + KEYS - 1 > wq_first - window);
    if (sees) {
      const uint32_t kt = ks_a + stage * S::TILE_BYTES, vt = vs_a + stage * S::TILE_BYTES;

      // S = q . K^T: 16 rows x KEYS keys per warp, fp32
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t a[4];
        if constexpr (DH <= 128) {
          a[0] = qf[kk][0], a[1] = qf[kk][1], a[2] = qf[kk][2], a[3] = qf[kk][3];
        } else {
          ldsm_x4(a, qs_a + swz<QROWS>(wrow + (lm & 1) * 8 + lrow, 2 * kk + (lm >> 1)));
        }
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bk[4];  // keys 16np .. 16np + 15, columns 16kk .. 16kk + 15
          ldsm_x4(bk, kt + swz<KEYS>(np * 16 + (lm >> 1) * 8 + lrow, 2 * kk + (lm & 1)));
          mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }

      // online softmax on the fragment: s[n][0..1] is row gr, keys
      // k0 + 8n + 2tq + {0, 1}; s[n][2..3] is row gr + 8
      const bool full = k0 + KEYS <= Lk && (!causal || k0 + KEYS - 1 <= wq_first) &&
                        (window <= 0 || k0 > wq_last - window);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if (!full) {
            const int key = k0 + n * 8 + 2 * tq + (e & 1);
            const int qp = e < 2 ? qp0 : qp1;
            const bool seen = key < Lk && (!causal || key <= qp) &&
                              (window <= 0 || key > qp - window);
            x = seen ? x : -INFINITY;
          }
          s[n][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
      // what is subtracted: 0 while a row has seen no key, so that its
      // masked scores give exp2(-inf) = 0 and not NaN
      const float mu0 = mx0 == -INFINITY ? 0.f : mx0;
      const float mu1 = mx1 == -INFINITY ? 0.f : mx1;
      if (__any_sync(FULL, mx0 != m0 || mx1 != m1)) {
        const float a0 = ex2(m0 - mu0), a1 = ex2(m1 - mu1);
        l0 *= a0;
        l1 *= a1;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          acc[n][0] *= a0, acc[n][1] *= a0;
          acc[n][2] *= a1, acc[n][3] *= a1;
        }
      }
      m0 = mx0;
      m1 = mx1;

      // P in bf16, in registers: the C-fragments of n-tiles 2j and 2j + 1
      // are the A-fragment of k-step j of P . V
      uint32_t pf[NS / 2][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float p0 = ex2(s[n][0] - mu0), p1 = ex2(s[n][1] - mu0);
        const float p2 = ex2(s[n][2] - mu1), p3 = ex2(s[n][3] - mu1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        pf[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
        pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
      }

      // O += P . V, V fragments by ldmatrix.trans of the row-major tile
#pragma unroll
      for (int j = 0; j < KEYS / 16; ++j) {
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          uint32_t bv[4];  // keys 16j .. 16j + 15, columns 16dp .. 16dp + 15
          ldsm_x4_t(bv, vt + swz<KEYS>(j * 16 + (lm & 1) * 8 + lrow, 2 * dp + (lm >> 1)));
          mma_bf16(acc[2 * dp], pf[j], bv[0], bv[1]);
          mma_bf16(acc[2 * dp + 1], pf[j], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  cp_async_wait<0>();
  if (!warp_active) return;
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;  // acc is 0 where l is

  // stage the warp's 16 rows in bf16 where its q rows were, then 16-byte stores
  __syncwarp();
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<uint32_t*>(qs + swz<QROWS>(wrow + gr, n) + tq * 4) =
        pack_bf16(acc[n][0] / d0, acc[n][1] / d0);
    *reinterpret_cast<uint32_t*>(qs + swz<QROWS>(wrow + gr + 8, n) + tq * 4) =
        pack_bf16(acc[n][2] / d1, acc[n][3] / d1);
  }
  __syncwarp();
  uint16_t* ob = o + (int64_t)b * so_b + (int64_t)h * so_h;
#pragma unroll
  for (int j = 0; j < 16 * CH / 32; ++j) {
    const int e = lane + j * 32, r = e / CH, c = e % CH;
    if (wrow + r < rows)
      *reinterpret_cast<uint4*>(ob + (int64_t)(row0 + wrow + r) * so_t + c * 8) =
          *reinterpret_cast<const uint4*>(qs + swz<QROWS>(wrow + r, c));
  }
}

}  // namespace tc

template <int DH, bool ALIGNED>
static int launch_tc_dh(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int G, int Lq, int Lk, float scale, int causal, int window,
                        int q_offset, const int64_t* st, void* stream) {
  using S = tc::Shape<DH>;
  static bool raised[MAX_DEVICES] = {false};
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(tc::attention_kernel<DH, ALIGNED>),
                             S::BYTES, raised);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B, (Lq + tc::QROWS - 1) / tc::QROWS);
  tc::attention_kernel<DH, ALIGNED><<<grid, tc::THREADS, S::BYTES, (cudaStream_t)stream>>>(
      (const uint16_t*)q, (const uint16_t*)k, (const uint16_t*)v, (uint16_t*)o, G, Lq, Lk,
      scale * tc::LOG2E, causal, window, q_offset, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

template <bool ALIGNED>
static int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int H,
                     int G, int Lq, int Lk, int Dh, float scale, int causal, int window,
                     int q_offset, const int64_t* st, void* stream) {
  switch (Dh) {
    case 64:
      return launch_tc_dh<64, ALIGNED>(q, k, v, o, B, H, G, Lq, Lk, scale, causal, window, q_offset, st, stream);
    case 128:
      return launch_tc_dh<128, ALIGNED>(q, k, v, o, B, H, G, Lq, Lk, scale, causal, window, q_offset, st, stream);
    case 256:
      return launch_tc_dh<256, ALIGNED>(q, k, v, o, B, H, G, Lq, Lk, scale, causal, window, q_offset, st, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Whether p and every stride of st (in bf16 elements) keep rows on 16 bytes.
static bool aligned16(const void* p, const int64_t* st) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (st[i] % 8) return false;
  return true;
}

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int Hkv, int Lq, int Lk, int Dh, float scale, int causal, int window,
                        int q_offset, int64_t sq_b, int64_t sq_h, int64_t sq_t, int64_t sk_b,
                        int64_t sk_h, int64_t sk_t, int64_t sv_b, int64_t sv_h, int64_t sv_t,
                        int64_t so_b, int64_t so_h, int64_t so_t, void* stream) {
  const int64_t st[12] = {sq_b, sq_h, sq_t, sk_b, sk_h, sk_t, sv_b, sv_h, sv_t, so_b, so_h, so_t};
  return launch<float>(q, k, v, o, B, H, Hkv, Lq, Lk, Dh, scale, causal, window, q_offset,
                       st, stream);
}

// `aligned`: the caller found q, k and v 16-byte aligned (aligned16 of each)
// and asks for the cp.async instance; 0 asks for the element-wise one.  o
// must be aligned: the wrapper allocates it.
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B, int H,
                         int Hkv, int Lq, int Lk, int Dh, float scale, int causal, int window,
                         int q_offset, int64_t sq_b, int64_t sq_h, int64_t sq_t, int64_t sk_b,
                         int64_t sk_h, int64_t sk_t, int64_t sv_b, int64_t sv_h, int64_t sv_t,
                         int64_t so_b, int64_t so_h, int64_t so_t, int aligned, void* stream) {
  const int64_t st[12] = {sq_b, sq_h, sq_t, sk_b, sk_h, sk_t, sv_b, sv_h, sv_t, so_b, so_h, so_t};
  if (!shape_ok(B, H, Hkv, Lq, Lk, window)) return (int)cudaErrorInvalidValue;
  if (!aligned16(o, st + 9)) return (int)cudaErrorMisalignedAddress;
  if (aligned && !(aligned16(q, st) && aligned16(k, st + 3) && aligned16(v, st + 6)))
    return (int)cudaErrorMisalignedAddress;
  const int G = H / Hkv;
  return aligned ? launch_tc<true>(q, k, v, o, B, H, G, Lq, Lk, Dh, scale, causal, window,
                                   q_offset, st, stream)
                 : launch_tc<false>(q, k, v, o, B, H, G, Lq, Lk, Dh, scale, causal, window,
                                    q_offset, st, stream);
}

// The dynamic shared memory one block of an instance takes, for reports.
int flash_smem_bytes(int bf16, int Dh) {
  switch (Dh) {
    case 64:
      return bf16 ? tc::Shape<64>::BYTES : Smem<64>::BYTES;
    case 128:
      return bf16 ? tc::Shape<128>::BYTES : Smem<128>::BYTES;
    case 256:
      return bf16 ? tc::Shape<256>::BYTES : Smem<256>::BYTES;
    default:
      return -1;
  }
}

const char* flash_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
