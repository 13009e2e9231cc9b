// Causal / windowed GQA attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call in flash_attention()).  For q (B, H, Lq, Dh) and k, v
// (B, Hkv, Lk, Dh), query head h reads KV head h / (H / Hkv), and
//
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, hk, j] + mask) v[b, hk, j]
//
// where query row i sits at position qpos = q_offset + i and sees key j iff
// j <= qpos (causal) and j > qpos - window (a window; 0 = none).  q is
// scaled in fp32 before the dot; the running max, sum and accumulator are
// fp32, masked scores are NEG_INF = -1e30 with their probabilities zeroed,
// and a row that sees no key gives 0 (the TPU kernel's l == 0 guard).  The
// output is written in the input dtype.
//
// Design.  The TPU grid (B, H, q_block, kv_block) runs its kv blocks in
// order on one core and carries (m, l, acc) across them in VMEM; CUDA
// blocks run in parallel and share nothing, so here one block owns BQ = 64
// query rows of one (query head, batch row) and loops over the key tiles
// itself.  The block stages its rows of q, scaled, in shared memory as fp32,
// and per tile BK = 32 rows of K and V as fp32.  Each of its eight warps
// owns R = 8 query rows.  For q.k^T lane j takes key j of the tile: per
// four head-dim columns it reads one float4 of its key (the K tile's rows
// are padded to Dh + 4 floats so that a quarter-warp's float4 reads hit 32
// distinct banks) and one broadcast float4 of q per row, for 32 FMAs.  The
// online-softmax update is a warp max and a warp sum per row.  For p.v the
// lanes own head-dim columns lane + 32c: the warp writes its probabilities
// to shared memory transposed (p[j][r]), and per key a lane reads them as
// two broadcast float4 and one V value per column, for R FMAs each.
// Key tiles that the causal or window mask covers completely for every row
// of the block are never loaded (the TPU kernel's pl.when(valid)), so the
// work scales with the unmasked area; under a causal mask the last query
// blocks see the most keys, so the grid puts the query block on its slowest
// axis, reversed, and the heaviest blocks start first.
//
// Bound.  A causal call does 4 * Dh * B * H * (Lq * Lk - Lq^2 / 2) fp32
// operations (two products of a multiply and an add per visible (i, j));
// at B = 4, H = 24, L = 1024, Dh = 128 that is 25.8 GFLOP, which the
// function could run on the bf16 tensor cores in 26 us.  This kernel runs
// them as fp32 FMAs on the CUDA cores with about one shared-memory
// wavefront per 2.7 FMA instructions, so shared-memory bandwidth and the
// FMA rate bound it; tensor cores (mma / wgmma on bf16 tiles), TMA loads
// and warp specialisation are later work.
//
// Strides.  q, k, v and o may be any views whose head-dim is unit-stride:
// the model passes its (B, L, H, Dh) projections transposed to (B, H, L, Dh)
// without a copy, and the wrapper allocates o as (B, Lq, H, Dh) so that the
// output projection reads it without one.  The kernel launches on the
// caller's stream and allocates nothing; the C entry points return
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
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
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

// Raise one instance's dynamic shared-memory limit once per device, on the
// first launch that needs more than the default 48 KB.
template <typename T, int DH>
static cudaError_t allow_smem() {
  constexpr int bytes = Smem<DH>::BYTES;
  if (bytes <= 48 * 1024) return cudaSuccess;
  static std::mutex mu;
  static bool raised[MAX_DEVICES] = {false};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(mu);
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(flash_attention_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    raised[dev] = true;
  }
  return cudaSuccess;
}

template <typename T, int DH>
static int launch_dh(const void* q, const void* k, const void* v, void* o, int B, int H,
                     int G, int Lq, int Lk, float scale, int causal, int window,
                     int q_offset, const int64_t* st, void* stream) {
  cudaError_t e = allow_smem<T, DH>();
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
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Lq < 1 || Lk < 1 || window < 0 ||
      H > 65535 || B > 65535 || (Lq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
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

extern "C" {

#define FLASH_ENTRY(NAME, T)                                                               \
  int NAME(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,   \
           int Lq, int Lk, int Dh, float scale, int causal, int window, int q_offset,     \
           int64_t sq_b, int64_t sq_h, int64_t sq_t, int64_t sk_b, int64_t sk_h,          \
           int64_t sk_t, int64_t sv_b, int64_t sv_h, int64_t sv_t, int64_t so_b,          \
           int64_t so_h, int64_t so_t, void* stream) {                                    \
    const int64_t st[12] = {sq_b, sq_h, sq_t, sk_b, sk_h, sk_t,                           \
                            sv_b, sv_h, sv_t, so_b, so_h, so_t};                          \
    return launch<T>(q, k, v, o, B, H, Hkv, Lq, Lk, Dh, scale, causal, window, q_offset,  \
                     st, stream);                                                         \
  }

FLASH_ENTRY(flash_attention_f32, float)
FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16)

const char* flash_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
