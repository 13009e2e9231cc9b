// Depthwise causal short convolution (FIR) with an optional gate, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/short_conv.py:24
// (_short_conv_kernel) with the function of its oracle
// repro/kernels/ref.py::short_conv_gate:
//
//   y[b, t, d] = sum_{k < K} w[d, k] * u[b, t - k, d]     (u[t < 0] = 0)
//   out        = downcast(y * gate)   or   downcast(y)
//
// in fp32: u, w and the gate are read as fp32, the K taps are added in the
// order k = 0 .. K-1 onto a zero start, each product rounded before its add
// (__fmul_rn / __fadd_rn: no FMA contraction, as the reference's separate
// multiply and add), and the gate multiplies the fp32 sum BEFORE the
// downcast to u's dtype.  That is the oracle's order and not
// repro.core.fftconv._fused_epilogue's (which downcasts first).  With these
// roundings every instance's fp32 sums equal the plain PyTorch version's bit
// for bit.  The TPU kernel takes its causal halo from the previous L block
// only, so it computes another function when K - 1 exceeds its L block or
// when K = 1; every instance here computes the oracle's for any K >= 1 and
// L >= 1.
//
// Bound.  Per output it does K multiplies and K adds (plus one for the
// gate) and moves 2 or 3 elements (u, out, gate): at K = 3 in bf16 about 7
// operations per 6 bytes, a hundred times under the card's ridge, so the
// function's least time is its bytes (u, out and gate once, w once).  The
// only levers are the bytes in flight and whole 128-byte lines.
//
// Vector instance (short_conv_vec_kernel<T, TW, K, GATED, U>), a streaming
// stencil.  A thread owns one 16-byte vector of V channels (8 bf16 or 4
// fp32) and walks a run of R consecutive rows of one batch row.  The
// threads are (batch row, run, vector) flattened with the vector fastest,
// so a warp reads and writes 32 consecutive vectors: 512 bytes, four whole
// lines of a row, and no lane idles at any D that is a multiple of V.  The
// K - 1 rows before the current one are a sliding window of fp32 registers,
// so the halo is loaded once per run (through L2, where the neighbouring
// run read it too) and not once per few rows.  A ring of U rows of u (and of
// the gate) is in flight ahead of the arithmetic: the row consumed is
// refilled with the load of the row U further on before its sums start.
// Every load of u and the gate is one 16-byte ld.global.cs and every store
// one 16-byte st.global.cs (evict first: each byte moves once).  R is a
// run-time argument the wrapper picks (kernels/short_conv.py::
// vector_geometry); U = AHEAD and K are template arguments, so the window,
// the ring and w's K x V taps live in registers.  Index arithmetic is 32-bit; the
// rows are walked with 64-bit pointers.  It takes views whose data
// pointers are 16-byte aligned, whose batch and row strides are multiples
// of V, and D a multiple of V (kernels/short_conv.py::short_conv_plan);
// a ragged D or a view off 16 bytes takes the scalar instance.
//
// Scalar instance (short_conv_scalar_kernel<T, TW, K, GATED, R>): one thread
// owns one channel and R consecutive rows (8, or 4 gated), loads its rows,
// their K - 1 halo rows and its gate rows into registers, one element a
// lane; a warp covers 32 consecutive channels.  It takes any view whose
// channel dim is unit-stride.
//
// General instance (short_conv_general_kernel<T, TW, GATED>), for K past
// MAX_UNROLLED_K: K is a run-time argument, one thread per channel and 8
// rows, each tap and each halo row read again through L1 (ld.global.nc).
// No registered config has K > 3; this instance is plain and right.
//
// Strides.  w (D, K) may have any strides; out is contiguous (B, L, D).  The
// kernels launch on the caller's stream and allocate nothing; the C entry
// points refuse what an instance does not take and return
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MAX_UNROLLED_K 8  // K past this takes the general instance
#ifndef AHEAD  // short_conv_sweep.py builds other depths with -DAHEAD=U to time them
#define AHEAD 4           // rows of u (and the gate) a vector thread keeps in flight
#endif
#define VEC_BLOCK 128     // threads a block of the vector instance
#define TD 32             // channels a block of the scalar and general instances
#define TY 8              // row groups a block of the scalar and general instances
#define ROWS 8            // output rows a scalar thread, ungated
#define ROWS_GATED 4      // output rows a scalar thread, gated
#define ROWS_GENERAL 8    // output rows a general thread

enum { INSTANCE_VECTOR = 0, INSTANCE_SCALAR = 1, INSTANCE_GENERAL = 2 };

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

// 16 bytes of T as V fp32 values
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float (&f)[V]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[V]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  // element 2i is the low half of word i: its fp32 value is the word
  // shifted up 16, element 2i + 1's the high half with the low half cleared
  static __device__ __forceinline__ void unpack(const uint4& r, float (&f)[V]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[V]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

// u[b, t, d] at b*su_b + t*su_t + d; gate likewise; w[d, k] at
// d*sw_d + k*sw_k; out[b, t, d] at (b*L + t)*D + d with D = n_vec*V.  Thread
// `item` = (b*n_runs + run)*n_vec + vec owns channels vec*V .. vec*V + V - 1
// of rows run*R .. run*R + R - 1 (cut at L).
template <typename T, typename TW, int K, bool GATED, int U>
__global__ void __launch_bounds__(VEC_BLOCK)
short_conv_vec_kernel(const T* __restrict__ u, const TW* __restrict__ w,
                      const T* __restrict__ gate, T* __restrict__ out, int L, int n_vec,
                      int R, int n_runs, int n_items, int64_t su_b, int64_t su_t,
                      int64_t sg_b, int64_t sg_t, int64_t sw_d, int64_t sw_k) {
  constexpr int V = Vec<T>::V;
  const int item = (int)blockIdx.x * VEC_BLOCK + (int)threadIdx.x;
  if (item >= n_items) return;
  const int vec = item % n_vec;
  const int rest = item / n_vec;
  const int run = rest % n_runs;
  const int b = rest / n_runs;
  const int t0 = run * R;
  const int n = min(R, L - t0);  // rows of this run, >= 1
  const int d0 = vec * V;

  const T* up = u + (int64_t)b * su_b + (int64_t)t0 * su_t + d0;
  const T* gp = GATED ? gate + (int64_t)b * sg_b + (int64_t)t0 * sg_t + d0 : nullptr;
  T* op = out + ((int64_t)b * L + t0) * ((int64_t)n_vec * V) + d0;
  const int64_t so = (int64_t)n_vec * V;

  // the ring: rows t0 .. t0 + U - 1 in flight first, then the halo
  uint4 qu[U], qg[U];
#pragma unroll
  for (int i = 0; i < U; ++i) {
    if (i < n) {
      qu[i] = __ldcs(reinterpret_cast<const uint4*>(up + i * su_t));
      if (GATED) qg[i] = __ldcs(reinterpret_cast<const uint4*>(gp + i * sg_t));
    }
  }
  // x[0 .. K-2]: the window, rows t0 - K + 1 .. t0 - 1 (zero before t = 0),
  // read with the default caching, since the previous run read them too;
  // x[K-1]: the current row
  uint4 halo[K > 1 ? K - 1 : 1];
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int dt = j - (K - 1);
    halo[j] = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + dt >= 0) halo[j] = __ldg(reinterpret_cast<const uint4*>(up + dt * su_t));
  }
  float wk[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i)
      wk[k][i] = to_f32(w[(int64_t)(d0 + i) * sw_d + (int64_t)k * sw_k]);
  float x[K][V];
#pragma unroll
  for (int j = 0; j < K - 1; ++j) Vec<T>::unpack(halo[j], x[j]);

  const T* un = up + (int64_t)U * su_t;  // the next row of u to load
  const T* gn = GATED ? gp + (int64_t)U * sg_t : nullptr;
  for (int j0 = 0; j0 < n; j0 += U) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int j = j0 + i;
      if (j >= n) return;  // the run's last row is done
      Vec<T>::unpack(qu[i], x[K - 1]);
      float g[V];
      if (GATED) Vec<T>::unpack(qg[i], g);
      // refill the slot with row j + U before the sums of row j
      if (j + U < n) {
        qu[i] = __ldcs(reinterpret_cast<const uint4*>(un));
        if (GATED) qg[i] = __ldcs(reinterpret_cast<const uint4*>(gn));
      }
      un += su_t;
      if (GATED) gn += sg_t;
      float y[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) s = __fadd_rn(s, __fmul_rn(x[K - 1 - k][v], wk[k][v]));
        y[v] = GATED ? __fmul_rn(s, g[v]) : s;
      }
      __stcs(reinterpret_cast<uint4*>(op), Vec<T>::pack(y));
      op += so;
      // slide the window one row
#pragma unroll
      for (int k = 0; k < K - 1; ++k)
#pragma unroll
        for (int v = 0; v < V; ++v) x[k][v] = x[k + 1][v];
    }
  }
}

// The scalar instance.  The grid is one dimension over (batch row, row
// tile, channel tile), channel tiles fastest.
template <typename T, typename TW, int K, bool GATED, int R>
__global__ void __launch_bounds__(TD * TY)
short_conv_scalar_kernel(const T* __restrict__ u, const TW* __restrict__ w,
                         const T* __restrict__ gate, T* __restrict__ out, int L, int D,
                         int n_dtiles, int n_ttiles, int64_t su_b, int64_t su_t,
                         int64_t sg_b, int64_t sg_t, int64_t sw_d, int64_t sw_k) {
  const int bid = (int)blockIdx.x;
  const int dtile = bid % n_dtiles;
  const int rest = bid / n_dtiles;
  const int ttile = rest % n_ttiles;
  const int b = rest / n_ttiles;
  const int d = dtile * TD + threadIdx.x;
  const int t0 = (ttile * TY + threadIdx.y) * R;
  if (d >= D || t0 >= L) return;

  float wk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) wk[k] = to_f32(w[(int64_t)d * sw_d + (int64_t)k * sw_k]);

  // x[i] = u[t0 - (K - 1) + i]: the K - 1 halo rows, then the thread's own
  const T* ub = u + (int64_t)b * su_b + d;
  float x[R + K - 1];
#pragma unroll
  for (int i = 0; i < R + K - 1; ++i) {
    const int t = t0 - (K - 1) + i;
    x[i] = (t >= 0 && t < L) ? to_f32(ub[(int64_t)t * su_t]) : 0.f;
  }
  // the gate's rows too, all loads issued before the first store
  float gv[R];
  if (GATED) {
    const T* gb = gate + (int64_t)b * sg_b + d;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int t = t0 + j;
      gv[j] = t < L ? to_f32(gb[(int64_t)t * sg_t]) : 0.f;
    }
  }
  T* ob = out + (int64_t)b * L * D + d;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int t = t0 + j;
    if (t < L) {
      float y = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) y = __fadd_rn(y, __fmul_rn(x[j + K - 1 - k], wk[k]));
      if (GATED) y = __fmul_rn(y, gv[j]);
      ob[(int64_t)t * D] = from_f32<T>(y);
    }
  }
}

// The general instance: K at run time, taps and halo read through L1.
template <typename T, typename TW, bool GATED>
__global__ void __launch_bounds__(TD * TY)
short_conv_general_kernel(const T* __restrict__ u, const TW* __restrict__ w,
                          const T* __restrict__ gate, T* __restrict__ out, int L, int D, int K,
                          int n_dtiles, int n_ttiles, int64_t su_b, int64_t su_t,
                          int64_t sg_b, int64_t sg_t, int64_t sw_d, int64_t sw_k) {
  const int bid = (int)blockIdx.x;
  const int dtile = bid % n_dtiles;
  const int rest = bid / n_dtiles;
  const int ttile = rest % n_ttiles;
  const int b = rest / n_ttiles;
  const int d = dtile * TD + threadIdx.x;
  const int t0 = (ttile * TY + threadIdx.y) * ROWS_GENERAL;
  if (d >= D || t0 >= L) return;

  const T* ub = u + (int64_t)b * su_b + d;
  const TW* wd = w + (int64_t)d * sw_d;
  T* ob = out + (int64_t)b * L * D + d;
  for (int j = 0; j < ROWS_GENERAL; ++j) {
    const int t = t0 + j;
    if (t >= L) break;
    float y = 0.f;
    for (int k = 0; k < K; ++k) {
      const float xk = t - k >= 0 ? to_f32(__ldg(ub + (int64_t)(t - k) * su_t)) : 0.f;
      y = __fadd_rn(y, __fmul_rn(xk, to_f32(__ldg(wd + (int64_t)k * sw_k))));
    }
    if (GATED) y = __fmul_rn(y, to_f32(gate[(int64_t)b * sg_b + (int64_t)t * sg_t + d]));
    ob[(int64_t)t * D] = from_f32<T>(y);
  }
}

struct Args {
  const void* u;
  const void* w;
  const void* gate;
  void* out;
  int B, L, D, K;
  int64_t su_b, su_t, sg_b, sg_t, sw_d, sw_k;
  cudaStream_t s;
};

template <typename T, typename TW, int K, bool GATED>
static int launch_vec(const Args& a, int R) {
  constexpr int V = Vec<T>::V;
  const int n_vec = a.D / V;
  const int n_runs = (a.L + R - 1) / R;
  const int64_t n_items = (int64_t)a.B * n_runs * n_vec;
  if (n_items > 0x7fffffffLL - VEC_BLOCK) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n_items + VEC_BLOCK - 1) / VEC_BLOCK);
  short_conv_vec_kernel<T, TW, K, GATED, AHEAD><<<grid, VEC_BLOCK, 0, a.s>>>(
      (const T*)a.u, (const TW*)a.w, (const T*)a.gate, (T*)a.out, a.L, n_vec, R, n_runs,
      (int)n_items, a.su_b, a.su_t, a.sg_b, a.sg_t, a.sw_d, a.sw_k);
  return (int)cudaGetLastError();
}

template <typename T, typename TW, bool GATED>
static int dispatch_vec(const Args& a, int R) {
  switch (a.K) {
#define VEC_CASE(KK) \
  case KK:           \
    return launch_vec<T, TW, KK, GATED>(a, R);
    VEC_CASE(1)
    VEC_CASE(2)
    VEC_CASE(3)
    VEC_CASE(4)
    VEC_CASE(5)
    VEC_CASE(6)
    VEC_CASE(7)
    VEC_CASE(8)
#undef VEC_CASE
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename TW, int K, bool GATED>
static int launch_scalar(const Args& a) {
  constexpr int R = GATED ? ROWS_GATED : ROWS;
  const int n_dtiles = (a.D + TD - 1) / TD;
  const int n_ttiles = (a.L + TY * R - 1) / (TY * R);
  const int64_t n_blocks = (int64_t)a.B * n_ttiles * n_dtiles;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  short_conv_scalar_kernel<T, TW, K, GATED, R><<<(unsigned)n_blocks, dim3(TD, TY), 0, a.s>>>(
      (const T*)a.u, (const TW*)a.w, (const T*)a.gate, (T*)a.out, a.L, a.D, n_dtiles,
      n_ttiles, a.su_b, a.su_t, a.sg_b, a.sg_t, a.sw_d, a.sw_k);
  return (int)cudaGetLastError();
}

template <typename T, typename TW, bool GATED>
static int dispatch_scalar(const Args& a) {
  switch (a.K) {
#define SCALAR_CASE(KK) \
  case KK:              \
    return launch_scalar<T, TW, KK, GATED>(a);
    SCALAR_CASE(1)
    SCALAR_CASE(2)
    SCALAR_CASE(3)
    SCALAR_CASE(4)
    SCALAR_CASE(5)
    SCALAR_CASE(6)
    SCALAR_CASE(7)
    SCALAR_CASE(8)
#undef SCALAR_CASE
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename TW, bool GATED>
static int launch_general(const Args& a) {
  const int n_dtiles = (a.D + TD - 1) / TD;
  const int n_ttiles = (a.L + TY * ROWS_GENERAL - 1) / (TY * ROWS_GENERAL);
  const int64_t n_blocks = (int64_t)a.B * n_ttiles * n_dtiles;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  short_conv_general_kernel<T, TW, GATED><<<(unsigned)n_blocks, dim3(TD, TY), 0, a.s>>>(
      (const T*)a.u, (const TW*)a.w, (const T*)a.gate, (T*)a.out, a.L, a.D, a.K, n_dtiles,
      n_ttiles, a.su_b, a.su_t, a.sg_b, a.sg_t, a.sw_d, a.sw_k);
  return (int)cudaGetLastError();
}

// what the vector instance needs: 16-byte aligned pointers, batch and row
// strides that keep every row's start on 16 bytes (a dim of size 1 has no
// stride that is ever stepped), D a multiple of V
template <typename T>
static bool vector_fits(const Args& a) {
  constexpr int V = Vec<T>::V;
  auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  auto steps = [&](int64_t stride, int size) { return size == 1 || stride % V == 0; };
  const bool u_ok = aligned(a.u) && steps(a.su_b, a.B) && steps(a.su_t, a.L);
  const bool g_ok = a.gate == nullptr ||
                    (aligned(a.gate) && steps(a.sg_b, a.B) && steps(a.sg_t, a.L));
  return a.D % V == 0 && aligned(a.out) && u_ok && g_ok;
}

template <typename T, typename TW, bool GATED>
static int dispatch(const Args& a, int instance, int R) {
  switch (instance) {
    case INSTANCE_VECTOR:
      if (a.K > MAX_UNROLLED_K || R < 1 || !vector_fits<T>(a)) return (int)cudaErrorInvalidValue;
      return dispatch_vec<T, TW, GATED>(a, R);
    case INSTANCE_SCALAR:
      return dispatch_scalar<T, TW, GATED>(a);
    case INSTANCE_GENERAL:
      return launch_general<T, TW, GATED>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename TW>
static int launch(const Args& a, int instance, int R) {
  if (a.B < 1 || a.L < 1 || a.D < 1 || a.K < 1) return (int)cudaErrorInvalidValue;
  return a.gate != nullptr ? dispatch<T, TW, true>(a, instance, R)
                           : dispatch<T, TW, false>(a, instance, R);
}

extern "C" {

// instance: 0 vector (R rows a run), 1 scalar, 2 general
#define SHORT_CONV_ENTRY(NAME, T, TW)                                                        \
  int NAME(const void* u, const void* w, const void* gate, void* out, int B, int L, int D,  \
           int K, int instance, int R, int64_t su_b, int64_t su_t, int64_t sg_b,            \
           int64_t sg_t, int64_t sw_d, int64_t sw_k, void* stream) {                         \
    const Args a{u, w, gate, out, B, L, D, K, su_b, su_t, sg_b, sg_t, sw_d, sw_k,           \
                 (cudaStream_t)stream};                                                      \
    return launch<T, TW>(a, instance, R);                                                    \
  }

SHORT_CONV_ENTRY(short_conv_f32_f32, float, float)
SHORT_CONV_ENTRY(short_conv_f32_bf16, float, __nv_bfloat16)
SHORT_CONV_ENTRY(short_conv_bf16_f32, __nv_bfloat16, float)
SHORT_CONV_ENTRY(short_conv_bf16_bf16, __nv_bfloat16, __nv_bfloat16)

#undef SHORT_CONV_ENTRY

const char* short_conv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int short_conv_max_unrolled_k(void) { return MAX_UNROLLED_K; }

int short_conv_ahead(void) { return AHEAD; }

}  // extern "C"
