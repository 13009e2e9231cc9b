// Depthwise causal short convolution (FIR) with an optional gate, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/short_conv.py::_short_conv_kernel
// with the function of its oracle repro/kernels/ref.py::short_conv_gate:
//
//   y[b, t, d] = sum_{k < K} w[d, k] * u[b, t - k, d]     (u[t < 0] = 0)
//   out        = downcast(y * gate)   or   downcast(y)
//
// in fp32: u, w and the gate are read as fp32, the K taps are added in the
// order k = 0 .. K-1 onto a zero start, each product rounded before its add
// (no FMA contraction, as the reference's separate multiply and add), and
// the gate multiplies the fp32 sum BEFORE the downcast to u's dtype.  That
// is the oracle's order and not repro.core.fftconv._fused_epilogue's (which
// downcasts first).  With these roundings the kernel's fp32 sums equal the
// plain PyTorch version's bit for bit.
//
// Design.  The TPU kernel tiles (L, D) and fetches its causal halo from the
// previous L block only, so it computes the wrong function when K - 1
// exceeds its L block or when K = 1 (its halo slice `-(K-1):` is then the
// whole block).  Here one thread owns one channel d and R consecutive
// output rows t0 .. t0 + R - 1 of one batch row: it loads the R + K - 1
// inputs u[t0 - K + 1 .. t0 + R - 1] straight from device memory into
// registers (zero before t = 0 and past L), so any K from 1 to MAX_K and any
// L >= 1 take the same path.  These R + K - 1 loads and the R gate loads
// are independent and issued before the first store.  A warp is 32
// consecutive channels of the same rows, so every load and store of u, gate
// and out is one contiguous run of 32 elements.  K and whether there is a
// gate are template arguments, so the tap loop is unrolled, w lives in K
// registers, and an ungated call keeps no registers for the gate (which
// would cost it occupancy).  R is 8 ungated and 4 gated: fewer rows mean
// fewer registers and more warps in flight, more rows fewer halo re-reads;
// on the H100 at hyena-153m's projection, 1 to 32 rows per thread put the
// least time there for each kernel.
//
// Bound.  Per output it does K multiplies and K adds (plus one for the
// gate) and moves 2 or 3 elements (u, out, gate): 7 operations per 6 bytes
// at K = 3 in bf16, far below the card's ~20 fp32 operations per byte, so
// the function's least time is its bytes (u, out and gate once, w once).
// The halo's K - 1 extra loads per R outputs are re-reads that the L1/L2
// caches serve.  Loads are one element wide (2 or 4 bytes a lane); wider
// vector loads need aligned channel offsets that a torch.split view does
// not promise, and are later work.
//
// Strides.  u and gate may be any view whose channel dim is unit-stride;
// w (D, K) any strides.  out is contiguous (B, L, D).  The kernel launches
// on the caller's stream and allocates nothing; the C entry points return
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define TD 32     // channels per block, one per lane
#define TY 8      // row groups per block
#define ROWS 8         // output rows per thread, ungated
#define ROWS_GATED 4   // output rows per thread, gated
#define MAX_K 8   // largest filter length

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

// u[b, t, d] at b*su_b + t*su_t + d; gate likewise; w[d, k] at d*sw_d + k*sw_k;
// out[b, t, d] at (b*L + t)*D + d.  The grid is one dimension over
// (batch row, row tile, channel tile), channel tiles fastest.
template <typename T, typename TW, int K, bool GATED, int R>
__global__ void __launch_bounds__(TD * TY)
short_conv_kernel(const T* __restrict__ u, const TW* __restrict__ w,
                  const T* __restrict__ gate, T* __restrict__ out, int L, int D,
                  int n_dtiles, int n_ttiles, int64_t su_b, int64_t su_t, int64_t sg_b,
                  int64_t sg_t, int64_t sw_d, int64_t sw_k) {
  const int64_t bid = blockIdx.x;
  const int dtile = (int)(bid % n_dtiles);
  const int64_t rest = bid / n_dtiles;
  const int ttile = (int)(rest % n_ttiles);
  const int64_t b = rest / n_ttiles;
  const int d = dtile * TD + threadIdx.x;
  const int t0 = (ttile * TY + threadIdx.y) * R;
  if (d >= D || t0 >= L) return;

  float wk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) wk[k] = to_f32(w[(int64_t)d * sw_d + (int64_t)k * sw_k]);

  // x[i] = u[t0 - (K - 1) + i]: the K - 1 halo rows, then the thread's own
  const T* ub = u + b * su_b + d;
  float x[R + K - 1];
#pragma unroll
  for (int i = 0; i < R + K - 1; ++i) {
    const int t = t0 - (K - 1) + i;
    x[i] = (t >= 0 && t < L) ? to_f32(ub[(int64_t)t * su_t]) : 0.f;
  }
  // the gate's rows too, all loads issued before the first store
  float gv[R];
  if (GATED) {
    const T* gb = gate + b * sg_b + d;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int t = t0 + j;
      gv[j] = t < L ? to_f32(gb[(int64_t)t * sg_t]) : 0.f;
    }
  }
  T* ob = out + b * (int64_t)L * D + d;
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

template <typename T, typename TW, int K, bool GATED>
static void launch_k(const void* u, const void* w, const void* gate, void* out, int B, int L,
                     int D, int64_t su_b, int64_t su_t, int64_t sg_b, int64_t sg_t,
                     int64_t sw_d, int64_t sw_k, cudaStream_t stream) {
  constexpr int R = GATED ? ROWS_GATED : ROWS;
  const int n_dtiles = (D + TD - 1) / TD;
  const int n_ttiles = (L + TY * R - 1) / (TY * R);
  short_conv_kernel<T, TW, K, GATED, R>
      <<<(unsigned)((int64_t)B * n_ttiles * n_dtiles), dim3(TD, TY), 0, stream>>>(
          (const T*)u, (const TW*)w, (const T*)gate, (T*)out, L, D, n_dtiles, n_ttiles, su_b,
          su_t, sg_b, sg_t, sw_d, sw_k);
}

template <typename T, typename TW>
static int launch(const void* u, const void* w, const void* gate, void* out, int B, int L,
                  int D, int K, int64_t su_b, int64_t su_t, int64_t sg_b, int64_t sg_t,
                  int64_t sw_d, int64_t sw_k, void* stream) {
  if (B < 1 || L < 1 || D < 1 || K < 1 || K > MAX_K) return (int)cudaErrorInvalidValue;
  // the largest grid: the gated one, with fewer rows per thread
  const int64_t n_blocks = (int64_t)B * ((L + TY * ROWS_GATED - 1) / (TY * ROWS_GATED)) *
                           ((D + TD - 1) / TD);
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define SHORT_CONV_CASE(KK)                                                                  \
  case KK:                                                                                   \
    if (gate != nullptr)                                                                     \
      launch_k<T, TW, KK, true>(u, w, gate, out, B, L, D, su_b, su_t, sg_b, sg_t, sw_d,     \
                                sw_k, s);                                                    \
    else                                                                                     \
      launch_k<T, TW, KK, false>(u, w, nullptr, out, B, L, D, su_b, su_t, sg_b, sg_t, sw_d, \
                                 sw_k, s);                                                   \
    break;
  switch (K) {
    SHORT_CONV_CASE(1)
    SHORT_CONV_CASE(2)
    SHORT_CONV_CASE(3)
    SHORT_CONV_CASE(4)
    SHORT_CONV_CASE(5)
    SHORT_CONV_CASE(6)
    SHORT_CONV_CASE(7)
    SHORT_CONV_CASE(8)
  }
#undef SHORT_CONV_CASE
  return (int)cudaGetLastError();
}

extern "C" {

#define SHORT_CONV_ENTRY(NAME, T, TW)                                                        \
  int NAME(const void* u, const void* w, const void* gate, void* out, int B, int L, int D,  \
           int K, int64_t su_b, int64_t su_t, int64_t sg_b, int64_t sg_t, int64_t sw_d,     \
           int64_t sw_k, void* stream) {                                                     \
    return launch<T, TW>(u, w, gate, out, B, L, D, K, su_b, su_t, sg_b, sg_t, sw_d, sw_k,   \
                         stream);                                                            \
  }

SHORT_CONV_ENTRY(short_conv_f32_f32, float, float)
SHORT_CONV_ENTRY(short_conv_f32_bf16, float, __nv_bfloat16)
SHORT_CONV_ENTRY(short_conv_bf16_f32, __nv_bfloat16, float)
SHORT_CONV_ENTRY(short_conv_bf16_bf16, __nv_bfloat16, __nv_bfloat16)

#undef SHORT_CONV_ENTRY

const char* short_conv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int short_conv_max_k(void) { return MAX_K; }

}  // extern "C"
