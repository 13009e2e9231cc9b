// RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (oracle repro/kernels/ref.py::rmsnorm).  Per row of D values
//
//   y = x * rsqrt(mean(x^2) + eps) * (1 + g)
//
// in fp32: x and g are read as fp32, 1 + g is formed in fp32 (g is cast
// before the add, as the TPU kernel does; the model's own norm adds 1 in
// g's dtype, so this is not a drop-in for it), and y is cast back to x's
// dtype.  A row of zeros gives zeros: eps keeps the rsqrt finite.
//
// Design.  The TPU kernel takes a (block_rows, D) tile per grid step and
// reduces it in VMEM.  Here one warp owns one row: each lane sums the
// squares of its elements in fp32, the warp adds the 32 partial sums with
// shuffles, and every lane then scales its elements and writes them.  A
// lane takes V consecutive elements at a time, chunks c = lane, lane + 32,
// ... of the row, so each warp load is one contiguous run of 32·V
// elements.  V fills 16 bytes (8 bf16 or 4 fp32 values, one 128-bit load)
// where the row's length, its stride and both pointers allow it, and is 1
// otherwise (any D, any row stride).  The second pass re-reads the
// row, which the first pass has just brought into L1/L2 (at most 32 KB for
// D = 8192 in fp32), so device memory sees each x once.  Any D >= 1 and any
// number of rows take the same path; a block holds 8 warps, 8 rows.
//
// Bound.  About 4 operations per element against 4 to 8 bytes moved (x in,
// y out): the function's least time is its bytes, x and y once and g once.
// The sum of squares is taken in another order than torch.mean's, so fp32
// outputs differ from the plain version in the last bits.
//
// Strides.  x is a (rows, D) view with a row stride and unit-stride
// elements; g (D,) any stride; out is contiguous (rows, D).  The kernel
// launches on the caller's stream and allocates nothing; the C entry points
// return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define WARPS 8  // rows per block, one per warp

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

// V consecutive elements at p (16-byte aligned when V > 1) as fp32
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f32(p[0]);
  } else {
    static_assert(V * sizeof(T) == 16, "one 128-bit load");
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f32(e[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = from_f32<T>(v[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// x[r, d] at r*sx + d; g[d] at d*sg; out[r, d] at r*D + d.  D and sx are
// multiples of V.
template <typename T, typename TG, int V>
__global__ void __launch_bounds__(32 * WARPS)
rmsnorm_kernel(const T* __restrict__ x, const TG* __restrict__ g, T* __restrict__ out,
               int64_t rows, int D, int64_t sx, int64_t sg, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;  // a whole warp leaves together
  const T* xr = x + r * sx;
  const int n_chunks = D / V;

  float s = 0.f;
#pragma unroll 4
  for (int c = lane; c < n_chunks; c += 32) {
    float v[V];
    load_vec<T, V>(xr + c * V, v);
#pragma unroll
    for (int i = 0; i < V; ++i) s = fmaf(v[i], v[i], s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float scale = rsqrtf(s / (float)D + eps);

  T* orow = out + r * (int64_t)D;
#pragma unroll 2
  for (int c = lane; c < n_chunks; c += 32) {
    float v[V];
    load_vec<T, V>(xr + c * V, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float one_g = __fadd_rn(1.f, to_f32(g[(int64_t)(c * V + i) * sg]));
      v[i] = __fmul_rn(__fmul_rn(v[i], scale), one_g);
    }
    store_vec<T, V>(orow + c * V, v);
  }
}

template <typename T, typename TG>
static int launch(const void* x, const void* g, void* out, int64_t rows, int D, int64_t sx,
                  int64_t sg, float eps, void* stream) {
  if (rows < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const int64_t n_blocks = (rows + WARPS - 1) / WARPS;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  const bool vec = D % V == 0 && sx % V == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    rmsnorm_kernel<T, TG, V><<<(unsigned)n_blocks, 32 * WARPS, 0, s>>>(
        (const T*)x, (const TG*)g, (T*)out, rows, D, sx, sg, eps);
  else
    rmsnorm_kernel<T, TG, 1><<<(unsigned)n_blocks, 32 * WARPS, 0, s>>>(
        (const T*)x, (const TG*)g, (T*)out, rows, D, sx, sg, eps);
  return (int)cudaGetLastError();
}

extern "C" {

#define RMSNORM_ENTRY(NAME, T, TG)                                                         \
  int NAME(const void* x, const void* g, void* out, int64_t rows, int D, int64_t sx,      \
           int64_t sg, float eps, void* stream) {                                          \
    return launch<T, TG>(x, g, out, rows, D, sx, sg, eps, stream);                         \
  }

RMSNORM_ENTRY(rmsnorm_f32_f32, float, float)
RMSNORM_ENTRY(rmsnorm_f32_bf16, float, __nv_bfloat16)
RMSNORM_ENTRY(rmsnorm_bf16_f32, __nv_bfloat16, float)
RMSNORM_ENTRY(rmsnorm_bf16_bf16, __nv_bfloat16, __nv_bfloat16)

#undef RMSNORM_ENTRY

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
