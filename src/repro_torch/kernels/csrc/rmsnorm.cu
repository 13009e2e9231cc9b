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
// Bound.  About 5 operations per element against 4 to 8 bytes moved (x in,
// y out): the function's least time is its bytes, x and y once and g once.
// A kernel reaches it only with enough bytes in flight to cover the memory
// latency, so the design is about what is in flight when.
//
// Design (rmsnorm_rows_kernel).  A row is cut into chunks of V elements:
// 16 bytes (8 bf16 or 4 fp32, one 128-bit load) where the row's length, its
// stride and both pointers allow it, else V = 1 (any D, any row stride).
// WPR warps own a row (the fewest of 1, 2, 4, 8 with at most 8 chunks a
// lane) and each lane holds NV of its chunks, a count fixed at compile time
// (1, 2, 3, 4, 6 or 8; the last slots predicated off), so the lane
// starts every load of its part of the row before it sums a square: the
// whole row is in flight at once and stays in registers for the second
// pass, which reads nothing from memory again.  The warp adds its lanes'
// sums with shuffles; with WPR > 1 the row's warps add their partial sums
// in a fixed order through shared memory (one barrier a row).  A block of
// 8 warps holds 8 / WPR rows at a time and walks the rows with a grid
// stride, the grid being what fits the card at once (the occupancy
// query), so 1 + g (fp32) is staged in shared memory once per block and
// every SM keeps several rows' loads in flight.  x is read and y written
// with the evict-first hints (ld/st.global.cs): each byte moves once.  At
// D = 864 in bf16 a lane holds 4 chunks (64 bytes), at D = 3072 a row is 2
// warps of 6 chunks, at D = 8192 4 warps of 8.  Widths past 8 warps of 8 chunks (D > 16384 in
// bf16, 8192 in fp32 or 2048 element by element) take the general kernel
// below.  The sum of squares is taken in another order than torch.mean's,
// so fp32 outputs differ from the plain version in the last bits.
//
// General kernel (rmsnorm_kernel): one warp per row, a loop whose trip
// count is set at run time, the row read a second time through L1/L2.
//
// Strides.  x is a (rows, D) view with a row stride and unit-stride
// elements; g (D,) any stride; out is contiguous (rows, D).  The kernels
// launch on the caller's stream and allocate nothing; the C entry points
// return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

#define WARPS 8      // warps a block
#define MAX_CHUNKS 8  // chunks a lane holds
// dynamic shared memory of the widest row-tile launch: 1 + g of
// 8 warps x 32 lanes x 8 chunks of 8 bf16
#define MAX_ROW_SMEM (WARPS * 32 * 8 * 8 * 4)

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

// V consecutive elements of type T, held as they were loaded
template <typename T, int V> struct Chunk {
  static_assert(V * sizeof(T) == 16, "one 128-bit load");
  uint4 raw;
  // read once: evict first (ld.global.cs), so the stream does not push
  // the rows still to be read out of L2
  __device__ __forceinline__ void load(const T* __restrict__ p) {
    raw = __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float get(int i) const {
    return to_f32(reinterpret_cast<const T*>(&raw)[i]);
  }
};
template <typename T> struct Chunk<T, 1> {
  T raw;
  __device__ __forceinline__ void load(const T* __restrict__ p) { raw = p[0]; }
  __device__ __forceinline__ float get(int) const { return to_f32(raw); }
};

// V consecutive elements at p (16-byte aligned when V > 1) as fp32
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&v)[V]) {
  Chunk<T, V> c;
  c.load(p);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = c.get(i);
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
    __stcs(reinterpret_cast<uint4*>(p), raw);  // written once: st.global.cs
  }
}

// x[r, d] at r*sx + d; g[d] at d*sg (bf16 where g_bf16, else fp32);
// out[r, d] at r*D + d.  D and sx are multiples of V; a row's chunk c of
// V elements is held by lane c % 32 of its warp (c / 32) % WPR, slot
// c / (32*WPR).
template <typename T, int V, int NV>
__global__ void __launch_bounds__(32 * WARPS)
rmsnorm_rows_kernel(const T* __restrict__ x, const void* __restrict__ g, int g_bf16,
                    T* __restrict__ out, int64_t rows, int D, int64_t sx, int64_t sg,
                    float eps, int wpr) {
  extern __shared__ float one_g[];  // 1 + g, fp32
  __shared__ float part[2][WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rpb = WARPS / wpr;  // rows a block holds at once
  const int grp = warp / wpr, w_in_row = warp - grp * wpr;
  const int n_chunks = D / V;
  const int c_first = w_in_row * 32 + lane;
  const int c_step = 32 * wpr;
  const int64_t stride = (int64_t)gridDim.x * rpb;
  Chunk<T, V> v[NV];
  auto load_row = [&](int64_t r) {
    const T* xr = x + r * sx;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = c_first + k * c_step;
      if (c < n_chunks) v[k].load(xr + c * V);
    }
  };
  // the first row's loads go out before 1 + g is staged, so the two trips
  // to memory overlap
  int64_t base = (int64_t)blockIdx.x * rpb;
  if (base + grp < rows) load_row(base + grp);
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float gv = g_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(g)[(int64_t)i * sg])
                            : static_cast<const float*>(g)[(int64_t)i * sg];
    one_g[i] = __fadd_rn(1.f, gv);
  }
  __syncthreads();
  int parity = 0;
  // every warp runs the same trip count, so the barriers below match
  for (; base < rows; base += stride, parity ^= 1) {
    const int64_t r = base + grp;
    const bool row_ok = r < rows;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = c_first + k * c_step;
      if (row_ok && c < n_chunks) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float e = v[k].get(i);
          s = fmaf(e, e, s);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (wpr > 1) {
      // the row's warps add their sums in one order; the two buffers let a
      // row's writes pass the previous row's reads with one barrier
      if (lane == 0) part[parity][warp] = s;
      __syncthreads();
      s = 0.f;
      for (int w = 0; w < wpr; ++w) s += part[parity][grp * wpr + w];
    }
    const float scale = rsqrtf(s / (float)D + eps);
    T* orow = out + (row_ok ? r : 0) * (int64_t)D;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = c_first + k * c_step;
      if (row_ok && c < n_chunks) {
        float y[V];
#pragma unroll
        for (int i = 0; i < V; ++i)
          y[i] = __fmul_rn(__fmul_rn(v[k].get(i), scale), one_g[c * V + i]);
        store_vec<T, V>(orow + c * V, y);
      }
    }
    if (r + stride < rows) load_row(r + stride);
  }
}

// The general kernel: one warp per row, 8 rows a block, g read from global
// memory, the row read twice.
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

// blocks of a kernel instance that fit one SM, and the SM count, asked of
// the runtime once per (device, instance, shared memory)
static cudaError_t fit_blocks(const void* kernel, int smem, int* blocks) {
  struct Entry { int dev; const void* kernel; int smem; int blocks; };
  static std::mutex mu;
  static Entry cache[256];
  static int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> hold(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].dev == dev && cache[i].kernel == kernel && cache[i].smem == smem) {
      *blocks = cache[i].blocks;
      return cudaSuccess;
    }
  if (smem > 48 * 1024) {
    // the most any instance takes (D = 16384 in bf16), so that a later
    // launch of the same instance with another D never finds it lowered
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_ROW_SMEM);
    if (e != cudaSuccess) return e;
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * WARPS, smem);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  if (used < 256) cache[used++] = {dev, kernel, smem, *blocks};
  return cudaSuccess;
}

template <typename T, int V, int NV>
static int launch_rows(const void* x, const void* g, int g_bf16, void* out, int64_t rows,
                       int D, int64_t sx, int64_t sg, float eps, int wpr, cudaStream_t s) {
  const void* kernel = reinterpret_cast<const void*>(rmsnorm_rows_kernel<T, V, NV>);
  const int smem = D * (int)sizeof(float);
  int fit = 0;
  cudaError_t e = fit_blocks(kernel, smem, &fit);
  if (e != cudaSuccess) return (int)e;
  const int rpb = WARPS / wpr;
  const int64_t want = (rows + rpb - 1) / rpb;
  const unsigned grid = (unsigned)(want < fit ? want : fit);
  rmsnorm_rows_kernel<T, V, NV><<<grid, 32 * WARPS, smem, s>>>(
      (const T*)x, g, g_bf16, (T*)out, rows, D, sx, sg, eps, wpr);
  return (int)cudaGetLastError();
}

// (warps a row, chunks a lane) of the row-tile instance for n_chunks
// chunks, or wpr = 0 where the general kernel takes the row
static void row_plan(int n_chunks, int* wpr, int* nv) {
  static const int counts[] = {1, 2, 3, 4, 6, MAX_CHUNKS};
  *wpr = 0;
  for (int w = 1; w <= WARPS; w *= 2) {
    const int need = (n_chunks + 32 * w - 1) / (32 * w);
    if (need > MAX_CHUNKS) continue;
    for (int c : counts)
      if (c >= need) {
        *wpr = w;
        *nv = c;
        return;
      }
  }
}

template <typename T, typename TG, int V>
static int launch_path(const void* x, const void* g, void* out, int64_t rows, int D,
                       int64_t sx, int64_t sg, float eps, cudaStream_t s) {
  int wpr = 0, nv = 0;
  row_plan(D / V, &wpr, &nv);
  const int g_bf16 = sizeof(TG) == 2;
  switch (wpr ? nv : 0) {
#define ROWS_CASE(NV)                                                                  \
  case NV:                                                                             \
    return launch_rows<T, V, NV>(x, g, g_bf16, out, rows, D, sx, sg, eps, wpr, s);
    ROWS_CASE(1)
    ROWS_CASE(2)
    ROWS_CASE(3)
    ROWS_CASE(4)
    ROWS_CASE(6)
    ROWS_CASE(8)
#undef ROWS_CASE
  }
  const int64_t n_blocks = (rows + WARPS - 1) / WARPS;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rmsnorm_kernel<T, TG, V><<<(unsigned)n_blocks, 32 * WARPS, 0, s>>>(
      (const T*)x, (const TG*)g, (T*)out, rows, D, sx, sg, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename TG>
static int launch(const void* x, const void* g, void* out, int64_t rows, int D, int64_t sx,
                  int64_t sg, float eps, void* stream) {
  if (rows < 1 || D < 1) return (int)cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  const bool vec = D % V == 0 && sx % V == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch_path<T, TG, V>(x, g, out, rows, D, sx, sg, eps, s)
             : launch_path<T, TG, 1>(x, g, out, rows, D, sx, sg, eps, s);
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

// (warps a row, chunks a lane) of the row-tile instance for D elements in
// chunks of V, as the launch picks it (wpr = 0: the general kernel)
int rmsnorm_plan(int D, int V, int* wpr, int* nv) {
  if (D < 1 || V < 1 || D % V) return (int)cudaErrorInvalidValue;
  *nv = 0;
  row_plan(D / V, wpr, nv);
  return 0;
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
