// Two-level (inner R / outer S) FFT causal convolution for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/twolevel_fft.py::_twolevel_kernel.
// For each (batch row, channel) it computes, on N = next_fast_len(2L-1) = R*S
// points, exactly the stages of that kernel and from the same DFT tables
// (repro_torch.core.blockfft._dft_mats, built in float64 and rounded to
// complex64 on the host):
//
//   0. the real input column, zero-padded to N, A[r, s] = u[r*S + s];
//   1. the inner R-point DFT over r, then the twiddle W_N^{k1 s};
//   2. the outer S-point DFT over s, then the product with the filter
//      spectrum H[k1, k2, d] (computed outside, with the same (R, S) split);
//   3. the inverse outer DFT, then the conjugate twiddle;
//   4. the inverse inner DFT, real part only, times 1/N, and the epilogue of
//      repro.core.fftconv._fused_epilogue: skip*u added in fp32, downcast to
//      the output dtype, THEN the gate multiplied in the output dtype.
//
// Design.  The TPU kernel accumulates r-chunks in VMEM across sequential
// grid steps; CUDA blocks run in parallel and share nothing, so here one
// block owns a whole padded column (one batch row, a tile of TD = 1, 2 or
// 4 channels) in shared memory as fp32 (re, im) planes, 8*N bytes per
// channel, and runs every stage on it.  Each stage writes a full plane
// that its own inputs still occupy, so a thread first computes its outputs
// (at most STAGED position-channel pairs) into registers, the block
// synchronises, and then the outputs are stored.  The DFT sums are direct
// sums over R or S (4NR + 8NS fp32 FMAs per channel), with the tables read
// from global memory through the read-only cache.  A thread computes one
// grid position for all TD channels of its tile, which lie side by side in
// shared memory: one vector load brings TD channels, and each table value
// loaded serves TD channels.  Threads of a warp walk consecutive s (or k2),
// so shared-memory reads are conflict-free or broadcast and table reads
// coalesce or broadcast.  FR and FS are symmetric (their exponents are
// outer(r, r) and outer(s, s)), which the host checks; the inverse outer
// DFT reads FS[q, s] for FS[s, q] so that its reads coalesce too.
//
// Bound.  At the served shape the function's least time on the card is
// set by bytes: u, gate and the output cross device memory once, and an
// O(N log N) FFT needs slightly fewer operations than that takes.  These direct sums do 4NR + 8NS fp32
// FMAs per channel instead, so this kernel is bound by its own fp32
// operations on the CUDA cores.  Loads, not FMAs, are what the inner loops
// issue most, hence the channel vectors above; the design spends nothing
// on tensor cores yet — running the DFTs as wgmma products, or as a
// radix-2/4 FFT in shared memory, is the way to a faster kernel.
//
// The kernel launches on the caller's stream and allocates nothing.  The C
// entry points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

// position-channel outputs a thread holds in registers across a sync
#define STAGED 16
#define MAX_DEVICES 64

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

// TD consecutive floats of shared memory, moved as one vector
template <int TD> struct Vec;
template <> struct Vec<1> {
  static __device__ __forceinline__ void ld(const float* p, float (&v)[1]) { v[0] = *p; }
  static __device__ __forceinline__ void st(float* p, const float (&v)[1]) { *p = v[0]; }
};
template <> struct Vec<2> {
  static __device__ __forceinline__ void ld(const float* p, float (&v)[2]) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
  static __device__ __forceinline__ void st(float* p, const float (&v)[2]) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};
template <> struct Vec<4> {
  static __device__ __forceinline__ void ld(const float* p, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  static __device__ __forceinline__ void st(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// store the staged outputs of a stage back into the planes
template <int TD, int POS>
__device__ __forceinline__ void store_staged(float* re, float* im, int N,
                                             const float (&vre)[POS][TD],
                                             const float (&vim)[POS][TD]) {
#pragma unroll
  for (int j = 0; j < POS; ++j) {
    const int p = threadIdx.x + j * blockDim.x;
    if (p < N) {
      Vec<TD>::st(re + p * TD, vre[j]);
      Vec<TD>::st(im + p * TD, vim[j]);
    }
  }
}

// Launch bounds per tile width.  The launch shape (twolevel_fft.py
// launch_shape) gives 1024 threads only to one-channel tiles (N > 8192),
// and at most 512 to 2- and 4-channel tiles, which ask for two blocks per
// SM.  Either way ptxas gets 64 registers a thread and spills a little:
// measured on the H100, 512 threads with one block per SM (74 registers,
// no spills in the served instance) ran 1.5 % slower than two blocks of
// 64 registers.
template <int TD> struct Bounds {
  static constexpr int threads = TD == 1 ? 1024 : 512;
  static constexpr int blocks = TD == 1 ? 1 : 2;
};

template <typename T, int TD>
__global__ void __launch_bounds__(Bounds<TD>::threads, Bounds<TD>::blocks) twolevel_fft_conv_kernel(
    const T* __restrict__ u,          // (B, L, D)
    const T* __restrict__ gate,       // (B, L, D) or null
    const float* __restrict__ skip,   // (D,) or null
    const float2* __restrict__ hc,    // (R, S, D) filter spectrum, complex64
    const float* __restrict__ frre,   // (R, R) inner DFT
    const float* __restrict__ frim,
    const float* __restrict__ twre,   // (R, S) twiddle W_N^{k1 s}
    const float* __restrict__ twim,
    const float* __restrict__ fsre,   // (S, S) outer DFT
    const float* __restrict__ fsim,
    T* __restrict__ out,              // (B, L, D)
    int L, int D, int R, int S) {
  constexpr int POS = STAGED / TD;  // grid positions a thread stages
  extern __shared__ float4 smem_vec[];
  const int N = R * S;
  float* re = reinterpret_cast<float*>(smem_vec);  // position p, channel c at p*TD + c
  float* im = re + N * TD;
  const int d0 = blockIdx.x * TD;
  const int64_t row = (int64_t)blockIdx.y * L * D;  // u[b, t, d] = row + t*D + d
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  float vre[POS][TD];
  float vim[POS][TD];

  // ---- stage 0: the real input column, zero past L and past D
  for (int t = tid; t < N; t += nt) {
    float x[TD];
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      const int d = d0 + c;
      x[c] = (t < L && d < D) ? to_f32(u[row + (int64_t)t * D + d]) : 0.f;
    }
    Vec<TD>::st(re + t * TD, x);
  }
  __syncthreads();

  // ---- stage 1: B[k1, s] = sum_r FR[k1, r] A[r, s]; U = B * TW[k1, s]
#pragma unroll
  for (int j = 0; j < POS; ++j) {
    const int p = tid + j * nt;  // = k1*S + s
    if (p < N) {
      const int k1 = p / S;
      const int s = p - k1 * S;
      const float* fr = frre + k1 * R;
      const float* fi = frim + k1 * R;
      float bre[TD], bim[TD];
#pragma unroll
      for (int c = 0; c < TD; ++c) bre[c] = bim[c] = 0.f;
      for (int r = 0; r < R; ++r) {
        float a[TD];
        Vec<TD>::ld(re + (r * S + s) * TD, a);
        const float wr = __ldg(fr + r), wi = __ldg(fi + r);
#pragma unroll
        for (int c = 0; c < TD; ++c) {
          bre[c] = fmaf(wr, a[c], bre[c]);
          bim[c] = fmaf(wi, a[c], bim[c]);
        }
      }
      const float tr = __ldg(twre + p), ti = __ldg(twim + p);
#pragma unroll
      for (int c = 0; c < TD; ++c) {
        vre[j][c] = bre[c] * tr - bim[c] * ti;
        vim[j][c] = bre[c] * ti + bim[c] * tr;
      }
    }
  }
  __syncthreads();
  store_staged<TD, POS>(re, im, N, vre, vim);
  __syncthreads();

  // ---- stage 2: C[k1, k2] = sum_s U[k1, s] FS[s, k2]; Y = C * H[k1, k2, d]
#pragma unroll
  for (int j = 0; j < POS; ++j) {
    const int p = tid + j * nt;  // = k1*S + k2
    if (p < N) {
      const int k1 = p / S;
      const int k2 = p - k1 * S;
      const float* xr = re + k1 * S * TD;
      const float* xi = im + k1 * S * TD;
      float cre[TD], cim[TD];
#pragma unroll
      for (int c = 0; c < TD; ++c) cre[c] = cim[c] = 0.f;
      for (int s = 0; s < S; ++s) {
        float ar[TD], ai[TD];
        Vec<TD>::ld(xr + s * TD, ar);
        Vec<TD>::ld(xi + s * TD, ai);
        const float fr = __ldg(fsre + s * S + k2), fi = __ldg(fsim + s * S + k2);
#pragma unroll
        for (int c = 0; c < TD; ++c) {
          cre[c] = fmaf(ar[c], fr, fmaf(-ai[c], fi, cre[c]));
          cim[c] = fmaf(ar[c], fi, fmaf(ai[c], fr, cim[c]));
        }
      }
#pragma unroll
      for (int c = 0; c < TD; ++c) {
        const int d = d0 + c;
        float hr = 0.f, hi = 0.f;
        if (d < D) {
          const float2 hv = __ldg(hc + (int64_t)p * D + d);
          hr = hv.x;
          hi = hv.y;
        }
        vre[j][c] = cre[c] * hr - cim[c] * hi;
        vim[j][c] = cre[c] * hi + cim[c] * hr;
      }
    }
  }
  __syncthreads();
  store_staged<TD, POS>(re, im, N, vre, vim);
  __syncthreads();

  // ---- stage 3: D[k1, s] = sum_q Y[k1, q] conj(FS[s, q]); E = D * conj(TW)
#pragma unroll
  for (int j = 0; j < POS; ++j) {
    const int p = tid + j * nt;  // = k1*S + s
    if (p < N) {
      const int k1 = p / S;
      const int s = p - k1 * S;
      const float* yr = re + k1 * S * TD;
      const float* yi = im + k1 * S * TD;
      float dre[TD], dim[TD];
#pragma unroll
      for (int c = 0; c < TD; ++c) dre[c] = dim[c] = 0.f;
      for (int q = 0; q < S; ++q) {
        float ar[TD], ai[TD];
        Vec<TD>::ld(yr + q * TD, ar);
        Vec<TD>::ld(yi + q * TD, ai);
        // FS is symmetric: FS[s, q] == FS[q, s]
        const float fr = __ldg(fsre + q * S + s), fi = __ldg(fsim + q * S + s);
#pragma unroll
        for (int c = 0; c < TD; ++c) {
          dre[c] = fmaf(ar[c], fr, fmaf(ai[c], fi, dre[c]));
          dim[c] = fmaf(ai[c], fr, fmaf(-ar[c], fi, dim[c]));
        }
      }
      const float tr = __ldg(twre + p), ti = __ldg(twim + p);
#pragma unroll
      for (int c = 0; c < TD; ++c) {
        vre[j][c] = dre[c] * tr + dim[c] * ti;
        vim[j][c] = dim[c] * tr - dre[c] * ti;
      }
    }
  }
  __syncthreads();
  store_staged<TD, POS>(re, im, N, vre, vim);
  __syncthreads();

  // ---- stage 4: y[r*S + s] = Re sum_k conj(FR[k, r]) E[k, s] / N, for
  // t < L only, then the fused epilogue straight to global memory
  const float inv_n = 1.0f / (float)N;
  for (int t = tid; t < L; t += nt) {
    const int r = t / S;
    const int s = t - r * S;
    float acc[TD];
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[c] = 0.f;
    for (int k = 0; k < R; ++k) {
      float er[TD], ei[TD];
      Vec<TD>::ld(re + (k * S + s) * TD, er);
      Vec<TD>::ld(im + (k * S + s) * TD, ei);
      const float wr = __ldg(frre + k * R + r), wi = __ldg(frim + k * R + r);
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[c] = fmaf(wi, ei[c], fmaf(wr, er[c], acc[c]));
    }
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      const int d = d0 + c;
      if (d < D) {
        const int64_t off = row + (int64_t)t * D + d;
        float y = acc[c] * inv_n;
        if (skip != nullptr) y = fmaf(to_f32(u[off]), skip[d], y);
        T o = from_f32<T>(y);
        if (gate != nullptr) o = from_f32<T>(to_f32(o) * to_f32(gate[off]));
        out[off] = o;
      }
    }
  }
}

template <typename T, int TD>
static int launch_td(const void* u, const void* gate, const float* skip,
                     const float* hc,
                     const float* frre, const float* frim,
                     const float* twre, const float* twim,
                     const float* fsre, const float* fsim, void* out,
                     int B, int L, int D, int R, int S, int threads,
                     int smem_bytes, cudaStream_t stream) {
  if (threads > Bounds<TD>::threads) return (int)cudaErrorInvalidConfiguration;
  if (smem_bytes > 48 * 1024) {
    // raise this instance's dynamic shared-memory limit on the current
    // device once, and again only for a launch that needs more
    static std::mutex mu;
    static int raised[MAX_DEVICES] = {0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> hold(mu);
    if (smem_bytes > raised[dev]) {
      e = cudaFuncSetAttribute(twolevel_fft_conv_kernel<T, TD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (e != cudaSuccess) return (int)e;
      raised[dev] = smem_bytes;
    }
  }
  dim3 grid((D + TD - 1) / TD, B);
  twolevel_fft_conv_kernel<T, TD><<<grid, threads, smem_bytes, stream>>>(
      (const T*)u, (const T*)gate, skip, (const float2*)hc, frre, frim, twre, twim,
      fsre, fsim, (T*)out, L, D, R, S);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* u, const void* gate, const float* skip,
                  const float* hc,
                  const float* frre, const float* frim,
                  const float* twre, const float* twim,
                  const float* fsre, const float* fsim, void* out,
                  int B, int L, int D, int R, int S, int td, int threads,
                  int smem_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (td) {
    case 1:
      return launch_td<T, 1>(u, gate, skip, hc, frre, frim, twre, twim,
                             fsre, fsim, out, B, L, D, R, S, threads, smem_bytes, st);
    case 2:
      return launch_td<T, 2>(u, gate, skip, hc, frre, frim, twre, twim,
                             fsre, fsim, out, B, L, D, R, S, threads, smem_bytes, st);
    case 4:
      return launch_td<T, 4>(u, gate, skip, hc, frre, frim, twre, twim,
                             fsre, fsim, out, B, L, D, R, S, threads, smem_bytes, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

int twolevel_fft_conv_f32(const void* u, const void* gate, const float* skip,
                          const float* hc,
                          const float* frre, const float* frim,
                          const float* twre, const float* twim,
                          const float* fsre, const float* fsim, void* out,
                          int B, int L, int D, int R, int S, int td,
                          int threads, int smem_bytes, void* stream) {
  return launch<float>(u, gate, skip, hc, frre, frim, twre, twim, fsre,
                       fsim, out, B, L, D, R, S, td, threads, smem_bytes, stream);
}

int twolevel_fft_conv_bf16(const void* u, const void* gate, const float* skip,
                           const float* hc,
                           const float* frre, const float* frim,
                           const float* twre, const float* twim,
                           const float* fsre, const float* fsim, void* out,
                           int B, int L, int D, int R, int S, int td,
                           int threads, int smem_bytes, void* stream) {
  return launch<__nv_bfloat16>(u, gate, skip, hc, frre, frim, twre, twim,
                               fsre, fsim, out, B, L, D, R, S, td, threads,
                               smem_bytes, stream);
}

const char* twolevel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int twolevel_staged(void) { return STAGED; }

}  // extern "C"
