// Two-level (inner R / outer S) FFT causal convolution for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/twolevel_fft.py::_twolevel_kernel.
// For each (batch row, channel) it computes, on N = next_fast_len(2L-1) = R*S
// points, the stages of that kernel from the same DFT tables
// (repro_torch.core.blockfft._dft_mats, built in float64 and rounded to
// complex64 on the host):
//
//   0. the real input column, zero-padded to N, A[r, s] = u[r*S + s];
//   1. the inner R-point DFT over r, then the twiddle W_N^{k1 s};
//   2. the outer S-point DFT over s, then the product with the filter
//      spectrum H[k1, k2, d] (the same two stages run on the taps h);
//   3. the inverse outer DFT, then the conjugate twiddle;
//   4. the inverse inner DFT, real part only, times 1/N, and the epilogue of
//      repro.core.fftconv._fused_epilogue: skip*u added in fp32, downcast to
//      the output dtype, THEN the gate multiplied in the output dtype.
//
// Bound.  At the served shape (B = 4, L = 1024, D = 864, bf16) the
// function's least time on the card is set by bytes: u, gate and the output
// cross device memory once (7.4 us at 3.35 TB/s), and an O(N log N) FFT
// needs fewer operations than that.  The four-step form computes each DFT
// as dense products instead: 4NR + 8NS multiply-adds per column, 1.05 M at
// N = 2048 = 64 * 32, 7.25 GFLOP over the 3456 columns.  On the CUDA cores
// (67 TFLOP/s fp32) that alone takes over 100 us; on the tensor cores it
// takes a few tens.
//
// bf16 path (tc::twolevel_tc_kernel): the four DFT stages as TF32 tensor-core
// products.  Every operand of a product is rounded to TF32 with
// cvt.rna.tf32.f32 (round to nearest, ties away: relative error <= 2^-11;
// raw fp32 bits would be truncated, twice the error), and every product sums
// in fp32 (kernels/twolevel_fft.py::TOLERANCE derives the bound).  The
// twiddles, the product with H, the 1/N scale and the epilogue stay fp32 on
// the CUDA cores.  Products run as mma.sync.m16n8k8.row.col.f32.tf32: the
// flash kernel's mma.sync route, whose fragment layouts are fixed by the
// PTX tables and need no shared-memory descriptors (wgmma's tf32 form wants
// both operands K-major in shared memory, so every stage would have to
// store its output transposed for the next; mma.sync takes the A operand
// from registers, which is what lets stages 1 -> 2 -> 3 chain without
// touching shared memory).  Stage 1 is FR . A (M = k1, K = r, N = s, two
// real products: the input is real); stages 2 and 3 are U . FS and
// Y . conj(FS) (M = k1, N = K = S, four real products each: the
// three-product form was not used); stage 4 is Re(conj(FR)^T . E) (M = r,
// K = k, N = s, two real products).
//
// Layout.  A team of MT warps owns one column (the R axis padded to MT = 1,
// 2 or 4 m-tiles of 16 rows); warp w owns rows 16w .. 16w + 15 of the R axis
// in stages 1-3 (k1) and of stage 4's output (r).  A C fragment holds
// (row g, cols 2q, 2q+1) and (row g + 8, same cols) of a 16 x 8 tile (g =
// lane / 4, q = lane % 4); an A fragment of m16n8k8 holds (row g, k-slot q)
// and (row g + 8, k-slot q + 4).  Since the order of a sum is free, k-slot q
// of k-step j is taken to be column 8j + 2q and slot q + 4 column 8j + 2q +
// 1: then the C fragment (c0, c1, c2, c3) of stage n is the A fragment (c0,
// c2, c1, c3) of stage n + 1, and U and Y never leave registers.  The B
// operands come from shared memory in fragment order, so that a lane reads
// its whole fragment with one 8- or 16-byte load and a warp's load is free
// of bank conflicts: FS (re0, re1, im0, im1) and (-im0, -im1) per lane,
// built on the host, so that no operand needs its sign flipped; the input
// column as (b0, b1) pairs; E, written by stage 3 and read by stage 4.
// Stage 4 sums over k, across the warps, so E goes through shared memory:
// its k-slots are ordered so that the C fragment's rows g and g + 8 are one
// (b0, b1) pair, and the team writes E with one 16-byte store per lane and
// tile, XOR-swizzled on the lane to keep the stores conflict-free.  FR (in
// the same k order, for stages 1 and 4: it is symmetric), FS and TW live in
// shared memory once per block, copied by cp.async, FR and FS rounded to
// TF32 in place.  Rows past R, columns past S and k-slots past R are zero
// in the tables, which makes the padded products exact.  Stage 1 skips the
// k-steps whose rows are all past L (half of them, since N >= 2L - 1), and
// stage 4 computes only the rows with outputs, splitting their tiles over
// the team's warps.  Stages 2 and 3 finish one output n-tile at a time, so
// 8 accumulators are live beside the 8 NT registers of their A operand.
//
// Block and operands.  A block holds `teams` teams (4 at N = 2048: 512
// threads) that own consecutive channels c0 .. c0 + teams - 1 and walk the
// batch rows together, one step per row.  For a step the block holds u and
// the gate of its channels as [t][teams] bf16 tiles in shared memory:
// u[b, t, c0 ..] is one 2*teams-byte chunk of a row, copied by cp.async,
// and the next step's tiles load (double-buffered) while this step
// computes.  Each team builds its column's B fragments from the u tile,
// writes its outputs into the gate tile over the gate it read, and the
// block stores the tile's rows as chunks.  u and the gate are read through
// all three strides, so the model's torch.split views of its projection
// cost no copy; views whose rows are not aligned for the chunk copy, and a
// ragged last group of channels, are copied element by element.  The
// output is contiguous.
//
// The filter.  At the first step of a unit (a group of channels and a run
// of `bpu` batch rows) each team runs stages 1-2 on its channel's taps h
// (read through its strides, fp32 or bf16, rounded to TF32) and keeps H in
// shared memory in the C-fragment order of stage 2: each lane later reads
// back the very values it wrote, so H costs no barrier.  The wrapper takes
// bpu = B, H once per channel, unless shorter runs balance the grid's
// waves better (they do not at the served shape).  The H-given instance
// (HGIVEN) reads H[k1, k2, d] from global memory into the same place and
// shares the rest.
//
// Registers and shared memory (ptxas, PERF.md): at N = 2048 the served
// instance (NT = 4) takes 126 registers of the 128 its 512 threads allow,
// no spills, and 225,280 bytes of dynamic shared memory (tables 61,440,
// four teams' column / E buffers and H 131,072, two steps' tiles 32,768):
// one block per SM, 132 blocks.  Instances are templated on NT =
// ceil(S / 8) <= 8 (S <= 64) and take R <= 64; launch bounds give 128
// registers a thread for NT <= 4 and 255 above, and every instance builds
// without spills.  Two things keep it so: the launch plan (unit counts,
// m-tiles as powers of two) is computed on the host, and values derived
// from the thread index or the loop state are recomputed where they are
// used (tid_x, opaque) instead of held across the step loop.
//
// What bounds it now: latency, not the tensor pipe.  A build that issues
// every stage 2-3 product twice runs in the same time (PERF.md): the
// products wait on their dependent accumulator chains (8 deep per n-tile in
// stages 2-3), on shared-memory loads and on the five barriers of a step,
// with 16 warps an SM to hide them.  The grid's 216 units of 4 rows on 132
// SMs also leave 48 SMs idle in the second wave, 18 % of the SM time.
//
// fp32 path (twolevel_fft_conv_kernel), and bf16 shapes past R = 64 or
// S = 64 (L > 2048 at the default split): the CUDA-core kernel.  One block
// per (batch row, tile of TD = 1, 2 or 4 channels) holds the padded column
// in shared memory as fp32 (re, im) planes and runs every stage as direct
// fp32 sums, the tables read through the read-only cache, H given (the
// wrapper computes it with the plain four-step transform, in fp32).  It is
// bound by its own fp32 FMAs and table loads; it keeps its 1e-4 agreement.
//
// The kernels launch on the caller's stream and allocate nothing.  The C
// entry points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

// position-channel outputs a thread holds in registers across a sync
#define STAGED 16
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

// ------------------------------------------------------------ CUDA-core path

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

// one block per (batch row, tile of TD channels); u[b, t, d] and gate[b, t, d]
// at b*s_b + t*s_t + d*s_d, out contiguous (B, L, D)
template <typename T, int TD>
__global__ void __launch_bounds__(Bounds<TD>::threads, Bounds<TD>::blocks) twolevel_fft_conv_kernel(
    const T* __restrict__ u, int64_t su_b, int64_t su_t, int64_t su_d,
    const T* __restrict__ gate, int64_t sg_b, int64_t sg_t, int64_t sg_d,  // gate or null
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
  const int b = blockIdx.y;
  const T* ub = u + (int64_t)b * su_b;
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
      x[c] = (t < L && d < D) ? to_f32(ub[(int64_t)t * su_t + (int64_t)d * su_d]) : 0.f;
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
        float y = acc[c] * inv_n;
        if (skip != nullptr)
          y = fmaf(to_f32(ub[(int64_t)t * su_t + (int64_t)d * su_d]), skip[d], y);
        T o = from_f32<T>(y);
        if (gate != nullptr)
          o = from_f32<T>(to_f32(o) *
                          to_f32(gate[(int64_t)b * sg_b + (int64_t)t * sg_t + (int64_t)d * sg_d]));
        out[((int64_t)b * L + t) * D + d] = o;
      }
    }
  }
}

template <typename T, int TD>
static int launch_td(const void* u, const int64_t* su, const void* gate, const int64_t* sg,
                     const float* skip, const float* hc,
                     const float* frre, const float* frim,
                     const float* twre, const float* twim,
                     const float* fsre, const float* fsim, void* out,
                     int B, int L, int D, int R, int S, int threads,
                     int smem_bytes, cudaStream_t stream) {
  if (threads > Bounds<TD>::threads) return (int)cudaErrorInvalidConfiguration;
  static int raised[MAX_DEVICES] = {0};
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(twolevel_fft_conv_kernel<T, TD>),
                             smem_bytes, raised);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((D + TD - 1) / TD, B);
  twolevel_fft_conv_kernel<T, TD><<<grid, threads, smem_bytes, stream>>>(
      (const T*)u, su[0], su[1], su[2], (const T*)gate, sg[0], sg[1], sg[2], skip,
      (const float2*)hc, frre, frim, twre, twim, fsre, fsim, (T*)out, L, D, R, S);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* u, const int64_t* su, const void* gate, const int64_t* sg,
                  const float* skip, const float* hc,
                  const float* frre, const float* frim,
                  const float* twre, const float* twim,
                  const float* fsre, const float* fsim, void* out,
                  int B, int L, int D, int R, int S, int td, int threads,
                  int smem_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (td) {
    case 1:
      return launch_td<T, 1>(u, su, gate, sg, skip, hc, frre, frim, twre, twim,
                             fsre, fsim, out, B, L, D, R, S, threads, smem_bytes, st);
    case 2:
      return launch_td<T, 2>(u, su, gate, sg, skip, hc, frre, frim, twre, twim,
                             fsre, fsim, out, B, L, D, R, S, threads, smem_bytes, st);
    case 4:
      return launch_td<T, 4>(u, su, gate, sg, skip, hc, frre, frim, twre, twim,
                             fsre, fsim, out, B, L, D, R, S, threads, smem_bytes, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// --------------------------------------------------------- tensor-core path

namespace tc {

constexpr int MAX_NT = 8;     // S <= 64
constexpr int MAX_R = 64;     // four m-tiles
constexpr int MAX_TEAMS = 8;  // named barriers 1 .. 8

template <int NT> struct Bounds {
  static constexpr int threads = NT <= 4 ? 512 : 256;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ float rna(float x) { return __uint_as_float(to_tf32(x)); }
__device__ __forceinline__ float bf16_f32(uint16_t x) { return __uint_as_float((uint32_t)x << 16); }
__device__ __forceinline__ uint16_t f32_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// c (16 x 8, fp32) += a (16 x 8, tf32, row-major) . b (8 x 8, tf32, col-major)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// BYTES (4, 8 or 16) global -> shared, asynchronously
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src), "n"(BYTES));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// threadIdx.x, read where it is used: what derives from it is recomputed
// there (a few integer operations) instead of being hoisted out of the step
// loop and held in registers, which at 128 registers a thread spills
__device__ __forceinline__ int tid_x() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// x, as a value the compiler cannot prove equal to x: what is computed from
// it is not merged with the same computation earlier in the loop, whose
// result would then stay live (in a register) in between
__device__ __forceinline__ int opaque(int x) {
  int y;
  asm volatile("mov.b32 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// barrier of one team (`threads` threads) on named barrier `id` >= 1
__device__ __forceinline__ void team_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Row of the R axis that k-slot kap (0..7) of k-step i stands for, in the
// R-long sums of stages 1 and 4.  Rows 16m .. 16m + 15 are k-steps 2m and
// 2m + 1: slots 0-3 are rows 16m + 4(i & 1) + 0..3 and slots 4-7 the same
// plus 8, so that rows g and g + 8 of a C fragment are one (b0, b1) pair.
// kernels/twolevel_fft.py::_tc_tables orders FR's k columns the same way.
__device__ __forceinline__ int krow(int i, int kap) {
  return 16 * (i >> 1) + 4 * (i & 1) + (kap & 3) + 8 * (kap >> 2);
}

// lane slot of E's 16-byte fragments: XOR bits 1-2 with bits 3-4, so that
// the 8 lanes of a store phase hit 8 distinct 16-byte bank groups
__device__ __forceinline__ int eswz(int l) { return l ^ (((l >> 3) & 3) << 1); }

__device__ __forceinline__ float ld_elem(const void* p, int64_t i, int is_bf16) {
  return is_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

// The operands of one step (batch row b, channels c0 .. c0 + teams - 1): u
// and the gate as tiles [t][teams] of bf16 bits.  `vec`: each tile row is
// one aligned 2*teams-byte chunk of a full group, copied by cp.async (the
// caller commits); else element by element, zero past D.
struct Operands {
  const uint16_t* u;
  int64_t su_b, su_t, su_d;
  const uint16_t* gate;  // or null
  int64_t sg_b, sg_t, sg_d;
};

template <int BYTES>
__device__ __forceinline__ void copy_rows(uint16_t* tile, const uint16_t* src, int64_t s_t, int L,
                                          int teams) {
  for (int t = threadIdx.x; t < L; t += blockDim.x)
    cp_async<BYTES>(smem_u32(tile + t * teams), src + (int64_t)t * s_t);
}

__device__ __forceinline__ void load_tiles(uint16_t* tu, uint16_t* tg, const Operands& op, int b,
                                           int c0, int teams, int L, int D, bool vec) {
  const uint16_t* ub = op.u + (int64_t)b * op.su_b + (int64_t)c0 * op.su_d;
  const uint16_t* gb = op.gate == nullptr ? nullptr : op.gate + (int64_t)b * op.sg_b + (int64_t)c0 * op.sg_d;
  if (vec) {
    switch (teams) {
      case 2:
        copy_rows<4>(tu, ub, op.su_t, L, 2);
        if (gb != nullptr) copy_rows<4>(tg, gb, op.sg_t, L, 2);
        break;
      case 4:
        copy_rows<8>(tu, ub, op.su_t, L, 4);
        if (gb != nullptr) copy_rows<8>(tg, gb, op.sg_t, L, 4);
        break;
      default:
        copy_rows<16>(tu, ub, op.su_t, L, 8);
        if (gb != nullptr) copy_rows<16>(tg, gb, op.sg_t, L, 8);
    }
    return;
  }
  for (int e = threadIdx.x; e < L * teams; e += blockDim.x) {
    const int t = e / teams, k = e - t * teams;
    const bool in = c0 + k < D;
    tu[e] = in ? ub[(int64_t)t * op.su_t + (int64_t)k * op.su_d] : (uint16_t)0;
    if (gb != nullptr) tg[e] = in ? gb[(int64_t)t * op.sg_t + (int64_t)k * op.sg_d] : (uint16_t)0;
  }
}

// the output tile [t][teams] to out[b, t, c0 ..] (contiguous (B, L, D));
// `vec`: rows as aligned 2*teams-byte chunks of a full group
__device__ __forceinline__ void store_tile(uint16_t* out, const uint16_t* to, int b, int c0,
                                           int teams, int L, int D, bool vec) {
  uint16_t* ob = out + (int64_t)b * L * D + c0;
  if (vec) {
    for (int t = threadIdx.x; t < L; t += blockDim.x) {
      uint16_t* dst = ob + (int64_t)t * D;
      const uint16_t* src = to + t * teams;
      if (teams == 2)
        *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
      else if (teams == 4)
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
      else
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    }
    return;
  }
  for (int e = threadIdx.x; e < L * teams; e += blockDim.x) {
    const int t = e / teams, k = e - t * teams;
    if (c0 + k < D) ob[(int64_t)t * D + k] = to[e];
  }
}

// The column of one channel into buf as stage 1's B fragments: float f of
// buf is half f & 1 of lane (f >> 1) & 31 of tile (k-step i, n-tile jn) =
// f >> 6, holding row krow(i, lane % 4 + 4 half), column 8 jn + lane / 4, so
// t = row * S + column (0 past L).  Only the KR1 k-steps that stage 1 reads.
// From the taps in global memory (h[off + t*st], fp32 or bf16) or from a u
// tile in shared memory (tile[t * teams], bf16).
template <int NT, bool TILE>
__device__ __forceinline__ void load_column(float* buf, const void* src, int64_t off, int64_t st,
                                            int is_bf16, int L, int R, int S, int KR1,
                                            int tthreads) {
  constexpr int U = 8;  // loads in flight per thread
  const int n = KR1 * NT * 64;
  const int ttid = tid_x() & (tthreads - 1);
  for (int f0 = ttid; f0 < n; f0 += U * tthreads) {
    float v[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int f = f0 + k * tthreads;
      v[k] = 0.f;
      if (f < n) {
        const int half = f & 1, ln = (f >> 1) & 31, blk = f >> 6;
        const int i = blk / NT, jn = blk - i * NT;
        const int r = krow(i, (ln & 3) + 4 * half), s = 8 * jn + (ln >> 2);
        const int t = r * S + s;
        if (r < R && s < S && t < L) {
          if (TILE)
            v[k] = bf16_f32(reinterpret_cast<const uint16_t*>(src)[off + (int64_t)t * st]);
          else
            v[k] = ld_elem(src, off + (int64_t)t * st, is_bf16);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int f = f0 + k * tthreads;
      if (f < n) buf[f] = rna(v[k]);
    }
  }
}

// stage 1: X = FR . A over the KR1 k-steps that hold rows < L / S, for the
// warp's m-tile; FR's fragments from frt, A's from buf
template <int NT>
__device__ __forceinline__ void stage1(const float4* frt, const float* buf, int mt, int KR,
                                       int KR1, int lane, float (&xr)[NT][4],
                                       float (&xi)[NT][4]) {
#pragma unroll
  for (int jn = 0; jn < NT; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) xr[jn][e] = xi[jn][e] = 0.f;
  const float2* b2 = reinterpret_cast<const float2*>(buf);
  for (int i = 0; i < KR1; ++i) {
    const float4 ar = frt[((mt * KR + i) * 2) * 32 + lane];
    const float4 ai = frt[((mt * KR + i) * 2 + 1) * 32 + lane];
    const uint32_t Ar[4] = {bits(ar.x), bits(ar.y), bits(ar.z), bits(ar.w)};
    const uint32_t Ai[4] = {bits(ai.x), bits(ai.y), bits(ai.z), bits(ai.w)};
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      const float2 bv = b2[(i * NT + jn) * 32 + lane];
      mma(xr[jn], Ar, bits(bv.x), bits(bv.y));
      mma(xi[jn], Ai, bits(bv.x), bits(bv.y));
    }
  }
}

// x * w (complex, elementwise on a C fragment) as the next stage's tf32 A
// fragment: C (c0, c1, c2, c3) -> A (c0, c2, c1, c3)
__device__ __forceinline__ void cmul_to_a(const float (&xr)[4], const float (&xi)[4],
                                          const float4& wr4, const float4& wi4,
                                          uint32_t (&Ar)[4], uint32_t (&Ai)[4]) {
  const float wr[4] = {wr4.x, wr4.y, wr4.z, wr4.w};
  const float wi[4] = {wi4.x, wi4.y, wi4.z, wi4.w};
  float pr[4], pi[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    pr[e] = xr[e] * wr[e] - xi[e] * wi[e];
    pi[e] = xr[e] * wi[e] + xi[e] * wr[e];
  }
  Ar[0] = to_tf32(pr[0]); Ar[1] = to_tf32(pr[2]); Ar[2] = to_tf32(pr[1]); Ar[3] = to_tf32(pr[3]);
  Ai[0] = to_tf32(pi[0]); Ai[1] = to_tf32(pi[2]); Ai[2] = to_tf32(pi[1]); Ai[3] = to_tf32(pi[3]);
}

// Stage 2 (CONJ = false): C = X . FS; stage 3 (CONJ = true): C = X . conj(FS)
// (FS is symmetric).  Four real products; FS's (re0, re1, im0, im1)
// fragments from fst, and (-im0, -im1) from fsn so that no operand needs its
// sign flipped.  One output n-tile at a time, handed to consume(jn, cr, ci):
// 8 accumulators live instead of 8 NT.
template <int NT, bool CONJ, typename F>
__device__ __forceinline__ void stage_outer(const float4* fst, const float2* fsn, int lane,
                                            const uint32_t (&Ar)[NT][4],
                                            const uint32_t (&Ai)[NT][4], F&& consume) {
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) {
    float cr[4] = {0.f, 0.f, 0.f, 0.f}, ci[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 f = fst[(j * NT + jn) * 32 + lane];
      const float2 m = fsn[(j * NT + jn) * 32 + lane];
      if (CONJ) {
        // (xr + i xi)(fr - i fi) = (xr fr + xi fi) + i (xi fr - xr fi)
        mma(cr, Ar[j], bits(f.x), bits(f.y));
        mma(ci, Ai[j], bits(f.x), bits(f.y));
        mma(cr, Ai[j], bits(f.z), bits(f.w));
        mma(ci, Ar[j], bits(m.x), bits(m.y));
      } else {
        // (xr + i xi)(fr + i fi) = (xr fr - xi fi) + i (xr fi + xi fr)
        mma(cr, Ar[j], bits(f.x), bits(f.y));
        mma(ci, Ar[j], bits(f.z), bits(f.w));
        mma(cr, Ai[j], bits(m.x), bits(m.y));
        mma(ci, Ai[j], bits(f.x), bits(f.y));
      }
    }
    consume(jn, cr, ci);
  }
}

// What a launch shares, computed on the host: the shape; the R axis padded
// to MT = 1, 2 or 4 m-tiles of 16 rows (a power of two, so that a thread's
// team and warp are shifts of its index); stage 1's k-steps KR1 and the MT4
// m-tiles with outputs, 2^lg_sp warps each; the walk over units.
struct Plan {
  int B, L, D, R, S;
  int MT, lg_mt, KR1, MT4, lg_sp;
  int teams, bpu, nbc, units;
  int vec_in, vec_out;
  float inv_n;
};

// Layout of a block's dynamic shared memory, in floats, then bytes.
struct Smem {
  int fr, fs, fsn, tw;  // the tables' floats
  int team;             // floats of one team: its column / E buffer, then H
  int tile;             // bf16 elements of one [t][teams] tile
  __device__ __forceinline__ Smem(int MT, int NT, int L, int teams)
      : fr(512 * MT * MT), fs(128 * NT * NT), fsn(64 * NT * NT), tw(256 * MT * NT),
        team(512 * MT * NT), tile(L * teams) {}
  __device__ __forceinline__ int tables() const { return fr + fs + fsn + tw; }
};

// One block per walk over steps (channels c0 .. c0 + teams - 1, batch row
// b); team k of the block owns channel c0 + k.  Units are (channel group,
// run of bpu batch rows), block-strided; H is computed once per unit.
// u[b, t, d] and gate[b, t, d] at b*s_b + t*s_t + d*s_d; h[d, t] at
// d*sh_d + t*sh_t (fp32 or bf16); out contiguous (B, L, D).  HGIVEN: H
// (R, S, D) complex64 read from hc, h unused.  vec_in / vec_out: the
// wrapper found u's and the gate's rows, or out's, aligned for
// 2*teams-byte copies (teams 2, 4 or 8).
template <int NT, bool HGIVEN>
__global__ void __launch_bounds__(Bounds<NT>::threads, 1) twolevel_tc_kernel(
    Operands op, Plan p, const void* __restrict__ skip, int skip_bf16, int64_t s_skip,
    const void* __restrict__ h, int h_bf16, int64_t sh_d, int64_t sh_t,
    const float2* __restrict__ hc, const float* __restrict__ tables,
    uint16_t* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int B = p.B, L = p.L, D = p.D, R = p.R, S = p.S, teams = p.teams, bpu = p.bpu;
  const int MT = p.MT, KR = 2 * MT, KR1 = p.KR1, MT4 = p.MT4;
  const Smem lay(MT, NT, L, teams);
  // the tables: FR's A fragments [mt][i][re, im][lane] (float4), FS's B
  // fragments [j][jn][lane] (float4) and their negated imaginary parts
  // (float2), TW in C-fragment order [mt][jn][re, im][lane] (float4);
  // cp.async, then FR and FS rounded to tf32 in place
  {
    const int n4 = lay.tables() >> 2;
    for (int e = threadIdx.x; e < n4; e += blockDim.x)
      cp_async<16>(smem_u32(sm + 4 * e), tables + 4 * e);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int e = threadIdx.x; e < lay.fr + lay.fs + lay.fsn; e += blockDim.x) sm[e] = rna(sm[e]);
  }
  const float4* frt = reinterpret_cast<const float4*>(sm);
  const float4* fst = frt + (lay.fr >> 2);
  const float2* fsn = reinterpret_cast<const float2*>(fst + (lay.fs >> 2));
  const float4* twt = reinterpret_cast<const float4*>(fsn + (lay.fsn >> 1));
  uint16_t* tiles = reinterpret_cast<uint16_t*>(sm + lay.tables() + teams * lay.team);

  const int tthreads = 32 << p.lg_mt;
  const int team = threadIdx.x >> (5 + p.lg_mt);
  const int ttid = threadIdx.x & (tthreads - 1);
  const int wt = ttid >> 5;  // the warp's m-tile: rows 16 wt .. 16 wt + 15
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int bar = 1 + team;
  // per team: the column (stage 1's B fragments) or E (stage 4's), then H
  float* buf = sm + lay.tables() + team * lay.team;
  float4* buf4 = reinterpret_cast<float4*>(buf);
  float4* hb4 = buf4 + 64 * MT * NT;

  // stage 1 reads the KR1 k-steps of the MT4 m-tiles that hold rows with
  // t < L, and stage 4 computes only those MT4 m-tiles' outputs, 2^lg_sp
  // warps a tile, each its n-tiles jn with jn & spm == part
  const int spm = (1 << p.lg_sp) - 1;
  const int mt4 = wt >> p.lg_sp, part = wt & spm;
  const float inv_n = p.inv_n;
  const int nbc = p.nbc, units = p.units;
  const int vec_in = p.vec_in, vec_out = p.vec_out;

  int unit = blockIdx.x;
  if (unit >= units) return;
  int b = (unit % nbc) * bpu;
  int cur = 0;
  load_tiles(tiles, tiles + lay.tile, op, b, (unit / nbc) * teams, teams, L, D,
             vec_in && (unit / nbc + 1) * teams <= D);
  cp_async_commit();
  // the step after (unit, b): the next batch row of the unit, else the first
  // of the block's next unit
  auto next_step = [&](int u_, int b_, int& next, int& nb) {
    next = u_;
    nb = b_ + 1;
    if (nb >= min(B, (u_ % nbc) * bpu + bpu)) {
      next = u_ + gridDim.x;
      nb = (next % nbc) * bpu;
    }
  };
  for (int prev = -1;;) {
    const int c0 = (unit / nbc) * teams;
    uint16_t* tu = tiles + cur * 2 * lay.tile;
    uint16_t* tg = tu + lay.tile;  // the gate, then the output

    cp_async_wait_all();
    __syncthreads();  // this step's tiles are in; the last step's output is stored
    {
      // the next step's tiles load while this one computes
      int next, nb;
      next_step(unit, b, next, nb);
      if (next < units) {
        uint16_t* nu = tiles + (cur ^ 1) * 2 * lay.tile;
        load_tiles(nu, nu + lay.tile, op, nb, (next / nbc) * teams, teams, L, D,
                   vec_in && (next / nbc + 1) * teams <= D);
      }
    }
    cp_async_commit();

    const int c = c0 + team;
    if (c < D) {
      // ---- H of channel c into hb, in stage 2's C-fragment order, once a unit
      if (unit != prev) {
        if constexpr (HGIVEN) {
          // this lane's positions of stage 2's C fragments, from tid_x()
          const int ln = tid_x() & 31;
          const int k1 = 16 * ((tid_x() & (tthreads - 1)) >> 5) + (ln >> 2);
          const int k2 = 2 * (ln & 3);
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) {
            float2 hv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = k1 + 8 * (e >> 1), q = 8 * jn + k2 + (e & 1);
              hv[e] = make_float2(0.f, 0.f);
              if (r < R && q < S) hv[e] = __ldg(hc + ((int64_t)r * S + q) * D + c);
            }
            hb4[((wt * NT + jn) * 2) * 32 + lane] = make_float4(hv[0].x, hv[1].x, hv[2].x, hv[3].x);
            hb4[((wt * NT + jn) * 2 + 1) * 32 + lane] =
                make_float4(hv[0].y, hv[1].y, hv[2].y, hv[3].y);
          }
        } else {
          load_column<NT, false>(buf, h, (int64_t)c * sh_d, sh_t, h_bf16, L, R, S, KR1,
                                 tthreads);
          team_sync(bar, tthreads);
          float xr[NT][4], xi[NT][4];
          stage1<NT>(frt, buf, wt, KR, KR1, lane, xr, xi);
          team_sync(bar, tthreads);  // every warp has read the taps
          uint32_t Ar[NT][4], Ai[NT][4];
#pragma unroll
          for (int jn = 0; jn < NT; ++jn)
            cmul_to_a(xr[jn], xi[jn], twt[((wt * NT + jn) * 2) * 32 + lane],
                      twt[((wt * NT + jn) * 2 + 1) * 32 + lane], Ar[jn], Ai[jn]);
          stage_outer<NT, false>(fst, fsn, lane, Ar, Ai,
                                 [&](int jn, const float (&cr)[4], const float (&ci)[4]) {
                                   hb4[((wt * NT + jn) * 2) * 32 + lane] =
                                       make_float4(cr[0], cr[1], cr[2], cr[3]);
                                   hb4[((wt * NT + jn) * 2 + 1) * 32 + lane] =
                                       make_float4(ci[0], ci[1], ci[2], ci[3]);
                                 });
        }
      }

      // ---- the column of u from the tile, then stages 1-3 in registers:
      // X = FR . A; U = X * TW; C = U . FS; Y = C * H; Dm = Y . conj(FS)
      load_column<NT, true>(buf, tu, team, teams, 1, L, R, S, KR1, tthreads);
      team_sync(bar, tthreads);
      float xr[NT][4], xi[NT][4];
      stage1<NT>(frt, buf, wt, KR, KR1, lane, xr, xi);
      uint32_t Ar[NT][4], Ai[NT][4];
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
        cmul_to_a(xr[jn], xi[jn], twt[((wt * NT + jn) * 2) * 32 + lane],
                  twt[((wt * NT + jn) * 2 + 1) * 32 + lane], Ar[jn], Ai[jn]);
      // Y = (U . FS) * H, tile by tile, as stage 3's A fragments
      uint32_t Yr[NT][4], Yi[NT][4];
      stage_outer<NT, false>(fst, fsn, lane, Ar, Ai,
                             [&](int jn, const float (&cr)[4], const float (&ci)[4]) {
                               cmul_to_a(cr, ci, hb4[((wt * NT + jn) * 2) * 32 + lane],
                                         hb4[((wt * NT + jn) * 2 + 1) * 32 + lane], Yr[jn],
                                         Yi[jn]);
                             });
      team_sync(bar, tthreads);  // every warp has read the column

      // ---- stage 3, tile by tile, and E = Dm * conj(TW) into buf as stage
      // 4's B fragments: rows 16 wt + g and + 8 of column s are slots
      // (b0, b1) of lane 4 (s % 8) + g % 4 in k-step 2 wt + g / 4
      stage_outer<NT, true>(fst, fsn, lane, Yr, Yi,
                            [&](int jn, const float (&cr)[4], const float (&ci)[4]) {
        const float4 wr4 = twt[((wt * NT + jn) * 2) * 32 + lane];
        const float4 wi4 = twt[((wt * NT + jn) * 2 + 1) * 32 + lane];
        const float wr[4] = {wr4.x, wr4.y, wr4.z, wr4.w};
        const float wi[4] = {wi4.x, wi4.y, wi4.z, wi4.w};
        float er[4], ei[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          er[e] = cr[e] * wr[e] + ci[e] * wi[e];
          ei[e] = ci[e] * wr[e] - cr[e] * wi[e];
        }
        float4* tile = buf4 + ((2 * wt + (g >> 2)) * NT + jn) * 32;
#pragma unroll
        for (int ee = 0; ee < 2; ++ee)
          tile[eswz(8 * tq + 4 * ee + (g & 3))] =
              make_float4(rna(er[ee]), rna(er[2 + ee]), rna(ei[ee]), rna(ei[2 + ee]));
      });
      team_sync(bar, tthreads);

      // ---- stage 4: y = Re(conj(FR)^T . E) = FRre . Ere + FRim . Eim, then
      // the epilogue into the tile: skip * u in fp32, the downcast, then the
      // gate in bf16, written over the gate
      if (mt4 < MT4) {
        float y[NT][4];
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) y[jn][e] = 0.f;
        for (int i = 0; i < KR; ++i) {
          const float4 ar = frt[((mt4 * KR + i) * 2) * 32 + lane];
          const float4 ai = frt[((mt4 * KR + i) * 2 + 1) * 32 + lane];
          const uint32_t Fr[4] = {bits(ar.x), bits(ar.y), bits(ar.z), bits(ar.w)};
          const uint32_t Fi[4] = {bits(ai.x), bits(ai.y), bits(ai.z), bits(ai.w)};
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) {
            if ((jn & spm) != part) continue;
            const float4 ev = buf4[(i * NT + jn) * 32 + eswz(lane)];
            mma(y[jn], Fr, bits(ev.x), bits(ev.y));
            mma(y[jn], Fi, bits(ev.z), bits(ev.w));
          }
        }
        const float sk = skip != nullptr ? ld_elem(skip, (int64_t)c * s_skip, skip_bf16) : 0.f;
        const int ln = tid_x() & 31;
        const int r0 = 16 * (((tid_x() & (tthreads - 1)) >> 5) >> p.lg_sp) + (ln >> 2);
        const int s0 = 2 * (ln & 3);
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          if ((jn & spm) != part) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + 8 * (e >> 1), s = 8 * jn + s0 + (e & 1);
            const int t = r * S + s;
            if (r >= R || s >= S || t >= L) continue;
            const int at = t * teams + team;
            float v = y[jn][e] * inv_n;
            if (skip != nullptr) v = fmaf(bf16_f32(tu[at]), sk, v);
            uint16_t o = f32_bf16(v);
            if (op.gate != nullptr) o = f32_bf16(bf16_f32(o) * bf16_f32(tg[at]));
            tg[at] = o;
          }
        }
      }
    }
    __syncthreads();  // every team's outputs are in the tile
    store_tile(out, tg, b, c0, teams, L, D, vec_out && c0 + teams <= D);
    prev = unit;
    int next, nb;
    next_step(opaque(unit), opaque(b), next, nb);
    if (next >= units) break;
    unit = next;
    b = nb;
    cur ^= 1;
  }
}

template <int NT, bool HG>
static int launch_nt(const Operands& op, const Plan& p, const void* skip, int skip_bf16,
                     int64_t s_skip, const void* h, int h_bf16, int64_t sh_d, int64_t sh_t,
                     const void* hc, const float* tables, void* out, int grid, int smem_bytes,
                     cudaStream_t stream) {
  const int threads = p.teams * p.MT * 32;
  if (threads > Bounds<NT>::threads) return (int)cudaErrorInvalidConfiguration;
  static int raised[MAX_DEVICES] = {0};
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(twolevel_tc_kernel<NT, HG>),
                             smem_bytes, raised);
  if (e != cudaSuccess) return (int)e;
  twolevel_tc_kernel<NT, HG><<<grid, threads, smem_bytes, stream>>>(
      op, p, skip, skip_bf16, s_skip, h, h_bf16, sh_d, sh_t, (const float2*)hc, tables,
      (uint16_t*)out);
  return (int)cudaGetLastError();
}

template <bool HG>
static int launch(const Operands& op, const Plan& p, const void* skip, int skip_bf16,
                  int64_t s_skip, const void* h, int h_bf16, int64_t sh_d, int64_t sh_t,
                  const void* hc, const float* tables, void* out, int grid, int smem_bytes,
                  cudaStream_t st) {
#define TC_CASE(NT)                                                                       \
  case NT:                                                                               \
    return launch_nt<NT, HG>(op, p, skip, skip_bf16, s_skip, h, h_bf16, sh_d, sh_t, hc,   \
                             tables, out, grid, smem_bytes, st);
  switch ((p.S + 7) / 8) {
    TC_CASE(1)
    TC_CASE(2)
    TC_CASE(3)
    TC_CASE(4)
    TC_CASE(5)
    TC_CASE(6)
    TC_CASE(7)
    TC_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TC_CASE
}

}  // namespace tc

extern "C" {

int twolevel_fft_conv_f32(const void* u, int64_t su_b, int64_t su_t, int64_t su_d,
                          const void* gate, int64_t sg_b, int64_t sg_t, int64_t sg_d,
                          const float* skip, const float* hc,
                          const float* frre, const float* frim,
                          const float* twre, const float* twim,
                          const float* fsre, const float* fsim, void* out,
                          int B, int L, int D, int R, int S, int td,
                          int threads, int smem_bytes, void* stream) {
  const int64_t su[3] = {su_b, su_t, su_d}, sg[3] = {sg_b, sg_t, sg_d};
  return launch<float>(u, su, gate, sg, skip, hc, frre, frim, twre, twim, fsre,
                       fsim, out, B, L, D, R, S, td, threads, smem_bytes, stream);
}

int twolevel_fft_conv_bf16(const void* u, int64_t su_b, int64_t su_t, int64_t su_d,
                           const void* gate, int64_t sg_b, int64_t sg_t, int64_t sg_d,
                           const float* skip, const float* hc,
                           const float* frre, const float* frim,
                           const float* twre, const float* twim,
                           const float* fsre, const float* fsim, void* out,
                           int B, int L, int D, int R, int S, int td,
                           int threads, int smem_bytes, void* stream) {
  const int64_t su[3] = {su_b, su_t, su_d}, sg[3] = {sg_b, sg_t, sg_d};
  return launch<__nv_bfloat16>(u, su, gate, sg, skip, hc, frre, frim, twre, twim,
                               fsre, fsim, out, B, L, D, R, S, td, threads,
                               smem_bytes, stream);
}

// The tensor-core instance (bf16 u, gate and output).  With hc null it
// computes H from the taps h in the same launch; else it reads H from hc.
int twolevel_tc_bf16(const void* u, int64_t su_b, int64_t su_t, int64_t su_d,
                     const void* gate, int64_t sg_b, int64_t sg_t, int64_t sg_d,
                     const void* skip, int skip_bf16, int64_t s_skip,
                     const void* h, int h_bf16, int64_t sh_d, int64_t sh_t,
                     const void* hc, const float* tables, void* out,
                     int B, int L, int D, int R, int S, int teams, int bpu, int vec_in,
                     int vec_out, int grid, int smem_bytes, void* stream) {
  const bool vec_teams = teams == 2 || teams == 4 || teams == 8;
  if (B < 1 || L < 1 || D < 1 || R < 1 || S < 1 || R > tc::MAX_R || S > 8 * tc::MAX_NT ||
      teams < 1 || teams > tc::MAX_TEAMS || bpu < 1 || grid < 1 ||
      (hc == nullptr && h == nullptr) || ((vec_in || vec_out) && !vec_teams) ||
      (vec_in && (su_d != 1 || (gate != nullptr && sg_d != 1))))
    return (int)cudaErrorInvalidValue;
  const tc::Operands op = {(const uint16_t*)u, su_b, su_t, su_d,
                           (const uint16_t*)gate, sg_b, sg_t, sg_d};
  tc::Plan p;
  p.B = B; p.L = L; p.D = D; p.R = R; p.S = S;
  p.MT = R <= 16 ? 1 : R <= 32 ? 2 : 4;
  p.lg_mt = p.MT == 4 ? 2 : p.MT - 1;
  const int Lr = (L + S - 1) / S;  // rows r that hold some t < L
  p.MT4 = (Lr + 15) / 16 < p.MT ? (Lr + 15) / 16 : p.MT;
  p.KR1 = 2 * p.MT4;
  const int sp = p.MT / p.MT4;  // 1, 2 or 4
  p.lg_sp = sp == 4 ? 2 : sp - 1;
  p.teams = teams; p.bpu = bpu;
  p.nbc = (B + bpu - 1) / bpu;
  p.units = (D + teams - 1) / teams * p.nbc;
  p.vec_in = vec_in; p.vec_out = vec_out;
  p.inv_n = 1.0f / (float)(R * S);
  cudaStream_t st = (cudaStream_t)stream;
  if (hc != nullptr)
    return tc::launch<true>(op, p, skip, skip_bf16, s_skip, h, h_bf16, sh_d, sh_t, hc, tables,
                            out, grid, smem_bytes, st);
  return tc::launch<false>(op, p, skip, skip_bf16, s_skip, h, h_bf16, sh_d, sh_t, hc, tables,
                           out, grid, smem_bytes, st);
}

// threads a block of the tensor-core instance for NT = ceil(S / 8) may have
int twolevel_tc_max_threads(int nt) {
  return nt <= 4 ? tc::Bounds<4>::threads : tc::Bounds<8>::threads;
}

const char* twolevel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int twolevel_staged(void) { return STAGED; }

}  // extern "C"
