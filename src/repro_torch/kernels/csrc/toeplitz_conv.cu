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
// ungated call bit for bit.
//
// Design.  The TPU grid (d_block, i, r) carries an fp32 accumulator in VMEM
// across sequential r steps; CUDA blocks run in parallel and share nothing,
// so here one block owns one (channel tile of TD = 32, output chunk i,
// batch row) and loops over r itself.  Per diagonal it stages u_{i-r}
// (Cp x TD, Cp = C rounded up to 16) and the 2Cp-1 taps h[rC - Cp + 1 ..
// rC + Cp - 1] of each channel in shared memory as fp32.  Thread (tx, ty)
// owns channel tx and the ROWS = 16 consecutive output rows 16*ty ..; its
// sums stay in fp32 registers across every diagonal.  Because T_r is
// Toeplitz, the taps a thread needs for a block of BB = 16 input rows are
// one window of ROWS + BB - 1 = 31 values: 16 + 31 shared loads feed 256
// FMAs.  Lanes of a warp are the 32 channels, so shared reads hit 32
// distinct banks (the tap array is padded to TD + 1 columns so that its
// staging writes, which walk lags, are conflict-free too) and the global
// reads and writes of u, gate and y are 32 consecutive channels.
//
// Bound.  The kernel does C^2 fp32 FMAs per (chunk pair, row, channel):
// sum over the chunk pairs of C^2 * B * D, 1.02 GFLOP at B=1, L=1024,
// D=864, C=128 (15 us at the 67 TFLOP/s of the CUDA cores), while the
// function's least time is set by its bytes (~2.6 us).  So this kernel is
// bound by its own fp32 operations; the register window above keeps loads
// well below the FMA count, and the diagonal block skips its acausal half.
// The tensor cores (TF32 or a bf16 split, with a tolerance chosen for it)
// are later work: the reference semantics is the fp32 sum.
//
// Strides.  u and gate may be any view whose channel dim is unit-stride
// (torch.split's views of the projection, on the model path); h may be a
// view of wider rows (the max_len filter sliced to L).  The kernel
// launches on the caller's stream and allocates nothing.  The C entry
// points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

#define TD 32      // channels per block, one per lane
#define ROWS 16    // output rows per thread
#define BB 16      // input rows per register block
#define MAX_C 256  // largest chunk: 512 threads, 98 KB of shared memory
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

// u[b, t, d] at b*su_b + t*su_t + d; gate likewise; h[d, lag] at d*sh_d + lag;
// out is contiguous (B, L, D).
template <typename T>
__global__ void __launch_bounds__(MAX_C / ROWS * TD)
toeplitz_conv_kernel(const T* __restrict__ u, const float* __restrict__ h,
                     const float* __restrict__ skip, const T* __restrict__ gate,
                     T* __restrict__ out, int L, int D, int C, int Cp, int K,
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
  const T* ub = u + (int64_t)b * su_b;

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
      us[e] = (q < C && t < L && d < D) ? to_f32(ub[(int64_t)t * su_t + d]) : 0.f;
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
  const T* gb = gate == nullptr ? nullptr : gate + (int64_t)b * sg_b;
  T* ob = out + (int64_t)b * L * D;
  const float sk = skip == nullptr ? 0.f : skip[d];
#pragma unroll
  for (int jj = 0; jj < ROWS; ++jj) {
    const int a = a0 + jj;
    const int t = i * C + a;
    if (a < C && t < L) {
      float y = acc[jj];
      if (skip != nullptr) y = y + to_f32(ub[(int64_t)t * su_t + d]) * sk;
      T o = from_f32<T>(y);
      if (gb != nullptr) o = from_f32<T>(to_f32(o) * to_f32(gb[(int64_t)t * sg_t + d]));
      ob[(int64_t)t * D + d] = o;
    }
  }
}

static int smem_bytes_for(int Cp) {
  return (Cp * TD + (2 * Cp - 1) * (TD + 1)) * (int)sizeof(float);
}

template <typename T>
static int launch(const void* u, const float* h, const float* skip, const void* gate,
                  void* out, int B, int L, int D, int C, int K, int64_t su_b,
                  int64_t su_t, int64_t sg_b, int64_t sg_t, int64_t sh_d,
                  void* stream) {
  if (C < 1 || C > MAX_C || K < 1 || B < 1 || L < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const int Cp = (C + BB - 1) / BB * BB;
  const int smem = smem_bytes_for(Cp);
  if (smem > 48 * 1024) {
    // raise this instance's dynamic shared-memory limit on the current
    // device once, and again only for a launch that needs more
    static std::mutex mu;
    static int raised[MAX_DEVICES] = {0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> hold(mu);
    if (smem > raised[dev]) {
      e = cudaFuncSetAttribute(toeplitz_conv_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      raised[dev] = smem;
    }
  }
  const int n_chunks = (L + C - 1) / C;
  dim3 grid((D + TD - 1) / TD, n_chunks, B);
  dim3 block(TD, Cp / ROWS);
  toeplitz_conv_kernel<T><<<grid, block, smem, (cudaStream_t)stream>>>(
      (const T*)u, h, skip, (const T*)gate, (T*)out, L, D, C, Cp, K, su_b, su_t,
      sg_b, sg_t, sh_d);
  return (int)cudaGetLastError();
}

extern "C" {

int toeplitz_conv_f32(const void* u, const float* h, const float* skip, const void* gate,
                      void* out, int B, int L, int D, int C, int K, int64_t su_b,
                      int64_t su_t, int64_t sg_b, int64_t sg_t, int64_t sh_d,
                      void* stream) {
  return launch<float>(u, h, skip, gate, out, B, L, D, C, K, su_b, su_t, sg_b, sg_t,
                       sh_d, stream);
}

int toeplitz_conv_bf16(const void* u, const float* h, const float* skip, const void* gate,
                       void* out, int B, int L, int D, int C, int K, int64_t su_b,
                       int64_t su_t, int64_t sg_b, int64_t sg_t, int64_t sh_d,
                       void* stream) {
  return launch<__nv_bfloat16>(u, h, skip, gate, out, B, L, D, C, K, su_b, su_t, sg_b,
                               sg_t, sh_d, stream);
}

const char* toeplitz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int toeplitz_max_chunk(void) { return MAX_C; }

}  // extern "C"
