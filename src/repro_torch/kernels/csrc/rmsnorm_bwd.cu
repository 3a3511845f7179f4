// Backward of the RMSNorm forward, hand-written for Hopper (sm_90a).
//
// The TPU kernel repro/kernels/rmsnorm.py::rmsnorm has no backward of its
// own: JAX differentiates the plain path.  This kernel computes that
// gradient for the port's forward (csrc/rmsnorm.cu): given x [rows, d] in
// float32 or bfloat16, scale [d] float32 and the cotangent dy (x's dtype),
//
//   rstd   = rsqrt(mean(x²) + eps),  x̂ = x · rstd,  g = dy · scale
//   dx     = rstd · (g − x̂ · mean(g · x̂))          in x's dtype
//   dscale = Σ_rows dy · x̂                          in float32
//
// all in float32.  Its plain twin is kernels/ref.py::rmsnorm_bwd.
//
// What bounds it on this card: bytes (x and dy read, dx written: 50.3 MB
// at (2048, 4096) bf16, 0.0150 ms at 3.35 TB/s).  The design:
//
// * rmsnorm_bwd_rows_kernel: a block of 256 threads takes RPB consecutive
//   rows; TPR threads take a row (32 up to d = 256, then 64, 128, 256),
//   each thread the columns lane + TPR·k (k < NPT, coalesced across
//   lanes), held in registers from the sum of squares to the write.  A row's two sums (x²
//   and g·x̂) reduce by an xor butterfly, and across the warps of a row
//   through shared memory, every thread adding the warps' sums in order.
//   Each thread keeps its columns' Σ dy·x̂ over the block's rows; the row
//   groups of a block are then summed in order into one partial row of
//   dscale per block.
// * rmsnorm_bwd_colsum_kernel: dscale[c] = Σ_p partial[p][c], p ascending,
//   one thread a column.
//
// No atomics: the plan (TPR, NPT, RPB, the partial count) follows from
// (rows, d) alone (rmsnorm_bwd.py::bwd_plan), never from the card, so two
// launches give the same bits.  rsqrtf as in the forward kernel; no
// --use_fast_math.
//
// C interface, loaded with ctypes: the launcher returns the cudaError_t of
// its launches (0 on success) and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Σ of v over the TPR threads of a row; every one of them gets the same
// bits.  red holds one word a warp; all threads of the block call it.
template <int TPR>
__device__ __forceinline__ float group_sum(float v, float* red) {
  constexpr int W = TPR < 32 ? TPR : 32;
#pragma unroll
  for (int o = 1; o < W; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (TPR <= 32) return v;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  const int first = (threadIdx.x / TPR) * (TPR / 32);
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < TPR / 32; ++i) tot += red[first + i];
  __syncthreads();
  return tot;
}

template <typename T, int TPR, int NPT>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_rows_kernel(const T* __restrict__ x,
                            const float* __restrict__ scale,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            float* __restrict__ partial, int rows, int d,
                            float eps, int rpb) {
  constexpr int RG = kThreads / TPR;           // rows a block takes at once
  extern __shared__ float smem[];              // [RG][d] row-group sums
  __shared__ float red[kThreads / 32];
  const int t = threadIdx.x, grp = t / TPR, lane = t % TPR;
  const int r_begin = blockIdx.x * rpb;
  const int r_end = min(rows, r_begin + rpb);
  const float inv_d = 1.0f / static_cast<float>(d);

  float s[NPT], acc[NPT];
#pragma unroll
  for (int k = 0; k < NPT; ++k) {
    const int c = lane + TPR * k;
    s[k] = c < d ? scale[c] : 0.f;
    acc[k] = 0.f;
  }
  for (int r0 = r_begin; r0 < r_end; r0 += RG) {
    const int row = r0 + grp;
    const bool active = row < r_end;
    const int64_t off = static_cast<int64_t>(row) * d;
    float xv[NPT], gv[NPT], dyv[NPT];
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
      const int c = lane + TPR * k;
      const bool in = active && c < d;
      xv[k] = in ? to_f(x[off + c]) : 0.f;
      dyv[k] = in ? to_f(dy[off + c]) : 0.f;
      gv[k] = dyv[k] * s[k];
      ss = fmaf(xv[k], xv[k], ss);
    }
    ss = group_sum<TPR>(ss, red);
    const float rstd = rsqrtf(ss * inv_d + eps);
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
      xv[k] *= rstd;                           // x̂
      dot = fmaf(gv[k], xv[k], dot);
    }
    dot = group_sum<TPR>(dot, red);
    const float mdot = dot * inv_d;
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
      const int c = lane + TPR * k;
      if (active && c < d)
        dx[off + c] = from_f<T>(rstd * (gv[k] - xv[k] * mdot));
      acc[k] = fmaf(dyv[k], xv[k], acc[k]);
    }
  }
  // the block's partial row of dscale: its row groups summed in order
#pragma unroll
  for (int k = 0; k < NPT; ++k) {
    const int c = lane + TPR * k;
    if (c < d) smem[grp * d + c] = acc[k];
  }
  __syncthreads();
  for (int c = t; c < d; c += kThreads) {
    float tot = 0.f;
    for (int g = 0; g < RG; ++g) tot += smem[g * d + c];
    partial[static_cast<int64_t>(blockIdx.x) * d + c] = tot;
  }
}

__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_colsum_kernel(const float* __restrict__ partial,
                              float* __restrict__ dscale, int n_part, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  float tot = 0.f;
#pragma unroll 8
  for (int p = 0; p < n_part; ++p)
    tot += partial[static_cast<int64_t>(p) * d + c];
  dscale[c] = tot;
}

template <typename T, int TPR, int NPT>
cudaError_t launch(const void* x, const void* scale, const void* dy,
                   void* dx, void* dscale, void* partial, int rows, int d,
                   float eps, int rpb, int n_part, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kThreads / TPR) * d * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rmsnorm_bwd_rows_kernel<T, TPR, NPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  rmsnorm_bwd_rows_kernel<T, TPR, NPT><<<n_part, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(partial), rows, d, eps, rpb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_colsum_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0,
                              stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dscale),
      n_part, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int tpr, int npt, const void* x, const void* scale,
                     const void* dy, void* dx, void* dscale, void* partial,
                     int rows, int d, float eps, int rpb, int n_part,
                     cudaStream_t stream) {
#define NORM_BWD_ARGS x, scale, dy, dx, dscale, partial, rows, d, eps, rpb, \
                      n_part, stream
  if (tpr == 32) {
    switch (npt) {
      case 1: return launch<T, 32, 1>(NORM_BWD_ARGS);
      case 2: return launch<T, 32, 2>(NORM_BWD_ARGS);
      case 4: return launch<T, 32, 4>(NORM_BWD_ARGS);
      case 8: return launch<T, 32, 8>(NORM_BWD_ARGS);
    }
  } else if (tpr == 64 && npt == 8) {
    return launch<T, 64, 8>(NORM_BWD_ARGS);
  } else if (tpr == 128 && npt == 8) {
    return launch<T, 128, 8>(NORM_BWD_ARGS);
  } else if (tpr == 256) {
    switch (npt) {
      case 8: return launch<T, 256, 8>(NORM_BWD_ARGS);
      case 16: return launch<T, 256, 16>(NORM_BWD_ARGS);
      case 32: return launch<T, 256, 32>(NORM_BWD_ARGS);
    }
  }
#undef NORM_BWD_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, dy, dx [rows, d] contiguous, of one dtype: 0 = float32, 1 =
// bfloat16; scale and dscale [d] float32; partial [n_part, d] float32
// scratch.  tpr, npt, rpb and n_part come from rmsnorm_bwd.py::bwd_plan.
int rmsnorm_bwd_launch(const void* x, const void* scale, const void* dy,
                       void* dx, void* dscale, void* partial, int rows, int d,
                       float eps, int dtype, int tpr, int npt, int rpb,
                       int n_part, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || d <= 0 || rpb <= 0 || n_part <= 0 ||
      static_cast<int64_t>(rpb) * n_part < rows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch<float>(tpr, npt, x, scale, dy, dx, dscale, partial, rows,
                          d, eps, rpb, n_part, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(tpr, npt, x, scale, dy, dx, dscale,
                                  partial, rows, d, eps, rpb, n_part, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
