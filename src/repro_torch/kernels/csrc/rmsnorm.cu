// RMSNorm over the last axis, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::rmsnorm.
// Semantics are the Pallas kernel's: x [rows, d] in float32 or bfloat16,
// scale [d] float32; y = x · rsqrt(mean(x²) + eps) · scale computed in f32
// and written in x's dtype.  The models call it for every rmsnorm (the
// layer norms, the final norm and qwen3's per-head qk-norm), so d runs
// from 128 (qk-norm) to 4096, and the row count is whatever B·S(·H) is.
//
// What bounds it on this card: bytes.  It reads x once for the sum and
// once more for the output (the second read hits L1/L2: a row is at most
// 16 KB) and writes y once, about 3 flops a byte.  The design:
//
// * The TPU kernel holds a [256, d] tile in VMEM and reduces a row in one
//   vector op.  Here one block owns a row: its threads stride over the row
//   (neighbouring threads on neighbouring elements, so a warp's loads
//   coalesce), each summing its squares in f32; a butterfly of warp
//   shuffles then one warp over the per-warp partials (in shared memory)
//   gives the sum.  The order of that sum depends only on d and the block
//   size, which depends only on d: no atomics, so a row's result does not
//   depend on the grid or on the other rows.
// * A second pass over the row writes (x · r) · scale, the plain version's
//   order of the two products.
// * Block size: d / 8 threads rounded up to a warp, between 32 and 1024,
//   so a thread handles about 8 elements (512 threads at d = 4096, one
//   warp at the qk-norm's d = 128).
//
// mean is the sum divided by d (an IEEE division); rsqrtf is the
// hardware's, within 2 ulp.  No --use_fast_math.
//
// C interface, loaded with ctypes: the launcher returns the cudaError_t of
// the launch (0 on success) and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const float* __restrict__ scale,
                               T* __restrict__ y, int d, float eps) {
  __shared__ float partial[kMaxWarps];
  __shared__ float r_shared;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    float t = lane < warps ? partial[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) r_shared = rsqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = r_shared;
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    yr[i] = from_f32<T>((to_f32(xr[i]) * r) * scale[i]);
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* y, int rows,
                   int d, float eps, cudaStream_t s) {
  int threads = ((d + 7) / 8 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  rmsnorm_kernel<T><<<rows, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(y), d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y [rows, d] contiguous, of one dtype: 0 = float32, 1 = bfloat16;
// scale [d] float32.
int rmsnorm_launch(const void* x, const void* scale, void* y, int rows,
                   int d, float eps, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch<float>(x, scale, y, rows, d, eps, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, scale, y, rows, d, eps, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
