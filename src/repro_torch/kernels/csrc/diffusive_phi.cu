// Diffusive φ update (paper Eq. 10), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/diffusive_phi.py::
// diffusive_phi (dense) and ::diffusive_phi_sparse (neighbour lists).
//
//   inv_phi'_i = (1/F_i + max_k (dtx_ik + inv_phi_k)) / (deg_i + 1)
//   inv_phi'_i = 1/F_i                                   where deg_i = 0
//   deg_i      = #{k : dtx_ik > NEG/2}   (NEG = -1e30 marks no link)
//
// Both kernels are bound by memory: each reads its delay operand once
// (R·N²·4 bytes dense, R·N·K·8 bytes sparse) and does two flops a byte at
// most.  The design keeps every load coalesced and every reduction inside
// registers and warp shuffles: no shared memory, no atomics, no second
// pass.  The TPU version pads N to 128 and carries the row max across a
// sequential grid axis in VMEM scratch; here a bounds check replaces the
// padding and a loop inside one warp replaces the sequential axis.
//
// The arithmetic is op for op that of the plain PyTorch version
// (repro_torch/kernels/ref.py): a max (exact, order-free), a degree count
// of exact f32 integers, one IEEE division for 1/F and one for the
// normalisation.  Compiled without --use_fast_math, the results are
// bit-identical to it.
//
// C interface, loaded with ctypes: each launcher returns the cudaError_t of
// the launch (0 on success) and never synchronises.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegHalf = -5e29f;  // NEG / 2, as float32
constexpr int kThreads = 256;

__device__ __forceinline__ float combine(float f, float worst, float deg) {
  const float inv_f = 1.0f / f;
  return deg > 0.0f ? (inv_f + worst) / (deg + 1.0f) : inv_f;
}

__device__ __forceinline__ void warp_reduce(float& m, float& deg) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    deg += __shfl_xor_sync(0xffffffffu, deg, off);
  }
}

// One warp per (run, row): lanes stride over the N columns with coalesced
// loads, then reduce by shuffles; lane 0 writes.
__global__ void __launch_bounds__(kThreads)
phi_dense_kernel(const float* __restrict__ inv_phi,
                 const float* __restrict__ F,
                 const float* __restrict__ dtx,
                 float* __restrict__ out, int R, int N) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<int64_t>(R) * N) return;  // warp-uniform
  const float* d = dtx + row * N;
  const float* ip = inv_phi + (row / N) * N;
  float m = -INFINITY, deg = 0.0f;
  for (int k = lane; k < N; k += 32) {
    const float v = d[k];
    m = fmaxf(m, v + ip[k]);
    deg += v > kNegHalf ? 1.0f : 0.0f;
  }
  warp_reduce(m, deg);
  if (lane == 0) out[row] = combine(F[row], m, deg);
}

// Gather of one slot.  A list index outside [0, N) is a caller bug: the
// slot is skipped instead of read out of bounds, and the row's output
// becomes NaN so that the fault shows.
__device__ __forceinline__ float gather(const float* __restrict__ ip,
                                        int idx, int N, bool& bad) {
  const bool ok = idx >= 0 && idx < N;
  bad |= !ok;
  return ok ? __ldg(ip + idx) : -INFINITY;
}

// One thread per (run, row), for short lists (K <= 32).  The 1/φ row of a
// run is N·4 bytes (256 KB at N = 65,536) and is read through L2 by gather.
__global__ void __launch_bounds__(kThreads)
phi_sparse_thread_kernel(const float* __restrict__ inv_phi,
                         const float* __restrict__ F,
                         const float* __restrict__ dtx,
                         const int32_t* __restrict__ nbr,
                         float* __restrict__ out, int R, int N, int K) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row >= static_cast<int64_t>(R) * N) return;
  const float* d = dtx + row * K;
  const int32_t* nb = nbr + row * K;
  const float* ip = inv_phi + (row / N) * N;
  float m = -INFINITY, deg = 0.0f;
  bool bad = false;
  for (int k = 0; k < K; ++k) {
    const float v = d[k];
    m = fmaxf(m, v + gather(ip, nb[k], N, bad));
    deg += v > kNegHalf ? 1.0f : 0.0f;
  }
  out[row] = bad ? NAN : combine(F[row], m, deg);
}

// One warp per (run, row), for long lists (K > 32).
__global__ void __launch_bounds__(kThreads)
phi_sparse_warp_kernel(const float* __restrict__ inv_phi,
                       const float* __restrict__ F,
                       const float* __restrict__ dtx,
                       const int32_t* __restrict__ nbr,
                       float* __restrict__ out, int R, int N, int K) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<int64_t>(R) * N) return;  // warp-uniform
  const float* d = dtx + row * K;
  const int32_t* nb = nbr + row * K;
  const float* ip = inv_phi + (row / N) * N;
  float m = -INFINITY, deg = 0.0f;
  bool bad = false;
  for (int k = lane; k < K; k += 32) {
    const float v = d[k];
    m = fmaxf(m, v + gather(ip, nb[k], N, bad));
    deg += v > kNegHalf ? 1.0f : 0.0f;
  }
  warp_reduce(m, deg);
  bad = __any_sync(0xffffffffu, bad);
  if (lane == 0) out[row] = bad ? NAN : combine(F[row], m, deg);
}

unsigned int blocks_for(int64_t threads) {
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int diffusive_phi_launch(const float* inv_phi, const float* F,
                         const float* dtx, float* out, int R, int N,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(R) * N;
  phi_dense_kernel<<<blocks_for(rows * 32), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(inv_phi, F, dtx,
                                                          out, R, N);
  return static_cast<int>(cudaGetLastError());
}

int diffusive_phi_sparse_launch(const float* inv_phi, const float* F,
                                const float* dtx, const int32_t* nbr,
                                float* out, int R, int N, int K, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(R) * N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 32) {
    phi_sparse_thread_kernel<<<blocks_for(rows), kThreads, 0, s>>>(
        inv_phi, F, dtx, nbr, out, R, N, K);
  } else {
    phi_sparse_warp_kernel<<<blocks_for(rows * 32), kThreads, 0, s>>>(
        inv_phi, F, dtx, nbr, out, R, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
