// Diffusive φ update (paper Eq. 10), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/diffusive_phi.py::
// diffusive_phi (dense) and ::diffusive_phi_sparse (neighbour lists).
// Two launchers keep the Pallas kernels' contract (1/φ and a delay operand
// with NEG off-link, built by the caller): ``diffusive_phi`` (dense) and
// ``diffusive_phi_sparse``.  Two are what the simulator calls every epoch,
// the whole update in one launch each: ``phi_update`` (dense,
// core/diffusive.py::phi_update_op) and ``phi_update_sparse`` (neighbour
// lists, ::phi_update_op_sparse), below.
//
//   inv_phi'_i = (1/F_i + max_k (dtx_ik + inv_phi_k)) / (deg_i + 1)
//   inv_phi'_i = 1/F_i                                   where deg_i = 0
//   deg_i      = #{k : dtx_ik > NEG/2}   (NEG = -1e30 marks no link)
//
// The kernels are bound by memory: each reads its delay operand once
// (R·N²·4 bytes dense, R·N·K·8 bytes sparse; phi_update R·N²·5 and
// phi_update_sparse R·N·K·9, below) and does two flops a byte at most.
// The design keeps every load coalesced and every reduction inside
// registers and warp shuffles: no atomics, no second pass (only phi_update
// stages its 1/φ row in shared memory).  The TPU version pads N to 128
// and carries the row max across a sequential grid axis in VMEM scratch;
// here a bounds check replaces the padding and a loop inside one warp
// replaces the sequential axis.
//
// The arithmetic is op for op that of the plain PyTorch version
// (repro_torch/kernels/ref.py): a max (exact, order-free), a degree count
// of exact f32 integers, one IEEE division for 1/F and one for the
// normalisation.  The max propagates NaN as torch.amax does (``nan_max``:
// fmaxf would drop it), and -inf and +inf come out as torch.amax gives
// them.  Compiled without --use_fast_math, the results are bit-identical
// to the plain version on every input, NaN for NaN.
//
// C interface, loaded with ctypes: each launcher returns the cudaError_t of
// the launch (0 on success) and never synchronises.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegHalf = -5e29f;  // NEG / 2, as float32
constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;

// The larger of m and c, NaN sticky: a NaN candidate wins and then stays,
// as in torch.amax and jnp.max.  (fmaxf returns the other operand.)
__device__ __forceinline__ float nan_max(float m, float c) {
  return (c > m || c != c) ? c : m;
}

__device__ __forceinline__ float combine(float f, float worst, float deg) {
  const float inv_f = 1.0f / f;
  return deg > 0.0f ? (inv_f + worst) / (deg + 1.0f) : inv_f;
}

// The max and the degree over the lanes of a group of `width` (a power of
// two up to 32) by xor shuffles; every lane of the warp takes part.
template <typename Deg>
__device__ __forceinline__ void group_reduce(float& m, Deg& deg,
                                             int width = 32) {
  for (int off = width >> 1; off > 0; off >>= 1) {
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
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
    m = nan_max(m, v + ip[k]);
    deg += v > kNegHalf ? 1.0f : 0.0f;
  }
  group_reduce(m, deg);
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
    m = nan_max(m, v + gather(ip, nb[k], N, bad));
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
    m = nan_max(m, v + gather(ip, nb[k], N, bad));
    deg += v > kNegHalf ? 1.0f : 0.0f;
  }
  group_reduce(m, deg);
  bad = __any_sync(0xffffffffu, bad);
  if (lane == 0) out[row] = bad ? NAN : combine(F[row], m, deg);
}

// ---------------------------------------------------------------------------
// phi_update: the whole dense update in one launch
//
//   inv_k = 1/φ_k
//   m_i   = max_k (adj_ik ? d_tx_ik + inv_k : NEG)
//   deg_i = #{k : adj_ik}
//   φ'_i  = deg_i > 0 ? 1 / ((1/F_i + m_i) / (deg_i + 1)) : F_i
//
// which is op for op core/diffusive.py::phi_update (IEEE divisions, one
// rounding an add, a max that propagates NaN as torch.amax does, an exact
// count), so the result is bit-identical to it and to the chain of seven
// torch ops it replaces (1/φ, where, diffusive_phi, the degree sum, its
// compare, 1/x, where: 11 launches).  Bytes: the adjacency byte and the
// delay of each (i, k), 5 a pair, against 13 for the chain (where reads 5
// and writes 4, the kernel reads 4 again).
//
// One block per (run, chunk of rows).  The block first writes the run's
// 1/φ row into shared memory (N·4 bytes, 16 KB at N = 4096), so no thread
// repeats a division per entry; N is therefore at most 58,112, where one
// run's delays alone are 13.5 GB (wider swarms take the sparse path).
// Each warp then takes a row at a time: its lanes read the adjacency four
// bytes as one 32-bit word and the delays as a float4 where N % 4 == 0
// and the rows are aligned (element by element otherwise), reduce the max
// and the count through shuffles, and lane 0 combines and writes.
// ---------------------------------------------------------------------------

constexpr int kUpdateWarps = kThreads / 32;
// shared memory a block may take on this card, in floats of the 1/φ row
constexpr int kMaxUpdateN = 232448 / 4;

__device__ __forceinline__ void visit(float& m, int& deg, bool on, float d,
                                      float inv) {
  m = nan_max(m, on ? d + inv : kNeg);
  deg += on;
}

__device__ __forceinline__ float update_out(float f, float m, int deg) {
  return deg > 0 ? 1.0f / ((1.0f / f + m) / (static_cast<float>(deg) + 1.0f))
                 : f;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
phi_update_kernel(const float* __restrict__ phi, const float* __restrict__ F,
                  const uint8_t* __restrict__ adj,
                  const float* __restrict__ dtx, float* __restrict__ out,
                  int N, int chunk, int chunks_per_run) {
  extern __shared__ float4 inv_smem4[];
  float* inv_smem = reinterpret_cast<float*>(inv_smem4);
  const int run = blockIdx.x / chunks_per_run;
  const int first = (blockIdx.x % chunks_per_run) * chunk;
  const int last = min(first + chunk, N);
  const float* ph = phi + static_cast<int64_t>(run) * N;
  for (int k = threadIdx.x; k < N; k += blockDim.x)
    inv_smem[k] = 1.0f / ph[k];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = first + warp; i < last; i += kUpdateWarps) {
    const int64_t row = static_cast<int64_t>(run) * N + i;
    const uint8_t* a = adj + row * N;
    const float* d = dtx + row * N;
    float m = -INFINITY;
    int deg = 0;
    if (VEC) {
      const uint32_t* a4 = reinterpret_cast<const uint32_t*>(a);
      const float4* d4 = reinterpret_cast<const float4*>(d);
#pragma unroll 4
      for (int q = lane; q < N / 4; q += 32) {
        const uint32_t w = __ldg(a4 + q);
        const float4 v = __ldg(d4 + q);
        const float4 inv = inv_smem4[q];
        visit(m, deg, w & 0xffu, v.x, inv.x);
        visit(m, deg, (w >> 8) & 0xffu, v.y, inv.y);
        visit(m, deg, (w >> 16) & 0xffu, v.z, inv.z);
        visit(m, deg, w >> 24, v.w, inv.w);
      }
    } else {
      for (int k = lane; k < N; k += 32)
        visit(m, deg, a[k] != 0, d[k], inv_smem[k]);
    }
    group_reduce(m, deg);
    if (lane == 0) out[row] = update_out(F[row], m, deg);
  }
}

// ---------------------------------------------------------------------------
// phi_update_sparse: the whole neighbour-list update in one launch
//
//   c_ik  = adj_e_ik ? d_tx_e_ik + 1/φ[nbr_ik] : NEG
//   m_i   = max_k c_ik
//   deg_i = #{k : adj_e_ik}
//   φ'_i  = deg_i > 0 ? 1 / ((1/F_i + m_i) / (deg_i + 1)) : F_i
//
// op for op core/diffusive.py::phi_update_sparse (the same ``visit`` and
// ``update_out`` as phi_update), so bit-identical to it, and to the dense
// update where the lists cover every neighbour.  It replaces the chain
// 1/φ, where, diffusive_phi_sparse, the degree sum, its compare, 1/x and
// where.  Bytes: R·N·K·9 (adjacency byte, index and delay of a slot) and
// R·N·12 (φ, F, φ'); the gathered φ reads go through L2.
//
// A group of G lanes takes a row (G the next power of two >= K for K <=
// 32, so a half-warp a row and two rows a warp at K = 16; G = 32 looping
// over the slots for K > 32): lane l reads slot l, so the three [R, N, K]
// operands load coalesced across the warp.  1/φ of a gathered neighbour
// is one IEEE division per on-link slot, the bits of the plain
// ``1.0 / phi``, with no shared-memory row, so N has no cap here.  The
// group reduces by xor shuffles of width G; lane 0 of the group writes.  A
// list index outside [0, N) on an on-link slot is a caller bug: the slot
// is not read and the row comes out NaN.  Off-link slots read no φ.
// ---------------------------------------------------------------------------

template <int G>
__global__ void __launch_bounds__(kThreads)
phi_update_sparse_kernel(const float* __restrict__ phi,
                         const float* __restrict__ F,
                         const uint8_t* __restrict__ adj,
                         const int32_t* __restrict__ nbr,
                         const float* __restrict__ dtx,
                         float* __restrict__ out, int64_t rows, int N,
                         int K) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t row = t / G;
  const int lane = static_cast<int>(t % G);
  // a row past the last still joins the shuffles (every lane of the warp
  // must) and loads nothing
  const bool live = row < rows;
  float m = -INFINITY;
  int deg = 0, bad = 0;
  if (live) {
    const int64_t base = row * K;
    const float* ph = phi + (row / N) * N;
    for (int k = lane; k < K; k += G) {
      const bool on = __ldg(adj + base + k) != 0;
      const int idx = __ldg(nbr + base + k);
      const float d = __ldg(dtx + base + k);
      float inv = 0.0f;
      if (on) {
        if (idx >= 0 && idx < N) inv = 1.0f / __ldg(ph + idx);
        else bad = 1;
      }
      visit(m, deg, on, d, inv);
    }
  }
  if (G > 1) {
    group_reduce(m, deg, G);
    for (int off = G >> 1; off > 0; off >>= 1)
      bad |= __shfl_xor_sync(0xffffffffu, bad, off);
  }
  if (live && lane == 0) out[row] = bad ? NAN : update_out(F[row], m, deg);
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

// phi, F, out [R, N] float32; adj [R, N, N] bool (one byte each); dtx
// [R, N, N] float32; all contiguous; N <= kMaxUpdateN.  chunk: rows a
// block.
int phi_update_launch(const float* phi, const float* F, const uint8_t* adj,
                      const float* dtx, float* out, int R, int N, int chunk,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R <= 0 || N <= 0 || N > kMaxUpdateN || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_run = (N + chunk - 1) / chunk;
  if (static_cast<int64_t>(per_run) * R >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(per_run * R);
  const bool vec = N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(adj) & 3u) == 0 &&
                   (reinterpret_cast<uintptr_t>(dtx) & 15u) == 0;
  const size_t bytes = static_cast<size_t>(N) * sizeof(float);
  auto kernel = vec ? &phi_update_kernel<true> : &phi_update_kernel<false>;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      phi, F, adj, dtx, out, N, chunk, per_run);
  return static_cast<int>(cudaGetLastError());
}

// phi, F, out [R, N] float32; adj [R, N, K] bool (one byte each); nbr
// [R, N, K] int32; dtx [R, N, K] float32; all contiguous.
int phi_update_sparse_launch(const float* phi, const float* F,
                             const uint8_t* adj, const int32_t* nbr,
                             const float* dtx, float* out, int R, int N,
                             int K, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R <= 0 || N <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = static_cast<int64_t>(R) * N;
  int G = 1;
  while (G < K && G < 32) G <<= 1;
  const int64_t blocks = (rows * G + kThreads - 1) / kThreads;
  if (blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PHI_SPARSE_ARGS phi, F, adj, nbr, dtx, out, rows, N, K
  switch (G) {
    case 1: phi_update_sparse_kernel<1><<<grid, kThreads, 0, s>>>(
        PHI_SPARSE_ARGS); break;
    case 2: phi_update_sparse_kernel<2><<<grid, kThreads, 0, s>>>(
        PHI_SPARSE_ARGS); break;
    case 4: phi_update_sparse_kernel<4><<<grid, kThreads, 0, s>>>(
        PHI_SPARSE_ARGS); break;
    case 8: phi_update_sparse_kernel<8><<<grid, kThreads, 0, s>>>(
        PHI_SPARSE_ARGS); break;
    case 16: phi_update_sparse_kernel<16><<<grid, kThreads, 0, s>>>(
        PHI_SPARSE_ARGS); break;
    default: phi_update_sparse_kernel<32><<<grid, kThreads, 0, s>>>(
        PHI_SPARSE_ARGS); break;
  }
#undef PHI_SPARSE_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
