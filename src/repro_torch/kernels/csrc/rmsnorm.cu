// RMSNorm over the last axis, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::rmsnorm.
// Semantics are the Pallas kernel's: x [rows, d] in float32 or bfloat16,
// scale [d] float32; y = x · rsqrt(mean(x²) + eps) · scale computed in f32
// and written in x's dtype.  The models call it for every rmsnorm (the
// layer norms, the final norm and qwen3's per-head qk-norm), so d runs
// from 128 (qk-norm) to 4096, and the row count is whatever B·S(·H) is:
// 32,768 rows of 128 in qwen3's prefill qk-norm, 4 rows of 4096 in a
// recurrent model's decode step.
//
// What bounds it on this card: bytes.  x is read once and y written once,
// about 3 flops a byte.  The design:
//
// * A row is cut into 16-byte chunks (8 bf16 or 4 f32).  Chunk c of a row
//   belongs to thread c mod P of the P threads that own the row, and each
//   thread keeps its chunks (at most 8) in registers from the sum of
//   squares to the write: x leaves device memory once.  Where d·sizeof(T)
//   is a multiple of 16 and the pointers are 16-byte aligned (every model
//   width), a chunk is one 16-byte load or store and the scale's chunk one
//   or two float4 loads through the read-only path; otherwise the same
//   chunks are read element by element, the tail masked.
// * The launch configuration (P and the chunks a thread, ``rmsnorm.py::
//   launch_plan``) depends on d and the dtype alone.  At d <= 1024 a row
//   takes a warp, or a half-warp where it has at most 16 chunks (qwen3's
//   qk-norm in bf16), several rows a 256-thread block, and reduces by
//   shuffles only: no shared memory, no barrier.  Above, a block takes a
//   row, with enough threads that each holds two chunks (up to 1024
//   threads, then 4 or 8 chunks; past 8 a thread re-reads its chunks from
//   memory for the write), and one barrier joins the warps' sums.
// * The sum of squares: each thread fmaf's its elements in chunk order,
//   then a butterfly of xor shuffles (every lane ends with the same bits:
//   each step adds the same two values on both partners), then, in a
//   block, every warp sums the per-warp partials by the same butterfly.
//   The order depends only on (d, dtype), never on the row count, the
//   grid, or whether the loads were vector or scalar; there are no
//   atomics.  A row normalises to the same bits in a 2048-row prefill and
//   a 4-row decode step.
//
// mean is the sum divided by d (an IEEE division); rsqrtf is the
// hardware's, within 2 ulp; the output is (x · r) · scale, the plain
// version's order of the two products.  No --use_fast_math.
//
// C interface, loaded with ctypes: the launcher returns the cudaError_t of
// the launch (0 on success) and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsBlock = 256;  // threads of a block in the warp layout
constexpr int kMaxThreads = 1024;

// One 16-byte chunk is four 32-bit words in registers.
template <typename T>
struct Elt;

template <>
struct Elt<float> {
  static constexpr int kVec = 4;
  __device__ static float get(const uint32_t (&w)[4], int e) {
    return __uint_as_float(w[e]);
  }
  __device__ static void put(uint32_t (&w)[4], int e, uint32_t bits) {
    w[e] = bits;
  }
  __device__ static uint32_t bits(const float* p, int64_t i) {
    return __float_as_uint(p[i]);
  }
  __device__ static uint32_t encode(float v) { return __float_as_uint(v); }
  __device__ static void store(float* p, int64_t i, uint32_t bits) {
    p[i] = __uint_as_float(bits);
  }
};

template <>
struct Elt<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float get(const uint32_t (&w)[4], int e) {
    const uint32_t u = w[e >> 1];
    return __uint_as_float((e & 1) ? (u & 0xffff0000u) : (u << 16));
  }
  __device__ static void put(uint32_t (&w)[4], int e, uint32_t bits) {
    w[e >> 1] |= bits << (16 * (e & 1));
  }
  __device__ static uint32_t bits(const __nv_bfloat16* p, int64_t i) {
    return reinterpret_cast<const uint16_t*>(p)[i];
  }
  __device__ static uint32_t encode(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));  // as torch's .to()
  }
  __device__ static void store(__nv_bfloat16* p, int64_t i, uint32_t bits) {
    reinterpret_cast<uint16_t*>(p)[i] = static_cast<uint16_t>(bits);
  }
};

// Chunk c of a row: one 16-byte load (VECIO), else element by element with
// the elements past d left 0 (they add exactly nothing to the sum).
template <typename T, bool VECIO>
__device__ __forceinline__ void load_chunk(const T* __restrict__ row, int c,
                                           int d, uint32_t (&w)[4]) {
  constexpr int V = Elt<T>::kVec;
  if (VECIO) {
    const uint4 u = reinterpret_cast<const uint4*>(row)[c];
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else {
    w[0] = w[1] = w[2] = w[3] = 0u;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int i = c * V + e;
      if (i < d) Elt<T>::put(w, e, Elt<T>::bits(row, i));
    }
  }
}

template <typename T>
__device__ __forceinline__ float sum_squares(const uint32_t (&w)[4],
                                             float ss) {
#pragma unroll
  for (int e = 0; e < Elt<T>::kVec; ++e) {
    const float v = Elt<T>::get(w, e);
    ss = fmaf(v, v, ss);
  }
  return ss;
}

// y's chunk c = (x · r) · scale, written as one 16-byte store (VECIO) or
// element by element up to d.
template <typename T, bool VECIO>
__device__ __forceinline__ void write_chunk(const uint32_t (&w)[4],
                                            const float* __restrict__ scale,
                                            T* __restrict__ row, int c, int d,
                                            float r) {
  constexpr int V = Elt<T>::kVec;
  float s[V];
  if (VECIO) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(scale) +
                             c * (V / 4) + q);
      s[4 * q] = f.x, s[4 * q + 1] = f.y, s[4 * q + 2] = f.z,
      s[4 * q + 3] = f.w;
    }
    uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < V; ++e)
      Elt<T>::put(o, e, Elt<T>::encode((Elt<T>::get(w, e) * r) * s[e]));
    reinterpret_cast<uint4*>(row)[c] = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int i = c * V + e;
      if (i < d)
        Elt<T>::store(row, i, Elt<T>::encode((Elt<T>::get(w, e) * r) *
                                             __ldg(scale + i)));
    }
  }
}

__device__ __forceinline__ float butterfly(float v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float inv_rms(float ss, int d, float eps) {
  return rsqrtf(__fdiv_rn(ss, static_cast<float>(d)) + eps);
}

// d <= 1024: LANES (16 or 32) lanes a row, kRowsBlock / LANES rows a block,
// NV chunks a lane.  Lanes of a row past the last one load nothing but
// still take part in the shuffles (every lane of the warp must).
template <typename T, int LANES, int NV, bool VECIO>
__global__ void __launch_bounds__(kRowsBlock)
rmsnorm_kernel_rows(const T* __restrict__ x, const float* __restrict__ scale,
                    T* __restrict__ y, int rows, int d, float eps) {
  constexpr int V = Elt<T>::kVec;
  const int64_t row = static_cast<int64_t>(blockIdx.x) *
                          (kRowsBlock / LANES) + threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const bool live = row < rows;
  const int chunks = (d + V - 1) / V;
  const T* xr = x + row * d;
  uint32_t w[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = lane + j * LANES;
    if (live && c < chunks) {
      load_chunk<T, VECIO>(xr, c, d, w[j]);
    } else {
      w[j][0] = w[j][1] = w[j][2] = w[j][3] = 0u;
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) ss = sum_squares<T>(w[j], ss);
  const float r = inv_rms(butterfly(ss, LANES), d, eps);
  if (!live) return;
  T* yr = y + row * d;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = lane + j * LANES;
    if (c < chunks) write_chunk<T, VECIO>(w[j], scale, yr, c, d, r);
  }
}

// d > 1024: one block a row, NV chunks a thread (chunk c on thread c mod
// blockDim.x); NV = 0 streams: the thread re-reads its chunks to write.
template <typename T, int NV, bool VECIO>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel_block(const T* __restrict__ x, const float* __restrict__ scale,
                     T* __restrict__ y, int d, float eps) {
  __shared__ float partial[kMaxThreads / 32];
  constexpr int V = Elt<T>::kVec;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const int P = blockDim.x;
  const int chunks = (d + V - 1) / V;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int NR = NV > 0 ? NV : 1;
  uint32_t w[NR][4];
  float ss = 0.f;
  if (NV > 0) {
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int c = threadIdx.x + j * P;
      if (c < chunks) {
        load_chunk<T, VECIO>(xr, c, d, w[j]);
      } else {
        w[j][0] = w[j][1] = w[j][2] = w[j][3] = 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < NR; ++j) ss = sum_squares<T>(w[j], ss);
  } else {
    for (int c = threadIdx.x; c < chunks; c += P) {
      load_chunk<T, VECIO>(xr, c, d, w[0]);
      ss = sum_squares<T>(w[0], ss);
    }
  }
  ss = butterfly(ss, 32);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  const float r = inv_rms(
      butterfly(lane < (P >> 5) ? partial[lane] : 0.f, 32), d, eps);
  if (NV > 0) {
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int c = threadIdx.x + j * P;
      if (c < chunks) write_chunk<T, VECIO>(w[j], scale, yr, c, d, r);
    }
  } else {
    for (int c = threadIdx.x; c < chunks; c += P) {
      load_chunk<T, VECIO>(xr, c, d, w[0]);
      write_chunk<T, VECIO>(w[0], scale, yr, c, d, r);
    }
  }
}

template <typename T, bool VECIO>
cudaError_t launch(const void* xv, const void* scale, void* yv, int rows,
                   int d, float eps, int threads, int nv, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const float* sc = static_cast<const float*>(scale);
  T* y = static_cast<T*>(yv);
  if (threads == 16 || threads == 32) {
    const unsigned rows_block = kRowsBlock / threads;
    const unsigned grid = (static_cast<unsigned>(rows) + rows_block - 1) /
                          rows_block;
#define ROWS(L, N)                                                        \
  if (threads == L && nv == N) {                                          \
    rmsnorm_kernel_rows<T, L, N, VECIO><<<grid, kRowsBlock, 0, s>>>(      \
        x, sc, y, rows, d, eps);                                          \
    return cudaGetLastError();                                            \
  }
    ROWS(16, 1) ROWS(32, 1) ROWS(32, 2) ROWS(32, 4) ROWS(32, 8)
#undef ROWS
    return cudaErrorInvalidValue;
  }
  if (threads % 32 != 0 || threads < 64 || threads > kMaxThreads)
    return cudaErrorInvalidValue;
#define BLOCK(N)                                                          \
  if (nv == N) {                                                          \
    rmsnorm_kernel_block<T, N, VECIO><<<rows, threads, 0, s>>>(x, sc, y,  \
                                                               d, eps);   \
    return cudaGetLastError();                                            \
  }
  BLOCK(2) BLOCK(4) BLOCK(8) BLOCK(0)
#undef BLOCK
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
cudaError_t dispatch(const void* x, const void* scale, void* y, int rows,
                     int d, float eps, int threads, int nv, cudaStream_t s) {
  const bool vecio = d % Elt<T>::kVec == 0 && aligned16(x) &&
                     aligned16(y) && aligned16(scale);
  return vecio ? launch<T, true>(x, scale, y, rows, d, eps, threads, nv, s)
               : launch<T, false>(x, scale, y, rows, d, eps, threads, nv, s);
}

}  // namespace

extern "C" {

// x, y [rows, d] contiguous, of one dtype: 0 = float32, 1 = bfloat16;
// scale [d] float32.  threads (a row's threads: 16 or 32 for the warp
// layout, a multiple of 32 from 64 to 1024 for a block a row) and nv (16-
// byte chunks a thread; 0 streams) come from rmsnorm.py::launch_plan.
int rmsnorm_launch(const void* x, const void* scale, void* y, int rows,
                   int d, float eps, int dtype, int threads, int nv,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = dispatch<float>(x, scale, y, rows, d, eps, threads, nv, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(x, scale, y, rows, d, eps, threads, nv, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
