// The backward passes of the MoE block's two row gathers, hand-written for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: JAX differentiates the reference's gathers
// (repro/models/moe.py::_moe_shard) as scatter-adds, and autograd's
// backward of an advanced-index read on CUDA is index_put_ with
// accumulate, which sorts the indices and walks each run of equal indices
// in series, one warp a run.  Both gathers of models/moe.py::_moe_shard
// have one very long run: every empty capacity slot of the dispatch reads
// token 0, every dropped assignment of the combine reads slot n_slots - 1.
// These kernels compute the same gradients from the inverse maps the
// forward already has, with no sort, no atomics and no run of equal
// indices.  ops.MoEDispatch and ops.MoECombine pair them with their
// forward gathers; the plain twins are kernels/ref.py::moe_dispatch_bwd and
// ::moe_combine_bwd.
//
//   moe_dispatch_bwd:  dx[t] = Σ_j dbuf[tok_slot[t, j]]  over j = 0..k-1
//                      with tok_slot[t, j] < n_slots (n_slots: no slot)
//   moe_combine_bwd:   dy[s] = src[s] >= 0 ? drows[src[s]] : 0
//
// dbuf [n_slots, d], tok_slot [T, k] int64, dx [T, d]; drows [A, d], src
// [n_slots] int64, dy [n_slots, d]; the rows float32 or bfloat16.  A
// token's slots are listed in ascending slot order, and the sum takes them
// in that order from a zero of the output dtype, rounding each partial sum
// to that dtype (__fadd_rn, then __float2bfloat16_rn in bfloat16).  That is
// the arithmetic of the accumulating index_put_ these kernels replace,
// which reads the output row, adds in float32 and writes it back at each
// index of a run, in the stable sort's order, ascending slot order; its
// other terms are the zero gradients of empty slots and dropped
// assignments, which change no sum.  So the gradients equal the library's
// bit for bit (a zero's sign aside).
//
// What bounds them on this card: bytes.  At granite-moe's training shape
// (T 8,192, k 8, d 1,024, 81,920 slots, about 38k kept) the dispatch reads
// the kept rows once and writes the tokens' (about 95 MB), the combine
// reads them once and writes every slot's row (about 246 MB).  A row is
// cut into 16-byte chunks (8 bf16 or 4 f32); TPR threads take a row (a
// power of two up to 32), chunk c on thread c mod TPR, so a warp's loads
// of a chunk index are consecutive 16-byte words; a block of 256 threads
// takes 256 / TPR rows.  The dispatch loads up to 8 of a token's rows of
// a chunk before it adds them, the combine 4 chunks of its row before it
// writes them, to keep bytes in flight.  Where d·sizeof(T) is not a
// multiple of 16 or a pointer is not 16-byte aligned, a chunk is one
// element (V = 1).
//
// C interface, loaded with ctypes: each launcher returns the cudaError_t
// of its launch (0 on success) and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsAhead = 8;    // a token's rows loaded before their adds
constexpr int kChunksAhead = 4;  // a slot's chunks loaded before stores

template <typename T, int V>
struct alignas(sizeof(T) * V) Chunk {
  T v[V];
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// acc + x rounded to T, returned widened (the index_put_ step)
__device__ __forceinline__ float add_rounded(float acc, float x, float) {
  return __fadd_rn(acc, x);
}
__device__ __forceinline__ float add_rounded(float acc, float x,
                                             __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(acc, x)));
}

__device__ __forceinline__ void narrow(float v, float* out) { *out = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);  // exact: v is already a bf16 value
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    moe_dispatch_bwd_kernel(const T* __restrict__ dbuf,
                            const int64_t* __restrict__ tok_slot,
                            T* __restrict__ dx, int64_t tokens, int k,
                            int64_t n_slots, int chunks, int tpr) {
  using C = Chunk<T, V>;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * (kThreads / tpr) +
                    threadIdx.x / tpr;
  if (t >= tokens) return;
  const int64_t* sl = tok_slot + t * k;
  const C* rows = reinterpret_cast<const C*>(dbuf);
  C* out = reinterpret_cast<C*>(dx) + t * chunks;
  for (int c = threadIdx.x % tpr; c < chunks; c += tpr) {
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
    for (int j0 = 0; j0 < k; j0 += kRowsAhead) {
      C r[kRowsAhead];
      bool held[kRowsAhead];
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u) {
        const int64_t s = j0 + u < k ? __ldg(sl + j0 + u) : n_slots;
        held[u] = s < n_slots;
        if (held[u]) r[u] = rows[s * chunks + c];
      }
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u) {
        if (!held[u]) continue;
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[e] = add_rounded(acc[e], widen(r[u].v[e]), T{});
      }
    }
    C o;
#pragma unroll
    for (int e = 0; e < V; ++e) narrow(acc[e], &o.v[e]);
    out[c] = o;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    moe_combine_bwd_kernel(const T* __restrict__ drows,
                           const int64_t* __restrict__ src,
                           T* __restrict__ dy, int64_t n_slots, int chunks,
                           int tpr) {
  using C = Chunk<T, V>;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * (kThreads / tpr) +
                    threadIdx.x / tpr;
  if (s >= n_slots) return;
  const int64_t a = __ldg(src + s);
  const C* in = reinterpret_cast<const C*>(drows) + (a >= 0 ? a : 0) * chunks;
  C* out = reinterpret_cast<C*>(dy) + s * chunks;
  for (int c0 = threadIdx.x % tpr; c0 < chunks; c0 += tpr * kChunksAhead) {
    C r[kChunksAhead];
#pragma unroll
    for (int u = 0; u < kChunksAhead; ++u) {
      const int c = c0 + u * tpr;
      if (c < chunks) {
        if (a >= 0) {
          r[u] = in[c];
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) r[u].v[e] = T(0.f);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kChunksAhead; ++u) {
      const int c = c0 + u * tpr;
      if (c < chunks) out[c] = r[u];
    }
  }
}

bool plan_ok(int dtype, int vec, int chunks, int tpr) {
  const int elt = dtype == 0 ? 4 : 2;
  return (dtype == 0 || dtype == 1) && (vec == 1 || vec == 16 / elt) &&
         chunks > 0 && tpr >= 1 && tpr <= 32 && (tpr & (tpr - 1)) == 0;
}

dim3 grid_of(int64_t rows, int tpr) {
  const int64_t per = kThreads / tpr;
  return dim3(static_cast<unsigned>((rows + per - 1) / per));
}

}  // namespace

extern "C" {

// dbuf [n_slots, d], dx [tokens, d] (float32: dtype 0, bfloat16: 1),
// tok_slot [tokens, k] int64, all contiguous; d = chunks · vec.
int moe_dispatch_bwd_launch(const void* dbuf, const void* tok_slot,
                            void* dx, int64_t tokens, int k,
                            int64_t n_slots, int dtype, int vec, int chunks,
                            int tpr, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tokens <= 0 || k <= 0 || n_slots < 0 ||
      !plan_ok(dtype, vec, chunks, tpr) ||
      (tokens + kThreads / tpr - 1) / (kThreads / tpr) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = grid_of(tokens, tpr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* ts = static_cast<const int64_t*>(tok_slot);
  if (dtype == 0 && vec > 1)
    moe_dispatch_bwd_kernel<float, 4><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(dbuf), ts, static_cast<float*>(dx), tokens,
        k, n_slots, chunks, tpr);
  else if (dtype == 0)
    moe_dispatch_bwd_kernel<float, 1><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(dbuf), ts, static_cast<float*>(dx), tokens,
        k, n_slots, chunks, tpr);
  else if (vec > 1)
    moe_dispatch_bwd_kernel<__nv_bfloat16, 8><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dbuf), ts,
        static_cast<__nv_bfloat16*>(dx), tokens, k, n_slots, chunks, tpr);
  else
    moe_dispatch_bwd_kernel<__nv_bfloat16, 1><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dbuf), ts,
        static_cast<__nv_bfloat16*>(dx), tokens, k, n_slots, chunks, tpr);
  return static_cast<int>(cudaGetLastError());
}

// drows [A, d], dy [n_slots, d] (float32: dtype 0, bfloat16: 1), src
// [n_slots] int64 (an index into drows, or -1), all contiguous; d =
// chunks · vec.
int moe_combine_bwd_launch(const void* drows, const void* src, void* dy,
                           int64_t n_slots, int dtype, int vec, int chunks,
                           int tpr, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_slots <= 0 || !plan_ok(dtype, vec, chunks, tpr) ||
      (n_slots + kThreads / tpr - 1) / (kThreads / tpr) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = grid_of(n_slots, tpr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* sr = static_cast<const int64_t*>(src);
  if (dtype == 0 && vec > 1)
    moe_combine_bwd_kernel<float, 4><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(drows), sr, static_cast<float*>(dy),
        n_slots, chunks, tpr);
  else if (dtype == 0)
    moe_combine_bwd_kernel<float, 1><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(drows), sr, static_cast<float*>(dy),
        n_slots, chunks, tpr);
  else if (vec > 1)
    moe_combine_bwd_kernel<__nv_bfloat16, 8><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(drows), sr,
        static_cast<__nv_bfloat16*>(dy), n_slots, chunks, tpr);
  else
    moe_combine_bwd_kernel<__nv_bfloat16, 1><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(drows), sr,
        static_cast<__nv_bfloat16*>(dy), n_slots, chunks, tpr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
