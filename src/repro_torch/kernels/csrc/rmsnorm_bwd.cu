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
// at (2048, 4096) bf16, 0.0150 ms at 3.35 TB/s).  The design, one launch:
//
// * A row is cut into 16-byte chunks (8 bf16 or 4 f32), as in the
//   forward.  TPR threads take a row (a power of two from 1 to 512), NV
//   chunks each (2; 1 for a one-chunk row; 4 past 1024 chunks), chunk c on
//   thread c mod TPR, so a warp's loads of a chunk index are consecutive
//   16-byte words.  Each thread holds its chunks of x and dy in registers
//   from the sum of squares to the write of dx, and loads its chunks of
//   the block's next row before it reduces this one, so two rows a row
//   group are in flight; scale is read from L1 at each use.  A block has
//   512 threads, RG = 512 / TPR rows at once, and walks RPB consecutive
//   rows RG at a time; about 132 blocks, one an SM (at most 128 registers
//   a thread).  A row's two sums, of x² and of g·x (mean(g·x̂) = rstd ·
//   Σ g·x / d), reduce together by an xor butterfly over its lanes and,
//   where a row spans warps, through shared memory, every thread adding
//   the warps' sums in order: one pair of barriers a row.  Where
//   d·sizeof(T) is not a multiple of 16 or a pointer is not 16-byte
//   aligned, the same chunks are read and written element by element
//   (VECIO false).
// * dscale in the same launch.  Each thread keeps its columns' Σ dy·x̂
//   over its rows in registers; the RG row groups of a block are summed in
//   order through shared memory into the block's partial row.  The blocks
//   form groups of GROUP consecutive blocks: each block writes its partial
//   row, does a __threadfence() and adds one to its group's int32 ticket;
//   the block that draws the group's last ticket sums the group's partial
//   rows in block order (a group partial, or dscale itself where there is
//   one group) and resets the ticket; the last of those, by a second
//   ticket, sums the group partials in group order into dscale.  The two
//   levels keep the tail short: the one block that sums last reads about
//   √(blocks) rows of d floats, not one row a block, with 16 rows' loads
//   in flight a thread.  The integer atomics
//   decide only which block sums, never a sum.
//
// The plan (TPR, NV, RPB, the blocks and GROUP) follows from (rows, d,
// dtype) alone (rmsnorm_bwd.py::bwd_plan), never from the card, so every
// sum runs in one fixed order and two launches give the same bits; there
// are no float atomics.  mean is the sum divided by d (an IEEE division),
// rsqrtf as in the forward kernel; no --use_fast_math.
//
// C interface, loaded with ctypes: the launcher returns the cudaError_t of
// its launch (0 on success) and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 512;        // a block's threads

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
  __device__ static uint32_t take(const uint32_t (&w)[4], int e) {
    return w[e];
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
  __device__ static uint32_t take(const uint32_t (&w)[4], int e) {
    return (w[e >> 1] >> (16 * (e & 1))) & 0xffffu;
  }
  __device__ static uint32_t encode(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static void store(__nv_bfloat16* p, int64_t i, uint32_t bits) {
    reinterpret_cast<uint16_t*>(p)[i] = static_cast<uint16_t>(bits);
  }
};

// Chunk c of a row: one 16-byte load (VECIO), else element by element with
// the elements past d left 0 (they add exactly nothing to any sum).
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

// The row's two sums (of x² and of g·x) over its TPR threads; every one of
// them gets the same bits.  red holds one pair a warp; all threads of the
// block call it.
template <int TPR>
__device__ __forceinline__ float2 row_sum(float2 v, float2* red) {
  constexpr int W = TPR < 32 ? TPR : 32;
#pragma unroll
  for (int o = W >> 1; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  if (TPR <= 32) return v;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  const int first = (threadIdx.x / TPR) * (TPR / 32);
  float2 tot = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < TPR / 32; ++i) {
    tot.x += red[first + i].x;
    tot.y += red[first + i].y;
  }
  __syncthreads();
  return tot;
}

// Adds one to ``*ticket``; true in the block that draws the last of
// ``members`` tickets, which also resets it.  Every thread calls it.
__device__ __forceinline__ bool last_of(int* ticket, int members,
                                        int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int t = atomicAdd(ticket, 1);
    *flag = t == members - 1;
    if (*flag) *ticket = 0;
  }
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// out[i] = Σ_p src[p·d + i] over rows p < n, p ascending, for every column
// i < d.  The block's threads take four columns at a time (one at a time
// where d is not a multiple of 4) and issue kInFlight rows' loads of them
// before adding, so that the sum is not a chain of round trips to L2.
template <int NT>
__device__ __forceinline__ void sum_rows(const float* src, int n, int d,
                                         float* out) {
  constexpr int kInFlight = 16;
  if ((d & 3) == 0) {
    for (int c = threadIdx.x * 4; c < d; c += NT * 4) {
      float4 tot = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int p0 = 0; p0 < n; p0 += kInFlight) {
        float4 v[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)
          if (p0 + u < n)
            v[u] = __ldcg(reinterpret_cast<const float4*>(
                src + static_cast<int64_t>(p0 + u) * d + c));
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)
          if (p0 + u < n) {
            tot.x += v[u].x;
            tot.y += v[u].y;
            tot.z += v[u].z;
            tot.w += v[u].w;
          }
      }
      *reinterpret_cast<float4*>(out + c) = tot;
    }
  } else {
    for (int c = threadIdx.x; c < d; c += NT) {
      float tot = 0.f;
      for (int p0 = 0; p0 < n; p0 += kInFlight) {
        float v[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)
          if (p0 + u < n)
            v[u] = __ldcg(src + static_cast<int64_t>(p0 + u) * d + c);
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)
          if (p0 + u < n) tot += v[u];
      }
      out[c] = tot;
    }
  }
}

template <typename T, int TPR, int NV, bool VECIO>
__global__ void __launch_bounds__(kBlock)
    rmsnorm_bwd_kernel(const T* __restrict__ x,
                       const float* __restrict__ scale,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ dscale, float* partial,
                       float* gpartial, int* tickets, int rows, int d,
                       float eps, int rpb, int n_part, int group) {
  constexpr int NT = kBlock;
  constexpr int RG = NT / TPR;                 // rows a block has in flight
  constexpr int V = Elt<T>::kVec;
  extern __shared__ float rowgroups[];         // [RG][d] where RG > 1
  __shared__ float2 red[NT / 32];
  __shared__ int flag;
  const int t = threadIdx.x, grp = t / TPR, lane = t % TPR;
  const int chunks = (d + V - 1) / V;
  const int r_begin = blockIdx.x * rpb;
  const int r_end = min(rows, r_begin + rpb);
  const float fd = static_cast<float>(d);

  float acc[NV][V];
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[k][e] = 0.f;
  // scale's elements of chunk k, from L1 at each use (zero past d)
  auto scale_at = [&](int k, float (&sv)[V]) {
    const int c = lane + TPR * k;
    if (VECIO) {
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const float4 f =
            c < chunks ? __ldg(reinterpret_cast<const float4*>(scale) +
                               c * (V / 4) + q)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        sv[4 * q] = f.x, sv[4 * q + 1] = f.y, sv[4 * q + 2] = f.z,
        sv[4 * q + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        sv[e] = c < chunks && c * V + e < d ? __ldg(scale + c * V + e) : 0.f;
    }
  };
  // this thread's chunks of x and dy in a row, zero past the block's rows
  auto fetch = [&](int row, uint32_t (&xa)[NV][4], uint32_t (&ga)[NV][4]) {
    const int64_t off = static_cast<int64_t>(row) * d;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = lane + TPR * k;
      if (row < r_end && c < chunks) {
        load_chunk<T, VECIO>(x + off, c, d, xa[k]);
        load_chunk<T, VECIO>(dy + off, c, d, ga[k]);
      } else {
        xa[k][0] = xa[k][1] = xa[k][2] = xa[k][3] = 0u;
        ga[k][0] = ga[k][1] = ga[k][2] = ga[k][3] = 0u;
      }
    }
  };
  uint32_t xw[NV][4], gw[NV][4];
  fetch(r_begin + grp, xw, gw);
  for (int r0 = r_begin; r0 < r_begin + rpb; r0 += RG) {
    const int row = r0 + grp;
    const int64_t off = static_cast<int64_t>(row) * d;
    uint32_t xn[NV][4], gn[NV][4];
    fetch(row + RG, xn, gn);          // the next row in flight meanwhile
    float2 sums = make_float2(0.f, 0.f);       // Σ x², Σ g·x
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float sv[V];
      scale_at(k, sv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float v = Elt<T>::get(xw[k], e);
        sums.x = fmaf(v, v, sums.x);
        sums.y = fmaf(Elt<T>::get(gw[k], e) * sv[e], v, sums.y);
      }
    }
    sums = row_sum<TPR>(sums, red);
    const float rstd = rsqrtf(__fdiv_rn(sums.x, fd) + eps);
    const float mdot = __fdiv_rn(sums.y * rstd, fd);   // mean(g·x̂)
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = lane + TPR * k;
      if (row >= r_end || c >= chunks) continue;
      uint32_t o[4] = {0u, 0u, 0u, 0u};
      float sv[V];
      scale_at(k, sv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float dyv = Elt<T>::get(gw[k], e);
        const float xh = Elt<T>::get(xw[k], e) * rstd;
        acc[k][e] = fmaf(dyv, xh, acc[k][e]);
        Elt<T>::put(o, e, Elt<T>::encode(rstd * (dyv * sv[e] - xh * mdot)));
      }
      if (VECIO) {
        reinterpret_cast<uint4*>(dx + off)[c] = make_uint4(o[0], o[1], o[2],
                                                           o[3]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (c * V + e < d) Elt<T>::store(dx + off, c * V + e,
                                           Elt<T>::take(o, e));
      }
    }
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        xw[k][w] = xn[k][w];
        gw[k][w] = gn[k][w];
      }
  }

  // the block's partial row of dscale: its row groups summed in order
  float* mine = partial + static_cast<int64_t>(blockIdx.x) * d;
  if (RG == 1) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = (lane + TPR * k) * V + e;
        if (i < d) mine[i] = acc[k][e];
      }
  } else {
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = (lane + TPR * k) * V + e;
        if (i < d) rowgroups[grp * d + i] = acc[k][e];
      }
    __syncthreads();
    for (int i = t; i < d; i += NT) {
      float tot = 0.f;
#pragma unroll 8
      for (int g = 0; g < RG; ++g) tot += rowgroups[g * d + i];
      mine[i] = tot;
    }
  }

  // the group's partial rows, summed by the group's last block
  const int gi = blockIdx.x / group, n_groups = (n_part + group - 1) / group;
  const int first = gi * group, members = min(group, n_part - first);
  if (!last_of(tickets + gi, members, &flag)) return;
  sum_rows<NT>(partial + static_cast<int64_t>(first) * d, members, d,
               n_groups == 1 ? dscale
                             : gpartial + static_cast<int64_t>(gi) * d);
  if (n_groups == 1) return;

  // the group partials, summed in group order by the last group's block
  if (!last_of(tickets + n_groups, n_groups, &flag)) return;
  sum_rows<NT>(gpartial, n_groups, d, dscale);
}

template <typename T, int TPR, int NV, bool VECIO>
cudaError_t launch(const void* x, const void* scale, const void* dy,
                   void* dx, void* dscale, void* partial, void* gpartial,
                   int* tickets, int rows, int d, float eps, int rpb,
                   int n_part, int group, cudaStream_t stream) {
  constexpr int NT = kBlock;
  const size_t smem = NT / TPR > 1 ? static_cast<size_t>(NT / TPR) * d * 4 : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rmsnorm_bwd_kernel<T, TPR, NV, VECIO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  rmsnorm_bwd_kernel<T, TPR, NV, VECIO><<<n_part, kBlock, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(dscale), static_cast<float*>(partial),
      static_cast<float*>(gpartial), tickets, rows, d, eps, rpb, n_part,
      group);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, bool VECIO>
cudaError_t dispatch(int tpr, int nv, const void* x, const void* scale,
                     const void* dy, void* dx, void* dscale, void* partial,
                     void* gpartial, int* tickets, int rows, int d, float eps,
                     int rpb, int n_part, int group, cudaStream_t stream) {
#define NORM_BWD(P, N)                                                      \
  if (tpr == P && nv == N)                                                  \
    return launch<T, P, N, VECIO>(x, scale, dy, dx, dscale, partial,        \
                                  gpartial, tickets, rows, d, eps, rpb,     \
                                  n_part, group, stream);
  NORM_BWD(1, 1) NORM_BWD(1, 2) NORM_BWD(2, 2) NORM_BWD(4, 2)
  NORM_BWD(8, 2) NORM_BWD(16, 2) NORM_BWD(32, 2) NORM_BWD(64, 2)
  NORM_BWD(128, 2) NORM_BWD(256, 2) NORM_BWD(512, 2) NORM_BWD(512, 4)
#undef NORM_BWD
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_io(int tpr, int nv, const void* x, const void* scale,
                        const void* dy, void* dx, void* dscale, void* partial,
                        void* gpartial, int* tickets, int rows, int d,
                        float eps, int rpb, int n_part, int group,
                        cudaStream_t s) {
  const bool vecio = d % Elt<T>::kVec == 0 && aligned16(x) &&
                     aligned16(dy) && aligned16(dx) && aligned16(scale);
  return vecio ? dispatch<T, true>(tpr, nv, x, scale, dy, dx, dscale,
                                   partial, gpartial, tickets, rows, d, eps,
                                   rpb, n_part, group, s)
               : dispatch<T, false>(tpr, nv, x, scale, dy, dx, dscale,
                                    partial, gpartial, tickets, rows, d, eps,
                                    rpb, n_part, group, s);
}

}  // namespace

extern "C" {

// x, dy, dx [rows, d] contiguous, of one dtype: 0 = float32, 1 =
// bfloat16; scale and dscale [d] float32; partial [n_part, d] and gpartial
// [ceil(n_part / group), d] float32 scratch; tickets int32 zeros, one a
// group and one more (the launch leaves them zero).  tpr, nv, rpb, n_part
// and group come from rmsnorm_bwd.py::bwd_plan.
int rmsnorm_bwd_launch(const void* x, const void* scale, const void* dy,
                       void* dx, void* dscale, void* partial, void* gpartial,
                       void* tickets, int rows, int d, float eps, int dtype,
                       int tpr, int nv, int rpb, int n_part, int group,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rg = tpr >= kBlock ? 1 : kBlock / (tpr > 0 ? tpr : 1);
  if (rows <= 0 || d <= 0 || rpb <= 0 || n_part <= 0 || group <= 0 ||
      rpb % rg != 0 || static_cast<int64_t>(rpb) * n_part < rows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* tk = static_cast<int*>(tickets);
  if (dtype == 0)
    err = dispatch_io<float>(tpr, nv, x, scale, dy, dx, dscale, partial,
                             gpartial, tk, rows, d, eps, rpb, n_part, group,
                             s);
  else if (dtype == 1)
    err = dispatch_io<__nv_bfloat16>(tpr, nv, x, scale, dy, dx, dscale,
                                     partial, gpartial, tk, rows, d, eps, rpb,
                                     n_part, group, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
