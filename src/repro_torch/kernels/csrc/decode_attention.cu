// Decode attention (flash-decode): one new query per head against a KV
// cache, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::
// decode_attention.  Semantics are the Pallas kernel's: q [B,Hq,hd] and the
// caches k, v [B,S,Hkv,hd] are read in their dtype (float32 or bfloat16)
// and upcast to f32; s = q·kᵀ·scale in f32 with scale = 1/√hd; cache slot
// kpos is kept where kpos <= pos and, with a window, pos - kpos < window;
// the softmax is online in f32; the output is acc / (l == 0 ? 1 : l) in
// q's dtype.  The G = Hq / Hkv query heads of kv head hk are heads
// hk·G .. hk·G + G - 1 (the [B, Hkv, G, hd] view of q), and stay together
// (GM of them a block) so that each K and V row is read once for all.
//
// What bounds it on this card: bytes.  Each kept K and V row is read once
// and used by G queries, about G flops a byte (2 at the serving path's
// shape, B = 4, Hkv = 8, G = 2, hd = 128), far below the ~20 flops a byte
// at which the f32 CUDA cores would bound it.  So the design is about how
// many bytes are in flight on how many SMs:
//
// * The TPU grid walks the whole cache in order (its last, sequential axis)
//   with m, l and acc in VMEM scratch, and masks slots past pos.  Here the
//   host passes the kept range [lo, hi] (pos is a host int), so only the
//   slots needed are read: a decode at step t reads t + 1 rows.
// * Split-S over the whole card: the kept range is cut into `splits`
//   contiguous chunks of `chunk` slots (the host's split_plan, in
//   kernels/decode_attention.py, chooses them so that the grid (splits,
//   Hkv · groups, B) has at least two blocks for each SM where the range is
//   long enough, and at most 64 splits; 512 blocks at the serving shape at
//   pos 1023).
// * Inside a block (4 warps), the chunk streams through a ring of 2 stages
//   of 16 KB of K and V rows in shared memory (rows padded by 16 bytes, so
//   that the rows neighbouring threads read fall in different banks),
//   filled by cp.async (16 bytes a thread): a block's first 32 KB are in
//   flight at once (the whole chunk at the serving shape), and at 37 KB of
//   shared memory several blocks share an SM.  A deeper ring measured
//   slower: the first tile lands later when every block asks for more at
//   once.  A tile is computed in three steps between barriers:
//   the scores (thread (row, slice) takes a slice of hd of one row for
//   every query, the slices summed in a fixed order), the online softmax
//   (a warp a query, a lane a row), and acc += p·V (a thread a pair of
//   columns, each V pair read once for all of the thread's queries).  m, l
//   and acc stay in f32 registers; bf16 widens to f32 by exact bit
//   arithmetic.
// * The splits are combined in the same launch: each block writes its (m,
//   l, acc) in f32 to a scratch buffer, then (after a __threadfence) adds
//   one to an int32 counter of its (b, kv head, group).  The block that
//   arrives last combines all splits in split order 0, 1, 2, ..., writes
//   the output and resets the counter to 0.  The integer atomic decides
//   only which block combines, never a sum, so the result does not depend
//   on the order in which blocks finish.  Each read of the last block is a
//   round trip to L2, so it issues the loads of every split's m and l and
//   of the first splits' accumulators together, computes the weights
//   exp(m_s - M) one thread each, and sums in split order.  One split
//   writes the output directly.
//
// * A second entry point, decode_attention_partial_launch, serves the
//   distributed flash-decode: each rank of the "model" axis holds a slice
//   of the cache along S and runs this kernel on it, over the slots of the
//   kept range that fall in its slice (possibly none).  The blocks and the
//   in-launch split combine are the same; only the last write differs: in
//   place of the output in q's dtype it writes the slice's own combined
//   partial in f32, o = acc / l (0 where l = 0), then m and l, hd + 2
//   floats a query head ([B, Hq, hd + 2]).  A slice that keeps no slot
//   writes o = 0, m = -inf and l = 0, never a NaN.  The ranks' partials
//   are combined across ranks on the host side of the collective
//   (kernels/decode_attention.py::combine_partials), in rank order.
//
// expf, not __expf, and no --use_fast_math.
//
// C interface, loaded with ctypes: the launcher returns the cudaError_t of
// the launch (0 on success) and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr int kStageBytes = 16 * 1024;  // K and V rows of one tile
constexpr int kMaxSplits = 64;          // split_plan's limit
constexpr float kNeg = -1e30f;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows of one tile: 16 KB of K and V rows, between 8 and 64 of them.
template <typename T, int HD>
__host__ __device__ constexpr int tile_rows() {
  constexpr int r = kStageBytes / (2 * HD * static_cast<int>(sizeof(T)));
  return r < 8 ? 8 : (r > 64 ? 64 : r);
}

// N consecutive elements starting at p (aligned to N·sizeof(T) bytes), as
// f32: one 2-, 4-, 8- or 16-byte load per 16 bytes.  A bf16 is the top half
// of an f32, so the widening is exact bit arithmetic.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float* out) {
  if constexpr (sizeof(T) == 2 && N == 1) {
    const unsigned short x = *reinterpret_cast<const unsigned short*>(p);
    out[0] = __uint_as_float(static_cast<uint32_t>(x) << 16);
  } else {
    constexpr int kWords = N * sizeof(T) / 4;
    static_assert(kWords == 1 || kWords == 2 || kWords % 4 == 0,
                  "unsupported row slice");
    uint32_t w[kWords];
    if constexpr (kWords % 4 == 0) {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 x = reinterpret_cast<const uint4*>(p)[i];
        w[4 * i] = x.x;
        w[4 * i + 1] = x.y;
        w[4 * i + 2] = x.z;
        w[4 * i + 3] = x.w;
      }
    } else if constexpr (kWords == 2) {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      w[0] = x.x;
      w[1] = x.y;
    } else {
      w[0] = *reinterpret_cast<const unsigned int*>(p);
    }
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      if constexpr (sizeof(T) == 4) {
        out[i] = __uint_as_float(w[i]);
      } else {
        out[2 * i] = __uint_as_float(w[i] << 16);
        out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int HD, int GM>
struct Smem {
  static constexpr int TILE = tile_rows<T, HD>();
  // a row in shared memory: hd elements and 16 bytes, so that the rows that
  // neighbouring threads read fall in different banks
  static constexpr int RS = HD + 16 / sizeof(T);
  static constexpr int NSL = kThreads / TILE;  // slices of hd a score
  static constexpr size_t kRing = sizeof(T) * kStages * 2 * TILE * RS;
  // q [GM][HD], dots [NSL][GM][TILE], p [GM][TILE], alpha [GM], m and l [2][GM]
  // the split combine reuses the ring: m, l and weights [GM][kMaxSplits],
  // then the maxima M [GM]
  static_assert(kRing >= sizeof(float) * GM * (3 * kMaxSplits + 1),
                "the ring holds the split combine");
  static constexpr size_t kBytes =
      kRing + sizeof(float) * (GM * HD + NSL * GM * TILE + GM * TILE + 3 * GM);
};

template <typename T, int HD, int GM>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ pout, float* __restrict__ part,
              int* __restrict__ counters, int S,
              int Hkv, int G, int lo, int hi, int chunk, int splits,
              float scale) {
  using SM = Smem<T, HD, GM>;
  constexpr int TILE = SM::TILE, RS = SM::RS, NSL = SM::NSL;
  constexpr int SL = HD / NSL;                       // elements a slice
  constexpr int EPC = 16 / sizeof(T);                // elements a 16 bytes
  constexpr int CPR = HD / EPC;                      // 16 bytes a row
  constexpr int NP = HD / 2;                         // column pairs a row
  constexpr int TPG = kThreads / NP;                 // threads on a pair
  constexpr int GPT = (GM + TPG - 1) / TPG;          // queries a thread
  constexpr int NMG = (GM + kWarps - 1) / kWarps;    // queries a warp
  static_assert(SL % EPC == 0 && kThreads % TILE == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);              // [stage][K|V][TILE][RS]
  float* qs = reinterpret_cast<float*>(smem + SM::kRing);
  float* dots = qs + GM * HD;
  float* ps = dots + NSL * GM * TILE;
  float* alpha_s = ps + GM * TILE;
  float* ml = alpha_s + GM;
  __shared__ int is_last;

  const int split = blockIdx.x;
  const int groups = gridDim.y / Hkv;
  const int hk = blockIdx.y / groups, gi = blockIdx.y % groups;
  const int b = blockIdx.z, g0 = gi * GM;
  const int Hq = Hkv * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // this block's slots: [first, last]
  const int first = lo + split * chunk;
  const int last = min(hi, first + chunk - 1);
  const int n_rows = last - first + 1;               // <= 0: none kept
  const int n_tiles = n_rows > 0 ? (n_rows + TILE - 1) / TILE : 0;

  const int64_t row = static_cast<int64_t>(Hkv) * HD;
  const T* kb = k + (static_cast<int64_t>(b) * S * Hkv + hk) * HD;
  const T* vb = v + (static_cast<int64_t>(b) * S * Hkv + hk) * HD;
  auto issue = [&](int t) {
    if (t < n_tiles) {
      T* dst = ring + (t % kStages) * 2 * TILE * RS;
      const int r0 = first + t * TILE;
      const int nr = min(TILE, last - r0 + 1);
      for (int i = tid; i < nr * CPR; i += kThreads) {
        const int r = i / CPR, c = (i % CPR) * EPC;
        cp_async16(dst + r * RS + c, kb + (r0 + r) * row + c);
        cp_async16(dst + (TILE + r) * RS + c, vb + (r0 + r) * row + c);
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  for (int i = tid; i < GM * HD; i += kThreads) {
    const int g = i / HD;
    float x = 0.0f;
    if (g0 + g < G) {
      load_row<T, 1>(q + (static_cast<int64_t>(b) * Hq + hk * G + g0) * HD + i,
                     &x);
    }
    qs[i] = x;
  }
  // in the p·V product and after it, this thread owns columns pc and
  // pc + 1 of queries gs, gs + TPG, ...
  const int pc = 2 * (tid % NP), gs = tid / NP;
  float m[NMG], l[NMG], acc[GPT][2];
#pragma unroll
  for (int i = 0; i < NMG; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < GPT; ++i) acc[i][0] = acc[i][1] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    issue(t + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* Ks = ring + (t % kStages) * 2 * TILE * RS;
    const T* Vs = Ks + TILE * RS;
    const int nr = min(TILE, last - (first + t * TILE) + 1);

    // scores: thread (r, slice) takes a slice of hd of row r for every
    // query; rows past nr are computed on stale data and never used
    {
      const int r = tid % TILE, sl = tid / TILE;
      float d[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) d[g] = 0.0f;
#pragma unroll
      for (int c = 0; c < SL; c += EPC) {
        float kf[EPC];
        load_row<T, EPC>(Ks + r * RS + sl * SL + c, kf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const float4* qv =
              reinterpret_cast<const float4*>(qs + g * HD + sl * SL + c);
#pragma unroll
          for (int e = 0; e < EPC / 4; ++e) {
            const float4 w = qv[e];
            d[g] = fmaf(w.x, kf[4 * e], d[g]);
            d[g] = fmaf(w.y, kf[4 * e + 1], d[g]);
            d[g] = fmaf(w.z, kf[4 * e + 2], d[g]);
            d[g] = fmaf(w.w, kf[4 * e + 3], d[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) dots[(sl * GM + g) * TILE + r] = d[g];
    }
    __syncthreads();

    // online softmax: warp w takes queries w, w + 4, ...; a lane takes rows
    // lane and lane + 32
#pragma unroll
    for (int i = 0; i < NMG; ++i) {
      const int g = warp + kWarps * i;
      if (g >= GM) break;
      float s[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = lane + 32 * j;
        float x = -INFINITY;
        if (r < nr) {
          x = 0.0f;
#pragma unroll
          for (int sl = 0; sl < NSL; ++sl) x += dots[(sl * GM + g) * TILE + r];
          x *= scale;
        }
        s[j] = x;
      }
      float mx = fmaxf(s[0], s[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = lane + 32 * j;
        const float p = expf(s[j] - m_new);
        if (r < TILE) ps[g * TILE + r] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
      if (lane == 0) alpha_s[g] = alpha;
    }
    __syncthreads();

    // acc += p · V: a V pair is read once for the thread's queries
#pragma unroll
    for (int i = 0; i < GPT; ++i) {
      const float a = gs + TPG * i < GM ? alpha_s[gs + TPG * i] : 0.0f;
      acc[i][0] *= a;
      acc[i][1] *= a;
    }
#pragma unroll
    for (int r = 0; r < TILE; ++r) {
      if (r < nr) {
        float vf[2];
        load_row<T, 2>(Vs + r * RS + pc, vf);
#pragma unroll
        for (int i = 0; i < GPT; ++i) {
          const int g = gs + TPG * i;
          if (g < GM) {
            const float p = ps[g * TILE + r];
            acc[i][0] = fmaf(p, vf[0], acc[i][0]);
            acc[i][1] = fmaf(p, vf[1], acc[i][1]);
          }
        }
      }
    }
    __syncthreads();  // the stage, dots and p are refilled next
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < NMG; ++i) {
    const int g = warp + kWarps * i;
    if (g < GM && lane == 0) {
      ml[g] = m[i];
      ml[GM + g] = l[i];
    }
  }
  __syncthreads();

  // this split's (m, l, acc): acc [GM][HD], then m [GM], then l [GM]
  const int cidx = (b * Hkv + hk) * groups + gi;
  float* mine = part + (static_cast<int64_t>(cidx) * splits + split) *
                           (GM * (HD + 2));
  // the output rows of this block's queries: out [B, Hq, HD] in T, or the
  // partial [B, Hq, HD + 2] in f32 (o, then m and l)
  const int64_t qrow = static_cast<int64_t>(b) * Hq + hk * G + g0;
  T* dst = pout ? nullptr : out + qrow * HD + pc;
  auto write = [&](int g, float a0, float a1, float m_g, float l_g) {
    const float den = l_g == 0.0f ? 1.0f : l_g;
    if (pout) {
      float* pd = pout + (qrow + g) * (HD + 2);
      pd[pc] = a0 / den;
      pd[pc + 1] = a1 / den;
      if (pc == 0) {
        pd[HD] = l_g == 0.0f ? -INFINITY : m_g;
        pd[HD + 1] = l_g;
      }
    } else {
      dst[g * HD] = from_f32<T>(a0 / den);
      dst[g * HD + 1] = from_f32<T>(a1 / den);
    }
  };
#pragma unroll
  for (int i = 0; i < GPT; ++i) {
    const int g = gs + TPG * i;
    if (g < GM) {
      if (splits > 1) {
        mine[g * HD + pc] = acc[i][0];
        mine[g * HD + pc + 1] = acc[i][1];
      } else if (g0 + g < G) {
        write(g, acc[i][0], acc[i][1], ml[g], ml[GM + g]);
      }
    }
  }
  if (splits == 1) return;
  if (tid < 2 * GM) mine[GM * HD + tid] = ml[tid];

  // the last split of this (b, kv head, group) to finish combines them
  // all.  Thread 0's fence, after the barrier, publishes the whole block's
  // partial before its count; the last block's fence orders its reads after
  // every other count.
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    is_last = atomicAdd(&counters[cidx], 1) == splits - 1;
    if (is_last) __threadfence();
  }
  __syncthreads();
  if (!is_last) return;
  // every split's m and l to shared memory (the ring is free) and the first
  // splits' accumulators to registers, all loads in flight at once (each is
  // a round trip to L2)
  constexpr int REC = GM * (HD + 2);     // floats of a split's record
  constexpr int kBatch = GPT >= 8 ? 2 : 16 / GPT;
  const float* all = part + static_cast<int64_t>(cidx) * splits * REC;
  float* ms = reinterpret_cast<float*>(smem);       // [GM][kMaxSplits]
  float* ls = ms + GM * kMaxSplits;                 // [GM][kMaxSplits]
  float* wt = ls + GM * kMaxSplits;                 // [GM][kMaxSplits]
  float* Ms = wt + GM * kMaxSplits;                 // [GM]
  for (int j = tid; j < splits * GM; j += kThreads) {
    const int sp = j / GM, g = j % GM;
    ms[g * kMaxSplits + sp] = __ldcg(all + sp * REC + GM * HD + g);
    ls[g * kMaxSplits + sp] = __ldcg(all + sp * REC + GM * HD + GM + g);
  }
  float x[GPT][2][kBatch];
  auto fetch = [&](int s0) {
#pragma unroll
    for (int i = 0; i < GPT; ++i)
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int g = gs + TPG * i;
        const bool in = g < GM && s0 + u < splits;
        const float* p = all + (s0 + u) * REC + g * HD + pc;
        x[i][0][u] = in ? __ldcg(p) : 0.0f;
        x[i][1][u] = in ? __ldcg(p + 1) : 0.0f;
      }
  };
  fetch(0);
  __syncthreads();
  // the weights exp(m_s - M), one thread each
  for (int j = tid; j < splits * GM; j += kThreads) {
    const int g = j / splits, sp = j % splits;
    float M = kNeg;
    for (int s2 = 0; s2 < splits; ++s2) M = fmaxf(M, ms[g * kMaxSplits + s2]);
    wt[g * kMaxSplits + sp] = expf(ms[g * kMaxSplits + sp] - M);
    if (sp == 0) Ms[g] = M;
  }
  __syncthreads();
  // L and the accumulators, summed in split order
  float L[GPT], A[GPT][2];
#pragma unroll
  for (int i = 0; i < GPT; ++i) L[i] = A[i][0] = A[i][1] = 0.0f;
  for (int s0 = 0; s0 < splits; s0 += kBatch) {
    if (s0 > 0) fetch(s0);
#pragma unroll
    for (int i = 0; i < GPT; ++i) {
      const int g = min(gs + TPG * i, GM - 1);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (s0 + u < splits) {
          const float w = wt[g * kMaxSplits + s0 + u];
          L[i] = fmaf(ls[g * kMaxSplits + s0 + u], w, L[i]);
          A[i][0] = fmaf(x[i][0][u], w, A[i][0]);
          A[i][1] = fmaf(x[i][1][u], w, A[i][1]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < GPT; ++i) {
    const int g = gs + TPG * i;
    if (g < GM && g0 + g < G) write(g, A[i][0], A[i][1], Ms[g], L[i]);
  }
  if (tid == 0) counters[cidx] = 0;
}

template <typename T, int HD, int GM>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* pout, void* part, void* counters, int B, int S,
                   int Hkv, int G,
                   int lo, int hi, int chunk, int splits, float scale,
                   int device, cudaStream_t stream) {
  constexpr size_t smem = Smem<T, HD, GM>::kBytes;
  static bool raised[64] = {};  // shared-memory limit raised, per device
  if (smem > 48 * 1024 && device >= 0 && device < 64 && !raised[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, HD, GM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  const int groups = (G + GM - 1) / GM;
  if (static_cast<int64_t>(Hkv) * groups > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(splits, Hkv * groups, B);
  decode_kernel<T, HD, GM><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(pout), static_cast<float*>(part),
      static_cast<int*>(counters), S, Hkv, G, lo,
      hi, chunk, splits, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_g(int GM, const void* q, const void* k, const void* v,
                     void* out, void* pout, void* part, void* counters, int B,
                     int S,
                     int Hkv, int G, int lo, int hi, int chunk, int splits,
                     float scale, int device, cudaStream_t stream) {
#define DECODE_ARGS q, k, v, out, pout, part, counters, B, S, Hkv, G, lo, \
                    hi, chunk, splits, scale, device, stream
  switch (GM) {
    case 1: return launch<T, HD, 1>(DECODE_ARGS);
    case 2: return launch<T, HD, 2>(DECODE_ARGS);
    case 4: return launch<T, HD, 4>(DECODE_ARGS);
    case 8: return launch<T, HD, 8>(DECODE_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef DECODE_ARGS
}

template <typename T>
cudaError_t launch_hd(int hd, int GM, const void* q, const void* k,
                      const void* v, void* out, void* pout, void* part,
                      void* counters, int B, int S, int Hkv, int G, int lo,
                      int hi, int chunk,
                      int splits, float scale, int device,
                      cudaStream_t stream) {
#define DECODE_ARGS GM, q, k, v, out, pout, part, counters, B, S, Hkv, G, \
                    lo, hi, chunk, splits, scale, device, stream
  switch (hd) {
    case 16: return launch_g<T, 16>(DECODE_ARGS);
    case 32: return launch_g<T, 32>(DECODE_ARGS);
    case 64: return launch_g<T, 64>(DECODE_ARGS);
    case 128: return launch_g<T, 128>(DECODE_ARGS);
    case 256: return launch_g<T, 256>(DECODE_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef DECODE_ARGS
}


int dispatch(const void* q, const void* k, const void* v, void* out,
             void* pout, void* part, void* counters, int B, int S, int Hkv,
             int G, int GM, int hd, int lo, int hi, int chunk, int splits,
             float scale, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || Hkv <= 0 || G <= 0 || lo < 0 || hi >= S ||
      chunk <= 0 || splits <= 0 || (splits > 1 && (!part || !counters)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DECODE_ARGS hd, GM, q, k, v, out, pout, part, counters, B, S, Hkv, \
                    G, lo, hi, chunk, splits, scale, device, s
  if (dtype == 0) {
    err = launch_hd<float>(DECODE_ARGS);
  } else if (dtype == 1) {
    err = launch_hd<__nv_bfloat16>(DECODE_ARGS);
  } else {
    err = cudaErrorInvalidValue;
  }
#undef DECODE_ARGS
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// q [B,Hq,hd], k/v [B,S,Hkv,hd], out [B,Hq,hd], all contiguous and of one
// dtype: 0 = float32, 1 = bfloat16.  hd is 16, 32, 64, 128 or 256; GM (1,
// 2, 4 or 8) query heads a block.  Slots lo..hi (inclusive) are the kept
// ones, cut into `splits` chunks of `chunk` slots; hi < lo keeps none and
// writes zeros.  With more than one split, part is f32 scratch of
// B·Hkv·⌈G/GM⌉·splits·GM·(hd + 2) floats and counters B·Hkv·⌈G/GM⌉ int32
// zeros, which the launch leaves at zero.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* out, void* part, void* counters, int B,
                            int S, int Hkv, int G, int GM, int hd, int lo,
                            int hi, int chunk, int splits, float scale,
                            int dtype, int device, void* stream) {
  if (!out) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, k, v, out, nullptr, part, counters, B, S, Hkv, G, GM,
                  hd, lo, hi, chunk, splits, scale, dtype, device, stream);
}

// The same on a rank's slice k/v [B,S,Hkv,hd] of the cache, slots lo..hi
// of the slice kept (hi < lo keeps none), writing the slice's partial to
// pout, f32 [B,Hq,hd + 2]: o = acc / l (0 where l = 0), then m (-inf where
// l = 0) and l.  part and counters as above.
int decode_attention_partial_launch(const void* q, const void* k,
                                    const void* v, void* pout, void* part,
                                    void* counters, int B, int S, int Hkv,
                                    int G, int GM, int hd, int lo, int hi,
                                    int chunk, int splits, float scale,
                                    int dtype, int device, void* stream) {
  if (!pout) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, k, v, nullptr, pout, part, counters, B, S, Hkv, G, GM,
                  hd, lo, hi, chunk, splits, scale, dtype, device, stream);
}

}  // extern "C"
