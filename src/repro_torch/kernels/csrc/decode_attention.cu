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
// so that each K and V row is read once for all of them.
//
// What bounds it on this card: bytes.  Each kept K and V row is read once
// and used by G queries, about G flops a byte (2 at the serving path's
// shape, B = 4, Hkv = 8, G = 2, hd = 128), far below the ~20 flops a byte
// at which the f32 CUDA cores would bound it.  The design:
//
// * The TPU grid walks the whole cache in order (its last, sequential axis)
//   with m, l and acc in VMEM scratch, and masks slots past pos.  Here the
//   host passes the kept range [lo, hi] (pos is a host int), so a block
//   reads only the slots it needs: a decode at step t reads t + 1 rows, not
//   the whole cache.
// * One block per (kv head, batch row, group of up to GM query heads), 8
//   warps.  Warp w takes slots lo + w·U .. in strides of 8·U, U slots at a
//   time for memory-level parallelism; each lane holds hd/32 consecutive
//   elements of a row (one 8- or 16-byte load at hd = 128), so a warp reads
//   a row as one coalesced transaction.  A dot product is a 5-step shuffle
//   reduction; m, l and acc stay in registers.  Rows are read straight
//   into registers: each is used once per block, so staging it in shared
//   memory would buy no reuse.
// * The 8 warps' partial (m, l, acc) are combined once at the end through
//   shared memory, flash-decoding's split-S combine inside one block.
// * Occupancy: at the serving path's shape the grid is 8 x 4 x 1 = 32
//   blocks on 132 SMs; a split of the cache over several blocks with a
//   second combine pass is the lever for a later version.
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

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
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

// N consecutive elements starting at p (aligned to N·sizeof(T) bytes), as
// f32: one 2-, 4-, 8- or 16-byte load per 16 bytes.  A bf16 is the top half
// of an f32, so the widening is exact bit arithmetic.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float* out) {
  if constexpr (sizeof(T) == 2 && N == 1) {
    const unsigned short x = __ldg(reinterpret_cast<const unsigned short*>(p));
    out[0] = __uint_as_float(static_cast<uint32_t>(x) << 16);
  } else {
    constexpr int kWords = N * sizeof(T) / 4;
    static_assert(kWords == 1 || kWords == 2 || kWords % 4 == 0,
                  "unsupported row slice");
    uint32_t w[kWords];
    if constexpr (kWords % 4 == 0) {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + i);
        w[4 * i] = x.x;
        w[4 * i + 1] = x.y;
        w[4 * i + 2] = x.z;
        w[4 * i + 3] = x.w;
      }
    } else if constexpr (kWords == 2) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = x.x;
      w[1] = x.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
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

template <typename T, int HD, int GM>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int S, int Hkv,
              int G, int lo, int hi, float scale) {
  // a row is spread over LANES lanes, VPL elements each (at hd = 16 half
  // the warp holds it and the other half adds zeros)
  constexpr int VPL = HD >= 32 ? HD / 32 : 1;
  constexpr int LANES = HD / VPL;
  constexpr int U = (GM * VPL >= 32) ? 2 : 4;       // slots in flight
  extern __shared__ __align__(16) float smem[];
  float* sm_m = smem;                               // [kWarps][GM]
  float* sm_l = sm_m + kWarps * GM;                 // [kWarps][GM]
  float* sm_acc = sm_l + kWarps * GM;               // [kWarps][GM][HD]

  const int hk = blockIdx.x, b = blockIdx.y, g0 = blockIdx.z * GM;
  const int Hq = Hkv * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool holds = lane < LANES;

  float qv[GM][VPL], acc[GM][VPL], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNeg;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < VPL; ++e) {
      qv[g][e] = 0.0f;
      acc[g][e] = 0.0f;
    }
    if (g0 + g < G && holds) {
      load_row<T, VPL>(
          q + (static_cast<int64_t>(b) * Hq + hk * G + g0 + g) * HD +
              lane * VPL,
          qv[g]);
    }
  }

  const int64_t row = static_cast<int64_t>(Hkv) * HD;
  const int64_t col = holds ? lane * VPL : 0;
  const T* kb = k + (static_cast<int64_t>(b) * S * Hkv + hk) * HD + col;
  const T* vb = v + (static_cast<int64_t>(b) * S * Hkv + hk) * HD + col;

  for (int base = lo + warp * U; base <= hi; base += kWarps * U) {
    float kf[U][VPL], vf[U][VPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u <= hi && holds) {
        load_row<T, VPL>(kb + (base + u) * row, kf[u]);
        load_row<T, VPL>(vb + (base + u) * row, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VPL; ++e) kf[u][e] = vf[u][e] = 0.0f;
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = 0.0f;
#pragma unroll
        for (int e = 0; e < VPL; ++e) part = fmaf(qv[g][e], kf[u][e], part);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s[u] = base + u <= hi ? part * scale : -INFINITY;
      }
      float mx = s[0];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[u]);
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      float p[U], ps = 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = expf(s[u] - m_new);
        ps += p[u];
      }
      l[g] = l[g] * alpha + ps;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < VPL; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(p[u], vf[u][e], a);
        acc[g][e] = a;
      }
    }
  }

  // combine the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (lane == 0) {
      sm_m[warp * GM + g] = m[g];
      sm_l[warp * GM + g] = l[g];
    }
    if (holds) {
#pragma unroll
      for (int e = 0; e < VPL; ++e)
        sm_acc[(warp * GM + g) * HD + lane * VPL + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < GM * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    if (g0 + g >= G) continue;
    float M = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w * GM + g]);
    float L = 0.0f, A = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w * GM + g] - M);
      L = fmaf(sm_l[w * GM + g], c, L);
      A = fmaf(sm_acc[(w * GM + g) * HD + d], c, A);
    }
    out[(static_cast<int64_t>(b) * Hq + hk * G + g0 + g) * HD + d] =
        from_f32<T>(A / (L == 0.0f ? 1.0f : L));
  }
}

template <typename T, int HD, int GM>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Hkv, int G, int lo, int hi, float scale,
                   int device, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * kWarps * GM * (HD + 2);
  static bool raised[64] = {};  // shared-memory limit raised, per device
  if (smem > 48 * 1024 && device >= 0 && device < 64 && !raised[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, HD, GM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  const dim3 grid(Hkv, B, (G + GM - 1) / GM);
  decode_kernel<T, HD, GM><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Hkv, G, lo, hi,
      scale);
  return cudaGetLastError();
}

// The smallest group size of {1, 2, 4, 8} that holds G (8 above that: the
// query heads of a kv head then take several blocks).
template <typename T, int HD>
cudaError_t launch_g(const void* q, const void* k, const void* v, void* out,
                     int B, int S, int Hkv, int G, int lo, int hi,
                     float scale, int device, cudaStream_t stream) {
  if (G <= 1)
    return launch<T, HD, 1>(q, k, v, out, B, S, Hkv, G, lo, hi, scale, device,
                            stream);
  if (G <= 2)
    return launch<T, HD, 2>(q, k, v, out, B, S, Hkv, G, lo, hi, scale, device,
                            stream);
  if (G <= 4)
    return launch<T, HD, 4>(q, k, v, out, B, S, Hkv, G, lo, hi, scale, device,
                            stream);
  return launch<T, HD, 8>(q, k, v, out, B, S, Hkv, G, lo, hi, scale, device,
                          stream);
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* out, int B, int S, int Hkv, int G, int lo, int hi,
                      float scale, int device, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch_g<T, 16>(q, k, v, out, B, S, Hkv, G, lo, hi, scale,
                             device, stream);
    case 32:
      return launch_g<T, 32>(q, k, v, out, B, S, Hkv, G, lo, hi, scale,
                             device, stream);
    case 64:
      return launch_g<T, 64>(q, k, v, out, B, S, Hkv, G, lo, hi, scale,
                             device, stream);
    case 128:
      return launch_g<T, 128>(q, k, v, out, B, S, Hkv, G, lo, hi, scale,
                              device, stream);
    case 256:
      return launch_g<T, 256>(q, k, v, out, B, S, Hkv, G, lo, hi, scale,
                              device, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B,Hq,hd], k/v [B,S,Hkv,hd], out [B,Hq,hd], all contiguous and of one
// dtype: 0 = float32, 1 = bfloat16.  hd is 16, 32, 64, 128 or 256.  Slots
// lo..hi
// (inclusive) are the kept ones; hi < lo keeps none and writes zeros.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* out, int B, int S, int Hkv, int G, int hd,
                            int lo, int hi, float scale, int dtype,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || Hkv <= 0 || G <= 0 || lo < 0 || hi >= S ||
      B > 65535 || (G + 7) / 8 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch_hd<float>(hd, q, k, v, out, B, S, Hkv, G, lo, hi, scale,
                           device, s);
  } else if (dtype == 1) {
    err = launch_hd<__nv_bfloat16>(hd, q, k, v, out, B, S, Hkv, G, lo, hi,
                                   scale, device, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
