// Flash attention forward (GQA, causal and optional sliding window),
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention.  Semantics are the Pallas kernel's: q, k and v are read
// in their dtype (float32 or bfloat16) and upcast to f32; s = q·kᵀ·scale in
// f32 with scale = 1/√hd; positions count from 0 for q and for k; a key is
// kept where (!causal || qpos >= kpos) && (window <= 0 || qpos - kpos <
// window), else its score is NEG = -1e30; the softmax is online, with the
// running max, the running sum and the accumulator in f32; the output is
// acc / (l == 0 ? 1 : l), written in q's dtype.  Query head h reads kv head
// h / G, G = Hq / Hkv.
//
// What bounds it on this card: at the serving path's shape (B = 4, S = 512,
// Hq = 16, hd = 128, causal, bf16) the work is 4.3 GFLOP over 25 MB, 170
// flops a byte, so the tensor cores' rate would bound it.  This first
// version does its products on the f32 CUDA cores (67 TFLOP/s), exactly as
// the f32 semantics state them, and is bound by those and by shared-memory
// bandwidth.  The design keeps the TPU kernel's structure where it fits the
// card and changes the rest:
//
// * The TPU grid walks the key tiles in order as its last, sequential axis
//   and keeps m, l and acc in VMEM scratch between grid steps.  Blocks of a
//   CUDA grid run in no order, so one block owns a tile of 64 q rows of one
//   head and loops over the key tiles itself, keeping m, l and acc in
//   registers.  Key tiles wholly above the causal diagonal or wholly
//   outside the window are skipped (the TPU kernel streams them masked);
//   the result is the same, since a masked score contributes exp(NEG - m)
//   = 0 once a row has seen a kept key, and every row's own key is kept.
// * The TPU pads nothing and asserts S % 128 == 0.  Here the ragged edge is
//   masked: q rows >= Sq are computed and not written, key slots >= Sk are
//   zero-filled in shared memory and score -inf (not NEG), so they never
//   count, even in a tile whose kept keys are all masked.
// * 256 threads in a 16 x 16 grid: thread (rg, kg) owns q rows rg + 16i
//   (i < 4) and, for the scores, keys kg + 16j (j < 4): a 4 x 4 register
//   tile, so each shared-memory read feeds 4 multiply-adds.  For P·V it
//   owns columns kg + 16j of its 4 rows.  The 16 threads of a row are 16
//   neighbouring lanes, so row max and row sum are 4 shuffles.
// * Shared memory holds the q tile in f32, the K and V tiles in their input
//   dtype and the tile of probabilities P.  Rows are padded by 4 bytes so
//   that the 16 key rows read at once fall in 16 banks.  At hd = 256 in f32
//   that is 213 KB, above the 48 KB of static shared memory, so the launch
//   asks for it as dynamic shared memory and checks cudaGetLastError().
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

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 key groups
constexpr int kPS = kBK + 16;  // row stride of P: the two half-warps' rows
                               // fall 16 banks apart
constexpr float kNeg = -1e30f;

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
  return __float2bfloat16(x);
}

// Row stride of the K and V tiles, in elements: hd plus 4 bytes.
template <typename T, int HD>
struct Tile {
  static constexpr int kPad = 4 / sizeof(T);
  static constexpr int kStride = HD + kPad;
  static constexpr int kWords = HD * sizeof(T) / 4;        // per global row
  static constexpr int kStrideWords = kStride * sizeof(T) / 4;
  static constexpr size_t kSmem = sizeof(float) * kBQ * (HD + 1) +
                                  2 * sizeof(T) * kBK * kStride +
                                  sizeof(float) * kBQ * kPS;
};

// Copy rows [k0, k0 + kBK) of one kv head into a padded shared tile, as
// 4-byte words (neighbouring threads on neighbouring words); rows >= Sk
// are zero-filled.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(uint32_t* dst, const T* src,
                                          int64_t row_stride, int k0, int Sk) {
  using TL = Tile<T, HD>;
  for (int i = threadIdx.x; i < kBK * TL::kWords; i += kThreads) {
    const int r = i / TL::kWords, w = i % TL::kWords;
    uint32_t val = 0;
    if (k0 + r < Sk) {
      val = reinterpret_cast<const uint32_t*>(src + (k0 + r) * row_stride)[w];
    }
    dst[r * TL::kStrideWords + w] = val;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
             int Hq, int Hkv, int causal, int window, float scale) {
  using TL = Tile<T, HD>;
  constexpr int kCols = HD / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  T* Ks = reinterpret_cast<T*>(Qs + kBQ * (HD + 1));
  T* Vs = Ks + kBK * TL::kStride;
  float* Ps = reinterpret_cast<float*>(Vs + kBK * TL::kStride);

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int rg = tid >> 4, kg = tid & 15;

  // q tile -> f32 in shared memory; rows >= Sq read as 0
  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float x = 0.0f;
    if (q0 + r < Sq) {
      x = to_f32(q[((static_cast<int64_t>(b) * Sq + q0 + r) * Hq + h) * HD +
                   d]);
    }
    Qs[r * (HD + 1) + d] = x;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }

  // key tiles that hold a kept key for some row of this q tile
  int kt_end = (Sk + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, (q0 + kBQ - 1) / kBK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBK;

  const int64_t kv_row = static_cast<int64_t>(Hkv) * HD;
  const T* kbase = k + (static_cast<int64_t>(b) * Sk * Hkv + hk) * HD;
  const T* vbase = v + (static_cast<int64_t>(b) * Sk * Hkv + hk) * HD;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    load_tile<T, HD>(reinterpret_cast<uint32_t*>(Ks), kbase, kv_row, k0, Sk);
    load_tile<T, HD>(reinterpret_cast<uint32_t*>(Vs), vbase, kv_row, k0, Sk);
    __syncthreads();

    // scores: a 4 x 4 register tile per thread
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = to_f32(Ks[(kg + 16 * j) * TL::kStride + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + kg + 16 * j;
        float x;
        if (kpos >= Sk) {
          x = -INFINITY;  // padding, not a key
        } else {
          const bool keep = (!causal || qpos >= kpos) &&
                            (window <= 0 || qpos - kpos < window);
          x = keep ? s[i][j] * scale : kNeg;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(rg + 16 * i) * kPS + kg + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P · V
    const int kn = min(kBK, Sk - k0);
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(rg + 16 * i) * kPS + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = to_f32(Vs[kk * TL::kStride + kg + 16 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
    __syncthreads();  // K, V and P are overwritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= Sq) continue;
    const float denom = l[i] == 0.0f ? 1.0f : l[i];
    T* o = out + ((static_cast<int64_t>(b) * Sq + row) * Hq + h) * HD;
#pragma unroll
    for (int j = 0; j < kCols; ++j) o[kg + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                   int window, float scale, int device, cudaStream_t stream) {
  constexpr size_t smem = Tile<T, HD>::kSmem;
  static bool raised[64] = {};  // shared-memory limit raised, per device
  if (smem > 48 * 1024 && device >= 0 && device < 64 && !raised[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, Hq, Hkv, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                      int causal, int window, float scale, int device,
                      cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window,
                           scale, device, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window,
                           scale, device, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window,
                           scale, device, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window,
                            scale, device, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window,
                            scale, device, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B,Sq,Hq,hd], k/v [B,Sk,Hkv,hd], out [B,Sq,Hq,hd], all contiguous and
// of one dtype: 0 = float32, 1 = bfloat16.  hd is 16, 32, 64, 128 or 256.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                           int hd, int causal, int window, float scale,
                           int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Sq > 65535 * kBQ || Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch_hd<float>(hd, q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                           window, scale, device, s);
  } else if (dtype == 1) {
    err = launch_hd<__nv_bfloat16>(hd, q, k, v, out, B, Sq, Sk, Hq, Hkv,
                                   causal, window, scale, device, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
