// Backward of the flash-attention forward, hand-written for Hopper (sm_90a).
//
// The TPU kernel repro/kernels/flash_attention.py::flash_attention has no
// backward of its own: JAX differentiates the plain path.  This kernel
// computes that gradient for the port's forward (csrc/flash_attention.cu):
// given q [B,Sq,Hq,hd], k and v [B,Sk,Hkv,hd], the forward's output o and
// its cotangent dO (one dtype, float32 or bfloat16), it writes dQ, dK and
// dV in that dtype.  The mask is the forward's: query row i sees key j when
// j <= i (causal) and i - j < window (window > 0), positions counted from
// 0 for both q and k; query head h reads kv head h / (Hq / Hkv).  Its
// plain twin is kernels/ref.py::flash_attention_bwd.
//
// What bounds it on this card: at qwen3's (4, 512, 16, 8, 128) bf16
// causal, 50.3 MB move (q, k, v, o, dO read once, dQ, dK, dV written
// once) against about 10.7 GFLOP, so bytes (0.0150 ms at 3.35 TB/s).
//
// The work, in two launches and without atomics, for either dtype:
//
// * a dQ kernel, a block per (query tile, query head, batch): D =
//   rowsum(dO∘O) (a fixed group of lanes a row, xor butterfly); the row
//   max and sum over the key tiles the mask keeps (online, in f32, the
//   scores recomputed from q and k: the forward's statistics are not
//   saved, so its kernel stays as it was), LSE = max + log(sum); then the
//   key tiles again: P = exp(s − LSE), dP = dO·Vᵀ, dS = P∘(dP − D), dQ +=
//   dS·K.  LSE and D go to a [B,Hq,Sq] float32 scratch for
// * a dK/dV kernel, a block per (key tile, kv head, batch): for each of
//   the G query heads of its group in order, and each query tile the mask
//   keeps in order, the same P and dS, dV += Pᵀ·dO and dK += dSᵀ·Q.  The G
//   heads' contributions are summed inside the block in a fixed order,
//   where a block per query head would need a cross-block sum.
//
// bfloat16 (namespace tc, the training path): the five products run on the
// tensor cores (wmma 16x16x16, f32 accumulators), q, k, v and dO tiles of
// 64 rows in shared memory as they are in memory (16-byte loads, rows
// padded by 16 bytes), the [64, 64] scores stored from the accumulators to
// shared memory for the elementwise stage (4 threads a row).  P and dS
// enter their products as a bf16 pair hi + lo (two products, the pair
// keeping about 16 bits), so the gradients keep the f32 arithmetic's
// accuracy where a single bf16 rounding of P and dS would not hold the
// plain twin's 2e-2.  Transposed operands (Pᵀ, dSᵀ, Kᵀ) are read by
// col-major fragment loads, so no tile is stored twice.
//
// float32: the same passes on the CUDA cores from float32 tiles with rows
// padded to hd + 1 words (both row- and column-wise reads free of bank
// conflicts); BT is 64 rows up to hd 128 and 32 at hd 256, a thread owns 4
// rows of a tile (ty) and every TX-th column (tx).  Scores are accumulated
// with fmaf in d order in both kernels, so both see the same P.
//
// Every sum runs in one fixed order (the tiles and their rows ascending,
// the products of a tensor-core block in one sequence), so two launches
// give the same bits.  expf and logf are IEEE (no --use_fast_math).
//
// C interface, loaded with ctypes: the launcher returns the cudaError_t of
// its launches (0 on success) and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Shape {
  int B, Sq, Sk, Hq, Hkv, causal, window;
  float scale;
};

__device__ __forceinline__ bool keep(int qp, int kp, const Shape& s) {
  if (qp >= s.Sq || kp >= s.Sk) return false;
  if (s.causal && kp > qp) return false;
  if (s.window > 0 && qp - kp >= s.window) return false;
  return true;
}

// The tile geometry of a (hd, BT) instantiation.
template <int HD, int BT>
struct Geo {
  static constexpr int TY = BT / 4;            // row groups of 4 rows
  static constexpr int TX = kThreads / TY;     // threads along a row
  static constexpr int NC = BT / TX;           // a thread's tile columns
  static constexpr int ND = HD / TX;           // a thread's head_dim columns
  static constexpr int LD = HD + 1;            // padded row of a [BT, hd]
  static constexpr int LP = BT + 1;            // padded row of a [BT, BT]
  static_assert(TX <= 32 && 32 % TX == 0, "a row's threads share a warp");
  static_assert(NC >= 1 && ND >= 1, "tile too narrow for the thread grid");
};

// Rows [r0, r0 + BT) of head h of a [B, S, H, HD] tensor into shared memory
// as float32 [BT][HD + 1]; zero past S.
template <int HD, int BT>
__device__ void load_tile(float* dst, const float* src, int b, int r0, int S,
                          int H, int h) {
  for (int idx = threadIdx.x; idx < BT * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD, row = r0 + r;
    float v = 0.f;
    if (row < S) v = src[((static_cast<int64_t>(b) * S + row) * H + h) * HD
                         + d];
    dst[r * (HD + 1) + d] = v;
  }
}

// out[r][c] = Σ_d A[ty·4 + r][d] · B[tx + TX·c][d], d ascending (fmaf).
template <int HD, int BT>
__device__ __forceinline__ void tile_dots(const float* A, const float* Bm,
                                          int ty, int tx,
                                          float (&out)[4][Geo<HD, BT>::NC]) {
  using G = Geo<HD, BT>;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < G::NC; ++c) out[r][c] = 0.f;
  const float* a0 = A + (ty * 4) * G::LD;
  const float* b0 = Bm + tx * G::LD;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[4], bv[G::NC];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = a0[r * G::LD + d];
#pragma unroll
    for (int c = 0; c < G::NC; ++c) bv[c] = b0[c * G::TX * G::LD + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < G::NC; ++c) out[r][c] = fmaf(a[r], bv[c], out[r][c]);
  }
}

// acc[r][c] += Σ_j W[ty·4 + r][j] · M[j][tx + TX·c], j ascending.
template <int HD, int BT>
__device__ __forceinline__ void tile_accumulate(
    const float* W, const float* M, int ty, int tx,
    float (&acc)[4][Geo<HD, BT>::ND]) {
  using G = Geo<HD, BT>;
  const float* w0 = W + (ty * 4) * G::LP;
#pragma unroll 2
  for (int j = 0; j < BT; ++j) {
    float w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) w[r] = w0[r * G::LP + j];
    const float* m = M + j * G::LD + tx;
#pragma unroll
    for (int c = 0; c < G::ND; ++c) {
      const float x = m[c * G::TX];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(w[r], x, acc[r][c]);
    }
  }
}

template <int TX>
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < TX; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int TX>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < TX; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD, int BT>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ o,
                        const float* __restrict__ dO, float* __restrict__ dq,
                        float* __restrict__ lse_g, float* __restrict__ d_g,
                        Shape s) {
  using Gm = Geo<HD, BT>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BT * Gm::LD;
  float* Ks = dOs + BT * Gm::LD;
  float* Vs = Ks + BT * Gm::LD;
  float* dSs = Vs + BT * Gm::LD;
  float* lse_s = dSs + BT * Gm::LP;
  float* D_s = lse_s + BT;

  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (s.Hq / s.Hkv);
  const int t = threadIdx.x, ty = t / Gm::TX, tx = t % Gm::TX;
  const int64_t row_base = static_cast<int64_t>(b) * s.Hq + h;

  load_tile<HD, BT>(Qs, q, b, q0, s.Sq, s.Hq, h);
  load_tile<HD, BT>(dOs, dO, b, q0, s.Sq, s.Hq, h);
  {  // D = rowsum(dO∘O): TPR consecutive lanes a row
    constexpr int TPR = kThreads / BT;
    const int r = t / TPR, l = t % TPR, row = q0 + r;
    float acc = 0.f;
    if (row < s.Sq) {
      const int64_t off =
          ((static_cast<int64_t>(b) * s.Sq + row) * s.Hq + h) * HD;
      for (int d = l; d < HD; d += TPR)
        acc = fmaf(dO[off + d], o[off + d], acc);
    }
#pragma unroll
    for (int w = 1; w < TPR; w <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (l == 0) {
      D_s[r] = acc;
      if (row < s.Sq) d_g[row_base * s.Sq + row] = acc;
    }
  }

  // the key tiles this query tile's rows can see
  const int k_lo = s.window > 0 ? max(0, q0 - s.window + 1) : 0;
  const int k_hi = s.causal ? min(s.Sk, q0 + BT) : s.Sk;
  const int kt_lo = k_lo / BT * BT;

  // pass 1: each row's max and sum of exp over the kept keys
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  for (int k0 = kt_lo; k0 < k_hi; k0 += BT) {
    __syncthreads();
    load_tile<HD, BT>(Ks, k, b, k0, s.Sk, s.Hkv, hk);
    __syncthreads();
    float sc[4][Gm::NC];
    tile_dots<HD, BT>(Qs, Ks, ty, tx, sc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + ty * 4 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < Gm::NC; ++c) {
        const bool ok = keep(qp, k0 + tx + Gm::TX * c, s);
        sc[r][c] = ok ? sc[r][c] * s.scale : -INFINITY;
        mx = fmaxf(mx, sc[r][c]);
      }
      const float mn = fmaxf(m[r], row_max<Gm::TX>(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < Gm::NC; ++c)
        sum += sc[r][c] == -INFINITY ? 0.f : expf(sc[r][c] - mn);
      sum = row_sum<Gm::TX>(sum);
      const float alpha = m[r] == -INFINITY ? 0.f : expf(m[r] - mn);
      l[r] = l[r] * alpha + sum;
      m[r] = mn;
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty * 4 + r, row = q0 + i;
    // a row that sees no key (past Sq) gets +inf: every P of it is 0
    const float lse = l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
    if (tx == 0) {
      lse_s[i] = lse;
      if (row < s.Sq) lse_g[row_base * s.Sq + row] = lse;
    }
  }

  // pass 2: dQ = scale · Σ_j dS[i][j] K[j]
  float acc[4][Gm::ND];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < Gm::ND; ++c) acc[r][c] = 0.f;
  for (int k0 = kt_lo; k0 < k_hi; k0 += BT) {
    __syncthreads();
    load_tile<HD, BT>(Ks, k, b, k0, s.Sk, s.Hkv, hk);
    load_tile<HD, BT>(Vs, v, b, k0, s.Sk, s.Hkv, hk);
    __syncthreads();
    float sc[4][Gm::NC], dp[4][Gm::NC];
    tile_dots<HD, BT>(Qs, Ks, ty, tx, sc);
    tile_dots<HD, BT>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty * 4 + r;
#pragma unroll
      for (int c = 0; c < Gm::NC; ++c) {
        const int j = tx + Gm::TX * c;
        const bool ok = keep(q0 + i, k0 + j, s);
        const float p = ok ? expf(sc[r][c] * s.scale - lse_s[i]) : 0.f;
        dSs[i * Gm::LP + j] = ok ? p * (dp[r][c] - D_s[i]) : 0.f;
      }
    }
    __syncthreads();
    tile_accumulate<HD, BT>(dSs, Ks, ty, tx, acc);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= s.Sq) continue;
    float* out = dq + ((static_cast<int64_t>(b) * s.Sq + row) * s.Hq + h) * HD;
#pragma unroll
    for (int c = 0; c < Gm::ND; ++c)
      out[tx + Gm::TX * c] = acc[r][c] * s.scale;
  }
}

template <int HD, int BT>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dO,
                          const float* __restrict__ lse_g,
                          const float* __restrict__ d_g,
                          float* __restrict__ dk, float* __restrict__ dv,
                          Shape s) {
  using Gm = Geo<HD, BT>;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * Gm::LD;
  float* Qs = Vs + BT * Gm::LD;
  float* dOs = Qs + BT * Gm::LD;
  float* Ps = dOs + BT * Gm::LD;
  float* dSs = Ps + BT * Gm::LP;
  float* lse_s = dSs + BT * Gm::LP;
  float* D_s = lse_s + BT;

  const int k0 = blockIdx.x * BT, hk = blockIdx.y, b = blockIdx.z;
  const int G = s.Hq / s.Hkv;
  const int t = threadIdx.x, ty = t / Gm::TX, tx = t % Gm::TX;

  load_tile<HD, BT>(Ks, k, b, k0, s.Sk, s.Hkv, hk);
  load_tile<HD, BT>(Vs, v, b, k0, s.Sk, s.Hkv, hk);

  // the query tiles whose rows can see this key tile
  const int q_lo = s.causal ? k0 : 0;
  const int q_hi = s.window > 0 ? min(s.Sq, k0 + BT - 1 + s.window) : s.Sq;
  const int qt_lo = q_lo / BT * BT;

  float dk_acc[4][Gm::ND], dv_acc[4][Gm::ND];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < Gm::ND; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const int64_t row_base = static_cast<int64_t>(b) * s.Hq + h;
    for (int q0 = qt_lo; q0 < q_hi; q0 += BT) {
      __syncthreads();
      load_tile<HD, BT>(Qs, q, b, q0, s.Sq, s.Hq, h);
      load_tile<HD, BT>(dOs, dO, b, q0, s.Sq, s.Hq, h);
      for (int i = t; i < BT; i += kThreads) {
        const int row = q0 + i;
        lse_s[i] = row < s.Sq ? lse_g[row_base * s.Sq + row] : INFINITY;
        D_s[i] = row < s.Sq ? d_g[row_base * s.Sq + row] : 0.f;
      }
      __syncthreads();
      // transposed tiles: rows are keys j = ty·4 + r, columns queries i
      float st[4][Gm::NC], dpt[4][Gm::NC];
      tile_dots<HD, BT>(Ks, Qs, ty, tx, st);
      tile_dots<HD, BT>(Vs, dOs, ty, tx, dpt);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = ty * 4 + r;
#pragma unroll
        for (int c = 0; c < Gm::NC; ++c) {
          const int i = tx + Gm::TX * c;
          const bool ok = keep(q0 + i, k0 + j, s);
          const float p = ok ? expf(st[r][c] * s.scale - lse_s[i]) : 0.f;
          Ps[j * Gm::LP + i] = p;
          dSs[j * Gm::LP + i] = ok ? p * (dpt[r][c] - D_s[i]) : 0.f;
        }
      }
      __syncthreads();
      tile_accumulate<HD, BT>(Ps, dOs, ty, tx, dv_acc);
      tile_accumulate<HD, BT>(dSs, Qs, ty, tx, dk_acc);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = k0 + ty * 4 + r;
    if (row >= s.Sk) continue;
    const int64_t off =
        ((static_cast<int64_t>(b) * s.Sk + row) * s.Hkv + hk) * HD;
#pragma unroll
    for (int c = 0; c < Gm::ND; ++c) {
      dk[off + tx + Gm::TX * c] = dk_acc[r][c] * s.scale;
      dv[off + tx + Gm::TX * c] = dv_acc[r][c];
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dO, void* dq, void* dk,
                   void* dv, void* lse, void* dvec, const Shape& s,
                   cudaStream_t stream) {
  constexpr int BT = HD <= 128 ? 64 : 32;
  using Gm = Geo<HD, BT>;
  const int dq_smem = (4 * BT * Gm::LD + BT * Gm::LP + 2 * BT) * 4;
  const int kv_smem = (4 * BT * Gm::LD + 2 * BT * Gm::LP + 2 * BT) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD, BT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD, BT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_smem);
  if (err != cudaSuccess) return err;
  const dim3 gq((s.Sq + BT - 1) / BT, s.Hq, s.B);
  flash_bwd_dq_kernel<HD, BT><<<gq, kThreads, dq_smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dO), static_cast<float*>(dq),
      static_cast<float*>(lse), static_cast<float*>(dvec), s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gk((s.Sk + BT - 1) / BT, s.Hkv, s.B);
  flash_bwd_dkdv_kernel<HD, BT><<<gk, kThreads, kv_smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<float*>(dk), static_cast<float*>(dv), s);
  return cudaGetLastError();
}

cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     const void* o, const void* dO, void* dq, void* dk,
                     void* dv, void* lse, void* dvec, const Shape& s,
                     cudaStream_t stream) {
#define BWD_ARGS q, k, v, o, dO, dq, dk, dv, lse, dvec, s, stream
  switch (hd) {
    case 16: return launch<16>(BWD_ARGS);
    case 32: return launch<32>(BWD_ARGS);
    case 64: return launch<64>(BWD_ARGS);
    case 128: return launch<128>(BWD_ARGS);
    case 256: return launch<256>(BWD_ARGS);
  }
#undef BWD_ARGS
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bfloat16: the five products on the tensor cores (wmma 16x16x16, f32
// accumulators)
// ---------------------------------------------------------------------------

namespace tc {

namespace wmma = nvcuda::wmma;
using bf = __nv_bfloat16;
constexpr int kWarps = 8, kThr = 32 * kWarps;
constexpr int BT = 64;            // query and key rows of a tile
constexpr int LS = BT + 4;        // row of a float32 [BT, BT] score tile
constexpr int LP = BT + 8;        // row of a bf16 [BT, BT] P or dS tile
constexpr int NB = BT / 16;       // 16-row blocks of a tile

template <int HD>
struct Geo {
  static constexpr int LD = HD + 8;            // row of a bf16 [BT, hd] tile
  static constexpr int LO = HD + 4;            // row of a f32 [BT, hd] stage
  static constexpr int NF = NB * (HD / 16);    // 16x16 blocks of [BT, hd]
  static constexpr int FW = (NF + kWarps - 1) / kWarps;  // a warp's blocks
  static constexpr int TILE = BT * LD;         // bf16 elements of a tile
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf, wmma::col_major> FragAt;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf, wmma::col_major> FragBt;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Rows [r0, r0 + BT) of head h of a [B, S, H, HD] bf16 tensor into shared
// memory [BT][LD], 16 bytes a load; zero past S.
template <int HD>
__device__ void load_tile(bf* dst, const bf* src, int b, int r0, int S,
                          int H, int h) {
  constexpr int V = HD / 8;
  for (int idx = threadIdx.x; idx < BT * V; idx += kThr) {
    const int r = idx / V, c = idx % V, row = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S)
      val = *reinterpret_cast<const uint4*>(
          src + ((static_cast<int64_t>(b) * S + row) * H + h) * HD + c * 8);
    *reinterpret_cast<uint4*>(dst + r * Geo<HD>::LD + c * 8) = val;
  }
}

// out[BT][LS] (f32, rows of A, columns the rows of Bm) = A · Bmᵀ over hd;
// warp w takes row block w / 2 and column blocks 2·(w % 2) + {0, 1}.
template <int HD>
__device__ void scores(const bf* A, const bf* Bm, float* out, int warp) {
  constexpr int LD = Geo<HD>::LD;
  const int rb = warp >> 1, cb = (warp & 1) * 2;
  FragC c[2];
  wmma::fill_fragment(c[0], 0.f);
  wmma::fill_fragment(c[1], 0.f);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    FragA a;
    wmma::load_matrix_sync(a, A + rb * 16 * LD + kk * 16, LD);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      FragBt bt;      // element (d, key) at Bm[key][d]
      wmma::load_matrix_sync(bt, Bm + (cb + j) * 16 * LD + kk * 16, LD);
      wmma::mma_sync(c[j], a, bt, c[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(out + rb * 16 * LS + (cb + j) * 16, c[j], LS,
                            wmma::mem_row_major);
}

// acc[f] += W · M for the warp's [16, 16] blocks f of a [BT, hd] output:
// W [BT, BT] bf16 as hi + lo (two products, so W keeps about 16 bits),
// M [BT, hd] bf16.  Transposed: W is read as Wᵀ (its rows are the inner
// dimension).
template <int HD, bool TRANS>
__device__ void accumulate(FragC (&acc)[Geo<HD>::FW], const bf* Wh,
                           const bf* Wl, const bf* M, int warp) {
  using G = Geo<HD>;
#pragma unroll
  for (int i = 0; i < G::FW; ++i) {
    const int f = warp + kWarps * i;
    if (f >= G::NF) break;
    const int rb = f / (HD / 16), cb = f % (HD / 16);
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      FragB m;        // element (inner, d) at M[inner][d]
      wmma::load_matrix_sync(m, M + kk * 16 * G::LD + cb * 16, G::LD);
      if (TRANS) {    // element (row, inner) at W[inner][row]
        FragAt h, l;
        wmma::load_matrix_sync(h, Wh + kk * 16 * LP + rb * 16, LP);
        wmma::load_matrix_sync(l, Wl + kk * 16 * LP + rb * 16, LP);
        wmma::mma_sync(acc[i], h, m, acc[i]);
        wmma::mma_sync(acc[i], l, m, acc[i]);
      } else {
        FragA h, l;
        wmma::load_matrix_sync(h, Wh + rb * 16 * LP + kk * 16, LP);
        wmma::load_matrix_sync(l, Wl + rb * 16 * LP + kk * 16, LP);
        wmma::mma_sync(acc[i], h, m, acc[i]);
        wmma::mma_sync(acc[i], l, m, acc[i]);
      }
    }
  }
}

__device__ __forceinline__ void split(float x, bf* hi, bf* lo) {
  const bf h = __float2bfloat16(x);
  *hi = h;
  *lo = __float2bfloat16(x - __bfloat162float(h));
}

// The warp's accumulator blocks, times ``factor``, to rows [r0, r0 + BT)
// of head h of a [B, S, H, HD] bf16 output, through a f32 stage.
template <int HD>
__device__ void write_out(FragC (&acc)[Geo<HD>::FW], float* stage, bf* out,
                          int b, int r0, int S, int H, int h, float factor,
                          int warp) {
  using G = Geo<HD>;
#pragma unroll
  for (int i = 0; i < G::FW; ++i) {
    const int f = warp + kWarps * i;
    if (f >= G::NF) break;
    const int rb = f / (HD / 16), cb = f % (HD / 16);
    wmma::store_matrix_sync(stage + rb * 16 * G::LO + cb * 16, acc[i], G::LO,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BT * HD; idx += kThr) {
    const int r = idx / HD, d = idx % HD, row = r0 + r;
    if (row < S)
      out[((static_cast<int64_t>(b) * S + row) * H + h) * HD + d] =
          __float2bfloat16(stage[r * G::LO + d] * factor);
  }
  __syncthreads();
}

// Element (row, col) of a [BT, BT] tile a thread takes in the elementwise
// stages: 4 threads a row, every 4th column (so a warp's reads of a row
// hit distinct banks).
constexpr int kRowThreads = kThr / BT;
constexpr int kCols = BT / kRowThreads;

template <int HD>
__global__ void __launch_bounds__(kThr)
    flash_bwd_dq_tc(const bf* __restrict__ q, const bf* __restrict__ k,
                    const bf* __restrict__ v, const bf* __restrict__ o,
                    const bf* __restrict__ dO, bf* __restrict__ dq,
                    float* __restrict__ lse_g, float* __restrict__ d_g,
                    Shape s) {
  using G = Geo<HD>;
  extern __shared__ __align__(128) unsigned char raw[];
  bf* Qs = reinterpret_cast<bf*>(raw);
  bf* dOs = Qs + G::TILE;
  bf* Ks = dOs + G::TILE;
  bf* Vs = Ks + G::TILE;
  float* Ss = reinterpret_cast<float*>(Vs + G::TILE);
  float* dPs = Ss + BT * LS;
  bf* dSh = reinterpret_cast<bf*>(dPs + BT * LS);
  bf* dSl = dSh + BT * LP;
  float* lse_s = reinterpret_cast<float*>(dSl + BT * LP);
  float* D_s = lse_s + BT;
  float* stage = reinterpret_cast<float*>(raw);   // the tiles, at the end

  // under the causal mask the last query tiles see the most keys: they go
  // first, so that the grid's tail is short
  const int qt = s.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (s.Hq / s.Hkv);
  const int t = threadIdx.x, warp = t / 32;
  const int row = t / kRowThreads, lane = t % kRowThreads, qp = q0 + row;
  const int64_t row_base = static_cast<int64_t>(b) * s.Hq + h;

  load_tile<HD>(Qs, q, b, q0, s.Sq, s.Hq, h);
  load_tile<HD>(dOs, dO, b, q0, s.Sq, s.Hq, h);
  {  // D = rowsum(dO∘O), the row's threads summing every 4th element
    float acc = 0.f;
    if (qp < s.Sq) {
      const int64_t off = ((static_cast<int64_t>(b) * s.Sq + qp) * s.Hq + h)
                          * HD;
      for (int d = lane; d < HD; d += kRowThreads)
        acc = fmaf(__bfloat162float(dO[off + d]), __bfloat162float(o[off + d]),
                   acc);
    }
#pragma unroll
    for (int w = 1; w < kRowThreads; w <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (lane == 0) {
      D_s[row] = acc;
      if (qp < s.Sq) d_g[row_base * s.Sq + qp] = acc;
    }
  }
  const int k_lo = s.window > 0 ? max(0, q0 - s.window + 1) : 0;
  const int k_hi = s.causal ? min(s.Sk, q0 + BT) : s.Sk;
  const int kt_lo = k_lo / BT * BT;

  // pass 1: the row's max and sum of exp over the kept keys
  float m = -INFINITY, l = 0.f;
  for (int k0 = kt_lo; k0 < k_hi; k0 += BT) {
    __syncthreads();
    load_tile<HD>(Ks, k, b, k0, s.Sk, s.Hkv, hk);
    __syncthreads();
    scores<HD>(Qs, Ks, Ss, warp);
    __syncthreads();
    float sc[kCols], mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + kRowThreads * c;
      const bool ok = keep(qp, k0 + col, s);
      sc[c] = ok ? Ss[row * LS + col] * s.scale : -INFINITY;
      mx = fmaxf(mx, sc[c]);
    }
#pragma unroll
    for (int w = 1; w < kRowThreads; w <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    const float mn = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      sum += sc[c] == -INFINITY ? 0.f : expf(sc[c] - mn);
#pragma unroll
    for (int w = 1; w < kRowThreads; w <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, w);
    l = l * (m == -INFINITY ? 0.f : expf(m - mn)) + sum;
    m = mn;
  }
  const float lse = l > 0.f ? m + logf(l) : INFINITY;
  if (lane == 0) {
    lse_s[row] = lse;
    if (qp < s.Sq) lse_g[row_base * s.Sq + qp] = lse;
  }

  // pass 2: dQ = scale · dS · K
  FragC acc[G::FW];
#pragma unroll
  for (int i = 0; i < G::FW; ++i) wmma::fill_fragment(acc[i], 0.f);
  for (int k0 = kt_lo; k0 < k_hi; k0 += BT) {
    __syncthreads();
    load_tile<HD>(Ks, k, b, k0, s.Sk, s.Hkv, hk);
    load_tile<HD>(Vs, v, b, k0, s.Sk, s.Hkv, hk);
    __syncthreads();
    scores<HD>(Qs, Ks, Ss, warp);
    scores<HD>(dOs, Vs, dPs, warp);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + kRowThreads * c;
      const bool ok = keep(qp, k0 + col, s);
      const float p = ok ? expf(Ss[row * LS + col] * s.scale - lse) : 0.f;
      const float ds = ok ? p * (dPs[row * LS + col] - D_s[row]) : 0.f;
      split(ds, dSh + row * LP + col, dSl + row * LP + col);
    }
    __syncthreads();
    accumulate<HD, false>(acc, dSh, dSl, Ks, warp);
  }
  __syncthreads();
  write_out<HD>(acc, stage, dq, b, q0, s.Sq, s.Hq, h, s.scale, warp);
}

template <int HD>
__global__ void __launch_bounds__(kThr)
    flash_bwd_dkdv_tc(const bf* __restrict__ q, const bf* __restrict__ k,
                      const bf* __restrict__ v, const bf* __restrict__ dO,
                      const float* __restrict__ lse_g,
                      const float* __restrict__ d_g, bf* __restrict__ dk,
                      bf* __restrict__ dv, Shape s) {
  using G = Geo<HD>;
  extern __shared__ __align__(128) unsigned char raw[];
  bf* Ks = reinterpret_cast<bf*>(raw);
  bf* Vs = Ks + G::TILE;
  bf* Qs = Vs + G::TILE;
  bf* dOs = Qs + G::TILE;
  float* Ss = reinterpret_cast<float*>(dOs + G::TILE);
  float* dPs = Ss + BT * LS;
  bf* Ph = reinterpret_cast<bf*>(dPs + BT * LS);
  bf* Pl = Ph + BT * LP;
  bf* dSh = Pl + BT * LP;
  bf* dSl = dSh + BT * LP;
  float* lse_s = reinterpret_cast<float*>(dSl + BT * LP);
  float* D_s = lse_s + BT;
  float* stage = reinterpret_cast<float*>(raw);

  const int k0 = blockIdx.x * BT, hk = blockIdx.y, b = blockIdx.z;
  const int G_ = s.Hq / s.Hkv;
  const int t = threadIdx.x, warp = t / 32;
  const int row = t / kRowThreads, lane = t % kRowThreads;

  load_tile<HD>(Ks, k, b, k0, s.Sk, s.Hkv, hk);
  load_tile<HD>(Vs, v, b, k0, s.Sk, s.Hkv, hk);
  const int q_lo = s.causal ? k0 : 0;
  const int q_hi = s.window > 0 ? min(s.Sq, k0 + BT - 1 + s.window) : s.Sq;
  const int qt_lo = q_lo / BT * BT;

  FragC dk_acc[G::FW], dv_acc[G::FW];
#pragma unroll
  for (int i = 0; i < G::FW; ++i) {
    wmma::fill_fragment(dk_acc[i], 0.f);
    wmma::fill_fragment(dv_acc[i], 0.f);
  }
  for (int g = 0; g < G_; ++g) {
    const int h = hk * G_ + g;
    const int64_t row_base = static_cast<int64_t>(b) * s.Hq + h;
    for (int q0 = qt_lo; q0 < q_hi; q0 += BT) {
      __syncthreads();
      load_tile<HD>(Qs, q, b, q0, s.Sq, s.Hq, h);
      load_tile<HD>(dOs, dO, b, q0, s.Sq, s.Hq, h);
      for (int i = t; i < BT; i += kThr) {
        const int qr = q0 + i;
        lse_s[i] = qr < s.Sq ? lse_g[row_base * s.Sq + qr] : INFINITY;
        D_s[i] = qr < s.Sq ? d_g[row_base * s.Sq + qr] : 0.f;
      }
      __syncthreads();
      scores<HD>(Qs, Ks, Ss, warp);       // rows queries, columns keys
      scores<HD>(dOs, Vs, dPs, warp);
      __syncthreads();
      const int qp = q0 + row;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + kRowThreads * c;
        const bool ok = keep(qp, k0 + col, s);
        const float p = ok ? expf(Ss[row * LS + col] * s.scale - lse_s[row])
                           : 0.f;
        const float ds = ok ? p * (dPs[row * LS + col] - D_s[row]) : 0.f;
        split(p, Ph + row * LP + col, Pl + row * LP + col);
        split(ds, dSh + row * LP + col, dSl + row * LP + col);
      }
      __syncthreads();
      accumulate<HD, true>(dv_acc, Ph, Pl, dOs, warp);
      accumulate<HD, true>(dk_acc, dSh, dSl, Qs, warp);
    }
  }
  __syncthreads();
  write_out<HD>(dv_acc, stage, dv, b, k0, s.Sk, s.Hkv, hk, 1.f, warp);
  write_out<HD>(dk_acc, stage, dk, b, k0, s.Sk, s.Hkv, hk, s.scale, warp);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dO, void* dq, void* dk,
                   void* dv, void* lse, void* dvec, const Shape& s,
                   cudaStream_t stream) {
  using G = Geo<HD>;
  const int scores_bytes = 2 * BT * LS * 4 + 2 * BT * 4;
  const int dq_smem = 4 * G::TILE * 2 + scores_bytes + 2 * BT * LP * 2;
  const int kv_smem = 4 * G::TILE * 2 + scores_bytes + 4 * BT * LP * 2;
  static_assert(BT * Geo<HD>::LO * 4 <= 4 * Geo<HD>::TILE * 2,
                "the output stage fits in the tiles");
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_tc<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_smem);
  if (err != cudaSuccess) return err;
  const dim3 gq((s.Sq + BT - 1) / BT, s.Hq, s.B);
  flash_bwd_dq_tc<HD><<<gq, kThr, dq_smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(o),
      static_cast<const bf*>(dO), static_cast<bf*>(dq),
      static_cast<float*>(lse), static_cast<float*>(dvec), s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gk((s.Sk + BT - 1) / BT, s.Hkv, s.B);
  flash_bwd_dkdv_tc<HD><<<gk, kThr, kv_smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<bf*>(dk), static_cast<bf*>(dv), s);
  return cudaGetLastError();
}

cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     const void* o, const void* dO, void* dq, void* dk,
                     void* dv, void* lse, void* dvec, const Shape& s,
                     cudaStream_t stream) {
#define BWD_ARGS q, k, v, o, dO, dq, dk, dv, lse, dvec, s, stream
  // qualified: Shape's namespace would bring the float32 launch in by ADL
  switch (hd) {
    case 16: return tc::launch<16>(BWD_ARGS);
    case 32: return tc::launch<32>(BWD_ARGS);
    case 64: return tc::launch<64>(BWD_ARGS);
    case 128: return tc::launch<128>(BWD_ARGS);
    case 256: return tc::launch<256>(BWD_ARGS);
  }
#undef BWD_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

extern "C" {

// q, o, dO, dq [B,Sq,Hq,hd]; k, v, dk, dv [B,Sk,Hkv,hd], all contiguous and
// of one dtype: 0 = float32, 1 = bfloat16.  lse and dvec are float32
// scratch of B·Hq·Sq each (the rows' log-sum-exp and rowsum(dO∘O)).  hd
// is 16, 32, 64, 128 or 256.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dO, void* dq,
                               void* dk, void* dv, void* lse, void* dvec,
                               int B, int Sq, int Sk, int Hq, int Hkv, int hd,
                               int causal, int window, float scale,
                               int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{B, Sq, Sk, Hq, Hkv, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch(hd, q, k, v, o, dO, dq, dk, dv, lse, dvec, s, st);
  else if (dtype == 1)
    err = tc::dispatch(hd, q, k, v, o, dO, dq, dk, dv, lse, dvec, s, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
