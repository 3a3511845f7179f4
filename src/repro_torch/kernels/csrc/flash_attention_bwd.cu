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
// The work, in two launches, for either dtype:
//
// * a dQ kernel, a block per (query tile, query head, batch): D =
//   rowsum(dO∘O) (a fixed group of lanes a row, xor butterfly); the row
//   max and sum over the key tiles the mask keeps (online, in f32, the
//   scores recomputed from q and k: the forward's statistics are not
//   saved, so its kernel stays as it was), LSE = max + log(sum); then the
//   key tiles again: P = exp(s − LSE), dP = dO·Vᵀ, dS = P∘(dP − D), dQ +=
//   dS·K.  LSE and D go to a float32 scratch for
// * a dK/dV kernel, a block per (key tile, kv head, batch): for each of
//   the G query heads of its group in order, and each query tile the mask
//   keeps in order, the same P and dS, dV += Pᵀ·dO and dK += dSᵀ·Q.  The G
//   heads' contributions are summed inside the block in a fixed order,
//   where a block per query head would need a cross-block sum.
//
// bfloat16 (namespace tc, the training path), redesigned for Hopper:
//
// * The dQ kernel: one warpgroup a block owns 64 query rows of one (batch,
//   head), the grid (Hq·B, query tiles) with the query tiles in reverse
//   under the causal mask, so that the tiles that see the most keys start
//   first.  Q and dO arrive once by TMA and stay; the key tiles stream
//   through a 2-stage ring on mbarriers, thread 0 refilling a stage as
//   soon as the warpgroup is done with it: first K alone (pass 1, the
//   LSE from S = Q·Kᵀ, online max and sum in f32), then K and V (pass 2:
//   S, dP = dO·Vᵀ, dS = P∘(dP − D) in the accumulator registers, dQ +=
//   dS·K).  S and dP are wgmma m64n64k16 with both operands K-major from
//   swizzled shared memory; dS·K is the register-A form, m64n{hd}k16,
//   with K MN-major (the forward's P·V).  D = rowsum(dO∘O) from 16-byte
//   loads.  LSE and D go to a [B, Hq, Sq rounded up to 64] f32 scratch
//   (the rows past Sq get LSE = +inf and D = 0).
// * The dK/dV kernel: a block per (key tile, kv head, batch, group of the
//   head split).  The G query heads of a kv head are cut into hs groups
//   (flash_attention_bwd.py::bwd_plan, from the shapes alone, so that the
//   grid covers about two waves of 132 SMs); the grid is (hs·Hkv·B, key
//   tiles), key tile 0 (the most query tiles under the causal mask)
//   first.  K and V arrive once by TMA; Q and dO tiles with their LSE and
//   D rows (a bulk copy of 256 bytes each) stream through a 2-stage ring
//   on mbarriers, over the group's heads and, for each, the query tiles
//   the mask keeps, in order.  Two warpgroups split the work by output.
//   The first computes Sᵀ = K·Qᵀ (rows keys), Pᵀ = exp(Sᵀ·scale − LSE),
//   hands P to the second through 16 KB of shared memory in the
//   fragment's order (two named barriers: P written, P read) and adds dV
//   += Pᵀ·dO; the second computes dPᵀ = V·dOᵀ, dSᵀ = Pᵀ∘(dPᵀ − D) and adds
//   dK += dSᵀ·Q.  Each holds one [64, hd] f32 accumulator, 128 registers
//   a thread at hd 256, within the 255 a 256-thread block allows (215 in
//   all at hd 256).  A stage is freed when all 256 threads have arrived
//   on its ``empty`` mbarrier; thread 0 of the second warpgroup, usually
//   the last to finish a tile, then refills it.  (A producer warpgroup
//   that hands its registers to the two by setmaxnreg measured slower at
//   every timed shape, and spilled at hd 256: ptxas kept the consumers
//   within the 168 registers a 384-thread block allows; PERF.md §6.)  With hs = 1 the block
//   writes dK and dV; otherwise each block writes its f32 partials to a
//   [2, hs, B, Sk, Hkv, hd] scratch, does a __threadfence() and adds one
//   to an int32 ticket of its (batch, kv head, key tile); the block that
//   draws the last ticket sums the hs partials in group order, writes bf16
//   and resets the ticket (decode_attention.cu's pattern: the integer
//   atomic decides only which block sums, never a sum).
// * P and dS enter their products as a bf16 pair hi + lo (two register-A
//   wgmmas, the pair keeping about 16 bits), so the gradients keep the f32
//   arithmetic's accuracy where a single bf16 rounding of P and dS would
//   not hold the plain twin's 2e-2.
// * Every mbarrier wait traps after 10 s (a launch error, not a hung card).
//
// float32: the same passes on the CUDA cores from float32 tiles with rows
// padded to hd + 1 words (both row- and column-wise reads free of bank
// conflicts); BT is 64 rows up to hd 128 and 32 at hd 256, a thread owns 4
// rows of a tile (ty) and every TX-th column (tx).  Scores are accumulated
// with fmaf in d order in both kernels, so both see the same P.
//
// Every sum runs in one fixed order (the tiles and their rows ascending,
// the products of a tensor-core block in one sequence, the head split's
// partials in group order), so two launches give the same bits; no float
// atomics.  expf and logf are IEEE (no --use_fast_math).
//
// C interface, loaded with ctypes: the launcher returns 0 on success, the
// cudaError_t of a failed launch or shared-memory request, or minus the
// CUresult of a failed tensor-map encoding; it never synchronises.  The
// library links libcuda for cuTensorMapEncodeTiled.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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
// bfloat16: the products on wgmma, the tiles by TMA (namespace tc)
// ---------------------------------------------------------------------------

namespace tc {

using bf = __nv_bfloat16;
constexpr int BT = 64;          // query and key rows of a tile
constexpr int kStages = 2;      // the TMA ring
constexpr int kWG = 128;        // threads of a warpgroup
constexpr int kDkdvThreads = 2 * kWG;  // the dV and dK warpgroups
// named barriers between the dK/dV kernel's two warpgroups
constexpr int kBarPFull = 1, kBarPFree = 2, kBarEpi = 3;

template <int HD>
struct Cfg {
  static constexpr int kBoxW = HD < 64 ? HD : 64;  // columns in a TMA box
  static constexpr int kRowB = 2 * kBoxW;          // bytes of a box row
  static constexpr int kBoxes = HD / kBoxW;
  // descriptor layout type matching the tensor map's swizzle: 1 = 128 B,
  // 2 = 64 B, 3 = 32 B
  static constexpr int kLayout = kRowB == 128 ? 1 : (kRowB == 64 ? 2 : 3);
  static constexpr int kBox = BT * kRowB;          // bytes of a box
  static constexpr int kTile = BT * HD * 2;        // bytes of a [64, hd] tile
  // dQ: Q and dO, then the ring of K and V; every tile on a 1024-byte
  // boundary (the 128-byte swizzle's period), the slack aligns the base
  static constexpr size_t kDqSmem = 1024 + 2 * kTile + kStages * 2 * kTile;
  // dK/dV: K and V, the ring of Q, dO and the tile's LSE and D rows, and
  // P [64, 64] f32 in the accumulator's fragment order
  static constexpr int kPBytes = BT * BT * 4;
  static constexpr int kRowsBytes = 2 * BT * 4;
  static constexpr size_t kDkdvSmem = 1024 + 2 * kTile +
                                      kStages * (2 * kTile + kRowsBytes) +
                                      kPBytes;
};

struct Plan {
  int hs, sq_pad;   // head split; rows of a (b, h) in the LSE and D scratch
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One box of a 4-d tensor map (coordinates innermost first) into shared
// memory, completing on the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ``bytes`` (a multiple of 16, both ends 16-byte aligned) of device memory
// into shared memory by the bulk-copy engine, completing on the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout type.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 64] (+)= A[64 x 16] · B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

// d[64 x N] += A[64 x 16] · B[16 x N], A in registers, B MN-major in
// shared memory (the transpose bit set); N = 16, 32, 64, 128, 256.
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Waits for the mbarrier's phase of the given parity.  A wait that lasts
// beyond 10 s of the global timer traps: a launch error the wrapper
// raises, where a fault in the ring would otherwise hang the card.
__device__ __forceinline__ void ring_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, spins = 0;
  uint64_t start = 0, now;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && (++spins & 1023u) == 0) {
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (start == 0) start = now;
      else if (now - start > 10000000000ull) __trap();
    }
  } while (!done);
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments (k16 steps kk, registers e) of a [64, 64] tile held as a
// wgmma accumulator fragment v, each value as a bf16 pair hi + lo: hi =
// bf16(x), lo = bf16(x − hi), so that the pair keeps about 16 bits.  The
// accumulator layout of m64n64 is the A-fragment layout of k16.
__device__ __forceinline__ void split_frag(const float (&v)[32],
                                           uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x0 = v[8 * kk + 2 * e], x1 = v[8 * kk + 2 * e + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][e] = bf2_bits(h);
      lo[kk][e] = bf2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
    }
}

// d = A · Bᵀ over hd: A and B [64, hd] tiles, K-major, at shared addresses
// sa and sb.  Between wgmma_fence and wgmma_commit.
template <int HD>
__device__ __forceinline__ void scores(float (&d)[32], uint32_t sa,
                                       uint32_t sb) {
  using C = Cfg<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int box = kk * 16 / C::kBoxW, col = (kk * 16) % C::kBoxW;
    const uint64_t da = make_desc(sa + box * C::kBox + 2 * col, 16,
                                  8 * C::kRowB, C::kLayout);
    const uint64_t db = make_desc(sb + box * C::kBox + 2 * col, 16,
                                  8 * C::kRowB, C::kLayout);
    wgmma_ss_n64(d, da, db, kk > 0);
  }
}

// acc[64, hd] += (hi + lo) · M over 64 rows: M a [64, hd] tile at shared
// address sm, MN-major (hd contiguous).  Between wgmma_fence and
// wgmma_commit.
template <int HD>
__device__ __forceinline__ void accumulate(float (&acc)[HD / 2],
                                           const uint32_t (&hi)[4][4],
                                           const uint32_t (&lo)[4][4],
                                           uint32_t sm) {
  using C = Cfg<HD>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = make_desc(sm + kk * 16 * C::kRowB, C::kBox,
                                  8 * C::kRowB, C::kLayout);
    wgmma_rs<HD>(acc, hi[kk], db);
    wgmma_rs<HD>(acc, lo[kk], db);
  }
}

// A (query tile, key tile) pair some of whose entries the mask drops.
__device__ __forceinline__ bool edge_tile(int q0, int k0, const Shape& s) {
  return q0 + BT > s.Sq || k0 + BT > s.Sk ||
         (s.causal && k0 + BT - 1 > q0) ||
         (s.window > 0 && q0 + BT - 1 - k0 >= s.window);
}

__device__ __forceinline__ float bf_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// dQ, with the rows' LSE and D.  One warpgroup a block owns a query tile of
// one (batch, head); Q and dO stay in shared memory.  Step j of the ring
// brings key tile j (pass 1, K only) or, from j = n on, the K and V of key
// tile j − n (pass 2).  Thread 0 issues every copy: a stage is refilled as
// soon as the warpgroup has finished with it.
template <int HD>
__global__ void __launch_bounds__(kWG, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const bf* __restrict__ o, const bf* __restrict__ dO,
                       bf* __restrict__ dq, float* __restrict__ lse_g,
                       float* __restrict__ d_g, Shape s, int sq_pad) {
  using C = Cfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kStages];  // Q and dO, the ring
  __shared__ float D_s[BT];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sdO = base + C::kTile;
  auto k_at = [&](int st) { return base + (2 + 2 * st) * C::kTile; };
  auto v_at = [&](int st) { return k_at(st) + C::kTile; };
  const uint32_t qbar = smem_u32(&bars[0]);
  auto full = [&](int st) { return smem_u32(&bars[1 + st]); };

  // under the causal mask the last query tiles see the most keys: they go
  // first, so that the grid's tail is short
  const int h = blockIdx.x % s.Hq, b = blockIdx.x / s.Hq;
  const int qt = s.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BT, hk = h / (s.Hq / s.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t rows_at = (static_cast<int64_t>(b) * s.Hq + h) * sq_pad + q0;

  // the key tiles that hold a kept key for some row of this query tile
  int kt_end = (s.Sk + BT - 1) / BT;
  if (s.causal) kt_end = min(kt_end, (q0 + BT - 1) / BT + 1);
  int kt_begin = 0;
  if (s.window > 0 && q0 - s.window + 1 > 0)
    kt_begin = (q0 - s.window + 1) / BT;
  const int n = max(0, kt_end - kt_begin);

  auto issue = [&](int j) {
    const int st = j % kStages;
    const bool both = j >= n;
    const int kt = kt_begin + (both ? j - n : j);
    mbar_expect_tx(full(st), (both ? 2 : 1) * C::kTile);
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c) {
      tma_load(k_at(st) + c * C::kBox, &tk, full(st), c * C::kBoxW, hk,
               kt * BT, b);
      if (both)
        tma_load(v_at(st) + c * C::kBox, &tv, full(st), c * C::kBoxW, hk,
                 kt * BT, b);
    }
  };
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < kStages; ++st) mbar_init(full(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, 2 * C::kTile);
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c) {
      tma_load(sQ + c * C::kBox, &tq, qbar, c * C::kBoxW, h, q0, b);
      tma_load(sdO + c * C::kBox, &tdo, qbar, c * C::kBoxW, h, q0, b);
    }
    for (int j = 0; j < kStages && j < 2 * n; ++j) issue(j);
  }
  __syncwarp();

  {  // D = rowsum(dO∘O): two threads a row, 16-byte loads, halves added
    const int r = tid >> 1, half = tid & 1, row = q0 + r;
    float acc = 0.f;
    if (row < s.Sq) {
      const int64_t off =
          ((static_cast<int64_t>(b) * s.Sq + row) * s.Hq + h) * HD +
          half * (HD / 2);
      const uint4* pd = reinterpret_cast<const uint4*>(dO + off);
      const uint4* po = reinterpret_cast<const uint4*>(o + off);
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) {
        const uint4 a = pd[c], e = po[c];
        const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
        const uint32_t ew[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          acc = fmaf(bf_lo(aw[w]), bf_lo(ew[w]), acc);
          acc = fmaf(bf_hi(aw[w]), bf_hi(ew[w]), acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      D_s[r] = acc;
      d_g[rows_at + r] = acc;
    }
  }

  // this thread's rows of the tile (accumulator fragment): r0 and r0 + 8;
  // element i is row r0 + 8·((i >> 1) & 1), column 8·(i >> 2) + c0 + (i & 1)
  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  const int qp[2] = {q0 + r0, q0 + r0 + 8};
  ring_wait(qbar, 0);
  __syncthreads();  // D_s
  const float Dr[2] = {D_s[r0], D_s[r0 + 8]};

  // pass 1: each row's max and sum of exp over the kept keys; l stays this
  // thread's share of the row sum (m is the same over the quad), the
  // quad's shares are added at the end
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = 0; j < n; ++j) {
    const int st = j % kStages, k0 = (kt_begin + j) * BT;
    ring_wait(full(st), (j / kStages) & 1);
    float sc[32];
    wgmma_fence();
    scores<HD>(sc, sQ, k_at(st));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    const bool edge = edge_tile(q0, k0, s);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int ri = (i >> 1) & 1;
      float x = sc[i] * s.scale;
      if (edge && !keep(qp[ri], k0 + 8 * (i >> 2) + c0 + (i & 1), s))
        x = -INFINITY;
      sc[i] = x;
      mx[ri] = fmaxf(mx[ri], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      alpha[r] = m[r] == -INFINITY ? 0.f : expf(m[r] - mn);
      m[r] = mn;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int ri = (i >> 1) & 1;
      rs[ri] += sc[i] == -INFINITY ? 0.f : expf(sc[i] - m[ri]);
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
    __syncthreads();  // the warpgroup is done with this stage: refill it
    if (tid == 0 && j + kStages < 2 * n) issue(j + kStages);
    __syncwarp();
  }
  float lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    // a row that sees no key (past Sq) gets +inf: every P of it is 0
    lse[r] = l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
  }
  if ((lane & 3) == 0) {
    lse_g[rows_at + r0] = lse[0];
    lse_g[rows_at + r0 + 8] = lse[1];
  }

  // pass 2: dQ = scale · dS · K, dS = P∘(dO·Vᵀ − D)
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  for (int j = n; j < 2 * n; ++j) {
    const int st = j % kStages, k0 = (kt_begin + j - n) * BT;
    ring_wait(full(st), (j / kStages) & 1);
    float sc[32], dp[32];
    wgmma_fence();
    scores<HD>(sc, sQ, k_at(st));
    scores<HD>(dp, sdO, v_at(st));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    const bool edge = edge_tile(q0, k0, s);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int ri = (i >> 1) & 1;
      const bool ok =
          !edge || keep(qp[ri], k0 + 8 * (i >> 2) + c0 + (i & 1), s);
      const float p = ok ? expf(sc[i] * s.scale - lse[ri]) : 0.f;
      sc[i] = ok ? p * (dp[i] - Dr[ri]) : 0.f;
    }
    uint32_t hi[4][4], lo[4][4];
    split_frag(sc, hi, lo);
    fence_regs(acc);
    wgmma_fence();
    accumulate<HD>(acc, hi, lo, k_at(st));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();
    if (tid == 0 && j + kStages < 2 * n) issue(j + kStages);
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qp[r];
    if (row >= s.Sq) continue;
    bf* dst = dq + ((static_cast<int64_t>(b) * s.Sq + row) * s.Hq + h) * HD +
              c0;
#pragma unroll
    for (int g = 0; g < HD / 8; ++g)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * g) = __floats2bfloat162_rn(
          acc[4 * g + 2 * r] * s.scale, acc[4 * g + 2 * r + 1] * s.scale);
  }
}

// dK and dV of one key tile of one kv head, over the query heads of one
// group of the head split.  K and V stay in shared memory; Q, dO and their
// LSE and D rows stream through the 2-stage ring, refilled by thread 0 of
// warpgroup 1 once both warpgroups have arrived on the stage's ``empty``
// mbarrier.  Warpgroup 0 computes Sᵀ = K·Qᵀ, Pᵀ, hands P to warpgroup 1
// through shared memory and accumulates dV += Pᵀ·dO; warpgroup 1 computes
// dPᵀ = V·dOᵀ, dSᵀ = Pᵀ∘(dPᵀ − D) and accumulates dK += dSᵀ·Q.  With one
// group (hs = 1) the block writes dK and dV; otherwise it writes its f32
// partials, and the last block of the key tile (an int32 ticket) sums the
// hs partials in group order and writes them.
template <int HD>
__global__ void __launch_bounds__(kDkdvThreads, 1)
    flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse_g,
                         const float* __restrict__ d_g, bf* __restrict__ dk,
                         bf* __restrict__ dv, float* partial, int* tickets,
                         Shape s, Plan pl) {
  using C = Cfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // K/V, full, empty
  __shared__ int flag;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sK = base, sV = base + C::kTile;
  auto q_at = [&](int st) { return base + (2 + 2 * st) * C::kTile; };
  auto do_at = [&](int st) { return q_at(st) + C::kTile; };
  const uint32_t rows_off = (2 + 2 * kStages) * C::kTile;  // [st][LSE, D]
  const uint32_t p_off = rows_off + kStages * C::kRowsBytes;
  const float* rows_s = reinterpret_cast<const float*>(gbase + rows_off);
  float4* P4 = reinterpret_cast<float4*>(gbase + p_off);
  const uint32_t kvbar = smem_u32(&bars[0]);
  auto full = [&](int st) { return smem_u32(&bars[1 + st]); };
  auto empty = [&](int st) { return smem_u32(&bars[1 + kStages + st]); };

  const int G = s.Hq / s.Hkv, gs = G / pl.hs;
  const int split = blockIdx.x % pl.hs;
  const int hk = (blockIdx.x / pl.hs) % s.Hkv;
  const int b = blockIdx.x / (pl.hs * s.Hkv);
  const int kt = blockIdx.y, k0 = kt * BT;
  const int h0 = hk * G + split * gs;         // the group's first query head
  // the query tiles whose rows can see this key tile, in order
  const int qt_begin = s.causal ? k0 / BT : 0;
  const int q_hi = s.window > 0 ? min(s.Sq, k0 + BT - 1 + s.window) : s.Sq;
  const int nq = max(0, (q_hi + BT - 1) / BT - qt_begin);
  const int items = gs * nq;
  const int tid = threadIdx.x;
  // the warpgroup (0 dV, 1 dK), broadcast from lane 0: warp-uniform
  const int wg = __shfl_sync(0xffffffffu, tid / kWG, 0);

  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 2 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int it) {    // item it: head h0 + it / nq, a query tile
    const int st = it % kStages;
    const int h = h0 + it / nq, q0 = (qt_begin + it % nq) * BT;
    const int64_t rows_at =
        (static_cast<int64_t>(b) * s.Hq + h) * pl.sq_pad + q0;
    mbar_expect_tx(full(st), 2 * C::kTile + C::kRowsBytes);
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c) {
      tma_load(q_at(st) + c * C::kBox, &tq, full(st), c * C::kBoxW, h, q0, b);
      tma_load(do_at(st) + c * C::kBox, &tdo, full(st), c * C::kBoxW, h, q0,
               b);
    }
    const uint32_t rows_dst = base + rows_off + st * C::kRowsBytes;
    bulk_load(rows_dst, lse_g + rows_at, BT * 4, full(st));
    bulk_load(rows_dst + BT * 4, d_g + rows_at, BT * 4, full(st));
  };
  const int ct = tid % kWG, warp = ct >> 5, lane = ct & 31;
  // thread 0 of the dK warpgroup, which usually finishes a tile last,
  // issues every copy: a stage is refilled once both have released it
  const bool issuer = wg == 1 && ct == 0;
  if (issuer) {
    mbar_expect_tx(kvbar, 2 * C::kTile);
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c) {
      tma_load(sK + c * C::kBox, &tk, kvbar, c * C::kBoxW, hk, k0, b);
      tma_load(sV + c * C::kBox, &tv, kvbar, c * C::kBoxW, hk, k0, b);
    }
    for (int it = 0; it < kStages && it < items; ++it) issue(it);
  }
  __syncwarp();
  const bool dv_role = wg == 0;
  // rows (keys) r0 and r0 + 8 of the fragment; columns (queries) c0, c0 + 1
  // of each group of 8
  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  const int kp[2] = {k0 + r0, k0 + r0 + 8};
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  ring_wait(kvbar, 0);

  for (int it = 0; it < items; ++it) {
    const int st = it % kStages, q0 = (qt_begin + it % nq) * BT;
    ring_wait(full(st), (it / kStages) & 1);
    const bool edge = edge_tile(q0, k0, s);
    const float* lse_s = rows_s + st * 2 * BT;
    const float* D_s = lse_s + BT;
    float t[32];
    uint32_t hi[4][4], lo[4][4];
    wgmma_fence();
    if (dv_role)
      scores<HD>(t, sK, q_at(st));    // Sᵀ: rows keys, columns queries
    else
      scores<HD>(t, sV, do_at(st));   // dPᵀ
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(t);
    if (dv_role) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qc = 8 * (i >> 2) + c0 + (i & 1);
        const bool ok = !edge || keep(q0 + qc, kp[(i >> 1) & 1], s);
        t[i] = ok ? expf(t[i] * s.scale - lse_s[qc]) : 0.f;
      }
      if (it > 0) bar_sync(kBarPFree, 2 * kWG);  // P of it − 1 was read
#pragma unroll
      for (int i4 = 0; i4 < 8; ++i4)
        P4[i4 * kWG + ct] = make_float4(t[4 * i4], t[4 * i4 + 1],
                                        t[4 * i4 + 2], t[4 * i4 + 3]);
      __threadfence_block();
      bar_arrive(kBarPFull, 2 * kWG);
    } else {
      bar_sync(kBarPFull, 2 * kWG);
#pragma unroll
      for (int i4 = 0; i4 < 8; ++i4) {
        const float4 p = P4[i4 * kWG + ct];
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * i4 + e;
          t[i] = pv[e] * (t[i] - D_s[8 * i4 + c0 + (e & 1)]);
        }
      }
      if (it + 1 < items) bar_arrive(kBarPFree, 2 * kWG);
    }
    split_frag(t, hi, lo);
    fence_regs(acc);
    wgmma_fence();
    accumulate<HD>(acc, hi, lo, dv_role ? do_at(st) : q_at(st));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty(st));
    if (issuer && it + kStages < items) {
      ring_wait(empty(st), (it / kStages) & 1);
      issue(it + kStages);
    }
    __syncwarp();
  }

  const float factor = dv_role ? 1.f : s.scale;
  if (pl.hs == 1) {
    bf* out = dv_role ? dv : dk;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kp[r] >= s.Sk) continue;
      bf* dst =
          out + ((static_cast<int64_t>(b) * s.Sk + kp[r]) * s.Hkv + hk) * HD +
          c0;
#pragma unroll
      for (int g = 0; g < HD / 8; ++g)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * g) =
            __floats2bfloat162_rn(acc[4 * g + 2 * r] * factor,
                                  acc[4 * g + 2 * r + 1] * factor);
    }
    return;
  }

  // the group's partials [2][hs][B, Sk, Hkv, hd] (dV, then dK), f32
  const int64_t plane = static_cast<int64_t>(s.B) * s.Sk * s.Hkv * HD;
  float* mine = partial + ((dv_role ? 0 : pl.hs) + split) * plane;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kp[r] >= s.Sk) continue;
    float* dst =
        mine + ((static_cast<int64_t>(b) * s.Sk + kp[r]) * s.Hkv + hk) * HD +
        c0;
#pragma unroll
    for (int g = 0; g < HD / 8; ++g)
      *reinterpret_cast<float2*>(dst + 8 * g) =
          make_float2(acc[4 * g + 2 * r], acc[4 * g + 2 * r + 1]);
  }
  __threadfence();
  bar_sync(kBarEpi, 2 * kWG);
  if (tid == 0) {
    int* ticket = tickets + (static_cast<int64_t>(b) * s.Hkv + hk) *
                                gridDim.y + kt;
    const int drawn = atomicAdd(ticket, 1);
    flag = drawn == pl.hs - 1;
    if (flag) *ticket = 0;
  }
  bar_sync(kBarEpi, 2 * kWG);
  if (!flag) return;
  __threadfence();
  // the last block of the key tile: the hs partials summed in group order,
  // four columns a step
  const int rows = min(BT, s.Sk - k0), per = rows * (HD / 4);
  for (int idx = tid; idx < 2 * per; idx += 2 * kWG) {
    const int which = idx / per, r = (idx % per) / (HD / 4);
    const int c = 4 * (idx % (HD / 4));
    const int64_t off =
        ((static_cast<int64_t>(b) * s.Sk + k0 + r) * s.Hkv + hk) * HD + c;
    const float* src = partial + which * pl.hs * plane + off;
    float4 tot = __ldcg(reinterpret_cast<const float4*>(src));
    for (int p = 1; p < pl.hs; ++p) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(src + p * plane));
      tot.x += v.x;
      tot.y += v.y;
      tot.z += v.z;
      tot.w += v.w;
    }
    const float f = which ? s.scale : 1.f;
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>((which ? dk : dv) + off);
    dst[0] = __floats2bfloat162_rn(tot.x * f, tot.y * f);
    dst[1] = __floats2bfloat162_rn(tot.z * f, tot.w * f);
  }
}

// A tensor map over a contiguous [B, S, H, hd] bf16 tensor (dims (hd, H,
// S, B)), boxes of 64 rows by min(hd, 64) columns, swizzled as wide as a
// box row.
CUresult make_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                  int hd) {
  const cuuint32_t bw = hd < 64 ? hd : 64;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * hd;
  const cuuint64_t strides_bytes[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {bw, 1, static_cast<cuuint32_t>(BT), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      bw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : (bw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B);
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides_bytes, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, void* dq, void* dk, void* dv, void* lse,
           void* dvec, void* partial, void* tickets, const Shape& s,
           const Plan& pl, int device, cudaStream_t stream) {
  using C = Cfg<HD>;
  static bool raised[64] = {};  // shared-memory limits raised, per device
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!raised[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::kDqSmem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(C::kDkdvSmem));
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  const int q_tiles = (s.Sq + BT - 1) / BT, k_tiles = (s.Sk + BT - 1) / BT;
  const int G = s.Hq / s.Hkv;
  if (q_tiles > 65535 || k_tiles > 65535 || pl.hs <= 0 || G % pl.hs != 0 ||
      pl.sq_pad < q_tiles * BT ||
      static_cast<int64_t>(pl.hs) * s.Hkv * s.B > 0x7fffffff ||
      static_cast<int64_t>(s.Hq) * s.B > 0x7fffffff ||
      (pl.hs > 1 && (partial == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  CUresult res = make_map(&tq, q, s.B, s.Sq, s.Hq, HD);
  if (res == CUDA_SUCCESS) res = make_map(&tdo, dO, s.B, s.Sq, s.Hq, HD);
  if (res == CUDA_SUCCESS) res = make_map(&tk, k, s.B, s.Sk, s.Hkv, HD);
  if (res == CUDA_SUCCESS) res = make_map(&tv, v, s.B, s.Sk, s.Hkv, HD);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  flash_bwd_dq_wgmma<HD><<<dim3(s.Hq * s.B, q_tiles), kWG, C::kDqSmem,
                           stream>>>(
      tq, tk, tv, tdo, static_cast<const bf*>(o), static_cast<const bf*>(dO),
      static_cast<bf*>(dq), static_cast<float*>(lse),
      static_cast<float*>(dvec), s, pl.sq_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_wgmma<HD><<<dim3(pl.hs * s.Hkv * s.B, k_tiles),
                             kDkdvThreads, C::kDkdvSmem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<bf*>(dk),
      static_cast<bf*>(dv), static_cast<float*>(partial),
      static_cast<int*>(tickets), s, pl);
  return cudaGetLastError();
}

int dispatch(int hd, const void* q, const void* k, const void* v,
             const void* o, const void* dO, void* dq, void* dk, void* dv,
             void* lse, void* dvec, void* partial, void* tickets,
             const Shape& s, const Plan& pl, int device, cudaStream_t stream) {
#define BWD_ARGS q, k, v, o, dO, dq, dk, dv, lse, dvec, partial, tickets, s, \
                 pl, device, stream
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
// scratch of B·Hq·sq_pad each (the rows' log-sum-exp and rowsum(dO∘O); the
// float32 kernels use the first B·Hq·Sq).  bfloat16 only: hs (the head
// split, a divisor of Hq / Hkv) and sq_pad (Sq rounded up to the tile)
// from flash_attention_bwd.py::bwd_plan; where hs > 1, partial is float32
// scratch of 2·hs·B·Sk·Hkv·hd and tickets int32 zeros, one a (batch, kv
// head, key tile), which the launch leaves zero.  hd is 16, 32, 64, 128 or
// 256.  Returns 0, a cudaError_t, or minus a CUresult.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dO, void* dq,
                               void* dk, void* dv, void* lse, void* dvec,
                               void* partial, void* tickets, int B, int Sq,
                               int Sk, int Hq, int Hkv, int hd, int causal,
                               int window, int hs, int sq_pad, float scale,
                               int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{B, Sq, Sk, Hq, Hkv, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(
        dispatch(hd, q, k, v, o, dO, dq, dk, dv, lse, dvec, s, st));
  if (dtype == 1)
    return tc::dispatch(hd, q, k, v, o, dO, dq, dk, dv, lse, dvec, partial,
                        tickets, s, tc::Plan{hs, sq_pad}, device, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
