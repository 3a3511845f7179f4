// The backward pass of the Mamba-1 selective scan, hand-written for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the Pallas kernel
// repro/kernels/mamba_scan.py::mamba_scan has no backward, and JAX
// differentiates its plain scan (repro/kernels/ref.py::mamba_scan).  This
// kernel computes that gradient for the port's forward kernel
// (csrc/mamba_scan.cu); ops.MambaScan pairs the two.  With h_t = a_t ⊙
// h_{t-1} + b_t over a [D, N] state from zero, y_t[d] = Σ_n h_t[d, n]·C_t[n],
// the cotangents dy of y [B, S, D] and, optionally, dh_last of h_{S-1}
// [B, D, N]:
//
//   G_{S-1} = dy_{S-1} ⊗ C_{S-1} + dh_last         (or + 0)
//   G_t     = dy_t ⊗ C_t + a_{t+1} ⊙ G_{t+1}
//   db_t    = G_t
//   da_t    = G_t ⊙ h_{t-1}                      (h_{-1} = 0)
//   dC_t[n] = Σ_d dy_t[d]·h_t[d, n]
//
// a, b [B, S, D, N], C [B, S, N], dy [B, S, D] float32 in; da, db
// [B, S, D, N] and dC [B, S, N] out.  falcon-mamba-7b's training calls it
// once per layer at (4, 512, 8192, 16).
//
// What bounds it on this card: bytes.  The least it must move is a, b, C
// and dy read once and da, db and dC written once (4.36 GB at that shape);
// it does about ten flops for every 16 bytes.  The design:
//
// * State checkpoints.  The backward needs h_{t-1} in reverse time order.
//   The training forward (mamba_scan.cu's checkpointing entry point) stores
//   h_{cT-1} at the end of every full chunk of T = kChunk = 32 steps but the
//   last, h_chk [B, ⌈S/T⌉ - 1, D, N] (1/32 of a tensor).  Without them (the
//   standalone call) a first launch, mamba_chk_kernel, computes them from a
//   and b with the forward's loop: it reads both once and writes only the
//   checkpoints.  From an exact state, h inside a chunk is recomputed with
//   the forward's roundings (__fmul_rn, then __fadd_rn), so it has the
//   forward's bits.
// * Tiles (mamba_bwd_chunk_kernel).  A block owns kGroup = 32 channels of
//   one batch row, all N states: one thread an (d, n), 32·N of them.  It
//   walks the chunks from the last to the first.  A chunk's a and b come
//   into shared memory as kSub = 4 stages, each the [kTs = 8, 32, N] tiles
//   of a and of b, loaded by TMA from 4-d tensor maps over [B, S, D, N]
//   (the unit zero-fills what lies past S or D) and completing on the
//   stage's mbarrier.  Each thread copies its (d, n) column of the stages
//   into registers (neighbouring threads read neighbouring words); once the
//   whole block has (a barrier), thread 0 starts the next chunk's loads into
//   the same buffer, so that they fly (128 KB at N = 16) while the block
//   computes.  No producer warp: a 16-warp block keeps 128 registers a
//   thread at N = 16, where a 17th warp would cut it to 96.
// * Forward within the chunk: each thread walks t upwards from the chunk's
//   checkpoint (zero for chunk 0), h_t over b_t in its registers, and
//   writes dy_t[d]·h_t[d, n] for dC into shared memory.
// * Reverse within the chunk, t downwards, the plain twin's operation
//   order: G_t = dy_t[d]·C_t[n] + carry (the carry starts from dh_last or
//   zero at S-1 and runs on across chunks), db_t = G_t, da_t = G_t·h_{t-1}
//   (the register before, or the chunk's checkpoint at its first step),
//   carry = a_t·G_t.  dy and C of the chunk are staged in shared memory
//   once.  da_t and db_t are stored once, coalesced: for a fixed t a
//   block's slice of [B, S, D, N] is 32·N contiguous floats.
// * dC sums over d, across blocks, with no float atomics.  After a barrier,
//   thread (u, n) sums the chunk's step u over its 32 channels by the halving
//   tree of the plain twin (element i plus element i + half, half = 16, 8,
//   4, 2, 1; DC_GROUP = 32) and writes the block's partial
//   [B, ⌈D/32⌉, S, N].  A second launch (mamba_dc_sum_kernel) sums the
//   partials in group order, one thread per (b, t, n).  The plain twin
//   (kernels/ref.py::mamba_scan_bwd) sums in exactly these groups, so dC,
//   like da and db, equals it bit for bit, and training runs repeat.
// * Bytes: a, b in, da, db out once, dy, C, the checkpoints and the dC
//   partials: about 4.4 GB at the training shape.  The standalone call
//   reads a and b once more.
// * Every product and sum is rounded on its own (__fmul_rn, __fadd_rn): no
//   FMA contraction, the plain twin's arithmetic.
// * N is a template parameter, 4, 8, 12 or 16.  Shared memory a block: the
//   chunk's a and b, its products [32, 32·N + N] (padded by N so that the
//   tree's reads spread over the banks), dy [32, 32] and C [32, N]: 205 KB
//   at N = 16 (one block of 512 threads an SM), 54 KB at N = 4.  The
//   chunk's a and h live in 64 registers a thread.
//
// The tensor maps need 16-byte rows and bases (a and b 16-byte aligned;
// N·4 bytes is a multiple of 16 for every N taken).
//
// C interface, loaded with ctypes: the launcher returns the cudaError_t of
// the launches (0 on success), or minus the CUresult where a tensor map
// cannot be encoded, and never synchronises.  The library links libcuda for
// cuTensorMapEncodeTiled.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;   // steps between checkpoints (CHECKPOINT_EVERY)
constexpr int kGroup = 32;   // channels a block, summed by one tree (DC_GROUP)
constexpr int kTs = 8;       // steps a stage of the ring
constexpr int kSub = kChunk / kTs;  // stages of the ring: one chunk
constexpr int kChkThreads = 128;
constexpr int kSumThreads = 128;

template <int N>
struct Plan {
  static constexpr int E = kGroup * N;     // floats of a step's slice
  static constexpr int kThreads = E;       // one an (d, n)
  static constexpr int kTile = kTs * E;    // floats of one tile
  static constexpr int kStageBytes = 2 * kTile * 4;    // a and b
  static constexpr int kQRow = E + N;      // a row of the products
  static constexpr int kRing = kSub * 2 * kTile;       // floats
  static constexpr int kQ = kChunk * kQRow;
  static constexpr int kDy = kChunk * kGroup;
  static constexpr int kC = kChunk * N;
  static constexpr size_t kSmem = 4 * (kRing + kQ + kDy + kC);
  static constexpr int kDyIters = (kDy + E - 1) / E;
};

__device__ __forceinline__ float step1(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

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

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
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

// The checkpoints alone: one thread a (b, d) channel walks all of S with
// the forward kernel's loads and arithmetic and stores h every kChunk
// steps (the standalone call's first launch).
template <int N>
__global__ void __launch_bounds__(kChkThreads)
    mamba_chk_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ h_chk, int S, int D) {
  constexpr int Q = N / 4;
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const int64_t bb = blockIdx.y;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  const int64_t step = static_cast<int64_t>(D) * Q;
  int64_t idx = (bb * S * D + d) * Q;
  const int nchk = (S - 1) / kChunk;
  const int last = nchk * kChunk;  // steps that reach a checkpoint
  float4* out = reinterpret_cast<float4*>(h_chk) + (bb * nchk * D + d) * Q;

  float h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = 0.f;
  float4 an[Q], bn[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    an[j] = __ldg(a4 + idx + j);
    bn[j] = __ldg(b4 + idx + j);
  }
  for (int s = 0; s < last; ++s) {
    float4 ac[Q], bc[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      ac[j] = an[j];
      bc[j] = bn[j];
    }
    if (s + 1 < last) {
      idx += step;
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        an[j] = __ldg(a4 + idx + j);
        bn[j] = __ldg(b4 + idx + j);
      }
    }
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      h[4 * j + 0] = step1(ac[j].x, h[4 * j + 0], bc[j].x);
      h[4 * j + 1] = step1(ac[j].y, h[4 * j + 1], bc[j].y);
      h[4 * j + 2] = step1(ac[j].z, h[4 * j + 2], bc[j].z);
      h[4 * j + 3] = step1(ac[j].w, h[4 * j + 3], bc[j].w);
    }
    if (s % kChunk == kChunk - 1) {
      float4* o = out + static_cast<int64_t>(s / kChunk) * D * Q;
#pragma unroll
      for (int j = 0; j < Q; ++j)
        o[j] = make_float4(h[4 * j], h[4 * j + 1], h[4 * j + 2],
                           h[4 * j + 3]);
    }
  }
}

template <int N>
__global__ void __launch_bounds__(Plan<N>::kThreads)
    mamba_bwd_chunk_kernel(const __grid_constant__ CUtensorMap ta,
                           const __grid_constant__ CUtensorMap tb,
                           const float* __restrict__ C,
                           const float* __restrict__ dy,
                           const float* __restrict__ dh_last,
                           const float* __restrict__ h_chk,
                           float* __restrict__ da, float* __restrict__ db,
                           float* __restrict__ part, int S, int D) {
  using P = Plan<N>;
  constexpr int E = P::E;
  // declared as floats in the shared window (not re-derived through an
  // integer), so that every access below is an LDS / STS with a 32-bit
  // address
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) uint64_t full[kSub];  // one a stage of the chunk
  float* qs = ring + P::kRing;   // [kChunk][kQRow]: dy_t[d]·h_t[d, n]
  float* dys = qs + P::kQ;       // [kChunk][kGroup]
  float* cs = dys + P::kDy;      // [kChunk][N]
  const int w = blockIdx.x, bb = blockIdx.y;
  const int d0 = w * kGroup;
  const int nC = (S + kChunk - 1) / kChunk;
  const int tid = threadIdx.x;

  // thread 0 loads chunk c into the ring: its stages of kTs steps that
  // start before S, a and b each, completing on full[k]
  auto load_chunk = [&](int c) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int k = 0; k < kSub; ++k) {
      const int t = c * kChunk + k * kTs;
      if (t >= S) break;
      const uint32_t bar = smem_u32(&full[k]);
      const uint32_t dst = smem_u32(ring + k * 2 * P::kTile);
      mbar_expect_tx(bar, P::kStageBytes);
      tma_load(dst, &ta, bar, 0, d0, t, bb);
      tma_load(dst + P::kTile * 4, &tb, bar, 0, d0, t, bb);
    }
  };
  if (tid == 0) {
    for (int k = 0; k < kSub; ++k) mbar_init(smem_u32(&full[k]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_chunk(nC - 1);
  }
  __syncthreads();

  const int dl = tid / N, n = tid % N;  // this thread's (d, n)
  const int d = d0 + dl;
  const bool active = d < D;
  const int nchk = nC - 1;
  const int W = (D + kGroup - 1) / kGroup;
  const int64_t DN = static_cast<int64_t>(D) * N;
  float* pw = part + (static_cast<int64_t>(bb) * W + w) * S * N;
  float carry = 0.f;  // a_{t+1}·G_{t+1}, across chunks
  if (dh_last != nullptr && active)
    carry = __ldg(dh_last + (static_cast<int64_t>(bb) * D + d) * N + n);

  uint32_t phase = 0;  // bit k: the parity full[k] waits for next
  for (int c = nC - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int len = min(kChunk, S - t0);
    // the chunk's dy and C, loaded now, staged after the copy
    float dyr[P::kDyIters];
#pragma unroll
    for (int r = 0; r < P::kDyIters; ++r) {
      const int i = tid + r * E;
      const int u = i / kGroup, dd = d0 + i % kGroup;
      dyr[r] = i < P::kDy && u < len && dd < D
                   ? __ldg(dy + (static_cast<int64_t>(bb) * S + t0 + u) * D +
                           dd)
                   : 0.f;
    }
    const float cr =
        tid / N < len
            ? __ldg(C + (static_cast<int64_t>(bb) * S + t0) * N + tid)
            : 0.f;
    const float h0 =
        c > 0 && active
            ? __ldg(h_chk + ((static_cast<int64_t>(bb) * nchk + c - 1) * D +
                             d) * N + n)
            : 0.f;

    // this thread's column of the chunk's a and b, into registers
    float av[kChunk], hv[kChunk];
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      if (k * kTs < len) {
        mbar_wait(smem_u32(&full[k]), (phase >> k) & 1u);
        phase ^= 1u << k;
        const float* as = ring + k * 2 * P::kTile + tid;
        const float* bs = as + P::kTile;
#pragma unroll
        for (int u = 0; u < kTs; ++u) {
          av[k * kTs + u] = as[u * E];
          hv[k * kTs + u] = bs[u * E];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < P::kDyIters; ++r)
      if (tid + r * E < P::kDy) dys[tid + r * E] = dyr[r];
    cs[tid] = cr;  // E = kChunk·N: one C value a thread
    __syncthreads();
    // the ring is free: the next chunk's loads fly while this one runs
    if (tid == 0 && c > 0) load_chunk(c - 1);

    // forward: h_t over b_t, from the checkpoint; the products for dC
    float h = h0;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (u < len) {
        h = step1(av[u], h, hv[u]);
        hv[u] = h;
        qs[u * P::kQRow + tid] = __fmul_rn(dys[u * kGroup + dl], h);
      }
    }

    // reverse: t from the chunk's last step down to t0
    const int64_t base = (static_cast<int64_t>(bb) * S + t0) * DN +
                         static_cast<int64_t>(d) * N + n;
#pragma unroll
    for (int u = kChunk - 1; u >= 0; --u) {
      if (u < len) {
        const float g = __fadd_rn(
            __fmul_rn(dys[u * kGroup + dl], cs[u * N + n]), carry);
        const float hp = u > 0 ? hv[u - 1] : h0;
        carry = __fmul_rn(av[u], g);
        if (active) {
          db[base + u * DN] = g;
          da[base + u * DN] = __fmul_rn(g, hp);
        }
      }
    }
    __syncthreads();

    // dC: thread (u, n) sums step u's 32 channels by the halving tree
    {
      const int u = tid / N, nn = tid % N;
      if (u < len) {
        float x[kGroup];
#pragma unroll
        for (int dd = 0; dd < kGroup; ++dd)
          x[dd] = qs[u * P::kQRow + dd * N + nn];
#pragma unroll
        for (int lvl = 1; lvl < kGroup; lvl *= 2) {  // half = kGroup / 2lvl
#pragma unroll
          for (int i = 0; i < kGroup / 2; ++i)
            if (i < kGroup / (2 * lvl))
              x[i] = __fadd_rn(x[i], x[i + kGroup / (2 * lvl)]);
        }
        pw[static_cast<int64_t>(t0 + u) * N + nn] = x[0];
      }
    }
  }
}

// dC[b, t, n] = the groups' partials part[b, w, t, n] summed in group order.
__global__ void __launch_bounds__(kSumThreads)
    mamba_dc_sum_kernel(const float* __restrict__ part,
                        float* __restrict__ dC, int W, int64_t sn,
                        int64_t total) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= total) return;
  const int64_t bb = i / sn;
  const float* p = part + bb * W * sn + (i - bb * sn);
  float acc = __ldg(p);
  for (int w = 1; w < W; ++w) acc = __fadd_rn(acc, __ldg(p + w * sn));
  dC[i] = acc;
}

// A tensor map over a contiguous [B, S, D, N] float32 tensor (dims (N, D,
// S, B)), boxes of kTs steps by kGroup channels by N, no swizzle, zero fill
// past the edges.
CUresult make_map(CUtensorMap* map, const void* ptr, int B, int S, int D,
                  int N) {
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(D),
      static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 4ull * N;
  const cuuint64_t strides_bytes[3] = {row, row * D, row * D * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(N), kGroup, kTs, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims,
      strides_bytes, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int N>
int launch(const void* a, const void* b, const void* C, const void* dy,
           const void* dh_last, void* h_chk, bool make_chk, void* da,
           void* db, void* part, void* dC, int B, int S, int D, int device,
           cudaStream_t s) {
  using P = Plan<N>;
  static bool raised[64] = {};  // shared-memory limit raised, per device
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!raised[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        mamba_bwd_chunk_kernel<N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(P::kSmem));
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  if (make_chk && S > kChunk) {
    const dim3 grid((D + kChkThreads - 1) / kChkThreads, B);
    mamba_chk_kernel<N><<<grid, kChkThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(h_chk), S, D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  CUtensorMap ta, tb;
  CUresult res = make_map(&ta, a, B, S, D, N);
  if (res == CUDA_SUCCESS) res = make_map(&tb, b, B, S, D, N);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  const int W = (D + kGroup - 1) / kGroup;
  mamba_bwd_chunk_kernel<N><<<dim3(W, B), P::kThreads, P::kSmem, s>>>(
      ta, tb, static_cast<const float*>(C), static_cast<const float*>(dy),
      static_cast<const float*>(dh_last), static_cast<const float*>(h_chk),
      static_cast<float*>(da), static_cast<float*>(db),
      static_cast<float*>(part), S, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t sn = static_cast<int64_t>(S) * N;
  const int64_t total = static_cast<int64_t>(B) * sn;
  const int64_t blocks = (total + kSumThreads - 1) / kSumThreads;
  mamba_dc_sum_kernel<<<static_cast<unsigned>(blocks), kSumThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dC), W, sn,
      total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a, b, da, db [B, S, D, N], C [B, S, N], dy [B, S, D], dh_last [B, D, N]
// or null, h_chk [B, ⌈S/T⌉ - 1, D, N] (read; written first where make_chk
// is non-zero), part [B, ⌈D/32⌉, S, N], dC [B, S, N]: float32,
// contiguous; a, b and (where make_chk) h_chk 16-byte aligned; N is 4, 8,
// 12 or 16; T, the caller's checkpoint interval, must be kChunk.
int mamba_scan_bwd_launch(const void* a, const void* b, const void* C,
                          const void* dy, const void* dh_last, void* h_chk,
                          int make_chk, void* da, void* db, void* part,
                          void* dC, int B, int S, int D, int N, int T,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535 || T != kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mk = make_chk != 0;
  switch (N) {
    case 4:
      return launch<4>(a, b, C, dy, dh_last, h_chk, mk, da, db, part, dC, B,
                       S, D, device, s);
    case 8:
      return launch<8>(a, b, C, dy, dh_last, h_chk, mk, da, db, part, dC, B,
                       S, D, device, s);
    case 12:
      return launch<12>(a, b, C, dy, dh_last, h_chk, mk, da, db, part, dC, B,
                        S, D, device, s);
    case 16:
      return launch<16>(a, b, C, dy, dh_last, h_chk, mk, da, db, part, dC, B,
                        S, D, device, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
