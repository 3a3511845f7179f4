// The RG-LRU linear recurrence h_t = a_t·h_{t-1} + b_t, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py::rglru_scan.
// Semantics are the Pallas kernel's: a, b [B, S, W] float32, a zero initial
// state, h [B, S, W] float32 out (so h_0 = b_0).  recurrentgemma's prefill
// calls it once per recurrent layer, at (4, 512, 4096).
//
// What bounds it on this card: bytes (a and b read once, h written once;
// one multiply and one add per 12 bytes).  The chain h = a·h + b is serial
// in S, and each update is a multiply rounded, then an add rounded
// (__fmul_rn, __fadd_rn: no FMA contraction), the plain version's
// arithmetic, so h comes out bit for bit that of the plain loop over S.
// Splitting S across blocks with a carry pass would give that up, so one
// thread owns one (b, w) channel for the whole sequence and keeps h in a
// register.  The TPU kernel tiles S into blocks carried through VMEM
// scratch along its sequential grid axis; here the same walk over S is a
// loop inside a block, and what matters is keeping enough bytes in flight
// while the chains run.
//
// The design (``rglru_tma_kernel``): a block owns kWt = 64 channels of one
// batch row and walks S in tiles of kTs = 32 steps through a ring of
// kStages = 4 stages in shared memory.  A stage holds the [kTs, kWt] tiles
// of a and of b.  One producer thread (its own warp) keeps the ring full
// with two TMA loads a stage from 3-d tensor maps over [B, S, W],
// completing on the stage's "full" mbarrier; the TMA unit zero-fills what
// lies past S or W.  kWt consumer threads, one a channel, wait on "full",
// copy their column of the stage into registers (conflict-free:
// neighbouring threads read neighbouring words), release the stage on its
// "empty" mbarrier (one arrival a consumer warp) and run the kTs updates,
// storing each h with a coalesced 128-byte warp store.  So the loads of
// later tiles stay in flight while a tile's chain runs: up to three
// stages, 48 KB a block, about 96 KB an SM at (4, 512, 4096) (256 blocks on
// 132 SMs).  (A debug sweep of kTs 16-64, 3-8 stages and 32-channel
// blocks, also at B = 1 where 64-channel blocks leave half the SMs idle,
// moved the time by a few percent at most.)
//
// The tensor maps need 16-byte rows and bases (W % 4 == 0, a and b
// 16-byte aligned).  Other operands take ``rglru_rowwise_kernel``: a
// thread a channel loading kUnroll steps into registers before it runs
// them, the same arithmetic and so the same bits.
//
// C interface, loaded with ctypes: the launcher returns the cudaError_t of
// the launch (0 on success), or minus the CUresult where a tensor map
// cannot be encoded, and never synchronises.  The library links libcuda
// for cuTensorMapEncodeTiled.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTs = 32;      // steps a stage
constexpr int kStages = 4;   // stages of the ring
constexpr int kWt = 64;      // channels a block: one consumer thread each
constexpr int kTile = kTs * kWt;                   // floats of one tile
constexpr int kStageBytes = 2 * kTile * 4;         // a and b
constexpr size_t kSmem = 128 + kStages * kStageBytes;
constexpr int kThreads = kWt + 32;                 // consumers, producer

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

// One box of a 3-d tensor map (coordinates innermost first) into shared
// memory, completing on the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__global__ void __launch_bounds__(kThreads)
rglru_tma_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb,
                 float* __restrict__ h, int S, int W) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];   // full, then empty
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t{127});
  auto full = [&](int s) { return smem_u32(&bars[s]); };
  auto empty = [&](int s) { return smem_u32(&bars[kStages + s]); };
  const int w0 = blockIdx.x * kWt, b = blockIdx.y;
  const int tiles = (S + kTs - 1) / kTs;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWt / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kWt) {  // the producer warp: one thread starts every load
    if (tid == kWt) {
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty(s), (j / kStages - 1) & 1);
        const uint32_t dst = smem_u32(ring + 2 * s * kTile);
        mbar_expect_tx(full(s), kStageBytes);
        tma_load(dst, &ta, full(s), w0, j * kTs, b);
        tma_load(dst + kTile * 4, &tb, full(s), w0, j * kTs, b);
      }
    }
    return;
  }

  const int w = w0 + tid;
  const bool mine = w < W;
  float* hp = h + static_cast<int64_t>(b) * S * W + w;
  float hv = 0.f;
  for (int j = 0; j < tiles; ++j) {
    const int s = j % kStages;
    mbar_wait(full(s), (j / kStages) & 1);
    const float* as = ring + 2 * s * kTile + tid;
    const float* bs = as + kTile;
    float* out = hp + static_cast<int64_t>(j) * kTs * W;
    const int n = min(kTs, S - j * kTs);
    if (n == kTs) {
      float av[kTs], bv[kTs];
#pragma unroll
      for (int u = 0; u < kTs; ++u) {
        av[u] = as[u * kWt];
        bv[u] = bs[u * kWt];
      }
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(empty(s));
#pragma unroll
      for (int u = 0; u < kTs; ++u) {
        hv = __fadd_rn(__fmul_rn(av[u], hv), bv[u]);
        if (mine) out[static_cast<int64_t>(u) * W] = hv;
      }
    } else {  // the last, short tile: read the stage in place
      for (int u = 0; u < n; ++u) {
        hv = __fadd_rn(__fmul_rn(as[u * kWt], hv), bs[u * kWt]);
        if (mine) out[static_cast<int64_t>(u) * W] = hv;
      }
    }
  }
}

constexpr int kRowThreads = 128;
constexpr int kUnroll = 16;

// A thread a channel, kUnroll steps of a and b loaded into registers
// before the kUnroll dependent updates: for operands the tensor maps do
// not take.
__global__ void rglru_rowwise_kernel(const float* __restrict__ a,
                                     const float* __restrict__ b,
                                     float* __restrict__ h, int S, int W) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * S * W + w;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  float hv = 0.f;
  int s = 0;
  for (; s + kUnroll <= S; s += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t off = static_cast<int64_t>(s + u) * W;
      av[u] = __ldg(ap + off);
      bv[u] = __ldg(bp + off);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      hv = __fadd_rn(__fmul_rn(av[u], hv), bv[u]);
      hp[static_cast<int64_t>(s + u) * W] = hv;
    }
  }
  for (; s < S; ++s) {
    const int64_t off = static_cast<int64_t>(s) * W;
    hv = __fadd_rn(__fmul_rn(__ldg(ap + off), hv), __ldg(bp + off));
    hp[off] = hv;
  }
}

// A tensor map over a contiguous [B, S, W] float32 tensor (dims (W, S,
// B)), boxes of kTs steps by kWt channels, no swizzle, zero fill past the
// edges.
CUresult make_map(CUtensorMap* map, const void* ptr, int B, int S, int W) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 4ull * W;
  const cuuint64_t strides_bytes[2] = {row, row * S};
  const cuuint32_t box[3] = {kWt, kTs, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
      strides_bytes, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

int launch_tma(const void* a, const void* b, void* h, int B, int S, int W,
               int device, cudaStream_t stream) {
  static bool raised[64] = {};  // shared-memory limit raised, per device
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!raised[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        rglru_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem));
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  CUtensorMap ta, tb;
  CUresult res = make_map(&ta, a, B, S, W);
  if (res == CUDA_SUCCESS) res = make_map(&tb, b, B, S, W);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  const dim3 grid((W + kWt - 1) / kWt, B);
  rglru_tma_kernel<<<grid, kThreads, kSmem, stream>>>(
      ta, tb, static_cast<float*>(h), S, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a, b, h [B, S, W] float32, contiguous.
int rglru_scan_launch(const void* a, const void* b, void* h, int B, int S,
                      int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tma = W % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(a) & 15u) == 0 &&
                   (reinterpret_cast<uintptr_t>(b) & 15u) == 0;
  if (tma) return launch_tma(a, b, h, B, S, W, device, s);
  dim3 grid((W + kRowThreads - 1) / kRowThreads, B);
  rglru_rowwise_kernel<<<grid, kRowThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), S, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
