// Flash attention forward (GQA, causal and optional sliding window),
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention.  Semantics are the Pallas kernel's: s = q·kᵀ·scale in
// f32 with scale = 1/√hd; positions count from 0 for q and for k; a key is
// kept where (!causal || qpos >= kpos) && (window <= 0 || qpos - kpos <
// window), else its score is NEG = -1e30; the softmax is online, with the
// running max, the running sum and the accumulator in f32; the output is
// acc / (l == 0 ? 1 : l), written in q's dtype.  Query head h reads kv head
// h / G, G = Hq / Hkv.  Key tiles wholly above the causal diagonal or
// wholly outside the window are skipped (the TPU kernel streams them
// masked): a masked score contributes exp(NEG - m) = 0 once a row has seen
// a kept key, and every row's own key is kept.  The ragged edge is masked:
// q rows >= Sq are computed and not written, key slots >= Sk read as zero
// and score -inf (not NEG), so they never count, even in a tile whose kept
// keys are all masked.  The TPU grid walks the key tiles as its last,
// sequential axis with m, l and acc in VMEM scratch; here one block owns a
// tile of q rows of one (batch, head) and loops over the key tiles itself,
// with m, l and acc in registers.
//
// The dtype chooses one of two kernels; nothing falls back from one to the
// other.
//
// bfloat16: flash_kernel_wgmma, on the tensor cores.  At the serving path's
// shape (B = 4, S = 512, Hq = 16, Hkv = 8, hd = 128, causal) the work is
// 4.3 GFLOP over 25 MB, 170 flops a byte: at the bf16 tensor cores' 989
// TFLOP/s the bytes bound it (7.5 µs), at the f32 CUDA cores' 67 TFLOP/s
// the flops would (64 µs).  The design:
//
// * One warpgroup (128 threads) owns 64 q rows.  The grid is (Hq·B, q
//   tiles), the q tiles in reverse so that the heaviest causal tiles start
//   first and the last wave is short.  At the serving shape that is 512
//   blocks of 80 KB of shared memory, two resident on each of the 132 SMs:
//   the grid covers the card about twice.  At hd = 256 (160 KB) one block
//   is resident on an SM.
// * Loads by TMA: tensor maps over the [B, S, H, hd] layout (dims (hd, H,
//   S, B)), built on the host at each launch and passed as
//   __grid_constant__ parameters.  A box is 64 rows by at most 64 columns
//   (128 bytes, the widest row the 128-byte swizzle takes), so a 128-wide
//   head is 2 boxes and a 256-wide one 4; hd 32 uses the 64-byte swizzle
//   and hd 16 the 32-byte one.  Q is loaded once; the K and V tiles of 64
//   keys stream through a ring of 2 stages, each reported on its own
//   mbarrier.  Thread 0 issues every copy: the next tile of a stage as soon
//   as the warpgroup has finished with it, so one tile's copy is in flight
//   while the other is computed.  TMA zero-fills rows past S.
// * S = Q·Kᵀ: wgmma m64n64k16, Q and K both K-major from shared memory
//   (descriptors: SBO = 8 rows, the K step moves the start address through
//   the swizzled row).  The product of two bf16 values is exact in f32, so
//   the scores keep the f32 semantics up to the order of summation.
// * The online softmax works on the accumulator fragment: a thread holds
//   pieces of two rows, whose max and sum take two shuffles over its quad.
//   Masks are applied only on the tiles that cross the diagonal, the window
//   edge or the end of the keys.  expf, no fast math; m, l and acc in f32.
// * O += P·V: wgmma m64n{hd}k16 with A = P in registers (the f32 score
//   fragment, rounded pairwise to bf16: the accumulator layout of m64nNk16
//   is the A-fragment layout of k16) and B = the V tile, MN-major (hd is
//   contiguous), with the transpose bit set (descriptors: SBO = 8 key rows,
//   LBO = the stride between 64-column boxes).  N = hd covers all five head
//   dims with one design.
// * Numerics: the Pallas kernel multiplies P·V in f32; this kernel rounds
//   the unnormalised P (in [0, 1]) to bf16 first, as the plain version
//   (ref.py), the model's plain path and the JAX model round the normalised
//   P.  The row sum l stays the sum of the f32 probabilities.
//
// float32: flash_kernel_f32, on the CUDA cores (the float32-compute paths
// are held at 3e-5, which TF32 products cannot meet).  256 threads in a 16
// x 16 grid: thread (rg, kg) owns q rows rg + 16i (i < 4) and, for the
// scores, keys kg + 16j (j < 4): a 4 x 4 register tile, so each
// shared-memory read feeds 4 multiply-adds.  For P·V it owns columns kg +
// 16j of its 4 rows.  Shared memory holds the q tile, the K and V tiles
// and the tile of probabilities P, rows padded by 4 bytes; at hd = 256 that
// is 213 KB of dynamic shared memory.
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

constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 key groups
constexpr int kPS = kBK + 16;  // row stride of P: the two half-warps' rows
                               // fall 16 banks apart
// row stride of the K and V tiles: hd + 4 bytes
__host__ __device__ constexpr int kStride(int hd) { return hd + 1; }

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (HD + 1) + 2 * kBK * kStride(HD) + kBQ * kPS);
}

// Copy rows [k0, k0 + kBK) of one kv head into a padded shared tile;
// rows >= Sk are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t row_stride, int k0, int Sk) {
  for (int i = threadIdx.x; i < kBK * HD; i += kThreads) {
    const int r = i / HD, w = i % HD;
    dst[r * kStride(HD) + w] = k0 + r < Sk ? src[(k0 + r) * row_stride + w]
                                           : 0.0f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int Sq,
                 int Sk, int Hq, int Hkv, int causal, int window,
                 float scale) {
  constexpr int kCols = HD / 16;  // output columns per thread
  constexpr int kS = kStride(HD);
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * (HD + 1);
  float* Vs = Ks + kBK * kS;
  float* Ps = Vs + kBK * kS;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int rg = tid >> 4, kg = tid & 15;

  // q tile in shared memory; rows >= Sq read as 0
  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    Qs[r * (HD + 1) + d] =
        q0 + r < Sq
            ? q[((static_cast<int64_t>(b) * Sq + q0 + r) * Hq + h) * HD + d]
            : 0.0f;
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
  const float* kbase = k + (static_cast<int64_t>(b) * Sk * Hkv + hk) * HD;
  const float* vbase = v + (static_cast<int64_t>(b) * Sk * Hkv + hk) * HD;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    load_tile<HD>(Ks, kbase, kv_row, k0, Sk);
    load_tile<HD>(Vs, vbase, kv_row, k0, Sk);
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
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(kg + 16 * j) * kS + d];
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
        const float vv = Vs[kk * kS + kg + 16 * j];
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
    float* o = out + ((static_cast<int64_t>(b) * Sq + row) * Hq + h) * HD;
#pragma unroll
    for (int j = 0; j < kCols; ++j) o[kg + 16 * j] = acc[i][j] / denom;
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                   int window, float scale, int device, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool raised[64] = {};  // shared-memory limit raised, per device
  if (smem > 48 * 1024 && device >= 0 && device < 64 && !raised[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  if (Sq > 65535 * kBQ || Hq > 65535 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_kernel_f32<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, Hq, Hkv,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBQ = 64;        // q rows per block: one warpgroup
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;
constexpr int kStages = 2;     // K/V ring

template <int HD>
struct Cfg {
  static constexpr int kBoxW = HD < 64 ? HD : 64;  // columns in a TMA box
  static constexpr int kRowB = 2 * kBoxW;          // bytes of a box row
  static constexpr int kBoxes = HD / kBoxW;
  // descriptor layout type matching the tensor map's swizzle: 1 = 128 B,
  // 2 = 64 B, 3 = 32 B
  static constexpr int kLayout = kRowB == 128 ? 1 : (kRowB == 64 ? 2 : 3);
  static constexpr int kQBox = kBQ * kRowB;        // bytes of a q box
  static constexpr int kKVBox = kBK * kRowB;       // bytes of a k or v box
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kKVBytes = kBK * HD * 2;    // one K (or V) tile
  static constexpr int kStageBytes = 2 * kKVBytes;
  // every tile starts on a 1024-byte boundary (the 128-byte swizzle's
  // period); the slack aligns the dynamic shared memory's base
  static constexpr size_t kSmem = 1024 + kQBytes + kStages * kStageBytes;
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

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

// d[64 x 16] += A[64 x 16] · B[16 x 16], A in registers, B MN-major in
// shared memory (the transpose bit set).
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

// d[64 x 32] += A[64 x 16] · B[16 x 32], A in registers, B MN-major in
// shared memory (the transpose bit set).
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

// d[64 x 64] += A[64 x 16] · B[16 x 64], A in registers, B MN-major in
// shared memory (the transpose bit set).
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

// d[64 x 128] += A[64 x 16] · B[16 x 128], A in registers, B MN-major in
// shared memory (the transpose bit set).
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

// d[64 x 256] += A[64 x 16] · B[16 x 256], A in registers, B MN-major in
// shared memory (the transpose bit set).
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


template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, int Sq, int Sk, int Hq,
                   int Hkv, int causal, int window, float scale) {
  using C = Cfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kStages];  // q, then the ring

  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // key tiles that hold a kept key for some row of this q tile
  int kt_end = (Sk + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, (q0 + kBQ - 1) / kBK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBK;
  const int n_tiles = kt_end - kt_begin;

  const uint32_t qbar = smem_u32(&bars[0]);
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto k_at = [&](int s) { return sq + C::kQBytes + s * C::kStageBytes; };
  auto v_at = [&](int s) { return k_at(s) + C::kKVBytes; };
  auto load_kv = [&](int s, int kt) {
    mbar_expect_tx(full(s), C::kStageBytes);
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c) {
      tma_load(k_at(s) + c * C::kKVBox, &tk, full(s), c * C::kBoxW, hk,
               kt * kBK, b);
      tma_load(v_at(s) + c * C::kKVBox, &tv, full(s), c * C::kBoxW, hk,
               kt * kBK, b);
    }
  };

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, C::kQBytes);
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c)
      tma_load(sq + c * C::kQBox, &tq, qbar, c * C::kBoxW, h, q0, b);
    for (int s = 0; s < kStages && s < n_tiles; ++s) load_kv(s, kt_begin + s);
  }
  __syncwarp();

  // this thread's rows of the tile (accumulator fragment): r0 and r0 + 8;
  // its columns in each group of 8: c0 and c0 + 1
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};

  mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int k0 = (kt_begin + j) * kBK;
    mbar_wait(full(s), (j / kStages) & 1);

    // S = Q · Kᵀ, both K-major
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int box = kk * 16 / C::kBoxW, col = (kk * 16) % C::kBoxW;
      const uint64_t da = make_desc(sq + box * C::kQBox + 2 * col, 16,
                                    8 * C::kRowB, C::kLayout);
      const uint64_t db = make_desc(k_at(s) + box * C::kKVBox + 2 * col, 16,
                                    8 * C::kRowB, C::kLayout);
      wgmma_ss_n64(sc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // mask (only on a tile that crosses the diagonal, the window edge or
    // the end of the keys), then the online softmax; element i of the
    // fragment is row r0 + 8·((i >> 1) & 1), column 8·(i >> 2) + c0 + (i & 1)
    const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && q0 + kBQ - 1 - k0 >= window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * scale;
      if (edge) {
        const int qpos = q0 + r0 + 8 * ((i >> 1) & 1);
        const int kpos = k0 + 8 * (i >> 2) + c0 + (i & 1);
        if (kpos >= Sk) {
          x = -INFINITY;  // padding, not a key
        } else if (!((!causal || qpos >= kpos) &&
                     (window <= 0 || qpos - kpos < window))) {
          x = kNeg;
        }
      }
      sc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = expf(sc[i] - m[(i >> 1) & 1]);
      sc[i] = p;
      rs[(i >> 1) & 1] += p;
    }
    // l stays this thread's share of the row sum (alpha is the same over
    // the quad); the quad's shares are added at the end
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P · V: P's fragment for keys 16kk .. 16kk + 15 is the score
    // fragment's groups 2kk and 2kk + 1, rounded pairwise to bf16
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = make_desc(v_at(s) + kk * 16 * C::kRowB, C::kKVBox,
                                    8 * C::kRowB, C::kLayout);
      wgmma_rs<HD>(o, pa[kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);

    // the warpgroup is done with this stage: refill it
    __syncthreads();
    if (tid == 0 && j + kStages < n_tiles) load_kv(s, kt_begin + j + kStages);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + r0 + 8 * r;
    if (row >= Sq) continue;
    const float denom = l[r] == 0.0f ? 1.0f : l[r];
    __nv_bfloat16* dst =
        out + ((static_cast<int64_t>(b) * Sq + row) * Hq + h) * HD + c0;
#pragma unroll
    for (int g = 0; g < HD / 8; ++g) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * g) = __floats2bfloat162_rn(
          o[4 * g + 2 * r] / denom, o[4 * g + 2 * r + 1] / denom);
    }
  }
}

// A tensor map over a contiguous [B, S, H, hd] bf16 tensor (dims (hd, H,
// S, B)), boxes of `rows` rows by min(hd, 64) columns, swizzled as wide as
// a box row.
CUresult make_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                  int hd, int rows) {
  const cuuint32_t bw = hd < 64 ? hd : 64;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * hd;
  const cuuint64_t strides_bytes[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {bw, 1, static_cast<cuuint32_t>(rows), 1};
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
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, int causal, int window,
           float scale, int device, cudaStream_t stream) {
  constexpr size_t smem = Cfg<HD>::kSmem;
  static bool raised[64] = {};  // shared-memory limit raised, per device
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!raised[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  const int q_tiles = (Sq + kBQ - 1) / kBQ;
  if (q_tiles > 65535 || static_cast<int64_t>(Hq) * B > 0x7fffffff)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  CUresult res = make_map(&tq, q, B, Sq, Hq, HD, kBQ);
  if (res == CUDA_SUCCESS) res = make_map(&tk, k, B, Sk, Hkv, HD, kBK);
  if (res == CUDA_SUCCESS) res = make_map(&tv, v, B, Sk, Hkv, HD, kBK);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  const dim3 grid(Hq * B, q_tiles);
  flash_kernel_wgmma<HD><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Sk, Hq, Hkv, causal,
      window, scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// q [B,Sq,Hq,hd], k/v [B,Sk,Hkv,hd], out [B,Sq,Hq,hd], all contiguous and
// of one dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the
// tensor-core kernel).  hd is 16, 32, 64, 128 or 256.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                           int hd, int causal, int window, float scale,
                           int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window, scale, \
                   device, s
  if (dtype == 0) {
    switch (hd) {
      case 16: return static_cast<int>(f32::launch<16>(FLASH_ARGS));
      case 32: return static_cast<int>(f32::launch<32>(FLASH_ARGS));
      case 64: return static_cast<int>(f32::launch<64>(FLASH_ARGS));
      case 128: return static_cast<int>(f32::launch<128>(FLASH_ARGS));
      case 256: return static_cast<int>(f32::launch<256>(FLASH_ARGS));
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 16: return tc::launch<16>(FLASH_ARGS);
      case 32: return tc::launch<32>(FLASH_ARGS);
      case 64: return tc::launch<64>(FLASH_ARGS);
      case 128: return tc::launch<128>(FLASH_ARGS);
      case 256: return tc::launch<256>(FLASH_ARGS);
    }
  }
#undef FLASH_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
