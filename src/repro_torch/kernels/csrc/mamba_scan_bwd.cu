// The backward pass of the Mamba-1 selective scan, hand-written for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the Pallas kernel
// repro/kernels/mamba_scan.py::mamba_scan has no backward, and JAX
// differentiates its plain scan (repro/kernels/ref.py::mamba_scan).  This
// kernel computes that gradient for the port's forward kernel
// (csrc/mamba_scan.cu, which returns y and the last state only);
// ops.MambaScan pairs the two.  With h_t = a_t ⊙ h_{t-1} + b_t over a
// [D, N] state from zero, y_t[d] = Σ_n h_t[d, n]·C_t[n], the cotangents dy
// of y [B, S, D] and, optionally, dh_last of h_{S-1} [B, D, N]:
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
// and dy read once and da, db and dC written once (4.3 GB at that shape);
// it does about ten flops for every 16 bytes.  The design (a simple one;
// a TMA-fed ring like the forward RG-LRU's is later work):
//
// * One thread owns one (b, d) channel and its N states in registers, as in
//   the forward kernel; nothing carries between blocks.
// * h is not saved by the forward, so the kernel recomputes it: a first
//   pass walks t upwards with the forward's arithmetic (__fmul_rn then
//   __fadd_rn, so h has the forward's bits) and writes h_t into slot t of
//   the da output.  A second pass walks t downwards: it reads h_{t-1} from
//   slot t-1, keeps h_t from the step before in registers (h_{S-1} is in
//   them when the first pass ends), and overwrites slot t with da_t.  No
//   scratch beyond the outputs; the passes move a, b, h (write), then a, h,
//   da, db: about 7 tensors of [B, S, D, N], so at best about 58 % of the
//   bound above.  A thread's N floats of a step are N/4 float4 accesses,
//   one step ahead of the dependent chain.
// * dC sums over d, across blocks, with no float atomics.  Each warp sums
//   its 32 channels' products dy_t[d]·h_t[d, n] by an xor butterfly of
//   shuffles (every lane ends with the same bits: each level adds a lane's
//   value to its partner's, and IEEE addition commutes) and lanes 0..N-1
//   write the warp's partial [B, ⌈D/32⌉, S, N].  A second launch sums the
//   partials in warp order, one thread per (b, t, n).  The plain twin
//   (kernels/ref.py::mamba_scan_bwd) sums in exactly these groups, so dC,
//   like da and db, equals it bit for bit, and training runs repeat.
// * Every product and sum is rounded on its own (__fmul_rn, __fadd_rn): no
//   FMA contraction, the plain twin's arithmetic.
// * N is a template parameter, 4, 8, 12 or 16, as in the forward.
//
// C interface, loaded with ctypes: the launcher returns the cudaError_t of
// the launches (0 on success) and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSumThreads = 128;

__device__ __forceinline__ float step1(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// Element n of a register array of float4s (n is a constant once the loops
// are unrolled, so this selects a register, never local memory).
template <int Q>
__device__ __forceinline__ float elem(const float4 (&v)[Q], int n) {
  const float4& x = v[n >> 2];
  switch (n & 3) {
    case 0:
      return x.x;
    case 1:
      return x.y;
    case 2:
      return x.z;
    default:
      return x.w;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_bwd_kernel(const float* __restrict__ a,
                          const float* __restrict__ b,
                          const float* __restrict__ C,
                          const float* __restrict__ dy,
                          const float* __restrict__ dh_last,
                          float* __restrict__ da, float* __restrict__ db,
                          float* __restrict__ part, int S, int D) {
  constexpr int Q = N / 4;
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int W = (D + 31) / 32;
  const int warp = d >> 5;  // blocks start at multiples of 128 channels
  if (warp >= W) return;    // the whole warp
  // a lane past D still takes part in the shuffles, with dy = h = 0
  const bool active = d < D;
  const int64_t bb = blockIdx.y;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  const float4* c4 = reinterpret_cast<const float4*>(C);
  float4* da4 = reinterpret_cast<float4*>(da);
  float4* db4 = reinterpret_cast<float4*>(db);
  const int64_t step = static_cast<int64_t>(D) * Q;  // float4s a step
  const int64_t first = (bb * S * D + d) * Q;         // (bb, 0, d, 0)

  float h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = 0.f;

  // pass 1: h_t, with the forward's arithmetic, into slot t of da
  if (active) {
    float4 an[Q], bn[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      an[j] = __ldg(a4 + first + j);
      bn[j] = __ldg(b4 + first + j);
    }
    int64_t idx = first;
    for (int s = 0; s < S; ++s, idx += step) {
      float4 ac[Q], bc[Q];
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        ac[j] = an[j];
        bc[j] = bn[j];
      }
      if (s + 1 < S) {
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          an[j] = __ldg(a4 + idx + step + j);
          bn[j] = __ldg(b4 + idx + step + j);
        }
      }
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        h[4 * j + 0] = step1(ac[j].x, h[4 * j + 0], bc[j].x);
        h[4 * j + 1] = step1(ac[j].y, h[4 * j + 1], bc[j].y);
        h[4 * j + 2] = step1(ac[j].z, h[4 * j + 2], bc[j].z);
        h[4 * j + 3] = step1(ac[j].w, h[4 * j + 3], bc[j].w);
        da4[idx + j] = make_float4(h[4 * j], h[4 * j + 1], h[4 * j + 2],
                                   h[4 * j + 3]);
      }
    }
  }

  // pass 2: t from S-1 down; h holds h_t, the carry a_{t+1} ⊙ G_{t+1}
  float carry[N];
  if (dh_last != nullptr && active) {
    const float4* l4 = reinterpret_cast<const float4*>(dh_last) +
                       (bb * D + d) * Q;
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const float4 v = __ldg(l4 + j);
      carry[4 * j + 0] = v.x;
      carry[4 * j + 1] = v.y;
      carry[4 * j + 2] = v.z;
      carry[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) carry[n] = 0.f;
  }
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  // the operands of step t: a_t, h_{t-1} (slot t-1 of da), C_t, dy_t
  float4 an[Q], hn[Q], cn[Q];
  float gn = 0.f;
  int64_t idx = first + static_cast<int64_t>(S - 1) * step;  // slot t
  {
    const int t = S - 1;
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      an[j] = active ? __ldg(a4 + idx + j) : zero4;
      hn[j] = active && t > 0 ? da4[idx - step + j] : zero4;
      cn[j] = __ldg(c4 + (bb * S + t) * Q + j);
    }
    if (active) gn = __ldg(dy + (bb * S + t) * D + d);
  }
  float* pw = part + (bb * W + warp) * static_cast<int64_t>(S) * N;
  for (int t = S - 1; t >= 0; --t, idx -= step) {
    float4 ac[Q], hc[Q], cc[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      ac[j] = an[j];
      hc[j] = hn[j];
      cc[j] = cn[j];
    }
    const float gc = gn;
    if (t > 0) {
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        an[j] = active ? __ldg(a4 + idx - step + j) : zero4;
        hn[j] = active && t > 1 ? da4[idx - 2 * step + j] : zero4;
        cn[j] = __ldg(c4 + (bb * S + t - 1) * Q + j);
      }
      if (active) gn = __ldg(dy + (bb * S + t - 1) * D + d);
    }
    float g[N], q[N], dav[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      g[n] = __fadd_rn(__fmul_rn(gc, elem(cc, n)), carry[n]);
      q[n] = __fmul_rn(gc, h[n]);  // dy_t[d]·h_t[d, n]
      carry[n] = __fmul_rn(elem(ac, n), g[n]);
      h[n] = elem(hc, n);          // h_{t-1}, for step t-1
      dav[n] = __fmul_rn(g[n], h[n]);
    }
    if (active) {
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        db4[idx + j] = make_float4(g[4 * j], g[4 * j + 1], g[4 * j + 2],
                                   g[4 * j + 3]);
        da4[idx + j] = make_float4(dav[4 * j], dav[4 * j + 1],
                                   dav[4 * j + 2], dav[4 * j + 3]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int n = 0; n < N; ++n)
        q[n] = __fadd_rn(q[n], __shfl_xor_sync(0xffffffffu, q[n], off));
    }
    float mine = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n)
      if (lane == n) mine = q[n];
    if (lane < N) pw[static_cast<int64_t>(t) * N + lane] = mine;
  }
}

// dC[b, t, n] = the warps' partials part[b, w, t, n] summed in warp order.
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

template <int N>
cudaError_t launch(const void* a, const void* b, const void* C,
                   const void* dy, const void* dh_last, void* da, void* db,
                   void* part, void* dC, int B, int S, int D,
                   cudaStream_t s) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  mamba_scan_bwd_kernel<N><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(C), static_cast<const float*>(dy),
      static_cast<const float*>(dh_last), static_cast<float*>(da),
      static_cast<float*>(db), static_cast<float*>(part), S, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int W = (D + 31) / 32;
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
// or null, part [B, ⌈D/32⌉, S, N], dC [B, S, N]: float32, contiguous;
// a, b, C, dh_last, da and db 16-byte aligned; N is 4, 8, 12 or 16.
int mamba_scan_bwd_launch(const void* a, const void* b, const void* C,
                          const void* dy, const void* dh_last, void* da,
                          void* db, void* part, void* dC, int B, int S,
                          int D, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4:
      err = launch<4>(a, b, C, dy, dh_last, da, db, part, dC, B, S, D, s);
      break;
    case 8:
      err = launch<8>(a, b, C, dy, dh_last, da, db, part, dC, B, S, D, s);
      break;
    case 12:
      err = launch<12>(a, b, C, dy, dh_last, da, db, part, dC, B, S, D, s);
      break;
    case 16:
      err = launch<16>(a, b, C, dy, dh_last, da, db, part, dC, B, S, D, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
