// The Mamba-1 selective scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py::mamba_scan.
// Semantics are the Pallas kernel's: a, b [B, S, D, N] and C [B, S, N]
// float32; the state h [D, N] of each batch row starts at zero and evolves
// as h_t = a_t ⊙ h_{t-1} + b_t; the output is y_t[d] = Σ_n h_t[d, n]·C_t[n],
// y [B, S, D] float32.  One addition to that contract: the kernel also
// writes the last state h_last [B, D, N], which the model keeps as its
// decode cache (the Pallas kernel holds it in its carry and drops it).
// falcon-mamba-7b's prefill calls it once per layer, at (4, 512, 8192, 16).
//
// A second entry point, for training, also writes state checkpoints:
// h_chk [B, ⌈S/T⌉ - 1, D, N] holds h_{cT-1}, the state at the end of every
// full chunk of T = kChunk steps but the last (chunk 0 starts from zero).
// The backward kernel (csrc/mamba_scan_bwd.cu) starts each chunk's
// recompute of h from them.  It is the same kernel with one more float4
// store a channel every T steps: the loop, the loads and the arithmetic do
// not change, so y and h_last keep their bits, and the checkpoints are the
// forward's own states.  At T = 32 they are 1/32 of a [B, S, D, N] tensor.
// Serving and prefill take the first entry point, which writes no h.
//
// What bounds it on this card: bytes.  a and b are 2·B·S·D·N·4 bytes (2.15
// GB at the prefill shape) read once, against 3 flops per element.  The
// design:
//
// * The TPU kernel tiles D over the grid and S into blocks carried through
//   VMEM scratch, with an associative scan inside a block.  Here one thread
//   owns one (b, d) channel for the whole sequence with its N states in
//   registers; nothing carries between blocks.
// * Each step a thread reads its a[b, s, d, 0:N] and b[b, s, d, 0:N] as N/4
//   float4 loads each, so a warp reads two contiguous runs of 32·N·4 bytes
//   (2 KB at N = 16).  The next step's loads are issued before the current
//   step's updates (a two-deep register pipeline) to keep bytes in flight
//   behind the dependent chain.  C[b, s, 0:N] is the same for every thread
//   of a block: a broadcast load through the read-only cache.
// * The update is a multiply rounded, then an add rounded (__fmul_rn,
//   __fadd_rn), the plain version's arithmetic, so h matches the plain loop
//   bit for bit; the readout sums h·C over n = 0 .. N-1 in that fixed order
//   (fmaf), so y does not depend on the grid.
// * N is a template parameter, 4, 8, 12 or 16 (a multiple of 4 for the
//   float4 loads, at most 16 to keep the 4·N registers of the pipeline).
//   At (4, 512, 8192, 16) the grid is 64 x 4 blocks of 128 threads.
//
// C interface, loaded with ctypes: the launchers return the cudaError_t of
// the launch (0 on success) and never synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;   // steps between checkpoints (CHECKPOINT_EVERY)

template <int N>
__device__ __forceinline__ void load_step(const float4* __restrict__ a,
                                          const float4* __restrict__ b,
                                          float4 (&av)[N / 4],
                                          float4 (&bv)[N / 4]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    av[j] = __ldg(a + j);
    bv[j] = __ldg(b + j);
  }
}

__device__ __forceinline__ float step1(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// kChk: also store h every kChunk steps into h_chk [B, (S-1)/kChunk, D, N].
template <int N, bool kChk>
__global__ void mamba_scan_kernel(const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  const float* __restrict__ C,
                                  float* __restrict__ y,
                                  float* __restrict__ h_last,
                                  float* __restrict__ h_chk, int S, int D) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const int64_t bb = blockIdx.y;
  // float4 views: element (bb, s, d, 4j) is float4 ((bb·S + s)·D + d)·N/4 + j
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  const float4* c4 = reinterpret_cast<const float4*>(C);
  const int64_t step = static_cast<int64_t>(D) * (N / 4);
  int64_t idx = (bb * S * D + d) * (N / 4);

  float h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = 0.f;

  float4 an[N / 4], bn[N / 4];
  load_step<N>(a4 + idx, b4 + idx, an, bn);
  for (int s = 0; s < S; ++s) {
    float4 ac[N / 4], bc[N / 4], cv[N / 4];
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      ac[j] = an[j];
      bc[j] = bn[j];
      cv[j] = __ldg(c4 + (bb * S + s) * (N / 4) + j);
    }
    if (s + 1 < S) {
      idx += step;
      load_step<N>(a4 + idx, b4 + idx, an, bn);
    }
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      h[4 * j + 0] = step1(ac[j].x, h[4 * j + 0], bc[j].x);
      h[4 * j + 1] = step1(ac[j].y, h[4 * j + 1], bc[j].y);
      h[4 * j + 2] = step1(ac[j].z, h[4 * j + 2], bc[j].z);
      h[4 * j + 3] = step1(ac[j].w, h[4 * j + 3], bc[j].w);
      acc = fmaf(h[4 * j + 0], cv[j].x, acc);
      acc = fmaf(h[4 * j + 1], cv[j].y, acc);
      acc = fmaf(h[4 * j + 2], cv[j].z, acc);
      acc = fmaf(h[4 * j + 3], cv[j].w, acc);
    }
    y[(bb * S + s) * D + d] = acc;
    if (kChk && s % kChunk == kChunk - 1 && s + 1 < S) {
      const int64_t slot = bb * ((S - 1) / kChunk) + s / kChunk;
      float4* o = reinterpret_cast<float4*>(h_chk) + (slot * D + d) * (N / 4);
#pragma unroll
      for (int j = 0; j < N / 4; ++j)
        o[j] = make_float4(h[4 * j], h[4 * j + 1], h[4 * j + 2],
                           h[4 * j + 3]);
    }
  }
  float4* out = reinterpret_cast<float4*>(h_last) + (bb * D + d) * (N / 4);
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
    out[j] = make_float4(h[4 * j], h[4 * j + 1], h[4 * j + 2], h[4 * j + 3]);
}

template <int N>
cudaError_t launch(const void* a, const void* b, const void* C, void* y,
                   void* h_last, void* h_chk, int B, int S, int D,
                   cudaStream_t s) {
  dim3 grid((D + kThreads - 1) / kThreads, B);
  const float* a_ = static_cast<const float*>(a);
  const float* b_ = static_cast<const float*>(b);
  const float* c_ = static_cast<const float*>(C);
  float* y_ = static_cast<float*>(y);
  float* l_ = static_cast<float*>(h_last);
  if (h_chk == nullptr)
    mamba_scan_kernel<N, false><<<grid, kThreads, 0, s>>>(
        a_, b_, c_, y_, l_, nullptr, S, D);
  else
    mamba_scan_kernel<N, true><<<grid, kThreads, 0, s>>>(
        a_, b_, c_, y_, l_, static_cast<float*>(h_chk), S, D);
  return cudaGetLastError();
}

int dispatch(const void* a, const void* b, const void* C, void* y,
             void* h_last, void* h_chk, int B, int S, int D, int N,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4:
      err = launch<4>(a, b, C, y, h_last, h_chk, B, S, D, s);
      break;
    case 8:
      err = launch<8>(a, b, C, y, h_last, h_chk, B, S, D, s);
      break;
    case 12:
      err = launch<12>(a, b, C, y, h_last, h_chk, B, S, D, s);
      break;
    case 16:
      err = launch<16>(a, b, C, y, h_last, h_chk, B, S, D, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// a, b [B, S, D, N], C [B, S, N], y [B, S, D], h_last [B, D, N]: float32,
// contiguous, 16-byte aligned; N is 4, 8, 12 or 16.
int mamba_scan_launch(const void* a, const void* b, const void* C, void* y,
                      void* h_last, int B, int S, int D, int N, int device,
                      void* stream) {
  return dispatch(a, b, C, y, h_last, nullptr, B, S, D, N, device, stream);
}

// The same, and h_chk [B, (S-1)/T, D, N] (16-byte aligned; unused where S
// <= T).  T is the caller's checkpoint interval, which must be kChunk.
int mamba_scan_chk_launch(const void* a, const void* b, const void* C,
                          void* y, void* h_last, void* h_chk, int B, int S,
                          int D, int N, int T, int device, void* stream) {
  if (T != kChunk) return static_cast<int>(cudaErrorInvalidValue);
  if (h_chk == nullptr || S <= kChunk)
    return dispatch(a, b, C, y, h_last, nullptr, B, S, D, N, device,
                    stream);
  return dispatch(a, b, C, y, h_last, h_chk, B, S, D, N, device, stream);
}

}  // extern "C"
