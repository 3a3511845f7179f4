// The RG-LRU linear recurrence h_t = a_t·h_{t-1} + b_t, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py::rglru_scan.
// Semantics are the Pallas kernel's: a, b [B, S, W] float32, a zero initial
// state, h [B, S, W] float32 out (so h_0 = b_0).  recurrentgemma's prefill
// calls it once per recurrent layer, at (4, 512, 4096).
//
// What bounds it on this card: bytes (a and b read once, h written once;
// one multiply and one add per 12 bytes), and, before that, the latency of
// the dependent chain over S.  The design:
//
// * The TPU kernel tiles S into blocks carried through VMEM scratch along
//   its sequential grid axis, with an associative scan inside a tile.
//   Blocks here run in no order, so nothing carries between them: one
//   thread owns one (b, w) channel for the whole sequence and keeps h in a
//   register.  Neighbouring threads own neighbouring w, so each step's
//   loads and store coalesce across a warp (128 bytes a warp).
// * The chain h = a·h + b is serial, so the loads are not: a thread loads
//   kUnroll steps of a and b into registers first (2·kUnroll independent
//   loads in flight), then runs the kUnroll dependent updates.  At
//   (4, 512, 4096) that is 16,384 threads in blocks of 128 (128 blocks on
//   132 SMs).
// * Each update is a multiply rounded, then an add rounded (__fmul_rn,
//   __fadd_rn: no FMA contraction), the plain version's arithmetic, so h
//   comes out bit for bit that of the plain loop over S.
//
// C interface, loaded with ctypes: the launcher returns the cudaError_t of
// the launch (0 on success) and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

__global__ void rglru_scan_kernel(const float* __restrict__ a,
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

}  // namespace

extern "C" {

// a, b, h [B, S, W] float32, contiguous.
int rglru_scan_launch(const void* a, const void* b, void* h, int B, int S,
                      int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), S, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
