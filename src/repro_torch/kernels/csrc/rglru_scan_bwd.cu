// The backward pass of the RG-LRU linear recurrence, hand-written for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the Pallas kernel
// repro/kernels/rglru_scan.py::rglru_scan has no backward, and JAX
// differentiates its plain scan (repro/kernels/ref.py::rglru_scan).  This
// kernel computes that gradient for the port's forward kernel
// (csrc/rglru_scan.cu); ops.RGLRUScan pairs the two.  With h_t = a_t·h_{t-1}
// + b_t from a zero state and the cotangent dy of h [B, S, W]:
//
//   g_t  = dy_t + a_{t+1}·g_{t+1}      (nothing past S)
//   db_t = g_t
//   da_t = g_t·h_{t-1}                 (h_{-1} = 0)
//
// a, h (the forward's output) and dy in, da and db out, all [B, S, W]
// float32.  recurrentgemma's training calls it once per recurrent layer at
// (4, 512, 4096).
//
// What bounds it on this card: bytes (three tensors read, two written; two
// multiplies and an add per 20 bytes).  The chain over g runs backwards in
// S and is serial, so, as in the forward's row-wise kernel, one thread owns
// one (b, w) channel for the whole sequence and keeps the carry a·g in a
// register; neighbouring threads own neighbouring channels, so every load
// and store of a warp is one 128-byte line.  A thread loads kUnroll steps
// of dy, a and h before it runs their kUnroll dependent updates, to keep
// bytes in flight behind the chain.  Each product and the sum are rounded
// on their own (__fmul_rn, __fadd_rn: no FMA contraction), the plain twin's
// arithmetic (kernels/ref.py::rglru_scan_bwd), so da and db equal it bit
// for bit.
//
// C interface, loaded with ctypes: the launcher returns the cudaError_t of
// the launch (0 on success) and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
    rglru_scan_bwd_kernel(const float* __restrict__ a,
                          const float* __restrict__ h,
                          const float* __restrict__ dy,
                          float* __restrict__ da, float* __restrict__ db,
                          int S, int W) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * S * W + w;
  const float* ap = a + base;
  const float* hp = h + base;
  const float* gp = dy + base;
  float* dap = da + base;
  float* dbp = db + base;
  float carry = 0.f;  // a_{t+1}·g_{t+1}
  int hi = S;         // steps [hi, S) are done
  for (; hi >= kUnroll; hi -= kUnroll) {
    const int lo = hi - kUnroll;
    float av[kUnroll], hv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t off = static_cast<int64_t>(lo + u) * W;
      av[u] = __ldg(ap + off);
      gv[u] = __ldg(gp + off);
      hv[u] = lo + u > 0 ? __ldg(hp + off - W) : 0.f;
    }
#pragma unroll
    for (int u = kUnroll - 1; u >= 0; --u) {
      const int64_t off = static_cast<int64_t>(lo + u) * W;
      const float g = __fadd_rn(gv[u], carry);
      dbp[off] = g;
      dap[off] = __fmul_rn(g, hv[u]);
      carry = __fmul_rn(av[u], g);
    }
  }
  for (int t = hi - 1; t >= 0; --t) {
    const int64_t off = static_cast<int64_t>(t) * W;
    const float g = __fadd_rn(__ldg(gp + off), carry);
    const float hprev = t > 0 ? __ldg(hp + off - W) : 0.f;
    dbp[off] = g;
    dap[off] = __fmul_rn(g, hprev);
    carry = __fmul_rn(__ldg(ap + off), g);
  }
}

}  // namespace

extern "C" {

// a, h, dy, da, db [B, S, W] float32, contiguous.
int rglru_scan_bwd_launch(const void* a, const void* h, const void* dy,
                          void* da, void* db, int B, int S, int W,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_bwd_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h),
      static_cast<const float*>(dy), static_cast<float*>(da),
      static_cast<float*>(db), S, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
