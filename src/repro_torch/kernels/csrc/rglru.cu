// RG-LRU linear recurrence for Hopper (sm_90a).
//
// rglru_scan replaces the Pallas kernel repro/kernels/rglru.py:rglru_scan
// (_rglru_kernel).  Per (b, c), from h = 0:
//
//   h_t = a_t * h_{t-1} + b_t,   out[b, t, c] = h_t
//
// a, b: float32 (B, T, C), last axis unit-stride, batch and time axes at
// the strides the caller passes (shared by a and b); out: a contiguous
// float32 (B, T, C).  Each step rounds the product and the sum
// separately (__fmul_rn, __fadd_rn, no fused multiply-add), as the plain
// version's two elementwise operations do, so the two agree bit for bit.
//
// Design: the TPU kernel tiles channels over the grid and runs a
// log-depth doubling scan inside each VMEM time block, carrying the state
// across a sequential grid axis.  Here the channels are independent
// threads: one thread per (b, c) walks time with h in a register.  Loads
// and stores are coalesced across c.  The thread keeps the next U steps'
// a and b in registers, loaded while it computes the current U steps, so
// 2*U loads are in flight per thread instead of 2.
//
// Bound on an H100: bytes.  A call must read a and b once and write out
// once: 12*B*T*C bytes, 201 MB (0.060 ms at 3.35 TB/s) at the serve shape
// B=8, T=512, C=4096, against 2 flops per element.  The B*C threads
// (32,768 there, 4,096 for a single sequence) are few for the card's
// memory parallelism, and the T steps are dependent; splitting time into
// chunks combined by a second pass is the later step.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_attrs.cuh"

namespace {

constexpr int THREADS = 64;
constexpr int U = 16;          // steps prefetched per thread

__global__ void __launch_bounds__(THREADS)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ out, int64_t T, int64_t C, int64_t sb,
             int64_t st) {
  const int64_t c = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;
  const int64_t bi = blockIdx.y;
  const float* pa = a + bi * sb + c;
  const float* pb = b + bi * sb + c;
  float* po = out + bi * T * C + c;

  float na[U], nb[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    na[u] = u < T ? pa[u * st] : 0.0f;
    nb[u] = u < T ? pb[u * st] : 0.0f;
  }
  float h = 0.0f;
  for (int64_t t0 = 0; t0 < T; t0 += U) {
    float ca[U], cb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) { ca[u] = na[u]; cb[u] = nb[u]; }
    const int64_t t1 = t0 + U;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t1 + u < T) {
        na[u] = pa[(t1 + u) * st];
        nb[u] = pb[(t1 + u) * st];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < T) {
        h = __fadd_rn(__fmul_rn(ca[u], h), cb[u]);
        po[(t0 + u) * C] = h;
      }
    }
  }
}

}  // namespace

// C interface for ctypes.  Strides are in elements.  Returns
// cudaGetLastError() after the launch (0 on success); the caller skips
// the call when B * T * C == 0.
extern "C" int rglru_forward(const float* a, const float* b, float* out,
                             int64_t B, int64_t T, int64_t C, int64_t sb,
                             int64_t st, void* stream) {
  const dim3 grid((unsigned int)((C + THREADS - 1) / THREADS),
                  (unsigned int)B);
  rglru_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a, b, out, T, C,
                                                           sb, st);
  return (int)cudaGetLastError();
}

namespace {

const KernelEntry kKernels[] = {
    {"rglru_scan", (const void*)rglru_kernel},
};

}  // namespace

extern "C" int rglru_attrs(int i, int* out, const char** name) {
  return kernel_attrs(kKernels, (int)(sizeof(kKernels) / sizeof(kKernels[0])),
                      i, out, name);
}
