// RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// wkv6 replaces the Pallas kernel repro/kernels/wkv6.py:wkv6
// (_wkv_kernel).  Per (b, h), from a zero state S (Dh_k x Dh_v):
//
//   o_t[j]   = sum_i r_t[i] * (S[i,j] + u[i] * k_t[i] * v_t[j])
//   S[i,j]  <- w_t[i] * S[i,j] + k_t[i] * v_t[j]
//
// r, k, v, w: float32 (B, T, H, Dh), last axis unit-stride, the other
// three axes at the strides the caller passes (the model's own layout;
// no transpose copy); u: float32 (H, Dh) contiguous.  Writes o as a
// contiguous float32 (B, T, H, Dh) and the final state as a contiguous
// float32 (B, H, Dh, Dh) in k-major order (state[b, h, i, j] = S[i, j]),
// the layout of the model's decode cache.  Accumulation is fp32.
//
// Design: the TPU kernel factors each time chunk into MXU matmuls, which
// needs exp(+-sum log w) and forces the model to clip the log-decay.
// Here the recurrence runs as written, one step at a time: one block per
// (b, h) with Dh threads; thread j keeps the state column S[:, j] in
// registers.  Each step stages r_t, k_t, w_t in shared memory (double
// buffered, so one barrier per step) while each thread prefetches the
// next step's values into registers, so the global loads of step t+1
// overlap the 2*Dh multiply-adds of step t.  Loads and stores are
// coalesced across j.
//
// Bound on an H100: bytes.  A call must read r, k, v, w once and write o
// and the final state once: 4 * (5*B*T*H*Dh + B*H*Dh*Dh) bytes, about
// 172 MB (0.051 ms at 3.35 TB/s) at B=8, T=512, H=32, Dh=64, against
// about 4*Dh^2 flops per (b, t, h), 2.1 GFLOP (0.032 ms at 67 TFLOP/s
// fp32).  This version is far from that bound: its T steps are
// dependent and it runs only B*H blocks of Dh threads (256 blocks of 64
// at the serve shape).  The chunked tensor-core form and more blocks
// per head (splitting the v axis) are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int DH>
__global__ void __launch_bounds__(DH)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ o,
            float* __restrict__ state, int64_t T, int H, int64_t sb,
            int64_t st, int64_t sh) {
  __shared__ float sr[2][DH], sk[2][DH], sw[2][DH], su[DH];
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int j = threadIdx.x;
  const int64_t in0 = b * sb + h * sh + j;                    // step 0
  const int64_t out0 = ((int64_t)b * T * H + h) * DH + j;    // contiguous o
  const int64_t ost = (int64_t)H * DH;

  su[j] = u[h * DH + j];
  float S[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) S[i] = 0.0f;

  float nr = 0.0f, nk = 0.0f, nv = 0.0f, nw = 0.0f;
  if (T > 0) {
    nr = r[in0]; nk = k[in0]; nv = v[in0]; nw = w[in0];
  }
  for (int64_t t = 0; t < T; ++t) {
    const int buf = (int)(t & 1);
    sr[buf][j] = nr;
    sk[buf][j] = nk;
    sw[buf][j] = nw;
    const float vj = nv;
    __syncthreads();
    if (t + 1 < T) {
      const int64_t off = in0 + (t + 1) * st;
      nr = r[off]; nk = k[off]; nv = v[off]; nw = w[off];
    }
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < DH; ++i) {
      const float kv = sk[buf][i] * vj;
      acc += sr[buf][i] * (S[i] + su[i] * kv);
      S[i] = sw[buf][i] * S[i] + kv;
    }
    o[out0 + t * ost] = acc;
  }
  float* sout = state + ((int64_t)blockIdx.x * DH) * DH + j;
#pragma unroll
  for (int i = 0; i < DH; ++i) sout[(int64_t)i * DH] = S[i];
}

template <int DH>
void launch(const float* r, const float* k, const float* v, const float* w,
            const float* u, float* o, float* state, int64_t B, int64_t T,
            int H, int64_t sb, int64_t st, int64_t sh, cudaStream_t s) {
  wkv6_kernel<DH><<<(unsigned int)(B * H), DH, 0, s>>>(
      r, k, v, w, u, o, state, T, H, sb, st, sh);
}

}  // namespace

// C interface for ctypes.  Strides are in elements.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a head dim without an instance; the caller
// skips the call when B * H == 0.
extern "C" int wkv6_forward(const float* r, const float* k, const float* v,
                            const float* w, const float* u, float* o,
                            float* state, int64_t B, int64_t T, int H,
                            int dh, int64_t sb, int64_t st, int64_t sh,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dh) {
    case 8: launch<8>(r, k, v, w, u, o, state, B, T, H, sb, st, sh, s); break;
    case 16: launch<16>(r, k, v, w, u, o, state, B, T, H, sb, st, sh, s); break;
    case 32: launch<32>(r, k, v, w, u, o, state, B, T, H, sb, st, sh, s); break;
    case 64: launch<64>(r, k, v, w, u, o, state, B, T, H, sb, st, sh, s); break;
    case 128: launch<128>(r, k, v, w, u, o, state, B, T, H, sb, st, sh, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
