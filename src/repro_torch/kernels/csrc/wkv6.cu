// RWKV-6 WKV recurrence for Hopper (sm_90a), in chunked form.
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
// the layout of the model's decode cache.
//
// The chunked form of the Pallas kernel (and of the model's wkv_chunked),
// with chunks of C = 16 steps.  Within a chunk, with cum the inclusive
// cumulative sum of log w over the chunk, ce the exclusive one, cl its
// last value (the kernel sums log2 w and raises 2 to the power):
//
//   q_eff = r * exp(ce)            k_in  = k * exp(-cum)
//   k_out = k * exp(cl - cum)      total = exp(cl)
//   A[t,s] = q_eff[t] . k_in[s] (s < t),   A[t,t] = sum_i r k u
//   o      = q_eff S + A v
//   S     <- diag(total) S + k_out^T v
//
// Steps past T (a ragged last chunk) take w = 1 and r = k = v = 0, so
// they add nothing and leave the state alone.  The factorization has no
// guard against exp(-cum) overflowing: the model clips the decay at
// w >= exp(-e^0.5) ~ 0.1924, where exp(+-cum) over 16 steps stays within
// 3e11, and it stays within float32 for any w >= 0.004.  (The Pallas
// kernel's default chunk of 32 reaches 8.2e22 at the clip floor.)
//
// Design.  One launch; a block owns VS = 32 value columns (Dh itself
// when Dh < 32) of one head's state and walks the chunks in order, its
// Dh x VS slice of S in registers (8 warps at Dh >= 64, each a band of
// rows; a lane holds RPT rows of one column).  The Dh / VS blocks of a
// head are neighbours in the grid (the slice index varies fastest), so
// their repeated reads of r, k and w come from L2.  Per chunk:
//   1. r, k, w (all Dh columns) and the block's v columns arrive in
//      shared memory by cp.async (16 B a thread where the pointers and
//      strides allow it, else 4 B), the next chunk's copy in flight while
//      the current one is multiplied;
//   2. log w and its cumulative sum over the chunk, then q_eff, k_in,
//      k_out, total and r k u, in shared memory (in the kernel: the JAX
//      wrapper's four pre-scaled tensors would be four more passes over
//      device memory, against a bound set by bytes);
//   3. the C x C matrix A, shared by the block's columns (each block of
//      the head recomputes it);
//   4. q_eff S, each lane's rows summed in registers, then over a warp's
//      row groups by shuffles (Dh < 32) and over the warps in shared
//      memory, plus A v, written to o;
//   5. S <- diag(total) S + k_out^T v in registers.
// Arithmetic is float32 on the CUDA cores: TF32 tensor cores would not
// hold the kernel's 1e-4 tolerance.  The cumulative sums are kept in
// log2 units (log2f, then exp2f: the hardware's ex2, 2 ulp whatever the
// argument), where expf's range reduction alone took most of the kernel's
// instructions and __expf errs by up to 2 + 1.2|x| ulp, 33 ulp at the
// clip floor's |x| = 26.  Registers are capped at 128 a thread, so 16
// warps of blocks fit an SM (cudaFuncGetAttributes on an H100: 128 at
// every head dim, a 16-byte spill at Dh = 128 only).
//
// Bound on an H100: bytes.  A call must read r, k, v, w once and write o
// and the final state once: 4 * (5*B*T*H*Dh + B*H*Dh*Dh) bytes, about
// 172 MB (0.051 ms at 3.35 TB/s) at B=8, T=512, H=32, Dh=64, against
// about 4*Dh^2 flops per (b, t, h), 2.1 GFLOP (0.032 ms at 67 TFLOP/s
// fp32).  The chunked form adds the C x C scores (Dh / VS times) and the
// exps; a chunk's steps are sequential within the block, so a single
// long sequence (few heads) is bound by latency, not by either.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kernel_attrs.cuh"

namespace {

constexpr int C = 16;             // steps a chunk
constexpr unsigned FULL = 0xffffffffu;

template <int DH>
struct Cfg {
  static constexpr int VS = DH < 32 ? DH : 32;   // value columns a block
  static constexpr int NS = DH / VS;             // blocks a head
  static constexpr int NW = DH >= 64 ? 8 : DH == 8 ? 2 : 4;   // warps
  static constexpr int NT = NW * 32;
  static constexpr int RW = DH / NW;             // state rows a warp
  static constexpr int IGW = 32 / VS;            // row groups a warp
  static constexpr int RPT = RW / IGW;           // state rows a thread
  static constexpr int TPC = NT / DH;            // threads a column (step 2)
  static constexpr int CT = C / TPC;             // steps a step-2 thread
  static constexpr int DP = DH + 4;              // padded row, 16 B aligned
  // shared floats: raw r, k, w; v (two buffers); q_eff, k_in, r k u
  // (padded); k_out; total; A; the warps' partial sums of q_eff S
  static constexpr int SMEM = 3 * C * DH + 2 * C * VS + 3 * C * DP + C * DH +
                              DH + C * (C + 1) + NW * C * VS;
  static_assert(RPT >= 1 && CT >= 1 && TPC <= 32, "layout");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// N consecutive floats of shared memory, in the widest aligned loads.
template <int N>
__device__ __forceinline__ void lds(float (&x)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      x[4 * q] = f.x;
      x[4 * q + 1] = f.y;
      x[4 * q + 2] = f.z;
      x[4 * q + 3] = f.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const float2 f = reinterpret_cast<const float2*>(p)[q];
      x[2 * q] = f.x;
      x[2 * q + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) x[q] = p[q];
  }
}

template <int DH>
__global__ void __launch_bounds__(Cfg<DH>::NT, 512 / Cfg<DH>::NT)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ o,
            float* __restrict__ state, int64_t T, int H, int64_t sb,
            int64_t st, int64_t sh, int vec) {
  using K = Cfg<DH>;
  constexpr int VS = K::VS, NW = K::NW, NT = K::NT, RPT = K::RPT;
  constexpr int TPC = K::TPC, CT = K::CT, DP = K::DP;
  extern __shared__ __align__(16) float sm[];
  float* rr = sm;                       // [C][DH] raw r
  float* kr = rr + C * DH;              // [C][DH] raw k
  float* wr = kr + C * DH;              // [C][DH] raw w
  float* vr = wr + C * DH;              // [2][C][VS]
  float* qe = vr + 2 * C * VS;          // [C][DP]
  float* kin = qe + C * DP;             // [C][DP]
  float* ru = kin + C * DP;             // [C][DP]
  float* ko = ru + C * DP;              // [C][DH]
  float* tot = ko + C * DH;             // [DH]
  float* As = tot + DH;                 // [C][C + 1]
  float* red = As + C * (C + 1);        // [NW][C][VS]

  const int slice = blockIdx.x % K::NS;
  const int bh = blockIdx.x / K::NS;
  const int b = bh / H, h = bh - b * H;
  const int j0 = slice * VS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ig = lane / VS, j = lane % VS;
  const int row0 = warp * K::RW + ig * RPT;    // this thread's state rows
  const int64_t in0 = b * sb + h * sh;
  const int n_chunks = (int)((T + C - 1) / C);

  auto load_chunk = [&](int c) {
    const int64_t t0 = (int64_t)c * C;
    float* vd = vr + (c & 1) * C * VS;
    if (vec) {
      constexpr int PIECES = DH / 4;        // 16-byte pieces of a row
      for (int idx = tid; idx < 3 * C * PIECES; idx += NT) {
        const int which = idx / (C * PIECES);
        const int rem = idx - which * C * PIECES;
        const int t = rem / PIECES, col = (rem - t * PIECES) * 4;
        const float* src = which == 0 ? r : which == 1 ? k : w;
        float* dst = which == 0 ? rr : which == 1 ? kr : wr;
        const bool ok = t0 + t < T;
        cp_async16(dst + t * DH + col, src + in0 + (ok ? t0 + t : 0) * st + col,
                   ok);
      }
      for (int idx = tid; idx < C * (VS / 4); idx += NT) {
        const int t = idx / (VS / 4), col = (idx - t * (VS / 4)) * 4;
        const bool ok = t0 + t < T;
        cp_async16(vd + t * VS + col,
                   v + in0 + (ok ? t0 + t : 0) * st + j0 + col, ok);
      }
    } else {
      for (int idx = tid; idx < 3 * C * DH; idx += NT) {
        const int which = idx / (C * DH), rem = idx - which * C * DH;
        const int t = rem / DH, col = rem - t * DH;
        const float* src = which == 0 ? r : which == 1 ? k : w;
        float* dst = which == 0 ? rr : which == 1 ? kr : wr;
        const bool ok = t0 + t < T;
        cp_async4(dst + t * DH + col, src + in0 + (ok ? t0 + t : 0) * st + col,
                  ok);
      }
      for (int idx = tid; idx < C * VS; idx += NT) {
        const int t = idx / VS, col = idx - t * VS;
        const bool ok = t0 + t < T;
        cp_async4(vd + t * VS + col,
                  v + in0 + (ok ? t0 + t : 0) * st + j0 + col, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // step 2's column and steps: threads tid / TPC of one column are
  // neighbouring lanes of one warp
  const int col = tid / TPC, part = tid % TPC, tb = part * CT;
  const float u_col = u[h * DH + col];

  float S[RPT];
#pragma unroll
  for (int m = 0; m < RPT; ++m) S[m] = 0.0f;

  if (n_chunks > 0) load_chunk(0);
  for (int c = 0; c < n_chunks; ++c) {
    const int64_t t0 = (int64_t)c * C;
    const float* vc = vr + (c & 1) * C * VS;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();                       // chunk c landed; c - 1 consumed

    // 2. log w, its cumulative sums, and the pre-scaled rows
    {
      float pre[CT];
      float run = 0.0f;
#pragma unroll
      for (int q = 0; q < CT; ++q) {
        const int t = tb + q;
        run += t0 + t < T ? log2f(fmaxf(wr[t * DH + col], 1e-38f)) : 0.0f;
        pre[q] = run;
      }
      float incl = run;                    // scan over the column's lanes
#pragma unroll
      for (int off = 1; off < TPC; off <<= 1) {
        const float y = __shfl_up_sync(FULL, incl, off, TPC);
        if (part >= off) incl += y;
      }
      float ce = __shfl_up_sync(FULL, incl, 1, TPC);
      if (part == 0) ce = 0.0f;
      const float cl = __shfl_sync(FULL, incl, TPC - 1, TPC);
      const float excl = ce;
#pragma unroll
      for (int q = 0; q < CT; ++q) {
        const int t = tb + q;
        const float ci = excl + pre[q];
        const float rv = rr[t * DH + col], kv = kr[t * DH + col];
        qe[t * DP + col] = rv * exp2f(ce);
        kin[t * DP + col] = kv * exp2f(-ci);
        ko[t * DH + col] = kv * exp2f(cl - ci);
        ru[t * DP + col] = rv * kv * u_col;
        ce = ci;
      }
      if (part == TPC - 1) tot[col] = exp2f(cl);
    }
    __syncthreads();                       // raw r, k, w consumed
    if (c + 1 < n_chunks) load_chunk(c + 1);

    // 3. A (lower triangle; the diagonal is the bonus term)
    for (int e = tid; e < C * C; e += NT) {
      const int t = e / C, s = e - t * C;
      if (s > t) continue;
      float acc = 0.0f;
      if (s < t) {
#pragma unroll
        for (int i = 0; i < DH; i += 4) {
          const float4 a4 = *reinterpret_cast<const float4*>(qe + t * DP + i);
          const float4 b4 = *reinterpret_cast<const float4*>(kin + s * DP + i);
          acc = fmaf(a4.x, b4.x, acc);
          acc = fmaf(a4.y, b4.y, acc);
          acc = fmaf(a4.z, b4.z, acc);
          acc = fmaf(a4.w, b4.w, acc);
        }
      } else {
#pragma unroll
        for (int i = 0; i < DH; i += 4) {
          const float4 a4 = *reinterpret_cast<const float4*>(ru + t * DP + i);
          acc += (a4.x + a4.y) + (a4.z + a4.w);
        }
      }
      As[t * (C + 1) + s] = acc;
    }

    // 4a. q_eff S over this thread's rows, summed over the warp's rows
#pragma unroll
    for (int t = 0; t < C; ++t) {
      float q[RPT];
      lds(q, qe + t * DP + row0);
      float p = 0.0f;
#pragma unroll
      for (int m = 0; m < RPT; ++m) p = fmaf(q[m], S[m], p);
#pragma unroll
      for (int off = VS; off < 32; off <<= 1)
        p += __shfl_xor_sync(FULL, p, off);
      if (ig == 0) red[(warp * C + t) * VS + j] = p;
    }
    // 5. S <- diag(total) S + k_out^T v
    {
      float tt[RPT];
      lds(tt, tot + row0);
#pragma unroll
      for (int m = 0; m < RPT; ++m) S[m] *= tt[m];
#pragma unroll
      for (int s = 0; s < C; ++s) {
        float kk[RPT];
        lds(kk, ko + s * DH + row0);
        const float vv = vc[s * VS + j];
#pragma unroll
        for (int m = 0; m < RPT; ++m) S[m] = fmaf(kk[m], vv, S[m]);
      }
    }
    __syncthreads();                       // A and the partial sums

    // 4b. o = q_eff S + A v
    for (int e = tid; e < C * VS; e += NT) {
      const int t = e / VS, jj = e - t * VS;
      if (t0 + t >= T) continue;
      float acc = 0.0f;
#pragma unroll
      for (int ww = 0; ww < NW; ++ww) acc += red[(ww * C + t) * VS + jj];
      for (int s = 0; s <= t; ++s)
        acc = fmaf(As[t * (C + 1) + s], vc[s * VS + jj], acc);
      o[((b * T + t0 + t) * H + h) * DH + j0 + jj] = acc;
    }
  }

  float* sout = state + ((int64_t)bh * DH + row0) * DH + j0 + j;
#pragma unroll
  for (int m = 0; m < RPT; ++m) sout[(int64_t)m * DH] = S[m];
}

template <int DH>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, float* o, float* state, int64_t B, int64_t T,
           int H, int64_t sb, int64_t st, int64_t sh, cudaStream_t s) {
  using K = Cfg<DH>;
  const size_t smem = K::SMEM * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = ((uintptr_t)r | (uintptr_t)k | (uintptr_t)v |
                   (uintptr_t)w) % 16 == 0 &&
                  sb % 4 == 0 && st % 4 == 0 && sh % 4 == 0;
  wkv6_kernel<DH><<<(unsigned int)(B * H * K::NS), K::NT, smem, s>>>(
      r, k, v, w, u, o, state, T, H, sb, st, sh, vec);
  return (int)cudaGetLastError();
}

const KernelEntry kKernels[] = {
    {"wkv6 Dh=8", (const void*)wkv6_kernel<8>},
    {"wkv6 Dh=16", (const void*)wkv6_kernel<16>},
    {"wkv6 Dh=32", (const void*)wkv6_kernel<32>},
    {"wkv6 Dh=64", (const void*)wkv6_kernel<64>},
    {"wkv6 Dh=128", (const void*)wkv6_kernel<128>},
};

}  // namespace

// C interface for ctypes.  Strides are in elements.  Returns the error of
// cudaFuncSetAttribute or cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for a head dim without an instance;
// the caller skips the call when B * H == 0.
extern "C" int wkv6_forward(const float* r, const float* k, const float* v,
                            const float* w, const float* u, float* o,
                            float* state, int64_t B, int64_t T, int H,
                            int dh, int64_t sb, int64_t st, int64_t sh,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dh) {
    case 8: return launch<8>(r, k, v, w, u, o, state, B, T, H, sb, st, sh, s);
    case 16: return launch<16>(r, k, v, w, u, o, state, B, T, H, sb, st, sh, s);
    case 32: return launch<32>(r, k, v, w, u, o, state, B, T, H, sb, st, sh, s);
    case 64: return launch<64>(r, k, v, w, u, o, state, B, T, H, sb, st, sh, s);
    case 128:
      return launch<128>(r, k, v, w, u, o, state, B, T, H, sb, st, sh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int wkv6_attrs(int i, int* out, const char** name) {
  return kernel_attrs(kKernels, (int)(sizeof(kKernels) / sizeof(kKernels[0])),
                      i, out, name);
}
