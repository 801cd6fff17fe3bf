// Blocked online-softmax (flash) attention for Hopper (sm_90a).
//
// flash_attention replaces the Pallas kernel
// repro/kernels/flash_attention.py:flash_attention (_flash_kernel).
// q: (B, Sq, H, Dh), k and v: (B, Sk, KV, Dh), float32 or bfloat16, last
// axis unit-stride, the other axes at the strides the caller passes (the
// model's own layout: no transpose to (B*H, S, Dh)); H % KV == 0 and
// head h reads kv head h / (H / KV), so K and V are never repeated in
// memory.  Writes o as a contiguous (B, Sq, H, Dh) of q's type.
//
// What it computes is the Pallas kernel's: inputs upcast to float32; the
// online-softmax state (m, l, acc) in float32 with m starting at
// NEG_INF = -1e30; s = (q . k) * Dh^-0.5; positions from indices
// (d = i - j, no position arrays); a masked score (causal: d < 0; window:
// d >= window) is set to NEG_INF, not -inf, so a run of fully masked keys
// before the first visible one adds exp(0) terms that the first visible
// key wipes out exactly (alpha = exp(-1e30 - m) = 0); o = acc / max(l,
// 1e-30).  Keys are folded in 32 at a time (one m, alpha and l update per
// 32 keys) where the Pallas kernel folds a whole tile: the same function,
// rounded in another order.
//
// Skipping fully masked keys.  A block skips key tiles, and a warp skips
// 32-key chunks, that no row it owns can see.  For a row with at least
// one visible key that changes nothing: masked keys after a visible one
// add exp(-1e30 - m) = 0, and those before it are wiped by alpha = 0.
// Every causal row sees its own key, so causal rows never differ.  A row
// that sees no key at all (only with a window, at i >= Sk + window - 1)
// averages every value in the Pallas kernel and in the plain version;
// a block that holds such a row skips nothing, and so does the same.
//
// Design (simple first; wgmma and TMA come later): one block of 8 warps
// per (b, h) and 32 q rows; each warp owns 4 rows, with lanes splitting
// Dh (lane l holds dims l, l+32, ...), so q and the accumulator of a row
// take ceil(Dh/32) registers a lane (8 at Dh = 256).  K and V tiles of 64
// keys are staged in shared memory in the input type and shared by the
// block's 32 rows: 64 KB at Dh = 256 in bf16 (128 KB in f32), above the
// 48 KB static limit, so the launch raises the kernel's dynamic
// shared-memory limit with cudaFuncSetAttribute first.  A score is a
// per-lane partial dot product summed across the warp by shuffles; lane j
// keeps key j's score, so the chunk's exp runs once per lane.  Arithmetic
// is float32 on the CUDA cores.  Blocks of late q tiles (the most keys
// under a causal mask) are scheduled first.
//
// Bound on an H100: 4*Dh flops per visible (row, key) pair (q.k and
// p.v as multiply-adds) at 989 TFLOP/s bf16, against q, k, v read and o
// written once at 3.35 TB/s.  At the serve shape (8, 512, 16, 256) with
// KV = 1, causal, that is 17.2 GFLOP (0.017 ms) against 71 MB (0.021 ms):
// bytes bound it there, by a hair; operations at longer sequences.  This
// version uses no tensor cores and is far from either.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;             // warps per block
constexpr int RPW = 4;            // q rows per warp
constexpr int BQ = NW * RPW;      // q rows per block
constexpr int BK = 64;            // keys per shared-memory tile
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t sq, sk;
  int h, kv, dh;
  int64_t sqb, sqs, sqh, skb, sks, skh, svb, svs, svh;
  int causal, window;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// Copy keys [t0, t0 + n) of one kv head into a (BK, dh) tile, 16 bytes
// a thread (the caller checks that pointers and strides allow it).
template <typename T>
__device__ void load_tile(T* dst, const T* src, int64_t s_stride, int n,
                          int dh) {
  constexpr int E = 16 / sizeof(T);
  const int per_row = dh / E;
  for (int idx = threadIdx.x; idx < n * per_row; idx += blockDim.x) {
    const int r = idx / per_row, c = (idx - r * per_row) * E;
    *reinterpret_cast<uint4*>(dst + r * dh + c) =
        *reinterpret_cast<const uint4*>(src + r * s_stride + c);
  }
}

template <typename T, int DPL>
__global__ void __launch_bounds__(NW * 32)
flash_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + BK * a.dh;

  const int bh = blockIdx.x;
  const int b = bh / a.h, hq = bh - b * a.h;
  const int hk = hq / (a.h / a.kv);
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dh = a.dh;
  const int64_t sk = a.sk;
  const T* qp = static_cast<const T*>(a.q) + b * a.sqb + hq * a.sqh;
  const T* kp = static_cast<const T*>(a.k) + b * a.skb + hk * a.skh;
  const T* vp = static_cast<const T*>(a.v) + b * a.svb + hk * a.svh;

  // The visible keys of row i are [lo(i), hi(i)]; empty only with a
  // window, for i >= Sk + window - 1.
  auto lo_of = [&](int64_t i) -> int64_t {
    return a.window ? (i - a.window + 1 > 0 ? i - a.window + 1 : 0) : 0;
  };
  auto hi_of = [&](int64_t i) -> int64_t {
    return a.causal ? (i < sk - 1 ? i : sk - 1) : sk - 1;
  };

  int64_t row[RPW], jlo[RPW], jhi[RPW];
  bool active[RPW], empty[RPW];
  float qr[RPW][DPL], acc[RPW][DPL], m[RPW], l[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    row[r] = q0 + warp * RPW + r;
    active[r] = row[r] < a.sq;
    jlo[r] = lo_of(row[r]);
    jhi[r] = hi_of(row[r]);
    empty[r] = active[r] && jlo[r] > jhi[r];
    m[r] = NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int u = 0; u < DPL; ++u) {
      const int d = lane + 32 * u;
      qr[r][u] = (active[r] && d < dh) ? to_f(qp[row[r] * a.sqs + d]) : 0.0f;
      acc[r][u] = 0.0f;
    }
  }

  // The block's key range: every key if a row sees none, else the union
  // of its rows' ranges (lo and hi grow with i).
  const int64_t last = (q0 + BQ < a.sq ? q0 + BQ : a.sq) - 1;
  const bool block_empty = a.window && last >= sk + a.window - 1;
  int64_t t_lo = 0, t_hi = sk - 1;
  if (!block_empty) {
    t_lo = lo_of(q0);
    t_hi = hi_of(last);
  }
  t_lo = t_lo / BK * BK;

  for (int64_t t0 = t_lo; t0 <= t_hi; t0 += BK) {
    const int n = (int)(sk - t0 < BK ? sk - t0 : BK);
    __syncthreads();                     // the previous tile is consumed
    load_tile(ks, kp + t0 * a.sks, a.sks, n, dh);
    load_tile(vs, vp + t0 * a.svs, a.svs, n, dh);
    __syncthreads();

    for (int c = 0; c < n; c += 32) {
      const int64_t c0 = t0 + c;
      bool need = false;
#pragma unroll
      for (int r = 0; r < RPW; ++r)
        need |= active[r] &&
                (empty[r] || (c0 <= jhi[r] && c0 + 31 >= jlo[r]));
      if (!need) continue;               // warp-uniform
      const int nc = n - c < 32 ? n - c : 32;

      // scores: lane j keeps key c0 + j's; keys past Sk stay -inf
      float mine[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) mine[r] = -INFINITY;
      for (int j = 0; j < nc; ++j) {
        const T* kr = ks + (c + j) * dh;
        float kf[DPL];
#pragma unroll
        for (int u = 0; u < DPL; ++u) {
          const int d = lane + 32 * u;
          kf[u] = d < dh ? to_f(kr[d]) : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          float part = 0.0f;
#pragma unroll
          for (int u = 0; u < DPL; ++u) part = fmaf(qr[r][u], kf[u], part);
          float s = warp_sum(part) * a.scale;
          const int64_t dist = row[r] - (c0 + j);
          const bool ok = (!a.causal || dist >= 0) &&
                          (!a.window || dist < a.window);
          if (lane == j) mine[r] = ok ? s : NEG_INF;
        }
      }

      // online-softmax update, one per row and chunk
      float p[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float m_new = fmaxf(m[r], warp_max(mine[r]));
        const float alpha = expf(m[r] - m_new);
        p[r] = expf(mine[r] - m_new);
        l[r] = l[r] * alpha + warp_sum(p[r]);
        m[r] = m_new;
#pragma unroll
        for (int u = 0; u < DPL; ++u) acc[r][u] *= alpha;
      }
      for (int j = 0; j < nc; ++j) {
        const T* vr = vs + (c + j) * dh;
        float vf[DPL];
#pragma unroll
        for (int u = 0; u < DPL; ++u) {
          const int d = lane + 32 * u;
          vf[u] = d < dh ? to_f(vr[d]) : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const float pj = __shfl_sync(FULL, p[r], j);
#pragma unroll
          for (int u = 0; u < DPL; ++u) acc[r][u] = fmaf(pj, vf[u], acc[r][u]);
        }
      }
    }
  }

  T* op = static_cast<T*>(a.o);
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (!active[r]) continue;
    const float lr = fmaxf(l[r], 1e-30f);
    T* orow = op + ((b * a.sq + row[r]) * a.h + hq) * (int64_t)dh;
#pragma unroll
    for (int u = 0; u < DPL; ++u) {
      const int d = lane + 32 * u;
      if (d < dh) store(orow + d, acc[r][u] / lr);
    }
  }
}

template <typename T, int DPL>
int launch(const Args& a, int64_t B, cudaStream_t s) {
  const size_t smem = 2 * (size_t)BK * a.dh * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)(B * a.h),
                  (unsigned int)((a.sq + BQ - 1) / BQ));
  flash_kernel<T, DPL><<<grid, NW * 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int64_t B, cudaStream_t s) {
  switch ((a.dh + 31) / 32) {
    case 1: return launch<T, 1>(a, B, s);
    case 2: return launch<T, 2>(a, B, s);
    case 3: return launch<T, 3>(a, B, s);
    case 4: return launch<T, 4>(a, B, s);
    case 5: return launch<T, 5>(a, B, s);
    case 6: return launch<T, 6>(a, B, s);
    case 7: return launch<T, 7>(a, B, s);
    case 8: return launch<T, 8>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface for ctypes.  Strides are in elements; dtype 0 is float32,
// 1 is bfloat16; k and v pointers and strides must be 16-byte aligned
// (the caller checks).  Returns the error of cudaFuncSetAttribute or
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a head dim past 256 or an unknown dtype.  The
// caller checks shapes and skips the call when B*H*Sq == 0.
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, void* o, int64_t B,
    int64_t Sq, int64_t Sk, int H, int KV, int dh, int64_t sqb, int64_t sqs,
    int64_t sqh, int64_t skb, int64_t sks, int64_t skh, int64_t svb,
    int64_t svs, int64_t svh, int causal, int window, float scale,
    int dtype, void* stream) {
  Args a{q, k, v, o, Sq, Sk, H, KV, dh, sqb, sqs, sqh, skb, sks, skh,
         svb, svs, svh, causal, window, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(a, B, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
