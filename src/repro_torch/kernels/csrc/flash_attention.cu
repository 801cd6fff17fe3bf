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
// What it computes is the Pallas kernel's: the online-softmax state
// (m, l, acc) in float32 with m starting at NEG_INF = -1e30; s = (q . k)
// * Dh^-0.5; positions from indices (d = i - j, no position arrays); a
// masked score (causal: d < 0; window: d >= window) is set to NEG_INF,
// not -inf, so a run of fully masked keys before the first visible one
// adds exp(0) terms that the first visible key wipes out exactly (alpha =
// exp(-1e30 - m) = 0); o = acc / max(l, 1e-30).  Keys are folded in a
// tile at a time (one m, alpha and l update per tile), as the Pallas
// kernel folds its key tiles: the same function, rounded in another order.
//
// Skipping fully masked keys.  A block skips key tiles, and a warp skips
// keys, that no row it owns can see.  For a row with at least one visible
// key that changes nothing: masked keys after a visible one add
// exp(-1e30 - m) = 0, and those before it are wiped by alpha = 0.  Every
// causal row sees its own key, so causal rows never differ.  A row that
// sees no key at all (only with a window, at i >= Sk + window - 1)
// averages every value in the Pallas kernel and in the plain version; a
// block (and a warp) that holds such a row skips nothing, and so does the
// same.  Keys past Sk score -inf and add nothing.
//
// Two kernels, chosen by the input type (a dispatch on dtype, not a
// fallback: each type has exactly one kernel):
//
// bfloat16: tensor cores (flash_tc_kernel).  One block of 8 warps, each
// owning 16 q rows, packs the heads that share a kv head (up to 8 of
// them; recurrentgemma's 16 heads of one kv head make two blocks of 8
// heads x 16 positions), so the block's 128 rows share every K/V tile
// and each tile is read from L2 once for 128 rows.  Q.K^T and P.V run as
// mma.sync.m16n8k16 with bf16 operands and float32 accumulation; operands
// come from shared memory with ldmatrix (V with ldmatrix.trans).  The
// score fragment (16 x BK a warp, float32 registers) gets the online-
// softmax update in registers: row max and row sum over the 4 lanes of a
// quad (shfl_xor 1, 2), scores in log2 units so p = exp2(s - m); P is
// rounded to bf16 in place as the A operand of P.V (the only rounding
// besides the output's; l sums the float32 p), and the O accumulator (16
// x Dh a warp) stays in float32 registers: 128 a thread at Dh = 256, so Q
// stays in shared memory and is re-read with ldmatrix for each key tile.
// K and V tiles of BK keys are double-buffered in dynamic shared memory
// and filled with cp.async.cg (16 B a thread, zero-filled past Sk), the
// next tile in flight while the current one is multiplied.  Rows are
// padded by 16 B so the 8 rows an ldmatrix reads fall in distinct banks;
// the head dim is padded with zero columns in shared memory, never in
// device memory, to the next power of two (at least 16: the mma's
// k-dimension), the kernel's compile-time width.  BK = 64 keys a tile
// (32-key tiles measured about 5% slower on an H100, PERF.md).  Shared
// memory is (128 + 4 BK) (Dp + 8) 2 bytes, Dp the padded head dim: 198 KB
// at Dh = 256, one block an SM.  Registers at Dh = 256, as
// cudaFuncGetAttributes reports them on an H100 (chip_smoke logs them
// through flash_attention_attrs): 245 a thread, with no spills.  Blocks of
// late q tiles (the most keys under a causal mask) are scheduled first.
//
// float32: CUDA cores (flash_kernel).  TF32 tensor cores would not hold
// the float32 tolerance (2e-5), and the model serves bf16.  One block of
// 8 warps per (b, h) and 32 q rows; each warp owns 4 rows, with lanes
// splitting Dh (lane l holds dims l, l+32, ...).  K and V tiles of 64
// keys in dynamic shared memory, shared by the block's rows; a score is
// a per-lane partial dot product summed across the warp by shuffles.
//
// Bound on an H100: 4*Dh flops per visible (row, key) pair (q.k and
// p.v as multiply-adds) at 989 TFLOP/s bf16 (67 fp32), against q, k, v
// read and o written once at 3.35 TB/s.  At the serve shape (8, 512, 16,
// 256) with KV = 1, causal, that is 17.2 GFLOP (0.017 ms) against 71 MB
// (0.021 ms): bytes bound it there, by a hair; operations at longer
// sequences.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kernel_attrs.cuh"

namespace {

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

// The visible keys of row i are [lo_of(i), hi_of(i)]; empty only with a
// window, for i >= Sk + window - 1.  Both grow with i.
__device__ __forceinline__ int64_t lo_of(const Args& a, int64_t i) {
  return a.window ? (i - a.window + 1 > 0 ? i - a.window + 1 : 0) : 0;
}
__device__ __forceinline__ int64_t hi_of(const Args& a, int64_t i) {
  return a.causal ? (i < a.sk - 1 ? i : a.sk - 1) : a.sk - 1;
}
__device__ __forceinline__ bool row_empty(const Args& a, int64_t i) {
  return a.window && i >= a.sk + a.window - 1;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores.
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int NW = 8;             // warps per block, 16 q rows each
constexpr int BQ = NW * 16;       // rows of the Q tile
constexpr int NT = NW * 32;
constexpr int BK = 64;            // keys a K/V tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row-major) . b (16x8, column-major), bf16 in, f32 sum.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 gq + tq holds, of a
// 16x8 f32 tile, rows gq and gq + 8 at columns 2 tq and 2 tq + 1 (d[0..1]
// and d[2..3]); the A tile of P.V is built from two such score tiles.
//
// A block packs hp heads that share one kv head: warp w serves head
// h0 + w / wph at positions q0 + (w % wph) * 16 + [0, 16), with wph =
// NW / hp warps a head, so the block's 128 rows share every K/V tile.
// q_vec: q's base and strides allow 16-byte copies.
template <int DKP>
__global__ void __launch_bounds__(NT)
    flash_tc_kernel(Args a, int hp, int q_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dh = a.dh;
  constexpr int ld = DKP + 8;       // row stride: 16 B off the bank period
  bf16* qs = reinterpret_cast<bf16*>(smem);   // [BQ][ld]
  bf16* ks = qs + BQ * ld;                    // [2][BK][ld]
  bf16* vs = ks + 2 * BK * ld;                // [2][BK][ld]

  const int grp = a.h / a.kv;                 // heads a kv head
  const int wph = NW / hp;                    // warps a head
  const int n_grp = grp / hp;                 // blocks a kv head
  const int b = blockIdx.x / (a.kv * n_grp);
  const int rem = blockIdx.x - b * a.kv * n_grp;
  const int hk = rem / n_grp;
  const int h0 = hk * grp + (rem - hk * n_grp) * hp;
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * wph * 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int64_t sq = a.sq, sk = a.sk;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sqb;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.skb + hk * a.skh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.svb + hk * a.svh;

  // Columns dh..ld of every row are zero: the copies never write them.
  {
    const int padv = (ld - dh) / 8;
    for (int idx = tid; idx < (BQ + 4 * BK) * padv; idx += NT) {
      const int r = idx / padv, c = dh + (idx - r * padv) * 8;
      *reinterpret_cast<uint4*>(qs + r * ld + c) = make_uint4(0, 0, 0, 0);
    }
  }
  // Q-tile row R (warp R / 16) holds head h0 + (R / 16) / wph at position
  // q0 + ((R / 16) % wph) * 16 + R % 16.
  const int per_row = dh / 8;       // 16-byte pieces of a row
  const int unit = q_vec ? per_row : dh;     // copies a row
  for (int idx = tid; idx < BQ * unit; idx += NT) {
    const int R = idx / unit, w_ = R >> 4;
    const int64_t pos = q0 + (w_ % wph) * 16 + (R & 15);
    const bf16* src = qb + (h0 + w_ / wph) * a.sqh;
    const bool ok = pos < sq;
    if (q_vec) {
      const int c = (idx - R * unit) * 8;
      cp_async16(qs + R * ld + c, src + (ok ? pos : 0) * a.sqs + c, ok);
    } else {
      const int c = idx - R * unit;
      qs[R * ld + c] = ok ? src[pos * a.sqs + c] : __float2bfloat16(0.0f);
    }
  }

  // The block's key range: every key if a row sees none, else the union
  // of its rows' ranges; then the warp's own, the same way.
  const int64_t last = (q0 + wph * 16 < sq ? q0 + wph * 16 : sq) - 1;
  int64_t t_lo = 0, t_hi = sk - 1;
  if (!row_empty(a, last)) {
    t_lo = lo_of(a, q0);
    t_hi = hi_of(a, last);
  }
  t_lo = t_lo / BK * BK;
  const int n_tiles = (int)((t_hi - t_lo) / BK + 1);
  const int hq = h0 + warp / wph;
  const int64_t wr0 = q0 + (warp % wph) * 16;
  const int64_t wlast = (wr0 + 16 < sq ? wr0 + 16 : sq) - 1;
  const bool w_active = wr0 < sq;
  int64_t w_lo = 0, w_hi = sk - 1;
  if (w_active && !row_empty(a, wlast)) {
    w_lo = lo_of(a, wr0);
    w_hi = hi_of(a, wlast);
  }
  const int64_t ra = wr0 + gq, rb = wr0 + gq + 8;

  auto load_kv = [&](int stage, int64_t t0) {
    bf16* kd = ks + stage * BK * ld;
    bf16* vd = vs + stage * BK * ld;
    for (int idx = tid; idx < BK * per_row; idx += NT) {
      const int r = idx / per_row, c = (idx - r * per_row) * 8;
      const bool ok = t0 + r < sk;
      const int64_t key = ok ? t0 + r : 0;
      cp_async16(kd + r * ld + c, kp + key * a.sks + c, ok);
      cp_async16(vd + r * ld + c, vp + key * a.svs + c, ok);
    }
  };

  float o[DKP / 8][4];
#pragma unroll
  for (int d = 0; d < DKP / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  const float scale_log2 = a.scale * 1.4426950408889634f;

  load_kv(0, t_lo);
  cp_async_commit();                 // with the Q copies
  for (int it = 0; it < n_tiles; ++it) {
    const int64_t t0 = t_lo + (int64_t)it * BK;
    if (it + 1 < n_tiles) {
      load_kv((it + 1) & 1, t0 + BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                 // tile it (and Q) landed for all

    if (w_active && t0 <= w_hi && t0 + BK - 1 >= w_lo) {   // warp-uniform
      const bf16* kst = ks + (it & 1) * BK * ld;
      const bf16* vst = vs + (it & 1) * BK * ld;

      // S = Q K^T for the warp's 16 rows and the tile's BK keys.
      float s[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DKP / 16; ++kk) {
        uint32_t qa[4];
        ldsm_x4(qa, qs + (warp * 16 + (lane & 15)) * ld + kk * 16 +
                        (lane >> 4) * 8);
#pragma unroll
        for (int n2 = 0; n2 < BK / 16; ++n2) {
          uint32_t kb[4];
          ldsm_x4(kb, kst + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                          kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * n2], qa, kb[0], kb[1]);
          mma_bf16(s[2 * n2 + 1], qa, kb[2], kb[3]);
        }
      }

      // Scale to log2 units; mask unless every row of the warp sees every
      // key of the tile.
      const bool full = t0 + BK <= sk && !row_empty(a, wlast) &&
                        lo_of(a, wlast) <= t0 && t0 + BK - 1 <= hi_of(a, wr0);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if (!full) {
            const int64_t key = t0 + n * 8 + tq * 2 + (e & 1);
            const int64_t d = (e < 2 ? ra : rb) - key;
            if (key >= sk)
              x = -INFINITY;
            else if ((a.causal && d < 0) || (a.window && d >= a.window))
              x = NEG_INF;
          }
          s[n][e] = x;
        }
      }

      // Online softmax: rows ra (e = 0, 1) and rb (e = 2, 3).
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = NEG_INF;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * hh], s[n][2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float m_new = fmaxf(m[hh], mx);
        const float alpha = exp2f(m[hh] - m_new);
        m[hh] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          const float p0 = exp2f(s[n][2 * hh] - m_new);
          const float p1 = exp2f(s[n][2 * hh + 1] - m_new);
          s[n][2 * hh] = p0;
          s[n][2 * hh + 1] = p1;
          sum += p0 + p1;
        }
        l[hh] = l[hh] * alpha + sum;    // this lane's part of the row
#pragma unroll
        for (int d = 0; d < DKP / 8; ++d) {
          o[d][2 * hh] *= alpha;
          o[d][2 * hh + 1] *= alpha;
        }
      }

      // O += P V, P rounded to bf16 as the A operand.
#pragma unroll
      for (int k2 = 0; k2 < BK / 16; ++k2) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * k2][0], s[2 * k2][1]),
            pack_bf16(s[2 * k2][2], s[2 * k2][3]),
            pack_bf16(s[2 * k2 + 1][0], s[2 * k2 + 1][1]),
            pack_bf16(s[2 * k2 + 1][2], s[2 * k2 + 1][3])};
#pragma unroll
        for (int d2 = 0; d2 < DKP / 16; ++d2) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vst + (k2 * 16 + (lane & 7) +
                                   (((lane >> 3) & 1) << 3)) * ld +
                                d2 * 16 + ((lane >> 4) << 3));
          mma_bf16(o[2 * d2], pa, vb[0], vb[1]);
          mma_bf16(o[2 * d2 + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();                 // tile it consumed before reuse
  }

  bf16* op = static_cast<bf16*>(a.o);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lr = l[hh];
    lr += __shfl_xor_sync(FULL, lr, 1);
    lr += __shfl_xor_sync(FULL, lr, 2);
    lr = fmaxf(lr, 1e-30f);
    const int64_t row = hh ? rb : ra;
    if (!w_active || row >= sq) continue;
    bf16* orow = op + ((b * sq + row) * a.h + hq) * (int64_t)dh;
#pragma unroll
    for (int d = 0; d < DKP / 8; ++d) {
      const int col = d * 8 + tq * 2;
      if (col < dh)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[d][2 * hh] / lr, o[d][2 * hh + 1] / lr);
    }
  }
}

template <int DKP>
int launch(const Args& a, int64_t B, cudaStream_t s) {
  const size_t smem = (size_t)(BQ + 4 * BK) * (DKP + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<DKP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grp = a.h / a.kv;
  const int hp = grp % 8 == 0 ? 8 : grp % 4 == 0 ? 4 : grp % 2 == 0 ? 2 : 1;
  const int q_vec = (uintptr_t)a.q % 16 == 0 && a.sqb % 8 == 0 &&
                    a.sqs % 8 == 0 && a.sqh % 8 == 0;
  const int64_t qt = NW / hp * 16;            // positions a block
  const dim3 grid((unsigned int)(B * a.kv * (grp / hp)),
                  (unsigned int)((a.sq + qt - 1) / qt));
  flash_tc_kernel<DKP><<<grid, NT, smem, s>>>(a, hp, q_vec);
  return (int)cudaGetLastError();
}

// The padded head dim is the next power of two: the kernel's loops then
// unroll with no run-time bound (a guard per k-step would split them into
// blocks the compiler cannot schedule across).
int dispatch(const Args& a, int64_t B, cudaStream_t s) {
  if (a.dh <= 16) return launch<16>(a, B, s);
  if (a.dh <= 32) return launch<32>(a, B, s);
  if (a.dh <= 64) return launch<64>(a, B, s);
  if (a.dh <= 128) return launch<128>(a, B, s);
  if (a.dh <= 256) return launch<256>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: CUDA cores.
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int NW = 8;             // warps per block
constexpr int RPW = 4;            // q rows per warp
constexpr int BQ = NW * RPW;      // q rows per block
constexpr int BK = 64;            // keys per shared-memory tile

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
__device__ void load_tile(float* dst, const float* src, int64_t s_stride,
                          int n, int dh) {
  const int per_row = dh / 4;
  for (int idx = threadIdx.x; idx < n * per_row; idx += blockDim.x) {
    const int r = idx / per_row, c = (idx - r * per_row) * 4;
    *reinterpret_cast<float4*>(dst + r * dh + c) =
        *reinterpret_cast<const float4*>(src + r * s_stride + c);
  }
}

template <int DPL>
__global__ void __launch_bounds__(NW * 32)
flash_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + BK * a.dh;

  const int bh = blockIdx.x;
  const int b = bh / a.h, hq = bh - b * a.h;
  const int hk = hq / (a.h / a.kv);
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dh = a.dh;
  const int64_t sk = a.sk;
  const float* qp = static_cast<const float*>(a.q) + b * a.sqb + hq * a.sqh;
  const float* kp = static_cast<const float*>(a.k) + b * a.skb + hk * a.skh;
  const float* vp = static_cast<const float*>(a.v) + b * a.svb + hk * a.svh;
  // lo_of / hi_of / row_empty over the local sk: through the shared
  // helpers this kernel compiles differently and measured 12% slower on
  // an H100 (PERF.md).
  auto lo = [&](int64_t i) -> int64_t {
    return a.window ? (i - a.window + 1 > 0 ? i - a.window + 1 : 0) : 0;
  };
  auto hi = [&](int64_t i) -> int64_t {
    return a.causal ? (i < sk - 1 ? i : sk - 1) : sk - 1;
  };

  int64_t row[RPW], jlo[RPW], jhi[RPW];
  bool active[RPW], empty[RPW];
  float qr[RPW][DPL], acc[RPW][DPL], m[RPW], l[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    row[r] = q0 + warp * RPW + r;
    active[r] = row[r] < a.sq;
    jlo[r] = lo(row[r]);
    jhi[r] = hi(row[r]);
    empty[r] = active[r] && jlo[r] > jhi[r];
    m[r] = NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int u = 0; u < DPL; ++u) {
      const int d = lane + 32 * u;
      qr[r][u] = (active[r] && d < dh) ? qp[row[r] * a.sqs + d] : 0.0f;
      acc[r][u] = 0.0f;
    }
  }

  const int64_t last = (q0 + BQ < a.sq ? q0 + BQ : a.sq) - 1;
  int64_t t_lo = 0, t_hi = sk - 1;
  if (!(a.window && last >= sk + a.window - 1)) {
    t_lo = lo(q0);
    t_hi = hi(last);
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
        const float* kr = ks + (c + j) * dh;
        float kf[DPL];
#pragma unroll
        for (int u = 0; u < DPL; ++u) {
          const int d = lane + 32 * u;
          kf[u] = d < dh ? kr[d] : 0.0f;
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
        const float* vr = vs + (c + j) * dh;
        float vf[DPL];
#pragma unroll
        for (int u = 0; u < DPL; ++u) {
          const int d = lane + 32 * u;
          vf[u] = d < dh ? vr[d] : 0.0f;
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

  float* op = static_cast<float*>(a.o);
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (!active[r]) continue;
    const float lr = fmaxf(l[r], 1e-30f);
    float* orow = op + ((b * a.sq + row[r]) * a.h + hq) * (int64_t)dh;
#pragma unroll
    for (int u = 0; u < DPL; ++u) {
      const int d = lane + 32 * u;
      if (d < dh) orow[d] = acc[r][u] / lr;
    }
  }
}

template <int DPL>
int launch(const Args& a, int64_t B, cudaStream_t s) {
  const size_t smem = 2 * (size_t)BK * a.dh * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)(B * a.h),
                  (unsigned int)((a.sq + BQ - 1) / BQ));
  flash_kernel<DPL><<<grid, NW * 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(const Args& a, int64_t B, cudaStream_t s) {
  switch ((a.dh + 31) / 32) {
    case 1: return launch<1>(a, B, s);
    case 2: return launch<2>(a, B, s);
    case 3: return launch<3>(a, B, s);
    case 4: return launch<4>(a, B, s);
    case 5: return launch<5>(a, B, s);
    case 6: return launch<6>(a, B, s);
    case 7: return launch<7>(a, B, s);
    case 8: return launch<8>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace f32

const KernelEntry kKernels[] = {
    {"flash_attention bf16 Dh<=16",
     (const void*)tc::flash_tc_kernel<16>},
    {"flash_attention bf16 Dh<=32",
     (const void*)tc::flash_tc_kernel<32>},
    {"flash_attention bf16 Dh<=64",
     (const void*)tc::flash_tc_kernel<64>},
    {"flash_attention bf16 Dh<=128",
     (const void*)tc::flash_tc_kernel<128>},
    {"flash_attention bf16 Dh<=256",
     (const void*)tc::flash_tc_kernel<256>},
    {"flash_attention f32 Dh<=32",
     (const void*)f32::flash_kernel<1>},
    {"flash_attention f32 Dh<=64",
     (const void*)f32::flash_kernel<2>},
    {"flash_attention f32 Dh<=96",
     (const void*)f32::flash_kernel<3>},
    {"flash_attention f32 Dh<=128",
     (const void*)f32::flash_kernel<4>},
    {"flash_attention f32 Dh<=160",
     (const void*)f32::flash_kernel<5>},
    {"flash_attention f32 Dh<=192",
     (const void*)f32::flash_kernel<6>},
    {"flash_attention f32 Dh<=224",
     (const void*)f32::flash_kernel<7>},
    {"flash_attention f32 Dh<=256",
     (const void*)f32::flash_kernel<8>},
};

}  // namespace

// C interface for ctypes.  Strides are in elements; dtype 0 is float32
// (CUDA-core kernel), 1 is bfloat16 (tensor-core kernel); k and v
// pointers and strides must be 16-byte aligned (the caller checks).
// Returns the error of cudaFuncSetAttribute or cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for a head dim past
// 256 or an unknown dtype.  The caller checks shapes and skips the call
// when B*H*Sq == 0.
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, void* o, int64_t B,
    int64_t Sq, int64_t Sk, int H, int KV, int dh, int64_t sqb, int64_t sqs,
    int64_t sqh, int64_t skb, int64_t sks, int64_t skh, int64_t svb,
    int64_t svs, int64_t svh, int causal, int window, float scale,
    int dtype, void* stream) {
  Args a{q, k, v, o, Sq, Sk, H, KV, dh, sqb, sqs, sqh, skb, sks, skh,
         svb, svs, svh, causal, window, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return f32::dispatch(a, B, s);
  if (dtype == 1) return tc::dispatch(a, B, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_attrs(int i, int* out, const char** name) {
  return kernel_attrs(kKernels, (int)(sizeof(kKernels) / sizeof(kKernels[0])),
                      i, out, name);
}
