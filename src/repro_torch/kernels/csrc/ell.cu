// ELL-format semiring SpMV, SpMM and masked column select for Hopper
// (sm_90a).
//
// spmv_ell replaces the Pallas kernel repro/kernels/spmv.py:spmv_ell
// (_spmv_ell_kernel); spmm_ell replaces repro/kernels/spmm.py:spmm_ell
// (_spmm_ell_kernel); spgemm_sel replaces repro/kernels/spmm.py:spgemm_sel
// (_spgemm_sel_kernel).
//
//   y[r]    = (+)_k vals[r,k] (x) x[cols[r,k]]        (spmv)
//   Y[r, j] = (+)_k vals[r,k] (x) X[cols[r,k], j]     (spmm, X row-major (C, B))
//   Y[r, j] = (+)_k vals[r,k] (x) [cols[r,k] == sel[j]]   (spgemm_sel)
//
// Rings: 0 = plus_times, 1 = max_times.  Padding slots (col == -1) and
// columns >= C contribute nothing.  max_times starts from -inf so signed
// products are not clamped; a row with no contributing slot resolves to 0.
// Accumulation is fp32.
//
// Design: the TPU kernel gathers x[col] as a one-hot matmul because the
// MXU has no gather; here each thread gathers directly through the
// read-only cache.  spmv: one thread per row.  spmm: one thread per
// (row, j), j fastest, so a warp's reads of X[col, :] are contiguous.
//
// Bound on an H100: memory.  Each launch must read the ELL pack once,
// R*K*8 bytes (int32 col + fp32 val), plus the x / X values the
// columns touch, and write R*4 (R*B*4) bytes of output; it does 2 flops
// per slot (per query), far below the 67 TFLOP/s fp32 rate.  This
// version reads the pack with a stride of K across neighbouring threads
// and re-reads each pack slot once per query in spmm; making it approach
// the 3.35 TB/s bound (coalesced pack loads, one pack read per row for
// all B queries) is later work.
//
// spgemm_sel reduces only stored hits: under max_times a (row, j) whose
// hits are all negative keeps its negative maximum (a one-hot X in spmm
// would let the zeros of X clamp it), and a (row, j) with no hit is 0.
// The TPU kernel compares a (rows, B) tile per slot on the VPU.  Here one
// thread owns a row: it reads the row's K slots once per 8 entries of sel
// (once for B <= 8), holds 8 accumulators in registers, and compares each
// stored slot with the entries of sel, which the block stages in shared
// memory 256 at a time.  That avoids spmm's (row, j) threads re-reading
// the pack.  Bound on an H100: memory, R*K*8 bytes of pack read and R*B*4
// written (sel is B*4); the compares are integer work well under the
// rate of the CUDA cores for the B of batched column queries.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

template <int RING>
__global__ void spmv_ell_kernel(const int32_t* __restrict__ ecols,
                                const float* __restrict__ evals,
                                const float* __restrict__ x,
                                float* __restrict__ y,
                                int64_t n_rows, int k, int64_t n_cols) {
  int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int32_t* c = ecols + r * k;
  const float* v = evals + r * k;
  float acc = RING == 0 ? 0.0f : -CUDART_INF_F;
  for (int s = 0; s < k; ++s) {
    int32_t col = c[s];
    if (col < 0 || col >= n_cols) continue;
    float p = v[s] * __ldg(x + col);
    acc = RING == 0 ? acc + p : fmaxf(acc, p);
  }
  if (RING == 1 && acc == -CUDART_INF_F) acc = 0.0f;
  y[r] = acc;
}

template <int RING>
__global__ void spmm_ell_kernel(const int32_t* __restrict__ ecols,
                                const float* __restrict__ evals,
                                const float* __restrict__ X,
                                float* __restrict__ Y,
                                int64_t n_rows, int k, int64_t n_cols,
                                int b) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rows * b) return;
  int64_t r = t / b;
  int j = (int)(t - r * b);
  const int32_t* c = ecols + r * k;
  const float* v = evals + r * k;
  float acc = RING == 0 ? 0.0f : -CUDART_INF_F;
  for (int s = 0; s < k; ++s) {
    int32_t col = c[s];
    if (col < 0 || col >= n_cols) continue;
    float p = v[s] * __ldg(X + (int64_t)col * b + j);
    acc = RING == 0 ? acc + p : fmaxf(acc, p);
  }
  if (RING == 1 && acc == -CUDART_INF_F) acc = 0.0f;
  Y[t] = acc;
}

constexpr int kSelTile = 256;   // entries of sel staged in shared memory
constexpr int kAcc = 8;         // accumulators (entries of sel) a thread

template <int RING>
__global__ void spgemm_sel_kernel(const int32_t* __restrict__ ecols,
                                  const float* __restrict__ evals,
                                  const int32_t* __restrict__ sel,
                                  float* __restrict__ Y, int64_t n_rows,
                                  int k, int b) {
  __shared__ int32_t s_sel[kSelTile];
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int32_t* c = ecols + r * k;
  const float* v = evals + r * k;
  const float init = RING == 0 ? 0.0f : -CUDART_INF_F;
  for (int t0 = 0; t0 < b; t0 += kSelTile) {
    const int nt = b - t0 < kSelTile ? b - t0 : kSelTile;
    __syncthreads();                       // the previous tile is done
    for (int j = threadIdx.x; j < nt; j += blockDim.x) s_sel[j] = sel[t0 + j];
    __syncthreads();
    if (r >= n_rows) continue;
    for (int j0 = 0; j0 < nt; j0 += kAcc) {
      const int nq = nt - j0 < kAcc ? nt - j0 : kAcc;
      float acc[kAcc];
#pragma unroll
      for (int q = 0; q < kAcc; ++q) acc[q] = init;
      for (int s = 0; s < k; ++s) {
        const int32_t col = c[s];
        if (col < 0) continue;
        const float x = v[s];
#pragma unroll
        for (int q = 0; q < kAcc; ++q) {
          if (q < nq && col == s_sel[j0 + q])
            acc[q] = RING == 0 ? acc[q] + x : fmaxf(acc[q], x);
        }
      }
      float* y = Y + r * b + t0 + j0;
#pragma unroll
      for (int q = 0; q < kAcc; ++q) {
        if (q < nq) y[q] = (RING == 1 && acc[q] == -CUDART_INF_F) ? 0.0f
                                                                    : acc[q];
      }
    }
  }
}

constexpr int kThreads = 256;

unsigned int blocks_for(int64_t n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

// C interface for ctypes.  Each returns cudaGetLastError() after its
// launch (0 on success); the caller skips the call when there is no work.
extern "C" int ell_spmv(const int32_t* ecols, const float* evals,
                        const float* x, float* y, int64_t n_rows, int k,
                        int64_t n_cols, int ring, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ring == 0)
    spmv_ell_kernel<0><<<blocks_for(n_rows), kThreads, 0, s>>>(
        ecols, evals, x, y, n_rows, k, n_cols);
  else
    spmv_ell_kernel<1><<<blocks_for(n_rows), kThreads, 0, s>>>(
        ecols, evals, x, y, n_rows, k, n_cols);
  return (int)cudaGetLastError();
}

extern "C" int ell_spmm(const int32_t* ecols, const float* evals,
                        const float* X, float* Y, int64_t n_rows, int k,
                        int64_t n_cols, int b, int ring, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int64_t n = n_rows * b;
  if (ring == 0)
    spmm_ell_kernel<0><<<blocks_for(n), kThreads, 0, s>>>(
        ecols, evals, X, Y, n_rows, k, n_cols, b);
  else
    spmm_ell_kernel<1><<<blocks_for(n), kThreads, 0, s>>>(
        ecols, evals, X, Y, n_rows, k, n_cols, b);
  return (int)cudaGetLastError();
}

extern "C" int ell_spgemm_sel(const int32_t* ecols, const float* evals,
                              const int32_t* sel, float* Y, int64_t n_rows,
                              int k, int b, int ring, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ring == 0)
    spgemm_sel_kernel<0><<<blocks_for(n_rows), kThreads, 0, s>>>(
        ecols, evals, sel, Y, n_rows, k, b);
  else
    spgemm_sel_kernel<1><<<blocks_for(n_rows), kThreads, 0, s>>>(
        ecols, evals, sel, Y, n_rows, k, b);
  return (int)cudaGetLastError();
}
