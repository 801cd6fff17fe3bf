// Segmented sums for Hopper (sm_90a): out[s] = sum_{i: ids[i] == s} vals[i].
//
// segsum replaces the Pallas kernel repro/kernels/segsum.py:segsum
// (_segsum_kernel); segsum_windowed replaces
// repro/kernels/segsum.py:segsum_windowed (_windowed_kernel and its XLA
// spill pass).
//
// Semantics: ids are int32; vals float32 or bf16, summed in fp32 into a
// float32 (num_segments,) output that the caller has zeroed.  Ids outside
// [0, num_segments) contribute nothing (this drops the ELL's -1 padding).
// segsum takes ids in any order; segsum_windowed requires them ascending.
//
// Design.  The TPU kernels turn the scatter into a one-hot matmul on the
// MXU, tiled over (segment tile, nnz block), because the TPU has no
// scatter; the windowed one only bounds which output tiles a sorted block
// can touch.  A GPU scatters directly.
//   segsum: a grid-stride loop over nnz, one element per thread per step,
//     into a per-block table of kSlots partial sums in shared memory.  An
//     id hashes to one slot; the first id to reach an empty slot claims
//     it (atomicCAS), and later elements of that id add there with a
//     shared-memory atomic.  An element whose slot another id holds adds
//     straight to out[id].  At the end each block adds its claimed slots
//     to out.  The pipeline's row-major incidence pack puts a few hot
//     columns (a protocol, a flag word, common ports and lengths) in
//     nearly every packet; they appear in a block's first packets, so
//     they claim their slots early and reach device memory once a block
//     instead of once an element.  That also keeps their float sums
//     short: a block adds a few thousand values, then the grid adds one
//     partial per block, instead of millions of ordered atomic adds.
//   segsum_windowed: a sorted reduce-by-key.  Each warp owns a contiguous
//     range of 32 x kRows elements (a block owns kWarps such ranges in a
//     row) and walks it a row of 32 at a time: a segmented shuffle
//     reduction sums the runs inside the row, and the run that reaches
//     the row's end is carried in registers into the next row.  A run
//     that lies wholly inside the range is written with a plain store (it
//     is the only writer of that segment, as the ids are sorted); only the
//     range's first and last run, which may continue in the neighbouring
//     range, go through atomicAdd.  The TPU's two-tile output window and
//     spill pass have no counterpart: any spread of ids is handled alike.
//
// Bound on an H100: memory.  Both read each id and value once (nnz * 8
// bytes for fp32 values, nnz * 6 for bf16) and write the output once
// (num_segments * 4 bytes, the zeroing included); one add per element is
// far below the fp32 rate.  Atomics to one address serialise in L2, which
// the slot table (segsum) and the run sums (segsum_windowed) avoid for
// the repeated ids the pipeline produces.  Float atomics make the order
// of a segment's sum vary from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_attrs.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                 // rows of 32 per warp's range
constexpr int32_t kNone = INT32_MIN;      // id of lanes past nnz; free slot
constexpr int kSlotBits = 11;
constexpr int kSlots = 1 << kSlotBits;    // segsum's partial sums a block
constexpr int64_t kPerBlock = 4096;       // segsum's least elements a block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Segmented suffix sum over the warp: on return, a lane that starts a run
// of equal ids (lane 0 or an id unlike its left neighbour's) holds the sum
// of its run's values.  Returns the ballot of run heads.  All 32 lanes
// must take part.
__device__ __forceinline__ unsigned run_sums(int32_t id, float& v, int lane) {
  int32_t left = __shfl_up_sync(kFull, id, 1);
  unsigned heads = __ballot_sync(kFull, lane == 0 || left != id);
  unsigned after = heads & ~((2u << lane) - 1u);    // heads right of lane
  int end = after ? __ffs(after) - 1 : 32;          // one past lane's run
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    float o = __shfl_down_sync(kFull, v, off);
    if (lane + off < end) v += o;
  }
  return heads;
}

template <typename T>
__global__ void segsum_kernel(const int32_t* __restrict__ ids,
                              const T* __restrict__ vals,
                              float* __restrict__ out, int64_t nnz,
                              int64_t n_seg) {
  __shared__ int32_t s_id[kSlots];
  __shared__ float s_sum[kSlots];
  for (int j = threadIdx.x; j < kSlots; j += blockDim.x) {
    s_id[j] = kNone;
    s_sum[j] = 0.0f;
  }
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nnz;
       i += stride) {
    const int32_t id = __ldg(ids + i);
    if (id < 0 || id >= n_seg) continue;
    const float v = to_f32(vals[i]);
    const int slot = (int)(((uint32_t)id * 2654435761u) >> (32 - kSlotBits));
    // A claimed slot never changes hands, so a stale kNone only costs a CAS.
    int32_t owner = *(volatile int32_t*)(s_id + slot);
    if (owner == kNone) {
      const int32_t old = atomicCAS(s_id + slot, kNone, id);
      owner = old == kNone ? id : old;
    }
    if (owner == id)
      atomicAdd(s_sum + slot, v);
    else
      atomicAdd(out + id, v);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kSlots; j += blockDim.x)
    if (s_id[j] != kNone) atomicAdd(out + s_id[j], s_sum[j]);
}

__device__ __forceinline__ void put(float* out, int32_t id, float v,
                                    int64_t n_seg, bool shared) {
  if (id < 0 || id >= n_seg) return;
  if (shared)
    atomicAdd(out + id, v);
  else
    out[id] = v;
}

template <typename T>
__global__ void segsum_windowed_kernel(const int32_t* __restrict__ ids,
                                       const T* __restrict__ vals,
                                       float* __restrict__ out, int64_t nnz,
                                       int64_t n_seg) {
  const int lane = threadIdx.x & 31;
  const int64_t span = 32 * kRows;
  const int64_t base =
      ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * span;
  if (base >= nnz) return;                            // whole warp
  const int64_t stop = base + span < nnz ? base + span : nnz;
  // The range's first run may have begun in the range before it, and its
  // last run may go on into the next: those two are written atomically.
  const int32_t first_id = __ldg(ids + base);
  const int32_t last_id = __ldg(ids + stop - 1);
  const bool open_before = base > 0 && __ldg(ids + base - 1) == first_id;
  const bool open_after = stop < nnz && __ldg(ids + stop) == last_id;
  auto shared = [&](int32_t id) {
    return (open_before && id == first_id) || (open_after && id == last_id);
  };

  int32_t carry_id = kNone;                           // warp-uniform
  float carry = 0.0f;
  for (int64_t row = base; row < stop; row += 32) {
    const int64_t i = row + lane;
    int32_t id = kNone;
    float v = 0.0f;
    if (i < stop) {
      id = __ldg(ids + i);
      v = to_f32(vals[i]);
    }
    unsigned heads = run_sums(id, v, lane);
    const int32_t id0 = __shfl_sync(kFull, id, 0);
    if (lane == 0) {
      if (id0 == carry_id)
        v += carry;                                   // the run goes on
      else if (carry_id != kNone)
        put(out, carry_id, carry, n_seg, shared(carry_id));
    }
    const int last = 31 - __clz(heads);               // head of open run
    if ((heads >> lane & 1u) && lane != last)
      put(out, id, v, n_seg, shared(id));
    carry_id = __shfl_sync(kFull, id, last);
    carry = __shfl_sync(kFull, v, last);
  }
  if (lane == 0 && carry_id != kNone)
    put(out, carry_id, carry, n_seg, shared(carry_id));
}

unsigned int grid_for(int64_t n, int64_t per_block, int64_t cap) {
  int64_t g = (n + per_block - 1) / per_block;
  return (unsigned int)(g < cap ? g : cap);
}

template <typename T>
int launch_segsum(const int32_t* ids, const void* vals, float* out,
                  int64_t nnz, int64_t n_seg, bool windowed,
                  cudaStream_t s) {
  const T* v = static_cast<const T*>(vals);
  if (windowed)
    segsum_windowed_kernel<T>
        <<<grid_for(nnz, (int64_t)kWarps * 32 * kRows, INT32_MAX), kThreads,
           0, s>>>(ids, v, out, nnz, n_seg);
  else
    segsum_kernel<T><<<grid_for(nnz, kPerBlock, 132 * 8), kThreads, 0, s>>>(
        ids, v, out, nnz, n_seg);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  vals_bf16 selects bf16 values (else fp32).
// Each returns cudaGetLastError() after its launch (0 on success); the
// caller zeroes out and skips the call when nnz is 0.
extern "C" int segsum_forward(const int32_t* ids, const void* vals,
                              float* out, int64_t nnz, int64_t n_seg,
                              int vals_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return vals_bf16
             ? launch_segsum<__nv_bfloat16>(ids, vals, out, nnz, n_seg, false,
                                            s)
             : launch_segsum<float>(ids, vals, out, nnz, n_seg, false, s);
}

extern "C" int segsum_windowed_forward(const int32_t* ids, const void* vals,
                                       float* out, int64_t nnz,
                                       int64_t n_seg, int vals_bf16,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return vals_bf16
             ? launch_segsum<__nv_bfloat16>(ids, vals, out, nnz, n_seg, true,
                                            s)
             : launch_segsum<float>(ids, vals, out, nnz, n_seg, true, s);
}

namespace {

const KernelEntry kKernels[] = {
    {"segsum f32", (const void*)segsum_kernel<float>},
    {"segsum bf16", (const void*)segsum_kernel<__nv_bfloat16>},
    {"segsum_windowed f32", (const void*)segsum_windowed_kernel<float>},
    {"segsum_windowed bf16",
     (const void*)segsum_windowed_kernel<__nv_bfloat16>},
};

}  // namespace

extern "C" int segsum_attrs(int i, int* out, const char** name) {
  return kernel_attrs(kKernels, (int)(sizeof(kKernels) / sizeof(kKernels[0])),
                      i, out, name);
}
