// Variants of the unsorted segmented sum, for timing on the card by
// scripts/segsum_variants.py: which part of the per-block slot table
// design sets its time, and candidates that remove it.  float32 values.
//
//   0 z  zero the output only (cudaMemsetAsync)
//   1 a  the first design: per-block table of 2,048 slots that an id claims
//        on first sighting (atomicCAS), shared-memory atomicAdd per element
//        of a claimed id, global atomicAdd for the others
//   2 b  loads only: each thread sums its valid values, one store a thread
//   3 c  every element a global atomicAdd, no table
//   4 d  (a) with the global atomics of unclaimed ids taken out
//   5 e  warp aggregation (__match_any_sync on the id, the group's sum in
//        lane order) before (a)'s table: one shared atomic per distinct id
//        in a warp step
//   6 f  warp aggregation, then a per-warp direct-mapped table of 512
//        slots with plain loads and stores (no shared atomics): a hit adds,
//        a miss sends the slot's old sum to out with a global atomic and
//        takes the slot
//   7 g  (f) with 16-byte loads, four elements a lane a step
//   8 h  (e) with 16-byte loads, four elements a lane a step
//   9 w  the first segsum_windowed (reduce-by-key, atomics at a warp
//        range's edges) after a zeroing memset
//  10 k  (a) behind a cache of kCache ids and sums in each thread's
//        registers: an id whose slot it holds is taken into the cache, so
//        a hot id's elements add in registers and reach shared memory only
//        when the cache evicts it (round robin); one element a thread a step
//  11 l  (k) with 16-byte loads, four elements a thread a step
//  12 m  (l) with one block of 1024 threads an SM and a table of 16,384
//        slots in dynamic shared memory
//  13 n  (m) claiming a slot only on an id's second sighting in the block
//        (a direct-mapped table of 16,384 last-seen ids)
//  14 o  (m) without the register cache: every element of a claimed id a
//        shared atomic
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kNone = INT32_MIN;
constexpr int kSlotBits = 11;
constexpr int kSlots = 1 << kSlotBits;
constexpr int kWSlotBits = 9;
constexpr int kWSlots = 1 << kWSlotBits;
constexpr int kRows = 16;
constexpr int64_t kPerBlock = 4096;

__device__ __forceinline__ int hash_slot(int32_t id, int bits) {
  return (int)(((uint32_t)id * 2654435761u) >> (32 - bits));
}

template <bool kGlobal>
__global__ void table_kernel(const int32_t* __restrict__ ids,
                             const float* __restrict__ vals,
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
    const float v = vals[i];
    const int slot = hash_slot(id, kSlotBits);
    int32_t owner = *(volatile int32_t*)(s_id + slot);
    if (owner == kNone) {
      const int32_t old = atomicCAS(s_id + slot, kNone, id);
      owner = old == kNone ? id : old;
    }
    if (owner == id)
      atomicAdd(s_sum + slot, v);
    else if (kGlobal)
      atomicAdd(out + id, v);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kSlots; j += blockDim.x)
    if (s_id[j] != kNone) atomicAdd(out + s_id[j], s_sum[j]);
}

__global__ void read_floor_kernel(const int32_t* __restrict__ ids,
                                  const float* __restrict__ vals,
                                  float* __restrict__ out, int64_t nnz,
                                  int64_t n_seg) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  float acc = 0.0f;
  for (int64_t i = g; i < nnz; i += stride) {
    const int32_t id = __ldg(ids + i);
    if (id >= 0 && id < n_seg) acc += vals[i];
  }
  if (g < n_seg) out[g] = acc;
}

__global__ void direct_kernel(const int32_t* __restrict__ ids,
                              const float* __restrict__ vals,
                              float* __restrict__ out, int64_t nnz,
                              int64_t n_seg) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nnz;
       i += stride) {
    const int32_t id = __ldg(ids + i);
    if (id >= 0 && id < n_seg) atomicAdd(out + id, vals[i]);
  }
}

// Sum of v over the lanes of grp, in lane order; every lane of act calls.
__device__ __forceinline__ float group_sum(unsigned grp, float v,
                                           unsigned act, int lane) {
  const unsigned rounds = __reduce_max_sync(act, (unsigned)__popc(grp));
  float s = 0.0f;
  unsigned m = grp;
  for (unsigned r = 0; r < rounds; ++r) {
    const int src = m ? __ffs(m) - 1 : lane;
    const float x = __shfl_sync(act, v, src);
    if (m) {
      s += x;
      m &= m - 1;
    }
  }
  return s;
}

// kPolicy 0: the block's claimed-slot table with shared atomics (e, h);
// 1: the warp's direct-mapped table, plain loads and stores (f, g).
template <int kPolicy>
struct Tables {
  static constexpr int kN = kPolicy == 0 ? kSlots : kWarps * kWSlots;
  int32_t id[kN];
  float sum[kN];
  uint8_t lock[kPolicy == 0 ? 4 : kN];
};

template <int kPolicy>
__device__ __forceinline__ void element(Tables<kPolicy>& t, float* out,
                                        int32_t id, float v, bool ok,
                                        int lane, int warp) {
  __syncwarp();
  const unsigned act = __ballot_sync(kFull, ok);
  if (!ok) return;
  const unsigned grp = __match_any_sync(act, id);
  const float s = group_sum(grp, v, act, lane);
  const bool leader = lane == __ffs(grp) - 1;
  const unsigned lead = __ballot_sync(act, leader);
  if (!leader) return;
  if (kPolicy == 0) {
    const int slot = hash_slot(id, kSlotBits);
    int32_t owner = *(volatile int32_t*)(t.id + slot);
    if (owner == kNone) {
      const int32_t old = atomicCAS(t.id + slot, kNone, id);
      owner = old == kNone ? id : old;
    }
    if (owner == id)
      atomicAdd(t.sum + slot, s);
    else
      atomicAdd(out + id, s);
  } else {
    const int slot = warp * kWSlots + hash_slot(id, kWSlotBits);
    t.lock[slot] = (uint8_t)lane;
    __syncwarp(lead);
    if (t.lock[slot] != lane) {
      atomicAdd(out + id, s);
      return;
    }
    const int32_t tag = t.id[slot];
    if (tag == id) {
      t.sum[slot] += s;
    } else {
      if (tag != kNone) atomicAdd(out + tag, t.sum[slot]);
      t.id[slot] = id;
      t.sum[slot] = s;
    }
  }
}

template <bool kVec, int kPolicy>
__global__ void match_kernel(const int32_t* __restrict__ ids,
                             const float* __restrict__ vals,
                             float* __restrict__ out, int64_t nnz,
                             int64_t n_seg) {
  __shared__ Tables<kPolicy> t;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < Tables<kPolicy>::kN; j += blockDim.x) {
    t.id[j] = kNone;
    t.sum[j] = 0.0f;
  }
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + warp * 32;
  auto valid = [&](int32_t id) { return id >= 0 && id < n_seg; };
  int64_t done = 0;
  if (kVec) {
    const int64_t n4 = nnz / 4;
    for (int64_t j0 = first; j0 < n4; j0 += stride) {
      const int64_t j = j0 + lane;
      int4 id4 = make_int4(-1, -1, -1, -1);
      float4 v4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (j < n4) {
        id4 = __ldg(reinterpret_cast<const int4*>(ids) + j);
        v4 = __ldg(reinterpret_cast<const float4*>(vals) + j);
      }
      element<kPolicy>(t, out, id4.x, v4.x, valid(id4.x), lane, warp);
      element<kPolicy>(t, out, id4.y, v4.y, valid(id4.y), lane, warp);
      element<kPolicy>(t, out, id4.z, v4.z, valid(id4.z), lane, warp);
      element<kPolicy>(t, out, id4.w, v4.w, valid(id4.w), lane, warp);
    }
    done = n4 * 4;
  }
  if (!kVec || (blockIdx.x == 0 && warp == 0)) {
    const int64_t from = kVec ? done : first;
    const int64_t step = kVec ? 32 : stride;
    for (int64_t i0 = from; i0 < nnz; i0 += step) {
      const int64_t i = i0 + lane;
      const int32_t id = i < nnz ? __ldg(ids + i) : -1;
      const bool ok = valid(id);
      element<kPolicy>(t, out, id, ok ? vals[i] : 0.0f, ok, lane, warp);
    }
  }
  if (kPolicy == 0) {
    __syncthreads();
    for (int j = threadIdx.x; j < Tables<kPolicy>::kN; j += blockDim.x)
      if (t.id[j] != kNone) atomicAdd(out + t.id[j], t.sum[j]);
  } else {
    __syncwarp();
    for (int j = warp * kWSlots + lane; j < (warp + 1) * kWSlots; j += 32)
      if (t.id[j] != kNone) atomicAdd(out + t.id[j], t.sum[j]);
  }
}

// The first segsum_windowed, as it was.
__device__ __forceinline__ unsigned run_sums(int32_t id, float& v, int lane) {
  int32_t left = __shfl_up_sync(kFull, id, 1);
  unsigned heads = __ballot_sync(kFull, lane == 0 || left != id);
  unsigned after = heads & ~((2u << lane) - 1u);
  int end = after ? __ffs(after) - 1 : 32;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    float o = __shfl_down_sync(kFull, v, off);
    if (lane + off < end) v += o;
  }
  return heads;
}

__device__ __forceinline__ void put(float* out, int32_t id, float v,
                                    int64_t n_seg, bool shared) {
  if (id < 0 || id >= n_seg) return;
  if (shared)
    atomicAdd(out + id, v);
  else
    out[id] = v;
}

__global__ void windowed_first_kernel(const int32_t* __restrict__ ids,
                                      const float* __restrict__ vals,
                                      float* __restrict__ out, int64_t nnz,
                                      int64_t n_seg) {
  const int lane = threadIdx.x & 31;
  const int64_t span = 32 * kRows;
  const int64_t base =
      ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * span;
  if (base >= nnz) return;
  const int64_t stop = base + span < nnz ? base + span : nnz;
  const int32_t first_id = __ldg(ids + base);
  const int32_t last_id = __ldg(ids + stop - 1);
  const bool open_before = base > 0 && __ldg(ids + base - 1) == first_id;
  const bool open_after = stop < nnz && __ldg(ids + stop) == last_id;
  auto shared = [&](int32_t id) {
    return (open_before && id == first_id) || (open_after && id == last_id);
  };
  int32_t carry_id = kNone;
  float carry = 0.0f;
  for (int64_t row = base; row < stop; row += 32) {
    const int64_t i = row + lane;
    int32_t id = kNone;
    float v = 0.0f;
    if (i < stop) {
      id = __ldg(ids + i);
      v = vals[i];
    }
    unsigned heads = run_sums(id, v, lane);
    const int32_t id0 = __shfl_sync(kFull, id, 0);
    if (lane == 0) {
      if (id0 == carry_id)
        v += carry;
      else if (carry_id != kNone)
        put(out, carry_id, carry, n_seg, shared(carry_id));
    }
    const int last = 31 - __clz(heads);
    if ((heads >> lane & 1u) && lane != last)
      put(out, id, v, n_seg, shared(id));
    carry_id = __shfl_sync(kFull, id, last);
    carry = __shfl_sync(kFull, v, last);
  }
  if (lane == 0 && carry_id != kNone)
    put(out, carry_id, carry, n_seg, shared(carry_id));
}

constexpr int kCache = 8;
constexpr int kBigBits = 14;

// Variants k-n.  Table of 1 << kBits slots (static for kBits == kSlotBits,
// else dynamic, with the last-seen ids after it when kSecond).
template <bool kVec, int kBits, bool kSecond, int kC = kCache>
__global__ void __launch_bounds__(1024)
    cache_kernel(const int32_t* __restrict__ ids,
                 const float* __restrict__ vals, float* __restrict__ out,
                 int64_t nnz, int64_t n_seg) {
  constexpr int kN = 1 << kBits;
  extern __shared__ int32_t dyn[];
  __shared__ int32_t st_id[kBits == kSlotBits ? kN : 1];
  __shared__ float st_sum[kBits == kSlotBits ? kN : 1];
  int32_t* s_id = kBits == kSlotBits ? st_id : dyn;
  float* s_sum = kBits == kSlotBits ? st_sum : (float*)(dyn + kN);
  int32_t* s_seen = dyn + 2 * kN;
  for (int j = threadIdx.x; j < kN; j += blockDim.x) {
    s_id[j] = kNone;
    s_sum[j] = 0.0f;
    if (kSecond) s_seen[j] = kNone;
  }
  __syncthreads();
  int32_t cid[kC > 0 ? kC : 1];
  float csum[kC > 0 ? kC : 1];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    cid[c] = kNone;
    csum[c] = 0.0f;
  }
  int rr = 0;
  auto add = [&](int32_t id, float v) {
    if (id < 0 || id >= n_seg) return;
    bool hit = false;
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (cid[c] == id) {
        csum[c] += v;
        hit = true;
      }
    if (hit) return;
    const int slot = hash_slot(id, kBits);
    int32_t owner = *(volatile int32_t*)(s_id + slot);
    if (owner == kNone) {
      bool claim = true;
      if (kSecond) {
        const int seen = hash_slot(id ^ 0x5bd1e995, kBits);
        claim = *(volatile int32_t*)(s_seen + seen) == id;
        if (!claim) s_seen[seen] = id;
      }
      if (claim) {
        const int32_t old = atomicCAS(s_id + slot, kNone, id);
        owner = old == kNone ? id : old;
      }
    }
    if (owner != id) {
      atomicAdd(out + id, v);
      return;
    }
    if (kC == 0) {
      atomicAdd(s_sum + slot, v);
      return;
    }
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (c == rr) {
        if (cid[c] != kNone)
          atomicAdd(s_sum + hash_slot(cid[c], kBits), csum[c]);
        cid[c] = id;
        csum[c] = v;
      }
    rr = rr + 1 == kC ? 0 : rr + 1;
  };
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (kVec) {
    const int64_t n4 = nnz / 4;
    for (int64_t j = g; j < n4; j += stride) {
      const int4 id4 = __ldg(reinterpret_cast<const int4*>(ids) + j);
      const float4 v4 = __ldg(reinterpret_cast<const float4*>(vals) + j);
      add(id4.x, v4.x);
      add(id4.y, v4.y);
      add(id4.z, v4.z);
      add(id4.w, v4.w);
    }
    done = n4 * 4;
  }
  for (int64_t i = done + g; i < nnz; i += stride) add(__ldg(ids + i), vals[i]);
#pragma unroll
  for (int c = 0; c < kC; ++c)
    if (cid[c] != kNone) atomicAdd(s_sum + hash_slot(cid[c], kBits), csum[c]);
  __syncthreads();
  for (int j = threadIdx.x; j < kN; j += blockDim.x)
    if (s_id[j] != kNone) atomicAdd(out + s_id[j], s_sum[j]);
}

template <bool kVec, int kBits, bool kSecond, int kC = kCache>
int launch_cache(const int32_t* ids, const float* vals, float* out,
                 int64_t nnz, int64_t n_seg, unsigned grid, int threads,
                 cudaStream_t s) {
  const int smem = kBits == kSlotBits ? 0 : (kSecond ? 3 : 2) * (4 << kBits);
  if (smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        cache_kernel<kVec, kBits, kSecond, kC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cache_kernel<kVec, kBits, kSecond, kC><<<grid, threads, smem, s>>>(
      ids, vals, out, nnz, n_seg);
  return (int)cudaGetLastError();
}

unsigned int grid_for(int64_t n, int64_t per_block, int64_t cap) {
  int64_t g = (n + per_block - 1) / per_block;
  return (unsigned int)(g < cap ? g : cap);
}

}  // namespace

// Runs variant `which` (the table above) on out; returns the CUDA error
// of the launch, -1 for an unknown variant, -2 for 16-byte loads on
// unaligned inputs.
extern "C" int variant_run(int which, const int32_t* ids, const float* vals,
                           float* out, int64_t nnz, int64_t n_seg,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned =
      (uintptr_t)ids % 16 == 0 && (uintptr_t)vals % 16 == 0;
  if ((which == 7 || which == 8 || which >= 11) && !aligned) return -2;
  if (which < 0 || which > 14) return -1;
  if (which != 2) {
    const cudaError_t err =
        cudaMemsetAsync(out, 0, (size_t)n_seg * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned g = grid_for(nnz, kPerBlock, 132 * 8);
  switch (which) {
    case 1: table_kernel<true><<<g, kThreads, 0, s>>>(ids, vals, out, nnz,
                                                      n_seg); break;
    case 2: read_floor_kernel<<<g, kThreads, 0, s>>>(ids, vals, out, nnz,
                                                     n_seg); break;
    case 3: direct_kernel<<<g, kThreads, 0, s>>>(ids, vals, out, nnz,
                                                 n_seg); break;
    case 4: table_kernel<false><<<g, kThreads, 0, s>>>(ids, vals, out, nnz,
                                                       n_seg); break;
    case 5: match_kernel<false, 0><<<g, kThreads, 0, s>>>(ids, vals, out,
                                                          nnz, n_seg); break;
    case 6: match_kernel<false, 1><<<g, kThreads, 0, s>>>(ids, vals, out,
                                                          nnz, n_seg); break;
    case 7: match_kernel<true, 1><<<g, kThreads, 0, s>>>(ids, vals, out,
                                                         nnz, n_seg); break;
    case 8: match_kernel<true, 0><<<g, kThreads, 0, s>>>(ids, vals, out,
                                                         nnz, n_seg); break;
    case 9: windowed_first_kernel<<<grid_for(nnz, kWarps * 32 * kRows,
                                             INT32_MAX), kThreads, 0, s>>>(
                ids, vals, out, nnz, n_seg); break;
    case 10: return launch_cache<false, kSlotBits, false>(
        ids, vals, out, nnz, n_seg, g, kThreads, s);
    case 11: return launch_cache<true, kSlotBits, false>(
        ids, vals, out, nnz, n_seg, g, kThreads, s);
    case 12: return launch_cache<true, kBigBits, false>(
        ids, vals, out, nnz, n_seg, 132, 1024, s);
    case 13: return launch_cache<true, kBigBits, true>(
        ids, vals, out, nnz, n_seg, 132, 1024, s);
    case 14: return launch_cache<true, kBigBits, false, 0>(
        ids, vals, out, nnz, n_seg, 132, 1024, s);
    default: break;
  }
  return (int)cudaGetLastError();
}
