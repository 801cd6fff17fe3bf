// Segmented sums for Hopper (sm_90a): out[s] = sum_{i: ids[i] == s} vals[i].
//
// segsum replaces the Pallas kernel repro/kernels/segsum.py:48 segsum
// (_segsum_kernel, pallas_call at :65); segsum_windowed replaces
// repro/kernels/segsum.py:107 segsum_windowed (_windowed_kernel,
// pallas_call at :139, and its XLA spill pass).
//
// Semantics: ids are int32; vals float32 or bf16, summed in fp32 into a
// float32 (num_segments,) output that the entry points write whole (the
// caller allocates it uninitialised).  Ids outside [0, num_segments)
// contribute nothing (this drops the ELL's -1 padding).  segsum takes ids
// in any order; segsum_windowed requires them ascending.
//
// Design.  The TPU kernels turn the scatter into a one-hot matmul on the
// MXU, tiled over (segment tile, nnz block), because the TPU has no
// scatter; the windowed one only bounds which output tiles a sorted block
// can touch.  A GPU scatters directly.
//   segsum: the entry zeroes out (cudaMemsetAsync on the same stream),
//     then one block of kSumThreads an SM runs a grid-stride loop over
//     nnz, four elements a thread a step from 16-byte id loads (after a
//     few single elements that align them).  Each element goes, in turn,
//     to a cache of kCache (id, sum) pairs in the thread's registers, to
//     the block's table of kSlots partial sums in dynamic shared memory,
//     or to out with a global atomic.  An id hashes to one slot; the first
//     id to reach an empty slot claims it (atomicCAS) and keeps it.  An
//     element of a claimed id enters the thread's cache, evicting the
//     oldest entry into its slot with one shared atomic, so the hot
//     columns the pipeline's row-major pack puts in nearly every packet
//     add in registers; at the end the caches go to the table and the
//     table to out (each warp first adding up its lanes' entries of one
//     id).  A hot id's sum is built from short partial sums (a thread's,
//     then a block's), not from millions of ordered atomics.
//   segsum_windowed: a write-once, atomic-free reduce-by-key in two
//     kernels from one entry.  The first gives each block of kThreads a
//     range of kTile ids; each thread loads kItems consecutive ids and
//     values (16-byte loads: the ranges are shifted by under 8 elements so
//     that all but the first start aligned), stores each run that begins
//     and ends inside it, and a block-wide segmented scan of the threads'
//     (has-head, tail-sum) pairs gives each thread the sum of the run open
//     at its first element, which it stores if the run ends inside it.
//     The range's first and last runs, which may continue across the
//     range's edges, leave their partial sums in a scratch record per
//     range; the second kernel gives each range whose last run goes on
//     into the next, and began inside it, a warp that adds the partials of
//     the ranges the run covers, kWalk ranges a lane per step, in range
//     order, and stores the sum once.  Each segment no id names is stored
//     as 0 by the thread where the next run begins (or, above the last id,
//     by the one holding it), the warp writing long gaps together.  So
//     every element of out is written exactly once, no atomics are used,
//     and the order of every sum is fixed: two calls give identical bits,
//     as the TPU's ordered grid does.  The work is O(nnz + num_segments)
//     whatever the run lengths: a run over many ranges costs its owner one
//     step per 32 * kWalk ranges.
//
// Bound on an H100: memory.  Both read each id and value once (nnz * 8
// bytes for fp32 values, nnz * 6 for bf16) and write the output once
// (num_segments * 4 bytes); one add per element is far below the fp32
// rate.  segsum_windowed moves those bytes and its per-range scratch (16
// bytes per kTile ids).  segsum cannot: ids it sees once in a block go to
// out as random 4-byte atomics in L2 (about 0.35 an element on the
// pipeline's row-major pack, against 0.23 distinct ids an element, by
// scripts/segsum_claims.py), and those set its time; float atomics also
// make the order of a segment's sum vary from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_attrs.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kNone = INT32_MIN;      // no id; free slot
constexpr int kSumThreads = 1024;         // segsum: one block an SM
constexpr int kSlotBits = 14;
constexpr int kSlots = 1 << kSlotBits;    // segsum: partial sums a block
constexpr int kCache = 8;                 // segsum: ids a thread caches
constexpr int kItems = 16;                // windowed: elements a thread
constexpr int kTile = kThreads * kItems;  // windowed: elements a range
constexpr int kWalk = 4;                  // ranges a lane reads per step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int hash_slot(int32_t id) {
  return (int)(((uint32_t)id * 2654435761u) >> (32 - kSlotBits));
}

// Sum of v over the lanes of grp, in lane order; all 32 lanes call it.
__device__ __forceinline__ float group_sum(unsigned grp, float v, int lane) {
  const unsigned rounds = __reduce_max_sync(kFull, (unsigned)__popc(grp));
  float s = 0.0f;
  unsigned m = grp;
  for (unsigned r = 0; r < rounds; ++r) {
    const float x = __shfl_sync(kFull, v, m ? __ffs(m) - 1 : lane);
    if (m) {
      s += x;
      m &= m - 1;
    }
  }
  return s;
}

// Four values from one 16-byte (float) or 8-byte (bf16) load; bf16 widens
// exactly by a shift.
__device__ __forceinline__ float4 load4(const float* v) {
  return __ldg(reinterpret_cast<const float4*>(v));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* v) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(v));
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

// One block of kSumThreads an SM, a grid-stride loop over nnz: the first
// `shift` elements one at a time, then (vec) groups of four from 16-byte
// id loads, then the rest.  Each element goes to the thread's register
// cache, else to the block's table of kSlots partial sums (in dynamic
// shared memory), else to out with a global atomic.  An id hashes to one
// slot and the first id to reach an empty slot claims it (atomicCAS); a
// claimed slot never changes hands.  An element of a claimed id enters
// the cache, evicting (round robin) an entry into its slot with one
// shared atomic, so a hot id's elements add in registers.
template <typename T>
__global__ void __launch_bounds__(kSumThreads, 1)
    segsum_kernel(const int32_t* __restrict__ ids, const T* __restrict__ vals,
                  float* __restrict__ out, int64_t nnz, int64_t n_seg,
                  int shift, int vec) {
  extern __shared__ int32_t s_table[];
  int32_t* s_id = s_table;
  float* s_sum = reinterpret_cast<float*>(s_table + kSlots);
  for (int j = threadIdx.x; j < kSlots; j += blockDim.x) {
    s_id[j] = kNone;
    s_sum[j] = 0.0f;
  }
  __syncthreads();
  int32_t cid[kCache];
  float csum[kCache];
#pragma unroll
  for (int c = 0; c < kCache; ++c) {
    cid[c] = kNone;
    csum[c] = 0.0f;
  }
  int next = 0;                                  // the cache entry to evict
  auto add = [&](int32_t id, float v) {
    if (id < 0 || id >= n_seg) return;
    bool hit = false;
#pragma unroll
    for (int c = 0; c < kCache; ++c)
      if (cid[c] == id) {
        csum[c] += v;
        hit = true;
      }
    if (hit) return;
    const int slot = hash_slot(id);
    // A claimed slot never changes hands, so a stale kNone only costs a CAS.
    int32_t owner = *(volatile int32_t*)(s_id + slot);
    if (owner == kNone) {
      const int32_t old = atomicCAS(s_id + slot, kNone, id);
      owner = old == kNone ? id : old;
    }
    if (owner != id) {
      atomicAdd(out + id, v);
      return;
    }
#pragma unroll
    for (int c = 0; c < kCache; ++c)
      if (c == next) {
        if (cid[c] != kNone) atomicAdd(s_sum + hash_slot(cid[c]), csum[c]);
        cid[c] = id;
        csum[c] = v;
      }
    next = next + 1 == kCache ? 0 : next + 1;
  };
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t rest = 0;                              // first element of the rest
  if (vec) {
    if (g < shift && g < nnz) add(__ldg(ids + g), to_f32(vals[g]));
    const int64_t n4 = nnz > shift ? (nnz - shift) / 4 : 0;
    const int32_t* id4 = ids + shift;
    const T* v4 = vals + shift;
    for (int64_t j = g; j < n4; j += stride) {
      const int4 i = __ldg(reinterpret_cast<const int4*>(id4) + j);
      const float4 x = load4(v4 + 4 * j);
      add(i.x, x.x);
      add(i.y, x.y);
      add(i.z, x.z);
      add(i.w, x.w);
    }
    rest = nnz > shift ? shift + 4 * n4 : nnz;
  }
  for (int64_t i = rest + g; i < nnz; i += stride)
    add(__ldg(ids + i), to_f32(vals[i]));
  // Every thread's cache holds the hot ids: each warp first sums the
  // entries of one id across its lanes, so a hot slot takes one shared
  // atomic a warp and entry, not one a thread.
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < kCache; ++c) {
    const unsigned grp = __match_any_sync(kFull, cid[c]);
    const float sum = group_sum(grp, csum[c], lane);
    if (cid[c] != kNone && lane == __ffs(grp) - 1)
      atomicAdd(s_sum + hash_slot(cid[c]), sum);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kSlots; j += blockDim.x)
    if (s_id[j] != kNone) atomicAdd(out + s_id[j], s_sum[j]);
}

// ---------------------------------------------------------------------------
// segsum_windowed
// ---------------------------------------------------------------------------

// What a range leaves for the combine: the partial sums of its first and
// last runs inside it, and how those runs meet its neighbours.
enum : int { kSingle = 1, kFromPrev = 2, kIntoNext = 4 };
struct alignas(16) RangePart {
  float first;   // the range's first run, summed inside the range
  float last;    // its last run, summed inside the range
  int flags;     // kSingle: one run; kFromPrev / kIntoNext: it goes on
  int unused;
};

// Ids below 0 become -1 and ids at or past n_seg become n_seg, so that
// every id out of range still bounds the gaps and ends runs.
__device__ __forceinline__ int32_t clamp_id(int32_t id, int64_t n_seg) {
  return id < 0 ? -1 : ((int64_t)id >= n_seg ? (int32_t)n_seg : id);
}

// Zero dst[lo, hi) of each lane that has a gap (dst in global or shared
// memory), the whole warp writing each gap in turn.  All 32 lanes must
// take part.
__device__ __forceinline__ void fill_gaps(float* dst, int64_t lo, int64_t hi,
                                          int lane) {
  unsigned m = __ballot_sync(kFull, hi > lo);
  while (m) {
    const int j = __ffs(m) - 1;
    m &= m - 1;
    const int64_t l = __shfl_sync(kFull, lo, j);
    const int64_t h = __shfl_sync(kFull, hi, j);
    for (int64_t s = l + lane; s < h; s += 32) dst[s] = 0.0f;
  }
}

// Each warp stages its 32 * kItems ids and values in shared memory with
// coalesced loads (16-byte ones when vec), then each lane reads back its
// kItems consecutive elements.  Element e of a warp's stage sits at word
// e + 4 * (e / 32): the pad keeps both the striped 16-byte stores and the
// lanes' 16-byte reads free of bank conflicts.
constexpr int kWarpElems = 32 * kItems;
constexpr int kWarpWords = kWarpElems + kWarpElems / 8;
constexpr int kStage = kWarps * kWarpWords;     // words an array, a block
constexpr int kOutCap = 2 * kStage;             // staged output floats

__device__ __forceinline__ int pad4(int e) { return e + ((e >> 5) << 2); }

__device__ __forceinline__ void stage_vals(float* w,
                                           const float* __restrict__ v,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < kWarpElems / 128; ++j) {
    const int g = j * 32 + lane;
    *reinterpret_cast<float4*>(w + pad4(4 * g)) =
        __ldg(reinterpret_cast<const float4*>(v) + g);
  }
}

__device__ __forceinline__ void stage_vals(float* w,
                                           const __nv_bfloat16* __restrict__ v,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < kWarpElems / 256; ++j) {  // 8 bf16 a load; exact widening
    const int g = j * 32 + lane;
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(v) + g);
    *reinterpret_cast<float4*>(w + pad4(8 * g)) = make_float4(
        __uint_as_float(b.x << 16), __uint_as_float(b.x & 0xffff0000u),
        __uint_as_float(b.y << 16), __uint_as_float(b.y & 0xffff0000u));
    *reinterpret_cast<float4*>(w + pad4(8 * g + 4)) = make_float4(
        __uint_as_float(b.z << 16), __uint_as_float(b.z & 0xffff0000u),
        __uint_as_float(b.w << 16), __uint_as_float(b.w & 0xffff0000u));
  }
}

// Range b holds ids [b * kTile - shift, (b + 1) * kTile - shift) cut to
// [0, nnz): shift < 8 makes every range but the first start where 16-byte
// loads of both arrays are aligned (vec), when such a shift exists.  The
// segments a range stores form one interval [lo, hi] (its runs that do not
// go on across its edges, and the gaps below its heads); when it fits in
// kOutCap floats the range builds it in shared memory and stores it with
// coalesced writes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    windowed_ranges_kernel(const int32_t* __restrict__ ids,
                           const T* __restrict__ vals,
                           float* __restrict__ out,
                           RangePart* __restrict__ parts, int64_t nnz,
                           int64_t n_seg, int shift, int vec) {
  __shared__ __align__(16) float s_stage[2 * kStage];
  __shared__ int s_wflag[kWarps];
  __shared__ float s_wsum[kWarps];
  __shared__ int s_from_prev;
  __shared__ int64_t s_lo, s_hi;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t start =
      blockIdx.x == 0 ? 0 : (int64_t)blockIdx.x * kTile - shift;
  const int64_t stop = (int64_t)(blockIdx.x + 1) * kTile - shift;
  const int n = (int)((stop < nnz ? stop : nnz) - start);
  const int base = tid * kItems;
  const int m = n - base < 0 ? 0 : (n - base < kItems ? n - base : kItems);
  const bool holds_end = m > 0 && base + m == n;   // the range's last id

  int32_t id[kItems];
  float v[kItems];
  {
    int32_t* w_id = reinterpret_cast<int32_t*>(s_stage) + warp * kWarpWords;
    float* w_v = s_stage + kStage + warp * kWarpWords;
    const int64_t w0 = start + warp * kWarpElems;
    const int wn = n - warp * kWarpElems;
    if (vec && (blockIdx.x > 0 || shift == 0) && wn >= kWarpElems) {
#pragma unroll
      for (int j = 0; j < kWarpElems / 128; ++j) {
        const int g = j * 32 + lane;
        *reinterpret_cast<int4*>(w_id + pad4(4 * g)) =
            __ldg(reinterpret_cast<const int4*>(ids + w0) + g);
      }
      stage_vals(w_v, vals + w0, lane);
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int e = j * 32 + lane;
        if (e < wn) {
          w_id[pad4(e)] = __ldg(ids + w0 + e);
          w_v[pad4(e)] = to_f32(vals[w0 + e]);
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int at = pad4(lane * kItems + 4 * q);
      const int4 a = *reinterpret_cast<const int4*>(w_id + at);
      const float4 b = *reinterpret_cast<const float4*>(w_v + at);
      id[4 * q] = a.x, id[4 * q + 1] = a.y, id[4 * q + 2] = a.z,
      id[4 * q + 3] = a.w;
      v[4 * q] = b.x, v[4 * q + 1] = b.y, v[4 * q + 2] = b.z,
      v[4 * q + 3] = b.w;
    }
  }
  const bool has_left = lane == 0 && m > 0 && start + base > 0;
  const bool has_after = holds_end && start + n < nnz;
  const int32_t left = has_left ? __ldg(ids + start + base - 1) : 0;
  const int32_t after = has_after ? __ldg(ids + start + n) : 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    id[k] = k < m ? clamp_id(id[k], n_seg) : kNone;
    v[k] = k < m ? v[k] : 0.0f;
  }
  // The id before this thread's first element (kNone at the array's start).
  const int32_t up = __shfl_up_sync(kFull, id[kItems - 1], 1);
  const int32_t before =
      lane == 0 ? (has_left ? clamp_id(left, n_seg) : kNone) : up;

  // The scan's inputs: whether a head lies past the range's first id in
  // this thread, and the sum since the last (or of all, if none).
  float pre = 0.0f, r = 0.0f;
  int last_head = -1;
  bool gap = false;
  int32_t cur = before;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (k >= m) break;
    if (id[k] != cur) {
      gap |= (int64_t)id[k] > (int64_t)(cur > -1 ? cur : -1) + 1;
      last_head = k;
      cur = id[k];
      r = v[k];
    } else if (last_head >= 0) {
      r += v[k];
    } else {
      pre += v[k];
    }
  }
  const bool into_next = has_after && clamp_id(after, n_seg) == cur;
  if (tid == 0) {
    s_from_prev = start > 0 && id[0] == before;
    s_lo = (int64_t)(before > -1 ? before : -1) + 1;
  }
  if (holds_end) {
    const int64_t hi = into_next ? (int64_t)cur - 1 : cur;
    s_hi = hi < n_seg - 1 ? hi : n_seg - 1;
  }

  // Block-wide exclusive segmented scan of (head past the range's first
  // id, sum since the last such head): the sum of the run open at this
  // thread's first element, from the range's start or that run's head,
  // and whether such a head came before this thread.  A fixed tree.
  int f = last_head >= 0 && base + last_head > 0;
  float s = last_head >= 0 ? r : pre;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int of = __shfl_up_sync(kFull, f, off);
    const float os = __shfl_up_sync(kFull, s, off);
    if (lane >= off) {
      if (!f) s = os + s;
      f |= of;
    }
  }
  if (lane == 31) {
    s_wflag[warp] = f;
    s_wsum[warp] = s;
  }
  int ef = __shfl_up_sync(kFull, f, 1);
  float es = __shfl_up_sync(kFull, s, 1);
  if (lane == 0) {
    ef = 0;
    es = 0.0f;
  }
  __syncthreads();                  // also: every stage read into registers
  int pf = 0;
  float ps = 0.0f;
  for (int w = 0; w < warp; ++w) {
    if (s_wflag[w]) {
      pf = 1;
      ps = s_wsum[w];
    } else {
      ps += s_wsum[w];
    }
  }
  const bool from_prev = s_from_prev;
  const int64_t lo = s_lo, span = s_hi - s_lo + 1;
  const bool staged = span <= kOutCap;
  float* dst = staged ? s_stage : out;           // segment s at dst[s - off]
  const int64_t off = staged ? lo : 0;

  // Every run end: stored (at dst), unless the run goes on across the
  // range's edge, in which case its partial waits in the range's record.
  RangePart* part = parts + blockIdx.x;
  auto emit = [&](int32_t rid, float rs, bool is_first, bool is_last) {
    if (is_first) part->first = rs;
    if (is_last) {
      part->last = rs;
      part->flags = (is_first ? kSingle : 0) | (from_prev ? kFromPrev : 0) |
                    (into_next ? kIntoNext : 0);
    }
    const bool open = (is_first && from_prev) || (is_last && into_next);
    if (!open && rid >= 0 && rid < n_seg) dst[rid - off] = rs;
  };
  {
    float run = ef ? es : ps + es;              // the run open on entry
    bool first = !(pf | ef);                    // ... is the range's first
    int32_t c = before;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (k >= m) break;
      if (id[k] != c) {
        if (base + k > 0) emit(c, run, first, false);
        first = base + k == 0;
        c = id[k];
        run = v[k];
      } else {
        run += v[k];
      }
    }
    if (holds_end) emit(c, run, first, true);
  }
  // Zeros for the segments no id names below each head (down to the id
  // before it).
  if (__any_sync(kFull, gap)) {
    int32_t prev = before;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      int64_t g_lo = 0, g_hi = 0;
      if (k < m && id[k] != prev) {
        g_lo = (int64_t)(prev > -1 ? prev : -1) + 1 - off;
        g_hi = id[k] - off;
      }
      prev = id[k];
      fill_gaps(dst, g_lo, g_hi, lane);
    }
  }
  if (staged) {
    __syncthreads();
    for (int j = tid; j < span; j += kThreads) out[lo + j] = s_stage[j];
  }
  // Above the last id, in the last range.
  const bool top = holds_end && start + n == nnz;
  fill_gaps(out, top ? (int64_t)cur + 1 : 0, top ? n_seg : 0, lane);
}

// One warp a range: a range whose last run goes on into the next range,
// and began inside it, owns that run.  The warp adds the partials of the
// ranges the run covers, in range order, 32 * kWalk ranges a step (each
// step's partials in a fixed tree), and stores the sum once.
__global__ void __launch_bounds__(kThreads)
    windowed_combine_kernel(const int32_t* __restrict__ ids,
                            const RangePart* __restrict__ parts,
                            float* __restrict__ out, int64_t n_ranges,
                            int64_t n_seg, int shift) {
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= n_ranges) return;
  const RangePart own = parts[b];
  if (!(own.flags & kIntoNext) ||
      ((own.flags & kSingle) && (own.flags & kFromPrev)))
    return;                                         // whole warp
  constexpr int kThrough = kSingle | kIntoNext;     // passes the run on
  float total = own.last;
  for (int64_t k0 = b + 1;; k0 += 32 * kWalk) {
    RangePart q[kWalk];
#pragma unroll
    for (int j = 0; j < kWalk; ++j) {
      const int64_t k = k0 + lane * kWalk + j;
      q[j] = k < n_ranges ? parts[k] : RangePart{0.0f, 0.0f, 0, 0};
    }
    float sum = 0.0f;
    bool stop = false;
#pragma unroll
    for (int j = 0; j < kWalk; ++j) {
      if (!stop) {
        sum += q[j].first;
        stop = (q[j].flags & kThrough) != kThrough;
      }
    }
    const unsigned ended = __ballot_sync(kFull, stop);
    const int end_lane = ended ? __ffs(ended) - 1 : 32;
    if (lane > end_lane) sum = 0.0f;
#pragma unroll
    for (int off = 16; off; off >>= 1)
      sum += __shfl_down_sync(kFull, sum, off);
    total += __shfl_sync(kFull, sum, 0);
    if (ended) break;
  }
  if (lane == 0) {
    const int32_t id =
        clamp_id(__ldg(ids + (b + 1) * kTile - shift - 1), n_seg);
    if (id >= 0 && id < n_seg) out[id] = total;
  }
}

unsigned int grid_for(int64_t n, int64_t per_block, int64_t cap) {
  int64_t g = (n + per_block - 1) / per_block;
  return (unsigned int)(g < cap ? g : cap);
}

// Elements to skip (below 8) so that 16-byte loads of ids and of groups
// of `group` values of `size` bytes start aligned; -1 when none does.
int aligning_shift(const void* ids, const void* vals, int size, int group) {
  for (int k = 0; k < 8; ++k)
    if (((uintptr_t)ids + 4 * k) % 16 == 0 &&
        ((uintptr_t)vals + (uintptr_t)size * k) % (size * group) == 0)
      return k;
  return -1;
}

template <typename T>
int launch_segsum(const int32_t* ids, const void* vals, float* out,
                  int64_t nnz, int64_t n_seg, cudaStream_t s) {
  constexpr int kSmem = kSlots * 8;
  static int sms = 0;
  if (sms == 0) {                  // once: the SM count and the smem limit
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(segsum_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmem);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n_seg * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const int shift = aligning_shift(ids, vals, (int)sizeof(T), 4);
  segsum_kernel<T><<<grid_for(nnz, 4 * kSumThreads, sms), kSumThreads, kSmem,
                     s>>>(ids, static_cast<const T*>(vals), out, nnz, n_seg,
                          shift < 0 ? 0 : shift, shift >= 0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_windowed(const int32_t* ids, const void* vals, float* out,
                    void* scratch, int64_t scratch_ranges, int64_t nnz,
                    int64_t n_seg, cudaStream_t s) {
  // Ranges after the first start at b * kTile - shift, aligned when an
  // aligned start exists (found elements in; kTile is a multiple of 8).
  const int found = aligning_shift(ids, vals, (int)sizeof(T), 16 / sizeof(T));
  const int shift = found <= 0 ? 0 : 8 - found;
  const int64_t n_ranges = (nnz + shift + kTile - 1) / kTile;
  if (scratch_ranges < n_ranges || n_ranges > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  RangePart* parts = static_cast<RangePart*>(scratch);
  windowed_ranges_kernel<T><<<(unsigned)n_ranges, kThreads, 0, s>>>(
      ids, static_cast<const T*>(vals), out, parts, nnz, n_seg, shift,
      found >= 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_ranges == 1) return (int)err;
  windowed_combine_kernel<<<grid_for(n_ranges, kWarps, INT32_MAX), kThreads,
                            0, s>>>(ids, parts, out, n_ranges, n_seg, shift);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  vals_bf16 selects bf16 values (else fp32).
// Both write every element of out (which may hold anything on entry) and
// return the CUDA error of their launches (0 on success); the caller
// skips the call when nnz or n_seg is 0.
extern "C" int segsum_forward(const int32_t* ids, const void* vals,
                              float* out, int64_t nnz, int64_t n_seg,
                              int vals_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return vals_bf16
             ? launch_segsum<__nv_bfloat16>(ids, vals, out, nnz, n_seg, s)
             : launch_segsum<float>(ids, vals, out, nnz, n_seg, s);
}

// scratch: 16 bytes for each of scratch_ranges ranges of kTile ids, at
// least ceil(nnz / kTile) + 1 of them (segsum_windowed_range below; the
// first range may be cut short so that the others start aligned).
extern "C" int segsum_windowed_forward(const int32_t* ids, const void* vals,
                                       float* out, void* scratch,
                                       int64_t scratch_ranges, int64_t nnz,
                                       int64_t n_seg, int vals_bf16,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return vals_bf16 ? launch_windowed<__nv_bfloat16>(
                         ids, vals, out, scratch, scratch_ranges, nnz, n_seg,
                         s)
                   : launch_windowed<float>(ids, vals, out, scratch,
                                            scratch_ranges, nnz, n_seg, s);
}

// Ids a range of segsum_windowed takes (kTile).
extern "C" int segsum_windowed_range(void) { return kTile; }

namespace {

const KernelEntry kKernels[] = {
    {"segsum f32", (const void*)segsum_kernel<float>},
    {"segsum bf16", (const void*)segsum_kernel<__nv_bfloat16>},
    {"segsum_windowed ranges f32", (const void*)windowed_ranges_kernel<float>},
    {"segsum_windowed ranges bf16",
     (const void*)windowed_ranges_kernel<__nv_bfloat16>},
    {"segsum_windowed combine", (const void*)windowed_combine_kernel},
};

}  // namespace

extern "C" int segsum_attrs(int i, int* out, const char** name) {
  return kernel_attrs(kKernels, (int)(sizeof(kKernels) / sizeof(kKernels[0])),
                      i, out, name);
}
