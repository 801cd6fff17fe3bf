// Variants of segsum_windowed's range kernel, for timing on the card by
// scripts/segsum_variants.py: where its time goes beyond the bytes bound.
// float32 values; the ranges shifted as the shipped kernel shifts them.
//
//   0  each thread loads its 16 consecutive ids and values with 16-byte
//      loads straight into registers and stores each run's sum straight
//      to out (the design before the shipped one's staging)
//   1  (0) without the zeros of the gaps
//   2  (0) without the stores of the runs (the partial records kept)
//   3  (0) with 8 elements a thread
//   4  (0) with 32 elements a thread
//   5  read floor of (0)'s loads: each thread sums its 16 consecutive
//      values (16-byte loads), one store a thread
//   6  read floor of coalesced loads: lane l of a warp loads the 16-byte
//      groups l, l + 32, ... of the warp's 512 elements, one store a thread
#include "../src/repro_torch/kernels/csrc/segsum.cu"

namespace {

template <int kI>
__device__ __forceinline__ void load_k(const int32_t* __restrict__ ids,
                                       const float* __restrict__ vals, int m,
                                       bool vec, int32_t* id, float* v) {
  if (vec && m == kI) {
#pragma unroll
    for (int q = 0; q < kI / 4; ++q) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(ids) + q);
      const float4 b = __ldg(reinterpret_cast<const float4*>(vals) + q);
      id[4 * q] = a.x, id[4 * q + 1] = a.y, id[4 * q + 2] = a.z,
      id[4 * q + 3] = a.w;
      v[4 * q] = b.x, v[4 * q + 1] = b.y, v[4 * q + 2] = b.z,
      v[4 * q + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kI; ++k) {
      id[k] = k < m ? __ldg(ids + k) : kNone;
      v[k] = k < m ? __ldg(vals + k) : 0.0f;
    }
  }
}

template <int kI, bool kGaps, bool kStores>
__global__ void __launch_bounds__(kThreads)
    ranges_variant(const int32_t* __restrict__ ids,
                   const float* __restrict__ vals, float* __restrict__ out,
                   RangePart* __restrict__ parts, int64_t nnz, int64_t n_seg,
                   int shift, int vec) {
  constexpr int kT = kThreads * kI;
  __shared__ int s_wflag[kWarps];
  __shared__ float s_wsum[kWarps];
  __shared__ int s_from_prev;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t start = blockIdx.x == 0 ? 0 : (int64_t)blockIdx.x * kT - shift;
  const int64_t stop = (int64_t)(blockIdx.x + 1) * kT - shift;
  const int n = (int)((stop < nnz ? stop : nnz) - start);
  const int base = tid * kI;
  const int m = n - base < 0 ? 0 : (n - base < kI ? n - base : kI);
  const bool holds_end = m > 0 && base + m == n;
  int32_t id[kI];
  float v[kI];
  load_k<kI>(ids + start + base, vals + start + base, m,
             vec && (blockIdx.x > 0 || shift == 0), id, v);
  const bool has_left = lane == 0 && m > 0 && start + base > 0;
  const bool has_after = holds_end && start + n < nnz;
  const int32_t left = has_left ? __ldg(ids + start + base - 1) : 0;
  const int32_t after = has_after ? __ldg(ids + start + n) : 0;
#pragma unroll
  for (int k = 0; k < kI; ++k)
    if (k < m) id[k] = clamp_id(id[k], n_seg);
  const int32_t up = __shfl_up_sync(kFull, id[kI - 1], 1);
  const int32_t before =
      lane == 0 ? (has_left ? clamp_id(left, n_seg) : kNone) : up;
  if (tid == 0) s_from_prev = start > 0 && id[0] == before;
  float pre = 0.0f, r = 0.0f;
  int first_head = -1, last_head = -1;
  bool gap = false;
  int32_t cur = before;
  RangePart* part = parts + blockIdx.x;
#pragma unroll
  for (int k = 0; k < kI; ++k) {
    if (k >= m) break;
    if (id[k] != cur) {
      gap |= (int64_t)id[k] > (int64_t)(cur > -1 ? cur : -1) + 1;
      if (last_head >= 0) {
        if (kStores && cur >= 0 && cur < n_seg) out[cur] = r;
        if (base + last_head == 0) part->first = r;
      } else {
        first_head = k;
      }
      last_head = k;
      cur = id[k];
      r = v[k];
    } else if (last_head >= 0) {
      r += v[k];
    } else {
      pre += v[k];
    }
  }
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
  __syncthreads();
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
  const float carry = ef ? es : ps + es;
  const bool first_open = !(pf | ef);
  const bool from_prev = s_from_prev;
  const bool into_next = has_after && clamp_id(after, n_seg) == cur;
  auto emit = [&](int32_t rid, float rs, bool is_first, bool is_last) {
    if (is_first) part->first = rs;
    if (is_last) {
      part->last = rs;
      part->flags = (is_first ? kSingle : 0) | (from_prev ? kFromPrev : 0) |
                    (into_next ? kIntoNext : 0);
    }
    const bool open = (is_first && from_prev) || (is_last && into_next);
    if (kStores && !open && rid >= 0 && rid < n_seg) out[rid] = rs;
  };
  if (first_head >= 0 && base + first_head > 0)
    emit(before, carry + pre, first_open, false);
  if (holds_end) {
    if (last_head >= 0)
      emit(cur, r, base + last_head == 0, true);
    else
      emit(cur, carry + pre, first_open, true);
  }
  if (kGaps) {
    if (__any_sync(kFull, gap)) {
      int32_t prev = before;
#pragma unroll
      for (int k = 0; k < kI; ++k) {
        int64_t lo = 0, hi = 0;
        if (k < m && id[k] != prev) {
          lo = (int64_t)(prev > -1 ? prev : -1) + 1;
          hi = id[k];
        }
        prev = id[k];
        fill_gaps(out, lo, hi, lane);
      }
    }
    const bool top = holds_end && start + n == nnz;
    fill_gaps(out, top ? (int64_t)cur + 1 : 0, top ? n_seg : 0, lane);
  }
}

template <bool kStriped>
__global__ void __launch_bounds__(kThreads)
    read_floor(const int32_t* __restrict__ ids, const float* __restrict__ vals,
               float* __restrict__ out, int64_t nnz, int shift) {
  // Whole groups of 16 elements a thread after the first `shift` ids.
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t n16 = (nnz - shift) / 16;
  if (t >= n16) return;
  const int4* ip = reinterpret_cast<const int4*>(ids + shift);
  const float4* vp = reinterpret_cast<const float4*>(vals + shift);
  const int lane = threadIdx.x & 31;
  const int64_t warp0 = (t - lane) * 4;          // the warp's first group
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int64_t g = kStriped ? warp0 + q * 32 + lane : t * 4 + q;
    if (g < n16 * 4) {
      const int4 a = __ldg(ip + g);
      const float4 b = __ldg(vp + g);
      acc += (a.x >= 0 ? b.x : 0.0f) + (a.y >= 0 ? b.y : 0.0f) +
             (a.z >= 0 ? b.z : 0.0f) + (a.w >= 0 ? b.w : 0.0f);
    }
  }
  out[t] = acc;
}

}  // namespace

// Runs variant `which` (the table above) after the shipped kernel's own
// range shift; scratch as segsum_windowed_forward's.  Returns the CUDA
// error of the launches, -1 for an unknown variant, -2 for inputs with no
// aligned shift.
extern "C" int windowed_variant_run(int which, const int32_t* ids,
                                    const float* vals, float* out,
                                    void* scratch, int64_t nnz,
                                    int64_t n_seg, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int found = aligning_shift(ids, vals, 4, 4);
  if (found < 0) return -2;
  const int shift = found == 0 ? 0 : 8 - found;
  RangePart* parts = static_cast<RangePart*>(scratch);
  const int items[] = {16, 16, 16, 8, 32};
  if (which >= 0 && which <= 4) {
    const int64_t tile = (int64_t)kThreads * items[which];
    const int64_t n_ranges = (nnz + shift + tile - 1) / tile;
    const unsigned g = (unsigned)n_ranges;
    switch (which) {
      case 0: ranges_variant<16, true, true><<<g, kThreads, 0, s>>>(
          ids, vals, out, parts, nnz, n_seg, shift, 1); break;
      case 1: ranges_variant<16, false, true><<<g, kThreads, 0, s>>>(
          ids, vals, out, parts, nnz, n_seg, shift, 1); break;
      case 2: ranges_variant<16, true, false><<<g, kThreads, 0, s>>>(
          ids, vals, out, parts, nnz, n_seg, shift, 1); break;
      case 3: ranges_variant<8, true, true><<<g, kThreads, 0, s>>>(
          ids, vals, out, parts, nnz, n_seg, shift, 1); break;
      case 4: ranges_variant<32, true, true><<<g, kThreads, 0, s>>>(
          ids, vals, out, parts, nnz, n_seg, shift, 1); break;
    }
    return (int)cudaGetLastError();
  }
  const int fshift = found;                      // elements before alignment
  const unsigned g = (unsigned)grid_for((nnz - fshift) / 16, kThreads,
                                        INT32_MAX);
  if (which == 5)
    read_floor<false><<<g, kThreads, 0, s>>>(ids, vals, out, nnz, fshift);
  else if (which == 6)
    read_floor<true><<<g, kThreads, 0, s>>>(ids, vals, out, nnz, fshift);
  else
    return -1;
  return (int)cudaGetLastError();
}
