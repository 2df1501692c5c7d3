// wide_lists.cuh: the wide route's lists, shared by knn_topk.cu and
// knn_topk_prefix.cu.  R slots a lane: lane j holds slots j, j + 32, ...
// of a sorted list of up to 32 R (distance, id) pairs.

#pragma once

#include <cuda_runtime.h>

namespace knn_wide {

constexpr unsigned kWarpAll = 0xffffffffu;

// Lists a launch of the wide route at R slots a lane: 2 R W registers.
__host__ __device__ constexpr int wide_lists(int R) {
  return R == 1 ? 24 : R == 2 ? 12 : R == 3 ? 8 : 6;
}

// v[r] for a warp-uniform runtime r, without a local-memory array.
template <int R>
__device__ __forceinline__ float pick(const float (&v)[R], int r) {
  float out = v[0];
#pragma unroll
  for (int i = 1; i < R; ++i)
    if (i == r) out = v[i];
  return out;
}

// offer() over R slots a lane: lane j holds slots j, j + 32, ...  The keys
// of the lanes in `lanes` (ids `cid`) are inserted in ascending lane order;
// an insert shifts every slot at or after its position up one (within a
// round up one lane, lane 31 of round r - 1 into lane 0 of round r), and
// the new k-th distance is max(key, old slot k - 2), as in offer().
template <int R>
__device__ __forceinline__ void offer_wide(float (&ld)[R], int (&li)[R], float key,
                                           int cid, unsigned lanes, int k, int lane) {
  const int rk = (k - 1) >> 5, lk = (k - 1) & 31;
  const int rb = k >= 2 ? (k - 2) >> 5 : 0, lb = k >= 2 ? (k - 2) & 31 : 0;
  const int prev = (lane + 31) & 31;
  float kth = __shfl_sync(kWarpAll, pick<R>(ld, rk), lk);
  unsigned qual = __ballot_sync(kWarpAll, key < kth) & lanes;
  while (qual) {
    const int src = __ffs(qual) - 1;
    const float kk = __shfl_sync(kWarpAll, key, src);
    const int ki = __shfl_sync(kWarpAll, cid, src);
    const float below = __shfl_sync(kWarpAll, pick<R>(ld, rb), lb);
    int pos = 0;
    float up_d[R];
    int up_i[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      pos += __popc(__ballot_sync(kWarpAll, r * 32 + lane < k && ld[r] <= kk));
      const bool carry = r > 0 && lane == 31;
      up_d[r] = __shfl_sync(kWarpAll, carry ? ld[r > 0 ? r - 1 : 0] : ld[r], prev);
      up_i[r] = __shfl_sync(kWarpAll, carry ? li[r > 0 ? r - 1 : 0] : li[r], prev);
    }
    kth = k >= 2 ? fmaxf(kk, below) : kk;
    qual &= (qual - 1) & __ballot_sync(kWarpAll, key < kth);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int slot = r * 32 + lane;
      if (slot == pos) {
        ld[r] = kk;
        li[r] = ki;
      } else if (slot > pos) {
        ld[r] = up_d[r];
        li[r] = up_i[r];
      }
    }
  }
}

}  // namespace knn_wide
