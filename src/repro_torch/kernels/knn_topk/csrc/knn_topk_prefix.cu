// knn_topk_prefix: prefix-snapshot kNN tables for nested library sizes,
// for a batch of series.  Hand-written for Hopper (sm_90a), plain C entry
// point.
//
// Replaces: src/repro/kernels/knn_topk/knn_topk.py::knn_topk_prefix_kernel
// (the Pallas kernel that builds the convergence diagnostic's tables).
//
// Computes, for series b, query row q, every library size Ls = lib_sizes[s]
// and every E in the selection set: the k nearest candidates among the
// columns col_ids[0], ..., col_ids[Ls - 1] of vc (the first Ls sweep
// positions of a seeded permutation; natural order when col_ids is null)
// under the dimension-E delay-embedding distance
//   D_E(q, c) = sum_{e < E} (vq[b, e, q] - vc[b, e, c])^2,
// accumulated with the pinned rounding of knn_topk.cu
//   d = vq - vc;  D = D + max(d * d, 0)      (__fsub_rn/__fmul_rn/__fadd_rn,
// built with --fmad=false), the float sequence of the JAX _acc_sq.
// With bf16 set (the JAX dist_dtype="bfloat16" branch) the square and the
// sum are each rounded to bfloat16, as knn_topk.cu's acc_sq does.
// Output: idx / dist (B, S, n_sel, Lq, k), int32 / float32, sorted by
// (distance, sweep position); ids are original column ids col_ids[p].
// Equal distances go to the EARLIEST SWEEP POSITION (the JAX prefix
// builders' arrival rule), which with a permuted col_ids is not the
// lowest id.  The self column under exclude_self (col_ids[p] == q) takes
// the finite stand-in kBig during selection and would come back as +inf;
// with lib_sizes[0] >= k + 1 (validated by the wrapper) it never survives
// to a snapshot.
//
// What bounds it on this card: bytes, at the significance path's shape.
// The function reads the swept columns and the queries (4 * B * E_hi *
// (Lq + P) bytes), col_ids (4 * P) and writes the S snapshots (8 * B * S
// * n_sel * Lq * k bytes): at B 8, Lq = P = 1430, 13 buckets, k 17 and
// five sizes about 0.10 GB, 0.031 ms at 3.35 TB/s; the 3 fp32 operations
// per (query, swept position, lag) take less at 67 TFLOP/s.  In practice
// the selection sets the time, as in knn_topk.cu.
//
// Design (warp-parallel selection, knn_topk.cu's, over sweep positions):
//  * grid = (query tiles of kWarps rows, series); one warp per query row.
//    The block stages the GATHERED columns vc[:, col_ids[p]] and their
//    ids tile by tile in shared memory; lane l takes sweep positions
//    p = p0 + 32 g + l of each 32-wide group, groups in ascending order.
//  * Each selected E's sorted list of k <= 32 (distance, id) pairs is
//    spread over the warp, lane j holding slot j in registers (MAXE, the
//    template bound on E_hi, sizes the register arrays).
//  * Offer: __ballot_sync(key < kth) marks the group's qualifiers; they
//    are inserted one at a time in ascending lane order, that is ascending
//    sweep position, the mask refreshed against each new k-th distance.
//    An insert counts the slots with distance <= key, so an equal distance
//    stays ahead: it was swept earlier.  That is knn_topk.cu's
//    ascending-id rule with "id" read as "sweep position", so the lists
//    see the sequence of one thread sweeping in order -- the earliest-
//    sweep-position rule, with no comparison on positions.  The id kept
//    is the lane's col_ids[p].
//  * Snapshots inside a group: a library size Ls can end inside a 32-wide
//    group.  Then, list by list, the qualifiers with p <= Ls - 1 are
//    inserted, the snapshot is written (lane j writes slot j, so a row's
//    k entries go out as one coalesced store), and the rest of the group
//    is inserted; several sizes in one group repeat the step.
//  * Occupancy (-Xptxas=-v, sm_90a): built, as knn_topk.cu, for 3 blocks
//    (24 warps) an SM: 80 registers a lane at MAXE 32, 24 and 16 (112 and
//    48 bytes of stack at 32 and 24, none at 16), 64 at MAXE 8; static
//    shared memory 34.8 KB at MAXE 32.  The first version held the lists
//    in shared memory, 32 or 64 rows a block, under 3 warps an SM at the
//    significance path's shape.
//
// The wide route (any E_hi, k up to 128, library sizes past a launch):
// knn_topk_prefix_wide_kernel, knn_topk.cu's wide route over sweep
// positions.  R = ceil(k / 32) slots a lane (offer_wide: each round shifts
// up one lane, lane 31 of round r - 1 into lane 0 of round r); lists for
// one window of at most W selected E whose lags span at most 32, the mask
// relative to e_lo, the lags below e_lo accumulated through L1 (__ldg of
// the gathered column) and only the window's lags staged, in the fast
// path's 32-lag tile, so shared memory and occupancy are the fast path's
// at any E.  Each launch writes its window's E rows (si0 of n_out) and
// its library sizes' rows (s0 of S_out) in place: the wrapper splits the
// selection into windows and lib_sizes into runs of at most kMaxS, and a
// size's snapshot depends only on its own prefix, so every split writes
// the tables of one launch, bit for bit.  The fast path's instantiations
// run only where one launch writes the whole output at k <= 32 and E_hi
// <= 32.  Registers: 2 R W list registers a lane, W = 24, 12, 8, 6 for R
// = 1-4.  -Xptxas=-v (sm_90a): 80 registers, 34,816 bytes of static
// shared memory, 60-64 / 128-232, 124-132 / 280-288, 132-136 / 384 and
// 108 / 496-504 bytes of spill stores / loads at R = 1, 2, 3 and 4; the
// fast path spills 100 / 172 at MAXE 24 and 920 / 1,768 at 32 with this
// toolkit.
//
// The key-select route (k past 128): knn_topk_prefix_ks_kernel,
// knn_topk.cu's over sweep positions.  A key's low word is the position p
// (the earliest-sweep-position rule), the id written col_ids[p]; the row
// holds the run's P = last size positions.  After each selected E, one
// selection per library size of the run over the positions below it: the
// first size's threshold from the last selected E's winners (positions),
// each later size's from the shorter prefix's k-th key (its k winners are
// in the longer prefix).  -Xptxas=-v (sm_90a): 64 registers, 16 / 20
// bytes of spill stores / loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/key_select.cuh"
#include "wide_lists.cuh"

namespace {

using knn_wide::offer_wide;
using knn_wide::wide_lists;

constexpr int kMaxE = 32;     // fast path: selection set is a 32-bit mask over E-1
constexpr int kFastK = 32;    // fast path: neighbours per table row = the warp width
constexpr int kWideK = 128;   // wide route: up to 4 slots a lane; past it key-select
constexpr int kSpan = 32;     // wide route: lags a window's mask spans
constexpr int kKsThreads = 512;  // key-select route: threads of a block (one row)
constexpr int kKsWords = 64;     // key-select route: 32-bit words of its lag mask
using KS = key_select::Block<kKsThreads>;
constexpr int kMaxS = 64;     // library sizes per launch
constexpr int kWarps = 8;     // query rows per block, one per warp
constexpr int kMinBlocks = 3; // blocks per SM the register budget is set for
constexpr int kTileC = 256;   // sweep positions staged per shared-memory tile
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

struct LibSizes {
  int n;
  int v[kMaxS];
};

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

// One cumulative-E distance update, knn_topk.cu's acc_sq: f32, or the
// square and the f32 sum each rounded to bfloat16.
template <bool BF16>
__device__ __forceinline__ float acc_sq(float D, float q, float c) {
  const float d = __fsub_rn(q, c);
  if (BF16) {
    const float sq = __bfloat162float(__float2bfloat16_rn(__fmul_rn(d, d)));
    return __bfloat162float(__float2bfloat16_rn(__fadd_rn(D, fmaxf(sq, 0.f))));
  }
  return __fadd_rn(D, fmaxf(__fmul_rn(d, d), 0.f));
}

// Lanes lo .. hi-1 (0 <= lo < hi <= 32).
__device__ __forceinline__ unsigned lane_range(int lo, int hi) {
  const unsigned below_hi = hi >= 32 ? kFull : ((1u << hi) - 1u);
  return below_hi & ~((1u << lo) - 1u);
}

// Offer the keys of the lanes in `lanes` (one per lane, id `cid`) to the
// sorted list (ld, li) distributed over the warp, lane j holding slot j,
// in ascending lane order.  As knn_topk.cu's offer: the new k-th distance
// after an insert is max(key, old slot k-2).
__device__ __forceinline__ void offer(float& ld, int& li, float key, int cid,
                                      unsigned lanes, int k, int lane) {
  float kth = __shfl_sync(kFull, ld, k - 1);
  unsigned qual = __ballot_sync(kFull, key < kth) & lanes;
  while (qual) {
    const int src = __ffs(qual) - 1;
    const float kk = __shfl_sync(kFull, key, src);
    const int ki = __shfl_sync(kFull, cid, src);
    const float below = __shfl_sync(kFull, ld, k >= 2 ? k - 2 : 0);
    const float up_d = __shfl_up_sync(kFull, ld, 1);
    const int up_i = __shfl_up_sync(kFull, li, 1);
    const int pos = __popc(__ballot_sync(kFull, lane < k && ld <= kk));
    kth = k >= 2 ? fmaxf(kk, below) : kk;
    qual &= (qual - 1) & __ballot_sync(kFull, key < kth);
    if (lane == pos) {
      ld = kk;
      li = ki;
    } else if (lane > pos) {
      ld = up_d;
      li = up_i;
    }
  }
}

template <int MAXE, bool BF16>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
knn_topk_prefix_kernel(const float* __restrict__ vq, const float* __restrict__ vc,
                       const int32_t* __restrict__ col_ids,
                       int32_t* __restrict__ out_idx, float* __restrict__ out_dist,
                       int E_rows, int Lq, int Lc, int k, int E_hi,
                       uint32_t sel_mask, int n_sel, int exclude_self,
                       LibSizes sizes) {
  __shared__ float vc_t[MAXE * kTileC];  // [e][kTileC], gathered columns
  __shared__ int ids_t[kTileC];          // their column ids
  __shared__ float qv_s[kWarps][MAXE];   // each warp's query coordinates

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q = blockIdx.x * kWarps + (tid >> 5);
  const bool live = q < Lq;  // warp-uniform
  const int S = sizes.n;
  const int P = sizes.v[S - 1];
  const float* vq_b = vq + (size_t)b * E_rows * Lq;
  const float* vc_b = vc + (size_t)b * E_rows * Lc;

  float* qv = qv_s[tid >> 5];  // warp-uniform reads: broadcast
  if (lane < MAXE) qv[lane] = (live && lane < E_hi) ? vq_b[(size_t)lane * Lq + q] : 0.f;
  __syncwarp();
  float ld[MAXE];
  int li[MAXE];
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    ld[e] = f_inf();
    li[e] = 0x7fffffff;
  }

  int s_next = 0;  // first library size not yet snapshot
  for (int c0 = 0; c0 < P; c0 += kTileC) {
    const int width = min(kTileC, P - c0);
    __syncthreads();  // previous tile fully consumed
    for (int j = tid; j < width; j += kWarps * 32)
      ids_t[j] = col_ids != nullptr ? col_ids[c0 + j] : c0 + j;
    __syncthreads();
    for (int i = tid; i < E_hi * kTileC; i += kWarps * 32) {
      const int e = i / kTileC, j = i - e * kTileC;
      vc_t[i] = j < width ? vc_b[(size_t)e * Lc + ids_t[j]] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int g = 0; g < width; g += 32) {
      const int j = g + lane;  // < kTileC: g <= kTileC - 32
      const bool valid = j < width;
      const int cid = valid ? ids_t[j] : 0;
      const bool masked = exclude_self && valid && cid == q;
      const int base = c0 + g;  // sweep position of lane 0
      int s_end = s_next;       // sizes ending in this group: s_next .. s_end-1
      while (s_end < S && sizes.v[s_end] <= base + 32) ++s_end;
      float D = 0.f;
#pragma unroll
      for (int e = 0; e < MAXE; ++e) {
        if (e >= E_hi) break;
        D = acc_sq<BF16>(D, qv[e], vc_t[e * kTileC + j]);
        if (!((sel_mask >> e) & 1u)) continue;
        const float key = !valid ? f_inf() : (masked ? kBig : D);
        if (s_end == s_next) {
          offer(ld[e], li[e], key, cid, kFull, k, lane);
          continue;
        }
        const int si = __popc(sel_mask & ((1u << e) - 1u));
        int lo = 0;
        for (int s = s_next; s < s_end; ++s) {
          const int hi = sizes.v[s] - base;  // positions base .. Ls-1
          offer(ld[e], li[e], key, cid, lane_range(lo, hi), k, lane);
          if (lane < k) {
            const size_t o = ((((size_t)b * S + s) * n_sel + si) * Lq + q) * k + lane;
            out_dist[o] = ld[e] >= kBig ? f_inf() : ld[e];
            out_idx[o] = li[e];
          }
          lo = hi;
        }
        if (lo < 32) offer(ld[e], li[e], key, cid, lane_range(lo, 32), k, lane);
      }
      s_next = s_end;
    }
  }
}

// The wide route: R slots a lane, lists for the selected E of one window
// (sel_mask relative to e_lo, E_hi - e_lo <= kSpan), snapshots at the
// library sizes of `sizes`, written to size rows s0 .. of S_out and E rows
// si0 .. of n_out.
template <int R, bool BF16>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
knn_topk_prefix_wide_kernel(const float* __restrict__ vq, const float* __restrict__ vc,
                            const int32_t* __restrict__ col_ids,
                            int32_t* __restrict__ out_idx, float* __restrict__ out_dist,
                            int E_rows, int Lq, int Lc, int k, int e_lo, int E_hi,
                            uint32_t sel_mask, int si0, int n_out, int s0, int S_out,
                            int exclude_self, LibSizes sizes) {
  constexpr int W = wide_lists(R);
  __shared__ float vc_t[kSpan * kTileC];  // lags e_lo .. E_hi-1, gathered columns
  __shared__ int ids_t[kTileC];           // their column ids
  __shared__ float qv_s[kWarps][kSpan];   // each warp's query coordinates there

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q = blockIdx.x * kWarps + (tid >> 5);
  const bool live = q < Lq;  // warp-uniform
  const int S = sizes.n;
  const int P = sizes.v[S - 1];
  const int span = E_hi - e_lo;
  const float* vq_b = vq + (size_t)b * E_rows * Lq;
  const float* vc_b = vc + (size_t)b * E_rows * Lc;

  float* qv = qv_s[tid >> 5];  // warp-uniform reads: broadcast
  qv[lane] = (live && lane < span) ? vq_b[(size_t)(e_lo + lane) * Lq + q] : 0.f;
  __syncwarp();
  float ld[W][R];
  int li[W][R];
#pragma unroll
  for (int w = 0; w < W; ++w)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ld[w][r] = f_inf();
      li[w][r] = 0x7fffffff;
    }

  int s_next = 0;  // first library size not yet snapshot
  for (int c0 = 0; c0 < P; c0 += kTileC) {
    const int width = min(kTileC, P - c0);
    __syncthreads();  // previous tile fully consumed
    for (int j = tid; j < width; j += kWarps * 32)
      ids_t[j] = col_ids != nullptr ? col_ids[c0 + j] : c0 + j;
    __syncthreads();
    for (int i = tid; i < span * kTileC; i += kWarps * 32) {
      const int e = i / kTileC, j = i - e * kTileC;
      vc_t[i] = j < width ? vc_b[(size_t)(e_lo + e) * Lc + ids_t[j]] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int g = 0; g < width; g += 32) {
      const int j = g + lane;  // < kTileC: g <= kTileC - 32
      const bool valid = j < width;
      const int cid = valid ? ids_t[j] : 0;
      const bool masked = exclude_self && valid && cid == q;
      const int base = c0 + g;  // sweep position of lane 0
      int s_end = s_next;       // sizes ending in this group: s_next .. s_end-1
      while (s_end < S && sizes.v[s_end] <= base + 32) ++s_end;
      // the lags below the window: distance only, read through L1
      float D = 0.f;
      for (int e = 0; e < e_lo; ++e)
        D = acc_sq<BF16>(D, __ldg(vq_b + (size_t)e * Lq + q),
                         __ldg(vc_b + (size_t)e * Lc + cid));
      uint32_t m = sel_mask;
      int e = 0;  // the window's next lag to accumulate, relative to e_lo
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (m == 0u) break;
        const int ew = __ffs(m) - 1;  // list w's lag, relative to e_lo
        m &= m - 1u;
        for (; e <= ew; ++e) D = acc_sq<BF16>(D, qv[e], vc_t[e * kTileC + j]);
        const float key = !valid ? f_inf() : (masked ? kBig : D);
        if (s_end == s_next) {
          offer_wide<R>(ld[w], li[w], key, cid, kFull, k, lane);
          continue;
        }
        int lo = 0;
        for (int s = s_next; s < s_end; ++s) {
          const int hi = sizes.v[s] - base;  // positions base .. Ls-1
          offer_wide<R>(ld[w], li[w], key, cid, lane_range(lo, hi), k, lane);
          const size_t row =
              ((((size_t)b * S_out + s0 + s) * n_out + si0 + w) * Lq + q) * k;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int slot = r * 32 + lane;
            if (slot < k) {
              out_dist[row + slot] = ld[w][r] >= kBig ? f_inf() : ld[w][r];
              out_idx[row + slot] = li[w][r];
            }
          }
          lo = hi;
        }
        if (lo < 32) offer_wide<R>(ld[w], li[w], key, cid, lane_range(lo, 32), k, lane);
      }
      s_next = s_end;
    }
  }
}

// The key-select route (k past kWideK), knn_topk.cu's over sweep
// positions: the lags of one window [e_lo, e_lo + 32 kKsWords) selected by
// the mask words, each selected E's snapshots at every library size of
// `sizes` (size rows s0 .. of S_out, E rows si0 .. of n_out); persistent
// blocks of kKsThreads, one (series, query) row at a time.  The row holds
// sweep positions [0, P), P the run's last size; a key's low word is the
// position, so equal distances go to the earliest position, and the id
// written is col_ids[p].
struct LagMask {
  uint32_t w[kKsWords];
};

template <bool BF16>
__global__ void __launch_bounds__(kKsThreads, 2)
knn_topk_prefix_ks_kernel(const float* __restrict__ vq, const float* __restrict__ vc,
                          const int32_t* __restrict__ col_ids,
                          unsigned char* __restrict__ work,
                          int32_t* __restrict__ out_idx, float* __restrict__ out_dist,
                          int B, int E_rows, int Lq, int Lc, int k, int e_lo, int E_hi,
                          LagMask sel, int si0, int n_out, int s0, int S_out,
                          int exclude_self, LibSizes sizes, int n_sm) {
  using key_select::u64;
  extern __shared__ __align__(16) unsigned char smem[];
  u64* buf = reinterpret_cast<u64*>(smem);
  u64* red = buf + KS::kCap;
  unsigned* count = reinterpret_cast<unsigned*>(red + 2 * KS::kWarps);
  u64* bcast = red + 2 * KS::kWarps + 1;
  float* d_sm = reinterpret_cast<float*>(smem + KS::kFixedBytes);
  const int S = sizes.n;
  const int P = sizes.v[S - 1];
  float* d_gm = reinterpret_cast<float*>(
      work + blockIdx.x * key_select::ks_block_bytes(P, n_sm, k));
  int32_t* wins = reinterpret_cast<int32_t*>(d_gm + (P - n_sm));  // positions
  const key_select::DistRow row{d_sm, d_gm, n_sm, 0u};
  const int tid = threadIdx.x;
  int parity = 0;
  const long long rows = (long long)B * Lq;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const int b = int(r / Lq), q = int(r - (long long)b * Lq);
    const float* vq_b = vq + (size_t)b * E_rows * Lq;
    const float* vc_b = vc + (size_t)b * E_rows * Lc;
    int si = si0;
    bool have_wins = false;
    for (int e = 0; e < E_hi; ++e) {
      const float qv = __ldg(vq_b + (size_t)e * Lq + q);
      const float* vce = vc_b + (size_t)e * Lc;
      for (int p = tid; p < P; p += kKsThreads) {
        const int cid = col_ids != nullptr ? __ldg(col_ids + p) : p;
        float* d = row.at(p);
        const uint32_t old = e == 0 ? ((exclude_self && cid == q) ? key_select::kSign : 0u)
                                    : __float_as_uint(*d);
        const float prev = __uint_as_float(old & ~key_select::kSign);
        *d = key_select::with_mask(acc_sq<BF16>(prev, qv, __ldg(vce + cid)),
                                   old & key_select::kSign);
      }
      const int rel = e - e_lo;
      if (rel < 0 || !((sel.w[rel >> 5] >> (rel & 31)) & 1u)) continue;
      __syncthreads();  // the row at lag e + 1 is whole
      u64 tau = key_select::kMaxKey;
      if (have_wins && sizes.v[0] > KS::kCap && k <= KS::kCap) {
        // the first size's winners at the last selected E: k distinct
        // positions bound the k-th key
        u64 m = 0;
        for (int j = tid; j < k; j += kKsThreads) m = key_select::umax(m, row.key(wins[j]));
        tau = key_select::block_max<kKsThreads>(m, red, parity);
      }
      for (int s = 0; s < S; ++s) {
        const int n = sizes.v[s];
        const size_t o = ((((size_t)b * S_out + s0 + s) * n_out + si) * Lq + q) * k;
        int32_t* oi = out_idx + o;
        float* od = out_dist + o;
        key_select::select_least<kKsThreads>(
            row, n, key_select::low_bits(uint32_t(n - 1)), k, tau, buf, red, count,
            parity, [&](int j, u64 key) {
              const int pos = int(uint32_t(key));
              const float v = __uint_as_float(uint32_t(key >> 32));
              oi[j] = col_ids != nullptr ? __ldg(col_ids + pos) : pos;
              od[j] = v >= kBig ? f_inf() : v;
              if (s == 0) wins[j] = pos;
              if (j == k - 1) *bcast = key;
            });
        // the k-th key of a prefix bounds the next, longer one's
        tau = *bcast;
        __syncthreads();  // every thread has read it
      }
      have_wins = true;
      ++si;
    }
    __syncthreads();  // the next row overwrites the distances
  }
}

template <bool BF16>
long long ks_grid(int n_sm, long long rows) {
  return key_select::ks_grid(knn_topk_prefix_ks_kernel<BF16>, kKsThreads,
                             KS::kFixedBytes + 4 * n_sm, rows);
}

template <int R>
int launch_wide(const float* vq, const float* vc, const int32_t* col_ids,
                int32_t* idx, float* dist, int B, int E_rows, int Lq, int Lc, int k,
                int e_lo, int E_hi, uint32_t sel_mask, int si0, int n_out, int s0,
                int S_out, int exclude_self, int bf16, const LibSizes& sizes,
                cudaStream_t stream) {
  if (__builtin_popcount(sel_mask) > wide_lists(R)) return -8;
  dim3 grid((Lq + kWarps - 1) / kWarps, B);
  if (bf16)
    knn_topk_prefix_wide_kernel<R, true><<<grid, kWarps * 32, 0, stream>>>(
        vq, vc, col_ids, idx, dist, E_rows, Lq, Lc, k, e_lo, E_hi, sel_mask, si0,
        n_out, s0, S_out, exclude_self, sizes);
  else
    knn_topk_prefix_wide_kernel<R, false><<<grid, kWarps * 32, 0, stream>>>(
        vq, vc, col_ids, idx, dist, E_rows, Lq, Lc, k, e_lo, E_hi, sel_mask, si0,
        n_out, s0, S_out, exclude_self, sizes);
  return (int)cudaGetLastError();
}

template <int MAXE>
int launch(const float* vq, const float* vc, const int32_t* col_ids,
           int32_t* idx, float* dist, int B, int E_rows, int Lq, int Lc, int k,
           int E_hi, uint32_t sel_mask, int n_sel, int exclude_self, int bf16,
           const LibSizes& sizes, cudaStream_t stream) {
  dim3 grid((Lq + kWarps - 1) / kWarps, B);
  if (bf16)
    knn_topk_prefix_kernel<MAXE, true><<<grid, kWarps * 32, 0, stream>>>(
        vq, vc, col_ids, idx, dist, E_rows, Lq, Lc, k, E_hi, sel_mask, n_sel,
        exclude_self, sizes);
  else
    knn_topk_prefix_kernel<MAXE, false><<<grid, kWarps * 32, 0, stream>>>(
        vq, vc, col_ids, idx, dist, E_rows, Lq, Lc, k, E_hi, sel_mask, n_sel,
        exclude_self, sizes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The wide route's table width: the key-select route takes k past it.
int knn_topk_prefix_wide_k() { return kWideK; }
int knn_topk_prefix_max_s() { return kMaxS; }
// Selected E a launch holds lists for at k, as knn_topk_lists.
int knn_topk_prefix_lists(int k) { return wide_lists((k + 31) / 32); }
// Lags a key-select launch's mask spans (kKsWords words).
int knn_topk_prefix_ks_span() { return 32 * kKsWords; }

// The key-select route's launch shape for a run whose last library size
// is P on the current device: its grid (blocks) and each block's device
// workspace in bytes (the launch's: grid * block bytes).  Returns 0 or a
// CUDA error.
int knn_topk_prefix_ks_shape(long long rows, int P, int k, int bf16, long long* grid,
                             long long* block_bytes) {
  const int n_sm = key_select::ks_cols_on_chip(P, KS::kFixedBytes);
  if (n_sm < 0) return (int)cudaGetLastError();
  const long long g = bf16 ? ks_grid<true>(n_sm, rows) : ks_grid<false>(n_sm, rows);
  if (g < 0) return (int)(-g);
  *grid = g;
  *block_bytes = key_select::ks_block_bytes(P, n_sm, k);
  return 0;
}

// The key-select route, any k <= lib_sizes[0]: arguments as
// knn_topk_prefix_launch's, the selection as kKsWords mask words (bit e of
// word w selects E = e_lo + 32 w + e + 1), work a device workspace of grid
// * block_bytes bytes and grid as knn_topk_prefix_ks_shape gave them for
// P = lib_sizes[S - 1].  Returns 0, a negative argument code, or the CUDA
// error of the launch.
int knn_topk_prefix_ks_launch(const float* vq, const float* vc, const int32_t* col_ids,
                              int32_t* idx, float* dist, void* work, long long grid,
                              int B, int E_rows, int Lq, int Lc, int k,
                              const unsigned int* sel_words, int e_lo, int si0,
                              int n_out, int exclude_self, int bf16,
                              const int* lib_sizes, int S, int s0, int S_out,
                              void* stream) {
  if (B < 1 || Lq < 1 || Lc < 1 || grid < 1 || grid > 0x7fffffffLL) return -1;
  if (k < 1 || k > Lc) return -2;
  if (e_lo < 0) return -3;
  LagMask sel;
  int E_hi = 0, n_sel = 0;
  for (int w = 0; w < kKsWords; ++w) {
    sel.w[w] = sel_words[w];
    n_sel += __builtin_popcount(sel_words[w]);
    if (sel_words[w]) E_hi = e_lo + 32 * w + 32 - __builtin_clz(sel_words[w]);
  }
  if (n_sel == 0) return -3;
  if (E_hi > E_rows) return -4;
  if (S < 1 || S > kMaxS || s0 < 0 || s0 + S > S_out) return -5;
  LibSizes sizes;
  sizes.n = S;
  for (int s = 0; s < S; ++s) {
    if (lib_sizes[s] < k || lib_sizes[s] > Lc) return -6;
    if (s > 0 && lib_sizes[s] <= lib_sizes[s - 1]) return -6;
    sizes.v[s] = lib_sizes[s];
  }
  if (si0 < 0 || si0 + n_sel > n_out) return -7;
  const int n_sm = key_select::ks_cols_on_chip(sizes.v[S - 1], KS::kFixedBytes);
  if (n_sm < 0) return (int)cudaGetLastError();
  const int smem = KS::kFixedBytes + 4 * n_sm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kern = bf16 ? knn_topk_prefix_ks_kernel<true> : knn_topk_prefix_ks_kernel<false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)grid, kKsThreads, smem, st>>>(
      vq, vc, col_ids, static_cast<unsigned char*>(work), idx, dist, B, E_rows, Lq, Lc,
      k, e_lo, E_hi, sel, si0, n_out, s0, S_out, exclude_self, sizes, n_sm);
  return (int)cudaGetLastError();
}

// vq (B, E_rows, Lq), vc (B, E_rows, Lc) float32 contiguous; col_ids
// (>= lib_sizes[S-1],) int32 with entries in [0, Lc) (not checked), or
// null for natural order; lib_sizes (S,) host ints, ascending, the last
// <= Lc; idx / dist (B, S_out, n_out, Lq, k), of which this launch writes
// size rows s0 .. s0 + S - 1 and E rows si0 .. si0 + popcount(sel_mask) -
// 1.  Bit e of sel_mask selects E = e_lo + e + 1 (a window of the
// selection); bf16 != 0 accumulates the distance in bfloat16.  The
// caller picks the route: fast != 0 runs knn_topk_prefix_kernel, which
// writes the whole output in one launch (e_lo 0, si0 0, n_out =
// popcount(sel_mask), s0 0, S_out = S, E_hi <= 32, k <= 32; -9
// otherwise); fast == 0 runs the wide kernel, at most
// knn_topk_prefix_lists(k) selected E a launch.  Returns 0, a negative
// argument code, or the CUDA error of the launch.
int knn_topk_prefix_launch(const float* vq, const float* vc,
                           const int32_t* col_ids, int32_t* idx, float* dist,
                           int B, int E_rows, int Lq, int Lc, int k,
                           unsigned int sel_mask, int e_lo, int si0, int n_out,
                           int exclude_self, int bf16, const int* lib_sizes, int S,
                           int s0, int S_out, int fast, void* stream) {
  if (B < 1 || Lq < 1 || Lc < 1 || B > 65535) return -1;
  if (k < 1 || k > kWideK || k > Lc) return -2;
  if (sel_mask == 0u || e_lo < 0) return -3;
  const int E_hi = e_lo + 32 - __builtin_clz(sel_mask);
  if (E_hi > E_rows) return -4;
  if (S < 1 || S > kMaxS || s0 < 0 || s0 + S > S_out) return -5;
  LibSizes sizes;
  sizes.n = S;
  for (int s = 0; s < S; ++s) {
    if (lib_sizes[s] < k || lib_sizes[s] > Lc) return -6;
    if (s > 0 && lib_sizes[s] <= lib_sizes[s - 1]) return -6;
    sizes.v[s] = lib_sizes[s];
  }
  const int n_sel = __builtin_popcount(sel_mask);
  if (si0 < 0 || si0 + n_sel > n_out) return -7;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fast) {
    if (e_lo != 0 || E_hi > kMaxE || k > kFastK || si0 != 0 || n_out != n_sel ||
        s0 != 0 || S_out != S)
      return -9;
    if (E_hi <= 8)
      return launch<8>(vq, vc, col_ids, idx, dist, B, E_rows, Lq, Lc, k, E_hi,
                       sel_mask, n_sel, exclude_self, bf16, sizes, st);
    if (E_hi <= 16)
      return launch<16>(vq, vc, col_ids, idx, dist, B, E_rows, Lq, Lc, k, E_hi,
                        sel_mask, n_sel, exclude_self, bf16, sizes, st);
    if (E_hi <= 24)
      return launch<24>(vq, vc, col_ids, idx, dist, B, E_rows, Lq, Lc, k, E_hi,
                        sel_mask, n_sel, exclude_self, bf16, sizes, st);
    return launch<32>(vq, vc, col_ids, idx, dist, B, E_rows, Lq, Lc, k, E_hi,
                      sel_mask, n_sel, exclude_self, bf16, sizes, st);
  }
  switch ((k + 31) / 32) {
    case 1:
      return launch_wide<1>(vq, vc, col_ids, idx, dist, B, E_rows, Lq, Lc, k, e_lo,
                            E_hi, sel_mask, si0, n_out, s0, S_out, exclude_self,
                            bf16, sizes, st);
    case 2:
      return launch_wide<2>(vq, vc, col_ids, idx, dist, B, E_rows, Lq, Lc, k, e_lo,
                            E_hi, sel_mask, si0, n_out, s0, S_out, exclude_self,
                            bf16, sizes, st);
    case 3:
      return launch_wide<3>(vq, vc, col_ids, idx, dist, B, E_rows, Lq, Lc, k, e_lo,
                            E_hi, sel_mask, si0, n_out, s0, S_out, exclude_self,
                            bf16, sizes, st);
    default:
      return launch_wide<4>(vq, vc, col_ids, idx, dist, B, E_rows, Lq, Lc, k, e_lo,
                            E_hi, sel_mask, si0, n_out, s0, S_out, exclude_self,
                            bf16, sizes, st);
  }
}

}  // extern "C"
