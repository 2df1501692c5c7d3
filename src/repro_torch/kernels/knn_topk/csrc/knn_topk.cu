// knn_topk: streaming kNN tables at a set of embedding dimensions, for a
// batch of series.  Hand-written for Hopper (sm_90a), plain C entry point.
//
// Replaces: src/repro/kernels/knn_topk/knn_topk.py::knn_topk_stream_kernel
// (the Pallas kernel that builds every kNN table of phase 1 and phase 2).
//
// Computes, for series s, query row q and every E in the selection set:
// the k nearest candidates under the dimension-E delay-embedding distance
//   D_E(q, c) = sum_{e < E} (vq[s, e, q] - vc[s, e, c])^2,
// accumulated as the cumulative-E recurrence with pinned rounding
//   d = vq - vc;  D = D + max(d * d, 0)      (each op rounded on its own,
// built with --fmad=false and written with __fsub_rn/__fmul_rn/__fadd_rn),
// which is the float sequence of the JAX reference (core/knn.py::_acc_sq).
// With bf16 set (the JAX dist_dtype="bfloat16" branch) the square and the
// sum are each rounded to bfloat16 (acc_sq below): the float sequence of
// the plain version's eager bf16 ops.
// Output: idx (S, n_sel, Lq, k) int32 and dist (S, n_sel, Lq, k) float32,
// sorted ascending by (distance, candidate id) -- the lax.top_k tie rule.
// Masked candidates (the self column under exclude_self) take the finite
// stand-in kBig during selection and come back as +inf with their own id.
// Column range (library sharding): candidate column c of vc is global
// candidate col_offset + c, the id the tables hold; columns with
// col_offset + c >= col_hi are masked as above, and exclude_self masks the
// global id equal to the query row, so Lq may differ from the shard's Lc.
// The default range (0, Lc) is the unsharded table, bit for bit.
//
// What bounds it on this card: operations.  Per (query, candidate, E) the
// kernel does a subtract, a multiply and an add (3 fp32 operations) and
// reads / writes only O(S * E * (Lq + Lc)) input and O(S * n_sel * Lq * k)
// output bytes, so the fp32 rate (67 TFLOP/s on an H100 SXM) is the bound.
// In practice the selection, not the arithmetic, sets the time: every
// candidate is tested against n_sel lists, and about k (1 + ln(Lc / k))
// candidates per list are inserted.
//
// Design (warp-parallel selection):
//  * grid = (query tiles of kWarps rows, series); one warp per query row.
//    The block stages candidate coordinates tile by tile in shared memory
//    ([e][kTileC]); lane l takes candidates c = c0 + 32 g + l of each
//    32-wide group, groups in ascending order, so the lanes read
//    consecutive words.  The query's coordinates are warp-uniform, kept
//    in shared memory (a broadcast read), which leaves the registers to
//    the lists.
//  * Each lane runs the cumulative-E recurrence for its candidate with the
//    pinned ops above; after each selected E it offers its key to that
//    E's list.
//  * Each selected E has one sorted list of k <= 32 (distance, id) pairs
//    distributed over the warp: lane j holds slot j, in registers (the
//    loops over E are unrolled, so the lists are register arrays indexed
//    by E; MAXE, the template bound on E_hi, sizes them).  The k-th
//    distance is read from lane k - 1 and is warp-uniform.
//  * Offer: __ballot_sync(key < kth) marks the group's qualifiers; they are
//    inserted one at a time in ascending lane order, that is ascending
//    candidate id, and after each insert the mask is refreshed against the
//    new k-th distance.  An insert counts the slots with distance <= key
//    (a ballot: equal distances stay ahead, since they were visited
//    earlier and so have lower ids), and the slots at and after that
//    position move up one lane (__shfl_up_sync).  The new k-th distance
//    is max(key, old slot k - 2), known before the shift lands, so the
//    next qualifier's test does not wait for it.
//  * Tie order: this is exactly the rule of one thread sweeping the
//    candidates in id order.  Candidates reach each list in ascending id
//    order; one enters only if
//    its key is strictly below the k-th distance at its turn, and it goes
//    behind every entry of equal distance.  So among equal distances the
//    lower id wins and comes first, as lax.top_k's rule, with no
//    comparison on ids; the tables are bit-identical to the plain version.
//  * Occupancy: lists in shared memory would take n_sel * k * 8 bytes a
//    query (3,360 B at n_sel 20, k 21), one 64-thread block an SM; in
//    registers they take 2 * MAXE a lane, and blocks of 8 warps fill the
//    card (phase 2 at Lq 1,430: 179 x 8 blocks).  The inserts are chains
//    of dependent shuffles and ballots, so the kernel is latency-bound
//    and occupancy pays: it is built for 3 blocks (24 warps) an SM, 80
//    registers a lane (-Xptxas=-v: 64 at MAXE 8; 80 at 16; 80 with 32 / 72
//    bytes of spill stores / loads at 24 and 384 / 1,472 at 32).  Times
//    against 2 blocks an SM: PERF.md.
//
// The wide route (any E_hi, k up to 128): the fast path above holds k <=
// 32 slots, one a lane, and a list for every lag up to E_hi <= 32 (a
// 32-bit selection mask, a [E][kTileC] tile of at most 32 lags).  Past
// either bound knn_topk_wide_kernel runs instead; the fast path's
// instantiations are untouched.
//  * R = ceil(k / 32) slots a lane: lane j holds slots j, j + 32, ...
//    An insert moves every slot at or after the insert position up one:
//    each round shifts up one lane and lane 0 of round r takes lane 31 of
//    round r - 1 (one shuffle a round: lane 31 sends round r - 1, the
//    others round r).  The k-th distance is read from slot k - 1 and the
//    one after an insert is still max(key, old slot k - 2), so the tie
//    rule and the insert order are the fast path's: the tables stay
//    bit-equal to the plain version.
//  * Selection windows: a launch keeps lists for at most W selected E (W
//    from R, below) whose lags span at most 32, [e_lo, E_hi); its mask is
//    relative to e_lo and fits 32 bits.  The wrapper splits the selection
//    into windows, one launch each, and each launch writes its rows of the
//    output in place (row offset si0 of n_out rows a series).  Each launch
//    runs the same cumulative recurrence from lag 0 with the same pinned
//    ops, so the distances at a window's lags are the fast path's, bit for
//    bit.  The lists are indexed by their rank in the window (the loop over
//    them is unrolled), so lags the window does not select hold no
//    registers.
//  * Staging: only the window's lags (at most 32) are staged a tile, in
//    the fast path's static [32][kTileC] tile (32 KB), so occupancy stays
//    at 3 blocks an SM at any E.  The lags below e_lo only accumulate
//    distance; they are read through L1 (__ldg: a lane's candidate column
//    is coalesced across the warp and shared by the block's 8 warps), so
//    no E_max needs more shared memory than the fast path.  Dynamic
//    shared memory for all E_hi lags would cost occupancy past 48 KB
//    (E_hi 48 at kTileC 256) and still bound E_max; chunks of lags staged
//    in turn would hold one distance a candidate group in registers, which
//    the lists need.
//  * Registers: 2 R W list registers a lane; W = 24, 12, 8 and 6 for R =
//    1, 2, 3 and 4 keeps them at 48, within the fast path's budget of 80
//    at 3 blocks an SM.  -Xptxas=-v (sm_90a): 80 registers and 33,792
//    bytes of static shared memory at every R, with 24 / 40, 32-36 /
//    52-60, 40 / 100 and 56-64 / 116-124 bytes of spill stores / loads at
//    R = 1, 2, 3 and 4 (the offer's R shifted copies), less than the fast
//    path's at MAXE 24 and 32.
//
// The key-select route (k past 128, any k <= Lc): knn_topk_ks_kernel.
// Register lists stop at R = 4, so past them a row's candidates are
// selected as keys (common/key_select.cuh, shared with knn_slab.cu):
//  * key = (float bits of D << 32) | global id; keys are distinct, so
//    one unsigned compare is the (distance, lowest id) rule.  A masked
//    candidate keys as (kBig, id): the masked ones sort last in id
//    order, as the plain version's stable sort puts its +inf entries.
//    The mask is the sign bit of the row's stored D (D >= +0), set at
//    lag 1.
//  * Persistent blocks of kKsThreads, one (series, query) row at a time:
//    the row's D for all Lc candidates in dynamic shared memory up to the
//    card's opt-in limit, the rest in the block's device workspace (the
//    wrapper allocates grid x block bytes, knn_topk_ks_shape).  One sweep
//    of the row a lag, with the pinned acc_sq; after each selected E one
//    selection (select_least): a row of at most 1,024 keys is sorted
//    whole; past it the last selected E's k winners, re-keyed at this E,
//    bound the k-th key (the first E: the k-th of 1,024 strided columns),
//    the keys at or below that bound are gathered and sorted, and a full
//    buffer or k > 1,024 takes the exact bitwise search.  The k least
//    keys are written sorted.  One launch holds every selected E up to lag
//    2,048 (kKsWords mask words).
//  * What bounds it: the tables written (bytes) at the smoke's shapes;
//    the selection's sort sets the time.  -Xptxas=-v (sm_90a): 64
//    registers, no spill, at __launch_bounds__(512, 2).

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
constexpr int kWarps = 8;     // query rows per block, one per warp
constexpr int kMinBlocks = 3; // blocks per SM the register budget is set for
constexpr int kTileC = 256;   // candidates staged per shared-memory tile
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

// One cumulative-E distance update of D by the lag difference of q and c.
// f32: D + max(d * d, 0), each op rounded on its own.  BF16: the square
// rounded to bfloat16, then the sum taken in f32 and rounded to bfloat16
// -- how eager PyTorch adds two bf16 tensors (never a native bf16 add,
// which rounds once and can differ where the exponents are far apart).
// D then holds a bfloat16 value in an f32 register, and the selection key
// is that value, as in the f32 route.
template <bool BF16>
__device__ __forceinline__ float acc_sq(float D, float q, float c) {
  const float d = __fsub_rn(q, c);
  if (BF16) {
    const float sq = __bfloat162float(__float2bfloat16_rn(__fmul_rn(d, d)));
    return __bfloat162float(__float2bfloat16_rn(__fadd_rn(D, fmaxf(sq, 0.f))));
  }
  return __fadd_rn(D, fmaxf(__fmul_rn(d, d), 0.f));
}

// Offer the group's keys (one per lane, candidate id c_base + lane) to the
// sorted list (ld, li) distributed over the warp, lane j holding slot j.
// The new k-th distance after an insert is max(key, old slot k-2) -- the
// key itself when it lands in slot k-1 -- so it is known without waiting
// for the shift, and the next qualifier's test overlaps the insert.
__device__ __forceinline__ void offer(float& ld, int& li, float key, int c_base,
                                      int k, int lane) {
  float kth = __shfl_sync(kFull, ld, k - 1);
  unsigned qual = __ballot_sync(kFull, key < kth);
  while (qual) {
    const int src = __ffs(qual) - 1;
    const float kk = __shfl_sync(kFull, key, src);
    const float below = __shfl_sync(kFull, ld, k >= 2 ? k - 2 : 0);
    const float up_d = __shfl_up_sync(kFull, ld, 1);
    const int up_i = __shfl_up_sync(kFull, li, 1);
    const int pos = __popc(__ballot_sync(kFull, lane < k && ld <= kk));
    kth = k >= 2 ? fmaxf(kk, below) : kk;
    qual &= (qual - 1) & __ballot_sync(kFull, key < kth);
    if (lane == pos) {
      ld = kk;
      li = c_base + src;
    } else if (lane > pos) {
      ld = up_d;
      li = up_i;
    }
  }
}

template <int MAXE, bool BF16>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
knn_topk_kernel(const float* __restrict__ vq, const float* __restrict__ vc,
                int32_t* __restrict__ out_idx, float* __restrict__ out_dist,
                int E_rows, int Lq, int Lc, int k, int E_hi, uint32_t sel_mask,
                int n_sel, int exclude_self, int col_offset, int col_hi) {
  __shared__ float vc_t[MAXE * kTileC];  // [e][kTileC]
  __shared__ float qv_s[kWarps][MAXE];    // each warp's query coordinates

  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q = blockIdx.x * kWarps + (tid >> 5);
  const bool live = q < Lq;  // warp-uniform
  const float* vq_s = vq + (size_t)s * E_rows * Lq;
  const float* vc_s = vc + (size_t)s * E_rows * Lc;

  float* qv = qv_s[tid >> 5];  // warp-uniform reads: broadcast
  if (lane < MAXE) qv[lane] = (live && lane < E_hi) ? vq_s[(size_t)lane * Lq + q] : 0.f;
  __syncwarp();
  float ld[MAXE];
  int li[MAXE];
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    ld[e] = f_inf();
    li[e] = 0x7fffffff;
  }

  for (int c0 = 0; c0 < Lc; c0 += kTileC) {
    const int width = min(kTileC, Lc - c0);
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < E_hi * kTileC; i += kWarps * 32) {
      const int e = i / kTileC, j = i - e * kTileC;
      vc_t[i] = j < width ? vc_s[(size_t)e * Lc + c0 + j] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int g = 0; g < width; g += 32) {
      const int j = g + lane;  // < kTileC: g <= kTileC - 32
      const int gid = col_offset + c0 + j;  // the global candidate id
      const bool valid = j < width;
      const bool masked = gid >= col_hi || (exclude_self && gid == q);
      float D = 0.f;
#pragma unroll
      for (int e = 0; e < MAXE; ++e) {
        if (e >= E_hi) break;
        D = acc_sq<BF16>(D, qv[e], vc_t[e * kTileC + j]);
        if ((sel_mask >> e) & 1u) {
          const float key = !valid ? f_inf() : (masked ? kBig : D);
          offer(ld[e], li[e], key, col_offset + c0 + g, k, lane);
        }
      }
    }
  }

  if (!live || lane >= k) return;
  int si = 0;
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    if (e >= E_hi) break;
    if ((sel_mask >> e) & 1u) {
      const size_t o = (((size_t)s * n_sel + si) * Lq + q) * k + lane;
      out_dist[o] = ld[e] >= kBig ? f_inf() : ld[e];
      out_idx[o] = li[e];
      ++si;
    }
  }
}

// The wide route: R slots a lane, lists for the selected E of one window
// (sel_mask relative to e_lo, E_hi - e_lo <= kSpan), written to rows si0 ..
// of the n_out rows a series.
template <int R, bool BF16>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
knn_topk_wide_kernel(const float* __restrict__ vq, const float* __restrict__ vc,
                     int32_t* __restrict__ out_idx, float* __restrict__ out_dist,
                     int E_rows, int Lq, int Lc, int k, int e_lo, int E_hi,
                     uint32_t sel_mask, int si0, int n_out, int exclude_self,
                     int col_offset, int col_hi) {
  constexpr int W = wide_lists(R);
  __shared__ float vc_t[kSpan * kTileC];  // lags e_lo .. E_hi-1: [e - e_lo][kTileC]
  __shared__ float qv_s[kWarps][kSpan];   // each warp's query coordinates there

  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q = blockIdx.x * kWarps + (tid >> 5);
  const bool live = q < Lq;  // warp-uniform
  const int span = E_hi - e_lo;
  const float* vq_s = vq + (size_t)s * E_rows * Lq;
  const float* vc_s = vc + (size_t)s * E_rows * Lc;

  float* qv = qv_s[tid >> 5];  // warp-uniform reads: broadcast
  qv[lane] = (live && lane < span) ? vq_s[(size_t)(e_lo + lane) * Lq + q] : 0.f;
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

  for (int c0 = 0; c0 < Lc; c0 += kTileC) {
    const int width = min(kTileC, Lc - c0);
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < span * kTileC; i += kWarps * 32) {
      const int e = i / kTileC, j = i - e * kTileC;
      vc_t[i] = j < width ? vc_s[(size_t)(e_lo + e) * Lc + c0 + j] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int g = 0; g < width; g += 32) {
      const int j = g + lane;  // < kTileC: g <= kTileC - 32
      const int gid = col_offset + c0 + j;  // the global candidate id
      const bool valid = j < width;
      const bool masked = gid >= col_hi || (exclude_self && gid == q);
      // the lags below the window: distance only, read through L1
      const float* vcj = vc_s + c0 + (valid ? j : 0);
      float D = 0.f;
      for (int e = 0; e < e_lo; ++e)
        D = acc_sq<BF16>(D, __ldg(vq_s + (size_t)e * Lq + q), __ldg(vcj + (size_t)e * Lc));
      uint32_t m = sel_mask;
      int e = 0;  // the window's next lag to accumulate, relative to e_lo
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (m == 0u) break;
        const int ew = __ffs(m) - 1;  // list w's lag, relative to e_lo
        m &= m - 1u;
        for (; e <= ew; ++e) D = acc_sq<BF16>(D, qv[e], vc_t[e * kTileC + j]);
        const float key = !valid ? f_inf() : (masked ? kBig : D);
        offer_wide<R>(ld[w], li[w], key, gid, kFull, k, lane);
      }
    }
  }

  if (!live) return;
  const int n_win = __popc(sel_mask);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (w >= n_win) break;
    const size_t row = (((size_t)s * n_out + si0 + w) * Lq + q) * k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int slot = r * 32 + lane;
      if (slot < k) {
        out_dist[row + slot] = ld[w][r] >= kBig ? f_inf() : ld[w][r];
        out_idx[row + slot] = li[w][r];
      }
    }
  }
}

// The key-select route (k past kWideK): the lags of one window [e_lo,
// e_lo + 32 kKsWords) selected by the mask words, lags below e_lo only
// accumulated; persistent blocks of kKsThreads, one (series, query) row
// at a time.  Rows si0 .. of the n_out rows a series.
struct LagMask {
  uint32_t w[kKsWords];
};

template <bool BF16>
__global__ void __launch_bounds__(kKsThreads, 2)
knn_topk_ks_kernel(const float* __restrict__ vq, const float* __restrict__ vc,
                   unsigned char* __restrict__ work, int32_t* __restrict__ out_idx,
                   float* __restrict__ out_dist, int S, int E_rows, int Lq, int Lc,
                   int k, int e_lo, int E_hi, LagMask sel, int si0, int n_out,
                   int exclude_self, int col_offset, int col_hi, int n_sm) {
  using key_select::u64;
  extern __shared__ __align__(16) unsigned char smem[];
  u64* buf = reinterpret_cast<u64*>(smem);
  u64* red = buf + KS::kCap;
  unsigned* count = reinterpret_cast<unsigned*>(red + 2 * KS::kWarps);
  float* d_sm = reinterpret_cast<float*>(smem + KS::kFixedBytes);
  float* d_gm = reinterpret_cast<float*>(
      work + blockIdx.x * key_select::ks_block_bytes(Lc, n_sm, k));
  int32_t* wins = reinterpret_cast<int32_t*>(d_gm + (Lc - n_sm));  // columns
  const key_select::DistRow row{d_sm, d_gm, n_sm, uint32_t(col_offset)};
  const int tid = threadIdx.x;
  const int lowbits = key_select::low_bits(uint32_t(col_offset + Lc - 1));
  const int hi = col_hi - col_offset;  // columns at or past it are masked
  int parity = 0;
  const long long rows = (long long)S * Lq;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const int s = int(r / Lq), q = int(r - (long long)s * Lq);
    const float* vq_s = vq + (size_t)s * E_rows * Lq;
    const float* vc_s = vc + (size_t)s * E_rows * Lc;
    const int self = exclude_self ? q - col_offset : -1;
    int si = si0;
    bool have_wins = false;
    for (int e = 0; e < E_hi; ++e) {
      const float qv = __ldg(vq_s + (size_t)e * Lq + q);
      const float* vce = vc_s + (size_t)e * Lc;
      for (int c = tid; c < Lc; c += kKsThreads) {
        float* d = row.at(c);
        const uint32_t old =
            e == 0 ? ((c >= hi || c == self) ? key_select::kSign : 0u) : __float_as_uint(*d);
        const float prev = __uint_as_float(old & ~key_select::kSign);
        *d = key_select::with_mask(acc_sq<BF16>(prev, qv, __ldg(vce + c)),
                                   old & key_select::kSign);
      }
      const int rel = e - e_lo;
      if (rel < 0 || !((sel.w[rel >> 5] >> (rel & 31)) & 1u)) continue;
      __syncthreads();  // the row at lag e + 1 is whole
      u64 tau = key_select::kMaxKey;
      if (have_wins && Lc > KS::kCap && k <= KS::kCap) {
        // the last selection's winners: k distinct columns bound the k-th key
        u64 m = 0;
        for (int j = tid; j < k; j += kKsThreads) m = key_select::umax(m, row.key(wins[j]));
        tau = key_select::block_max<kKsThreads>(m, red, parity);
      }
      const size_t o = (((size_t)s * n_out + si) * Lq + q) * k;
      int32_t* oi = out_idx + o;
      float* od = out_dist + o;
      key_select::select_least<kKsThreads>(
          row, Lc, lowbits, k, tau, buf, red, count, parity, [&](int j, u64 key) {
            const uint32_t low = uint32_t(key);
            const float v = __uint_as_float(uint32_t(key >> 32));
            oi[j] = int32_t(low);
            od[j] = v >= kBig ? f_inf() : v;
            wins[j] = int32_t(low) - col_offset;
          });
      have_wins = true;
      ++si;
    }
    __syncthreads();  // the next row overwrites the distances
  }
}

template <bool BF16>
long long ks_grid(int n_sm, long long rows) {
  return key_select::ks_grid(knn_topk_ks_kernel<BF16>, kKsThreads,
                             KS::kFixedBytes + 4 * n_sm, rows);
}

template <int R>
int launch_wide(const float* vq, const float* vc, int32_t* idx, float* dist, int S,
                int E_rows, int Lq, int Lc, int k, int e_lo, int E_hi,
                uint32_t sel_mask, int si0, int n_out, int exclude_self,
                int col_offset, int col_hi, int bf16, cudaStream_t stream) {
  if (__builtin_popcount(sel_mask) > wide_lists(R)) return -9;
  dim3 grid((Lq + kWarps - 1) / kWarps, S);
  if (bf16)
    knn_topk_wide_kernel<R, true><<<grid, kWarps * 32, 0, stream>>>(
        vq, vc, idx, dist, E_rows, Lq, Lc, k, e_lo, E_hi, sel_mask, si0, n_out,
        exclude_self, col_offset, col_hi);
  else
    knn_topk_wide_kernel<R, false><<<grid, kWarps * 32, 0, stream>>>(
        vq, vc, idx, dist, E_rows, Lq, Lc, k, e_lo, E_hi, sel_mask, si0, n_out,
        exclude_self, col_offset, col_hi);
  return (int)cudaGetLastError();
}

template <int MAXE>
int launch(const float* vq, const float* vc, int32_t* idx, float* dist, int S,
           int E_rows, int Lq, int Lc, int k, int E_hi, uint32_t sel_mask,
           int n_sel, int exclude_self, int col_offset, int col_hi, int bf16,
           cudaStream_t stream) {
  dim3 grid((Lq + kWarps - 1) / kWarps, S);
  if (bf16)
    knn_topk_kernel<MAXE, true><<<grid, kWarps * 32, 0, stream>>>(
        vq, vc, idx, dist, E_rows, Lq, Lc, k, E_hi, sel_mask, n_sel, exclude_self,
        col_offset, col_hi);
  else
    knn_topk_kernel<MAXE, false><<<grid, kWarps * 32, 0, stream>>>(
        vq, vc, idx, dist, E_rows, Lq, Lc, k, E_hi, sel_mask, n_sel, exclude_self,
        col_offset, col_hi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The wide route's table width: the key-select route takes k past it.
int knn_topk_wide_k() { return kWideK; }
// Selected E a launch holds lists for at k (a window of the selection):
// the fast path's 32 where k <= 32 and every selected E is at most 32.
int knn_topk_lists(int k) { return wide_lists((k + 31) / 32); }
int knn_topk_span() { return kSpan; }
// Lags a key-select launch's mask spans (kKsWords words).
int knn_topk_ks_span() { return 32 * kKsWords; }

// The key-select route's launch shape for rows of Lc columns on the
// current device: its grid (blocks) and each block's device workspace in
// bytes; the workspace of a launch is grid * block bytes.  Returns 0 or a
// CUDA error.
int knn_topk_ks_shape(long long rows, int Lc, int k, int bf16, long long* grid,
                      long long* block_bytes) {
  const int n_sm = key_select::ks_cols_on_chip(Lc, KS::kFixedBytes);
  if (n_sm < 0) return (int)cudaGetLastError();
  const long long g = bf16 ? ks_grid<true>(n_sm, rows) : ks_grid<false>(n_sm, rows);
  if (g < 0) return (int)(-g);
  *grid = g;
  *block_bytes = key_select::ks_block_bytes(Lc, n_sm, k);
  return 0;
}

// The key-select route, any k <= Lc: arguments as knn_topk_launch's, the
// selection as kKsWords mask words (bit e of word w selects E = e_lo + 32 w
// + e + 1), work a device workspace of grid * block_bytes bytes and grid
// as knn_topk_ks_shape gave them.  Returns 0, a negative argument code,
// or the CUDA error of the launch.
int knn_topk_ks_launch(const float* vq, const float* vc, int32_t* idx, float* dist,
                       void* work, long long grid, int S, int E_rows, int Lq, int Lc,
                       int k, const unsigned int* sel_words, int e_lo, int si0,
                       int n_out, int exclude_self, int col_offset, int col_hi,
                       int bf16, void* stream) {
  if (S < 1 || Lq < 1 || Lc < 1 || grid < 1 || grid > 0x7fffffffLL) return -1;
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
  if (col_offset < 0 || col_hi < 0 || (long long)col_hi > (long long)col_offset + Lc)
    return -5;
  if (exclude_self && Lq < col_hi) return -6;
  if (si0 < 0 || si0 + n_sel > n_out) return -7;
  const int n_sm = key_select::ks_cols_on_chip(Lc, KS::kFixedBytes);
  if (n_sm < 0) return (int)cudaGetLastError();
  const int smem = KS::kFixedBytes + 4 * n_sm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kern = bf16 ? knn_topk_ks_kernel<true> : knn_topk_ks_kernel<false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)grid, kKsThreads, smem, st>>>(
      vq, vc, static_cast<unsigned char*>(work), idx, dist, S, E_rows, Lq, Lc, k, e_lo,
      E_hi, sel, si0, n_out, exclude_self, col_offset, col_hi, n_sm);
  return (int)cudaGetLastError();
}

// vq (S, E_rows, Lq), vc (S, E_rows, Lc) float32 contiguous; idx / dist
// (S, n_out, Lq, k), of which this launch writes rows si0 ..
// si0 + popcount(sel_mask) - 1 of each series.  Bit e of sel_mask selects
// E = e_lo + e + 1 (a window of the selection); E_hi = the highest
// selected E.  Candidate column c is global id col_offset + c; global ids
// >= col_hi are masked (0 <= col_hi <= col_offset + Lc; with exclude_self
// also col_hi <= Lq).  bf16 != 0 accumulates the distance in bfloat16.
// The caller picks the route: fast != 0 runs knn_topk_kernel, which
// takes the whole selection in one launch (e_lo 0, si0 0, n_out =
// popcount(sel_mask), E_hi <= 32, k <= 32; -8 otherwise); fast == 0 runs
// knn_topk_wide_kernel, at most knn_topk_lists(k) selected E a launch.
// Returns 0, a negative argument code, or the CUDA error of the launch.
int knn_topk_launch(const float* vq, const float* vc, int32_t* idx,
                    float* dist, int S, int E_rows, int Lq, int Lc, int k,
                    unsigned int sel_mask, int e_lo, int si0, int n_out,
                    int exclude_self, int col_offset, int col_hi, int bf16,
                    int fast, void* stream) {
  if (S < 1 || Lq < 1 || Lc < 1 || S > 65535) return -1;
  if (k < 1 || k > kWideK || k > Lc) return -2;
  if (sel_mask == 0u || e_lo < 0) return -3;
  const int E_hi = e_lo + 32 - __builtin_clz(sel_mask);
  if (E_hi > E_rows) return -4;
  if (col_offset < 0 || col_hi < 0 || (long long)col_hi > (long long)col_offset + Lc)
    return -5;
  if (exclude_self && Lq < col_hi) return -6;
  const int n_sel = __builtin_popcount(sel_mask);
  if (si0 < 0 || si0 + n_sel > n_out) return -7;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fast) {
    if (e_lo != 0 || E_hi > kMaxE || k > kFastK || si0 != 0 || n_out != n_sel)
      return -8;
    if (E_hi <= 8)
      return launch<8>(vq, vc, idx, dist, S, E_rows, Lq, Lc, k, E_hi, sel_mask,
                       n_sel, exclude_self, col_offset, col_hi, bf16, st);
    if (E_hi <= 16)
      return launch<16>(vq, vc, idx, dist, S, E_rows, Lq, Lc, k, E_hi, sel_mask,
                        n_sel, exclude_self, col_offset, col_hi, bf16, st);
    if (E_hi <= 24)
      return launch<24>(vq, vc, idx, dist, S, E_rows, Lq, Lc, k, E_hi, sel_mask,
                        n_sel, exclude_self, col_offset, col_hi, bf16, st);
    return launch<32>(vq, vc, idx, dist, S, E_rows, Lq, Lc, k, E_hi, sel_mask,
                      n_sel, exclude_self, col_offset, col_hi, bf16, st);
  }
  switch ((k + 31) / 32) {
    case 1:
      return launch_wide<1>(vq, vc, idx, dist, S, E_rows, Lq, Lc, k, e_lo, E_hi,
                            sel_mask, si0, n_out, exclude_self, col_offset, col_hi,
                            bf16, st);
    case 2:
      return launch_wide<2>(vq, vc, idx, dist, S, E_rows, Lq, Lc, k, e_lo, E_hi,
                            sel_mask, si0, n_out, exclude_self, col_offset, col_hi,
                            bf16, st);
    case 3:
      return launch_wide<3>(vq, vc, idx, dist, S, E_rows, Lq, Lc, k, e_lo, E_hi,
                            sel_mask, si0, n_out, exclude_self, col_offset, col_hi,
                            bf16, st);
    default:
      return launch_wide<4>(vq, vc, idx, dist, S, E_rows, Lq, Lc, k, e_lo, E_hi,
                            sel_mask, si0, n_out, exclude_self, col_offset, col_hi,
                            bf16, st);
  }
}

}  // extern "C"
