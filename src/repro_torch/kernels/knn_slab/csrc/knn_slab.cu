// knn_slab: dense-slab kNN tables at every embedding dimension, for one
// query set against one library.  Hand-written for Hopper (sm_90a), plain
// C entry point.
//
// Replaces: benchmarks/run.py::_slab_knn_pallas (its local `kernel`), the
// dense-slab Pallas kernel that the kNN selection bench times as the A/B
// partner of the streaming kernel.
//
// Computes, for query row q and every lag count e = 1..E_max: the k
// nearest library columns under the cumulative-E distance
//   D_e(q, c) = D_{e-1}(q, c) + max((vq[e, q] - vc[e, c])^2, 0),
// each op rounded on its own (__fsub_rn / __fmul_rn / __fadd_rn, built
// with --fmad=false): the float sequence of core/knn.py::_acc_sq.
// Columns are numbered over the library padded to Lc_pad = ceil(Lc / 128)
// * 128; padding columns (c >= Lc) and, with exclude_self, the column
// c == q carry the finite stand-in kBig = 3.0e38 instead of a distance.
// Row (e, q) of the output holds the k least (value, column) keys in
// ascending order -- equal values to the earliest column, the k-pass
// masked argmin of the TPU kernel -- as idx (E_max, Lq, k) int32 and dist
// (E_max, Lq, k) float32.  Where k exceeds the valid candidates the table
// ends in kBig entries and their columns (the self column, padding ids),
// as the TPU kernel's does.
//
// What bounds it on this card (launch/roofline.py::slab_counts): per
// (query, real column, lag) a subtract, a multiply and an add (3 fp32
// operations) on E_max * (Lq + Lc) input and E_max * Lq * k output words.
// At the kNN bench's Lq 128, E_max 20, k 21 the fp32 rate (67 TFLOP/s on
// an H100 SXM) bounds it from Lc ~1,450 up, the tables' bytes (3.35 TB/s)
// below.  The selection, not the arithmetic, sets the time.
//
// Design: one block of kThreads = 1024 per query row (at the bench's 128
// queries one row fills one SM), one sweep of the row a lag.  Against the
// three limits of a k-pass argmin per lag (k block reductions a lag, each
// followed by one thread's serial rescan; the slab row read and written
// in device memory every lag; one block of 512 threads a row):
//  * Keys.  A column's key is (float bits of its value << 32) | column:
//    values are >= +0 (or kBig), so one unsigned compare orders by value,
//    then column, and keys are distinct.  The k least keys are the TPU
//    kernel's k masked-argmin passes, ties and kBig entries included.
//  * A threshold, then one sweep.  Before the sweep of lag e the block
//    holds a key tau with at least k keys <= tau: the k-th least lag-e key
//    of lag e-1's candidates (k <= 32; the k distinct columns of any set
//    bound the k-th least key, and these are the query's neighbours at
//    lag e-1) or of lag e-1's k winners (k > 32).  At lag 1, and where
//    tau passes more than 2k keys of a strided sample of kCap distinct
//    columns (or, scaled to the row, more than a quarter of the buffer),
//    the sample's own k-th least key tightens it.  The sweep accumulates
//    D_e and appends every key <= tau to a buffer of kCap keys in shared
//    memory (one warp vote and shared atomic per kUnroll columns).  The
//    k least keys all pass.
//  * Selection ("filter" route).  Up to k = 32 and kRankMax candidates,
//    a thread a candidate counts the smaller keys of the buffer (its rank;
//    keys are distinct, so the ranks are a permutation) and the first k
//    write themselves out; past kRankMax candidates each warp sorts its 64
//    in registers (bitonic by shuffles) and the warps' lists merge in a
//    tree, one barrier a level.  Either way the same pass finds the k-th
//    least lag-(e+1) key of the candidates, the next threshold.  For k >
//    32 the buffer is sorted in shared memory (stages of stride <= 32 with
//    __syncwarp only).  No step leaves one thread working while the block
//    waits.
//  * Exact route ("search").  Where the candidates overflow the buffer or
//    k > kCap, the block finds the t-th least key at or above a floor by
//    a bitwise search over the key (31 value bits, then ceil(log2 Lc_pad)
//    column bits; each step a count over the row and one block sum),
//    gathers exactly those t keys, sorts and writes them, and repeats in
//    chunks of kCap until k are written.  Exact for any k up to Lc_pad
//    and any data; it is a route of this kernel, not a retry.
//  * The slab row on chip.  Columns [0, n_sm) of the row live in dynamic
//    shared memory (cudaFuncAttributeMaxDynamicSharedMemorySize up to the
//    card's opt-in limit, 227 KB on an H100: n_sm = Lc up to Lc 53,760),
//    the rest in a (Lq, Lc - n_sm) device workspace that stays in the L2.
//    Registers cannot take the rest: 1024 threads get 64 registers each,
//    all in use by the sweep and the selection, against the ~10 columns
//    a thread past 53,760.  At Lc 64,000 the workspace holds 10,240
//    columns a row, 16% of a whole-row slab's traffic.
//  * Shared code.  The keys, the block reductions, the buffer's append,
//    the bitonic sort and the search are common/key_select.cuh's, shared
//    with the key-select route of knn_topk.cu and knn_topk_prefix.cu.
//  * Counters.  Thread 0 of each block counts its (row, lag) selections by
//    route (filter, search) and those whose threshold came from the
//    sample, and adds them at its end to a small device buffer that the
//    wrapper owns.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/key_select.cuh"

namespace {

using key_select::append;
using key_select::kFull;
using key_select::kMaxKey;
using key_select::make_key;
using key_select::u64;
using key_select::umax;
using key_select::umin;

constexpr int kThreads = 1024;
using KS = key_select::Block<kThreads>;
constexpr int kWarps = KS::kWarps;
constexpr int kPad = 128;  // the TPU kernel's lane width: Lc_pad granularity
constexpr int kCap = KS::kCap;      // candidate keys sorted at once
constexpr int kWarpK = 32;          // k up to this: a warp-register selection
constexpr int kRankMax = 256;       // candidates up to this: ranked by counting
constexpr int kUnroll = 4;          // sweep columns a thread keeps in flight
constexpr float kBig = 3.0e38f;
constexpr int kNone = 0x7fffffff;
// dynamic shared memory: the buffer, two rows of block-reduction slots,
// the candidate count and a broadcast key (16 bytes), then the slab row
constexpr int kFixedBytes = KS::kFixedBytes;

enum Counter { kFilter = 0, kSearch = 1, kSampled = 2, kCounters = 3 };

__device__ __forceinline__ u64 block_max(u64 v, u64* red, int& parity) {
  return key_select::block_max<kThreads>(v, red, parity);
}

__device__ __forceinline__ unsigned block_sum(unsigned v, u64* red, int& parity) {
  return key_select::block_sum<kThreads>(v, red, parity);
}

__device__ __forceinline__ void sort_keys(u64* a, int n) {
  key_select::sort_keys<kThreads>(a, n);
}

// A warp's 32 keys, one a lane, sorted ascending across the lanes
// (bitonic, by shuffles).
__device__ __forceinline__ u64 warp_sort32(u64 x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      const u64 y = __shfl_xor_sync(kFull, x, j);
      x = (((lane & j) == 0) == ((lane & size) == 0)) ? umin(x, y) : umax(x, y);
    }
  }
  return x;
}

// A bitonic sequence of 32 keys across the lanes, sorted ascending.
__device__ __forceinline__ u64 warp_merge32(u64 x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const u64 y = __shfl_xor_sync(kFull, x, j);
    x = (lane & j) ? umax(x, y) : umin(x, y);
  }
  return x;
}

// The 32 least of the keys the block holds, two a thread (a, b), where
// only warps [0, n_warps) hold keys below kMaxKey -- with kDual, for two
// key sets at once (a, b) and (a2, b2), which share the barriers.  Each
// such warp sorts its two 32-key lists and keeps the 32 least of both
// (the lane-wise min of one list and the other reversed is bitonic); then
// the warps' lists merge pairwise in a tree through xch (2 * 32 * 32 keys
// of shared memory that no thread reads meanwhile), one barrier a level.
// Lane l of warp 0 ends with the l-th least key of each set in x and y.
template <bool kDual>
__device__ void block_least32(u64 a, u64 b, u64 a2, u64 b2, int n_warps,
                              u64* xch, u64& x, u64& y) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = y = kMaxKey;
  if (warp < n_warps) {
    a = warp_sort32(a);
    b = warp_sort32(b);
    x = warp_merge32(umin(a, __shfl_sync(kFull, b, 31 - lane)));
    if (kDual) {
      a2 = warp_sort32(a2);
      b2 = warp_sort32(b2);
      y = warp_merge32(umin(a2, __shfl_sync(kFull, b2, 31 - lane)));
    }
  }
  u64* xch2 = xch + kWarps * 32;
  for (int s = 1; s < n_warps; s <<= 1) {
    if (warp < n_warps && (warp & (2 * s - 1)) == s) {
      xch[warp * 32 + lane] = x;
      if (kDual) xch2[warp * 32 + lane] = y;
    }
    __syncthreads();
    if ((warp & (2 * s - 1)) == 0 && warp + s < n_warps) {
      x = warp_merge32(umin(x, xch[(warp + s) * 32 + 31 - lane]));
      if (kDual) y = warp_merge32(umin(y, xch2[(warp + s) * 32 + 31 - lane]));
    }
  }
}

// One query row's slab: columns [0, n_sm) in shared memory, the rest in
// the device workspace.
struct Row {
  float* sm;
  float* gm;
  int n_sm, Lc, self;

  __device__ __forceinline__ float get(int c) const {
    return c < n_sm ? sm[c] : gm[c - n_sm];
  }
  // the key of column c after this lag's sweep
  __device__ __forceinline__ u64 key(int c) const {
    return (c < Lc && c != self) ? make_key(get(c), c) : make_key(kBig, c);
  }
};

// Is key (v, c) <= the threshold (hi, lo)?  A compare of the value bits
// first, so the sweep builds no 64-bit key for the columns that fail.
__device__ __forceinline__ bool at_most(float v, int c, unsigned hi,
                                        unsigned lo) {
  const unsigned b = __float_as_uint(v);
  return b < hi || (b == hi && unsigned(c) <= lo);
}

// The sweep of one lag over the real columns [c0, c1), whose slab values
// are P[0, c1 - c0): accumulate D_e into P and append the keys <= (hi,
// lo) to buf (kBig for the self column).  kUnroll columns a thread are
// loaded before any is used; then one vote a warp for all of them.
__device__ void sweep(float* P, int c0, int c1, const float* __restrict__ vce,
                      float qv, bool first, int self, bool filter, unsigned hi,
                      unsigned lo, u64* buf, unsigned* count) {
  int base = c0;
  for (; base + kUnroll * kThreads <= c1; base += kUnroll * kThreads) {
    const int c = base + threadIdx.x;
    float v[kUnroll], x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      x[u] = vce[c + u * kThreads];
      v[u] = first ? 0.f : P[c - c0 + u * kThreads];
    }
    unsigned pass = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float d = __fsub_rn(qv, x[u]);
      const float acc = __fadd_rn(v[u], fmaxf(__fmul_rn(d, d), 0.f));
      P[c - c0 + u * kThreads] = acc;
      v[u] = c + u * kThreads == self ? kBig : acc;
      pass |= unsigned(at_most(v[u], c + u * kThreads, hi, lo)) << u;
    }
    if (filter && __any_sync(kFull, pass != 0)) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        append<kThreads>((pass >> u) & 1u, make_key(v[u], c + u * kThreads), buf,
                         count);
    }
  }
  for (; base < c1; base += kThreads) {  // the rest: one column a thread
    const int c = base + threadIdx.x;
    float v = kBig;
    if (c < c1) {
      const float d = __fsub_rn(qv, vce[c]);
      const float acc = __fadd_rn(first ? 0.f : P[c - c0],
                                  fmaxf(__fmul_rn(d, d), 0.f));
      P[c - c0] = acc;
      if (c != self) v = acc;
    }
    if (filter)
      append<kThreads>(c < c1 && at_most(v, c, hi, lo), make_key(v, c), buf, count);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
knn_slab_kernel(const float* __restrict__ vq, const float* __restrict__ vc,
                float* __restrict__ spill, int32_t* __restrict__ out_idx,
                float* __restrict__ out_dist,
                unsigned long long* __restrict__ counters, int E_max, int Lq,
                int Lc, int Lc_pad, int n_sm, int k, int exclude_self) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* buf = reinterpret_cast<u64*>(smem);
  u64* red = buf + kCap;
  unsigned* count = reinterpret_cast<unsigned*>(red + 2 * kWarps);
  u64* bcast = red + 2 * kWarps + 1;

  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const Row row{reinterpret_cast<float*>(smem + kFixedBytes),
                spill + (size_t)q * (Lc - n_sm), n_sm, Lc,
                exclude_self ? q : -1};
  const bool filter = k <= kCap;       // else every lag takes the search
  const bool warp_k = k <= kWarpK;     // else the selections sort the buffer
  const bool sampled = Lc_pad > kCap;  // else the buffer holds the row
  const int colbits = 32 - __clz(Lc_pad - 1);
  int parity = 0;
  unsigned long long routes[kCounters] = {0, 0, 0};  // thread 0's
  float qv_next = vq[q];

  for (int e = 0; e < E_max; ++e) {
    const float qv = qv_next;
    const bool last_lag = e + 1 == E_max;
    if (!last_lag) qv_next = vq[(size_t)(e + 1) * Lq + q];
    const float* vce = vc + (size_t)e * Lc;
    // the lag-e key of column c, before the sweep writes it
    auto next_key = [&](int c) -> u64 {
      if (c >= Lc || c == row.self) return make_key(kBig, c);
      const float d = __fsub_rn(qv, vce[c]);
      const float prev = e == 0 ? 0.f : row.get(c);
      return make_key(__fadd_rn(prev, fmaxf(__fmul_rn(d, d), 0.f)), c);
    };
    // the lag-(e+1) key of a lag-e key: its column's D_e is the key's value
    auto rekey = [&](u64 key) -> u64 {
      const int c = int(uint32_t(key));
      if (last_lag || key == kMaxKey || c >= Lc || c == row.self) return key;
      const float d = __fsub_rn(qv_next, vce[Lc + c]);
      return make_key(__fadd_rn(__uint_as_float(uint32_t(key >> 32)),
                                fmaxf(__fmul_rn(d, d), 0.f)), c);
    };

    // ---- the threshold tau: at least k keys are <= tau
    u64 tau = kMaxKey;
    if (filter) {
      if (e > 0 && warp_k) {
        tau = *bcast;  // set by lag e-1's selection
      } else if (e > 0) {  // lag e-1's winners, still in buf[0, k)
        u64 m = 0;
        for (int j = tid; j < k; j += kThreads)
          m = umax(m, next_key(int(uint32_t(buf[j]))));
        tau = block_max(m, red, parity);
      }
      if (sampled) {  // kCap distinct columns, evenly strided
        const u64 s0 = next_key(int((long long)tid * Lc_pad / kCap));
        const u64 s1 =
            next_key(int((long long)(tid + kThreads) * Lc_pad / kCap));
        bool use = e == 0;
        if (!use) {  // tau passes over 2k sample keys, or over a quarter
                     // of the buffer's worth of the row
          const unsigned ns = block_sum(
              unsigned(s0 <= tau) + unsigned(s1 <= tau), red, parity);
          use = ns > unsigned(2 * k) || (unsigned long long)ns * Lc_pad >
                                            (unsigned long long)kCap * (kCap / 4);
        }
        if (use) {
          if (warp_k) {
            u64 x, unused;
            block_least32<false>(s0, s1, 0, 0, kWarps, buf, x, unused);
            if (tid == k - 1) *bcast = x;
          } else {
            buf[tid] = s0;
            buf[tid + kThreads] = s1;
            __syncthreads();
            sort_keys(buf, kCap);
            if (tid == 0) *bcast = buf[k - 1];
          }
          __syncthreads();
          tau = umin(tau, *bcast);
          if (tid == 0) ++routes[kSampled];
        }
      }
    }
    if (tid == 0) *count = 0;
    __syncthreads();

    // ---- the sweep: accumulate D_e, keep the keys <= tau
    const unsigned hi = unsigned(tau >> 32), lo = unsigned(tau);
    sweep(row.sm, 0, min(n_sm, Lc), vce, qv, e == 0, row.self, filter, hi, lo,
          buf, count);
    if (n_sm < Lc)
      sweep(row.gm, n_sm, Lc, vce, qv, e == 0, row.self, filter, hi, lo, buf,
            count);
    if (filter) {  // the padding columns, keyed kBig
      for (int c = (Lc & ~31) + tid; c < Lc_pad; c += kThreads)
        append<kThreads>(c >= Lc && at_most(kBig, c, hi, lo), make_key(kBig, c), buf,
                         count);
    }
    __syncthreads();
    const unsigned n_cand = *count;

    // ---- the selection
    int32_t* oi = out_idx + ((size_t)e * Lq + q) * k;
    float* od = out_dist + ((size_t)e * Lq + q) * k;
    auto emit = [&](int j, u64 key) {
      oi[j] = int32_t(uint32_t(key));
      od[j] = __uint_as_float(uint32_t(key >> 32));
    };
    if (filter && n_cand <= unsigned(kCap)) {
      if (warp_k && n_cand <= unsigned(kRankMax)) {
        // the same two selections by rank: candidate t's rank is the count
        // of smaller keys (distinct keys: the ranks are a permutation)
        const int n = int(n_cand);
        u64* next = buf + kCap / 2;
        u64 a = kMaxKey, a2 = kMaxKey;
        if (tid < n) {
          a = buf[tid];
          a2 = next[tid] = rekey(a);
        }
        __syncthreads();
        if (tid < n) {
          int r = 0, r2 = 0;
#pragma unroll 4
          for (int j = 0; j < n; ++j) {
            r += int(buf[j] < a);
            r2 += int(next[j] < a2);
          }
          if (r < k) {
            oi[r] = int32_t(uint32_t(a));
            od[r] = __uint_as_float(uint32_t(a >> 32));
          }
          if (r2 == k - 1) *bcast = a2;
        }
        __syncthreads();
      } else if (warp_k) {
        // lag e's k least candidates, and the k-th least lag-(e+1) key of
        // the same candidates: the next lag's threshold (any k distinct
        // columns bound it; these are near the query)
        const int w64 = (tid >> 5) * 64 + (tid & 31);
        const u64 a = w64 < int(n_cand) ? buf[w64] : kMaxKey;
        const u64 b = w64 + 32 < int(n_cand) ? buf[w64 + 32] : kMaxKey;
        const u64 a2 = rekey(a), b2 = rekey(b);
        __syncthreads();
        u64 x, y;
        block_least32<true>(a, b, a2, b2, (int(n_cand) + 63) / 64, buf, x, y);
        if (tid < k) {
          oi[tid] = int32_t(uint32_t(x));
          od[tid] = __uint_as_float(uint32_t(x >> 32));
        }
        if (tid == k - 1) *bcast = y;
        __syncthreads();
      } else {
        key_select::sort_emit<kThreads>(buf, int(n_cand), k, emit);
      }
      if (tid == 0) ++routes[kFilter];
    } else {
      key_select::search<kThreads>(row, Lc_pad, colbits, k, buf, red, count, parity,
                                   emit);
      if (warp_k && tid < 32) {  // the next threshold: the winners' bound
        u64 m = tid < k ? rekey(buf[tid]) : 0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          m = umax(m, __shfl_xor_sync(kFull, m, off));
        if (tid == 0) *bcast = m;
      }
      __syncthreads();
      if (tid == 0) ++routes[kSearch];
    }
  }
  if (tid == 0) {
    for (int i = 0; i < kCounters; ++i)
      if (routes[i]) atomicAdd(&counters[i], routes[i]);
  }
}

// Columns of a row that fit in shared memory beside the buffer, on the
// current device; negative on a CUDA error.
int row_cols_on_chip(int Lc) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  const int cap = (optin - kFixedBytes) / 4 / kPad * kPad;
  return Lc < cap ? Lc : cap;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int knn_slab_pad() { return kPad; }

int knn_slab_capacity() { return kCap; }

int knn_slab_counters() { return kCounters; }

// Columns of each query row that go to the device workspace (the rest of
// the row lives in shared memory); negative on an error.
int knn_slab_spill_cols(int Lc) {
  const int n_sm = row_cols_on_chip(Lc);
  return n_sm < 0 ? n_sm : Lc - n_sm;
}

// vq (E_max, Lq), vc (E_max, Lc) float32 contiguous; spill (Lq,
// knn_slab_spill_cols(Lc)) float32 workspace (no initial value needed);
// idx / dist (E_max, Lq, k); counters knn_slab_counters() uint64, added
// to.  Returns 0, a negative argument code, or the CUDA error of the
// launch.
int knn_slab_launch(const float* vq, const float* vc, float* spill,
                    int32_t* idx, float* dist, unsigned long long* counters,
                    int E_max, int Lq, int Lc, int k, int exclude_self,
                    void* stream) {
  if (E_max < 1 || Lq < 1 || Lc < 1) return -1;
  const long long Lc_pad = ((long long)Lc + kPad - 1) / kPad * kPad;
  if (Lc_pad >= kNone) return -1;
  if (k < 1 || k > Lc_pad) return -2;
  const int n_sm = row_cols_on_chip(Lc);
  if (n_sm < 0) return (int)cudaGetLastError();
  const int smem = kFixedBytes + n_sm * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      knn_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  knn_slab_kernel<<<Lq, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      vq, vc, spill, idx, dist, counters, E_max, Lq, Lc, (int)Lc_pad, n_sm, k,
      exclude_self);
  return (int)cudaGetLastError();
}

}  // extern "C"
