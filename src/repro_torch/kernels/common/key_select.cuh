// key_select.cuh: selection of the k least 64-bit keys of a row by one
// block of T threads, shared by knn_slab.cu, knn_topk.cu and
// knn_topk_prefix.cu.
//
// A key is (float bits of a value >= +0 << 32) | low word, the low word a
// column id or a sweep position: keys are distinct, so one unsigned
// compare orders by value, then by the low word, and the k least keys are
// unique.  Shared memory of a block: a buffer of kCap = 2 T keys, two rows
// of block-reduction slots, a candidate count and a broadcast key
// (kFixedBytes).  A Row type gives key(c) for the columns c in [0, n).
//
//  * sort_keys / sort_emit: bitonic sort of up to kCap keys in shared
//    memory, stages of stride <= 32 with __syncwarp only.
//  * nth_key / search: the exact route.  The least key K with at least t
//    keys in [floor, K], by a bitwise search high bit first (31 value
//    bits, then the low bits the row needs; each step a count over the
//    row and one block sum); the t keys are gathered, sorted and emitted,
//    in chunks of kCap until k are out.  Exact for any k <= n and any data.
//  * select_least: the key-select route of the kNN kernels.  A row of at
//    most kCap keys is sorted whole; otherwise a threshold tau with at
//    least k keys <= tau (the caller's, or the k-th least key of kCap
//    evenly strided columns) filters the row into the buffer, which is
//    sorted, and a full buffer (or k > kCap) takes the search.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace key_select {

using u64 = unsigned long long;

constexpr unsigned kFull = 0xffffffffu;
constexpr u64 kMaxKey = ~0ull;
constexpr int kMinSort = 64;  // the smallest sort: one warp's 64 keys

template <int T>
struct Block {
  static constexpr int kWarps = T / 32;
  static constexpr int kCap = 2 * T;  // candidate keys sorted at once
  // the buffer, two rows of block-reduction slots, the candidate count and
  // a broadcast key (16 bytes)
  static constexpr int kFixedBytes = kCap * 8 + 2 * kWarps * 8 + 16;
};

__device__ __forceinline__ u64 make_key(float v, uint32_t low) {
  return (u64(__float_as_uint(v)) << 32) | low;
}

__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a > b ? a : b; }

__device__ __forceinline__ u64 umin(u64 a, u64 b) { return a < b ? a : b; }

// Block-wide max and sum, every thread gets the result; one barrier each.
// The two rows of slots alternate, so no second barrier is needed before
// the next call writes its slots.
template <int T>
__device__ u64 block_max(u64 v, u64* red, int& parity) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = umax(v, __shfl_xor_sync(kFull, v, off));
  u64* r = red + parity * Block<T>::kWarps;
  parity ^= 1;
  if ((threadIdx.x & 31) == 0) r[threadIdx.x >> 5] = v;
  __syncthreads();
  u64 m = 0;
#pragma unroll 8
  for (int w = 0; w < Block<T>::kWarps; ++w) m = umax(m, r[w]);
  return m;
}

template <int T>
__device__ unsigned block_sum(unsigned v, u64* red, int& parity) {
  v = __reduce_add_sync(kFull, v);
  u64* r = red + parity * Block<T>::kWarps;
  parity ^= 1;
  if ((threadIdx.x & 31) == 0) r[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned s = 0;
#pragma unroll 8
  for (int w = 0; w < Block<T>::kWarps; ++w) s += unsigned(r[w]);
  return s;
}

// Append the passing keys of a warp to buf (one shared atomic a warp);
// called by all 32 lanes.  The count runs on past kCap: it then says the
// buffer overflowed.
template <int T>
__device__ __forceinline__ void append(bool pass, u64 key, u64* buf, unsigned* count) {
  const unsigned m = __ballot_sync(kFull, pass);
  if (m == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  unsigned base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(kFull, base, leader);
  if (pass) {
    const unsigned pos = base + __popc(m & ((1u << lane) - 1u));
    if (pos < unsigned(Block<T>::kCap)) buf[pos] = key;
  }
}

// Ascending bitonic sort of a[0, n), n a power of two in [kMinSort, kCap],
// by every thread.  A stage of stride j <= 32 pairs keys inside one
// warp's 64, so only stages of stride >= 64, and the ones before them,
// end in a block barrier.
template <int T>
__device__ void sort_keys(u64* a, int n) {
  const int t = threadIdx.x;
  for (int size = 2; size <= n; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (t < (n >> 1)) {
        const int lo = 2 * t - (t & (j - 1));
        const int hi = lo + j;
        const u64 x = a[lo], y = a[hi];
        if ((x > y) == ((lo & size) == 0)) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      const int next = j > 1 ? j >> 1 : size;  // the next stage's stride
      if (j >= 64 || next >= 64) {
        __syncthreads();
      } else {
        __syncwarp();
      }
    }
  }
  __syncthreads();
}

// Sort the n_keys keys in buf and hand the first n_out to emit(j, key),
// j ascending from 0.
template <int T, class Emit>
__device__ void sort_emit(u64* buf, int n_keys, int n_out, const Emit& emit) {
  int n = kMinSort;
  while (n < n_keys) n <<= 1;
  for (int i = n_keys + threadIdx.x; i < n; i += T) buf[i] = kMaxKey;
  __syncthreads();
  sort_keys<T>(buf, n);
  for (int j = threadIdx.x; j < n_out; j += T) emit(j, buf[j]);
}

// The least key K with at least t keys of row.key(c), c in [0, n), in
// [floor, K]: a bitwise search, high bit first, over the value bits
// (62..32; the sign bit is 0) and the low bits 0 .. lowbits-1.
template <int T, class Row>
__device__ u64 nth_key(const Row& row, int n, int lowbits, u64 floor, int t, u64* red,
                       int& parity) {
  u64 ans = 0;
  for (int b = 62; b >= 0; --b) {
    if (b < 32 && b >= lowbits) continue;
    const u64 trial = ans | ((1ull << b) - 1);
    unsigned cnt = 0;
    for (int c = threadIdx.x; c < n; c += T) {
      const u64 key = row.key(c);
      cnt += unsigned(key >= floor && key <= trial);
    }
    if (block_sum<T>(cnt, red, parity) < unsigned(t)) ans |= 1ull << b;
  }
  return ans;
}

// The exact route: the k least keys of the row, in chunks of kCap, each
// found by nth_key, gathered, sorted and emitted (emit(j, key), j from 0
// to k - 1).  buf ends holding the last chunk, sorted.
template <int T, class Row, class Emit>
__device__ void search(const Row& row, int n, int lowbits, int k, u64* buf, u64* red,
                       unsigned* count, int& parity, const Emit& emit) {
  u64 floor = 0;
  for (int done = 0; done < k;) {
    const int t = min(Block<T>::kCap, k - done);
    const u64 last = nth_key<T>(row, n, lowbits, floor, t, red, parity);
    if (threadIdx.x == 0) *count = 0;
    __syncthreads();
    for (int c0 = 0; c0 < n; c0 += T) {  // every lane of a warp appends
      const int c = c0 + threadIdx.x;
      const u64 key = c < n ? row.key(c) : kMaxKey;
      append<T>(c < n && key >= floor && key <= last, key, buf, count);
    }
    __syncthreads();
    sort_emit<T>(buf, t, t, [&](int j, u64 key) { emit(done + j, key); });
    __syncthreads();
    done += t;
    floor = last + 1;
  }
}

// The key-select route: emit(j, key) for the k least keys of row.key(c),
// c in [0, n), j ascending from 0, 1 <= k <= n.  tau (kMaxKey: none) is a
// key with at least k keys <= tau.  Ends in a barrier.
template <int T, class Row, class Emit>
__device__ void select_least(const Row& row, int n, int lowbits, int k, u64 tau,
                            u64* buf, u64* red, unsigned* count, int& parity,
                            const Emit& emit) {
  constexpr int kCap = Block<T>::kCap;
  const int tid = threadIdx.x;
  if (n <= kCap) {
    for (int c = tid; c < n; c += T) buf[c] = row.key(c);
    sort_emit<T>(buf, n, k, emit);
    __syncthreads();
    return;
  }
  if (k <= kCap) {
    if (tau == kMaxKey) {  // kCap distinct columns, evenly strided
      for (int i = tid; i < kCap; i += T) buf[i] = row.key(int((long long)i * n / kCap));
      __syncthreads();
      sort_keys<T>(buf, kCap);
      tau = buf[k - 1];
      __syncthreads();
    }
    if (tid == 0) *count = 0;
    __syncthreads();
    for (int c0 = 0; c0 < n; c0 += T) {  // every lane of a warp appends
      const int c = c0 + tid;
      const u64 key = c < n ? row.key(c) : kMaxKey;
      append<T>(c < n && key <= tau, key, buf, count);
    }
    __syncthreads();
    const unsigned n_cand = *count;
    if (n_cand <= unsigned(kCap)) {
      sort_emit<T>(buf, int(n_cand), k, emit);
      __syncthreads();
      return;
    }
  }
  search<T>(row, n, lowbits, k, buf, red, count, parity, emit);
}

// ---- the key-select route's rows (knn_topk.cu, knn_topk_prefix.cu) ----

constexpr float kBig = 3.0e38f;  // the key value of a masked column
constexpr uint32_t kSign = 0x80000000u;

// One query row's running distances: columns [0, n_sm) in dynamic shared
// memory, the rest in the block's device workspace.  Distances are >= +0,
// so the sign bit is free: it marks a masked column, whose key is (kBig,
// low0 + c) whatever its distance.  The low word of column c is low0 + c.
struct DistRow {
  float* sm;
  float* gm;
  int n_sm;
  uint32_t low0;

  __device__ __forceinline__ float* at(int c) const {
    return c < n_sm ? sm + c : gm + (c - n_sm);
  }
  __device__ __forceinline__ u64 key(int c) const {
    const uint32_t b = __float_as_uint(*at(c));
    return (b & kSign) ? make_key(kBig, low0 + uint32_t(c))
                       : (u64(b) << 32) | (low0 + uint32_t(c));
  }
};

// The mask bit of a column (kSign or 0) and its next distance new_d >= +0.
__device__ __forceinline__ float with_mask(float new_d, uint32_t mask) {
  return __uint_as_float(__float_as_uint(new_d) | mask);
}

// Low bits that the low words 0 .. max_low need (0 for max_low 0).
__device__ __forceinline__ int low_bits(uint32_t max_low) {
  return max_low == 0 ? 0 : 32 - __clz(int(max_low));
}

// Columns of a row that fit in dynamic shared memory beside fixed_bytes on
// the current device (at most n); negative on a CUDA error.
inline int ks_cols_on_chip(int n, int fixed_bytes) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  const int cap = (optin - fixed_bytes) / 4;
  return n < cap ? n : cap;
}

// Device workspace of one block: the row's columns past n_sm (floats) and
// the last selection's k winners (ints).
__host__ __device__ inline long long ks_block_bytes(int n, int n_sm, int k) {
  return 4LL * (n - n_sm) + 4LL * k;
}

// Blocks of a persistent key-select launch over `rows` rows: the blocks
// the card holds at once, at most one a row.  Sets the kernel's dynamic
// shared memory limit on the current device first.  Negative on a CUDA
// error.
template <class Kernel>
inline long long ks_grid(Kernel kernel, int threads, int smem, long long rows) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return -(long long)err;
  const long long g = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return g < rows ? g : rows;
}

}  // namespace key_select
