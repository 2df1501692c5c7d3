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
// Output: idx (S, n_sel, Lq, k) int32 and dist (S, n_sel, Lq, k) float32,
// sorted ascending by (distance, candidate id) -- the lax.top_k tie rule.
// Masked candidates (the self column under exclude_self) take the finite
// stand-in kBig during selection and come back as +inf with their own id.
//
// What bounds it on this card: operations.  Per (query, candidate, E) the
// kernel does a subtract, a multiply and an add (3 fp32 operations) and
// reads / writes only O(S * E * (Lq + Lc)) input and O(S * n_sel * Lq * k)
// output bytes, so the fp32 rate (67 TFLOP/s on an H100 SXM) is the bound.
//
// Design (first version: right and simple, not yet fast):
//  * grid = (query tiles, series); one thread per query row; the series
//    batch is a grid dimension (the JAX side vmaps the Pallas call).
//  * Each thread sweeps ALL candidates in ascending id order, so no
//    partial lists are ever merged: a candidate enters a list only when
//    its distance is strictly below the current k-th distance (an equal
//    distance loses to the incumbent, whose id is lower).  That is the
//    lowest-id-among-equals rule with no comparison on ids at all.
//  * Candidate coordinates are staged tile by tile in shared memory and
//    read by all threads of the block at the same address (broadcast).
//  * The sorted lists, n_sel * k (distance, id) pairs per row, live in
//    shared memory laid out [list][slot][row] so that neighbouring threads
//    touch neighbouring words.  The k-th distance of every selected E is
//    held in a register (the loops over E are unrolled), so the common
//    case -- a candidate that does not enter -- costs one compare.
//  * Known weakness: the lists take n_sel * k * 8 bytes per row (3,360 B
//    at n_sel = 20, k = 21), so a block holds 32 or 64 rows and an SM one
//    or two blocks: low occupancy, latency-bound.  Later work: split the
//    candidate range across threads and merge on the (distance, id) key.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxE = 32;     // selection set is a 32-bit mask over E-1
constexpr int kMaxK = 32;     // neighbours per table row
constexpr int kTileC = 128;   // candidates staged per shared-memory tile
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

// Insert (key, id) into the sorted list `l` (k entries, stride `rows`
// between slots).  Entries with distance <= key stay ahead of it: they
// were visited earlier, so they have lower ids.  Returns the new k-th
// distance.
__device__ __noinline__ float insert_sorted(float* ld, int* li, int rows, int k,
                                            float key, int id) {
  int j = k - 1;
  while (j > 0) {
    const float prev = ld[(j - 1) * rows];
    if (prev <= key) break;
    ld[j * rows] = prev;
    li[j * rows] = li[(j - 1) * rows];
    --j;
  }
  ld[j * rows] = key;
  li[j * rows] = id;
  return ld[(k - 1) * rows];
}

__global__ void knn_topk_kernel(const float* __restrict__ vq,
                                const float* __restrict__ vc,
                                int32_t* __restrict__ out_idx,
                                float* __restrict__ out_dist, int E_rows,
                                int Lq, int Lc, int k, int E_hi,
                                uint32_t sel_mask, int n_sel,
                                int exclude_self) {
  extern __shared__ float smem[];
  const int rows = blockDim.x;
  float* vc_t = smem;                                  // [E_hi][kTileC]
  float* ld = vc_t + E_hi * kTileC;                    // [n_sel][k][rows]
  int* li = reinterpret_cast<int*>(ld + n_sel * k * rows);

  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int q = blockIdx.x * rows + tid;
  const bool live = q < Lq;
  const float* vq_s = vq + (size_t)s * E_rows * Lq;
  const float* vc_s = vc + (size_t)s * E_rows * Lc;

  for (int j = 0; j < n_sel * k; ++j) {
    ld[j * rows + tid] = f_inf();
    li[j * rows + tid] = 0x7fffffff;
  }
  float qv[kMaxE];
  float thr[kMaxE];
#pragma unroll
  for (int e = 0; e < kMaxE; ++e) {
    qv[e] = (live && e < E_hi) ? vq_s[(size_t)e * Lq + q] : 0.f;
    thr[e] = f_inf();
  }

  for (int c0 = 0; c0 < Lc; c0 += kTileC) {
    const int width = min(kTileC, Lc - c0);
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < E_hi * kTileC; i += rows) {
      const int e = i / kTileC, j = i - e * kTileC;
      vc_t[i] = j < width ? vc_s[(size_t)e * Lc + c0 + j] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < width; ++j) {
      const int cid = c0 + j;
      const bool masked = exclude_self && cid == q;
      float D = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxE; ++e) {
        if (e >= E_hi) break;
        const float d = __fsub_rn(qv[e], vc_t[e * kTileC + j]);
        D = __fadd_rn(D, fmaxf(__fmul_rn(d, d), 0.f));
        if ((sel_mask >> e) & 1u) {
          const float key = masked ? kBig : D;
          if (key < thr[e]) {
            const int si = __popc(sel_mask & ((1u << e) - 1u));
            thr[e] = insert_sorted(ld + si * k * rows + tid,
                                   li + si * k * rows + tid, rows, k, key, cid);
          }
        }
      }
    }
  }

  if (!live) return;
  for (int si = 0; si < n_sel; ++si) {
    const size_t o = (((size_t)s * n_sel + si) * Lq + q) * k;
    for (int j = 0; j < k; ++j) {
      const float dv = ld[(si * k + j) * rows + tid];
      out_dist[o + j] = dv >= kBig ? f_inf() : dv;
      out_idx[o + j] = li[(si * k + j) * rows + tid];
    }
  }
}

size_t smem_bytes(int rows, int E_hi, int n_sel, int k) {
  return (size_t)E_hi * kTileC * sizeof(float) +
         (size_t)n_sel * k * rows * (sizeof(float) + sizeof(int));
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int knn_topk_max_k() { return kMaxK; }
int knn_topk_max_e() { return kMaxE; }

// Rows per block the launch will use (0 = the lists do not fit).
int knn_topk_rows_per_block(int E_hi, int n_sel, int k) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  const int candidates[2] = {64, 32};
  for (int i = 0; i < 2; ++i) {
    if (smem_bytes(candidates[i], E_hi, n_sel, k) <= (size_t)optin)
      return candidates[i];
  }
  return 0;
}

// vq (S, E_rows, Lq), vc (S, E_rows, Lc) float32 contiguous; idx / dist
// (S, popcount(sel_mask), Lq, k).  Bit e of sel_mask selects E = e + 1;
// E_hi = highest selected E.  Returns 0, a negative argument code, or the
// CUDA error of the launch.
int knn_topk_launch(const float* vq, const float* vc, int32_t* idx,
                    float* dist, int S, int E_rows, int Lq, int Lc, int k,
                    unsigned int sel_mask, int exclude_self, void* stream) {
  if (S < 1 || Lq < 1 || Lc < 1 || S > 65535) return -1;
  if (k < 1 || k > kMaxK || k > Lc) return -2;
  if (sel_mask == 0u) return -3;
  const int E_hi = 32 - __builtin_clz(sel_mask);
  if (E_hi > E_rows || E_hi > kMaxE) return -4;
  if (exclude_self && Lq != Lc) return -5;
  const int n_sel = __builtin_popcount(sel_mask);
  const int rows = knn_topk_rows_per_block(E_hi, n_sel, k);
  if (rows == 0) return -6;
  const size_t smem = smem_bytes(rows, E_hi, n_sel, k);
  cudaError_t err = cudaFuncSetAttribute(
      knn_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + rows - 1) / rows, S);
  knn_topk_kernel<<<grid, rows, smem, static_cast<cudaStream_t>(stream)>>>(
      vq, vc, idx, dist, E_rows, Lq, Lc, k, E_hi, sel_mask, n_sel,
      exclude_self);
  return (int)cudaGetLastError();
}

}  // extern "C"
