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
// Output: idx / dist (B, S, n_sel, Lq, k), int32 / float32, sorted by
// (distance, sweep position); ids are original column ids col_ids[p].
// Equal distances go to the EARLIEST SWEEP POSITION (the JAX prefix
// builders' arrival rule), which with a permuted col_ids is not the
// lowest id.  The self column under exclude_self (col_ids[p] == q) takes
// the finite stand-in kBig during selection and would come back as +inf;
// with lib_sizes[0] >= k + 1 (validated by the wrapper) it never survives
// to a snapshot.
//
// What bounds it on this card: operations.  Per (query, swept position,
// lag) a subtract, a multiply and an add (3 fp32 operations) against
// O(B * E * (Lq + Lc)) input and O(B * S * n_sel * Lq * k) output bytes,
// so the fp32 rate (67 TFLOP/s on an H100 SXM) is the bound.
//
// Design (first version: right and simple, not yet fast), knn_topk.cu's
// with two changes:
//  * grid = (query tiles, series); one thread per query row sweeps the
//    positions 0 .. lib_sizes[S-1]-1 in order.  A candidate enters a list
//    only when strictly below the current k-th distance, so an equal
//    distance loses to the incumbent, which arrived earlier: that is the
//    earliest-position tie rule with no comparison on positions.
//  * Each tile stages the GATHERED columns vc[:, col_ids[p]] and their
//    ids in shared memory (one gather per block per tile, broadcast reads
//    after).  After position lib_sizes[s]-1 every thread copies its n_sel
//    sorted lists to slot s of the output: the snapshot IS the table of
//    that prefix, since the sweep up to there saw exactly its columns.
//  * Known weakness, as knn_topk.cu: the lists (n_sel * k * 8 bytes per
//    row) sit in shared memory, so a block holds 32 or 64 rows and an SM
//    one or two blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxE = 32;     // selection set is a 32-bit mask over E-1
constexpr int kMaxK = 32;     // neighbours per table row
constexpr int kMaxS = 64;     // library sizes per launch
constexpr int kTileC = 128;   // sweep positions staged per shared-memory tile
constexpr float kBig = 3.0e38f;

struct LibSizes {
  int n;
  int v[kMaxS];
};

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

// Insert (key, id) into the sorted list `l` (k entries, stride `rows`
// between slots).  Entries with distance <= key stay ahead of it: they
// arrived earlier.  Returns the new k-th distance.
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

__global__ void knn_topk_prefix_kernel(const float* __restrict__ vq,
                                       const float* __restrict__ vc,
                                       const int32_t* __restrict__ col_ids,
                                       int32_t* __restrict__ out_idx,
                                       float* __restrict__ out_dist,
                                       int E_rows, int Lq, int Lc, int k,
                                       int E_hi, uint32_t sel_mask, int n_sel,
                                       int exclude_self, LibSizes sizes) {
  extern __shared__ float smem[];
  const int rows = blockDim.x;
  float* vc_t = smem;                                        // [E_hi][kTileC]
  int* ids_t = reinterpret_cast<int*>(vc_t + E_hi * kTileC); // [kTileC]
  float* ld = reinterpret_cast<float*>(ids_t + kTileC);      // [n_sel][k][rows]
  int* li = reinterpret_cast<int*>(ld + n_sel * k * rows);

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int q = blockIdx.x * rows + tid;
  const bool live = q < Lq;
  const int S = sizes.n;
  const int P = sizes.v[S - 1];
  const float* vq_b = vq + (size_t)b * E_rows * Lq;
  const float* vc_b = vc + (size_t)b * E_rows * Lc;

  for (int j = 0; j < n_sel * k; ++j) {
    ld[j * rows + tid] = f_inf();
    li[j * rows + tid] = 0x7fffffff;
  }
  float qv[kMaxE];
  float thr[kMaxE];
#pragma unroll
  for (int e = 0; e < kMaxE; ++e) {
    qv[e] = (live && e < E_hi) ? vq_b[(size_t)e * Lq + q] : 0.f;
    thr[e] = f_inf();
  }

  int s = 0;                 // next snapshot slot
  int next = sizes.v[0];     // its library size
  for (int c0 = 0; c0 < P; c0 += kTileC) {
    const int width = min(kTileC, P - c0);
    __syncthreads();  // previous tile fully consumed
    for (int j = tid; j < width; j += rows) {
      ids_t[j] = col_ids != nullptr ? col_ids[c0 + j] : c0 + j;
    }
    __syncthreads();
    for (int i = tid; i < E_hi * kTileC; i += rows) {
      const int e = i / kTileC, j = i - e * kTileC;
      vc_t[i] = j < width ? vc_b[(size_t)e * Lc + ids_t[j]] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < width; ++j) {
      const int cid = ids_t[j];
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
      if (c0 + j + 1 == next) {  // the sweep has seen exactly prefix s
        for (int si = 0; si < n_sel; ++si) {
          const size_t o = ((((size_t)b * S + s) * n_sel + si) * Lq + q) * k;
          for (int jj = 0; jj < k; ++jj) {
            const float dv = ld[(si * k + jj) * rows + tid];
            out_dist[o + jj] = dv >= kBig ? f_inf() : dv;
            out_idx[o + jj] = li[(si * k + jj) * rows + tid];
          }
        }
        ++s;
        next = s < S ? sizes.v[s] : -1;
      }
    }
  }
}

size_t smem_bytes(int rows, int E_hi, int n_sel, int k) {
  return (size_t)E_hi * kTileC * sizeof(float) + (size_t)kTileC * sizeof(int) +
         (size_t)n_sel * k * rows * (sizeof(float) + sizeof(int));
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int knn_topk_prefix_max_k() { return kMaxK; }
int knn_topk_prefix_max_e() { return kMaxE; }
int knn_topk_prefix_max_s() { return kMaxS; }

// Rows per block the launch will use (0 = the lists do not fit).
int knn_topk_prefix_rows_per_block(int E_hi, int n_sel, int k) {
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

// vq (B, E_rows, Lq), vc (B, E_rows, Lc) float32 contiguous; col_ids
// (>= lib_sizes[S-1],) int32 with entries in [0, Lc) (not checked), or
// null for natural order; lib_sizes (S,) host ints, ascending, the last
// <= Lc; idx / dist (B, S, popcount(sel_mask), Lq, k).  Bit e of sel_mask
// selects E = e + 1.  Returns 0, a negative argument code, or the CUDA
// error of the launch.
int knn_topk_prefix_launch(const float* vq, const float* vc,
                           const int32_t* col_ids, int32_t* idx, float* dist,
                           int B, int E_rows, int Lq, int Lc, int k,
                           unsigned int sel_mask, int exclude_self,
                           const int* lib_sizes, int S, void* stream) {
  if (B < 1 || Lq < 1 || Lc < 1 || B > 65535) return -1;
  if (k < 1 || k > kMaxK || k > Lc) return -2;
  if (sel_mask == 0u) return -3;
  const int E_hi = 32 - __builtin_clz(sel_mask);
  if (E_hi > E_rows || E_hi > kMaxE) return -4;
  if (S < 1 || S > kMaxS) return -5;
  LibSizes sizes;
  sizes.n = S;
  for (int s = 0; s < S; ++s) {
    if (lib_sizes[s] < k || lib_sizes[s] > Lc) return -6;
    if (s > 0 && lib_sizes[s] <= lib_sizes[s - 1]) return -6;
    sizes.v[s] = lib_sizes[s];
  }
  const int n_sel = __builtin_popcount(sel_mask);
  const int rows = knn_topk_prefix_rows_per_block(E_hi, n_sel, k);
  if (rows == 0) return -7;
  const size_t smem = smem_bytes(rows, E_hi, n_sel, k);
  cudaError_t err = cudaFuncSetAttribute(
      knn_topk_prefix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + rows - 1) / rows, B);
  knn_topk_prefix_kernel<<<grid, rows, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      vq, vc, col_ids, idx, dist, E_rows, Lq, Lc, k, E_hi, sel_mask, n_sel,
      exclude_self, sizes);
  return (int)cudaGetLastError();
}

}  // extern "C"
