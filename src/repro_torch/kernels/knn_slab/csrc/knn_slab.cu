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
// What bounds it on this card: per (query, column, lag) the kernel does a
// subtract, a multiply and an add (3 fp32 operations) on E_max * (Lq + Lc)
// input and E_max * Lq * k output words.  At the kNN bench's Lq 128, E_max
// 20, k 21 the fp32 rate (67 TFLOP/s on an H100 SXM) bounds it from Lc
// ~1,450 up, the tables' bytes (3.35 TB/s) below.  The selection, not the
// arithmetic, sets the time.
//
// Design:
//  * grid = (Lq), one block of kThreads per query row.  The row's slab is
//    a row of the (Lq, Lc_pad) float32 workspace in device memory (the
//    TPU kernel kept a (128, Lc_pad) block of it in VMEM; a Hopper SM has
//    227 KB of shared memory, less than one row at Lc 64,000).  Thread t
//    owns the columns c = t + j * kThreads: the accumulation reads and
//    writes them coalesced, and only t ever touches them again.
//  * After the accumulation at lag e every thread holds the least key of
//    its own columns.  Selection pass j takes the block-wide least key (a
//    warp shuffle reduction, then one over the warps' winners) and writes
//    it out; only the thread that owned it rescans its columns, for its
//    least key above the one just taken.  Since keys (value, column) are
//    distinct, "the least key above the last one taken" is the k-pass
//    argmin with taken columns knocked out, without a knocked-out copy of
//    the slab: lag e + 1 accumulates onto the unmasked D, and no list of
//    taken columns is kept.  A pass costs one block reduction and one
//    thread's Lc_pad / kThreads reads, not a sweep of the row, and k is
//    bounded only by Lc_pad.
//  * The reduction's sentinel is (+inf, INT_MAX), above every real key.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 128;  // the TPU kernel's lane width: Lc_pad granularity
constexpr float kBig = 3.0e38f;
constexpr int kNone = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ bool key_less(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_min(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (key_less(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
knn_slab_kernel(const float* __restrict__ vq, const float* __restrict__ vc,
                float* __restrict__ slab, int32_t* __restrict__ out_idx,
                float* __restrict__ out_dist, int E_max, int Lq, int Lc,
                int Lc_pad, int k, int exclude_self) {
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float win_v;
  __shared__ int win_i;

  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  float* D = slab + (size_t)q * Lc_pad;
  const int self_col = exclude_self ? q : -1;

  for (int e = 0; e < E_max; ++e) {
    const float qv = vq[(size_t)e * Lq + q];
    const float* vce = vc + (size_t)e * Lc;
    // accumulate this thread's columns, keeping its least key
    float bv = f_inf();
    int bi = kNone;
    for (int c = tid; c < Lc_pad; c += kThreads) {
      float key = kBig;
      if (c < Lc) {
        const float d = __fsub_rn(qv, vce[c]);
        const float prev = e == 0 ? 0.f : D[c];
        const float acc = __fadd_rn(prev, fmaxf(__fmul_rn(d, d), 0.f));
        D[c] = acc;
        if (c != self_col) key = acc;
      }
      if (key_less(key, c, bv, bi)) {
        bv = key;
        bi = c;
      }
    }
    int32_t* oi = out_idx + ((size_t)e * Lq + q) * k;
    float* od = out_dist + ((size_t)e * Lq + q) * k;
    for (int j = 0; j < k; ++j) {
      float v = bv;
      int i = bi;
      warp_min(v, i);
      if (lane == 0) {
        red_v[warp] = v;
        red_i[warp] = i;
      }
      __syncthreads();
      if (warp == 0) {
        v = lane < kWarps ? red_v[lane] : f_inf();
        i = lane < kWarps ? red_i[lane] : kNone;
        warp_min(v, i);
        if (lane == 0) {
          win_v = v;
          win_i = i;
          oi[j] = i;
          od[j] = v;
        }
      }
      __syncthreads();
      const float lv = win_v;
      const int li = win_i;
      if (li % kThreads == tid) {
        // the owner of the key just taken: its least key above it
        bv = f_inf();
        bi = kNone;
        for (int c = tid; c < Lc_pad; c += kThreads) {
          const float key = (c < Lc && c != self_col) ? D[c] : kBig;
          if (key_less(lv, li, key, c) && key_less(key, c, bv, bi)) {
            bv = key;
            bi = c;
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int knn_slab_pad() { return kPad; }

// vq (E_max, Lq), vc (E_max, Lc) float32 contiguous; slab (Lq, Lc_pad)
// float32 workspace (no initial value needed); idx / dist (E_max, Lq, k).
// Returns 0, a negative argument code, or the CUDA error of the launch.
int knn_slab_launch(const float* vq, const float* vc, float* slab,
                    int32_t* idx, float* dist, int E_max, int Lq, int Lc,
                    int k, int exclude_self, void* stream) {
  if (E_max < 1 || Lq < 1 || Lc < 1) return -1;
  const long long Lc_pad = ((long long)Lc + kPad - 1) / kPad * kPad;
  if (Lc_pad >= kNone) return -1;
  if (k < 1 || k > Lc_pad) return -2;
  knn_slab_kernel<<<Lq, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      vq, vc, slab, idx, dist, E_max, Lq, Lc, (int)Lc_pad, k, exclude_self);
  return (int)cudaGetLastError();
}

}  // extern "C"
