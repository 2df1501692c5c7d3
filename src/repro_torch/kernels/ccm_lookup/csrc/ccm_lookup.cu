// ccm_lookup: batched CCM lookup (paper Alg. 5) for targets that share a
// library table.  Hand-written for Hopper (sm_90a), plain C entry point.
//
// Replaces: src/repro/kernels/ccm_lookup/ccm_lookup.py::ccm_lookup_kernel.
//
// Computes  out[s, b, t] = sum_j w[s, t, j] * Y[b, idx[s, t, j]]
// for S tables (one per library series of a chunk; S = 1 is the JAX op's
// signature), idx / w (S, Lq, k), Y (B, Lp) -> out (S, B, Lq), float32.
// The sum runs over j in ascending order, each product and sum rounded on
// its own (built with --fmad=false), which is the order of the plain
// PyTorch version in ref.py.
//
// What bounds it on this card: bytes.  The function reads idx and w
// (8 * S * Lq * k bytes) and Y (4 * B * Lp) and writes 4 * S * B * Lq;
// it does 2 operations per (s, b, t, j).  At S = 1, B = 2048, Lq = Lp =
// 1430, k = 21 that is 23.7 MB, about 7 us at 3.35 TB/s, against about
// 1.8 us of fp32 arithmetic at 67 TFLOP/s.
//
// Design (first version): grid = (time blocks of kT, target blocks of
// kTargets, S).  A block stages its time block's idx and w in shared
// memory once, then for each of its targets copies the target's Y row
// into shared memory (coalesced) and lets each thread gather its k
// neighbours from there -- the random gather never touches device memory.
// Each Y row is read from device memory (or L2) once per time block; the
// output is written coalesced along t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 256;        // time points per block, one per thread
constexpr int kTargets = 32;   // targets (Y rows) per block

__global__ void ccm_lookup_kernel(const int32_t* __restrict__ idx,
                                  const float* __restrict__ w,
                                  const float* __restrict__ Y,
                                  float* __restrict__ out, int Lq, int k,
                                  int B, int Lp) {
  extern __shared__ float smem[];
  int* sidx = reinterpret_cast<int*>(smem);  // [kT][k]
  float* sw = smem + kT * k;                 // [kT][k]
  float* yrow = sw + kT * k;                 // [Lp]

  const int s = blockIdx.z;
  const int t0 = blockIdx.x * kT;
  const int b0 = blockIdx.y * kTargets;
  const int tid = threadIdx.x;
  const int nt = min(kT, Lq - t0);
  const int32_t* idx_s = idx + ((size_t)s * Lq + t0) * k;
  const float* w_s = w + ((size_t)s * Lq + t0) * k;
  for (int i = tid; i < nt * k; i += blockDim.x) {
    sidx[i] = idx_s[i];
    sw[i] = w_s[i];
  }
  const int b1 = min(b0 + kTargets, B);
  for (int b = b0; b < b1; ++b) {
    __syncthreads();  // staging done / previous row consumed
    const float* yb = Y + (size_t)b * Lp;
    for (int i = tid; i < Lp; i += blockDim.x) yrow[i] = yb[i];
    __syncthreads();
    if (tid < nt) {
      float acc = 0.f;
      for (int j = 0; j < k; ++j)
        acc = __fadd_rn(acc, __fmul_rn(sw[tid * k + j], yrow[sidx[tid * k + j]]));
      out[((size_t)s * B + b) * Lq + t0 + tid] = acc;
    }
  }
}

size_t smem_bytes(int k, int Lp) {
  return (size_t)kT * k * (sizeof(int) + sizeof(float)) + (size_t)Lp * sizeof(float);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// idx (S, Lq, k) int32, w (S, Lq, k) float32, Y (B, Lp) float32, all
// contiguous; out (S, B, Lq).  Every idx entry must lie in [0, Lp).
// Returns 0, a negative argument code, or the CUDA error of the launch.
int ccm_lookup_launch(const int32_t* idx, const float* w, const float* Y,
                      float* out, int S, int Lq, int k, int B, int Lp,
                      void* stream) {
  if (S < 1 || S > 65535 || Lq < 1 || k < 1 || B < 1 || Lp < 1) return -1;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(k, Lp);
  if (smem > (size_t)optin) return -2;
  const int tb = (B + kTargets - 1) / kTargets;
  if (tb > 65535) return -3;
  err = cudaFuncSetAttribute(ccm_lookup_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + kT - 1) / kT, tb, S);
  ccm_lookup_kernel<<<grid, kT, smem, static_cast<cudaStream_t>(stream)>>>(
      idx, w, Y, out, Lq, k, B, Lp);
  return (int)cudaGetLastError();
}

}  // extern "C"
