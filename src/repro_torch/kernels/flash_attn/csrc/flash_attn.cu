// flash_attn: flash-attention forward with an online softmax, GQA-aware.
// Hand-written for Hopper (sm_90a), plain C entry point.
//
// Replaces: src/repro/kernels/flash_attn/flash_attn.py::_flash_kernel
// (through flash_attn_pallas / ops.py::flash_attn).
//
// Computes, per batch b and query head h (kv head g = h / (H / K)),
//   o[b, i, h] = sum_j softmax_j(s_ij) v[b, j, g],  s_ij = (q[b, i, h] / sqrt(dh)) . k[b, j, g]
// with s_ij = -1e30 where causal and i < j (top-left aligned, as the
// Pallas kernel), over the keys j < Sk only: a key at or beyond Sk never
// enters the softmax (the JAX wrapper pads keys with zeros, which the
// non-causal softmax then counts; this kernel masks them itself).
// q (B, Sq, H, dh), k / v (B, Sk, K, dh), o like q; read and written in
// that layout, float32 or bfloat16, all math in float32.
//
// What bounds it on this card: operations.  4 * B * H * dh * Sq * Sk
// (halved when causal) against 989 TFLOP/s of bf16 tensor cores; the
// bytes are q, k, v read once and o written once.  At the qwen2.5-3b
// serve shape (B 4, S 2048, H 16, K 2, dh 128, bf16, causal) that is
// 68.75 GFLOP, 0.0695 ms, against 75.5 MB, 0.0225 ms.
//
// Design (first version, CUDA cores, no tensor cores): one block of 256
// threads per (query tile of 64 rows, batch * head); the heaviest causal
// tiles are scheduled first.  The block stages its q tile (scaled) in
// shared memory once, then per tile of 64 keys stages k and v (zero past
// Sk and past dh), computes the 64 x 64 logits with each thread owning a
// 4 x 4 sub-tile, masks, updates the per-row running max m and sum l
// (the 16 threads of a row reduce with warp shuffles), writes p into the
// k buffer and accumulates p . v into a 4 x (D / 16) register tile.  Key
// tiles wholly above the causal diagonal are skipped.  Output
// acc / max(l, 1e-30).  The products are explicit fmaf calls, so the
// library's --fmad=false (kept for the kNN kernels' pinned rounding)
// does not split them; it does keep the rescales and exponent arguments
// as separate multiplies and adds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                // query rows per block
constexpr int kBK = 64;                // keys per tile
constexpr int kThreads = 256;
constexpr int kTX = 16;                // threads along keys / head dim
constexpr int kTY = kThreads / kTX;    // threads along query rows
constexpr int kRows = kBQ / kTY;       // query rows per thread (4)
constexpr int kCols = kBK / kTX;       // keys per thread (4)
constexpr int kPLD = kBK + 1;          // row stride of p in shared memory
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Shared-memory floats of one block for head-dim capacity D.
template <int D>
constexpr int smem_floats() {
  constexpr int ld = D + 1;
  constexpr int kreg = kBK * ld > kBQ * kPLD ? kBK * ld : kBQ * kPLD;
  return kBQ * ld + kreg + kBK * ld;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                  int H, int K, int dh, int causal, float scale) {
  constexpr int LD = D + 1;   // odd row stride: column reads are conflict-free
  constexpr int kDC = D / kTX;  // head-dim columns per thread
  constexpr int kKReg = kBK * LD > kBQ * kPLD ? kBK * LD : kBQ * kPLD;
  extern __shared__ float smem[];
  float* Qs = smem;            // [kBQ][LD], q * scale
  float* Ks = Qs + kBQ * LD;   // [kBK][LD]; then p [kBQ][kPLD]
  float* Vs = Ks + kKReg;      // [kBK][LD]
  float* Ps = Ks;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int g = h / (H / K);
  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;

  const size_t q_row = (size_t)H * dh;   // elements between positions of q / o
  const size_t kv_row = (size_t)K * dh;  // ... of k / v
  const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * dh;
  const T* kb = k + (size_t)b * Sk * kv_row + (size_t)g * dh;
  const T* vb = v + (size_t)b * Sk * kv_row + (size_t)g * dh;
  T* ob = o + (size_t)b * Sq * q_row + (size_t)h * dh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (q0 + r < Sq && d < dh) x = to_f32(qb[(size_t)(q0 + r) * q_row + d]) * scale;
    Qs[r * LD + d] = x;
  }

  float m[kRows], l[kRows], acc[kRows][kDC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + kBQ, Sq) - 1;
  int n_kt = (Sk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, q_last / kBK + 1);  // skip tiles above the diagonal

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // q staged / the previous tile's p and v consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < Sk && d < dh) {
        const size_t off = (size_t)(k0 + r) * kv_row + d;
        kx = to_f32(kb[off]);
        vx = to_f32(vb[off]);
      }
      Ks[r * LD + d] = kx;
      Vs[r * LD + d] = vx;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty + kTY * i) * LD + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + kTX * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty + kTY * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + kTX * j;
        if (kpos >= Sk) s[i][j] = -INFINITY;  // no such key: exp gives 0
        else if (causal && qpos < kpos) s[i][j] = kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done reading Ks: p goes there
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) Ps[(ty + kTY * i) * kPLD + tx + kTX * j] = s[i][j];
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows], vv[kDC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty + kTY * i) * kPLD + c];
#pragma unroll
      for (int cc = 0; cc < kDC; ++cc) vv[cc] = Vs[c * LD + tx + kTX * cc];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int cc = 0; cc < kDC; ++cc) acc[i][cc] = __fmaf_rn(pv[i], vv[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty + kTY * i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < kDC; ++cc) {
      const int d = tx + kTX * cc;
      if (d < dh) ob[(size_t)r * q_row + d] = from_f32<T>(acc[i][cc] / den);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int H, int K, int dh, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)dh));
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attn_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, K, dh, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, int B, int Sq,
              int Sk, int H, int K, int dh, int causal, cudaStream_t stream) {
  if (dh <= 32) return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, K, dh, causal, stream);
  if (dh <= 64) return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, K, dh, causal, stream);
  return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, K, dh, causal, stream);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Sq, H, dh), k / v (B, Sk, K, dh), o (B, Sq, H, dh), contiguous,
// all of one type: dtype 0 = float32, 1 = bfloat16.  H % K == 0,
// 1 <= dh <= 128, B * H <= 65535.  Returns 0, a negative argument code,
// or the CUDA error of the launch.
int flash_attn_launch(const void* q, const void* k, const void* v, void* o,
                      int dtype, int B, int Sq, int Sk, int H, int K, int dh,
                      int causal, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || K < 1 || dh < 1) return -1;
  if (H % K != 0) return -2;
  if (dh > 128) return -3;
  if ((long long)B * H > 65535) return -4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dh<float>(q, k, v, o, B, Sq, Sk, H, K, dh, causal, s);
  if (dtype == 1) return launch_dh<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, K, dh, causal, s);
  return -5;
}

}  // extern "C"
