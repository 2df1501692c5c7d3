// flash_attn: flash-attention forward with an online softmax, GQA-aware.
// Hand-written for Hopper (sm_90a), plain C entry points.
//
// Replaces: src/repro/kernels/flash_attn/flash_attn.py::_flash_kernel
// (through flash_attn_pallas / ops.py::flash_attn).
//
// Computes, per batch b and query head h (kv head g = h / (H / K)),
//   o[b, i, h] = sum_j softmax_j(s_ij) v[b, j, g],  s_ij = (q[b, i, h] / sqrt(dh)) . k[b, j, g]
// with s_ij = -1e30 where causal and p_i < j, p_i the position of query
// row i: i itself (top-left aligned, as the Pallas kernel) or q_pos[i]
// where a position array is given, over the keys j < Sk only: a key at or beyond Sk never
// enters the softmax (the JAX wrapper pads keys with zeros, which the
// non-causal softmax then counts; these kernels mask them themselves).
// q (B, Sq, H, dh), k / v (B, Sk, K, dh), o like q; read and written in
// that layout in place.
//
// Positions (q_pos, int32 (Sq,), optional): the rows of one rank of
// sequence-parallel attention (sharding/attention.py) are a subset of the
// sequence -- a contiguous run, or C / n rows of every chunk of C --, so
// row i attends to the keys j <= q_pos[i].  q_pos must be non-decreasing
// (the wrapper asserts it on the device): a tile's last row then holds its
// largest position, which bounds the key tiles it reads, and its first row
// the smallest, which says whether a key tile needs the mask.  A tile's
// last position does not fall as its index grows, so the launch order of
// the top-left kernels (the highest tile index first) still runs the
// heaviest tiles first.  Without positions the pointer is null and the
// kernels are the top-left ones, bit for bit.
//
// What bounds it on this card: operations.  4 * B * H * dh * Sq * Sk
// (halved when causal) against 989 TFLOP/s of bf16 tensor cores; the
// bytes are q, k, v read once and o written once.  At the qwen2.5-3b
// serve shape (B 4, S 2048, H 16, K 2, dh 128, bf16, causal) that is
// 68.75 GFLOP, 0.0695 ms, against 75.5 MB, 0.0225 ms.
//
// Two kernels, routed statically by the wrapper (ops.py::flash_route):
//
// flash_attn_wgmma_launch -- bfloat16 with dh a multiple of 16 up to 128,
// on the tensor cores (the prefill route).  On the CUDA cores the
// kernel is bound by shared-memory loads (8 per 16 FMAs in q.k^T), far
// below the bound; here the products run on wgmma and the loads are
// asynchronous:
//  * one block of 288 threads per (128 query rows, batch * head), the
//    heaviest causal tiles first (the query tile is the slow grid
//    dimension, so the first wave takes the longest rows of every head);
//  * warp 8 is the producer: one thread loads the block's q once and then
//    K and V tiles of 64 keys through TMA (cp.async.bulk.tensor, 4-D maps
//    over (dh, heads, S, B), so (B, S, K, dh) is read in place with a row
//    stride of K * dh * 2 bytes) into a ring of kStages stages, 128-byte
//    swizzled, each stage guarded by a full and an empty mbarrier;
//  * warps 0-7 are two consumer warpgroups of 64 query rows each.  Per
//    stage: S = q k^T with wgmma m64n64k16 (both operands K-major from
//    shared memory, f32 accumulate), the masks, the online softmax in f32
//    (exp2f with scale * log2(e) folded into one multiply-add), p rounded
//    to bf16 in registers -- the accumulator layout of S is the A-fragment
//    layout -- and o += p v with wgmma m64n{64,128}k16, A from registers,
//    v from shared memory through the transpose bit (MN-major B);
//  * keys >= Sk: TMA zero-fills rows past Sk (and columns past dh, which
//    pad dh to 64 or 128), and the kernel still masks those keys to -inf;
//    a warpgroup skips the tiles wholly past its last row's position;
//  * p is rounded to bf16 before p v, as in every such kernel, so the
//    result is not one bf16 rounding of the f32 plain version: the checks
//    hold it to twice the error of F.scaled_dot_product_attention on the
//    same inputs (and 0.04 at most), and each element to one bf16 step
//    plus twice that error in its own row.
//
// flash_attn_launch -- every other case (float32, the gate route; bf16 at
// other head dims) on the CUDA cores: one block of 256 threads per (query
// tile of 64 rows, batch * head); the heaviest causal tiles are scheduled
// first.  The block stages its q tile (scaled) in shared memory once,
// then per tile of 64 keys stages k and v
// (zero past Sk and past dh), computes the 64 x 64 logits with each thread
// owning a 4 x 4 sub-tile, masks, updates the per-row running max m and
// sum l (the 16 threads of a row reduce with warp shuffles), writes p
// into the k buffer and accumulates p . v into a 4 x (D / 16) register
// tile.  Key tiles wholly past the tile's last position are skipped.  Output
// acc / max(l, 1e-30), all math in float32.  The products are explicit
// fmaf calls, so --fmad=false (every kernel's flag; the float32 gate's
// numbers rest on this code's rounding) does not split them; it does keep
// the rescales and exponent arguments as separate multiplies and adds.

#include <cuda.h>
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
                  int H, int K, int dh, int causal, float scale,
                  const int* __restrict__ qpos) {
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
  const int p_last = qpos ? qpos[q_last] : q_last;  // the tile's largest position
  int n_kt = (Sk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, p_last / kBK + 1);  // skip tiles past it
  int qp[kRows];  // each row's position (a row past Sq: the last row's)
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty + kTY * i;
    qp[i] = qpos ? qpos[min(r, Sq - 1)] : r;
  }

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
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + kTX * j;
        if (kpos >= Sk) s[i][j] = -INFINITY;  // no such key: exp gives 0
        else if (causal && qp[i] < kpos) s[i][j] = kNeg;
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
           int Sk, int H, int K, int dh, int causal, const int* qpos,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)dh));
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attn_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, K, dh, causal, scale, qpos);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, int B, int Sq,
              int Sk, int H, int K, int dh, int causal, const int* qpos,
              cudaStream_t stream) {
  if (dh <= 32) return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, K, dh, causal, qpos, stream);
  if (dh <= 64) return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, K, dh, causal, qpos, stream);
  return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, K, dh, causal, qpos, stream);
}

}  // namespace

// ---------------------------------------------------------------------------
// The tensor-core route: bfloat16, dh a multiple of 16 up to 128.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBQ = 128;          // query rows per block: two warpgroups of 64
constexpr int kBK = 64;           // keys per stage
constexpr int kStages = 2;        // K / V ring depth
constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kSub = 64;          // head-dim columns of one 128-byte swizzle row
constexpr int kSubBytes = 64 * kSub * 2;   // one 64-row x 64-column bf16 sub-tile
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// Shared-memory bytes of one block for padded head dim D (64 or 128):
// q (2 warpgroups), the K and V rings, 1 KB of alignment slack and the
// barriers.
template <int D>
constexpr int smem_bytes() {
  return 1024 + (2 + 2 * kStages) * (D / kSub) * kSubBytes + 64;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Waits for the phase of parity `parity` to complete.  A wait that spins
// 2^26 times (seconds; a launch takes milliseconds) traps: a broken
// pipeline fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t spins = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++spins == (1u << 26)) asm volatile("trap;");
  } while (!done);
}

// One 4-D TMA tile load into shared memory, completion on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving accesses of the registers across the
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (m64n64, f32) (+)= A (smem desc, K-major) * B (smem desc, K-major)^T
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (m64n64, f32) += A (registers, bf16 fragments) * B (smem desc, MN-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D (m64n128, f32) += A (registers, bf16 fragments) * B (smem desc, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float* acc, const uint32_t* a, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float* acc, const uint32_t* a, uint64_t db) {
  wgmma_m64n64k16_rs(acc, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float* acc, const uint32_t* a, uint64_t db) {
  wgmma_m64n128k16_rs(acc, a, db);
}

// One block: 128 query rows of one (batch, head); warps 0-7 are two
// consumer warpgroups of 64 rows each, warp 8 the producer.  D is the
// head dim padded to 64 or 128: TMA fills the columns past dh with zeros.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H,
                        int K, int dh, int causal, float scale_log2,
                        const int* __restrict__ qpos) {
  constexpr int kNSub = D / kSub;
  constexpr int kQBytes = 2 * kNSub * kSubBytes;     // both warpgroups' q
  constexpr int kTileBytes = kNSub * kSubBytes;      // one K (or V) stage
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles want 1024-byte alignment
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [wg][sub][64][64]
  const uint32_t sK = sQ + kQBytes;                            // [stage][sub][64][64]
  const uint32_t sV = sK + kStages * kTileBytes;               // [stage][sub][64][64]
  const uint32_t bar_q = sV + kStages * kTileBytes;
  const uint32_t bar_full = bar_q + 8;                         // [kStages]
  const uint32_t bar_empty = bar_full + 8 * kStages;           // [kStages]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int p_last = qpos ? qpos[q_last] : q_last;  // the tile's largest position
  int n_kt = (Sk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, p_last / kBK + 1);  // skip tiles past it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers / 32);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // ---- producer: one thread issues TMA ----
    if (lane == 0) {
      mbar_expect_tx(bar_q, kQBytes);
      for (int w = 0; w < 2; ++w)
        for (int sub = 0; sub < kNSub; ++sub)
          tma_load(sQ + (w * kNSub + sub) * kSubBytes, &tm_q, bar_q, sub * kSub, h,
                   q0 + 64 * w, b);
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(bar_empty + 8 * s, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * kTileBytes);
        for (int sub = 0; sub < kNSub; ++sub) {
          const uint32_t off = (s * kNSub + sub) * kSubBytes;
          tma_load(sK + off, &tm_k, bar_full + 8 * s, sub * kSub, g, t * kBK, b);
          tma_load(sV + off, &tm_v, bar_full + 8 * s, sub * kSub, g, t * kBK, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows wq0 .. wq0 + 63 ----
  const int wg = warp >> 2;
  const int wq0 = q0 + 64 * wg;
  const int wq_last = min(wq0 + 64, Sq) - 1;  // < wq0: no rows of this warpgroup
  const int row0 = wq0 + (warp & 3) * 16 + (lane >> 2);  // and row0 + 8
  // positions: the warpgroup's first (smallest) and last (largest), and
  // this thread's two rows' (a row past Sq: the last row's)
  const bool has_rows = wq_last >= wq0;
  const int wp_first = qpos ? (has_rows ? qpos[wq0] : 0) : wq0;
  const int wp_last = qpos ? (has_rows ? qpos[wq_last] : -1) : wq_last;
  const int rp0 = qpos ? qpos[min(row0, Sq - 1)] : row0;
  const int rp1 = qpos ? qpos[min(row0 + 8, Sq - 1)] : row0 + 8;
  const int cq = 2 * (lane & 3);  // column of this thread within each 8-wide chunk

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_kt; ++t) {
    const int s = t % kStages;
    const int k0 = t * kBK;
    mbar_wait(bar_full + 8 * s, (t / kStages) & 1);
    if (has_rows && !(causal && k0 > wp_last)) {
      // S = q k^T over the head dim: 64 x 64 f32 in registers
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int sub = 0; sub < kNSub; ++sub)
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk) {
          const uint64_t da =
              desc_sw128(sQ + (wg * kNSub + sub) * kSubBytes + kk * 32, 16, 1024);
          const uint64_t db =
              desc_sw128(sK + (s * kNSub + sub) * kSubBytes + kk * 32, 16, 1024);
          wgmma_m64n64k16_ss(sc, da, db, (sub | kk) != 0);
        }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(sc);

      // masks: keys >= Sk never enter; causal -1e30 past the row's position
      if (k0 + kBK > Sk || (causal && k0 + kBK - 1 > wp_first)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = k0 + 8 * (i >> 2) + cq + (i & 1);
          const int rp = ((i >> 1) & 1) ? rp1 : rp0;
          if (col >= Sk) sc[i] = -INFINITY;
          else if (causal && rp < col) sc[i] = kNeg;
        }
      }
      // online softmax in f32, exp2 with scale * log2(e) folded in
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2], mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f((m[r] - m_new) * scale_log2);
        m[r] = m_new;
        mc[r] = m_new * scale_log2;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = exp2f(__fmaf_rn(sc[i], scale_log2, -mc[r]));
        sum[r] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      // p in bf16: the accumulator layout of S is the A-fragment layout
      uint32_t pa[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kc][r] = pack_bf16(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1]);

      // o += p v: v is [keys][head dim], the MN-major B operand
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const uint64_t dv = desc_sw128(sV + s * kTileBytes + kc * 16 * 128,
                                       kSubBytes, 1024);
        wgmma_pv<D>(acc, pa[kc], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<D / 2>(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with stage s
  }

  if (!has_rows) return;
  const size_t q_row = (size_t)H * dh;
  __nv_bfloat16* ob = o + (size_t)b * Sq * q_row + (size_t)h * dh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < dh)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * q_row + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                       12000, cudaEnableDefault, &res);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, S, n_heads, dh) bf16 tensor read in place as 64-row x 64-column
// boxes of one head, 128-byte swizzled; coordinates (col, head, row, batch).
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int S,
              int n_heads, int dh) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)n_heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2, (cuuint64_t)n_heads * dh * 2,
                                 (cuuint64_t)S * n_heads * dh * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kSub, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int H, int K, int dh, int causal, const int* qpos,
           cudaStream_t stream) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return -7;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(enc, &tm_q, q, B, Sq, H, dh) || !make_map(enc, &tm_k, k, B, Sk, K, dh) ||
      !make_map(enc, &tm_v, v, B, Sk, K, dh))
    return -8;
  const int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)dh));
  dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_attn_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), Sq, Sk, H, K, dh, causal,
      scale_log2, qpos);
  return (int)cudaGetLastError();
}

}  // namespace tc

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Sq, H, dh), k / v (B, Sk, K, dh), o (B, Sq, H, dh), contiguous,
// all of one type: dtype 0 = float32, 1 = bfloat16.  H % K == 0,
// 1 <= dh <= 128, B * H <= 65535.  q_pos: null (row i at position i) or
// int32 (Sq,), non-decreasing.  Returns 0, a negative argument code, or
// the CUDA error of the launch.
int flash_attn_launch(const void* q, const void* k, const void* v, void* o,
                      int dtype, int B, int Sq, int Sk, int H, int K, int dh,
                      int causal, const int* q_pos, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || K < 1 || dh < 1) return -1;
  if (H % K != 0) return -2;
  if (dh > 128) return -3;
  if ((long long)B * H > 65535) return -4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dh<float>(q, k, v, o, B, Sq, Sk, H, K, dh, causal, q_pos, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, K, dh, causal, q_pos, s);
  return -5;
}

// q (B, Sq, H, dh), k / v (B, Sk, K, dh), o (B, Sq, H, dh), contiguous
// bfloat16.  H % K == 0, dh a multiple of 16 in [16, 128],
// ceil(Sq / 128) <= 65535 (grid.y; B * H is grid.x).  q_pos as
// flash_attn_launch's.  Returns 0, a negative argument code, or the CUDA
// error of the launch.
int flash_attn_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                            int B, int Sq, int Sk, int H, int K, int dh,
                            int causal, const int* q_pos, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || K < 1 || dh < 1) return -1;
  if (H % K != 0) return -2;
  if (dh > 128 || dh % 16 != 0) return -3;
  if ((long long)B * H > 0x7fffffffLL ||
      ((long long)Sq + tc::kBQ - 1) / tc::kBQ > 65535)
    return -4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 64) return tc::launch<64>(q, k, v, o, B, Sq, Sk, H, K, dh, causal, q_pos, s);
  return tc::launch<128>(q, k, v, o, B, Sq, Sk, H, K, dh, causal, q_pos, s);
}

}  // extern "C"
