// ccm_lookup: batched CCM lookup (paper Alg. 5) for bucket-sorted targets
// against a chunk's table sets.  Hand-written for Hopper (sm_90a), plain C
// entry point.
//
// Replaces: src/repro/kernels/ccm_lookup/ccm_lookup.py::ccm_lookup_kernel.
//
// Computes  out[s, b, t] = sum_j w[s, r(b), t, j] * Y[b, idx[s, r(b), t, j]]
// for S tables (one per library series of a chunk, or per (series, library
// size) on the significance path), each a set of nb tables (one per optE
// bucket), idx / w (S, nb, Lq, k), Y (B, Lp) -> out (S, B, Lq), float32.
// The targets come in segments: segment i is the next count_i rows of Y,
// looked up through table row r = row_i (a bucket segment of phase 2, or
// the part of one that a target block holds).  The JAX op's signature is
// the case nb = 1 with one segment.  The sum runs over j in ascending
// order, each product and sum rounded on its own (__fmul_rn / __fadd_rn,
// built with --fmad=false): the order of the plain version in ref.py, so
// the two agree to the bit.
//
// What bounds it on this card: bytes.  The function reads the idx and w
// rows its segments use (8 * S * Lq * k bytes per distinct table row), Y
// (4 * B * Lp) and writes 4 * S * B * Lq; 2 operations per (s, b, t, j).
// At S = 8, B = 2048, Lq = Lp = 1430, k = 21 that is about 107 MB, 0.032
// ms at 3.35 TB/s, most of it the 93.7 MB output, against 0.015 ms of fp32
// arithmetic at 67 TFLOP/s.
//
// Design of the staged kernel (Lp up to 7,168):
//  * Work items are (group of G targets of one segment, time block of kT
//    points).  A block owns a contiguous run of items, so it walks a few
//    groups, each across its time blocks; the grid is as many blocks as
//    fit on the card at once (persistent), so the ragged last time block
//    and short groups spread over the run instead of idling a wave.
//  * A group's G target rows are staged in shared memory interleaved
//    [Lp][G]: one vector load (LDS.128 at G 4 and 8, LDS.64 at G 2)
//    gathers the neighbour's value for all G targets, one shared-memory
//    read per neighbour where the first version made three (index, weight,
//    target value) per target.  The gather is random, so bank conflicts
//    set its pace; at G = 8 the two 16-byte halves of a row swap where bit
//    2 of the point is set (slot<8>), so a random row's half starts at any
//    of the 8 bank quads, not 4: 8 lanes of a phase of an LDS.128 meet in
//    about 2.5 wavefronts instead of about 3.6.
//  * Staging overlaps the gather: the next group is copied while the
//    current one is gathered, double-buffered with 4-byte cp.async (the
//    [Lp][G] transpose happens in the copy: a warp reads 8 consecutive
//    points of 4 rows, 32-byte sectors, and writes 32 words of one
//    interleaved span).  Each group is staged once per block and serves
//    its time blocks and all S tables.
//  * One thread per (table, time point): the block loops over the S
//    tables with the group in place; the thread holds its row of idx and w
//    in registers (k <= MAXK, a template bound: 8, 16, 24 or 32) and
//    keeps G sums.  Output rows are written coalesced along t.
//  * G is the largest of 8, 4, 2 whose two stages (8 * Lp * G bytes)
//    leave room for two blocks an SM (112 KB each).  Fish1_Normo's Lp =
//    1430 runs at G = 8 (91.5 KB).
//  * Occupancy (-Xptxas=-v, sm_90a, no spills): at G = 8, 105 / 94 / 78 /
//    62 registers for MAXK 32 / 24 / 16 / 8, within __launch_bounds__(256,
//    2); shared memory sets it: 2 blocks (16 warps) an SM at G = 8 and Lp
//    = 1430 (91.5 KB a block).  The idx and w rows are read by __ldg, one
//    row a thread: a variant with 16 warps a block that fetched them
//    coalesced through shared memory took 128 registers and was no faster
//    at the main path's segment mix.
//
// Past Lp = 7,168 not even G = 2 fits two blocks an SM, and one target a
// stage would reload every idx / w row for each target (on an H100 80GB
// HBM3 at 700 W: 30.65 ms at Subject11's Lp 8508, 8 tables, B 2048, k 21,
// 0.6% of the bound and 4x F.embedding_bag; this kernel 2.98 ms).  There
// the stream kernel takes over:
//  * One thread per (table, time point) pair, kTS = 512 pairs a block; the
//    pair's idx / w row stays in registers while the targets' table row
//    does, reloaded only where a segment with another table row begins.
//  * The block streams a run of consecutive targets through two staged
//    rows (double-buffered cp.async, 16-byte copies where Lp % 4 == 0):
//    each staged row serves 512 pairs.  Blocks of one run are launched
//    together, so their rows come from L2.
//  * Two stages of one row: up to Lp = optin / 8 (29,056 on an H100: 227
//    KB of shared memory a block); Subject11's Lp = 8508 takes 68 KB.
//  * Occupancy (-Xptxas=-v, sm_90a): 101 / 102 / 72 / 60 registers for
//    MAXK 32 / 24 / 16 / 8, so one block (16 warps) an SM at k = 21.
//
// Past Lp = optin / 8, up to optin / 4 (58,112 on an H100), the stream
// kernel stages one row at a time (STAGES 1): the copy of a target's row
// and the gather over it take turns, two barriers a target.  A block holds
// the whole SM either way (one 512-thread block an SM), so the second
// stage would only have overlapped the copy; a row staged once still
// serves 512 pairs, where the gather route's reads come through L1 and L2
// one neighbour at a time.  At Lp 36,000 (8 tables, B 2,048, k 21; an
// H100 80GB HBM3 at 700 W, chip_smoke.py's long_recording phase): 21.0
// ms, against the gather route's 43.1 and F.embedding_bag's 38.6.
// -Xptxas=-v (sm_90a), no spills: 56 / 64 / 96 / 98 registers at MAXK 8 /
// 16 / 24 / 32 and 96 WIDE.
//
// Past Lp = optin / 4 the gather route: the stream kernel's pairs and
// runs of targets with nothing staged (STAGES 0): each neighbour's value
// is an __ldg of the target row, served by L2 while the run's blocks read
// the same row, so there is no barrier and any Lp runs.
//
// Past k = 32 (WIDE, any k): the idx / w row is walked in chunks of 32
// held in registers (the MAXK 32 register arrays), the sums carried
// across chunks, so each sum still runs over j in ascending order with
// the same rounded ops; nothing of a kernel is sized by k, so any k runs
// (the tables past 128 neighbours of the kNN kernels' key-select route).
// The staged kernel keeps its G sums across the chunks; the stream and
// gather kernels reload the chunks for every target.  At k <= 32 every route launches the instantiations it did
// before.  The wrapper splits a segment list longer than kMaxSegs into
// launches, each over its own run of targets (Y and out offset to its
// first target, out's rows B_out apart).  -Xptxas=-v (sm_90a), no
// spills: the staged kernel WIDE at G = 8 / 4 / 2 112 / 100 / 98
// registers (within __launch_bounds__(256, 2)), the stream kernel WIDE 103,
// the gather route 34 / 50 / 66 / 82 at MAXK 8 / 16 / 24 / 32 and 86 WIDE
// (one 512-thread block an SM, as the stream kernel).

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kT = 256;        // time points per item, one per thread
constexpr int kTS = 512;       // (table, time point) pairs a stream block
constexpr int kChunk = 32;     // of them held in registers at once (MAXK bound)
constexpr int kMaxSegs = 64;   // segments per launch (kernel parameter)
constexpr size_t kTwoBlockBytes = 112 * 1024;  // shared memory for 2 blocks an SM
constexpr int kMaxDevices = 64;  // device indices the launch caches keep a slot for

struct Segs {
  int n;                  // segments
  int y0[kMaxSegs];       // first target of the segment (row of Y and of out)
  int count[kMaxSegs];    // its targets
  int row[kMaxSegs];      // its table row, in [0, nb)
  int g0[kMaxSegs + 1];   // its first group; g0[n] = groups in all
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Group {
  int b0, cnt, row;
};

__device__ __forceinline__ Group group_of(const Segs& sg, int grp, int G) {
  int i = 0;
  while (grp >= sg.g0[i + 1]) ++i;  // block-uniform, at most n steps
  Group out;
  out.b0 = sg.y0[i] + (grp - sg.g0[i]) * G;
  out.cnt = min(G, sg.y0[i] + sg.count[i] - out.b0);
  out.row = sg.row[i];
  return out;
}

// Word of target g at point p in a stage.  Rows are [Lp][G]; at G = 8 a
// row is 32 bytes, whose two 16-byte halves could start at only 4 of the
// 8 bank quads, so the halves swap where bit 2 of p is set: a random row's
// first half then starts at any of the 8, and a warp's LDS.128 meets half
// the bank conflicts.
template <int G>
__device__ __forceinline__ int slot(int p, int g) {
  if constexpr (G == 8) return p * 8 + ((((g >> 2) ^ (p >> 2)) & 1) << 2) + (g & 3);
  return p * G + g;
}

// The G targets' values at point p of a stage.
template <int G>
__device__ __forceinline__ void load_g(const float* ys, int p, float (&y)[G]) {
  if constexpr (G == 8) {
    const int h = (p >> 2) & 1;
    const float4 a = *reinterpret_cast<const float4*>(ys + p * 8 + 4 * h);
    const float4 b = *reinterpret_cast<const float4*>(ys + p * 8 + 4 - 4 * h);
    y[0] = a.x; y[1] = a.y; y[2] = a.z; y[3] = a.w;
    y[4] = b.x; y[5] = b.y; y[6] = b.z; y[7] = b.w;
  } else if constexpr (G == 4) {
    const float4 a = *reinterpret_cast<const float4*>(ys + p * 4);
    y[0] = a.x; y[1] = a.y; y[2] = a.z; y[3] = a.w;
  } else {
    static_assert(G == 2, "G is 8, 4 or 2");
    const float2 a = *reinterpret_cast<const float2*>(ys + p * 2);
    y[0] = a.x; y[1] = a.y;
  }
}

// Copy rows b0 .. b0+cnt-1 of Y into buf as [Lp][G] (asynchronously).
template <int G>
__device__ __forceinline__ void stage(float* buf, const float* __restrict__ Y,
                                      const Group& gr, int Lp) {
  const int n = ((Lp + 7) >> 3) * 8 * G;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i / (8 * G), r = i - c * (8 * G);
    const int g = r >> 3, p = c * 8 + (r & 7);
    if (p < Lp && g < gr.cnt)
      cp_async4(buf + slot<G>(p, g), Y + (size_t)(gr.b0 + g) * Lp + p);
  }
}

// Add the kc <= MAXK neighbours of one idx / w row (from ix / wv, global)
// to the G targets' sums, in ascending order.
template <int G, int MAXK>
__device__ __forceinline__ void gather_row(const int32_t* __restrict__ ix_row,
                                           const float* __restrict__ w_row, int kc,
                                           const float* ys, float (&acc)[G]) {
  int ix[MAXK];
  float wv[MAXK];
#pragma unroll
  for (int j = 0; j < MAXK; ++j) {
    if (j >= kc) break;
    ix[j] = __ldg(ix_row + j);
    wv[j] = __ldg(w_row + j);
  }
#pragma unroll
  for (int j = 0; j < MAXK; ++j) {
    if (j >= kc) break;
    float y[G];
    load_g<G>(ys, ix[j], y);
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = __fadd_rn(acc[g], __fmul_rn(wv[j], y[g]));
  }
}

// WIDE (k > MAXK): the row is walked in chunks of MAXK held in registers,
// the G sums kept across chunks, so the order of the sum is the same.
template <int G, int MAXK, bool WIDE>
__global__ void __launch_bounds__(kT, 2)
ccm_lookup_kernel(const int32_t* __restrict__ idx, const float* __restrict__ w,
                  const float* __restrict__ Y, float* __restrict__ out, int S,
                  int nb, int Lq, int k, int B, int Lp, int n_tb, Segs sg) {
  extern __shared__ __align__(16) float smem[];
  const long long n_items = (long long)sg.g0[sg.n] * n_tb;
  const int i0 = (int)(n_items * blockIdx.x / gridDim.x);
  const int i1 = (int)(n_items * (blockIdx.x + 1) / gridDim.x);
  if (i0 >= i1) return;
  const int gfirst = i0 / n_tb, glast = (i1 - 1) / n_tb;

  Group cur = group_of(sg, gfirst, G);
  stage<G>(smem, Y, cur, Lp);
  cp_async_commit();
  for (int grp = gfirst; grp <= glast; ++grp) {
    float* ys = smem + (size_t)((grp - gfirst) & 1) * Lp * G;
    Group nxt = cur;
    if (grp < glast) {
      nxt = group_of(sg, grp + 1, G);
      stage<G>(smem + (size_t)((grp + 1 - gfirst) & 1) * Lp * G, Y, nxt, Lp);
      cp_async_commit();
      cp_async_wait<1>();  // this group's copies have landed (ours)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // ... and everyone's

    const int tb_lo = max(i0, grp * n_tb) - grp * n_tb;
    const int tb_hi = min(i1, (grp + 1) * n_tb) - grp * n_tb;
    for (int tb = tb_lo; tb < tb_hi; ++tb) {
      const int t = tb * kT + threadIdx.x;
      if (t >= Lq) continue;
      for (int s = 0; s < S; ++s) {
        const size_t base = (((size_t)s * nb + cur.row) * Lq + t) * k;
        float acc[G];
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] = 0.f;
        if constexpr (WIDE) {
          for (int j0 = 0; j0 < k; j0 += MAXK)
            gather_row<G, MAXK>(idx + base + j0, w + base + j0, min(MAXK, k - j0), ys,
                                acc);
        } else {
          gather_row<G, MAXK>(idx + base, w + base, k, ys, acc);
        }
        float* o = out + ((size_t)s * B + cur.b0) * Lq + t;
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (g < cur.cnt) o[(size_t)g * Lq] = acc[g];
      }
    }
    __syncthreads();  // the buffer is refilled for the group after next
    cur = nxt;
  }
}

// Copy one target row of Lp floats into buf (asynchronously); vec: 16-byte
// copies (Lp % 4 == 0 and Y 16-byte aligned).
__device__ __forceinline__ void stage_row(float* buf, const float* __restrict__ src,
                                          int Lp, bool vec) {
  if (vec) {
    for (int i = 4 * threadIdx.x; i < Lp; i += 4 * kTS) cp_async16(buf + i, src + i);
  } else {
    for (int i = threadIdx.x; i < Lp; i += kTS) cp_async4(buf + i, src + i);
  }
}

// The neighbour's value of a target row: staged in shared memory, or read
// through L2 (the gather route).
template <int STAGES>
__device__ __forceinline__ float target_at(const float* ys, int i) {
  if constexpr (STAGES > 0) return ys[i];
  return __ldg(ys + i);
}

// STAGES 2: each target row is staged in shared memory while the one
// before is gathered (Lp up to max_lp(dev, 2)); 1: staged, then gathered,
// in turns (Lp up to max_lp(dev, 1)); 0: the gather route, the
// neighbours' values through L2, nothing staged, no barrier.  WIDE (k >
// MAXK): the row is walked in chunks of MAXK from global memory for every
// target, the sum carried across chunks; else it stays in registers while
// the targets' table row does.  Rows of out are B_out apart.
template <int MAXK, bool WIDE, int STAGES>
__global__ void __launch_bounds__(kTS, 1)
ccm_lookup_stream_kernel(const int32_t* __restrict__ idx, const float* __restrict__ w,
                         const float* __restrict__ Y, float* __restrict__ out, int S,
                         int nb, int Lq, int k, int B, int Lp, int n_tiles,
                         int n_runs, bool vec, int B_out, Segs sg) {
  extern __shared__ __align__(16) float smem[];
  const int tile = blockIdx.x % n_tiles, run = blockIdx.x / n_tiles;
  const int b0 = (int)((long long)B * run / n_runs);
  const int b1 = (int)((long long)B * (run + 1) / n_runs);
  if (b0 >= b1) return;
  const long long p = (long long)tile * kTS + threadIdx.x;
  const bool live = p < (long long)S * Lq;  // a dead pair reads pair 0's row
  const int s = live ? (int)(p / Lq) : 0;
  const int t = live ? (int)(p - (long long)s * Lq) : 0;

  int seg = 0, row = -1;
  size_t base = 0;
  int ix[MAXK];
  float wv[MAXK];
  if constexpr (STAGES == 2) {
    stage_row(smem, Y + (size_t)b0 * Lp, Lp, vec);
    cp_async_commit();
  }
  for (int b = b0; b < b1; ++b) {
    const float* ys;
    if constexpr (STAGES == 2) {
      ys = smem + (size_t)((b - b0) & 1) * Lp;
      if (b + 1 < b1) {
        stage_row(smem + (size_t)((b + 1 - b0) & 1) * Lp, Y + (size_t)(b + 1) * Lp,
                  Lp, vec);
        cp_async_commit();
        cp_async_wait<1>();  // this target's copies have landed (ours)
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // ... and everyone's
    } else if constexpr (STAGES == 1) {
      ys = smem;
      stage_row(smem, Y + (size_t)b * Lp, Lp, vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    } else {
      ys = Y + (size_t)b * Lp;
    }
    while (b >= sg.y0[seg] + sg.count[seg]) ++seg;  // block-uniform
    if (sg.row[seg] != row) {
      row = sg.row[seg];
      base = (((size_t)s * nb + row) * Lq + t) * k;
      if constexpr (!WIDE) {
#pragma unroll
        for (int j = 0; j < MAXK; ++j) {
          if (j >= k) break;
          ix[j] = __ldg(idx + base + j);
          wv[j] = __ldg(w + base + j);
        }
      }
    }
    if (live) {
      float acc = 0.f;
      for (int j0 = 0; j0 < (WIDE ? k : 1); j0 += MAXK) {
        const int kc = WIDE ? min(MAXK, k - j0) : k;
        if constexpr (WIDE) {
#pragma unroll
          for (int j = 0; j < MAXK; ++j) {
            if (j >= kc) break;
            ix[j] = __ldg(idx + base + j0 + j);
            wv[j] = __ldg(w + base + j0 + j);
          }
        }
#pragma unroll
        for (int j = 0; j < MAXK; ++j) {
          if (j >= kc) break;
          acc = __fadd_rn(acc, __fmul_rn(wv[j], target_at<STAGES>(ys, ix[j])));
        }
      }
      out[((size_t)s * B_out + b) * Lq + t] = acc;
    }
    if constexpr (STAGES > 0) __syncthreads();  // the buffer is refilled
  }
}

// The longest target row that `stages` staged rows hold on `dev`.
int max_lp(int dev, int stages) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return optin / (stages * (int)sizeof(float));
}

// G of the staged kernel, or 1: the stream kernel.
int choose_g(int Lp) {
  for (int G = 8; G > 1; G >>= 1)
    if (2 * (size_t)Lp * G * sizeof(float) <= kTwoBlockBytes) return G;
  return 1;
}

// The dynamic shared-memory attribute of a kernel instance and the
// resident blocks it gives, per device: the attribute is set on the
// current device, so each device index keeps its own slot, and a launch
// that alternates between cards finds its slot set.  One mutex an instance
// makes the check and the set one step for launches from several host
// threads.
struct LaunchCache {
  std::mutex mu;
  size_t smem[kMaxDevices] = {};
  int blocks[kMaxDevices] = {};  // 0: not set on that device yet
};

// Grid-filling block count of ``kern`` at ``threads`` and ``smem`` on
// ``dev`` (0 or a negative argument code, or the CUDA error).
template <typename Kern>
int resident_blocks(Kern kern, int threads, size_t smem, int dev,
                    LaunchCache& cache, int* blocks) {
  if (dev < 0 || dev >= kMaxDevices) return -9;
  std::lock_guard<std::mutex> lock(cache.mu);
  if (cache.blocks[dev] == 0 || cache.smem[dev] != smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, n_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return -8;
    cache.blocks[dev] = per_sm * n_sm;
    cache.smem[dev] = smem;
  }
  *blocks = cache.blocks[dev];
  return 0;
}

template <int G, int MAXK, bool WIDE>
int launch(const int32_t* idx, const float* w, const float* Y, float* out,
           int S, int nb, int Lq, int k, int B, int Lp, int B_out, const Segs& sg,
           int dev, cudaStream_t stream) {
  static LaunchCache cache;
  const size_t smem = 2 * (size_t)Lp * G * sizeof(float);
  int blocks = 0;
  const int rc = resident_blocks(ccm_lookup_kernel<G, MAXK, WIDE>, kT, smem, dev,
                                 cache, &blocks);
  if (rc != 0) return rc;
  const int n_tb = (Lq + kT - 1) / kT;
  const long long n_items = (long long)sg.g0[sg.n] * n_tb;
  if (n_items == 0) return 0;
  const int grid = (int)(n_items < blocks ? n_items : blocks);
  ccm_lookup_kernel<G, MAXK, WIDE><<<grid, kT, smem, stream>>>(
      idx, w, Y, out, S, nb, Lq, k, B_out, Lp, n_tb, sg);
  return (int)cudaGetLastError();
}

template <int G>
int launch_k(const int32_t* idx, const float* w, const float* Y, float* out,
             int S, int nb, int Lq, int k, int B, int Lp, int B_out, const Segs& sg,
             int dev, cudaStream_t st) {
  if (k <= 8)
    return launch<G, 8, false>(idx, w, Y, out, S, nb, Lq, k, B, Lp, B_out, sg, dev, st);
  if (k <= 16)
    return launch<G, 16, false>(idx, w, Y, out, S, nb, Lq, k, B, Lp, B_out, sg, dev, st);
  if (k <= 24)
    return launch<G, 24, false>(idx, w, Y, out, S, nb, Lq, k, B, Lp, B_out, sg, dev, st);
  if (k <= kChunk)
    return launch<G, kChunk, false>(idx, w, Y, out, S, nb, Lq, k, B, Lp, B_out, sg,
                                    dev, st);
  return launch<G, kChunk, true>(idx, w, Y, out, S, nb, Lq, k, B, Lp, B_out, sg, dev,
                                 st);
}

template <int MAXK, bool WIDE, int STAGES>
int launch_stream(const int32_t* idx, const float* w, const float* Y, float* out,
                  int S, int nb, int Lq, int k, int B, int Lp, int B_out,
                  const Segs& sg, int dev, cudaStream_t stream) {
  static LaunchCache cache;
  const size_t smem = (size_t)STAGES * Lp * sizeof(float);
  auto kern = ccm_lookup_stream_kernel<MAXK, WIDE, STAGES>;
  int blocks = 0;
  const int rc = resident_blocks(kern, kTS, smem, dev, cache, &blocks);
  if (rc != 0) return rc;
  // every run of targets is read by all n_tiles blocks of it, so more runs
  // cost no bytes: about four waves of blocks, for balance
  const long long n_tiles = ((long long)S * Lq + kTS - 1) / kTS;
  long long n_runs = (4LL * blocks + n_tiles - 1) / n_tiles;
  if (n_runs > B) n_runs = B;
  const bool vec = (Lp % 4 == 0) && (reinterpret_cast<uintptr_t>(Y) % 16 == 0);
  kern<<<(int)(n_tiles * n_runs), kTS, smem, stream>>>(
      idx, w, Y, out, S, nb, Lq, k, B, Lp, (int)n_tiles, (int)n_runs, vec, B_out, sg);
  return (int)cudaGetLastError();
}

template <int STAGES>
int launch_stream_k(const int32_t* idx, const float* w, const float* Y, float* out,
                    int S, int nb, int Lq, int k, int B, int Lp, int B_out,
                    const Segs& sg, int dev, cudaStream_t st) {
  if (k <= 8)
    return launch_stream<8, false, STAGES>(idx, w, Y, out, S, nb, Lq, k, B, Lp, B_out,
                                           sg, dev, st);
  if (k <= 16)
    return launch_stream<16, false, STAGES>(idx, w, Y, out, S, nb, Lq, k, B, Lp, B_out,
                                            sg, dev, st);
  if (k <= 24)
    return launch_stream<24, false, STAGES>(idx, w, Y, out, S, nb, Lq, k, B, Lp, B_out,
                                            sg, dev, st);
  if (k <= kChunk)
    return launch_stream<kChunk, false, STAGES>(idx, w, Y, out, S, nb, Lq, k, B, Lp,
                                                B_out, sg, dev, st);
  return launch_stream<kChunk, true, STAGES>(idx, w, Y, out, S, nb, Lq, k, B, Lp, B_out,
                                             sg, dev, st);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ccm_lookup_max_segments() { return kMaxSegs; }

// The longest target row (Lp) the stream kernel stages on the current
// device in `stages` (2 or 1) shared-memory rows; past max_lp(1) the
// gather route runs.
int ccm_lookup_max_lp(int stages) {
  int dev = 0;
  if (stages < 1 || stages > 2 || cudaGetDevice(&dev) != cudaSuccess) return 0;
  return max_lp(dev, stages);
}

// idx / w (S, nb, Lq, k) int32 / float32, Y (B, Lp) float32, all
// contiguous; out (S, B_out, Lq) with B_out >= B: this launch writes rows
// 0 .. B - 1 of each table's block (the caller offsets Y and out to the
// launch's first target).  Segment i: the next seg_counts[i] targets,
// through table row seg_rows[i]; the counts sum to B.  Every idx entry
// must lie in [0, Lp).  Returns 0, a negative argument code, or the CUDA
// error of the launch.
int ccm_lookup_launch(const int32_t* idx, const float* w, const float* Y,
                      float* out, int S, int nb, int Lq, int k, int B, int Lp,
                      const int* seg_rows, const int* seg_counts, int n_seg,
                      int B_out, void* stream) {
  if (S < 1 || nb < 1 || Lq < 1 || B < 1 || Lp < 1 || B_out < B) return -1;
  if (k < 1) return -2;
  if (n_seg < 1 || n_seg > kMaxSegs) return -3;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int G = choose_g(Lp);
  Segs sg;
  sg.n = n_seg;
  long long y = 0, groups = 0;
  for (int i = 0; i < n_seg; ++i) {
    if (seg_rows[i] < 0 || seg_rows[i] >= nb || seg_counts[i] < 0) return -5;
    sg.y0[i] = (int)y;
    sg.count[i] = seg_counts[i];
    sg.row[i] = seg_rows[i];
    sg.g0[i] = (int)groups;
    y += seg_counts[i];
    groups += (seg_counts[i] + G - 1) / G;
  }
  if (y != B) return -6;
  sg.g0[n_seg] = (int)groups;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 8: return launch_k<8>(idx, w, Y, out, S, nb, Lq, k, B, Lp, B_out, sg, dev, st);
    case 4: return launch_k<4>(idx, w, Y, out, S, nb, Lq, k, B, Lp, B_out, sg, dev, st);
    case 2: return launch_k<2>(idx, w, Y, out, S, nb, Lq, k, B, Lp, B_out, sg, dev, st);
    default:
      if (Lp <= max_lp(dev, 2))
        return launch_stream_k<2>(idx, w, Y, out, S, nb, Lq, k, B, Lp, B_out, sg, dev,
                                  st);
      if (Lp <= max_lp(dev, 1))
        return launch_stream_k<1>(idx, w, Y, out, S, nb, Lq, k, B, Lp, B_out, sg, dev,
                                  st);
      return launch_stream_k<0>(idx, w, Y, out, S, nb, Lq, k, B, Lp, B_out, sg, dev,
                                st);
  }
}

}  // extern "C"
