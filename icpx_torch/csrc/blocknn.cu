// Block-NN kernels for Hopper (sm_90a): the radius moments of in-registration
// normal estimation, and the ways a block registration delivers each
// iteration's correspondences.
//
//   moments6  replaces icpx/kernels/blocknn_pallas.py::_moments6_kernel
//             (wrapper block_radius_moments_fused6);
//   fold6     replaces icpx/kernels/blocknn_pallas.py::_fold6_kernel
//             (wrappers fold6_prepare / block_fold_fused_pre);
//   fold7     replaces icpx/kernels/blocknn_pallas.py::_fold7_kernel
//             (wrappers fold7_prepare / block_fold7_pre, payload_mode="vmem7");
//   select    replaces icpx/kernels/blocknn_pallas.py::_select_kernel
//             (wrapper payload_select_fused, payload_mode="select");
//   fused4    replaces icpx/kernels/blocknn_pallas.py::_vpu_kernel
//             (wrapper block_nn_fused4, block_fused="on");
//   moments_fused  replaces icpx/kernels/blocknn_pallas.py::_moments_kernel
//             (wrapper block_radius_moments_fused, the fused branch of
//             normals._block_radius_cov).
//
// moments6, fold6 and fold7 hold 4 queries a thread, several query tiles a
// 128-thread block, and stream each tile's candidate rows through shared
// memory by cp.async, packed centred while the next stage lands; moments6
// and fold6 screen pairs by a centred expansion against a proven margin and
// keep the direct form's verdicts. fused4 and moments_fused (see theirs
// below) hold 4 queries a thread too and split a union's rows across 4
// neighbouring threads.
//
// The TPU kernels' shapes (S-minor transposes, (Tq, k, 3, S), (Tq, k, 4, S)
// and (Tq, k, 8, S) prep copies, the 3-term bf16 one-hot payload selection)
// exist for the MXU and the 128-lane VMEM layout and are dropped: nothing is
// copied ahead of a launch, and the folds copy the winning payload row
// straight from device memory, exactly.
//
// Cost model. Per scored pair: 3 FSUB + 3 FMUL + 2 FADD, a compare and a
// select (plus, for moments, 16 operations on pairs inside the radius), with
// no memory traffic of its own: the kernels are bound by the FP32 issue
// rate, not by bytes (the flagship moments launch scores 1M x 256 pairs and
// moves ~70 MB; the fold scores 1M x 768 pairs and moves ~190 MB).
//
// Score. The direct form (q - r)^2, rounded step by step (__fmul_rn /
// __fadd_rn forbid FMA contraction), so the plain PyTorch versions in
// icpx_torch/kernels/blocknn_cuda.py reproduce every d2 bit for bit: the
// radius test and the fold's winner agree exactly with them. The TPU kernels
// score by the expansion ||r||^2 - 2 q.r (+ ||q||^2), which cancels at fp32;
// moments6 and fold6 screen by a centred expansion against a proven margin
// and keep the direct form's verdicts (fold6: the winner's bits). fold7's contract is the TPU's own
// centred bf16 score, in a fixed order (see its note).
//
// Later work (not here): TMA staging; the union moments' 0/1 weight product
// and fold7's bf16 score on the tensor cores, as the TPU ran them on its MXU
// (TF32 operands lose the second moments' accuracy, split bf16 operands are
// a design of their own, and mma's accumulation order is not fold7's).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kValidAbs = 1.0e6f;  // a coordinate at or beyond this is a sentinel row
constexpr float kMissD2 = 1.0e15f;   // a fold d2 at or beyond this is a miss

__device__ __forceinline__ float sqdist_rn(float ax, float ay, float az,
                                           float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Payload selection (select). The query's position pos (from the plain
// block_nn fold) counts once for every candidate slot of its query tile that
// holds tile pos / s; the output is the payload row summed that many times
// in fp32 from +0 (the row itself with distinct candidates, zeros when pos
// lies in no candidate tile, twice the row for a tile listed twice), as the
// TPU's one-hot product gives. Bound by bytes: a position and a payload row
// read, a row written.
//
// One thread a chunk of W floats of an output row (W = 4, 2 or 1, chosen by
// the wrapper from D and the table's alignment): a block is (D / W chunks)
// x (rows), x fastest, so neighbouring threads write neighbouring addresses
// and a warp's store is one contiguous span; indices are 32-bit (the wrapper
// keeps Tq * Sq * D below 2^31), so no 64-bit division is left. The block
// first stages the candidate ids of the query tiles its rows fall in
// in shared memory.
template <int W> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float2 add_rn(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float4 add_rn(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

template <int W>
__global__ void select_kernel(const int* __restrict__ pos, const int* __restrict__ cand,
                              const float* __restrict__ payload, int sq, int s, int k, int d,
                              int n_rows, int n, float* __restrict__ out) {
  using V = typename Vec<W>::T;
  extern __shared__ int cand_s[];
  const int row_lo = blockIdx.x * blockDim.y;
  const int row_hi = min(n, row_lo + (int)blockDim.y) - 1;
  const int tile_lo = row_lo / sq;
  const int n_ids = (row_hi / sq - tile_lo + 1) * k;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < n_ids; i += blockDim.x * blockDim.y)
    cand_s[i] = cand[tile_lo * k + i];
  __syncthreads();
  const int row = row_lo + threadIdx.y;
  if (row >= n) return;
  const int p = pos[row];
  int hits = 0;
  if (p >= 0 && p < n_rows) {
    const int tile = p / s;
    const int* ids = cand_s + (row / sq - tile_lo) * k;
    for (int j = 0; j < k; ++j) hits += ids[j] == tile;
  }
  V acc{};  // +0: a hit adds the row to it, as the plain version's sum does
  if (hits) {
    const V v = reinterpret_cast<const V*>(payload + (int64_t)p * d)[threadIdx.x];
    for (int h = 0; h < hits; ++h) acc = add_rn(acc, v);
  }
  reinterpret_cast<V*>(out + (int64_t)row * d)[threadIdx.x] = acc;
}

// Fused union fold (fused4): one block a group of query tiles, up to
// kF4Queries of its gq queries, against the group's union of candidate tiles
// (unions (g, u_max), sorted unique ids; the tail repeats slot 0's id as
// padding and is skipped: its rows tie slot 0's in every lane and a strict
// '<' keeps the earlier slot, so skipping changes nothing). Score
// rr - 2 (qx rx + qy ry + qz rz), uncentred, rounded step by step; doubling a
// rounded dot is exact, so the last step is one FFMA, fma(-2, dot, rr), bit for
// bit. Per lane the earliest slot keeps a tie; across lanes the largest
// u * s + lane among the lanes whose minimum equals smin wins, which is the
// TPU kernel's epilogue.
//
// Bound by FP32 issue: 3 FMUL + 2 FADD + 1 FFMA a pair, and a compare and two
// selects to keep each lane's minimum and its earliest slot. What held the
// first version back: one query a thread (a broadcast float4 from shared
// memory for every pair), ~11 instructions a pair, shared memory sized by
// u_max (64 KB at u_max 32, 3 blocks an SM) and staging by scalar loads. Now:
//   * A thread holds kF4Q = 4 queries, so one float4 read feeds 4 pairs, and
//     kF4LaneThreads = 4 neighbouring threads split the lanes of the same 4
//     queries (thread j scans lanes j, j + 4, ...). Each keeps, per query,
//     (least score, largest key among its lanes at that score); two
//     shuffles combine the four under the same order (smaller score, then
//     larger key). Keys are unique, so the order is total, the combine
//     associative, and the result does not depend on how lanes were split.
//   * The union streams through shared memory in chunks of kF4ChunkRows
//     rows: every slot of a run of lanes, so each lane is whole in one chunk
//     and its earliest-slot rule needs no state across chunks. A slot's run
//     of raw 12-byte rows lands by 16-byte cp.async, double buffered (the
//     next chunk is in flight while the current one is scanned), and is
//     packed once as (x, y, z, rr). 20 KB a block, whatever u_max.
// What holds it back (H100 80GB HBM3 at 700 W, the 1M refine shape): 0.64
// ms, 2.3e12 pairs/s. The compare and two selects that keep each lane's
// minimum and its earliest slot run on the half-rate ALU pipe, 3 of the 9
// instructions a pair; the kernel reaches ~60% of what that allows. No
// cheaper exact screen is used: the nn kernel's margin admits most lanes'
// minima at this density, and its resolve would run in nearly every warp.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

constexpr int kF4Threads = 256;
constexpr int kF4Q = 4;            // queries a thread
constexpr int kF4LaneThreads = 4;  // threads that split the lanes of the same queries
constexpr int kF4ChunkRows = 512;  // union rows a chunk stages
constexpr int kF4Queries = kF4Threads / kF4LaneThreads * kF4Q;  // queries a block
constexpr int kF4MaxUnion = kF4ChunkRows / kF4LaneThreads;     // a chunk holds >= 4 lanes

// The union kernels' common steps (fused4, moments_fused).
//
// Lanes a chunk of a union of n_u slots holds: as many as fit in kChunkRows
// rows, a multiple of kLaneThreads, no more than s needs.
template <int kChunkRows, int kLaneThreads>
__device__ __forceinline__ int chunk_lanes(int n_u, int s) {
  const int fit = kChunkRows / n_u / kLaneThreads * kLaneThreads;
  const int need = (s + kLaneThreads - 1) / kLaneThreads * kLaneThreads;
  return fit < need ? fit : need;
}

// n_u, the slots of a union before the first repeat of slot 0's id (the
// padding), from the first warp's ballots rather than one dependent load a
// slot. Every thread of the block calls it; it synchronises the block.
__device__ __forceinline__ int union_slots(const int* un, int u_max, int* shared_n) {
  if (threadIdx.x < 32) {
    const int id0 = un[0];
    int n = u_max;
    for (int i0 = 0; i0 < u_max && n == u_max; i0 += 32) {
      const int i = i0 + threadIdx.x;
      const unsigned rep = __ballot_sync(0xffffffffu, i > 0 && i < u_max && un[i] == id0);
      if (rep) n = i0 + __ffs(rep) - 1;
    }
    if (threadIdx.x == 0) *shared_n = n;
  }
  __syncthreads();
  return *shared_n;
}

// Start staging chunk c of a union (lanes [c * lc, c * lc + nl) of each of
// its n_u slots, 3 words a row, as read) into raw[u * lc * 3 ...], and
// commit it as one cp.async group: in 16-byte pieces where a slot's run
// starts on 16 bytes (by16: s and lc are multiples of 4 lanes and tiles is
// 16-byte aligned), else word by word. Slot u's tile id is un[u * stride]
// (fold6 stages one candidate of several query tiles: a column of cand).
template <int kThreads>
__device__ __forceinline__ void stage_chunk(float* raw, const float* __restrict__ tiles,
                                            const int* un, int n_u, int s, int lc, int c,
                                            bool by16, int stride = 1) {
  const int l0 = c * lc, nl = min(lc, s - l0);
  const int per = by16 ? nl * 3 / 4 : nl * 3;  // copies a slot
  for (int i = threadIdx.x; i < n_u * per; i += kThreads) {
    const int u = i / per, w = i - u * per;
    const float* src = tiles + 3 * ((int64_t)un[u * stride] * s + l0);
    if (by16) {
      cp_async16(&raw[u * lc * 3 + 4 * w], src + 4 * w);
    } else {
      cp_async4(&raw[u * lc * 3 + w], src + w);
    }
  }
  cp_async_commit();
}

// The better of two (least score, key) states: the smaller score, then the
// larger key.
__device__ __forceinline__ void f4_take(float& best, int& key, float b, int k) {
  if (b < best || (b == best && k > key)) {
    best = b;
    key = k;
  }
}

__global__ void __launch_bounds__(kF4Threads)
fused4_kernel(const float* __restrict__ query, const float* __restrict__ tiles,
              const int* __restrict__ unions, int gq, int s, int u_max,
              float* __restrict__ out_d, int* __restrict__ out_pos) {
  __shared__ __align__(16) float raw[2][kF4ChunkRows * 3];  // staged rows, as read
  __shared__ __align__(16) float4 rows[kF4ChunkRows];      // rows[u * lc + lane]
  __shared__ int first_repeat;
  const int* un = unions + (int64_t)blockIdx.x * u_max;
  const int n_u = union_slots(un, u_max, &first_repeat);
  const int lc = chunk_lanes<kF4ChunkRows, kF4LaneThreads>(n_u, s);
  const int chunks = (s + lc - 1) / lc;

  const int quad = threadIdx.x / kF4LaneThreads, jl = threadIdx.x % kF4LaneThreads;
  const int q_first = blockIdx.y * kF4Queries + quad * kF4Q;  // this thread's queries
  const float* qg = query + 3 * ((int64_t)blockIdx.x * gq);
  float qx[kF4Q], qy[kF4Q], qz[kF4Q], best[kF4Q];
  int key[kF4Q];
#pragma unroll
  for (int k = 0; k < kF4Q; ++k) {
    const bool in = q_first + k < gq;
    qx[k] = in ? qg[3 * (q_first + k) + 0] : 0.f;
    qy[k] = in ? qg[3 * (q_first + k) + 1] : 0.f;
    qz[k] = in ? qg[3 * (q_first + k) + 2] : 0.f;
    best[k] = __int_as_float(0x7f800000);
    key[k] = 0;
  }

  const bool by16 = s % 4 == 0 && (reinterpret_cast<uintptr_t>(tiles) & 15) == 0;
  stage_chunk<kF4Threads>(raw[0], tiles, un, n_u, s, lc, 0, by16);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage_chunk<kF4Threads>(raw[(c + 1) & 1], tiles, un, n_u, s, lc, c + 1, by16);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // chunk c has landed; every thread is done with chunk c - 1's rows
    const int l0 = c * lc, nl = min(lc, s - l0);
    const float* rb = raw[c & 1];
    for (int i = threadIdx.x; i < n_u * nl; i += kF4Threads) {
      const int u = i / nl, lane = i - u * nl;
      const float* r = rb + 3 * (u * lc + lane);
      const float x = r[0], y = r[1], z = r[2];
      const float rr = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
      rows[u * lc + lane] = make_float4(x, y, z, rr);
    }
    __syncthreads();
    for (int lane = jl; lane < nl; lane += kF4LaneThreads) {
      float m[kF4Q];
      int mu[kF4Q];
#pragma unroll
      for (int k = 0; k < kF4Q; ++k) {
        m[k] = __int_as_float(0x7f800000);
        mu[k] = 0;
      }
#pragma unroll 4
      for (int u = 0; u < n_u; ++u) {
        const float4 r = rows[u * lc + lane];
#pragma unroll
        for (int k = 0; k < kF4Q; ++k) {
          const float dot = __fadd_rn(__fadd_rn(__fmul_rn(qx[k], r.x), __fmul_rn(qy[k], r.y)),
                                      __fmul_rn(qz[k], r.z));
          const float sc = __fmaf_rn(-2.f, dot, r.w);
          if (sc < m[k]) {  // strict: the earliest slot keeps a tie
            m[k] = sc;
            mu[k] = u;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kF4Q; ++k) f4_take(best[k], key[k], m[k], mu[k] * s + l0 + lane);
    }
  }

  // the four lane threads of a quad are neighbours in one warp
#pragma unroll
  for (int off = 1; off < kF4LaneThreads; off <<= 1) {
#pragma unroll
    for (int k = 0; k < kF4Q; ++k) {
      const float b = __shfl_xor_sync(0xffffffffu, best[k], off);
      const int kk = __shfl_xor_sync(0xffffffffu, key[k], off);
      f4_take(best[k], key[k], b, kk);
    }
  }
  // lane thread jl writes query jl of the quad: neighbouring threads,
  // neighbouring queries
  float b = best[0], x = qx[0], y = qy[0], z = qz[0];
  int kb = key[0];
#pragma unroll
  for (int k = 1; k < kF4Q; ++k) {
    if (jl == k) {
      b = best[k];
      kb = key[k];
      x = qx[k];
      y = qy[k];
      z = qz[k];
    }
  }
  const int qi = q_first + jl;
  if (qi < gq) {
    const int64_t q = (int64_t)blockIdx.x * gq + qi;
    const float qq = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
    const float dd = fmaxf(__fadd_rn(b, qq), 0.f);
    out_d[q] = dd < kMissD2 ? dd : __int_as_float(0x7f800000);
    out_pos[q] = un[kb / s] * s + kb % s;
  }
}
static_assert(kF4Q == kF4LaneThreads, "lane thread j writes query j of its quad");

// Union radius moments (moments_fused): the radius moments of each query
// of a group of gq queries (its query tiles together) over the group's union
// of candidate tiles (unions (g, u_max), laid out as for fused4). Queries
// and union rows are centred on the group's valid-query centroid q_cent
// (g, 3). A row counts when
//   score = (((ax rx + ay ry) + az rz) + rr) + c <= 0,
// a = -2 q_c, rr = (rx^2 + ry^2) + rz^2, c = |q_c|^2 - r^2, every step rounded:
// the TPU kernel's d^2 - r^2 from the expansion, in a fixed order, so the
// plain version reproduces every count. The kernel tests the equivalent
// s1 <= -c with s1 = ((ax rx + ay ry) + az rz) + rr, one FADD less: rounding
// to nearest is monotone and, without flush-to-zero (nvcc's default; no
// --use_fast_math), a nonzero sum of two floats never rounds to 0, so
// round(s1 + c) <= 0 exactly when s1 + c <= 0. Sentinel rows drop out
// through rr ~ 1e16. The TPU kernel sums every one of the u_max slots, and
// the padded ones repeat slot 0's tile: slot 0's rows count (u_max - n_u + 1)
// times. The kernel scores them once, apart from the other slots, and adds
// them with that weight. out (10, g * gq): count, then the centred sums x, y,
// z, xx, yy, zz, xy, xz, yz; the mean and covariance are finished in torch,
// as the reference finishes them in XLA.
//
// Bound by FP32 issue: 3 FMUL + 3 FADD and a compare a scored pair (2.07e9
// pairs at the 1M covariance index, ~67 MB moved). On fused4's design:
//   * A thread holds kMFQ = 4 queries (a, -c and 10 sums each), so one
//     float4 read feeds 4 pairs; kMFLaneThreads = 4 neighbouring threads
//     split the lanes of the same 4 queries (thread j scans lanes j, j + 4,
//     ...), and two shuffle rounds reduce the quad's partial sums, each
//     thread keeping one query: counts are sums of small integers, exact in
//     any order; the other sums change only in rounding.
//   * The union streams through shared memory in chunks of kMFChunkRows rows
//     (every slot of a run of lanes), by 16-byte cp.async, double buffered,
//     centred and packed once a chunk as (x, y, z, rr) lane by lane, so a
//     thread's rows of one lane are contiguous (loads at constant offsets,
//     the next row read ahead): 24 KB a block, whatever u_max.
//   * In each lane, slot 0 is scored first with its weight, then slots 1 ..
//     n_u - 1 with weight 1, so no select is left in the loop. A row's four
//     compares branch once; inside, the row's six products are formed once
//     and each query adds its weight (0 for a miss) times the features by
//     FMA, so the fast path keeps one combined predicate and no per-query
//     branch. The warp takes that branch in 5.0% of its row steps at the 1M
//     index (scripts/torch_variants.py moments_fused's counters); ~0.5% of the pairs
//     count.
//   * 3 blocks an SM (80 registers; 40 bytes of spill stores, reloaded once
//     every 4 rows in the loop): uncapped, 124 registers and 2 blocks ran
//     8% slower.
// What holds it back (H100 80GB HBM3 at 700 W, the 1M covariance index):
// 0.762-0.769 ms device (the one-query-a-thread version: 1.243), 2.7e12
// pairs/s; variants are timed by scripts/torch_variants.py. A row step is ~34 instructions for 4 pairs (12 FMUL, 12 FADD, 4
// FSETP, the branch and its BSSY/BSYNC, an address and the LDS), issued
// ~68% of the time; the rounded score and its compare (28) are the floor
// of this form. A screen by a 3-FFMA score with a proven rounding margin
// reached 0.734 ms, and only without the register cap: too little to carry
// the proof.
constexpr int kMFThreads = 256;
constexpr int kMFQ = 4;            // queries a thread
constexpr int kMFLaneThreads = 4;  // threads that split the lanes of the same queries
constexpr int kMFChunkRows = 512;  // union rows a chunk stages
constexpr int kMFQueries = kMFThreads / kMFLaneThreads * kMFQ;  // queries a block
constexpr int kMFMaxUnion = kMFChunkRows / kMFLaneThreads;     // a chunk holds >= 4 lanes
static_assert(kMFQ == kMFLaneThreads, "lane thread j keeps query j of its quad");
static_assert(kMFQ == 4, "the epilogue's two shuffle rounds split 4 queries");

// One union row r = (x, y, z, rr), centred, against the thread's queries:
// each query whose s1 <= -c adds w (kWeighted) or 1 times the row's ten
// features to its sums. The four compares branch once; inside, each query
// adds its weight (0 for a miss) times the features by FMA, so no per-query
// branch is left.
template <bool kWeighted>
__device__ __forceinline__ void mf_row(const float4 r, const float (&ax)[kMFQ],
                                       const float (&ay)[kMFQ], const float (&az)[kMFQ],
                                       const float (&nc)[kMFQ], float (&m)[kMFQ][10], float w) {
  float s1[kMFQ];
#pragma unroll
  for (int k = 0; k < kMFQ; ++k)
    s1[k] = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(ax[k], r.x), __fmul_rn(ay[k], r.y)), __fmul_rn(az[k], r.z)),
        r.w);
  if ((s1[0] <= nc[0]) | (s1[1] <= nc[1]) | (s1[2] <= nc[2]) | (s1[3] <= nc[3])) {
    const float f[9] = {r.x, r.y, r.z, r.x * r.x, r.y * r.y, r.z * r.z,
                        r.x * r.y, r.x * r.z, r.y * r.z};
#pragma unroll
    for (int k = 0; k < kMFQ; ++k) {
      const float h = s1[k] <= nc[k] ? (kWeighted ? w : 1.f) : 0.f;
      m[k][0] += h;
#pragma unroll
      for (int i = 0; i < 9; ++i) m[k][i + 1] = fmaf(h, f[i], m[k][i + 1]);
    }
  }
}

__global__ void __launch_bounds__(kMFThreads, 3)
moments_fused_kernel(const float* __restrict__ query, const float* __restrict__ tiles,
                     const int* __restrict__ unions, const float* __restrict__ q_cent,
                     const float* __restrict__ r2_ptr, int gq, int s, int u_max,
                     float* __restrict__ out, int64_t n) {
  __shared__ __align__(16) float raw[2][kMFChunkRows * 3];  // staged rows, as read
  // rows[lane * stride + u], centred: a thread's rows of one lane are
  // contiguous, and the odd stride puts the four lanes a quad reads at once
  // in distinct banks; one float4 more for the prefetch past the last row
  __shared__ __align__(16) float4 rows[kMFChunkRows * 3 / 2 + 1];
  __shared__ int first_repeat;
  const int grp = blockIdx.x;
  const int* un = unions + (int64_t)grp * u_max;
  const int n_u = union_slots(un, u_max, &first_repeat);
  const int lc = chunk_lanes<kMFChunkRows, kMFLaneThreads>(n_u, s);
  const int chunks = (s + lc - 1) / lc;
  const int stride = n_u | 1;  // lc * stride <= 3/2 kMFChunkRows, reached at n_u = 2
  const bool by16 = s % 4 == 0 && (reinterpret_cast<uintptr_t>(tiles) & 15) == 0;
  stage_chunk<kMFThreads>(raw[0], tiles, un, n_u, s, lc, 0, by16);

  const float cx = q_cent[3 * grp + 0];
  const float cy = q_cent[3 * grp + 1];
  const float cz = q_cent[3 * grp + 2];
  const float r2 = *r2_ptr;
  const float mult0 = (float)(u_max - n_u + 1);
  const int quad = threadIdx.x / kMFLaneThreads, jl = threadIdx.x % kMFLaneThreads;
  const int q_first = blockIdx.y * kMFQueries + quad * kMFQ;  // this thread's queries
  const float* qg = query + 3 * ((int64_t)grp * gq);
  float ax[kMFQ], ay[kMFQ], az[kMFQ], nc[kMFQ], m[kMFQ][10];
#pragma unroll
  for (int k = 0; k < kMFQ; ++k) {
    const bool in = q_first + k < gq;
    const float qx = in ? __fsub_rn(qg[3 * (q_first + k) + 0], cx) : 0.f;
    const float qy = in ? __fsub_rn(qg[3 * (q_first + k) + 1], cy) : 0.f;
    const float qz = in ? __fsub_rn(qg[3 * (q_first + k) + 2], cz) : 0.f;
    const float c = __fsub_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)), __fmul_rn(qz, qz)), r2);
    ax[k] = -2.f * qx;  // exact
    ay[k] = -2.f * qy;
    az[k] = -2.f * qz;
    nc[k] = in ? -c : -__int_as_float(0x7f800000);  // a query past gq counts nothing
#pragma unroll
    for (int f = 0; f < 10; ++f) m[k][f] = 0.f;
  }

  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage_chunk<kMFThreads>(raw[(c + 1) & 1], tiles, un, n_u, s, lc, c + 1, by16);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // chunk c has landed; every thread is done with chunk c - 1's rows
    const int l0 = c * lc, nl = min(lc, s - l0);
    const float* rb = raw[c & 1];
    for (int i = threadIdx.x; i < n_u * nl; i += kMFThreads) {
      const int u = i / nl, lane = i - u * nl;
      const float* r = rb + 3 * (u * lc + lane);
      const float x = __fsub_rn(r[0], cx), y = __fsub_rn(r[1], cy), z = __fsub_rn(r[2], cz);
      const float rr = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
      rows[lane * stride + u] = make_float4(x, y, z, rr);
    }
    __syncthreads();
    for (int lane = jl; lane < nl; lane += kMFLaneThreads) {
      const float4* rl = rows + lane * stride;
      float4 r = rl[1];  // prefetched a row ahead
      mf_row<true>(rl[0], ax, ay, az, nc, m, mult0);  // slot 0, weighted
#pragma unroll 4
      for (int u = 1; u < n_u; ++u) {
        const float4 next = rl[u + 1];
        mf_row<false>(r, ax, ay, az, nc, m, 1.f);
        r = next;
      }
    }
  }

  // Reduce the quad's partial sums, each thread keeping one query: threads
  // jl and jl ^ 2 swap halves (jl & 2 keeps queries 2, 3), then jl and jl ^ 1
  // (jl & 1 keeps the odd one), so lane thread jl ends with query jl, summed
  // as (P[jl] + P[jl ^ 2]) + (P[jl ^ 1] + P[jl ^ 3]) over the partials P.
  const bool hi = jl & 2, odd = jl & 1;
  float h[2][10], res[10];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int f = 0; f < 10; ++f) {
      const float send = hi ? m[k][f] : m[k + 2][f];
      const float keep = hi ? m[k + 2][f] : m[k][f];
      h[k][f] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
    }
  }
#pragma unroll
  for (int f = 0; f < 10; ++f) {
    const float send = odd ? h[0][f] : h[1][f];
    const float keep = odd ? h[1][f] : h[0][f];
    res[f] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
  }
  const int qi = q_first + jl;
  if (qi < gq) {
    const int64_t q = (int64_t)grp * gq + qi;
#pragma unroll
    for (int f = 0; f < 10; ++f) out[f * n + q] = res[f];
  }
}

// Radius moments (moments6): for each query of query tile t, over the rows
// of its k candidate tiles cand[t], with c = q_cent[t]: qc = fl(q - c) and
// rc = fl(r - c) (each component rounded once), and a row counts when it is
// not a sentinel row (a coordinate at or beyond kValidAbs) and the direct
// form sqdist_rn(qc, rc) <= r2. out is (10, N), N = tq * sq, one row a
// quantity: the count, the mean x, y, z (de-centred) and the covariance
// c00, c01, c02, c11, c12, c22 of the rows that count, finished as
// mean = s / max(count, 1) + c and cov = ss / max(count, 1) - mean_c mean_c;
// a query with no row gets count 0, c and zeros, as the plain version does.
//
// Bound by FP32 issue. The first version ran one query a thread over k x S
// rows staged whole (k * S * 16 bytes of shared memory): a broadcast LDS.128,
// the direct form (3 FSUB, 3 FMUL, 2 FADD), a compare and a branch a pair,
// and the ten sums under a branch per thread: 0.161 ms at the 1M normals
// shape (8,192 x 128 queries, k 2: 2.68e8 pairs, ~11 of them counting a
// query). On fold6's frame:
// 1. Work. A thread holds kM6Q = 2 queries of one query tile, so one
//    broadcast float4 read from shared memory feeds 2 pairs. A 128-thread
//    block holds tiles_per_block query tiles (2 at Sq = 128: 4,096 blocks at
//    the 1M shape) or, above 256 queries a tile, a part of one (blockIdx.y);
//    the wrapper's plan (moments6_plan) picks them, and the C entry refuses
//    a plan that does not fit.
// 2. Staging. A stage is one candidate slot (a run of at most kM6StageLanes
//    lanes of it) of each of the block's tiles, brought in by 16-byte
//    cp.async (stage_chunk) into one raw buffer: stage st + 1 is issued once
//    st is packed and lands while st is screened. Packing centres each row
//    on its own tile's c as (x, y, z, rr), rr = fl(fl(x^2 + y^2) + z^2); a
//    sentinel row and the padding up to a whole mask word of 32 rows are
//    (NaN, NaN, NaN, +inf), whose screen score is NaN. A warp packs one mask
//    word of one tile, and takes by REDUX the word's exact box of valid rows
//    and the tile's largest rr of the stage (a shared atomicMax), whose root
//    is the stage's R: every valid row has rr <= R^2 by construction. Shared
//    memory does not grow with k or S: 19 KB a block.
// 3. Thresholds. A query's verdicts for the stage: A = fl(r2 - qq), qq =
//    fl(|qc|^2), and thr = A -/+ delta (below); s <= thr_lo counts for
//    certain, s > thr_hi does not, and between them (the band) the direct
//    form decides; s = fma(ax, x, fma(ay, y, fma(az, z, rr))) with a = -2 qc,
//    s + |qc|^2 the squared distance.
// 4. Screen. A mask word whose box lies beyond the reach fl(r2 + delta) of
//    every query of the warp is skipped (39% of the warps' words at the 1M
//    normals shape, 68% at k 8). Otherwise each pair's bit is the sign of
//    t = fma(ax, x, fma(ay, y, fma(az, z, fl(rr - thr_hi)))), shifted into
//    the query's word by a funnel shift: FADD, 3 FFMA and an SHF a pair (an
//    FSETP, a select and an add in its place cost 6%, 0.1373 against 0.1296
//    ms). The words of the stage go to shared memory.
// 5. Hits. Each pass of the walk takes the next set bit of both queries of
//    the thread: the row from shared memory, s again, and either s <= thr_lo
//    or, in the band, sqdist_rn(qc, rc) <= r2; a row that counts adds 1, x,
//    y, z and the six products to the query's sums, so a warp makes as many
//    passes as its lanes' most hits of one query in the stage. A branch a row
//    step instead, whose body sums for every query of the thread (the mf_row
//    pattern), ran the sums in 35% of a warp's row steps (57% with 4 queries
//    a thread: a tile's own rows count for themselves): 0.207 ms, 0.290 with 4
//    queries a thread.
// 6. Far queries. A query whose stage is far (qn - R > 0 and (qn - R)^2 >
//    r2 + delta, qn = sqrt(qq)) or that lies past its tile's end gets
//    thr_hi = -inf and sets no bit; a warp whose queries are all far for a
//    stage skips it. The pad rows (PAD_COORD) are far from any tile's rows,
//    so a pad query writes count 0, c and zeros, without scanning.
// 7. Epilogue. Each thread finishes its queries (one correctly rounded
//    reciprocal of max(count, 1) a query) and writes them as float2 where
//    Sq is even.
//
// Why the verdicts are the direct form's. Write u = 2^-24, gamma_n = n u /
// (1 - n u), Q = |qc|, rho = |rc| for a valid row, and W = (Q + R)^2 +
// |r2|; D = |qc - rc|^2 exactly, d the direct form. qc and rc are the
// contract's own floats, so the only errors are the ones below.
//   * d = D (1 + theta), |theta| <= gamma_5 (3 roundings a square, 2 adds of
//     nonnegative terms): |d - D| <= gamma_5 (Q + rho)^2.
//   * rr = rho^2 (1 + theta_3), and the FMA chain rounds 3 times:
//     |s - (rho^2 - 2 qc.rc)| <= gamma_3 rho^2 + gamma_3 (rr + 2 Q rho)
//     <= 2 gamma_3 (Q + rho)^2 (1 + O(u)) (Cauchy-Schwarz), and
//     rho^2 - 2 qc.rc = D - Q^2.
//   * |qq - Q^2| <= gamma_3 Q^2, and |A - (r2 - qq)| <= u (|r2| + qq).
//   So |(s - A) - (d - r2)| <= E = (5 + 6 + 3) u (Q + rho)^2 + u (|r2| +
//   Q^2) (1 + O(u)) <= 15 u W (1 + O(u)), with rho <= R (step 2).
// The kernel takes delta = fl(fl(2^-18 fl(fl(sum^2) + |r2|)) + 2^-100),
// sum = fl(qn + fl(sqrt(R^2))): qn >= Q (1 - 3u) and the computed R >=
// rho (1 - 3u), so delta >= 63 u W. The thresholds thr = fl(A -/+ delta)
// are off by at most u |A -/+ delta| <= 1.01 u W. Then s <= thr_lo gives
// d - r2 <= -delta + 1.01 u W + E < 0: the row counts. The screen's t
// rounds fl(rr - thr_hi) (u (rr + |thr_hi|)) and 3 FMAs on terms of at most
// rr + |thr_hi| + 2 Q rho: |t - (D - Q^2 - thr_hi)| <= 11 u W (1 + O(u)),
// so a clear sign bit (t >= +0) gives d - r2 >= delta - 23 u W > 0: the row
// does not count. A NaN's sign bit is clear (the card's NaN results are the
// canonical 0x7fffffff), so sentinel rows never set a bit. Box: every valid
// row of a word lies in its exact box, the computed distance to the box is
// at most its exact value times (1 + gamma_5), and above fl(r2 + delta) it
// gives d > (r2 + delta)(1 - 11 u) > r2 for every row of the word. Far: qn
// >= Q (1 - 3u) and the computed R >= rho (1 - 3u) bound Q - rho >= g - 4 u
// sum for g = fl(qn - R) > 0, and fl(g^2) > fl(r2 + delta) then gives
// d >= (Q - rho)^2 - 5 u W > r2 + delta - 17 u W > r2 for every valid row of
// the stage. The floor 2^-100 covers the absolute error of subnormal
// roundings (each under 2^-149), where the relative bounds above fail.
// Anything the proof does not cover takes the direct form: where W is not
// below 2^100 (or not a number), thr_lo = -inf and thr_hi = +inf, so every
// pair with a score sets a bit and is in the band.
//
// What holds it back (H100 80GB HBM3 at 700 W, the 1M normals shape,
// scripts/torch_variants.py moments6): 0.130 ms device against 0.161, of it
// ~0.035 staging, packing, thresholds and the 40 MB of outputs (the kernel
// without screen and walk), ~0.042 the screen (5.5 instructions a screened
// pair at ~60% issue) and ~0.053 the walk: a warp makes ~11 passes a stage,
// the most hits any of its 64 queries has there, against 5.4 on average, at
// ~110 instructions a pass, a third of them finding and clearing the next
// bit of two 128-bit masks. Capped at 8 blocks an SM (64 registers), ptxas spills 28
// bytes to a 32-byte stack (52 bytes of reloads); uncapped (72 registers, no spill) it
// ran 0.131 ms, and at 6 blocks an SM (79 registers, 12 bytes spilled) 0.134, so the cap
// stays. 4 queries a thread (sums in 40 registers, spills at 80) ran 0.200 ms.
constexpr int kM6Threads = 128;
constexpr int kM6Q = 2;              // queries a thread
constexpr int kM6Group = 32;         // rows a mask word covers
constexpr int kM6StageLanes = 128;   // lanes of one candidate slot a stage holds, at most
constexpr int kM6StageRows = 512;    // packed rows a stage holds, over the block's tiles
constexpr int kM6Words = kM6StageLanes / kM6Group;    // mask words a query a stage
constexpr int kM6MaxTiles = kM6StageRows / kM6Group;  // query tiles a block, at most
constexpr float kM6DeltaScale = 3.814697265625e-06f;   // 2^-18
constexpr float kM6DeltaFloor = 7.888609052210118e-31f;  // 2^-100
constexpr float kM6ScreenMax = 1.2676506002282294e30f;   // 2^100: W at or beyond, the band
static_assert(kM6StageLanes % kM6Group == 0 && kM6StageRows % kM6StageLanes == 0,
              "a stage holds whole mask words and a whole run of lanes");
static_assert(kM6Group == 32, "a mask word is a 32-bit word, and a warp packs one tile's rows");
static_assert(kM6Words <= 4, "a stage's mask words fit two 64-bit masks a query");

// A float as an int that orders as the floats do (-0 just below +0), and back.
__device__ __forceinline__ int m6_key(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float m6_unkey(int k) { return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff); }

__device__ __forceinline__ float m6_screen(const float ax, const float ay, const float az,
                                           const float4 r) {
  return __fmaf_rn(ax, r.x, __fmaf_rn(ay, r.y, __fmaf_rn(az, r.z, r.w)));
}

__global__ void __launch_bounds__(kM6Threads, 8)
moments6_kernel(const float* __restrict__ query, const float* __restrict__ tiles,
                const int* __restrict__ cand, const float* __restrict__ q_cent,
                const float* __restrict__ r2_ptr, int tq, int sq, int s, int k, int tpb, int lc,
                float* __restrict__ out, int64_t n) {
  __shared__ __align__(16) float raw[kM6StageRows * 3];  // a stage of rows, as read
  __shared__ __align__(16) float4 rows[kM6StageRows];    // rows[b * lcp + lane], centred
  __shared__ unsigned hit_s[kM6Words][kM6Q][kM6Threads];  // a stage's mask words, a query each
  __shared__ float4 cent_s[kM6MaxTiles];                  // c a tile
  __shared__ unsigned rmax_s[2][kM6MaxTiles];             // a stage's largest valid rr a tile, bits
  __shared__ float4 box_lo_s[kM6MaxTiles], box_hi_s[kM6MaxTiles];  // a stage's box a mask word
  const float kInf = __int_as_float(0x7f800000), kNaN = __int_as_float(0x7fc00000);
  const int t0 = blockIdx.x * tpb;
  const int n_live = min(tpb, tq - t0);  // tiles of this block
  const int lcp = (lc + kM6Group - 1) / kM6Group * kM6Group;
  const int nw = lcp / kM6Group;  // mask words a stage
  const int chunks = (s + lc - 1) / lc, n_st = k * chunks;
  const int nqs = min((sq + kM6Q - 1) / kM6Q, kM6Threads);  // threads a tile in this block
  const int b = threadIdx.x / nqs;
  const bool live = b < n_live;
  const int br = live ? b : 0;  // idle threads read tile 0's rows
  const int q_first = blockIdx.y * nqs * kM6Q + (threadIdx.x % nqs) * kM6Q;
  const int tile = t0 + br;
  const bool by16 = s % 4 == 0 && lc % 4 == 0 && (reinterpret_cast<uintptr_t>(tiles) & 15) == 0;
  const int* cand_b = cand + (int64_t)t0 * k;  // the block's tiles' candidates, (n_live, k)
  stage_chunk<kM6Threads>(raw, tiles, cand_b, n_live, s, lc, 0, by16, k);
  if (threadIdx.x < n_live) {
    const float* cp = q_cent + 3 * (int64_t)(t0 + threadIdx.x);
    cent_s[threadIdx.x] = make_float4(cp[0], cp[1], cp[2], 0.f);
    rmax_s[0][threadIdx.x] = 0u;
  }
  __syncthreads();

  const float4 c = cent_s[br];
  const float r2 = *r2_ptr;
  unsigned in = 0;  // the thread's queries inside its tile, a bit each
  float ax[kM6Q], ay[kM6Q], az[kM6Q], m[kM6Q][10];  // a = -2 qc; the sums
#pragma unroll
  for (int q = 0; q < kM6Q; ++q) {
    const bool ok = live && q_first + q < sq;
    const float* qp = query + 3 * ((int64_t)tile * sq + q_first + q);
    ax[q] = ok ? -2.f * __fsub_rn(qp[0], c.x) : 0.f;  // the doubling is exact
    ay[q] = ok ? -2.f * __fsub_rn(qp[1], c.y) : 0.f;
    az[q] = ok ? -2.f * __fsub_rn(qp[2], c.z) : 0.f;
    in |= (ok ? 1u : 0u) << q;
#pragma unroll
    for (int f = 0; f < 10; ++f) m[q][f] = 0.f;
  }

  const int pack_u = threadIdx.x / lcp, pack_l = threadIdx.x - pack_u * lcp;  // this thread's first
  const float4* rs = rows + br * lcp;
  for (int st = 0; st < n_st; ++st) {
    cp_async_wait_all();
    __syncthreads();  // stage st has landed; every thread is done with stage st - 1
    const int ci = st / chunks, nl = min(lc, s - (st - ci * chunks) * lc);
    unsigned* rmax = rmax_s[st & 1];
    // n_live * lcp is a whole number of warps' rows, and a warp's 32 rows are one tile's
    for (int i = threadIdx.x, u = pack_u, l = pack_l; i < n_live * lcp; i += kM6Threads) {
      if (i != threadIdx.x) {  // (u, l) of row i = u * lcp + l, without a division
        l += kM6Threads;
        while (l >= lcp) {
          l -= lcp;
          ++u;
        }
      }
      float4 v = make_float4(kNaN, kNaN, kNaN, kInf);
      unsigned rb = 0u;
      bool valid = false;
      if (l < nl) {
        const float* r = raw + 3 * (u * lc + l);
        const float x = r[0], y = r[1], z = r[2];
        if (fabsf(x) < kValidAbs && fabsf(y) < kValidAbs && fabsf(z) < kValidAbs) {
          const float4 cu = cent_s[u];
          v.x = __fsub_rn(x, cu.x);
          v.y = __fsub_rn(y, cu.y);
          v.z = __fsub_rn(z, cu.z);
          v.w = __fadd_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)), __fmul_rn(v.z, v.z));
          rb = __float_as_uint(v.w);  // rr >= +0 (or NaN): its bits order as its values
          valid = true;
        }
      }
      rows[i] = v;
      rb = __reduce_max_sync(0xffffffffu, rb);
      // the word's box of valid rows (none: lo +inf, hi -inf), exact
      const int lox = __reduce_min_sync(0xffffffffu, valid ? m6_key(v.x) : 0x7f800000);
      const int loy = __reduce_min_sync(0xffffffffu, valid ? m6_key(v.y) : 0x7f800000);
      const int loz = __reduce_min_sync(0xffffffffu, valid ? m6_key(v.z) : 0x7f800000);
      const int hix = __reduce_max_sync(0xffffffffu, valid ? m6_key(v.x) : m6_key(-kInf));
      const int hiy = __reduce_max_sync(0xffffffffu, valid ? m6_key(v.y) : m6_key(-kInf));
      const int hiz = __reduce_max_sync(0xffffffffu, valid ? m6_key(v.z) : m6_key(-kInf));
      if ((threadIdx.x & 31) == 0) {
        atomicMax(&rmax[u], rb);
        box_lo_s[i / kM6Group] = make_float4(m6_unkey(lox), m6_unkey(loy), m6_unkey(loz), 0.f);
        box_hi_s[i / kM6Group] = make_float4(m6_unkey(hix), m6_unkey(hiy), m6_unkey(hiz), 0.f);
      }
    }
    __syncthreads();
    if (st + 1 < n_st) {  // into the raw buffer, now packed, while st is screened
      const int c1 = (st + 1) / chunks;
      stage_chunk<kM6Threads>(raw, tiles, cand_b + c1, n_live, s, lc, st + 1 - c1 * chunks, by16, k);
    }
    if (threadIdx.x < n_live) rmax_s[(st + 1) & 1][threadIdx.x] = 0u;  // stage st - 1's, now free

    // each query's thresholds for this stage (the note's proof), and the far test
    const float big_r = sqrtf(__uint_as_float(rmax[br]));
    float lo[kM6Q], hi[kM6Q], reach[kM6Q];
    bool skip_all = true;
#pragma unroll
    for (int q = 0; q < kM6Q; ++q) {
      const float qx = -0.5f * ax[q], qy = -0.5f * ay[q], qz = -0.5f * az[q];  // exact
      const float qq = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)), __fmul_rn(qz, qz));
      const float qn = sqrtf(qq);
      const float sum = __fadd_rn(qn, big_r);
      const float w = __fadd_rn(__fmul_rn(sum, sum), fabsf(r2));
      const float delta = __fadd_rn(__fmul_rn(kM6DeltaScale, w), kM6DeltaFloor);
      const float a = __fsub_rn(r2, qq);
      const float g = __fsub_rn(qn, big_r);
      const bool proven = w < kM6ScreenMax;
      const bool far = proven && g > 0.f && __fmul_rn(g, g) > __fadd_rn(r2, delta);
      const bool skip = !((in >> q) & 1u) || far;
      lo[q] = proven ? __fsub_rn(a, delta) : -kInf;
      hi[q] = skip ? -kInf : (proven ? __fadd_rn(a, delta) : kInf);
      reach[q] = skip ? -kInf : (proven ? __fadd_rn(r2, delta) : kInf);
      skip_all &= skip;
    }
    if (__all_sync(0xffffffffu, skip_all)) continue;  // warp-uniform

    // the screen: a bit a pair, the sign of t = fma(ax, x, fma(ay, y, fma(az, z,
    // fl(rr - thr_hi)))) shifted in, so row e of a word is its bit 31 - e
    for (int w = 0; w < nw; ++w) {
      unsigned bits[kM6Q];
      // a word whose box is beyond every query's reach has no row that counts
      const float4 blo = box_lo_s[br * nw + w], bhi = box_hi_s[br * nw + w];
      bool beyond = true;
#pragma unroll
      for (int q = 0; q < kM6Q; ++q) {
        bits[q] = 0u;
        const float qx = -0.5f * ax[q], qy = -0.5f * ay[q], qz = -0.5f * az[q];  // exact
        const float dx = fmaxf(fmaxf(__fsub_rn(blo.x, qx), __fsub_rn(qx, bhi.x)), 0.f);
        const float dy = fmaxf(fmaxf(__fsub_rn(blo.y, qy), __fsub_rn(qy, bhi.y)), 0.f);
        const float dz = fmaxf(fmaxf(__fsub_rn(blo.z, qz), __fsub_rn(qz, bhi.z)), 0.f);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        beyond &= !(d2 <= reach[q]);
      }
      if (!__all_sync(0xffffffffu, beyond)) {  // warp-uniform
#pragma unroll
        for (int e = 0; e < kM6Group; ++e) {
          const float4 r = rs[w * kM6Group + e];  // a broadcast over the tile's threads
#pragma unroll
          for (int q = 0; q < kM6Q; ++q) {
            const float t =
                m6_screen(ax[q], ay[q], az[q], make_float4(r.x, r.y, r.z, __fsub_rn(r.w, hi[q])));
            bits[q] = __funnelshift_l(__float_as_uint(t), bits[q], 1);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kM6Q; ++q) hit_s[w][q][threadIdx.x] = bits[q];
    }
    // the hits: each pass takes the next set bit of every query of the
    // thread (a stage's words as two 64-bit masks a query), so their loads
    // and sums overlap, and a warp makes as many passes as its lanes' most
    // hits of one query in the stage
    unsigned long long b_lo[kM6Q], b_hi[kM6Q];
#pragma unroll
    for (int q = 0; q < kM6Q; ++q) {
      const unsigned w0 = hit_s[0][q][threadIdx.x];
      const unsigned w1 = nw > 1 ? hit_s[1][q][threadIdx.x] : 0u;
      const unsigned w2 = nw > 2 ? hit_s[2][q][threadIdx.x] : 0u;
      const unsigned w3 = nw > 3 ? hit_s[3][q][threadIdx.x] : 0u;
      b_lo[q] = static_cast<unsigned long long>(w0) << 32 | w1;  // row e: bit 63 - e
      b_hi[q] = static_cast<unsigned long long>(w2) << 32 | w3;
    }
    for (bool more = true; more;) {
      more = false;
#pragma unroll
      for (int q = 0; q < kM6Q; ++q) {
        if (b_lo[q] | b_hi[q]) {
          const bool low = b_lo[q] != 0ull;
          const unsigned long long bq = low ? b_lo[q] : b_hi[q];
          const int lead = __clzll(bq);
          const unsigned long long rest = bq & ~(0x8000000000000000ull >> lead);
          if (low) {
            b_lo[q] = rest;
          } else {
            b_hi[q] = rest;
          }
          const float4 r = rs[(low ? 0 : 64) + lead];
          bool h = m6_screen(ax[q], ay[q], az[q], r) <= lo[q];  // counts for certain
          if (!h)  // the band: the contract's direct form decides
            h = sqdist_rn(-0.5f * ax[q], -0.5f * ay[q], -0.5f * az[q], r.x, r.y, r.z) <= r2;
          if (h) {
            m[q][0] += 1.f;
            m[q][1] += r.x;
            m[q][2] += r.y;
            m[q][3] += r.z;
            m[q][4] = __fmaf_rn(r.x, r.x, m[q][4]);
            m[q][5] = __fmaf_rn(r.x, r.y, m[q][5]);
            m[q][6] = __fmaf_rn(r.x, r.z, m[q][6]);
            m[q][7] = __fmaf_rn(r.y, r.y, m[q][7]);
            m[q][8] = __fmaf_rn(r.y, r.z, m[q][8]);
            m[q][9] = __fmaf_rn(r.z, r.z, m[q][9]);
          }
          more |= (b_lo[q] | b_hi[q]) != 0ull;
        }
      }
    }
  }

  // count, mean (de-centred), c00, c01, c02, c11, c12, c22 a query
  float res[10][kM6Q];
  const float cc[3] = {c.x, c.y, c.z};
#pragma unroll
  for (int q = 0; q < kM6Q; ++q) {
    const float inv = __frcp_rn(fmaxf(m[q][0], 1.f));
    float mc[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      mc[i] = __fmul_rn(m[q][1 + i], inv);
      res[1 + i][q] = __fadd_rn(mc[i], cc[i]);
    }
    res[0][q] = m[q][0];
    res[4][q] = __fsub_rn(__fmul_rn(m[q][4], inv), __fmul_rn(mc[0], mc[0]));
    res[5][q] = __fsub_rn(__fmul_rn(m[q][5], inv), __fmul_rn(mc[0], mc[1]));
    res[6][q] = __fsub_rn(__fmul_rn(m[q][6], inv), __fmul_rn(mc[0], mc[2]));
    res[7][q] = __fsub_rn(__fmul_rn(m[q][7], inv), __fmul_rn(mc[1], mc[1]));
    res[8][q] = __fsub_rn(__fmul_rn(m[q][8], inv), __fmul_rn(mc[1], mc[2]));
    res[9][q] = __fsub_rn(__fmul_rn(m[q][9], inv), __fmul_rn(mc[2], mc[2]));
  }
  float* o = out + (int64_t)tile * sq + q_first;
  if (kM6Q == 2 && in == 3u && sq % 2 == 0) {  // 8-byte aligned: n and the offset are even
#pragma unroll
    for (int f = 0; f < 10; ++f)
      *reinterpret_cast<float2*>(o + f * n) = make_float2(res[f][0], res[f][1]);
  } else {
#pragma unroll
    for (int q = 0; q < kM6Q; ++q) {
      if ((in >> q) & 1u) {
#pragma unroll
        for (int f = 0; f < 10; ++f) o[f * n + q] = res[f][q];
      }
    }
  }
}

// Frozen-candidate fold (fold6): for each query of query tile t, the row of
// its k candidate tiles cand[t] with the least d2, then the least
// j = lane * k + c (the TPU kernel's "lowest lane, then earliest candidate"),
// d2 the uncentred direct form ((qx-rx)^2 + (qy-ry)^2) + (qz-rz)^2 with every
// step rounded; outputs that d2 (+inf from kMissD2 on) and that row's payload
// (T * S, d) copied exactly. Sentinel rows keep their coordinates: a query
// whose candidates are all sentinel lands on the sentinel row the direct scan
// picks (the first, as the plain version's first minimum).
//
// Bound by FP32 issue: the direct form costs ~12 instructions a pair (3 FSUB,
// 3 FMUL, 2 FADD, a compare, two selects, a broadcast LDS.128), and the one
// query a thread version ran at ~77% of the card's issue rate (0.373 ms at
// the 1M refine shape, 8.05e8 pairs). The lever is the instruction count, so
// the kernel screens in a centred expansion form and rescores a few rows:
//
// 1. Work. A thread holds kF6Q = 4 queries of one query tile, so one
//    broadcast float4 read from shared memory feeds 4 pairs, and scans all
//    of the tile's candidate rows. A 128-thread block holds tiles_per_block
//    query tiles (8 at Sq = 64) or, above 512 queries a tile, a part of one
//    (blockIdx.y); the wrapper's plan (fold6_plan) picks both, and the C
//    entry refuses a plan that does not fit.
// 2. Staging. A stage is one candidate slot c (a run of lanes of it where S
//    exceeds kF6StageRows) of each of the block's tiles: contiguous 12-byte
//    rows, brought in by 16-byte cp.async (stage_chunk, its ids a column of
//    cand) into one raw buffer: stage st + 1 is issued once st is packed and
//    lands while st is screened (two buffers ran 1-4% slower).
//    Each stage is packed once, centred on the query tile's centre c_t, as
//    (x - cx, y - cy, z - cz, rr), rr = (x^2 + y^2) + z^2 of the centred row;
//    a sentinel row (|coord| >= kValidAbs) and the padding up to a whole
//    group are (0, 0, 0, +inf). Packing checks every valid row against the
//    tile's R (rr <= R^2); a tile with a row beyond it takes the direct scan
//    (step 5), so c and R, made at the block's start from the candidates'
//    tile boxes (f6_centre), decide the speed and never the result. 32.5 KB
//    of dynamic shared memory a block.
// 3. Screen. With a = -2 (q - c) the score s = fma(ax, rx, fma(ay, ry,
//    fma(az, rz, rr))) is 3 FFMA; s + |q - c|^2 is the squared distance.
//    Each thread folds its rows in groups of kF6Group with fminf (4
//    instructions a pair) and keeps, per query, the two least group minima
//    m1 <= m2 with their groups g1, g2, and the least minimum m3 of the other
//    groups. A group minimum below m3 is rare once the near rows are known:
//    one vote a group decides whether the warp updates at all.
// 4. Exact rows. After the last stage, with thr = fl(m1 + delta_q): every
//    row that can be a least row lies in a group whose minimum is <= thr
//    (below). If m3 > thr, those are g1 and, where m2 <= thr, g2: their 8 or
//    16 rows are rescored in the raw direct form from device memory (L2;
//    16-byte loads, in flight together) and the least key
//    bits(d2) << 32 | j kept. d2 >= 0, so the key order is exactly "least
//    d2, then least j". At the 1M refine shape 99.27% of the queries need
//    one group, 0.72% two, 0.009% the direct scan.
// 5. The direct scan, the plain version's, for a query with a coordinate at
//    or beyond kF6FarAbs (the PAD_COORD pad rows; Q would explode), with no
//    valid candidate row (m1 = +inf), with a third group within thr, in a
//    tile with a row beyond its R, or whose best d2 is at least kF6DirectD2:
//    the warp's 32 lanes share the query's k x S rows from device memory and
//    fold their keys by shuffles. For the others no sentinel row can tie or
//    beat the best: a sentinel row has a coordinate |r_i| >= 1e6 while
//    |q_i| < 5e5, so fl(q_i - r_i)^2 >= 2.5e11 and, rounding being
//    monotone, its d2 >= 2.5e11 > kF6DirectD2 > the best; leaving sentinel
//    rows out of the screen is exact.
// 6. Epilogue. The winners' payload rows go through shared memory, and the
//    block copies its contiguous run of output rows float by float.
//
// Why every least row is rescored. Write u = 2^-24, Q = |q - c| and R the
// tile's radius: |rc| <= R (1 + 3u) for every valid row, by the check of
// step 2 (rr = fl(|rc|^2) <= fl(R^2)). qc = fl(q - c) and rc = fl(r - c) are
// exact subtractions rounded once, |qc - (q - c)| <= u Q and
// |rc - (r - c)| <= u |r - c|. Let E bound |s + Q^2 - d| over every valid
// pair, s the fp32 screen and d the fp32 direct form of the raw coordinates:
//   * rr is off by gamma_3 |rc|^2, and the FMA chain adds gamma_3 (rr +
//     2 |qc||rc|) (Cauchy-Schwarz): |s - (|rc|^2 - 2 qc.rc)| <= 2 gamma_3
//     (Q + R)^2 (1 + O(u));
//   * |rc|^2 - 2 qc.rc + |qc|^2 = |(q - r) + e|^2 with |e| <= u (Q + R), and
//     |q - r| <= Q + R: within 2u (Q + R)^2 + O(u^2) of |q - r|^2;
//   * ||qc|^2 - Q^2| <= 2u Q^2 + O(u^2);
//   * the direct form is off by gamma_5 |q - r|^2 <= gamma_5 (Q + R)^2.
// So E <= (6 + 2 + 2 + 5) u (Q + R)^2 (1 + O(u)) = 15 u (Q + R)^2. The kernel
// takes delta_q = 2^-18 (Q + R)^2 = 64 u (Q + R)^2 (fold6_screen_margin in
// blocknn_cuda.py), Q from the rounded |qc|^2: twice E, with 34 u of room
// for rounding thr (|m1| <= (Q + R)^2: u) and Q, R and delta_q themselves
// (~10 u). Let x be the row of m1 and r* a least row: s(r*) <= d(r*) - Q^2 +
// E <= d(x) - Q^2 + E <= s(x) + 2E = m1 + 2E <= thr, so r*'s group has a
// minimum <= thr. At the 1M refine shape Q + R is a few tile widths (R ~0.06
// at the median), delta_q ~3e-10 to 1e-9, and the NN d2 ~4e-6.
//
// What holds it back (H100 80GB HBM3 at 700 W, the 1M refine shape,
// scripts/torch_variants.py fold6): ~0.28-0.29 ms device against the
// direct form's 0.37. A screen step of 8 rows for 4 queries is ~146
// instructions (8 LDS.128, 96 FFMA, 32 FMNMX, 4 FSETP, the vote, the
// branch), 4.6 a pair, issued about half the time (80 registers, 32.5 KB of
// shared memory: 6 blocks, 24 warps an SM); two groups a loop step (unroll
// 2) gained 5%. The screen alone, with the exact rows dropped, takes ~0.26
// ms. Halving the shared-memory traffic (8 queries a thread: 126 registers,
// fewer warps) made it slower, 0.33-0.39 ms. Marking groups and rescoring
// them once a stage (nn.cu's resolve) cost more than the screen here: a
// warp paid its lanes' largest count of marks every stage.
constexpr int kF6Threads = 128;
constexpr int kF6Q = 4;             // queries a thread
constexpr int kF6Group = 8;         // rows a screened group
constexpr int kF6StageRows = 1024;  // packed rows a stage holds, over the block's tiles
// dynamic shared memory: the raw stage, the packed rows, a centre and a
// flag a tile (a block holds at most a tile a thread), the winners' payload
// rows
constexpr int kF6Smem = kF6StageRows * 12 + kF6StageRows * 16 + kF6Threads * 20 +
                        kF6Threads * kF6Q * 4;
static_assert(kF6StageRows % 4 == 0, "the packed rows start 16-byte aligned");
constexpr float kF6DeltaScale = 3.814697265625e-06f;  // 2^-18
constexpr float kF6FarAbs = 5.0e5f;     // a query coordinate at or beyond: the direct scan
constexpr float kF6DirectD2 = 1.0e11f;  // a best d2 at or beyond: the direct scan
static_assert(3 * kF6Group % 4 == 0, "a group of rows is a whole number of float4");

__device__ __forceinline__ float f6_screen(float ax, float ay, float az, float4 r) {
  return __fmaf_rn(ax, r.x, __fmaf_rn(ay, r.y, __fmaf_rn(az, r.z, r.w)));
}

__device__ __forceinline__ unsigned long long f6_key(float d, int j) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) | static_cast<unsigned>(j);
}

// The plain version's scan for one query, shared by the 32 lanes of a warp
// (every lane calls it with the same query): lane l scores rows j = l,
// l + 32, ... of the k * S candidate rows from device memory, and the least
// key bits(d2) << 32 | j over the warp is the least d2, then the least j,
// as the plain version's first minimum. Every lane gets it.
__device__ unsigned long long f6_direct_warp(float qx, float qy, float qz,
                                             const float* __restrict__ tiles, const int* ids,
                                             int s, int k) {
  unsigned long long best = ~0ull;
#pragma unroll 4
  for (int j = threadIdx.x & 31; j < k * s; j += 32) {
    const int lane = j / k, c = j - lane * k;
    const float* r = tiles + 3 * ((int64_t)ids[c] * s + lane);
    best = min(best, f6_key(sqdist_rn(qx, qy, qz, r[0], r[1], r[2]), j));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) best = min(best, __shfl_xor_sync(0xffffffffu, best, off));
  return best;
}

// The least key over the rows of screened group gid (stage gid / ng, its
// group gid % ng), in the direct form from device memory; the group's rows
// are loaded first, so their loads are in flight together.
__device__ __forceinline__ unsigned long long f6_group(float qx, float qy, float qz,
                                                       const float* __restrict__ tiles,
                                                       const int* ids, int s, int k, int lc,
                                                       int chunks, int ng, int gid) {
  const int st = gid / ng, ci = st / chunks;
  const int l0 = (st - ci * chunks) * lc + (gid - st * ng) * kF6Group;
  const int n = min(kF6Group, s - l0);
  const float* base = tiles + 3 * ((int64_t)ids[ci] * s + l0);
  float r[3 * kF6Group];
  if (n == kF6Group && (reinterpret_cast<uintptr_t>(base) & 15) == 0) {  // 16-byte loads
#pragma unroll
    for (int i = 0; i < 3 * kF6Group / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(base)[i];
      r[4 * i] = v.x;
      r[4 * i + 1] = v.y;
      r[4 * i + 2] = v.z;
      r[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 3 * kF6Group; ++i) r[i] = i < 3 * n ? base[i] : 0.f;
  }
  unsigned long long best = ~0ull;
#pragma unroll
  for (int e = 0; e < kF6Group; ++e) {
    if (e < n)
      best = min(best, f6_key(sqdist_rn(qx, qy, qz, r[3 * e], r[3 * e + 1], r[3 * e + 2]),
                              (l0 + e) * k + ci));
  }
  return best;
}

// A query tile's screen centre and radius (cx, cy, cz, R) from the boxes of
// its k candidate tiles ids: c the centre of the first box that holds a row
// (lo <= hi; the origin if none does), R the distance from c to the
// farthest corner of those boxes, a little over. Only the speed rests on
// them: packing checks every valid row against R. The tests' fold6_centres
// (tests/test_torch_blocknn.py) repeats this arithmetic.
__device__ float4 f6_centre(const int* ids, const float* __restrict__ box_lo,
                           const float* __restrict__ box_hi, int k) {
  float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
  bool found = false;
  float r2 = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = 0; i < k; ++i) {
      const float* lo = box_lo + 3 * (int64_t)ids[i];
      const float* hi = box_hi + 3 * (int64_t)ids[i];
      if (!(lo[0] <= hi[0] && lo[1] <= hi[1] && lo[2] <= hi[2])) continue;  // no row
      if (pass == 0) {
        if (!found) {
          c.x = 0.5f * __fadd_rn(lo[0], hi[0]);
          c.y = 0.5f * __fadd_rn(lo[1], hi[1]);
          c.z = 0.5f * __fadd_rn(lo[2], hi[2]);
          found = true;
        }
      } else {
        const float dx = fmaxf(fabsf(__fsub_rn(hi[0], c.x)), fabsf(__fsub_rn(lo[0], c.x)));
        const float dy = fmaxf(fabsf(__fsub_rn(hi[1], c.y)), fabsf(__fsub_rn(lo[1], c.y)));
        const float dz = fmaxf(fabsf(__fsub_rn(hi[2], c.z)), fabsf(__fsub_rn(lo[2], c.z)));
        r2 = fmaxf(r2, __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
      }
    }
  }
  c.w = __fmul_rn(sqrtf(r2), 1.0009765625f);  // 1 + 2^-10 over the boxes' own rounding
  return c;
}

__global__ void __launch_bounds__(kF6Threads)
fold6_kernel(const float* __restrict__ query, const float* __restrict__ tiles,
             const int* __restrict__ cand, const float* __restrict__ box_lo,
             const float* __restrict__ box_hi, const float* __restrict__ payload, int tq, int sq,
             int s, int k, int d, int tpb, int lc, float* __restrict__ out_d,
             float* __restrict__ out_pl) {
  extern __shared__ __align__(16) float4 f6_smem[];
  float* raw = reinterpret_cast<float*>(f6_smem);  // a stage of rows, as read
  float4* rows = f6_smem + kF6StageRows * 3 / 4;     // rows[b * lcp + lane], centred
  float4* cent_s = rows + kF6StageRows;                  // (cx, cy, cz, R) a tile
  int* pos_s = reinterpret_cast<int*>(cent_s + kF6Threads);  // the winners' payload rows
  int* beyond = pos_s + kF6Threads * kF6Q;  // a tile with a valid row beyond its R: the direct scan
  const int t0 = blockIdx.x * tpb;
  const int n_live = min(tpb, tq - t0);  // tiles of this block
  const int lcp = (lc + kF6Group - 1) / kF6Group * kF6Group;
  const int ng = lcp / kF6Group;  // groups a stage
  const int pack_u = threadIdx.x / lcp, pack_l = threadIdx.x - pack_u * lcp;  // this thread's first
  const int chunks = (s + lc - 1) / lc, n_st = k * chunks;
  const int nqs = min((sq + kF6Q - 1) / kF6Q, kF6Threads);  // threads a tile in this block
  const int y0 = blockIdx.y * nqs * kF6Q, ny = min(sq - y0, nqs * kF6Q);  // its queries
  const int b = threadIdx.x / nqs;
  const bool live = b < n_live;
  const int br = live ? b : 0;  // idle threads read tile 0's rows
  const int q_first = y0 + (threadIdx.x % nqs) * kF6Q;
  const int tile = t0 + br;
  const bool by16 = s % 4 == 0 && lc % 4 == 0 && (reinterpret_cast<uintptr_t>(tiles) & 15) == 0;
  const int* cand_b = cand + (int64_t)t0 * k;  // the block's tiles' candidates, (n_live, k)
  stage_chunk<kF6Threads>(raw, tiles, cand_b, n_live, s, lc, 0, by16, k);
  if (threadIdx.x < n_live) {
    cent_s[threadIdx.x] = f6_centre(cand_b + threadIdx.x * k, box_lo, box_hi, k);
    beyond[threadIdx.x] = 0;
  }
  __syncthreads();

  const float4 c = cent_s[br];
  // per query: a = -2 (q - c); the two least group minima m1 <= m2 with
  // their groups g1, g2, and the least of the other groups' minima m3
  float ax[kF6Q], ay[kF6Q], az[kF6Q], m1[kF6Q], m2[kF6Q], m3[kF6Q];
  int g1[kF6Q], g2[kF6Q];
#pragma unroll
  for (int q = 0; q < kF6Q; ++q) {
    const bool in = live && q_first + q < sq;
    const float* qp = query + 3 * ((int64_t)tile * sq + q_first + q);
    ax[q] = in ? -2.f * __fsub_rn(qp[0], c.x) : 0.f;  // the doubling is exact
    ay[q] = in ? -2.f * __fsub_rn(qp[1], c.y) : 0.f;
    az[q] = in ? -2.f * __fsub_rn(qp[2], c.z) : 0.f;
    m1[q] = m2[q] = m3[q] = __int_as_float(0x7f800000);
    g1[q] = g2[q] = 0;
  }

  for (int st = 0; st < n_st; ++st) {
    cp_async_wait_all();
    __syncthreads();  // stage st has landed; every thread is done with stage st - 1
    const int ci = st / chunks, nl = min(lc, s - (st - ci * chunks) * lc);
    for (int i = threadIdx.x, u = pack_u, l = pack_l; i < n_live * lcp; i += kF6Threads) {
      if (i != threadIdx.x) {  // (u, l) of row i = u * lcp + l, without a division
        l += kF6Threads;
        while (l >= lcp) {
          l -= lcp;
          ++u;
        }
      }
      float4 v = make_float4(0.f, 0.f, 0.f, __int_as_float(0x7f800000));
      if (l < nl) {
        const float* r = raw + 3 * (u * lc + l);
        const float x = r[0], y = r[1], z = r[2];
        if (fabsf(x) < kValidAbs && fabsf(y) < kValidAbs && fabsf(z) < kValidAbs) {
          const float4 cu = cent_s[u];
          v.x = __fsub_rn(x, cu.x);
          v.y = __fsub_rn(y, cu.y);
          v.z = __fsub_rn(z, cu.z);
          v.w = __fadd_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)), __fmul_rn(v.z, v.z));
          if (!(v.w <= __fmul_rn(cu.w, cu.w))) beyond[u] = 1;  // the margin's R does not hold
        }
      }
      rows[i] = v;
    }
    __syncthreads();
    if (st + 1 < n_st) {  // into the raw buffer, now packed, while st is screened
      const int c1 = (st + 1) / chunks;
      stage_chunk<kF6Threads>(raw, tiles, cand_b + c1, n_live, s, lc, st + 1 - c1 * chunks, by16, k);
    }
    const float4* rs = rows + br * lcp;
#pragma unroll 2  // two groups' loads and chains in flight: 5% faster
    for (int g = 0; g < ng; ++g) {
      float gmin[kF6Q];
#pragma unroll
      for (int q = 0; q < kF6Q; ++q) gmin[q] = __int_as_float(0x7f800000);
#pragma unroll
      for (int e = 0; e < kF6Group; ++e) {
        const float4 r = rs[g * kF6Group + e];  // a broadcast over the tile's threads
#pragma unroll
        for (int q = 0; q < kF6Q; ++q) gmin[q] = fminf(gmin[q], f6_screen(ax[q], ay[q], az[q], r));
      }
      bool enters = false;  // a group minimum below m3 enters the three least
#pragma unroll
      for (int q = 0; q < kF6Q; ++q) enters |= gmin[q] < m3[q];
      if (__any_sync(0xffffffffu, enters)) {  // warp-uniform, and rare once near rows are known
        const int gid = st * ng + g;
#pragma unroll
        for (int q = 0; q < kF6Q; ++q) {
          const float m = gmin[q];
          if (m < m2[q]) {
            m3[q] = m2[q];
            if (m < m1[q]) {
              m2[q] = m1[q];
              g2[q] = g1[q];
              m1[q] = m;
              g1[q] = gid;
            } else {
              m2[q] = m;
              g2[q] = gid;
            }
          } else {
            m3[q] = fminf(m3[q], m);
          }
        }
      }
    }
  }

  // Each query: the least key over its least group and, where m2 is within
  // the margin, the next. The direct scan, shared by the warp, where a
  // third group is within the margin, for far queries and where no valid
  // row is near enough.
  const int* ids = cand + (int64_t)tile * k;
  unsigned long long key[kF6Q];
  unsigned need = 0;  // queries for the direct scan, a bit each
#pragma unroll
  for (int q = 0; q < kF6Q; ++q) {
    key[q] = ~0ull;
    const int qi = q_first + q;
    if (!live || qi >= sq) continue;
    const float* qp = query + 3 * ((int64_t)tile * sq + qi);
    const float x = qp[0], y = qp[1], z = qp[2];
    const float qx = -0.5f * ax[q], qy = -0.5f * ay[q], qz = -0.5f * az[q];  // exact
    const float qq = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)), __fmul_rn(qz, qz));
    const float sum = __fadd_rn(sqrtf(qq), c.w);
    const float thr = __fadd_rn(m1[q], __fmul_rn(kF6DeltaScale, __fmul_rn(sum, sum)));
    if (fmaxf(fabsf(x), fmaxf(fabsf(y), fabsf(z))) < kF6FarAbs && m1[q] < __int_as_float(0x7f800000)
        && !(m3[q] <= thr) && !beyond[b]) {
      key[q] = f6_group(x, y, z, tiles, ids, s, k, lc, chunks, ng, g1[q]);
      if (m2[q] <= thr) key[q] = min(key[q], f6_group(x, y, z, tiles, ids, s, k, lc, chunks, ng, g2[q]));
    }
    if (!(__uint_as_float(static_cast<unsigned>(key[q] >> 32)) < kF6DirectD2)) need |= 1u << q;
  }
  for (;;) {
    const unsigned lanes = __ballot_sync(0xffffffffu, need != 0);
    if (!lanes) break;
    const int src = __ffs(lanes) - 1;
    const int q = __shfl_sync(0xffffffffu, __ffs(need) - 1, src);  // that lane's first
    const int gq = __shfl_sync(0xffffffffu, tile * sq + q_first + q, src);
    const int* src_ids = cand + (int64_t)(gq / sq) * k;
    const unsigned long long kd = f6_direct_warp(query[3 * (int64_t)gq], query[3 * (int64_t)gq + 1],
                                                 query[3 * (int64_t)gq + 2], tiles, src_ids, s, k);
    if ((threadIdx.x & 31) == src) {
#pragma unroll
      for (int i = 0; i < kF6Q; ++i)
        if (i == q) key[i] = kd;
      need &= need - 1;
    }
  }
#pragma unroll
  for (int q = 0; q < kF6Q; ++q) {
    const int qi = q_first + q;
    if (!live || qi >= sq) continue;
    const float dd = __uint_as_float(static_cast<unsigned>(key[q] >> 32));
    const int j = static_cast<int>(static_cast<unsigned>(key[q]));
    const int lane = j / k;
    pos_s[b * ny + qi - y0] = ids[j - lane * k] * s + lane;
    out_d[tile * sq + qi] = dd < kMissD2 ? dd : __int_as_float(0x7f800000);  // Tq * Sq < 2^31
  }
  __syncthreads();
  // The block's outputs are one contiguous run of rows: copy the payload
  // rows float by float, neighbouring threads on neighbouring addresses.
  const int n_out = n_live * ny;
  float* dst = out_pl + ((int64_t)t0 * sq + y0) * d;
  for (int e = threadIdx.x; e < n_out * d; e += kF6Threads) {
    const int qo = e / d;
    dst[e] = payload[(int64_t)pos_s[qo] * d + (e - qo * d)];
  }
}

// Frozen-candidate fold scored in bf16 (fold7, payload_mode="vmem7"):
// replaces icpx/kernels/blocknn_pallas.py::_fold7_kernel. For each query of
// query tile t, against the rows of its k candidate tiles cand[t], with
// c = q_cent[t] the frozen phase's centroid of the tile:
//   qc = fl(q - c), qq = fl(fl(qc_x^2 + qc_y^2) + qc_z^2), a = bf16(qc);
//   rc = fl(r - c), rr = fl(fl(rc_x^2 + rc_y^2) + rc_z^2),
//   B = bf16(-2 rc_x, -2 rc_y, -2 rc_z, rr) (round to nearest even);
//   score = ((a_x B_x + a_y B_y) + a_z B_z) + B_w, each step rounded;
// the winner is the least score, then the least j = lane * k + c (the lowest
// lane, then the earliest candidate); d2 = max(smin + qq, 0), +inf from
// kMissD2 on; the payload is the winner's row, copied exactly. Sentinel rows
// and pad queries are scored like any other: their operands are finite.
//
// Bound by FP32 issue. The first version ran one query a thread over k x S
// operand rows staged whole, ~11 instructions a pair (a broadcast LDS.128, 4
// FMUL, 3 FADD, a compare, two selects), ~84% of the card's issue rate: 0.315
// ms at the 1M refine shape (8.05e8 pairs). Its operands were a (Tq, k, S, 4)
// bf16 copy made ahead of every phase (100 MB at 1M, 1.17 ms of torch ops).
// Now:
// 1. Score. A bf16 x bf16 product has at most 16 significant bits, so it is
//    exact in fp32 unless it is subnormal or overflows, and then
//    ((p0 + p1) + p2) + p3 = fadd(fma(az, Bz, fma(ay, By, ax * Bx)), Bw) bit
//    for bit: FMUL, 2 FFMA and FADD a pair (f7_score), and fminf into the
//    group's minimum. The condition: every nonzero |a_i| in [2^-63, 2^63)
//    and every nonzero |B_i| in [2^-62, 2^64) (i = x, y, z), so every
//    nonzero product lies in [2^-125, 2^127): normal and finite. Packing
//    flags a tile with an operand outside it, the start a query outside it;
//    such a query takes the direct scan (step 5), which scores in the
//    contract's own steps (f7_score_rn). Only coordinates within ~1e-19 of
//    the centroid, or beyond ~1e18 from it, leave the range. B_w >= +0 (a
//    rounded sum of squares), so no score is -0.
// 2. Work. A thread holds kF7Q = 4 queries of one query tile, so one
//    broadcast float4 read from shared memory feeds 4 pairs. A 128-thread
//    block holds tiles_per_block query tiles (8 at Sq = 64) or, above 512
//    queries a tile, a part of one (blockIdx.y); the wrapper's plan
//    (fold7_plan) picks them and the lanes a stage, and the C entry refuses
//    a plan that does not fit.
// 3. Staging, lane-major. A stage is the lanes [l0, l0 + L) of all k
//    candidate tiles of each of the block's tiles, brought in by cp.async
//    (stage_chunk, its slots the block's (tiles, k) candidate ids) into one
//    raw buffer: stage st + 1 is issued once st is packed and lands while st
//    is scored. Packing makes each row's operands from the tile's c, in the
//    contract's steps (f7_operands), at rows[b][(l - l0) k + c]: scan order
//    is j order. A tile's rows of a stage are padded to whole groups of
//    kF7Group with (0, 0, 0, +inf), whose score is +inf. The k x S rows are
//    never held whole, so k x S has no cap. 34.5 KB of shared memory a block.
// 4. Winner. Per group of 8 rows, a query keeps the group's least score, and
//    a strict '<' against its best keeps the group's first j (a compare and
//    a select; the best by fminf). The strict '<' keeps the earliest group
//    of a tie, and that group holds the least tied j. After the last stage
//    the winning group's rows are made and scored again from device memory
//    (L2) and the first equal to the best is the winner: no screen, no
//    margin, the score being the contract.
// 5. The direct scan, for a query outside step 1's condition: the warp's 32
//    lanes share the query's k x S rows from device memory in the contract's
//    steps, and fold keys map(score) << 32 | j by shuffles; map flips the
//    sign bit of a positive score and every bit of a negative one, so the
//    keys order as the scores do (no score is -0 or NaN).
// 6. Epilogue. The winners' payload rows go through shared memory, and the
//    block copies its contiguous run of output rows float by float.
// What holds it back (H100 80GB HBM3 at 700 W, the 1M refine shape,
// scripts/torch_variants.py fold7): ~0.28 ms device against the first
// version's 0.31. A group step of 8 rows for 4 queries is ~180
// instructions (8 LDS.128, 32 FMUL, 64 FFMA, 32 FADD, 32 FMNMX, the
// compares and selects), 5.6 a pair, issued about half the time at 80
// registers (capped for the 6 blocks, 24 warps, an SM that shared memory
// allows; uncapped, 72 and a spill) as fold6's screen is; packing makes
// ~13% of the instructions (its range check alone ~4% of the time) and the
// rescoring ~5% (0.266 ms without it). A warp vote before the best's
// update cost 3%, 8 queries a thread (96 registers) 24%; unrolling,
// 896-row stages at 7 blocks an SM and integer bf16 rounding moved nothing.
constexpr int kF7Threads = 128;
constexpr int kF7Q = 4;             // queries a thread
constexpr int kF7Group = 8;         // rows a group
constexpr int kF7StageRows = 1024;  // packed rows a stage holds, over the block's tiles
// dynamic shared memory: the raw stage, the packed rows, a centroid and a
// flag a tile (a block holds at most a tile a thread), the winners' payload
// rows, the stage's row table
constexpr int kF7Smem = kF7StageRows * 12 + kF7StageRows * 16 + kF7Threads * 20 +
                        kF7Threads * kF7Q * 4 + kF7StageRows * 2;
static_assert(kF7StageRows % 4 == 0, "the packed rows start 16-byte aligned");
static_assert(kF7StageRows <= 65536, "the row table holds 16-bit offsets");
// step 1's range, as float bits: [2^-63, 2^63) for a, [2^-62, 2^64) for B
constexpr unsigned kF7LoA = 0x20000000u, kF7HiA = 0x5f000000u;
constexpr unsigned kF7LoB = 0x20800000u, kF7HiB = 0x5f800000u;

// One of x, y, z is not 0 and its magnitude lies outside [lo, hi) (floats
// given by their bits; inf and NaN lie outside): the least of |bits| - 1
// (0 wraps to the largest) below lo - 1, or the largest |bits| from hi on.
__device__ __forceinline__ bool f7_outside3(float4 v, unsigned lo, unsigned hi) {
  const unsigned mx = __float_as_uint(v.x) & 0x7fffffffu, my = __float_as_uint(v.y) & 0x7fffffffu,
                 mz = __float_as_uint(v.z) & 0x7fffffffu;
  return min(min(mx - 1u, my - 1u), mz - 1u) < lo - 1u || max(max(mx, my), mz) >= hi;
}

// A candidate row's operands centred on c: bf16(-2 rc) and bf16(rr), as
// floats (the doubling is exact).
__device__ __forceinline__ float4 f7_operands(float x, float y, float z, float4 c) {
  const float rx = __fsub_rn(x, c.x), ry = __fsub_rn(y, c.y), rz = __fsub_rn(z, c.z);
  const float rr = __fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)), __fmul_rn(rz, rz));
  return make_float4(bf16_round(__fmul_rn(-2.f, rx)), bf16_round(__fmul_rn(-2.f, ry)),
                     bf16_round(__fmul_rn(-2.f, rz)), bf16_round(rr));
}

// The score in four instructions; equal to f7_score_rn where no product is
// subnormal (step 1).
__device__ __forceinline__ float f7_score(float ax, float ay, float az, float4 r) {
  return __fadd_rn(__fmaf_rn(az, r.z, __fmaf_rn(ay, r.y, __fmul_rn(ax, r.x))), r.w);
}

// The score in the contract's steps, as the plain version computes it.
__device__ __forceinline__ float f7_score_rn(float ax, float ay, float az, float4 r) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(ax, r.x), __fmul_rn(ay, r.y)), __fmul_rn(az, r.z)), r.w);
}

// Keys that order as (score, j) do: map(score) << 32 | j (step 5).
__device__ __forceinline__ unsigned long long f7_key(float sc, int j) {
  const unsigned u = __float_as_uint(sc);
  const unsigned m = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(m) << 32) | static_cast<unsigned>(j);
}

__device__ __forceinline__ float f7_key_score(unsigned long long key) {
  const unsigned m = static_cast<unsigned>(key >> 32);
  return __uint_as_float((m & 0x80000000u) ? (m & 0x7fffffffu) : ~m);
}

// The direct scan for one query, shared by the 32 lanes of a warp (every
// lane calls it with the same query): lane l scores rows j = l, l + 32, ...
// of the k * S candidate rows from device memory; every lane gets the
// least key.
__device__ unsigned long long f7_direct_warp(float ax, float ay, float az, float4 c,
                                             const float* __restrict__ tiles, const int* ids,
                                             int s, int k) {
  unsigned long long best = ~0ull;
#pragma unroll 4
  for (int j = threadIdx.x & 31; j < k * s; j += 32) {
    const int lane = j / k, cc = j - lane * k;
    const float* r = tiles + 3 * ((int64_t)ids[cc] * s + lane);
    best = min(best, f7_key(f7_score_rn(ax, ay, az, f7_operands(r[0], r[1], r[2], c)), j));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) best = min(best, __shfl_xor_sync(0xffffffffu, best, off));
  return best;
}

__global__ void __launch_bounds__(kF7Threads, 6)
fold7_kernel(const float* __restrict__ query, const float* __restrict__ tiles,
             const int* __restrict__ cand, const float* __restrict__ q_cent,
             const float* __restrict__ payload, int tq, int sq, int s, int k, int d, int tpb,
             int lc, float* __restrict__ out_d, float* __restrict__ out_pl) {
  extern __shared__ __align__(16) float4 f7_smem[];
  float* raw = reinterpret_cast<float*>(f7_smem);  // a stage of rows, as read
  float4* rows = f7_smem + kF7StageRows * 3 / 4;     // rows[b * lcp + (l - l0) * k + c]: operands
  float4* cent_s = rows + kF7StageRows;              // c a tile
  int* pos_s = reinterpret_cast<int*>(cent_s + kF7Threads);  // the winners' payload rows
  int* outside = pos_s + kF7Threads * kF7Q;  // a tile with an operand outside step 1's range
  unsigned short* tab = reinterpret_cast<unsigned short*>(outside + kF7Threads);  // row -> c * lc + l
  const int t0 = blockIdx.x * tpb;
  const int n_live = min(tpb, tq - t0);  // tiles of this block
  const int klc = k * lc;                // rows a tile a full stage
  const int lcp = (klc + kF7Group - 1) / kF7Group * kF7Group;
  const int n_st = (s + lc - 1) / lc;
  const int nqs = min((sq + kF7Q - 1) / kF7Q, kF7Threads);  // threads a tile in this block
  const int y0 = blockIdx.y * nqs * kF7Q, ny = min(sq - y0, nqs * kF7Q);  // its queries
  const int b = threadIdx.x / nqs;
  const bool live = b < n_live;
  const int br = live ? b : 0;  // idle threads read tile 0's rows
  const int q_first = y0 + (threadIdx.x % nqs) * kF7Q;
  const int tile = t0 + br;
  const bool by16 = s % 4 == 0 && lc % 4 == 0 && (reinterpret_cast<uintptr_t>(tiles) & 15) == 0;
  const int* cand_b = cand + (int64_t)t0 * k;  // the block's tiles' candidates, (n_live, k)
  stage_chunk<kF7Threads>(raw, tiles, cand_b, n_live * k, s, lc, 0, by16);
  for (int i = threadIdx.x; i < klc; i += kF7Threads) {
    const int l = i / k;
    tab[i] = static_cast<unsigned short>((i - l * k) * lc + l);  // raw slot c's lane l
  }
  if (threadIdx.x < n_live) {
    const float* cp = q_cent + 3 * (int64_t)(t0 + threadIdx.x);
    cent_s[threadIdx.x] = make_float4(cp[0], cp[1], cp[2], 0.f);
    outside[threadIdx.x] = 0;
  }
  __syncthreads();

  const float4 c = cent_s[br];
  float ax[kF7Q], ay[kF7Q], az[kF7Q], best[kF7Q];
  int bj[kF7Q];  // the first j of the group that holds the best
#pragma unroll
  for (int q = 0; q < kF7Q; ++q) {
    const bool in = live && q_first + q < sq;
    const float* qp = query + 3 * ((int64_t)tile * sq + q_first + q);
    ax[q] = in ? bf16_round(__fsub_rn(qp[0], c.x)) : 0.f;
    ay[q] = in ? bf16_round(__fsub_rn(qp[1], c.y)) : 0.f;
    az[q] = in ? bf16_round(__fsub_rn(qp[2], c.z)) : 0.f;
    best[q] = __int_as_float(0x7f800000);
    bj[q] = 0;
  }

  const int pack_u = threadIdx.x / lcp, pack_l = threadIdx.x - pack_u * lcp;  // this thread's first
  for (int st = 0; st < n_st; ++st) {
    cp_async_wait_all();
    __syncthreads();  // stage st has landed; every thread is done with stage st - 1
    const int nlk = min(lc, s - st * lc) * k;  // rows a tile this stage
    for (int i = threadIdx.x, u = pack_u, l = pack_l; i < n_live * lcp; i += kF7Threads) {
      if (i != threadIdx.x) {  // (u, l) of row i = u * lcp + l, without a division
        l += kF7Threads;
        while (l >= lcp) {
          l -= lcp;
          ++u;
        }
      }
      float4 v = make_float4(0.f, 0.f, 0.f, __int_as_float(0x7f800000));
      if (l < nlk) {
        const float* r = raw + 3 * (u * klc + tab[l]);
        v = f7_operands(r[0], r[1], r[2], cent_s[u]);
        if (f7_outside3(v, kF7LoB, kF7HiB)) outside[u] = 1;
      }
      rows[i] = v;
    }
    __syncthreads();
    if (st + 1 < n_st)  // into the raw buffer, now packed, while st is scored
      stage_chunk<kF7Threads>(raw, tiles, cand_b, n_live * k, s, lc, st + 1, by16);
    const float4* rs = rows + br * lcp;
    const int ng = (nlk + kF7Group - 1) / kF7Group, j0 = st * klc;
#pragma unroll 2
    for (int g = 0; g < ng; ++g) {
      const float4* rg = rs + g * kF7Group;  // broadcasts over the tile's threads
      float gmin[kF7Q];
      const float4 r0 = rg[0];
#pragma unroll
      for (int q = 0; q < kF7Q; ++q) gmin[q] = f7_score(ax[q], ay[q], az[q], r0);
#pragma unroll
      for (int e = 1; e < kF7Group; ++e) {
        const float4 r = rg[e];
#pragma unroll
        for (int q = 0; q < kF7Q; ++q) gmin[q] = fminf(gmin[q], f7_score(ax[q], ay[q], az[q], r));
      }
#pragma unroll
      for (int q = 0; q < kF7Q; ++q) {  // a strict '<': the earlier group keeps a tie
        bj[q] = gmin[q] < best[q] ? j0 + g * kF7Group : bj[q];
        best[q] = fminf(best[q], gmin[q]);
      }
    }
  }

  // Each query: the first row of its best group whose score equals the
  // best; the direct scan, shared by the warp, outside step 1's condition.
  const int* ids = cand + (int64_t)tile * k;
  const bool tile_out = outside[br] != 0;
  const int rows_n = k * s;
  unsigned need = 0;  // queries for the direct scan, a bit each
#pragma unroll
  for (int q = 0; q < kF7Q; ++q) {
    const int qi = q_first + q;
    if (!live || qi >= sq) continue;
    if (tile_out || f7_outside3(make_float4(ax[q], ay[q], az[q], 0.f), kF7LoA, kF7HiA)) {
      need |= 1u << q;
      continue;
    }
    float r[3 * kF7Group];  // the group's rows, loaded first so the loads are in flight together
    int l = bj[q] / k, cc = bj[q] - l * k;
#pragma unroll
    for (int e = 0; e < kF7Group; ++e) {
      const bool in = bj[q] + e < rows_n;
      const float* p = tiles + 3 * ((int64_t)ids[in ? cc : 0] * s + (in ? l : 0));
      r[3 * e] = p[0];
      r[3 * e + 1] = p[1];
      r[3 * e + 2] = p[2];
      if (++cc == k) {
        cc = 0;
        ++l;
      }
    }
    int win = bj[q];
#pragma unroll
    for (int e = kF7Group - 1; e >= 0; --e) {  // inside step 1's range: f7_score is the contract's
      const float sc = f7_score(ax[q], ay[q], az[q], f7_operands(r[3 * e], r[3 * e + 1], r[3 * e + 2], c));
      if (bj[q] + e < rows_n && sc == best[q]) win = bj[q] + e;
    }
    bj[q] = win;
  }
  for (;;) {
    const unsigned lanes = __ballot_sync(0xffffffffu, need != 0);
    if (!lanes) break;
    const int src = __ffs(lanes) - 1;
    const int q = __shfl_sync(0xffffffffu, __ffs(need) - 1, src);  // that lane's first
    const int gq = __shfl_sync(0xffffffffu, tile * sq + q_first + q, src);
    const int t = gq / sq;
    const float4 tc = make_float4(q_cent[3 * (int64_t)t], q_cent[3 * (int64_t)t + 1],
                                  q_cent[3 * (int64_t)t + 2], 0.f);
    const float* qp = query + 3 * (int64_t)gq;
    const unsigned long long key = f7_direct_warp(
        bf16_round(__fsub_rn(qp[0], tc.x)), bf16_round(__fsub_rn(qp[1], tc.y)),
        bf16_round(__fsub_rn(qp[2], tc.z)), tc, tiles, cand + (int64_t)t * k, s, k);
    if ((threadIdx.x & 31) == src) {
#pragma unroll
      for (int i = 0; i < kF7Q; ++i) {
        if (i == q) {
          best[i] = f7_key_score(key);
          bj[i] = static_cast<int>(static_cast<unsigned>(key));
        }
      }
      need &= need - 1;
    }
  }
#pragma unroll
  for (int q = 0; q < kF7Q; ++q) {
    const int qi = q_first + q;
    if (!live || qi >= sq) continue;
    const float* qp = query + 3 * ((int64_t)tile * sq + qi);
    const float qx = __fsub_rn(qp[0], c.x), qy = __fsub_rn(qp[1], c.y), qz = __fsub_rn(qp[2], c.z);
    const float qq = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)), __fmul_rn(qz, qz));
    const float dd = fmaxf(__fadd_rn(best[q], qq), 0.f);
    const int lane = bj[q] / k;
    pos_s[b * ny + qi - y0] = ids[bj[q] - lane * k] * s + lane;
    out_d[tile * sq + qi] = dd < kMissD2 ? dd : __int_as_float(0x7f800000);  // Tq * Sq < 2^31
  }
  __syncthreads();
  // The block's outputs are one contiguous run of rows: copy the payload
  // rows float by float, neighbouring threads on neighbouring addresses.
  const int n_out = n_live * ny;
  float* dst = out_pl + ((int64_t)t0 * sq + y0) * d;
  for (int e = threadIdx.x; e < n_out * d; e += kF7Threads) {
    const int qo = e / d;
    dst[e] = payload[(int64_t)pos_s[qo] * d + (e - qo * d)];
  }
}

}  // namespace

extern "C" {

// moments6's shape: threads a block, queries a thread, rows a mask word,
// lanes a stage holds, packed rows a stage. The wrapper plans from these
// (moments6_plan).
void icpx_moments6_shape(int* threads, int* queries_per_thread, int* group, int* stage_lanes,
                         int* stage_rows) {
  *threads = kM6Threads;
  *queries_per_thread = kM6Q;
  *group = kM6Group;
  *stage_lanes = kM6StageLanes;
  *stage_rows = kM6StageRows;
}

// query (tq, sq, 3), tiles (t, s, 3), q_cent (tq, 3) and r2 (1,) f32; cand
// (tq, k) i32; out (10, tq * sq) f32. All contiguous, on `device`. tpb query
// tiles a block (parts of one tile a block where its queries need more than
// kM6Threads threads, then tpb = 1) and lc lanes a stage, as moments6_plan
// gives them; a plan that does not fit the kernel is refused with
// cudaErrorInvalidValue. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError().
int icpx_moments6_forward(const void* query, const void* tiles, const void* cand,
                          const void* q_cent, const void* r2, int tq, int sq, int s, int k,
                          int tpb, int lc, void* out, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int nqt = (sq + kM6Q - 1) / kM6Q;
  const int nqs = nqt < kM6Threads ? nqt : kM6Threads;
  const int lcp = (lc + kM6Group - 1) / kM6Group * kM6Group;
  if (s < 1 || k < 1 || tpb < 1 || lc < 1 || lc > s || lc > kM6StageLanes ||
      lcp * tpb > kM6StageRows || (nqs > 0 && tpb * nqs > kM6Threads))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tq > 0 && sq > 0) {
    const dim3 grid((tq + tpb - 1) / tpb, (nqt + nqs - 1) / nqs);
    moments6_kernel<<<grid, kM6Threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(query), static_cast<const float*>(tiles),
        static_cast<const int*>(cand), static_cast<const float*>(q_cent),
        static_cast<const float*>(r2), tq, sq, s, k, tpb, lc, static_cast<float*>(out),
        (int64_t)tq * sq);
  }
  return static_cast<int>(cudaGetLastError());
}

// fold6's shape: threads a block, queries a thread, rows a screened group,
// packed rows a stage. The wrapper plans from these (fold6_plan).
void icpx_fold6_shape(int* threads, int* queries_per_thread, int* group, int* stage_rows) {
  *threads = kF6Threads;
  *queries_per_thread = kF6Q;
  *group = kF6Group;
  *stage_rows = kF6StageRows;
}

// query (tq, sq, 3) and tiles (t, s, 3) f32; cand (tq, k) i32; box_lo and
// box_hi (t, 3) f32, each index tile's box over its rows (lo > hi where it
// has none); payload (t * s, d) f32; outputs d2 (tq * sq,) and payload rows
// (tq * sq, d) f32. All contiguous, on `device`. tpb query tiles a block
// (parts of one tile a block where its queries need more than kF6Threads
// threads, then tpb = 1) and
// lc lanes a stage, as fold6_plan gives them; a plan that does not fit the
// kernel is refused with cudaErrorInvalidValue. Same launch contract as
// above.
int icpx_fold6_forward(const void* query, const void* tiles, const void* cand, const void* box_lo,
                       const void* box_hi, const void* payload, int tq, int sq, int s, int k, int d,
                       int tpb, int lc, void* out_d, void* out_pl, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int nq4 = (sq + kF6Q - 1) / kF6Q;
  const int nqs = nq4 < kF6Threads ? nq4 : kF6Threads;
  const int lcp = (lc + kF6Group - 1) / kF6Group * kF6Group;
  if (s < 1 || k < 1 || d < 0 || tpb < 1 || lc < 1 || lc > s || lcp * tpb > kF6StageRows ||
      (nqs > 0 && tpb * nqs > kF6Threads))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tq > 0 && sq > 0) {
    if (kF6Smem > 48 * 1024) {
      const cudaError_t rc =
          cudaFuncSetAttribute(fold6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kF6Smem);
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
    const dim3 grid((tq + tpb - 1) / tpb, (nq4 + nqs - 1) / nqs);
    fold6_kernel<<<grid, kF6Threads, kF6Smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(query), static_cast<const float*>(tiles),
        static_cast<const int*>(cand), static_cast<const float*>(box_lo),
        static_cast<const float*>(box_hi), static_cast<const float*>(payload), tq, sq, s, k, d, tpb,
        lc, static_cast<float*>(out_d), static_cast<float*>(out_pl));
  }
  return static_cast<int>(cudaGetLastError());
}

// fold7's shape: threads a block, queries a thread, rows a group, packed
// rows a stage. The wrapper plans from these (fold7_plan).
void icpx_fold7_shape(int* threads, int* queries_per_thread, int* group, int* stage_rows) {
  *threads = kF7Threads;
  *queries_per_thread = kF7Q;
  *group = kF7Group;
  *stage_rows = kF7StageRows;
}

// query (tq, sq, 3), tiles (t, s, 3), q_cent (tq, 3) and payload (t * s, d)
// f32; cand (tq, k) i32; outputs d2 (tq * sq,) and payload rows (tq * sq, d)
// f32. All contiguous, on `device`. tpb query tiles a block (parts of one
// tile a block where its queries need more than kF7Threads threads, then
// tpb = 1) and lc lanes a stage, as fold7_plan gives them; a plan that does
// not fit the kernel is refused with cudaErrorInvalidValue. Same launch
// contract as above.
int icpx_fold7_forward(const void* query, const void* tiles, const void* cand, const void* q_cent,
                       const void* payload, int tq, int sq, int s, int k, int d, int tpb, int lc,
                       void* out_d, void* out_pl, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int nq4 = (sq + kF7Q - 1) / kF7Q;
  const int nqs = nq4 < kF7Threads ? nq4 : kF7Threads;
  if (s < 1 || k < 1 || d < 0 || tpb < 1 || lc < 1 || lc > s || k > kF7StageRows ||
      (long long)tpb * (((long long)k * lc + kF7Group - 1) / kF7Group * kF7Group) > kF7StageRows ||
      (nqs > 0 && tpb * nqs > kF7Threads))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tq > 0 && sq > 0) {
    if (kF7Smem > 48 * 1024) {
      const cudaError_t rc =
          cudaFuncSetAttribute(fold7_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kF7Smem);
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
    const dim3 grid((tq + tpb - 1) / tpb, (nq4 + nqs - 1) / nqs);
    fold7_kernel<<<grid, kF7Threads, kF7Smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(query), static_cast<const float*>(tiles),
        static_cast<const int*>(cand), static_cast<const float*>(q_cent),
        static_cast<const float*>(payload), tq, sq, s, k, d, tpb, lc, static_cast<float*>(out_d),
        static_cast<float*>(out_pl));
  }
  return static_cast<int>(cudaGetLastError());
}

// pos (tq, sq) and cand (tq, k) i32; payload (n_rows, d) f32 with n_rows a
// multiple of s; out (tq * sq, d) f32; width 4, 2 or 1 floats a thread, with
// d a multiple of it and payload and out aligned to 4 * width bytes. Same
// launch contract as above.
int icpx_select_forward(const void* pos, const void* cand, const void* payload, int tq, int sq,
                        int s, int k, int d, int n_rows, int width, void* out, int device,
                        void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if ((width != 1 && width != 2 && width != 4) || d % width || d / width > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = tq * sq;
  if (n > 0 && d > 0) {
    const int cpr = d / width;  // chunks a row: the block's x
    const int rows = cpr >= 256 ? 1 : 256 / cpr;  // rows a block: its y
    // the block's rows fall in at most (rows - 1) / sq + 2 query tiles
    const size_t smem = sizeof(int) * (size_t)((rows - 1) / sq + 2) * k;
    const dim3 block(cpr, rows);
    const unsigned blocks = (unsigned)((n + rows - 1) / rows);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* p = static_cast<const int*>(pos);
    const int* c = static_cast<const int*>(cand);
    const float* pl = static_cast<const float*>(payload);
    float* o = static_cast<float*>(out);
    if (width == 4) {
      select_kernel<4><<<blocks, block, smem, st>>>(p, c, pl, sq, s, k, d, n_rows, n, o);
    } else if (width == 2) {
      select_kernel<2><<<blocks, block, smem, st>>>(p, c, pl, sq, s, k, d, n_rows, n, o);
    } else {
      select_kernel<1><<<blocks, block, smem, st>>>(p, c, pl, sq, s, k, d, n_rows, n, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// fused4's shape: threads a block, queries a thread, threads that split a
// quad's lanes, union rows a chunk. The wrapper plans and checks from these.
void icpx_fused4_shape(int* threads, int* queries_per_thread, int* lane_threads, int* chunk_rows) {
  *threads = kF4Threads;
  *queries_per_thread = kF4Q;
  *lane_threads = kF4LaneThreads;
  *chunk_rows = kF4ChunkRows;
}

// query (g * gq, 3) and tiles (t, s, 3) f32; unions (g, u_max) i32 with
// u_max <= kF4MaxUnion; outputs d2 (g * gq,) f32 and flat sorted positions
// (g * gq,) i32. A grid of (g, ceil(gq / kF4Queries)) blocks. Same launch
// contract as above.
int icpx_fused4_forward(const void* query, const void* tiles, const void* unions, int g, int gq,
                        int s, int u_max, void* out_d, void* out_pos, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (u_max < 1 || u_max > kF4MaxUnion || s < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (g > 0 && gq > 0) {
    const dim3 grid(g, (gq + kF4Queries - 1) / kF4Queries);
    fused4_kernel<<<grid, kF4Threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(query), static_cast<const float*>(tiles),
        static_cast<const int*>(unions), gq, s, u_max, static_cast<float*>(out_d),
        static_cast<int*>(out_pos));
  }
  return static_cast<int>(cudaGetLastError());
}

// moments_fused's shape: threads a block, queries a thread, threads that
// split a quad's lanes, union rows a chunk. The wrapper plans and checks
// from these.
void icpx_moments_fused_shape(int* threads, int* queries_per_thread, int* lane_threads,
                              int* chunk_rows) {
  *threads = kMFThreads;
  *queries_per_thread = kMFQ;
  *lane_threads = kMFLaneThreads;
  *chunk_rows = kMFChunkRows;
}

// query (g * gq, 3), tiles (t, s, 3), q_cent (g, 3) and r2 (1,) f32; unions
// (g, u_max) i32 with u_max <= kMFMaxUnion; out (10, g * gq) f32. A grid of
// (g, ceil(gq / kMFQueries)) blocks. Same launch contract as above.
int icpx_moments_fused_forward(const void* query, const void* tiles, const void* unions,
                               const void* q_cent, const void* r2, int g, int gq, int s, int u_max,
                               void* out, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (u_max < 1 || u_max > kMFMaxUnion || s < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (g > 0 && gq > 0) {
    const dim3 grid(g, (gq + kMFQueries - 1) / kMFQueries);
    moments_fused_kernel<<<grid, kMFThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(query), static_cast<const float*>(tiles),
        static_cast<const int*>(unions), static_cast<const float*>(q_cent),
        static_cast<const float*>(r2), gq, s, u_max, static_cast<float*>(out), (int64_t)g * gq);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* icpx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
