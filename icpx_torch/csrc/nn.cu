// Exact brute-force 1-nearest-neighbour search in fp32, for Hopper (sm_90a).
//
// Replaces icpx/kernels/knn_pallas.py::_nn_kernel (wrapper nn_pallas). For
// every query row it returns the squared distance to, and the index of, the
// nearest valid reference row.
//
// Contract (the JAX package's off-TPU contract, icpx/kernels/knn.py:180-189):
//   * masked reference rows never win;
//   * ties go to the LOWEST reference index;
//   * a query with no valid reference gets d2 = +inf and index 0;
//   * d2 is the direct form ((dx^2 + dy^2) + dz^2), every step rounded on
//     its own, so the output is bit-equal to nearest_neighbor_reference in
//     icpx_torch/kernels/nn_cuda.py.
//
// Cost model. At 65,536 x 65,536 one call scores 4.3e9 pairs with no memory
// traffic of its own: the kernel is bound by the FP32 issue rate, and the
// number of instructions a pair is the lever. The direct form costs ~10 (3
// FSUB, 1 FMUL, 2 FFMA, a compare, two selects). This kernel screens in the
// expansion form instead and rescores rarely:
//
// 1. Pack (nn_pack_kernel, once a call). References become contiguous
//    float4 rows (x, y, z, rr), rr = (x^2 + y^2) + z^2; a masked row, and
//    every padded row past nr, is (NaN, NaN, NaN, +inf): its screen score
//    and its direct d2 are NaN, which fminf passes over and no comparison
//    takes. The same pass writes each tile's largest rr over its valid rows
//    as bits + 1, and 0 for an empty tile (one with no valid row), and
//    zeroes the tickets and counters of steps 4-5.
// 2. Screen (nn_search_kernel, near rows). With a = -2q the score
//    s = fma(ax, rx, fma(ay, ry, fma(az, rz, rr))) is 3 FFMA; s + |q|^2 is
//    the squared distance. Per group of kGroup references the scores fold
//    with fminf (4 instructions a pair), and the group minimum gmin is
//    compared with the query's threshold thr. A group that passes lowers
//    thr to gmin + delta_q and sets its bit in the query's mask of the
//    tile's groups; whether any query of the warp passed is one vote, so a
//    group that passes nowhere costs ~0.3 instructions a pair more.
// 3. Resolve, once a tile. Each query's marked groups are rescored in
//    ascending order: the row scores first (independent, so they pipeline),
//    then, for each row whose own score passes thr, the direct form
//    (__fsub_rn / __fmul_rn / __fadd_rn: no FMA contraction) with a strict
//    '<', skipping rows with rr = +inf; a new best lowers thr to its score +
//    delta_q. Resolving at the tile's end, not inside the screen, makes a
//    warp pay the largest count of marks over its lanes once a tile, not a
//    divergent round each time any of its 128 queries passes.
//
// Why every least row is resolved. Let E bound |s + |q|^2 - d| over every
// pair, s the fp32 screen score and d the fp32 direct form. With u = 2^-24,
// Q = |q| and R = max |r| over the valid rows: rr is off by gamma_3 rr, the
// FMA chain adds at most gamma_3 (rr + 2 Q R) (Cauchy-Schwarz on
// sum |a_i r_i|), and the direct form is off by gamma_5 d <= gamma_5
// (Q + R)^2, so E <= (2 gamma_3 + gamma_5) (Q + R)^2 ~ 11 u (Q + R)^2. The
// kernel takes delta_q = 2 * 16 u (Q + R)^2 = 2^-19 (Q + R)^2 (the helper
// screen_margin in nn_cuda.py; the 5 u of room covers the fp32 rounding of
// Q, R, delta_q and of s + delta_q itself). thr is always +inf or
// fl(s(x) + delta_q) for a row x already scored. A row r* whose direct d is
// the least over all rows then has s(r*) <= d(r*) - |q|^2 + E <=
// d(x) - |q|^2 + E <= s(x) + 2E <= thr, at the screen and at the resolve
// alike: its group is marked, it is rescored, and among the least rows the
// lowest index wins under the strict '<'.
//
// Rows that carry nothing for the screen. Two kinds, both found by the
// kernel in its own inputs, so a call without them runs steps 2-3 alone:
//   * Empty tiles. A tile with no valid row is never copied, screened or
//     resolved: every block walks only the non-empty tiles, and the
//     reference splits are cut by rank among them, so a masked tail (a
//     scan's capacity rows) leaves no split idle and none longer.
//   * Far query rows. The screen scores of a query over the valid rows
//     s = |r|^2 - 2 q.r lie in [-2 Q R, R^2 + 2 Q R], so a query with
//     delta_q >= R (R + 4 Q) (the helper far_rows in nn_cuda.py) passes every
//     group and resolves every row: ~25 instructions a pair, not ~4.5.
//     Queries at PAD_COORD (1e8) are such rows. They are not screened:
//     near work gives them thr = NaN (no group passes, no key), and far
//     work scores them in the direct form alone over the non-empty tiles
//     (9 instructions a pair: the direct form and an fminf over a group;
//     a group whose least d beats the best is searched again for the
//     lowest index among its rows).
//
// 4. Work items and blocks on the card. A thread holds kQ = 4 queries in
//    registers, so one broadcast float4 read from shared memory feeds 4
//    pairs; a block has 256 threads. Each block takes work items from a
//    counter until none is left: first the near items, (query block,
//    reference split), with the splits chosen by the wrapper so that the
//    near items fill one wave of resident blocks (from the SM count and the
//    occupancy that icpx_nn_blocks_per_sm reports) at 65,536 queries; then
//    the far items. The grid is two blocks a near item, at most that wave,
//    so blocks beyond the near items take far items while the near items
//    run. The near item of split 0 lists its query block's far rows (in no
//    order) and counts the block as classified. A far item waits until
//    every query block is classified: all of them were taken before it, by
//    blocks that are running, so the wait is short and cannot deadlock.
//    The far rows are then cut into chunks of kThreads * kQ rows (kQ a
//    thread, kThreads apart; one a thread in a chunk of at most kThreads
//    rows, so a few far rows spread over a few warps), and the non-empty
//    tiles into about kFarItems * grid / chunks pieces of ranks, so the far
//    work spreads over every block that the near items leave free.
//    A call with neither kind of row pays little for them: with no empty
//    tile a rank is its tile's index and the walk reads no tile_max, and a
//    block whose near item ends once every near item is taken and every
//    query block is classified without a far row (one u64 counts both)
//    leaves at once (measured on an H100: 0.4-0.7 us a call, 1-2%, over the
//    kernel without these paths, at 3,456^2 and 4,096^2).
//    icpx_nn_shape hands the constants to the wrapper, which sizes the
//    scratch and the split plan from them; icpx_nn_forward refuses a
//    scratch smaller than its own layout needs.
// 5. Combine. Each item's winners pack into one u64 key a query,
//    bits(d) << 32 | index (d >= 0, so the bits order as the values do),
//    folded with atomicMin into keys (nq,) that the pack kernel filled with
//    (bits(+inf) << 32 | 0). The u64 order is exactly "least d, then lowest
//    index", so the result does not depend on the order of the atomics; a
//    query with no valid reference keeps (+inf, 0). The last split of a
//    query block to finish (a ticket a query block) unpacks that block's
//    near rows; the last piece of a far chunk (a ticket a chunk) unpacks
//    the chunk's far rows. So a call is two launches, pack and search.
//    Counters (u64, accumulated over calls): [0] far rows, [1] empty tiles
//    skipped, n_tiles - non-empty tiles for every query block.
// 6. Staging. Tiles of kTileR packed rows move into shared memory with
//    16-byte cp.async copies, double buffered: the next non-empty tile is
//    in flight while the current one is scored.
//
// What holds it back (measured on an H100): the broadcast float4 loads
// from shared memory, ~0.25 ms of the ~0.95 at 65,536^2 (the screen runs
// at the FP32 issue rate with the operands in registers), and the resolves.
//
// Why not the tensor cores. The augmented depth is 4, half of an m16n8k8
// TF32 product. Plain TF32 keeps a 10-bit mantissa, so delta_q would grow
// ~8,000-fold and most groups would resolve; a 3xTF32 split costs two MMAs
// per 128 pairs, no faster than 3 FFMA, and the minimum over the fragment
// still costs one instruction a pair either way.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 4;        // queries a thread
constexpr int kGroup = 8;    // references screened per group
constexpr int kTileR = 256;  // packed rows a stage: one 16-byte copy per thread
constexpr int kRows = kThreads * kQ;  // query rows of a query block or of a far chunk
constexpr int kFarItems = 4;  // far pieces a resident block, about
constexpr float kDeltaScale = 1.9073486328125e-06f;  // 2^-19
constexpr unsigned long long kInitKey = 0x7f80000000000000ull;  // (bits(+inf) << 32) | 0
static_assert(kTileR == kThreads, "a stage is one 16-byte copy per thread");
static_assert(kTileR / kGroup <= 32, "a tile's groups fit the 32-bit resolve mask");

// The counters of ctl, each on a 128-byte line of its own (the waiting
// blocks poll one, the others take items from another): the next work item;
// one u64, the query blocks classified (low half) and how many of them listed
// a far row (high half), so that one read tells whether any far work exists;
// the far rows listed.
enum { kNextItem = 0, kClassified = 32, kFarCount = 64, kCtlWords = 96 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ float screen(float ax, float ay, float az, float4 r) {
  return __fmaf_rn(ax, r.x, __fmaf_rn(ay, r.y, __fmaf_rn(az, r.z, r.w)));
}

__device__ __forceinline__ float direct(float qx, float qy, float qz, float4 r) {
  const float dx = __fsub_rn(qx, r.x);
  const float dy = __fsub_rn(qy, r.y);
  const float dz = __fsub_rn(qz, r.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ unsigned long long pack_key(float d, int i) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) | static_cast<unsigned>(i);
}

// The scratch of one call, in this order: the packed rows (n_tiles * kTileR
// float4), keys (nq u64), each tile's largest valid rr (n_tiles u32, bits +
// 1, 0 for an empty tile), a ticket a query block and a ticket a far chunk
// (q_blocks u32 each), the far rows' indices (nq u32) and ctl (kCtlWords
// u32, from the next multiple of 8 bytes, for its u64).
struct Scratch {
  float4* packed;
  unsigned long long* keys;
  unsigned* tile_max;
  unsigned* tickets;
  unsigned* far_tickets;
  unsigned* far_rows;
  unsigned* ctl;
};

__host__ __device__ inline int query_blocks(int nq) { return (nq + kRows - 1) / kRows; }

int64_t scratch_layout(int nq, int nr, char* base, Scratch* out) {
  const int64_t n_tiles = ((int64_t)nr + kTileR - 1) / kTileR;
  const int64_t qb = query_blocks(nq);
  const int64_t packed = n_tiles * kTileR * 16, keys = 8 * (int64_t)nq, tile_max = 4 * n_tiles;
  const int64_t tickets = 4 * qb, far_rows = 4 * (int64_t)nq;
  if (out != nullptr) {
    char* p = base;
    out->packed = reinterpret_cast<float4*>(p);
    out->keys = reinterpret_cast<unsigned long long*>(p += packed);
    out->tile_max = reinterpret_cast<unsigned*>(p += keys);
    out->tickets = reinterpret_cast<unsigned*>(p += tile_max);
    out->far_tickets = reinterpret_cast<unsigned*>(p += tickets);
    out->far_rows = reinterpret_cast<unsigned*>(p += tickets);
    out->ctl = reinterpret_cast<unsigned*>(base + ((p + far_rows - base + 7) & ~7ll));
  }
  return ((packed + keys + tile_max + 2 * tickets + far_rows + 7) & ~7ll) + 4 * kCtlWords;
}

// Block b < n_tiles packs tile b of ref (nr, 3) into kTileR rows and writes
// the tile's largest valid rr (as bits + 1: rr >= 0, so the bits order as
// the values do; 0 where the tile has no valid row). Every block also fills
// its share of the keys with kInitKey and of the tickets and ctl with 0;
// with no tile at all (nr = 0) it writes the outputs (+inf, 0) itself.
__global__ void __launch_bounds__(kTileR)
nn_pack_kernel(const float* __restrict__ ref, const uint8_t* __restrict__ mask, int nq, int nr,
               int n_tiles, Scratch sc, float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ unsigned warp_max[kTileR / 32];
  const int j = blockIdx.x * kTileR + threadIdx.x;
  if (j < nq) {
    if (n_tiles > 0) {
      sc.keys[j] = kInitKey;
    } else {
      out_d[j] = CUDART_INF_F;
      out_i[j] = 0;
    }
  }
  if (j < query_blocks(nq)) {
    sc.tickets[j] = 0u;
    sc.far_tickets[j] = 0u;
  }
  if (j < kCtlWords) sc.ctl[j] = 0u;
  if (blockIdx.x >= n_tiles) return;  // uniform over the block
  float4 v = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_INF_F);
  unsigned bits = 0;
  if (j < nr && (mask == nullptr || mask[j] != 0)) {
    v.x = ref[3 * (int64_t)j + 0];
    v.y = ref[3 * (int64_t)j + 1];
    v.z = ref[3 * (int64_t)j + 2];
    v.w = __fadd_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)), __fmul_rn(v.z, v.z));
    bits = __float_as_uint(v.w) + 1u;
  }
  sc.packed[j] = v;
  const unsigned m = __reduce_max_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    const unsigned w = __reduce_max_sync(
        0xffffffffu, threadIdx.x < kTileR / 32 ? warp_max[threadIdx.x] : 0u);
    if (threadIdx.x == 0) sc.tile_max[blockIdx.x] = w;
  }
}

// The first non-empty tile in [t, hi), or hi.
__device__ __forceinline__ int next_tile(const unsigned* __restrict__ tile_max, int t, int hi) {
  while (t < hi && __ldg(tile_max + t) == 0u) ++t;
  return t;
}

// Walks the non-empty tiles of [lo, hi) in ascending order, each staged in
// shared memory (the next in flight while the current one is scored), and
// calls body(rows, t) with every thread of the block. `dense`: no tile is
// empty, so the walk reads no tile_max.
template <class Body>
__device__ __forceinline__ void walk_tiles(const float4* __restrict__ packed,
                                           const unsigned* __restrict__ tile_max, int lo, int hi,
                                           bool dense, float4 (*tile)[kTileR], Body body) {
  int t = dense ? lo : next_tile(tile_max, lo, hi), buf = 0;
  if (t < hi) {
    cp_async16(&tile[0][threadIdx.x], packed + (int64_t)t * kTileR + threadIdx.x);
    cp_async_commit();
  }
  while (t < hi) {
    const int tn = dense ? t + 1 : next_tile(tile_max, t + 1, hi);
    if (tn < hi) {
      cp_async16(&tile[buf ^ 1][threadIdx.x], packed + (int64_t)tn * kTileR + threadIdx.x);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // tile t is in shared memory for every thread
    body(tile[buf], t);
    __syncthreads();  // every thread is done with tile t before the next copy lands in its buffer
    t = tn;
    buf ^= 1;
  }
}

// A block's shared state: block-uniform values and each thread's count of
// non-empty tiles, kept out of the registers that the screen's loop needs.
struct Block {
  int item;    // the work item taken
  int slot;    // a tile index agreed by the block (tile_of_rank)
  int n_ne;    // non-empty tiles
  int per;     // tiles a thread counts: thread i the tiles [i * per, (i + 1) * per)
  float big_r; // sqrt of the largest valid rr
  unsigned u[3];
  unsigned no_far;  // every query block is classified and none listed a far row
  int pre[kThreads];  // non-empty tiles before thread i's tiles
  int cnt[kThreads];  // non-empty tiles among them
};

// The tile index of non-empty rank `rank` (n_tiles for rank >= every
// non-empty tile), agreed by the whole block; the rank itself when no tile
// is empty.
__device__ int tile_of_rank(const unsigned* __restrict__ tile_max, int n_tiles, Block& b,
                            int rank) {
  if (b.n_ne == n_tiles) return rank;  // uniform over the block
  __syncthreads();  // the last reader of slot is done
  if (threadIdx.x == 0) b.slot = n_tiles;
  __syncthreads();
  const int pre = b.pre[threadIdx.x];
  if (rank >= pre && rank < pre + b.cnt[threadIdx.x]) {
    int t = threadIdx.x * b.per, r = pre;
    for (;; ++t) {
      if (__ldg(tile_max + t) != 0u && r++ == rank) break;
    }
    b.slot = t;
  }
  __syncthreads();
  return b.slot;
}

__device__ __forceinline__ float row_norm(float qx, float qy, float qz) {
  return sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)), __fmul_rn(qz, qz)));
}

__device__ __forceinline__ float row_delta(float qn, float big_r) {
  const float sum = __fadd_rn(qn, big_r);
  return __fmul_rn(kDeltaScale, __fmul_rn(sum, sum));
}

// One near item, b.item: query block qb (kQ queries a thread, kThreads
// apart, so a warp loads neighbouring rows) over split `split` of the
// non-empty tiles by rank. A query is far when delta_q >= R (R + 4 |q|) and
// some reference is valid; it keeps thr = NaN here (no group passes, no key).
__device__ void near_item(const float* __restrict__ query, int nq, int n_tiles, int splits,
                          const Scratch& sc, unsigned long long* __restrict__ counts,
                          float* __restrict__ out_d, int* __restrict__ out_i,
                          float4 (*tile)[kTileR], Block& b) {
  const int q_blocks = query_blocks(nq);
  const int qb = b.item % q_blocks, split = b.item / q_blocks;
  const int n_ne = b.n_ne;
  const float big_r = b.big_r;
  float ax[kQ], ay[kQ], az[kQ], delta[kQ], thr[kQ], best_d[kQ];
  int best_i[kQ];
  unsigned pend[kQ];  // per query: the groups of this tile to resolve, one bit each
  unsigned far = 0u, near = 0u;  // bit k: query k is a far / near row
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int qi = qb * kRows + threadIdx.x + k * kThreads;
    const bool in = qi < nq;
    const float qx = in ? query[3 * (int64_t)qi + 0] : 0.f;
    const float qy = in ? query[3 * (int64_t)qi + 1] : 0.f;
    const float qz = in ? query[3 * (int64_t)qi + 2] : 0.f;
    ax[k] = -2.f * qx;
    ay[k] = -2.f * qy;
    az[k] = -2.f * qz;
    const float qn = row_norm(qx, qy, qz);
    delta[k] = row_delta(qn, big_r);
    const bool is_far =
        n_ne > 0 && delta[k] >= __fmul_rn(big_r, __fadd_rn(big_r, __fmul_rn(4.f, qn)));
    if (in) (is_far ? far : near) |= 1u << k;
    thr[k] = is_far ? CUDART_NAN_F : CUDART_INF_F;
    best_d[k] = CUDART_INF_F;
    best_i[k] = 0;
    pend[k] = 0u;
  }

  if (split == 0) {
    // List the block's far rows, then count the block as classified.
    if (threadIdx.x == 0 && n_tiles > n_ne) {
      atomicAdd(counts + 1, static_cast<unsigned long long>(n_tiles - n_ne));
    }
    if (threadIdx.x == 0) b.u[0] = 0u;
    if (__syncthreads_or(far != 0u)) {
      const int mine = __popc(far);
      const unsigned off = mine ? atomicAdd(&b.u[0], static_cast<unsigned>(mine)) : 0u;
      __syncthreads();
      if (threadIdx.x == 0) {
        b.u[1] = atomicAdd(sc.ctl + kFarCount, b.u[0]);
        atomicAdd(counts + 0, static_cast<unsigned long long>(b.u[0]));
      }
      __syncthreads();
      unsigned pos = b.u[1] + off;
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        if ((far >> k) & 1u) sc.far_rows[pos++] = qb * kRows + threadIdx.x + k * kThreads;
      }
      __threadfence();
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(sc.ctl + kClassified),
                1ull | (b.u[0] ? 1ull << 32 : 0ull));
    }
  }

  // A block of far rows alone has no near work.
  if (__syncthreads_or(near != 0u) && n_ne > 0) {
    const int lo = tile_of_rank(sc.tile_max, n_tiles, b, (int)((int64_t)split * n_ne / splits));
    const int hi =
        tile_of_rank(sc.tile_max, n_tiles, b, (int)((int64_t)(split + 1) * n_ne / splits));
    const bool dense = n_ne == n_tiles;
    walk_tiles(sc.packed, sc.tile_max, lo, hi, dense, tile, [&](const float4* rows, int t) {
      // Screen: a group whose least score passes lowers the threshold to that
      // score + delta_q (valid for any scanned row) and is marked for resolving.
      for (int gi = 0; gi < kTileR / kGroup; ++gi) {
        float gmin[kQ];
#pragma unroll
        for (int k = 0; k < kQ; ++k) gmin[k] = CUDART_INF_F;
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const float4 r = rows[gi * kGroup + g];  // a broadcast: every lane reads the same row
#pragma unroll
          for (int k = 0; k < kQ; ++k) gmin[k] = fminf(gmin[k], screen(ax[k], ay[k], az[k], r));
        }
        bool pass = false;
#pragma unroll
        for (int k = 0; k < kQ; ++k) pass |= gmin[k] <= thr[k];
        if (__any_sync(0xffffffffu, pass)) {  // warp-uniform, and rare once near rows are known
#pragma unroll
          for (int k = 0; k < kQ; ++k) {
            if (gmin[k] <= thr[k]) {
              thr[k] = fminf(thr[k], __fadd_rn(gmin[k], delta[k]));
              pend[k] |= 1u << gi;
            }
          }
        }
      }
      // Resolve each query's marked groups in ascending order: a warp pays the
      // largest count over its lanes once a tile, not a round per marked group.
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        const float qx = -0.5f * ax[k], qy = -0.5f * ay[k], qz = -0.5f * az[k];
        while (pend[k]) {
          const int g0 = (__ffs(pend[k]) - 1) * kGroup;
          pend[k] &= pend[k] - 1;
          float sr[kGroup];
#pragma unroll
          for (int g = 0; g < kGroup; ++g) sr[g] = screen(ax[k], ay[k], az[k], rows[g0 + g]);
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            const int g = g0 + j;
            const float s = sr[j];
            if (s > thr[k]) continue;  // cannot be a least row
            const float4 r = rows[g];
            if (r.w == CUDART_INF_F) continue;  // masked or padded
            const float d = direct(qx, qy, qz, r);
            if (d < best_d[k]) {  // strict: the lowest index keeps an exact tie
              best_d[k] = d;
              best_i[k] = t * kTileR + g;
              thr[k] = fminf(thr[k], __fadd_rn(s, delta[k]));
            }
          }
        }
      }
    });
  }

  const int q_base = (b.item % q_blocks) * kRows + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int qi = q_base + k * kThreads;
    if (qi < nq && best_d[k] != CUDART_INF_F) {
      atomicMin(sc.keys + qi, pack_key(best_d[k], best_i[k]));
    }
  }
  // The last split of this query block to get here unpacks the keys of its
  // near rows (thr is NaN for a far row, and only for one): every item's
  // atomics are visible device-wide before it takes its ticket. The same
  // thread reads whether any work is left for this block to take: none
  // when every near item is taken and every query block classified with no
  // far row (the three reads overlap).
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    b.u[2] = atomicAdd(sc.tickets + b.item % q_blocks, 1u) == static_cast<unsigned>(splits - 1);
    const unsigned long long c =
        *reinterpret_cast<volatile unsigned long long*>(sc.ctl + kClassified);
    const unsigned taken = *reinterpret_cast<volatile unsigned*>(sc.ctl + kNextItem);
    b.no_far = taken >= static_cast<unsigned>(q_blocks * splits) &&
               static_cast<unsigned>(c) == static_cast<unsigned>(q_blocks) && (c >> 32) == 0u;
  }
  __syncthreads();
  if (!b.u[2]) return;
  __threadfence();
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int qi = q_base + k * kThreads;
    if (qi < nq && !isnan(thr[k])) {
      const unsigned long long key = __ldcg(sc.keys + qi);  // from L2, where the atomics landed
      out_d[qi] = __uint_as_float(static_cast<unsigned>(key >> 32));
      out_i[qi] = static_cast<int>(static_cast<unsigned>(key));
    }
  }
}

// One far item: far chunk `chunk` (rows [chunk * kRows, ...) of the far
// list, NK a thread and kThreads apart, NK = 1 for a chunk of at most
// kThreads rows, so that a few far rows spread over a few warps) over the
// non-empty ranks [r0, r1), in the direct form alone; `pieces` items cover
// a chunk.
template <int NK>
__device__ void far_item(const float* __restrict__ query, int n_tiles, const Scratch& sc,
                         int n_far, int chunk, int r0, int r1, int pieces,
                         float* __restrict__ out_d, int* __restrict__ out_i,
                         float4 (*tile)[kTileR], Block& b) {
  float qx[NK], qy[NK], qz[NK], best_d[NK];
  int best_i[NK], qi[NK];
  const int f_base = chunk * kRows + threadIdx.x;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const bool in = f_base + k * kThreads < n_far;
    qi[k] = in ? static_cast<int>(__ldcg(sc.far_rows + f_base + k * kThreads)) : -1;
    qx[k] = in ? query[3 * (int64_t)qi[k] + 0] : 0.f;
    qy[k] = in ? query[3 * (int64_t)qi[k] + 1] : 0.f;
    qz[k] = in ? query[3 * (int64_t)qi[k] + 2] : 0.f;
    best_d[k] = CUDART_INF_F;
    best_i[k] = 0;
  }
  const bool busy = __any_sync(0xffffffffu, f_base < n_far);  // warp-uniform
  const int lo = tile_of_rank(sc.tile_max, n_tiles, b, r0);
  const int hi = tile_of_rank(sc.tile_max, n_tiles, b, r1);
  const bool dense = b.n_ne == n_tiles;
  walk_tiles(sc.packed, sc.tile_max, lo, hi, dense, tile, [&](const float4* rows, int t) {
    if (!busy) return;
    for (int gi = 0; gi < kTileR / kGroup; ++gi) {
      float gmin[NK];
#pragma unroll
      for (int k = 0; k < NK; ++k) gmin[k] = CUDART_INF_F;
#pragma unroll 1
      for (int g = 0; g < kGroup; ++g) {
        const float4 r = rows[gi * kGroup + g];  // masked rows score NaN, which fminf skips
#pragma unroll
        for (int k = 0; k < NK; ++k) gmin[k] = fminf(gmin[k], direct(qx[k], qy[k], qz[k], r));
      }
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        if (gmin[k] < best_d[k]) {  // strict: an earlier row keeps an exact tie
          int g = gi * kGroup;
          while (direct(qx[k], qy[k], qz[k], rows[g]) != gmin[k]) ++g;  // the lowest such row
          best_d[k] = gmin[k];
          best_i[k] = t * kTileR + g;
        }
      }
    }
  });
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    if (qi[k] >= 0 && best_d[k] != CUDART_INF_F) {
      const unsigned long long key = pack_key(best_d[k], best_i[k]);
      if (key < __ldcg(sc.keys + qi[k])) atomicMin(sc.keys + qi[k], key);
    }
  }
  // The last piece of this chunk to get here unpacks its rows' keys.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    b.u[2] = atomicAdd(sc.far_tickets + chunk, 1u) == static_cast<unsigned>(pieces - 1);
  }
  __syncthreads();
  if (!b.u[2]) return;
  __threadfence();
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    if (qi[k] >= 0) {
      const unsigned long long key = __ldcg(sc.keys + qi[k]);
      out_d[qi[k]] = __uint_as_float(static_cast<unsigned>(key >> 32));
      out_i[qi[k]] = static_cast<int>(static_cast<unsigned>(key));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
nn_search_kernel(const float* __restrict__ query, int nq, int n_tiles, int splits, Scratch sc,
                 unsigned long long* __restrict__ counts, float* __restrict__ out_d,
                 int* __restrict__ out_i) {
  __shared__ __align__(16) float4 tile[2][kTileR];
  __shared__ int warp_sum[kThreads / 32];
  __shared__ unsigned warp_max[kThreads / 32];
  __shared__ Block b;

  // The first work item, taken before the scan below so that the atomic's
  // round trip overlaps the scan's reads.
  unsigned first = 0u;
  if (threadIdx.x == 0) first = atomicAdd(sc.ctl + kNextItem, 1u);

  // The largest valid rr over every tile (bits + 1, 0 when there is none),
  // and the ranks of the non-empty tiles: thread i counts a run of tiles.
  {
    const int per = (n_tiles + kThreads - 1) / kThreads;
    const int t_lo = min(n_tiles, static_cast<int>(threadIdx.x) * per);
    const int t_hi = min(n_tiles, t_lo + per);
    unsigned m = 0;
    int cnt = 0;
    for (int t = t_lo; t < t_hi; ++t) {
      const unsigned v = __ldg(sc.tile_max + t);
      m = max(m, v);
      cnt += v != 0u;
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 31) warp_sum[warp] = incl;
    if (lane == 0) warp_max[warp] = m;
    __syncthreads();
    int before = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) before += w < warp ? warp_sum[w] : 0;
    b.pre[threadIdx.x] = before + incl - cnt;
    b.cnt[threadIdx.x] = cnt;
    if (threadIdx.x == 0) {
      int n_ne = 0;
      for (int w = 0; w < kThreads / 32; ++w) {
        n_ne += warp_sum[w];
        m = max(m, warp_max[w]);
      }
      b.n_ne = n_ne;
      b.per = per;
      b.big_r = m ? sqrtf(__uint_as_float(m - 1u)) : 0.f;
    }
  }

  for (bool round0 = true;; round0 = false) {
    if (threadIdx.x == 0) {
      b.item = static_cast<int>(round0 ? first : atomicAdd(sc.ctl + kNextItem, 1u));
    }
    __syncthreads();
    const int n_near = query_blocks(nq) * splits;
    if (b.item < n_near) {
      near_item(query, nq, n_tiles, splits, sc, counts, out_d, out_i, tile, b);
      if (b.no_far) return;  // no far item to take (uniform over the block)
      __syncthreads();  // every thread is done with b before thread 0 takes the next item
      continue;
    }
    // Far items: every query block was taken before this item, by a running
    // block, and is listed soon; wait for the last.
    if (threadIdx.x == 0) {
      const volatile unsigned long long* done =
          reinterpret_cast<volatile unsigned long long*>(sc.ctl + kClassified);
      unsigned long long c;
      while (static_cast<unsigned>(c = *done) < static_cast<unsigned>(query_blocks(nq))) {
        __nanosleep(500);
      }
      __threadfence();
      b.u[0] = (c >> 32) ? __ldcg(sc.ctl + kFarCount) : 0u;
    }
    __syncthreads();
    const int n_far = static_cast<int>(b.u[0]), n_ne = b.n_ne;
    const int chunks = (n_far + kRows - 1) / kRows;
    if (chunks == 0) return;
    const int want =
        min(n_ne, max(1, (kFarItems * static_cast<int>(gridDim.x) + chunks - 1) / chunks));
    const int per = (n_ne + want - 1) / want;    // ranks a piece
    const int pieces = (n_ne + per - 1) / per;  // pieces a chunk
    const int p = b.item - n_near;
    if (p >= chunks * pieces) return;
    const int c = p / chunks, chunk = p % chunks;
    if (n_far - chunk * kRows > kThreads) {
      far_item<kQ>(query, n_tiles, sc, n_far, chunk, c * per, min(n_ne, (c + 1) * per), pieces,
                   out_d, out_i, tile, b);
    } else {
      far_item<1>(query, n_tiles, sc, n_far, chunk, c * per, min(n_ne, (c + 1) * per), pieces,
                  out_d, out_i, tile, b);
    }
    __syncthreads();  // every thread is done with b before thread 0 takes the next item
  }
}

}  // namespace

extern "C" {

// The search kernel's shape: threads a block, queries a thread, references
// a screened group, packed rows a tile. The wrapper plans from these.
void icpx_nn_shape(int* threads, int* queries_per_thread, int* group, int* tile_r) {
  *threads = kThreads;
  *queries_per_thread = kQ;
  *group = kGroup;
  *tile_r = kTileR;
}

// Bytes of scratch icpx_nn_forward needs for nq queries and nr references.
long long icpx_nn_scratch_bytes(int nq, int nr) { return scratch_layout(nq, nr, nullptr, nullptr); }

// Resident search blocks an SM holds; a negative value is minus a CUDA error
// code.
int icpx_nn_blocks_per_sm(int device) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return -static_cast<int>(set);
  int n = 0;
  const cudaError_t rc =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, nn_search_kernel, kThreads, 0);
  return rc == cudaSuccess ? n : -static_cast<int>(rc);
}

// query (nq, 3) f32, ref (nr, 3) f32, ref_mask (nr,) bool/uint8 or null;
// scratch of scratch_bytes (at least icpx_nn_scratch_bytes(nq, nr)), 16-byte
// aligned; outputs d2 (nq,) f32 and index (nq,) i32; counts two u64 that
// the search adds its far rows and skipped empty tiles to. All
// contiguous, on `device`. The near items cut the non-empty tiles into
// `splits` ranges by rank; `grid` blocks take the work items. Launches the
// pack and search kernels on `stream`, does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue for a short scratch, no split
// or no block).
int icpx_nn_forward(const void* query, const void* ref, const void* ref_mask, int nq, int nr,
                    void* scratch, long long scratch_bytes, int splits, int grid, void* counts,
                    void* out_d, void* out_i, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (nq <= 0) return static_cast<int>(cudaGetLastError());
  Scratch sc;
  if (splits < 1 || grid < 1 ||
      scratch_bytes < scratch_layout(nq, nr, static_cast<char*>(scratch), &sc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (nr + kTileR - 1) / kTileR;
  const int q_tiles = (nq + kTileR - 1) / kTileR;
  const int pack_blocks = n_tiles > q_tiles ? n_tiles : q_tiles;
  nn_pack_kernel<<<pack_blocks, kTileR, 0, s>>>(
      static_cast<const float*>(ref), static_cast<const uint8_t*>(ref_mask), nq, nr, n_tiles, sc,
      static_cast<float*>(out_d), static_cast<int*>(out_i));
  if (n_tiles > 0) {
    nn_search_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(query), nq, n_tiles, splits, sc,
        static_cast<unsigned long long*>(counts), static_cast<float*>(out_d),
        static_cast<int*>(out_i));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* icpx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
