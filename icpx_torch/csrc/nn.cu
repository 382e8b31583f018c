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
//    every padded row past nr, is (0, 0, 0, +inf). The same pass writes
//    each tile's largest rr over its valid rows (every search block takes
//    the largest of those) and initialises the keys and tickets of step 5.
// 2. Screen (nn_search_kernel). With a = -2q the score
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
// lowest index wins under the strict '<'. Queries at PAD_COORD (1e8) get a
// delta_q far above the spread of their scores: every group resolves for
// them, which is right and slow for those warps only.
//
// 4. Work per thread and blocks on the card. A thread holds kQ = 4 queries
//    in registers, so one broadcast float4 read from shared memory feeds 4
//    pairs; a block has 256 threads. The grid is (query blocks, reference
//    splits): the wrapper chooses the splits from nq, nr, the SM count and
//    the occupancy that icpx_nn_blocks_per_sm reports, so that one wave
//    fills the card at 65,536 queries; at 3,456 there is one split a tile.
//    icpx_nn_shape hands these constants to the wrapper, which sizes the
//    scratch and the split plan from them; icpx_nn_forward refuses a
//    scratch smaller than its own layout needs.
// 5. Combine the splits. Each split's winner packs into one u64 key,
//    bits(d) << 32 | index (d >= 0, so the bits order as the values do),
//    folded with atomicMin into keys (nq,) that the pack kernel filled with
//    (bits(+inf) << 32 | 0). The u64 order is exactly "least d, then lowest
//    index", so the result does not depend on the order of the atomics; a
//    query with no valid reference keeps (+inf, 0). The last split block of
//    a query block to finish (a ticket counter a query block, zeroed by the
//    pack kernel) unpacks d and index for that block's queries, so a call
//    is two launches, pack and search.
// 6. Staging. Tiles of kTileR packed rows move into shared memory with
//    16-byte cp.async copies, double buffered: the next tile is in flight
//    while the current one is scored.
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
constexpr float kDeltaScale = 1.9073486328125e-06f;  // 2^-19
constexpr unsigned long long kInitKey = 0x7f80000000000000ull;  // (bits(+inf) << 32) | 0
static_assert(kTileR == kThreads, "a stage is one 16-byte copy per thread");
static_assert(kTileR / kGroup <= 32, "a tile's groups fit the 32-bit resolve mask");

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

// The scratch of one call, in this order: the packed rows (n_tiles * kTileR
// float4), keys (nq u64), each tile's largest valid rr (n_tiles u32) and a
// ticket a query block (q_blocks u32).
struct Scratch {
  float4* packed;
  unsigned long long* keys;
  unsigned* tile_max;
  unsigned* tickets;
};

__host__ __device__ inline int query_blocks(int nq) {
  return (nq + kThreads * kQ - 1) / (kThreads * kQ);
}

int64_t scratch_layout(int nq, int nr, char* base, Scratch* out) {
  const int64_t n_tiles = ((int64_t)nr + kTileR - 1) / kTileR;
  const int64_t packed = n_tiles * kTileR * 16, keys = 8 * (int64_t)nq, tile_max = 4 * n_tiles;
  if (out != nullptr) {
    out->packed = reinterpret_cast<float4*>(base);
    out->keys = reinterpret_cast<unsigned long long*>(base + packed);
    out->tile_max = reinterpret_cast<unsigned*>(base + packed + keys);
    out->tickets = reinterpret_cast<unsigned*>(base + packed + keys + tile_max);
  }
  return packed + keys + tile_max + 4 * (int64_t)query_blocks(nq);
}

// Block b < n_tiles packs tile b of ref (nr, 3) into kTileR rows and writes
// the tile's largest valid rr (as bits: rr >= 0, so the bits order as the
// values do; 0 where the tile has no valid row). Every block also fills its
// share of the keys with kInitKey and of the tickets with 0; with no tile
// at all (nr = 0) it writes the outputs (+inf, 0) itself.
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
  if (j < query_blocks(nq)) sc.tickets[j] = 0u;
  if (blockIdx.x >= n_tiles) return;  // uniform over the block
  float4 v = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
  unsigned bits = 0;
  if (j < nr && (mask == nullptr || mask[j] != 0)) {
    v.x = ref[3 * (int64_t)j + 0];
    v.y = ref[3 * (int64_t)j + 1];
    v.z = ref[3 * (int64_t)j + 2];
    v.w = __fadd_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)), __fmul_rn(v.z, v.z));
    bits = __float_as_uint(v.w);
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

__global__ void __launch_bounds__(kThreads)
nn_search_kernel(const float* __restrict__ query, int nq, int n_tiles, int tiles_per_split,
                 Scratch sc, float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ __align__(16) float4 tile[2][kTileR];
  __shared__ unsigned warp_max[kThreads / 32];
  __shared__ bool last;

  // The largest valid rr over every tile (0 when there is none: every
  // screen score is then +inf and no group ever resolves a valid row).
  unsigned m = 0;
  for (int t = threadIdx.x; t < n_tiles; t += kThreads) m = max(m, sc.tile_max[t]);
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
  const float big_r = sqrtf(__uint_as_float(m));
  const float4* __restrict__ packed = sc.packed;

  float ax[kQ], ay[kQ], az[kQ], delta[kQ], thr[kQ], best_d[kQ];
  int best_i[kQ];
  unsigned pend[kQ];  // per query: the groups of this tile to resolve, one bit each
  const int q_base = blockIdx.x * (kThreads * kQ) + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    // a thread's queries are kThreads apart: a warp loads neighbouring rows
    const int qi = q_base + k * kThreads;
    const bool in = qi < nq;
    const float qx = in ? query[3 * (int64_t)qi + 0] : 0.f;
    const float qy = in ? query[3 * (int64_t)qi + 1] : 0.f;
    const float qz = in ? query[3 * (int64_t)qi + 2] : 0.f;
    ax[k] = -2.f * qx;
    ay[k] = -2.f * qy;
    az[k] = -2.f * qz;
    const float qn = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)),
                                     __fmul_rn(qz, qz)));
    const float sum = __fadd_rn(qn, big_r);
    delta[k] = __fmul_rn(kDeltaScale, __fmul_rn(sum, sum));
    thr[k] = CUDART_INF_F;
    best_d[k] = CUDART_INF_F;
    best_i[k] = 0;
    pend[k] = 0u;
  }

  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(n_tiles, t0 + tiles_per_split);
  if (t0 < t1) {
    cp_async16(&tile[0][threadIdx.x], packed + (int64_t)t0 * kTileR + threadIdx.x);
    cp_async_commit();
  }
  for (int t = t0; t < t1; ++t) {
    const int buf = (t - t0) & 1;
    if (t + 1 < t1) {
      cp_async16(&tile[buf ^ 1][threadIdx.x], packed + (int64_t)(t + 1) * kTileR + threadIdx.x);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // tile t is in shared memory for every thread
    const float4* rows = tile[buf];
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
    __syncthreads();  // every thread is done with tile t before t + 2 lands in its buffer
  }

#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int qi = q_base + k * kThreads;
    if (qi < nq && best_d[k] != CUDART_INF_F) {
      const unsigned long long key =
          (static_cast<unsigned long long>(__float_as_uint(best_d[k])) << 32) |
          static_cast<unsigned>(best_i[k]);
      atomicMin(sc.keys + qi, key);
    }
  }
  // The last split block of this query block to get here unpacks the keys:
  // every block's atomics are visible device-wide before it takes its ticket.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(sc.tickets + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int qi = q_base + k * kThreads;
    if (qi < nq) {
      const unsigned long long key = __ldcg(sc.keys + qi);  // from L2, where the atomics landed
      out_d[qi] = __uint_as_float(static_cast<unsigned>(key >> 32));
      out_i[qi] = static_cast<int>(static_cast<unsigned>(key));
    }
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
// aligned; outputs d2 (nq,) f32 and index (nq,) i32. All contiguous, on
// `device`. The reference splits are tiles_per_split tiles of kTileR rows
// each. Launches the pack and search kernels on `stream`, does not
// synchronise, and returns cudaGetLastError() (cudaErrorInvalidValue for a
// short scratch or a split of no tiles).
int icpx_nn_forward(const void* query, const void* ref, const void* ref_mask, int nq, int nr,
                    void* scratch, long long scratch_bytes, int tiles_per_split, void* out_d,
                    void* out_i, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (nq <= 0) return static_cast<int>(cudaGetLastError());
  Scratch sc;
  if (tiles_per_split < 1 || scratch_bytes < scratch_layout(nq, nr, static_cast<char*>(scratch), &sc)) {
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
    const dim3 grid(query_blocks(nq), (n_tiles + tiles_per_split - 1) / tiles_per_split);
    nn_search_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(query), nq, n_tiles,
                                               tiles_per_split, sc, static_cast<float*>(out_d),
                                               static_cast<int*>(out_i));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* icpx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
