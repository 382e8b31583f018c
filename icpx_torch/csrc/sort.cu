// Segmented stable sort for Hopper (sm_90a): the median-level sorts of the
// KD tile-index build.
//
//   sort  replaces icpx/kernels/sort_pallas.py::_sort_kernel
//         (wrapper sort_segments, icpx_torch/kernels/sort_cuda.py).
//
// Contract: key (c, m) f32, m a power of two, with up to kMaxPayloads payload
// arrays whose rows are (c, m) rows of 4-byte words. Each of the c segments is
// sorted by (key, original position) ascending, which is a stable sort by key:
// the output equals torch.sort(key, dim=1, stable=True) applied to the key and
// every payload, for finite keys. Signed zeros compare equal (as in torch.sort
// and lax.sort); the output keeps each key's own bits.
//
// Design. A key and its segment-local position pack into one 64-bit integer
// whose unsigned order is the (key, position) order, so every element is
// distinct and a bitonic network, though not stable itself, has exactly one
// possible output: the stable order. The network sorts only these packed keys;
// the payload rows move once at the end, read at their source position and
// written at their destination.
//
// Cost. The bound is bytes: each key and payload word read once and written
// once (40 B an element for the KD build's key, xyz and index: 42 MB, 0.0125
// ms at 3.35 TB/s, a level at 1M points). What held the first version back
// was a barrier at every one of the network's log2(m) (log2(m) + 1) / 2
// stages (105 at m = 16,384) with one compare-exchange a thread between
// them, 64 blocks for 132 SMs at m = 16,384, and a payload description
// indexed at run time (an 88-byte stack frame). This one:
//
// 1. Registers. A block of kThreads = 512 threads holds kBlockElems = 8,192
//    packed keys, kE = 16 a thread. In layout A thread t holds the elements
//    t * kE + e: partner distances j < kE are compare-exchanges inside the
//    thread, kE <= j < 32 kE go through __shfl_xor_sync. Neither needs a
//    barrier. For 32 kE <= j < kBlockElems the block transposes to layout B
//    (thread t holds e * kThreads + t; kThreads / 32 = kE, so the element
//    index's warp bits become the in-thread ones) through shared memory, runs
//    those stages inside the thread, and transposes back: one barrier a
//    transpose, two a merge size, 8 for a whole 8,192-element block instead
//    of 91. Shared memory is padded one word in kE (stride 17 words in
//    layout A), so neither layout's accesses conflict on a bank.
// 2. Filling the card. Segments of m <= kBlockElems sort kBlockElems / m to
//    a block: 128 blocks a 1M level. At m = 2 kBlockElems (the first KD
//    level, 16,384) a segment is a thread-block cluster of 2: the one stage
//    whose partner lies in the other block (j = kBlockElems) reads it
//    through distributed shared memory, so that level is 128 blocks too.
//    Longer segments keep the chunked path: blocks sort chunks of
//    kBlockElems into a scratch array, a pass in device memory does each
//    stage of j >= kBlockElems, a block pass the rest of each merge size,
//    and the last one writes the outputs.
// 3. The outputs. The sorted keys' source positions go through shared memory
//    to layout B, so neighbouring threads write neighbouring destination
//    rows; each reads its
//    key and payload rows at the source, a 4-byte column at a time with
//    kGatherBatch loads in flight before their stores. On an H100 this phase
//    carries all the payload traffic and runs near the memory rate (20 of a 1M
//    level's 40-100 us), while the network before it leaves memory idle: so
//    right after loading its keys, a block asks L2 for the payload rows its
//    outputs will read (its own, or its cluster pair's), and those reads
//    overlap the network. The payload loop is unrolled over kMaxPayloads
//    with constant indices, so the description stays in the kernel's
//    parameter space: no stack frame.
//
// What holds it back (globaltimer stamps at each block's phases, H100 80GB
// HBM3 at 700 W, 1M levels): the network takes 14 us at m = 256 and 53 at
// 16,384, the outputs 18-30, against a 12.5 us bound. One block of 16 warps
// an SM (the register file is full) leaves the network latency-bound and
// serialises the two phases; overlapping them needs more, smaller blocks an
// SM or a producer warp that streams the payloads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxPayloads = 4;
constexpr int kE = 16;                        // packed keys a thread holds
constexpr int kLogE = 4;
constexpr int kThreads = 512;                 // threads a block
constexpr int kBlockElems = kE * kThreads;    // 8,192 packed keys a block
constexpr int kSmemWords = kBlockElems + kBlockElems / kE;  // one pad word in kE
constexpr size_t kSmemBytes = 2 * sizeof(uint64_t) * kSmemWords;  // two buffers
static_assert(1 << kLogE == kE, "kLogE = log2(kE)");
static_assert(kThreads / 32 == kE, "layout B puts the element index's warp bits in the thread");

struct Payloads {
  const uint32_t* in[kMaxPayloads];
  uint32_t* out[kMaxPayloads];
  int width[kMaxPayloads];  // 4-byte words a row
  int n;
};

// What a block pass reads, does and writes.
struct Pass {
  const float* key;      // (c, m) f32 keys: read to pack, and at the end
  uint64_t* work;        // (c, m) packed keys, the chunked path's scratch
  float* out_key;
  Payloads pl;
  int total;             // c * m
  int m;
  int k_lo, k_hi;        // merge sizes this pass runs
  int j_cap;             // largest partner distance it runs (below kBlockElems,
                         // or kBlockElems for a cluster pair)
};

// (key, position) as one integer whose unsigned order is key's float order
// (-0 = +0), then position.
__device__ __forceinline__ uint64_t pack(float key, uint32_t pos) {
  uint32_t b = __float_as_uint(key == 0.f ? 0.f : key);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((uint64_t)b << 32) | pos;
}

__device__ __forceinline__ void cas(uint64_t& a, uint64_t& b, bool asc) {
  const bool swap = (a > b) == asc;
  const uint64_t lo = swap ? b : a, hi = swap ? a : b;
  a = lo;
  b = hi;
}

__device__ __forceinline__ int padded(int i) { return i + i / kE; }

// The pair at global indices i < i + j of merge size k sorts ascending where
// bit k of i is clear, and always at k = m (i's segment-local index is < m).
__device__ __forceinline__ bool ascending(int i, int k, bool whole) { return whole || (i & k) == 0; }

// Layout A, partner distances jtop .. 1 below kE. a0: global index of this
// thread's element 0 (a multiple of kE), so from k = kE on every pair of the
// thread has one direction, that of a0.
__device__ __forceinline__ void thread_stages(uint64_t (&v)[kE], int jtop, int k, bool whole, int a0) {
  const bool asc0 = ascending(a0, k, whole);
#pragma unroll
  for (int jb = kLogE - 1; jb >= 0; --jb) {
    const int j = 1 << jb;
    if (j > jtop) continue;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      if (e & j) continue;
      cas(v[e], v[e + j], k >= kE ? asc0 : whole || (e & k) == 0);
    }
  }
}

// Layout A, partner distances jtop .. kE through the warp's shuffles: the
// partner of element e of thread t is element e of thread t ^ (j / kE).
__device__ __forceinline__ void warp_stages(uint64_t (&v)[kE], int jtop, int k, bool whole, int a0) {
  for (int j = jtop; j >= kE; j >>= 1) {
    const int lanes = j / kE;
    // k > j >= kE: bit k of every element's index is bit k of a0
    const bool keep_min = ((threadIdx.x & lanes) == 0) == ascending(a0, k, whole);
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const uint64_t o = __shfl_xor_sync(0xffffffffu, v[e], lanes);
      v[e] = (o < v[e]) == keep_min ? o : v[e];  // keys are distinct, but for the padding
    }
  }
}

// Layout B, partner distances jtop .. kThreads: element e of thread t is
// b0 + e * kThreads, its partner element e ^ (j / kThreads) of the same
// thread.
__device__ __forceinline__ void block_stages(uint64_t (&v)[kE], int jtop, int k, bool whole, int b0) {
#pragma unroll
  for (int jb = kLogE - 1; jb >= 0; --jb) {
    if ((kThreads << jb) > jtop) continue;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      if (e & (1 << jb)) continue;
      cas(v[e], v[e + (1 << jb)], ascending(b0 + e * kThreads, k, whole));
    }
  }
}

__device__ __forceinline__ void store_a(uint64_t* s, const uint64_t (&v)[kE]) {
#pragma unroll
  for (int e = 0; e < kE; ++e) s[padded(threadIdx.x * kE + e)] = v[e];
}
__device__ __forceinline__ void load_a(const uint64_t* s, uint64_t (&v)[kE]) {
#pragma unroll
  for (int e = 0; e < kE; ++e) v[e] = s[padded(threadIdx.x * kE + e)];
}
__device__ __forceinline__ void store_b(uint64_t* s, const uint64_t (&v)[kE]) {
#pragma unroll
  for (int e = 0; e < kE; ++e) s[padded(e * kThreads + threadIdx.x)] = v[e];
}
__device__ __forceinline__ void load_b(const uint64_t* s, uint64_t (&v)[kE]) {
#pragma unroll
  for (int e = 0; e < kE; ++e) v[e] = s[padded(e * kThreads + threadIdx.x)];
}

// Asks L2 for `bytes` from ptr, a 128-byte line a thread at a time.
__device__ __forceinline__ void prefetch_l2(const void* ptr, int64_t bytes) {
  const char* c = static_cast<const char*>(ptr);
  for (int64_t off = 128 * (int64_t)threadIdx.x; off < bytes; off += 128 * kThreads)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + off));
}

// One 4-byte column of the outputs: word f of each of this thread's kE rows
// in layout B (width w words; row d = b0 + e * kThreads takes the row at
// its segment's source position pos[padded(e * kThreads + threadIdx.x)],
// rows from `total` on none), kGatherBatch loads in flight before their
// stores. The positions stay in shared memory: as a register array they
// push the kernel past its 128-register cap.
constexpr int kGatherBatch = 4;  // 8 spills at the 128-register cap; 1, 2 and 16 are slower
__device__ __forceinline__ void move_column(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                                            int w, int f, const uint32_t* pos, int b0, int m,
                                            int total) {
#pragma unroll
  for (int h = 0; h < kE; h += kGatherBatch) {
    uint32_t t[kGatherBatch];
#pragma unroll
    for (int e = 0; e < kGatherBatch; ++e) {
      const int d = b0 + (h + e) * kThreads;
      const int src = d - (d & (m - 1)) + (int)pos[padded((h + e) * kThreads + threadIdx.x)];
      if (d < total) t[e] = in[(int64_t)src * w + f];
    }
#pragma unroll
    for (int e = 0; e < kGatherBatch; ++e) {
      const int d = b0 + (h + e) * kThreads;
      if (d < total) out[(int64_t)d * w + f] = t[e];
    }
  }
}

// One block pass over kBlockElems consecutive elements (a cluster pair: two
// blocks of one segment). kFromKey: pack the f32 keys, else load the packed
// keys from work. Then the merge sizes k_lo .. k_hi, each from partner
// distance min(k / 2, j_cap) down to 1. kToWork: store the packed keys to
// work, else write the sorted key and payloads. Elements past `total` hold
// the largest key; they form whole segments of their own (total and
// kBlockElems are multiples of m when m < kBlockElems) and are never
// written.
template <bool kFromKey, bool kToWork>
__global__ void __launch_bounds__(kThreads, 1) sort_block_kernel(const Pass p) {
  extern __shared__ uint64_t smem[];
  int nb = 0;  // the buffer (0 or 1) the next shared-memory store uses
  const int base = blockIdx.x * kBlockElems;
  const int a0 = base + threadIdx.x * kE;  // layout A: this thread's element 0
  const int b0 = base + threadIdx.x;       // layout B
  uint64_t v[kE];
  if (kFromKey) {
    const float* src = p.key + a0;
    if (base + kBlockElems <= p.total && (reinterpret_cast<uintptr_t>(p.key) & 15) == 0) {
#pragma unroll
      for (int e = 0; e < kE; e += 4) {
        const float4 f = *reinterpret_cast<const float4*>(src + e);
        v[e + 0] = pack(f.x, (uint32_t)((a0 + e + 0) & (p.m - 1)));
        v[e + 1] = pack(f.y, (uint32_t)((a0 + e + 1) & (p.m - 1)));
        v[e + 2] = pack(f.z, (uint32_t)((a0 + e + 2) & (p.m - 1)));
        v[e + 3] = pack(f.w, (uint32_t)((a0 + e + 3) & (p.m - 1)));
      }
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e)
        v[e] = a0 + e < p.total ? pack(src[e], (uint32_t)((a0 + e) & (p.m - 1))) : ~0ull;
    }
  } else {
    const ulonglong2* src = reinterpret_cast<const ulonglong2*>(p.work + a0);
#pragma unroll
    for (int e = 0; e < kE; e += 2) {
      const ulonglong2 w = src[e / 2];
      v[e] = w.x;
      v[e + 1] = w.y;
    }
  }

  if (!kToWork && p.m <= 2 * kBlockElems) {
    // the rows this block's outputs will read (its own, or its cluster
    // pair's), into L2 while the network runs: the device-memory traffic of
    // the payloads then overlaps the compare-exchanges
    const int rows = min(kBlockElems, p.total - base);
#pragma unroll
    for (int a = 0; a < kMaxPayloads; ++a)
      if (a < p.pl.n)
        prefetch_l2(p.pl.in[a] + (int64_t)base * p.pl.width[a], 4ll * rows * p.pl.width[a]);
  }
  for (int k = p.k_lo; k <= p.k_hi; k <<= 1) {
    const bool whole = k >= p.m;
    int j = min(k >> 1, p.j_cap);
    if (j >= kBlockElems) {
      // a cluster pair at k = m = 2 kBlockElems: element i of block rank r
      // against element i of rank r ^ 1, ascending, rank 0 the lower
      cg::cluster_group cluster = cg::this_cluster();
      const unsigned rank = cluster.block_rank();
      store_a((smem + nb * kSmemWords), v);
      cluster.sync();
      const uint64_t* other = cluster.map_shared_rank((smem + nb * kSmemWords), rank ^ 1u);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const uint64_t o = other[padded(threadIdx.x * kE + e)];
        v[e] = (o < v[e]) == (rank == 0) ? o : v[e];
      }
      cluster.sync();  // both blocks are done reading before either stores again
      j >>= 1;
    }
    if (j >= kThreads) {
      store_a((smem + nb * kSmemWords), v);
      __syncthreads();
      load_b((smem + nb * kSmemWords), v);
      nb ^= 1;
      block_stages(v, j, k, whole, b0);
      store_b((smem + nb * kSmemWords), v);
      __syncthreads();
      load_a((smem + nb * kSmemWords), v);
      nb ^= 1;
      j = kThreads >> 1;
    }
    if (j >= kE) {
      warp_stages(v, j, k, whole, a0);
      j = kE >> 1;
    }
    thread_stages(v, j, k, whole, a0);
  }

  if (kToWork) {
    ulonglong2* dst = reinterpret_cast<ulonglong2*>(p.work + a0);
#pragma unroll
    for (int e = 0; e < kE; e += 2) dst[e / 2] = make_ulonglong2(v[e], v[e + 1]);
    return;
  }
  // to layout B, the source positions alone (the keys' low words):
  // neighbouring threads write neighbouring destination rows
  uint32_t* pos = reinterpret_cast<uint32_t*>(smem + nb * kSmemWords);
#pragma unroll
  for (int e = 0; e < kE; ++e) pos[padded(threadIdx.x * kE + e)] = (uint32_t)v[e];
  __syncthreads();
  move_column(reinterpret_cast<const uint32_t*>(p.key), reinterpret_cast<uint32_t*>(p.out_key), 1,
              0, pos, b0, p.m, p.total);
#pragma unroll
  for (int a = 0; a < kMaxPayloads; ++a) {  // constant indices: the description stays in
    if (a < p.pl.n) {                        // the parameter space
      const int w = p.pl.width[a];
      for (int f = 0; f < w; ++f) move_column(p.pl.in[a], p.pl.out[a], w, f, pos, b0, p.m, p.total);
    }
  }
}

// The chunked path's stages of partner distance j >= kBlockElems, in device
// memory: a thread a pair.
__global__ void merge_global_kernel(uint64_t* __restrict__ work, int64_t pairs, int m, int k, int j) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pairs) return;
  const int64_t i = ((p & ~(int64_t)(j - 1)) << 1) | (p & (j - 1));
  const bool asc = ((i & (m - 1)) & k) == 0;
  const uint64_t a = work[i], b = work[i + j];
  if ((a > b) == asc) {
    work[i] = b;
    work[i + j] = a;
  }
}

template <bool kFromKey, bool kToWork>
cudaError_t launch_block(const Pass& p, int blocks, bool pair, cudaStream_t st) {
  static bool opted = false;  // the large dynamic shared memory, once a process
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(sort_block_kernel<kFromKey, kToWork>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)kSmemBytes);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  if (!pair) {
    sort_block_kernel<kFromKey, kToWork><<<blocks, kThreads, kSmemBytes, st>>>(p);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, sort_block_kernel<kFromKey, kToWork>, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// The kernel's shape: payloads at most, packed keys a block, threads a
// block. The wrapper plans from these.
void icpx_sort_shape(int* max_payloads, int* block_elems, int* threads) {
  *max_payloads = kMaxPayloads;
  *block_elems = kBlockElems;
  *threads = kThreads;
}

// key (c, m) f32 with m a power of two; payload a (c, m, widths[a]) 4-byte
// words in, pay_out[a] alike out; out_key (c, m) f32; work (c, m) u64 scratch,
// needed (and read) only when m > 2 * kBlockElems. All contiguous, on
// `device`, c * m < 2^31. Launches on `stream`, does not synchronise, and
// returns the first CUDA error (0 when none).
int icpx_sort_forward(const void* key, int c, int m, const void* const* pay_in,
                      void* const* pay_out, const int* widths, int n_payloads, void* out_key,
                      void* work, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n_payloads < 0 || n_payloads > kMaxPayloads || m < 1 || (m & (m - 1)) != 0 || c < 0 ||
      (int64_t)c * m >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Pass p{};
  p.key = static_cast<const float*>(key);
  p.work = static_cast<uint64_t*>(work);
  p.out_key = static_cast<float*>(out_key);
  p.pl.n = n_payloads;
  for (int a = 0; a < n_payloads; ++a) {
    p.pl.in[a] = static_cast<const uint32_t*>(pay_in[a]);
    p.pl.out[a] = static_cast<uint32_t*>(pay_out[a]);
    p.pl.width[a] = widths[a];
  }
  p.total = c * m;
  p.m = m;
  if (p.total == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (p.total + kBlockElems - 1) / kBlockElems;
  if (m <= 2 * kBlockElems) {  // whole segments in a block, or in a cluster pair
    p.k_lo = 2;
    p.k_hi = m;
    p.j_cap = kBlockElems;
    return static_cast<int>(launch_block<true, false>(p, blocks, m == 2 * kBlockElems, st));
  }
  if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  p.k_lo = 2;
  p.k_hi = kBlockElems;
  p.j_cap = kBlockElems / 2;
  if ((err = launch_block<true, true>(p, blocks, false, st)) != cudaSuccess) return static_cast<int>(err);
  const int64_t pairs = p.total / 2;
  const int pair_threads = 256;
  const unsigned pair_blocks = (unsigned)((pairs + pair_threads - 1) / pair_threads);
  for (int k = 2 * kBlockElems; k <= m; k <<= 1) {
    for (int j = k >> 1; j >= kBlockElems; j >>= 1) {
      merge_global_kernel<<<pair_blocks, pair_threads, 0, st>>>(p.work, pairs, m, k, j);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    p.k_lo = p.k_hi = k;
    err = k < m ? launch_block<false, true>(p, blocks, false, st)
                : launch_block<false, false>(p, blocks, false, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* icpx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
