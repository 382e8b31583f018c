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
// written at their destination (the TPU kernel carried every payload through
// every stage).
//   * m <= kSmemElems (16,384: 128 KB of packed keys): one block sorts a whole
//     segment in shared memory, or several segments at once when they are
//     short (the network's partners never cross an m-aligned segment), then
//     writes the outputs.
//   * larger m: blocks sort kSmemElems-element chunks in shared memory into a
//     scratch array, global passes do the merge stages whose partner distance
//     is a chunk or more, shared-memory passes the rest, and a last pass
//     writes the outputs.
//
// Cost. The bound is bytes: each key and payload word read once and written
// once (40 B an element for the KD build's key, xyz and index: 42 MB, 0.0125
// ms at 3.35 TB/s, a level at 1M points). The network does m log2(m)^2 / 4
// compare-exchanges a segment in shared memory with a barrier between stages;
// at m = 16,384 a level is 64 blocks of one segment each, half the SMs idle.
// Thread-block clusters (distributed shared memory) and a radix pass are later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPayloads = 4;
constexpr int kSmemElems = 16384;  // packed keys one block sorts in shared memory
constexpr int kBlockElems = 2048;  // elements a block takes when segments are shorter
constexpr int kMaxThreads = 1024;

struct Payloads {
  const uint32_t* in[kMaxPayloads];
  uint32_t* out[kMaxPayloads];
  int width[kMaxPayloads];  // 4-byte words a row
  int n;
};

// (key, position) as one integer whose unsigned order is key's float order
// (-0 = +0), then position.
__device__ __forceinline__ uint64_t pack(float key, uint32_t pos) {
  uint32_t b = __float_as_uint(key == 0.f ? 0.f : key);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((uint64_t)b << 32) | pos;
}

// The lower element of compare-exchange pair p at partner distance j.
__device__ __forceinline__ int64_t lower_of(int64_t p, int64_t j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

// One stage of the bitonic network over e shared-memory elements whose first
// has segment-local index `base`: merge size k, partner distance j. A pair
// sorts ascending where the segment-local index has bit k clear (always at
// k = m), descending elsewhere.
__device__ __forceinline__ void stage_smem(uint64_t* s, int e, int base, int m, int k, int j) {
  for (int p = threadIdx.x; p < e / 2; p += blockDim.x) {
    const int i = (int)lower_of(p, j);
    const bool asc = (((base + i) & (m - 1)) & k) == 0;
    const uint64_t a = s[i], b = s[i + j];
    if ((a > b) == asc) {
      s[i] = b;
      s[i + j] = a;
    }
  }
  __syncthreads();
}

// Destination element dst takes its key and payload rows from element src.
__device__ __forceinline__ void move_row(const float* key, int64_t dst, int64_t src,
                                         float* out_key, const Payloads& pl) {
  out_key[dst] = key[src];
  for (int a = 0; a < pl.n; ++a) {
    const int w = pl.width[a];
    for (int f = 0; f < w; ++f) pl.out[a][dst * w + f] = pl.in[a][src * w + f];
  }
}

// m <= kSmemElems: g whole segments a block, the full network in shared
// memory, then the outputs. Slots past the last segment hold the largest key
// and are never written.
__global__ void sort_local_kernel(const float* __restrict__ key, int64_t total, int m, int g,
                                  float* __restrict__ out_key, Payloads pl) {
  extern __shared__ uint64_t s[];
  const int e = g * m;
  const int64_t base = (int64_t)blockIdx.x * e;
  for (int i = threadIdx.x; i < e; i += blockDim.x)
    s[i] = base + i < total ? pack(key[base + i], (uint32_t)(i & (m - 1))) : ~0ull;
  __syncthreads();
  for (int k = 2; k <= m; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) stage_smem(s, e, 0, m, k, j);
  for (int i = threadIdx.x; i < e; i += blockDim.x) {
    const int64_t dst = base + i;
    if (dst < total) move_row(key, dst, dst - (i & (m - 1)) + (uint32_t)s[i], out_key, pl);
  }
}

// m > kSmemElems, first pass: each block sorts one kSmemElems chunk through
// merge sizes 2 .. kSmemElems, with the directions of the whole segment's
// network, into the scratch array.
__global__ void sort_chunk_kernel(const float* __restrict__ key, int m, uint64_t* __restrict__ work) {
  extern __shared__ uint64_t s[];
  const int64_t base = (int64_t)blockIdx.x * kSmemElems;
  const int lin = (int)(base & (m - 1));  // segment-local index of the chunk's first element
  for (int i = threadIdx.x; i < kSmemElems; i += blockDim.x)
    s[i] = pack(key[base + i], (uint32_t)(lin + i));
  __syncthreads();
  for (int k = 2; k <= kSmemElems; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) stage_smem(s, kSmemElems, lin, m, k, j);
  for (int i = threadIdx.x; i < kSmemElems; i += blockDim.x) work[base + i] = s[i];
}

// One stage of merge size k at partner distance j >= kSmemElems, in device
// memory: a thread a pair.
__global__ void merge_global_kernel(uint64_t* __restrict__ work, int64_t pairs, int m, int k, int j) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pairs) return;
  const int64_t i = lower_of(p, j);
  const bool asc = ((i & (m - 1)) & k) == 0;
  const uint64_t a = work[i], b = work[i + j];
  if ((a > b) == asc) {
    work[i] = b;
    work[i + j] = a;
  }
}

// The stages of merge size k with partner distance < kSmemElems, one chunk a
// block in shared memory.
__global__ void merge_local_kernel(uint64_t* __restrict__ work, int m, int k) {
  extern __shared__ uint64_t s[];
  const int64_t base = (int64_t)blockIdx.x * kSmemElems;
  const int lin = (int)(base & (m - 1));
  for (int i = threadIdx.x; i < kSmemElems; i += blockDim.x) s[i] = work[base + i];
  __syncthreads();
  for (int j = kSmemElems >> 1; j > 0; j >>= 1) stage_smem(s, kSmemElems, lin, m, k, j);
  for (int i = threadIdx.x; i < kSmemElems; i += blockDim.x) work[base + i] = s[i];
}

// The outputs from the sorted scratch array: a thread an element.
__global__ void permute_kernel(const float* __restrict__ key, const uint64_t* __restrict__ work,
                               int64_t total, int m, float* __restrict__ out_key, Payloads pl) {
  const int64_t dst = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (dst >= total) return;
  move_row(key, dst, dst - (dst & (m - 1)) + (uint32_t)work[dst], out_key, pl);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// key (c, m) f32 with m a power of two; payload a (c, m, widths[a]) 4-byte
// words in, pay_out[a] alike out; out_key (c, m) f32; work (c, m) u64 scratch,
// needed (and read) only when m > 16,384. All contiguous, on `device`.
// Launches on `stream`, does not synchronise, and returns the first CUDA
// error (0 when none).
int icpx_sort_forward(const void* key, int c, int m, const void* const* pay_in,
                      void* const* pay_out, const int* widths, int n_payloads, void* out_key,
                      void* work, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n_payloads < 0 || n_payloads > kMaxPayloads || m < 1 || (m & (m - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Payloads pl{};
  pl.n = n_payloads;
  for (int a = 0; a < n_payloads; ++a) {
    pl.in[a] = static_cast<const uint32_t*>(pay_in[a]);
    pl.out[a] = static_cast<uint32_t*>(pay_out[a]);
    pl.width[a] = widths[a];
  }
  const int64_t total = (int64_t)c * m;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* k_in = static_cast<const float*>(key);
  float* k_out = static_cast<float*>(out_key);
  cudaError_t err;
  if (m <= kSmemElems) {
    const int g = m >= kBlockElems ? 1 : kBlockElems / m;
    const int e = g * m;
    const size_t smem = sizeof(uint64_t) * (size_t)e;
    if ((err = allow_smem(sort_local_kernel, smem)) != cudaSuccess) return static_cast<int>(err);
    // e >= kBlockElems = 2 * kMaxThreads: every thread has a pair in each stage
    sort_local_kernel<<<(c + g - 1) / g, kMaxThreads, smem, st>>>(k_in, total, m, g, k_out, pl);
    return static_cast<int>(cudaGetLastError());
  }
  uint64_t* w = static_cast<uint64_t*>(work);
  const size_t smem = sizeof(uint64_t) * (size_t)kSmemElems;
  if ((err = allow_smem(sort_chunk_kernel, smem)) != cudaSuccess) return static_cast<int>(err);
  if ((err = allow_smem(merge_local_kernel, smem)) != cudaSuccess) return static_cast<int>(err);
  const int chunks = (int)(total / kSmemElems);
  sort_chunk_kernel<<<chunks, kMaxThreads, smem, st>>>(k_in, m, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int64_t pairs = total / 2;
  const int pair_threads = 256;
  const unsigned pair_blocks = (unsigned)((pairs + pair_threads - 1) / pair_threads);
  for (int k = 2 * kSmemElems; k <= m; k <<= 1) {
    for (int j = k >> 1; j >= kSmemElems; j >>= 1) {
      merge_global_kernel<<<pair_blocks, pair_threads, 0, st>>>(w, pairs, m, k, j);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    merge_local_kernel<<<chunks, kMaxThreads, smem, st>>>(w, m, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = 256;
  permute_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(k_in, w, total, m,
                                                                                  k_out, pl);
  return static_cast<int>(cudaGetLastError());
}

const char* icpx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
