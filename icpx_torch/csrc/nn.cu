// Exact brute-force 1-nearest-neighbour search in fp32, for Hopper (sm_90a).
//
// Replaces icpx/kernels/knn_pallas.py::_nn_kernel (wrapper nn_pallas). For
// every query row it returns the squared distance to, and the index of, the
// nearest valid reference row.
//
// Contract (the JAX package's off-TPU contract, icpx/kernels/knn.py:180-189):
//   * masked reference rows never win;
//   * ties go to the LOWEST reference index: refs are scanned in ascending
//     order and a candidate replaces the running best only when strictly
//     closer. (The TPU kernel's lane/chunk fold can return a higher index
//     among exact ties, knn_pallas.py:66-84.)
//   * a query with no valid reference gets d2 = +inf and index 0.
//
// Cost model. At 65,536 x 65,536 one call scores 4.3e9 pairs. Each pair is
// 3 FSUB + 1 FMUL + 2 FFMA, a compare and two selects, with no memory
// traffic of its own: the kernel is bound by the FP32 issue rate. To stay
// off the memory side of that bound, a block stages a tile of reference
// points in shared memory as float4 (x, y, z, unused); every thread of a
// warp reads the same element, which is a broadcast with no bank
// conflicts, and each value read is reused by kQueriesPerThread queries
// held in registers. Masked and out-of-range refs are staged as NaN: every
// comparison with NaN is false, so they cost no extra instruction and can
// never win.
//
// The score is the direct form (q - r)^2, which has no cancellation; the
// plain PyTorch version (nearest_neighbor_reference in
// icpx_torch/kernels/nn_cuda.py) computes the same formula, so the two agree
// to fp32 rounding (FMA contraction may differ in the last bit).
//
// Later work (not here): tensor-core scoring with 3xTF32 splits, splitting
// refs across blocks when Nq is small, TMA staging.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kQueriesPerThread = 2;
constexpr int kQueriesPerBlock = kThreads * kQueriesPerThread;
constexpr int kTileR = 1024;  // 16 KB of float4 in shared memory

__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ query, const float* __restrict__ ref,
          const uint8_t* __restrict__ ref_mask, int nq, int nr,
          float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float4 tile[kTileR];
  const float kNaN = __int_as_float(0x7fc00000);
  const float kInf = __int_as_float(0x7f800000);

  float qx[kQueriesPerThread], qy[kQueriesPerThread], qz[kQueriesPerThread];
  float best[kQueriesPerThread];
  int best_i[kQueriesPerThread];
  const int q_base = blockIdx.x * kQueriesPerBlock + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kQueriesPerThread; ++k) {
    // Queries of one thread are kThreads apart, so loads and stores of a
    // warp touch neighbouring rows.
    const int qi = q_base + k * kThreads;
    const bool in = qi < nq;
    qx[k] = in ? query[3 * (int64_t)qi + 0] : 0.f;
    qy[k] = in ? query[3 * (int64_t)qi + 1] : 0.f;
    qz[k] = in ? query[3 * (int64_t)qi + 2] : 0.f;
    best[k] = kInf;
    best_i[k] = 0;
  }

  for (int base = 0; base < nr; base += kTileR) {
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < kTileR; j += kThreads) {
      const int r = base + j;
      float4 v = make_float4(kNaN, kNaN, kNaN, 0.f);
      if (r < nr && (ref_mask == nullptr || ref_mask[r] != 0)) {
        v.x = ref[3 * (int64_t)r + 0];
        v.y = ref[3 * (int64_t)r + 1];
        v.z = ref[3 * (int64_t)r + 2];
      }
      tile[j] = v;
    }
    __syncthreads();
    const int count = min(kTileR, nr - base);
#pragma unroll 8
    for (int j = 0; j < count; ++j) {
      const float4 r = tile[j];
#pragma unroll
      for (int k = 0; k < kQueriesPerThread; ++k) {
        const float dx = qx[k] - r.x;
        const float dy = qy[k] - r.y;
        const float dz = qz[k] - r.z;
        const float d = dx * dx + dy * dy + dz * dz;
        if (d < best[k]) {  // strict: the lowest index keeps an exact tie
          best[k] = d;
          best_i[k] = base + j;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kQueriesPerThread; ++k) {
    const int qi = q_base + k * kThreads;
    if (qi < nq) {
      out_d[qi] = best[k];
      out_i[qi] = best_i[k];
    }
  }
}

}  // namespace

extern "C" {

// query (nq, 3) f32, ref (nr, 3) f32, ref_mask (nr,) bool/uint8 or null,
// outputs d2 (nq,) f32 and index (nq,) i32; all contiguous, on `device`.
// Launches on `stream`, does not synchronise, and returns cudaGetLastError().
int icpx_nn_forward(const void* query, const void* ref, const void* ref_mask,
                    int nq, int nr, void* out_d, void* out_i, int device,
                    void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (nq > 0) {
    const int blocks = (nq + kQueriesPerBlock - 1) / kQueriesPerBlock;
    nn_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(query), static_cast<const float*>(ref),
        static_cast<const uint8_t*>(ref_mask), nq, nr,
        static_cast<float*>(out_d), static_cast<int*>(out_i));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* icpx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
