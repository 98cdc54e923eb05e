// Row-wise argmax for Hopper (sm_90a): greedy sampling over [B, V] logits.
//
// Replaces: repro/kernels/sampling.py::_argmax_kernel (the Pallas TPU kernel
// behind block_argmax).  Same contract as torch.argmax / jnp.argmax: the
// lowest index among equal maxima wins, so a row of -inf returns 0; NaN
// ranks above every number (the first NaN wins), as in torch.argmax.
//
// What bounds it on this card: one compare per element read, so memory.
// Its design: one block of 1024 threads per row; each thread scans a
// strided slice of the row in ascending order keeping its (value, index)
// best, then warp shuffles and one shared-memory pass reduce the block's
// 1024 candidates with the same tie rule.  Comparisons only: no arithmetic
// touches the logits, so the result is exact.  With B rows there are only
// B blocks; splitting a row over several blocks is later work.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

// does (v1, i1) rank before (v2, i2)?
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  const bool n1 = v1 != v1, n2 = v2 != v2;
  if (n1 || n2) return n1 && n2 ? i1 < i2 : n1;
  if (v1 != v2) return v1 > v2;
  return i1 < i2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
argmax_kernel(const T* __restrict__ x, int* __restrict__ out, int V,
              int64_t row_stride) {
  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
  const T* row = x + (int64_t)blockIdx.x * row_stride;
  float best = -INFINITY;
  int bi = INT_MAX;
  for (int j = threadIdx.x; j < V; j += kThreads) {
    const float v = load_f32(row, j);
    if (better(v, j, best, bi)) {
      best = v;
      bi = j;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (better(ov, oi, best, bi)) {
      best = ov;
      bi = oi;
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sv[warp] = best;
    si[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    best = sv[lane];
    bi = si[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, best, bi)) {
        best = ov;
        bi = oi;
      }
    }
    if (lane == 0) out[blockIdx.x] = bi;
  }
}

}  // namespace

// x: [B, V] with unit stride along V and `row_stride` elements between rows;
// out: [B] int32.  V must be >= 1.
REPRO_EXPORT int argmax_rows(const void* x, void* out, int B, int V,
                             long long row_stride, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return cudaSuccess;
  if (V < 1) return cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  if (dtype == kF32)
    argmax_kernel<float><<<B, kThreads, 0, s>>>(
        static_cast<const float*>(x), o, V, row_stride);
  else if (dtype == kBF16)
    argmax_kernel<__nv_bfloat16><<<B, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), o, V, row_stride);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}
