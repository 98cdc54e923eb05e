// Row-wise argmax for Hopper (sm_90a): greedy sampling over [B, V] logits.
//
// Replaces: repro/kernels/sampling.py::_argmax_kernel (the Pallas TPU kernel
// behind block_argmax).  Same contract as torch.argmax / jnp.argmax: the
// lowest index among equal maxima wins, so a row of -inf returns 0; NaN
// ranks above every number (the first NaN wins), as in torch.argmax.
//
// What bounds it on this card: one compare per element read, so memory:
// [8, 151936] bf16 is 2.43 MB, 0.73 us at 3.35 TB/s.  At that size the
// time is launch latency plus how many bytes are in flight, so the design
// spreads a row over SPLIT CTAs (the wrapper's argmax_plan: up to 8, the
// portable cluster size, 64 CTAs on 64 SMs at B = 8) and reads with
// 16-byte loads, four in flight a thread.  CTA r of a row scans the
// elements [r * chunk, min(V, (r + 1) * chunk)): scalar loads up to the
// first 16-byte boundary (the wrapper passes any row stride, so a view's
// rows start anywhere), 16-byte vectors (8 bf16 or 4 fp32), then a scalar
// tail.  Each thread keeps its (value, index) best, warp shuffles and one
// shared-memory pass reduce the CTA's, and the SPLIT CTAs of a row, one
// thread block cluster, combine their candidates through distributed
// shared memory (cluster.map_shared_rank): one launch, no global scratch,
// no counter.  better() is a strict total order on (value, index) pairs
// (NaN above numbers, then the larger value, then the lower index), so
// every combine order gives the same exact answer; comparisons only, no
// arithmetic touches the logits.
#include <climits>
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;         // 16-byte loads in flight a thread
// CTAs a row that the combine can take (one lane of warp 0 each); the
// launch itself rejects clusters past the portable size of 8
constexpr int kMaxSplit = 32;

// does (v1, i1) rank before (v2, i2)?
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  const bool n1 = v1 != v1, n2 = v2 != v2;
  if (n1 || n2) return n1 && n2 ? i1 < i2 : n1;
  if (v1 != v2) return v1 > v2;
  return i1 < i2;
}

__device__ __forceinline__ void take(float v, int i, float& best, int& bi) {
  if (better(v, i, best, bi)) {
    best = v;
    bi = i;
  }
}

__device__ __forceinline__ void warp_best(float& best, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    take(__shfl_xor_sync(0xffffffffu, best, off),
         __shfl_xor_sync(0xffffffffu, bi, off), best, bi);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
argmax_kernel(const T* __restrict__ x, int* __restrict__ out, int V,
              int64_t row_stride, int chunk) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float wv[kThreads / 32];
  __shared__ int wi[kThreads / 32];
  __shared__ float cta_v;            // this CTA's candidate, read by rank 0
  __shared__ int cta_i;
  cg::cluster_group cluster = cg::this_cluster();
  const T* row = x + (int64_t)blockIdx.y * row_stride;
  const int lo = blockIdx.x * chunk, hi = min(V, lo + chunk);
  float best = -INFINITY;
  int bi = INT_MAX;

  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(row + lo) & 15) / sizeof(T));
  const int body = min(hi, lo + (mis ? VEC - mis : 0));   // first aligned
  if (lo + (int)threadIdx.x < body)
    take(load_f32(row, lo + threadIdx.x), lo + threadIdx.x, best, bi);
  const int nvec = (hi - body) / VEC;
  const uint4* vp = reinterpret_cast<const uint4*>(row + body);
  for (int base = threadIdx.x; base < nvec; base += kThreads * kUnroll) {
    uint4 u[kUnroll];
#pragma unroll
    for (int w = 0; w < kUnroll; ++w)
      if (base + w * kThreads < nvec) u[w] = __ldg(vp + base + w * kThreads);
#pragma unroll
    for (int w = 0; w < kUnroll; ++w) {
      const int vi = base + w * kThreads;
      if (vi < nvec) {
        const T* e = reinterpret_cast<const T*>(&u[w]);
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          take(load_f32(e, c), body + vi * VEC + c, best, bi);
      }
    }
  }
  const int tail = body + nvec * VEC;
  if (tail + (int)threadIdx.x < hi)
    take(load_f32(row, tail + threadIdx.x), tail + threadIdx.x, best, bi);

  warp_best(best, bi);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    wv[warp] = best;
    wi[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < kThreads / 32 ? wv[lane] : -INFINITY;
    bi = lane < kThreads / 32 ? wi[lane] : INT_MAX;
    warp_best(best, bi);
    if (lane == 0) {
      cta_v = best;
      cta_i = bi;
    }
  }
  cluster.sync();                    // every CTA's candidate is written
  if (blockIdx.x == 0 && warp == 0) {
    const int n = gridDim.x;         // the cluster spans the row's CTAs
    best = -INFINITY;
    bi = INT_MAX;
    if (lane < n) {
      best = *cluster.map_shared_rank(&cta_v, lane);
      bi = *cluster.map_shared_rank(&cta_i, lane);
    }
    warp_best(best, bi);
    if (lane == 0) out[blockIdx.y] = bi;
  }
  cluster.sync();                    // no CTA leaves while rank 0 reads it
}

template <typename T>
cudaError_t launch(const void* x, int* out, int B, int V, int64_t row_stride,
                   int split, int chunk, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;  // one cluster per row
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, argmax_kernel<T>, static_cast<const T*>(x), out, V, row_stride,
      chunk);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// x: [B, V] with unit stride along V and `row_stride` elements between rows;
// out: [B] int32.  Row r is split over `split` CTAs of `chunk` elements
// each (the last one shorter), every CTA non-empty; the wrapper's
// argmax_plan keeps split within the portable cluster size.
REPRO_EXPORT int argmax_rows(const void* x, void* out, int B, int V,
                             long long row_stride, int split, int chunk,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return cudaSuccess;
  if (V < 1 || B > 65535 || split < 1 || split > kMaxSplit || chunk < 1 ||
      (long long)(split - 1) * chunk >= V || (long long)split * chunk < V)
    return cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  if (dtype == kF32)
    return launch<float>(x, o, B, V, row_stride, split, chunk, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, o, B, V, row_stride, split, chunk, s);
  return cudaErrorInvalidValue;
}
