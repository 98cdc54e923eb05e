// STREAM triad for Hopper (sm_90a): a = b + s*c over flat [N] arrays.
//
// Replaces: repro/kernels/stream_triad.py::stream_triad_kernel (the Pallas
// TPU kernel that walks [rows, 128] tiles and double-buffers HBM -> VMEM).
// The paper's case study 1 and the probe of the bandwidth map.
//
// What bounds it on this card: memory.  Two FLOPs per element against 12
// bytes moved in fp32 (6 in bf16), so the card's 3.35 TB/s of HBM, or its
// L2 when the three arrays fit there, is the limit.
//
// Its design: one CTA a tile (the wrapper's triad_plan: by default a
// tile is one 16-byte vector of each input for each of the 256 threads,
// 1024 fp32 or 2048 bf16 elements), so the grid covers the array once
// and the CTAs in flight at any moment stream one contiguous window of
// each array, neighbouring CTAs on neighbouring addresses.  Stores carry
// the streaming hint (st.global.cs, evict-first), since no byte is read
// twice.  On the card this schedule beat the alternatives it was timed
// against, in turns with torch.add: a grid of resident CTAs striding
// over the tiles, four or eight 16-byte loads of each input in flight a
// thread, and streaming loads (ld.global.cs made the loads slower).  A
// grid smaller than the tile count (one CTA over the whole array, the TPU
// kernel's "one block, no pipelining" schedule) strides: CTA i takes
// tiles i, i + grid, ...  Indices are 64-bit because the bandwidth map's
// arrays pass 2^31 bytes.  The vector path needs all three pointers
// 16-byte aligned and a tile of whole vectors (a view may start
// anywhere); otherwise the kernel takes the scalar path.  Math is fp32
// with the product and the sum rounded separately (no FMA contraction,
// so fp32 results are bit-equal to b + s * c in PyTorch); a bf16 store
// rounds once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float triad(float b, float c, float s) {
  return __fadd_rn(b, __fmul_rn(s, c));
}

template <typename T>
__device__ __forceinline__ uint4 triad_vec(uint4 rb, uint4 rc, float s) {
  constexpr int kN = 16 / sizeof(T);
  uint4 ra;
  const T* eb = reinterpret_cast<const T*>(&rb);
  const T* ec = reinterpret_cast<const T*>(&rc);
  T* ea = reinterpret_cast<T*>(&ra);
#pragma unroll
  for (int k = 0; k < kN; ++k)
    store_from_f32(ea, k, triad(load_f32(eb, k), load_f32(ec, k), s));
  return ra;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
triad_kernel(const T* __restrict__ b, const T* __restrict__ c,
             T* __restrict__ a, int64_t n, float s, int64_t tile,
             bool vector_ok) {
  constexpr int kN = 16 / sizeof(T);     // elements in a 16-byte vector
  const int64_t tiles = (n + tile - 1) / tile;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t start = t * tile;
    const int64_t end = min(start + tile, n);
    int64_t tail = start;
    if (vector_ok) {
      const int64_t nvec = (end - start) / kN;
      const uint4* bv = reinterpret_cast<const uint4*>(b + start);
      const uint4* cv = reinterpret_cast<const uint4*>(c + start);
      uint4* av = reinterpret_cast<uint4*>(a + start);
      for (int64_t v = threadIdx.x; v < nvec; v += kThreads)
        __stcs(av + v, triad_vec<T>(bv[v], cv[v], s));
      tail = start + nvec * kN;
    }
    for (int64_t i = tail + threadIdx.x; i < end; i += kThreads)
      store_from_f32(a, i, triad(load_f32(b, i), load_f32(c, i), s));
  }
}

template <typename T>
int launch(const void* b, const void* c, void* a, long long n, float s,
           int grid, long long tile, cudaStream_t st) {
  const bool vector_ok =
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
        reinterpret_cast<uintptr_t>(c)) & 15) == 0 &&
      tile % (long long)(16 / sizeof(T)) == 0;
  triad_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(a),
      n, s, tile, vector_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// b, c, a: [n] contiguous, one dtype; `grid` CTAs take the tiles of
// `tile` > 0 elements (the wrapper's triad_plan: one CTA a tile, or grid
// 1 and tile n for a single CTA).
REPRO_EXPORT int stream_triad_fwd(const void* b, const void* c, void* a,
                                  long long n, float s, int grid,
                                  long long tile, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) return cudaSuccess;
  if (n < 0 || tile < 1 || grid < 1) return cudaErrorInvalidValue;
  if (dtype == kF32) return launch<float>(b, c, a, n, s, grid, tile, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(b, c, a, n, s, grid, tile, st);
  return cudaErrorInvalidValue;
}
