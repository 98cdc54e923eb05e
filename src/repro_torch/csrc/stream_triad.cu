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
// Its design: each CTA owns `per_cta` consecutive elements (the TPU
// kernel's block of block_rows x 128) and walks them with 16-byte vector
// loads and stores, neighbouring threads on neighbouring vectors, with a
// scalar tail; indices are 64-bit because the bandwidth map's arrays pass
// 2^31 bytes.  The vector path needs all three pointers 16-byte aligned
// (a view may start anywhere); otherwise the CTA takes the scalar path.
// Math is fp32 with the product and the sum rounded separately (no FMA
// contraction, so fp32 results are bit-equal to b + s * c in PyTorch); a
// bf16 store rounds once.  One CTA over the whole array is the TPU
// kernel's "one block, no pipelining" schedule: same result, one SM.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float triad(float b, float c, float s) {
  return __fadd_rn(b, __fmul_rn(s, c));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
triad_kernel(const T* __restrict__ b, const T* __restrict__ c,
             T* __restrict__ a, int64_t n, float s, int64_t per_cta,
             bool vector_ok) {
  const int64_t start = (int64_t)blockIdx.x * per_cta;
  const int64_t end = min(start + per_cta, n);
  int64_t tail = start;
  if (vector_ok) {
    constexpr int kN = 16 / sizeof(T);   // elements in a 16-byte vector
    const int64_t nvec = (end - start) / kN;
    const uint4* bv = reinterpret_cast<const uint4*>(b + start);
    const uint4* cv = reinterpret_cast<const uint4*>(c + start);
    uint4* av = reinterpret_cast<uint4*>(a + start);
    for (int64_t v = threadIdx.x; v < nvec; v += kThreads) {
      const uint4 rb = bv[v], rc = cv[v];
      uint4 ra;
      const T* eb = reinterpret_cast<const T*>(&rb);
      const T* ec = reinterpret_cast<const T*>(&rc);
      T* ea = reinterpret_cast<T*>(&ra);
#pragma unroll
      for (int k = 0; k < kN; ++k)
        store_from_f32(ea, k, triad(load_f32(eb, k), load_f32(ec, k), s));
      av[v] = ra;
    }
    tail = start + nvec * kN;
  }
  for (int64_t i = tail + threadIdx.x; i < end; i += kThreads)
    store_from_f32(a, i, triad(load_f32(b, i), load_f32(c, i), s));
}

template <typename T>
int launch(const void* b, const void* c, void* a, long long n, float s,
           long long per_cta, cudaStream_t st) {
  const long long grid = (n + per_cta - 1) / per_cta;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vector_ok =
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
        reinterpret_cast<uintptr_t>(c)) & 15) == 0 &&
      per_cta % (long long)(16 / sizeof(T)) == 0;
  triad_kernel<T><<<(unsigned)grid, kThreads, 0, st>>>(
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(a),
      n, s, per_cta, vector_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// b, c, a: [n] contiguous, one dtype; per_cta > 0 elements per CTA
// (n for a single CTA).
REPRO_EXPORT int stream_triad_fwd(const void* b, const void* c, void* a,
                                  long long n, float s, long long per_cta,
                                  int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) return cudaSuccess;
  if (n < 0 || per_cta < 1) return cudaErrorInvalidValue;
  if (dtype == kF32) return launch<float>(b, c, a, n, s, per_cta, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(b, c, a, n, s, per_cta, st);
  return cudaErrorInvalidValue;
}
