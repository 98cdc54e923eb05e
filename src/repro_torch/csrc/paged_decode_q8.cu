// Paged decode attention over int8 KV pages for Hopper (sm_90a).
//
// Replaces: repro/kernels/paged_decode.py::_paged_kernel_q8 (the Pallas TPU
// kernel behind paged_decode_attention_q8_grouped).  The contract of the fp
// kernel (paged_decode.cu) over int8 codes: pages [P,ps,KVH,Dh] int8 with
// one f32 scale per (page, position) in k_scale/v_scale [P,ps], shared by
// every KV head of that token row.  Codes are dequantized in registers as
// code * scale[page, pos] right after the load; the new token's K/V stay
// in the model dtype (it is not in a page yet).  Only live pages
// j*ps < length[b] are read, the partial last page is masked with -2e38,
// the new token is folded in last and the divide clamps l at 1e-20, so
// length == 0 outputs exactly v_new.
//
// What bounds it on this card: device memory, as for the fp kernel, and at
// decode batch sizes the latency of few blocks (B*KVH = 16 blocks for 132
// SMs at the main shape).  Its design is about bytes: device memory sees
// only the int8 codes (16-byte vector loads, one token row of one head is
// Dh bytes) and one f32 scale per token, half the page bytes of bf16; the
// dequantized page is staged in shared memory in fp32 and consumed by the
// same per-warp online softmax as the fp kernel (paged_attend.cuh), one
// block per (kv head, batch row) serving all G query heads so a page is
// read once.  Accumulation is fp32; q and the output stay in the model
// dtype.  A split-K variant is later work.
#include "paged_attend.cuh"

namespace {

constexpr int kVec = 16;                   // bytes per vector load

template <typename T, int DH>
__global__ void paged_decode_q8_kernel(const T* __restrict__ q4,
                                       const int8_t* __restrict__ kp,
                                       const int8_t* __restrict__ vp,
                                       const float* __restrict__ ksc,
                                       const float* __restrict__ vsc,
                                       const int* __restrict__ pt,
                                       const int* __restrict__ lengths,
                                       const T* __restrict__ kn,
                                       const T* __restrict__ vn,
                                       T* __restrict__ out, int KVH, int G,
                                       int ps, int NP, float scale) {
  static_assert(DH % kVec == 0, "a token row must be whole 16-byte vectors");
  constexpr int VPR = DH / kVec;           // vectors per token row
  extern __shared__ float smem[];
  float* ks = smem;                        // [ps][DH + 1]
  float* vs = ks + ps * (DH + 1);          // [ps][DH]
  float* qs = vs + ps * DH;                // [G][DH], pre-scaled

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int g = tid / 32, lane = tid % 32;
  const int64_t head = (int64_t)b * KVH + h;

  for (int idx = tid; idx < G * DH; idx += nthr)
    qs[idx] = load_f32(q4, head * G * DH + idx) * scale;

  const int len = max(lengths[b], 0);
  const int n_pages = min((len + ps - 1) / ps, NP);
  const int64_t tok_stride = (int64_t)KVH * DH;
  const int64_t page_stride = (int64_t)ps * tok_stride;
  const float* qg = qs + g * DH;

  PagedSoftmax<DH> sm;
  sm.init();
  for (int j = 0; j < n_pages; ++j) {
    __syncthreads();          // q staged / the previous page consumed
    const int64_t page = pt[(int64_t)b * NP + j];
    const int64_t base = page * page_stride + (int64_t)h * DH;
    for (int idx = tid; idx < ps * VPR; idx += nthr) {
      const int t = idx / VPR, c = (idx % VPR) * kVec;
      const int64_t off = base + t * tok_stride + c;
      const int4 kraw = *reinterpret_cast<const int4*>(kp + off);
      const int4 vraw = *reinterpret_cast<const int4*>(vp + off);
      const float k_s = ksc[page * ps + t], v_s = vsc[page * ps + t];
      const unsigned w[4] = {(unsigned)kraw.x, (unsigned)kraw.y,
                             (unsigned)kraw.z, (unsigned)kraw.w};
      const unsigned x[4] = {(unsigned)vraw.x, (unsigned)vraw.y,
                             (unsigned)vraw.z, (unsigned)vraw.w};
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        // byte u of the vector (little-endian), sign-extended
        const int sh = 24 - 8 * (u % 4);
        const int kc = static_cast<int>(w[u / 4] << sh) >> 24;
        const int vc = static_cast<int>(x[u / 4] << sh) >> 24;
        ks[t * (DH + 1) + c + u] = (float)kc * k_s;
        vs[t * DH + c + u] = (float)vc * v_s;
      }
    }
    __syncthreads();
    sm.consume(ks, vs, qg, ps, j * ps, len, lane);
  }
  if (n_pages == 0) __syncthreads();        // q staged before it is read
  sm.finish(qg, kn, vn, head * DH, out + (head * G + g) * DH, lane);
}

template <typename T>
struct Launcher {
  const void* q4;
  const int8_t *kp, *vp;
  const float *ksc, *vsc;
  const int *pt, *lengths;
  const void *kn, *vn;
  void* out;
  int B, KVH, G, ps, NP;
  float scale;
  cudaStream_t stream;

  template <int DH>
  cudaError_t run() const {
    const size_t smem = sizeof(float) * paged_smem_floats(ps, DH, G);
    if (smem > 48 * 1024) return cudaErrorInvalidValue;
    dim3 grid(KVH, B);
    paged_decode_q8_kernel<T, DH><<<grid, 32 * G, smem, stream>>>(
        static_cast<const T*>(q4), kp, vp, ksc, vsc, pt, lengths,
        static_cast<const T*>(kn), static_cast<const T*>(vn),
        static_cast<T*>(out), KVH, G, ps, NP, scale);
    return cudaGetLastError();
  }

  cudaError_t dispatch(int Dh) const {
#define REPRO_LAUNCH(D) run<D>()
    REPRO_DISPATCH_DH(Dh, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  }
};

}  // namespace

// All tensors contiguous on the device, the pages 16-byte aligned;
// k_scale/v_scale [P,ps] f32; page_table [B,NP] and lengths [B] int32.
// G (query heads per kv head) must be in [1, 32].  `dtype` is the dtype of
// q4, k_new, v_new and out.
REPRO_EXPORT int paged_decode_q8_fwd(const void* q4, const void* k_pages,
                                     const void* v_pages, const void* k_scale,
                                     const void* v_scale,
                                     const void* page_table,
                                     const void* lengths, const void* k_new,
                                     const void* v_new, void* out, int B,
                                     int KVH, int G, int Dh, int ps, int NP,
                                     float scale, int dtype, void* stream) {
  if (B == 0) return cudaSuccess;
  if (G < 1 || G > 32 || ps < 1 || KVH < 1) return cudaErrorInvalidValue;
  const int8_t* kp = static_cast<const int8_t*>(k_pages);
  const int8_t* vp = static_cast<const int8_t*>(v_pages);
  const float* ksc = static_cast<const float*>(k_scale);
  const float* vsc = static_cast<const float*>(v_scale);
  const int* pt = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32) {
    const Launcher<float> l{q4, kp, vp, ksc, vsc, pt, lens, k_new, v_new,
                            out, B, KVH, G, ps, NP, scale, s};
    err = l.dispatch(Dh);
  } else if (dtype == kBF16) {
    const Launcher<__nv_bfloat16> l{q4, kp, vp, ksc, vsc, pt, lens, k_new,
                                    v_new, out, B, KVH, G, ps, NP, scale, s};
    err = l.dispatch(Dh);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
