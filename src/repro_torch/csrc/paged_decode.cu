// Paged decode attention for Hopper (sm_90a): one new token per row attends
// that row's live KV pages, then itself.
//
// Replaces: repro/kernels/paged_decode.py::_paged_kernel (the Pallas TPU
// kernel behind paged_decode_attention_grouped, fp pages).  Same contract:
// q4 [B,KVH,G,Dh], pages [P,ps,KVH,Dh], page_table [B,NP], lengths [B]
// (past tokens; the new token is not in the pages yet), k_new/v_new
// [B,KVH,Dh].  Only logical pages j with j*ps < length[b] are read, through
// page_table[b, j]; table entries past them are never dereferenced.  The
// partial last page is masked, and the new token's K/V are folded into the
// same online softmax last, so length == 0 outputs exactly v_new.  Pages
// may be stored in another dtype than q (fp32 pages under a bf16 model):
// each load is cast to fp32, as the TPU kernel casts each block.
//
// What bounds it on this card: each K/V byte is used for G dot products,
// far below the ~295 FLOP/byte ridge, so it is bound by memory (and, at
// decode batch sizes, by how few blocks there are to hide latency).  Its
// design: one block per (kv head, batch row) serving all G query heads of
// the group, so every page is read from device memory once, not G times.
// The block stages one page of K and V in shared memory; warp g owns query
// head g (PagedSoftmax in paged_attend.cuh).  The TPU's sequential
// page-block grid axis is the loop over pages; a split-K variant for long
// contexts at small batch is later work.
#include "paged_attend.cuh"

namespace {

template <typename T, typename P, int DH>
__global__ void paged_decode_kernel(const T* __restrict__ q4,
                                    const P* __restrict__ kp,
                                    const P* __restrict__ vp,
                                    const int* __restrict__ pt,
                                    const int* __restrict__ lengths,
                                    const T* __restrict__ kn,
                                    const T* __restrict__ vn,
                                    T* __restrict__ out, int KVH, int G,
                                    int ps, int NP, float scale) {
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
    const int64_t base = (int64_t)pt[(int64_t)b * NP + j] * page_stride +
                         (int64_t)h * DH;
    for (int idx = tid; idx < ps * DH; idx += nthr) {
      const int t = idx / DH, c = idx % DH;
      ks[t * (DH + 1) + c] = load_f32(kp, base + t * tok_stride + c);
      vs[t * DH + c] = load_f32(vp, base + t * tok_stride + c);
    }
    __syncthreads();
    sm.consume(ks, vs, qg, ps, j * ps, len, lane);
  }
  if (n_pages == 0) __syncthreads();        // q staged before it is read
  sm.finish(qg, kn, vn, head * DH, out + (head * G + g) * DH, lane);
}

template <typename T, typename P>
struct Launcher {
  const void *q4, *kp, *vp;
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
    paged_decode_kernel<T, P, DH><<<grid, 32 * G, smem, stream>>>(
        static_cast<const T*>(q4), static_cast<const P*>(kp),
        static_cast<const P*>(vp), pt, lengths, static_cast<const T*>(kn),
        static_cast<const T*>(vn), static_cast<T*>(out), KVH, G, ps, NP,
        scale);
    return cudaGetLastError();
  }

  cudaError_t dispatch(int Dh) const {
#define REPRO_LAUNCH(D) run<D>()
    REPRO_DISPATCH_DH(Dh, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  }
};

template <typename T, typename P>
cudaError_t dispatch_dh(int Dh, const void* q4, const void* kp,
                        const void* vp, const int* pt, const int* lengths,
                        const void* kn, const void* vn, void* out, int B,
                        int KVH, int G, int ps, int NP, float scale,
                        cudaStream_t stream) {
  const Launcher<T, P> l{q4, kp, vp, pt, lengths, kn, vn, out,
                         B, KVH, G, ps, NP, scale, stream};
  return l.dispatch(Dh);
}

template <typename T>
cudaError_t dispatch_pages(int page_dtype, int Dh, const void* q4,
                           const void* kp, const void* vp, const int* pt,
                           const int* lengths, const void* kn,
                           const void* vn, void* out, int B, int KVH, int G,
                           int ps, int NP, float scale, cudaStream_t stream) {
  if (page_dtype == kF32)
    return dispatch_dh<T, float>(Dh, q4, kp, vp, pt, lengths, kn, vn, out,
                                 B, KVH, G, ps, NP, scale, stream);
  if (page_dtype == kBF16)
    return dispatch_dh<T, __nv_bfloat16>(Dh, q4, kp, vp, pt, lengths, kn, vn,
                                         out, B, KVH, G, ps, NP, scale,
                                         stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// All tensors contiguous on the device; page_table [B,NP] and lengths [B]
// int32.  G (query heads per kv head) must be in [1, 32].  `dtype` is the
// dtype of q4, k_new, v_new and out; `page_dtype` that of the pages.
REPRO_EXPORT int paged_decode_fwd(const void* q4, const void* k_pages,
                                  const void* v_pages, const void* page_table,
                                  const void* lengths, const void* k_new,
                                  const void* v_new, void* out, int B,
                                  int KVH, int G, int Dh, int ps, int NP,
                                  float scale, int dtype, int page_dtype,
                                  void* stream) {
  const int* pt = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return cudaSuccess;
  if (G < 1 || G > 32 || ps < 1 || KVH < 1) return cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == kF32)
    err = dispatch_pages<float>(page_dtype, Dh, q4, k_pages, v_pages, pt,
                                lens, k_new, v_new, out, B, KVH, G, ps, NP,
                                scale, s);
  else if (dtype == kBF16)
    err = dispatch_pages<__nv_bfloat16>(page_dtype, Dh, q4, k_pages, v_pages,
                                        pt, lens, k_new, v_new, out, B, KVH,
                                        G, ps, NP, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
