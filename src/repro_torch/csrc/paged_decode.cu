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
// same online softmax last, so length == 0 outputs exactly v_new.
//
// What bounds it on this card: each K/V byte is used for G dot products,
// far below the ~295 FLOP/byte ridge, so it is bound by memory (and, at
// decode batch sizes, by how few blocks there are to hide latency).  Its
// design: one block per (kv head, batch row) serving all G query heads of
// the group, so every page is read from device memory once, not G times.
// The block stages one page of K and V in shared memory; warp g owns query
// head g: lanes split the page's keys for the QK^T dot products (K rows
// padded to Dh+1 floats so the lanes hit distinct banks), then split the
// head dims for the PV update.  The TPU's sequential page-block grid axis
// is the loop over pages; a split-K variant for long contexts at small
// batch is later work.
#include "common.cuh"

namespace {

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int DH>
__global__ void paged_decode_kernel(const T* __restrict__ q4,
                                    const T* __restrict__ kp,
                                    const T* __restrict__ vp,
                                    const int* __restrict__ pt,
                                    const int* __restrict__ lengths,
                                    const T* __restrict__ kn,
                                    const T* __restrict__ vn,
                                    T* __restrict__ out, int KVH, int G,
                                    int ps, int NP, float scale) {
  constexpr int NPL = (DH + 31) / 32;      // head dims per lane (PV part)
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

  float m = REPRO_NEG_INF, l = 0.f;
  float acc[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) acc[i] = 0.f;

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
    for (int c0 = 0; c0 < ps; c0 += 32) {
      const int t = c0 + lane;
      const bool ok = t < ps && j * ps + t < len;   // partial last page
      float s = REPRO_NEG_INF;
      if (ok) {
        float d = 0.f;
#pragma unroll 8
        for (int e = 0; e < DH; ++e) d += qg[e] * ks[t * (DH + 1) + e];
        s = d;
      }
      const float m_new = fmaxf(m, warp_max(s));
      const float alpha = expf(m - m_new);
      const float p = ok ? expf(s - m_new) : 0.f;
      l = l * alpha + warp_sum(p);
      const int cnt = min(32, ps - c0);
#pragma unroll
      for (int i = 0; i < NPL; ++i) acc[i] *= alpha;
      for (int u = 0; u < cnt; ++u) {
        const float pu = __shfl_sync(0xffffffffu, p, u);
#pragma unroll
        for (int i = 0; i < NPL; ++i) {
          const int d = lane + 32 * i;
          if (d < DH) acc[i] += pu * vs[(c0 + u) * DH + d];
        }
      }
      m = m_new;
    }
  }
  if (n_pages == 0) __syncthreads();        // q staged before it is read

  // the new token attends itself: fold its K/V row in, then normalize
  float part = 0.f;
  float vt[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int d = lane + 32 * i;
    vt[i] = 0.f;
    if (d < DH) {
      part += qg[d] * load_f32(kn, head * DH + d);
      vt[i] = load_f32(vn, head * DH + d);
    }
  }
  const float s_t = warp_sum(part);
  const float m_new = fmaxf(m, s_t);
  const float alpha = expf(m - m_new);
  const float p_t = expf(s_t - m_new);
  const float den = fmaxf(l * alpha + p_t, 1e-20f);
  T* orow = out + (head * G + g) * DH;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int d = lane + 32 * i;
    if (d < DH) store_from_f32(orow, d, (acc[i] * alpha + p_t * vt[i]) / den);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q4, const void* kp, const void* vp,
                   const int* pt, const int* lengths, const void* kn,
                   const void* vn, void* out, int B, int KVH, int G, int ps,
                   int NP, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)ps * (DH + 1) +
                                       (size_t)ps * DH + (size_t)G * DH);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  dim3 grid(KVH, B);
  paged_decode_kernel<T, DH><<<grid, 32 * G, smem, stream>>>(
      static_cast<const T*>(q4), static_cast<const T*>(kp),
      static_cast<const T*>(vp), pt, lengths, static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<T*>(out), KVH, G, ps, NP,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int Dh, const void* q4, const void* kp,
                        const void* vp, const int* pt, const int* lengths,
                        const void* kn, const void* vn, void* out, int B,
                        int KVH, int G, int ps, int NP, float scale,
                        cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch<T, 16>(q4, kp, vp, pt, lengths, kn, vn, out, B,
                                  KVH, G, ps, NP, scale, stream);
    case 32: return launch<T, 32>(q4, kp, vp, pt, lengths, kn, vn, out, B,
                                  KVH, G, ps, NP, scale, stream);
    case 64: return launch<T, 64>(q4, kp, vp, pt, lengths, kn, vn, out, B,
                                  KVH, G, ps, NP, scale, stream);
    case 128: return launch<T, 128>(q4, kp, vp, pt, lengths, kn, vn, out, B,
                                    KVH, G, ps, NP, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// All tensors contiguous on the device; page_table [B,NP] and lengths [B]
// int32.  G (query heads per kv head) must be in [1, 32].
REPRO_EXPORT int paged_decode_fwd(const void* q4, const void* k_pages,
                                  const void* v_pages, const void* page_table,
                                  const void* lengths, const void* k_new,
                                  const void* v_new, void* out, int B,
                                  int KVH, int G, int Dh, int ps, int NP,
                                  float scale, int dtype, void* stream) {
  const int* pt = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return cudaSuccess;
  if (G < 1 || G > 32 || ps < 1 || KVH < 1) return cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == kF32)
    err = dispatch_dh<float>(Dh, q4, k_pages, v_pages, pt, lens, k_new,
                             v_new, out, B, KVH, G, ps, NP, scale, s);
  else if (dtype == kBF16)
    err = dispatch_dh<__nv_bfloat16>(Dh, q4, k_pages, v_pages, pt, lens,
                                     k_new, v_new, out, B, KVH, G, ps, NP,
                                     scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
