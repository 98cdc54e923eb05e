// The online softmax shared by the paged decode kernels (fp pages in
// paged_decode.cu, int8 pages in paged_decode_q8.cu).
//
// Both kernels run one block per (kv head, batch row) with one warp per
// query head of the group.  The block stages one page of K and V in shared
// memory as fp32 (K rows padded to DH+1 floats so the lanes hit distinct
// banks); then, per warp, PagedSoftmax::consume folds that page into the
// warp's running (max, denominator, accumulator): lanes split the page's
// keys for the QK^T dot products, then split the head dims for the PV
// update.  PagedSoftmax::finish folds the new token's K/V row in last and
// normalizes, dividing by max(l, 1e-20), so a row with no past token
// outputs exactly v_new.  Masked scores use the TPU kernels' finite -2e38
// and their probabilities are zeroed explicitly.
#pragma once

#include "common.cuh"

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

// shared-memory floats a block needs: K [ps][DH+1], V [ps][DH], q [G][DH]
__host__ __device__ inline size_t paged_smem_floats(int ps, int dh, int g) {
  return (size_t)ps * (dh + 1) + (size_t)ps * dh + (size_t)g * dh;
}

template <int DH>
struct PagedSoftmax {
  static constexpr int NPL = (DH + 31) / 32;   // head dims per lane (PV)
  float m, l;
  float acc[NPL];

  __device__ __forceinline__ void init() {
    m = REPRO_NEG_INF;
    l = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) acc[i] = 0.f;
  }

  // Fold one staged page into the running softmax.  ks [ps][DH+1] and
  // vs [ps][DH] hold the page's keys and values in fp32; `first` is the
  // logical position of its first token and `len` the row's past tokens,
  // so positions >= len (the partial last page) are masked.
  __device__ __forceinline__ void consume(const float* ks, const float* vs,
                                          const float* qg, int ps, int first,
                                          int len, int lane) {
    for (int c0 = 0; c0 < ps; c0 += 32) {
      const int t = c0 + lane;
      const bool ok = t < ps && first + t < len;
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

  // The new token attends itself: fold its K/V row (kn/vn at `off`, in
  // the model dtype) into the softmax, normalize, and store the warp's
  // output row.
  template <typename T>
  __device__ __forceinline__ void finish(const float* qg, const T* kn,
                                         const T* vn, int64_t off, T* orow,
                                         int lane) {
    float part = 0.f;
    float vt[NPL];
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int d = lane + 32 * i;
      vt[i] = 0.f;
      if (d < DH) {
        part += qg[d] * load_f32(kn, off + d);
        vt[i] = load_f32(vn, off + d);
      }
    }
    const float s_t = warp_sum(part);
    const float m_new = fmaxf(m, s_t);
    const float alpha = expf(m - m_new);
    const float p_t = expf(s_t - m_new);
    const float den = fmaxf(l * alpha + p_t, 1e-20f);
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int d = lane + 32 * i;
      if (d < DH) store_from_f32(orow, d, (acc[i] * alpha + p_t * vt[i]) / den);
    }
  }
};

// Launch a paged kernel template for the head dims the wrappers accept.
#define REPRO_DISPATCH_DH(Dh, LAUNCH)               \
  switch (Dh) {                                     \
    case 16: return LAUNCH(16);                     \
    case 32: return LAUNCH(32);                     \
    case 64: return LAUNCH(64);                     \
    case 128: return LAUNCH(128);                   \
    default: return cudaErrorInvalidValue;          \
  }
