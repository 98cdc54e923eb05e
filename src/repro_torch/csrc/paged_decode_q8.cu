// Paged decode attention over int8 KV pages for Hopper (sm_90a).
//
// Replaces: repro/kernels/paged_decode.py::_paged_kernel_q8 (the Pallas TPU
// kernel behind paged_decode_attention_q8_grouped).  The contract of the fp
// kernel (paged_decode.cu) over int8 codes: pages [P,ps,KVH,Dh] int8 with
// one f32 scale per (page, position) in k_scale/v_scale [P,ps], shared by
// every KV head of that token row.  Codes are dequantized in registers as
// code * scale[page, pos] at the dot product and at the PV update; the new
// token's K/V stay in the model dtype (it is not in a page yet).  Only
// live pages j*ps < length[b] are read, the partial last page is masked
// with -2e38, the new token is folded in last and the divide clamps l at
// 1e-20, so length == 0 outputs exactly v_new.
//
// What bounds it on this card: at decode batch sizes, latency.  The bytes
// are few (int8 codes, 264 B a token at Dh 64 with its two scales: 0.47
// MB, 0.15 us at 3.35 TB/s, at the main shape), so the time is the chain
// of dependent steps a block walks: a grid of one block per (kv head,
// batch row), 16 blocks for 132 SMs, walking up to 33 pages one at a time
// with no load in flight while a page is consumed, was ~480x its byte
// bound.  Its design (paged_split.cuh): flash-decoding over a thread block
// cluster.  The grid is (S, KVH, B), a cluster of S <= 8 CTAs along x per
// (kv head, batch row), S chosen by the wrapper from shapes only (128 CTAs
// at the main shape); CTA r takes its share of the row's live pages,
// computed on the device from lengths[b].  A CTA keeps a ring of kStages
// pages of int8 codes and their scales in shared memory, filled by
// cp.async (16 bytes a copy; a token row of one head is Dh bytes at a
// stride of KVH*Dh) while earlier pages are consumed, so up to kStages - 1
// pages are in flight behind the one being read.  One warp per query head
// of the group; its lanes split a key's head dims in 16-dim slices, so a
// page of 16 keys at Dh 64 keeps all 32 lanes busy.  The cluster's
// partials merge in rank 0 through distributed shared memory: one launch,
// no global scratch, no second pass.  Accumulation is fp32; q and the
// output stay in the model dtype.
#include "paged_split.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStages = split::kStages;
constexpr int kVec = 16;                 // bytes a cp.async

// bytes of one ring slot: K and V codes [ps][DH] each, then the two
// [ps] f32 scales, rounded up to 16 bytes (the wrapper's twin:
// paged_decode.py::q8_smem_bytes)
__host__ __device__ inline int slot_bytes(int ps, int dh) {
  return 2 * ps * dh + (8 * ps + 15) / 16 * 16;
}

__host__ __device__ inline size_t smem_bytes(int ps, int dh, int g) {
  return (size_t)kStages * slot_bytes(ps, dh) + sizeof(float) * g * (dh + 2);
}

template <typename T, int DH>
__global__ void __launch_bounds__(1024)
paged_decode_q8_kernel(const T* __restrict__ q4,
                       const int8_t* __restrict__ kp,
                       const int8_t* __restrict__ vp,
                       const float* __restrict__ ksc,
                       const float* __restrict__ vsc,
                       const int* __restrict__ pt,
                       const int* __restrict__ lengths,
                       const T* __restrict__ kn, const T* __restrict__ vn,
                       T* __restrict__ out, int KVH, int G, int ps, int NP,
                       float scale) {
  using L = split::Lanes<DH>;
  constexpr int S16 = split::kSlice;
  constexpr int VPR = DH / kVec;         // 16-byte copies per token row
  extern __shared__ __align__(16) unsigned char smem[];
  const int slot = slot_bytes(ps, DH);
  float* part_base = reinterpret_cast<float*>(smem + kStages * slot);
  const split::Partial part{part_base + G * DH, part_base + G * DH + G,
                            part_base};   // m [G], l [G], acc [G][DH]

  cg::cluster_group cluster = cg::this_cluster();
  const int S = gridDim.x;               // the cluster spans x
  const int rank = blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int g = tid / 32, lane = tid % 32;
  const int ds = lane % L::LPK;
  const int64_t head = (int64_t)b * KVH + h;

  float q[S16];                          // this lane's slice, pre-scaled
  {
    const T* qrow = q4 + (head * G + g) * DH + ds * S16;
#pragma unroll
    for (int k = 0; k < S16; ++k) q[k] = load_f32(qrow, k) * scale;
  }

  const int len = max(lengths[b], 0);
  const int n_pages = min((len + ps - 1) / ps, NP);
  int j0, j1;
  split::page_range(rank, S, n_pages, j0, j1);
  const int64_t tok_stride = (int64_t)KVH * DH;
  const int64_t page_stride = (int64_t)ps * tok_stride;
  const int* row_pt = pt + (int64_t)b * NP;

  // every thread copies its share of page j into ring slot `dst`
  auto fetch = [&](int j, unsigned char* dst) {
    const int64_t page = row_pt[j];
    const int8_t* kb = kp + page * page_stride + (int64_t)h * DH;
    const int8_t* vb = vp + page * page_stride + (int64_t)h * DH;
    for (int idx = tid; idx < ps * VPR; idx += nthr) {
      const int t = idx / VPR, c = (idx % VPR) * kVec;
      cp_async16(smem_u32(dst + t * DH + c), kb + t * tok_stride + c, kVec);
      cp_async16(smem_u32(dst + (ps + t) * DH + c), vb + t * tok_stride + c,
                 kVec);
    }
    float* sc = reinterpret_cast<float*>(dst + 2 * ps * DH);
    for (int idx = tid; idx < 2 * ps; idx += nthr)
      cp_async4(sc + idx, idx < ps ? ksc + page * ps + idx
                                   : vsc + page * ps + (idx - ps));
  };
  // this lane's slice of key t: int8 codes as floats, and their scales
  auto row = [&](const unsigned char* src, int t, float& d,
                 float (&v)[S16], float& k_s, float& v_s) {
    const int8_t* kc = reinterpret_cast<const int8_t*>(src);
    const int8_t* vc = kc + ps * DH;
    const float* scales = reinterpret_cast<const float*>(src + 2 * ps * DH);
    const int4 kraw = *reinterpret_cast<const int4*>(kc + t * DH + ds * S16);
    const int4 vraw = *reinterpret_cast<const int4*>(vc + t * DH + ds * S16);
    const int8_t* ke = reinterpret_cast<const int8_t*>(&kraw);
    const int8_t* ve = reinterpret_cast<const int8_t*>(&vraw);
#pragma unroll
    for (int k = 0; k < S16; ++k) {
      d += q[k] * (float)ke[k];
      v[k] = (float)ve[k];
    }
    k_s = scales[t];
    v_s = scales[ps + t];
  };

  split::Softmax<DH> sm;
  sm.init();
  split::walk_pages<DH, kStages>(sm, smem, slot, j0, j1, ps, len, lane,
                                 fetch, row);
  sm.store(part, g, lane);
  cluster.sync();                        // every CTA's partial is written
  if (rank == 0)
    split::combine_and_finish<DH>(cluster, part, S, g, lane, q, kn, vn,
                                  head * DH, out + (head * G + g) * DH);
  cluster.sync();                        // no CTA leaves while rank 0 reads
}

template <typename T>
struct Launcher {
  const void* q4;
  const int8_t *kp, *vp;
  const float *ksc, *vsc;
  const int *pt, *lengths;
  const void *kn, *vn;
  void* out;
  int B, KVH, G, ps, NP, n_split;
  float scale;
  cudaStream_t stream;

  template <int DH>
  cudaError_t run() const {
    const size_t smem = smem_bytes(ps, DH, G);
    if (smem > 48 * 1024) return cudaErrorInvalidValue;
    return split::launch_split(
        paged_decode_q8_kernel<T, DH>, n_split, KVH, B, G, smem, stream,
        static_cast<const T*>(q4), kp, vp, ksc, vsc, pt, lengths,
        static_cast<const T*>(kn), static_cast<const T*>(vn),
        static_cast<T*>(out), KVH, G, ps, NP, scale);
  }

};

}  // namespace

// All tensors contiguous on the device, the pages 16-byte aligned;
// k_scale/v_scale [P,ps] f32; page_table [B,NP] and lengths [B] int32.
// G (query heads per kv head) must be in [1, 32]; `n_split` CTAs a row,
// in [1, 8] (the wrapper's q8_split_plan).  `dtype` is the dtype of q4,
// k_new, v_new and out.
REPRO_EXPORT int paged_decode_q8_fwd(const void* q4, const void* k_pages,
                                     const void* v_pages, const void* k_scale,
                                     const void* v_scale,
                                     const void* page_table,
                                     const void* lengths, const void* k_new,
                                     const void* v_new, void* out, int B,
                                     int KVH, int G, int Dh, int ps, int NP,
                                     int n_split, float scale, int dtype,
                                     void* stream) {
  if (B == 0) return cudaSuccess;
  if (G < 1 || G > 32 || ps < 1 || KVH < 1 || NP < 0 || B > 65535 ||
      KVH > 65535 || n_split < 1 || n_split > split::kMaxSplit)
    return cudaErrorInvalidValue;
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
                            out, B, KVH, G, ps, NP, n_split, scale, s};
    err = split::dispatch_dh(Dh, l);
  } else if (dtype == kBF16) {
    const Launcher<__nv_bfloat16> l{q4, kp, vp, ksc, vsc, pt, lens, k_new,
                                    v_new, out, B, KVH, G, ps, NP, n_split,
                                    scale, s};
    err = split::dispatch_dh(Dh, l);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
