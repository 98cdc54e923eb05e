// Paged decode attention for Hopper (sm_90a): one new token per row attends
// that row's live KV pages, then itself.
//
// Replaces: repro/kernels/paged_decode.py::_paged_kernel (the Pallas TPU
// kernel behind paged_decode_attention_grouped, fp pages).  Same contract:
// q4 [B,KVH,G,Dh], pages [P,ps,KVH,Dh], page_table [B,NP], lengths [B]
// (past tokens; the new token is not in the pages yet), k_new/v_new
// [B,KVH,Dh].  Only logical pages j with j*ps < length[b] are read, through
// page_table[b, j]; table entries past them are never dereferenced.  The
// partial last page is masked with -2e38, the new token's K/V are folded
// in last and the divide clamps l at 1e-20, so length == 0 outputs exactly
// v_new.  Pages may be stored in another dtype than q (fp32 pages under a
// bf16 model): each element is cast to fp32 as it is read, as the TPU
// kernel casts each block.
//
// What bounds it on this card: at decode batch sizes, latency.  Each K/V
// byte is used for G dot products, far below the ~295 FLOP/byte ridge, and
// the bytes are few (bf16 pages at Dh 64: 0.94 MB, 0.28 us at 3.35 TB/s,
// at the main shape), so the time is the chain of dependent steps a block
// walks: one block per (kv head, batch row), 16 blocks for 132 SMs, each
// walking up to 34 pages one at a time through fp32 shared memory with no
// load in flight, was ~430x its byte bound.  Its design is the
// int8 kernel's (paged_split.cuh): flash-decoding over a thread block
// cluster.  The grid is (S, KVH, B), a cluster of S <= 8 CTAs along x per
// (kv head, batch row), S chosen by the wrapper from shapes only (128 CTAs
// at the main shape); CTA r takes its share of the row's live pages,
// computed on the device from lengths[b].  A CTA keeps a ring of kStages
// pages of K and V rows in the pages' own dtype in shared memory, filled
// by cp.async (16 bytes a copy; a token row of one head is Dh elements at
// a stride of KVH*Dh) while earlier pages are consumed.  One warp per query
// head of the group; its lanes split a key's head dims in 16-dim slices
// (32 bytes of bf16 or 64 of fp32 a lane), converted to fp32 as they are
// read.  The cluster's partials merge in rank 0 through distributed shared
// memory, the new token folded in last.  Accumulation is fp32; q and the
// output stay in the model dtype.  Shared memory above 48 KB (fp32 pages
// at Dh 128) takes the opt-in.
#include "paged_split.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStages = split::kStages;

// bytes of one ring slot: the K and V rows [ps][DH] of one head in the
// pages' dtype (the wrapper's twin: paged_decode.py::fp_smem_bytes)
template <typename P>
__host__ __device__ inline size_t slot_bytes(int ps, int dh) {
  return 2 * (size_t)ps * dh * sizeof(P);
}

template <typename P>
inline size_t smem_bytes(int ps, int dh, int g) {
  return kStages * slot_bytes<P>(ps, dh) + sizeof(float) * g * (dh + 2);
}

// 16 consecutive page elements in shared memory, as floats
__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
  const float4* s = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 a = s[i];
    v[4 * i] = a.x;
    v[4 * i + 1] = a.y;
    v[4 * i + 2] = a.z;
    v[4 * i + 3] = a.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[16]) {
  const uint4* s = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 a = s[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[8 * i + 2 * k] = __bfloat162float(h[k].x);
      v[8 * i + 2 * k + 1] = __bfloat162float(h[k].y);
    }
  }
}

template <typename T, typename P, int DH>
__global__ void __launch_bounds__(1024)
paged_decode_kernel(const T* __restrict__ q4, const P* __restrict__ kp,
                    const P* __restrict__ vp, const int* __restrict__ pt,
                    const int* __restrict__ lengths,
                    const T* __restrict__ kn, const T* __restrict__ vn,
                    T* __restrict__ out, int KVH, int G, int ps, int NP,
                    float scale) {
  using L = split::Lanes<DH>;
  constexpr int S16 = split::kSlice;
  constexpr int EPV = 16 / (int)sizeof(P);   // elements a 16-byte copy
  constexpr int VPR = DH / EPV;              // copies a token row
  extern __shared__ __align__(16) unsigned char smem[];
  const int slot = (int)slot_bytes<P>(ps, DH);
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

  // every thread copies its share of page j's K and V rows into `dst`
  auto fetch = [&](int j, unsigned char* dst) {
    const int64_t page = row_pt[j];
    const P* kb = kp + page * page_stride + (int64_t)h * DH;
    const P* vb = vp + page * page_stride + (int64_t)h * DH;
    P* ks = reinterpret_cast<P*>(dst);
    P* vs = ks + ps * DH;
    for (int idx = tid; idx < ps * VPR; idx += nthr) {
      const int t = idx / VPR, c = (idx % VPR) * EPV;
      cp_async16(smem_u32(ks + t * DH + c), kb + t * tok_stride + c, 16);
      cp_async16(smem_u32(vs + t * DH + c), vb + t * tok_stride + c, 16);
    }
  };
  // this lane's slice of key t, as floats; fp pages carry no scales
  auto row = [&](const unsigned char* src, int t, float& d,
                 float (&v)[S16], float& k_s, float& v_s) {
    const P* kr = reinterpret_cast<const P*>(src) + t * DH + ds * S16;
    float k[S16];
    load16(kr, k);
    load16(kr + ps * DH, v);
#pragma unroll
    for (int e = 0; e < S16; ++e) d += q[e] * k[e];
    k_s = 1.f;
    v_s = 1.f;
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

template <typename T, typename P>
struct Launcher {
  const void *q4, *kp, *vp;
  const int *pt, *lengths;
  const void *kn, *vn;
  void* out;
  int B, KVH, G, ps, NP, n_split;
  float scale;
  cudaStream_t stream;

  template <int DH>
  cudaError_t run() const {
    const size_t smem = smem_bytes<P>(ps, DH, G);
    if (smem > (size_t)kMaxSmemOptIn) return cudaErrorInvalidValue;
    static SmemOptIn opt_in;
    if (smem > 48 * 1024) {
      const cudaError_t e = opt_in(paged_decode_kernel<T, P, DH>);
      if (e != cudaSuccess) return e;
    }
    return split::launch_split(
        paged_decode_kernel<T, P, DH>, n_split, KVH, B, G, smem, stream,
        static_cast<const T*>(q4), static_cast<const P*>(kp),
        static_cast<const P*>(vp), pt, lengths, static_cast<const T*>(kn),
        static_cast<const T*>(vn), static_cast<T*>(out), KVH, G, ps, NP,
        scale);
  }

};

template <typename T>
cudaError_t dispatch_pages(int page_dtype, int Dh, const void* q4,
                           const void* kp, const void* vp, const int* pt,
                           const int* lengths, const void* kn,
                           const void* vn, void* out, int B, int KVH, int G,
                           int ps, int NP, int n_split, float scale,
                           cudaStream_t stream) {
  if (page_dtype == kF32) {
    const Launcher<T, float> l{q4, kp, vp, pt, lengths, kn, vn, out, B,
                               KVH, G, ps, NP, n_split, scale, stream};
    return split::dispatch_dh(Dh, l);
  }
  if (page_dtype == kBF16) {
    const Launcher<T, __nv_bfloat16> l{q4, kp, vp, pt, lengths, kn, vn,
                                       out, B, KVH, G, ps, NP, n_split,
                                       scale, stream};
    return split::dispatch_dh(Dh, l);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// All tensors contiguous on the device, the pages 16-byte aligned;
// page_table [B,NP] and lengths [B] int32.  G (query heads per kv head)
// must be in [1, 32]; `n_split` CTAs a row, in [1, 8] (the wrapper's
// split_plan).  `dtype` is the dtype of q4, k_new, v_new and out;
// `page_dtype` that of the pages.
REPRO_EXPORT int paged_decode_fwd(const void* q4, const void* k_pages,
                                  const void* v_pages, const void* page_table,
                                  const void* lengths, const void* k_new,
                                  const void* v_new, void* out, int B,
                                  int KVH, int G, int Dh, int ps, int NP,
                                  int n_split, float scale, int dtype,
                                  int page_dtype, void* stream) {
  if (B == 0) return cudaSuccess;
  if (G < 1 || G > 32 || ps < 1 || KVH < 1 || NP < 0 || B > 65535 ||
      KVH > 65535 || n_split < 1 || n_split > split::kMaxSplit)
    return cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32)
    err = dispatch_pages<float>(page_dtype, Dh, q4, k_pages, v_pages, pt,
                                lens, k_new, v_new, out, B, KVH, G, ps, NP,
                                n_split, scale, s);
  else if (dtype == kBF16)
    err = dispatch_pages<__nv_bfloat16>(page_dtype, Dh, q4, k_pages, v_pages,
                                        pt, lens, k_new, v_new, out, B, KVH,
                                        G, ps, NP, n_split, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
