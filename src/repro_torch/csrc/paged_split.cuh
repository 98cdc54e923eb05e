// Split-K (flash-decoding) paged decode over a thread block cluster: the
// page split, the lane layout, the page loop through a cp.async ring, the
// per-warp online softmax over 16-dim slices, the combine of the
// cluster's partials and the cluster launch, shared by the fp kernel
// (paged_decode.cu) and the int8 kernel (paged_decode_q8.cu), which differ
// only in how a page is copied and how a lane reads its slice of a key.
//
// A row's (kv head, batch row) is served by a cluster of S CTAs along x.
// CTA r takes the live pages [r * n / S, (r + 1) * n / S) of the row's n
// (computed on the device from lengths[b], so the host never reads it)
// and keeps, per query head, a running (m, l, acc[Dh]); a CTA with no
// page keeps the neutral (-2e38, 0, 0).  Inside a warp (one query head)
// lane = kg * LPK + ds: the lanes of key group kg each hold 16 head dims
// (slice ds) of q, of one key's K row and of the accumulator, so a pass
// covers KPP = 32 / LPK keys: the QK^T dot reduces over the LPK lanes of
// a key (shuffle), the max over the key groups; each lane keeps its own l
// and acc for its keys, and the key groups are summed once at the end.
// The XOR shuffles need LPK to be a power of two: LPK is Dh / 16 rounded
// up to one (1, 2, 4, 8 at Dh 16, 32, 64, 128; 8 at Dh 80, whose 5 slices
// leave lanes ds = 5..7 of each group idle: they hold zeros, read no
// shared memory and store nothing), so KPP = 4 keys a pass at Dh 80.  After
// cluster.sync() rank 0 reads every CTA's (m, l, acc) through distributed
// shared memory and merges them (m = max m_i, l = sum l_i e^(m_i - m),
// acc = sum acc_i e^(m_i - m)), folds in the new token last and divides
// by max(l, 1e-20), so a row with no past token outputs exactly v_new.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "tensor_core.cuh"

namespace split {

namespace cg = cooperative_groups;

constexpr int kSlice = 16;        // head dims a lane holds
constexpr int kMaxSplit = 8;      // the portable cluster size
constexpr int kStages = 4;        // pages in each CTA's shared-memory ring

template <int DH>
struct Lanes {
  static_assert(DH % kSlice == 0 && DH / kSlice <= 32, "16-dim slices");
  static constexpr int SLICES = DH / kSlice;   // lanes of a key with dims
  static constexpr int LPK = SLICES <= 1 ? 1 : SLICES <= 2 ? 2
                           : SLICES <= 4 ? 4 : SLICES <= 8 ? 8
                           : SLICES <= 16 ? 16 : 32;   // lanes a key
  static constexpr int KPP = 32 / LPK;         // keys a pass
  // whether lane slice ds holds head dims (a lane past them is idle)
  __host__ __device__ static constexpr bool live(int ds) {
    return ds < SLICES;
  }
};

// the pages [j0, j1) of n that CTA `rank` of `S` takes
__device__ __forceinline__ void page_range(int rank, int S, int n, int& j0,
                                           int& j1) {
  j0 = (int)((long long)rank * n / S);
  j1 = (int)((long long)(rank + 1) * n / S);
}

// sum over the lanes whose index differs in the bits [from, to)
template <int FROM, int TO>
__device__ __forceinline__ float xor_sum(float x) {
#pragma unroll
  for (int off = FROM; off < TO; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int FROM, int TO>
__device__ __forceinline__ float xor_max(float x) {
#pragma unroll
  for (int off = FROM; off < TO; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// one CTA's partial for one query head, in its shared memory
struct Partial {
  float* m;      // [G]
  float* l;      // [G]
  float* acc;    // [G][DH]
};

template <int DH>
struct Softmax {
  using L = Lanes<DH>;
  float m, l;
  float acc[kSlice];

  __device__ __forceinline__ void init() {
    m = REPRO_NEG_INF;
    l = 0.f;
#pragma unroll
    for (int i = 0; i < kSlice; ++i) acc[i] = 0.f;
  }

  // Fold one pass: this lane's key has score `s` (a real key only if
  // `ok`; the warp's max runs over every key group) and value slice
  // v_scale * v[0..16) (v: the codes as floats, v_scale: their scale).
  __device__ __forceinline__ void fold(float s, bool ok,
                                       const float (&v)[kSlice],
                                       float v_scale) {
    const float m_new = fmaxf(m, xor_max<L::LPK, 32>(s));
    const float alpha = expf(m - m_new);
    const float p = ok ? expf(s - m_new) : 0.f;
    l = l * alpha + p;
    const float pv = p * v_scale;
#pragma unroll
    for (int i = 0; i < kSlice; ++i) acc[i] = acc[i] * alpha + pv * v[i];
    m = m_new;
  }

  // sum the key groups' l and acc (every lane of a dims slice then holds
  // the CTA's partial for its 16 dims) and store it
  __device__ __forceinline__ void store(const Partial& part, int g,
                                        int lane) {
    l = xor_sum<L::LPK, 32>(l);
#pragma unroll
    for (int i = 0; i < kSlice; ++i) acc[i] = xor_sum<L::LPK, 32>(acc[i]);
    if (lane < L::SLICES) {
      float4* dst =
          reinterpret_cast<float4*>(part.acc + g * DH + lane * kSlice);
#pragma unroll
      for (int i = 0; i < kSlice / 4; ++i)
        dst[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                             acc[4 * i + 3]);
    }
    if (lane == 0) {
      part.m[g] = m;
      part.l[g] = l;
    }
  }
};

// Rank 0 of the cluster, warp g: merge the S partials of query head g,
// fold in the new token (kn/vn rows at `off`, model dtype; q holds this
// lane's pre-scaled slice) and store the output row.  Key group kg of
// the lanes takes the ranks kg, kg + KPP, ...
template <int DH, typename T>
__device__ __forceinline__ void combine_and_finish(
    cg::cluster_group& cluster, const Partial& part, int S, int g, int lane,
    const float (&q)[kSlice], const T* kn, const T* vn, int64_t off,
    T* orow) {
  using L = Lanes<DH>;
  const int kg = lane / L::LPK, ds = lane % L::LPK;
  float m = REPRO_NEG_INF;
  for (int i = 0; i < S; ++i)
    m = fmaxf(m, *cluster.map_shared_rank(part.m + g, i));
  float l = 0.f, acc[kSlice];
#pragma unroll
  for (int k = 0; k < kSlice; ++k) acc[k] = 0.f;
  const bool live = L::live(ds);
  for (int i = kg; i < S; i += L::KPP) {
    const float w = expf(*cluster.map_shared_rank(part.m + g, i) - m);
    l += *cluster.map_shared_rank(part.l + g, i) * w;
    if (!live) continue;                 // an idle slice has no partial
    const float4* src = reinterpret_cast<const float4*>(
        cluster.map_shared_rank(part.acc + g * DH + ds * kSlice, i));
#pragma unroll
    for (int k = 0; k < kSlice / 4; ++k) {
      const float4 a = src[k];
      acc[4 * k] += a.x * w;
      acc[4 * k + 1] += a.y * w;
      acc[4 * k + 2] += a.z * w;
      acc[4 * k + 3] += a.w * w;
    }
  }
  l = xor_sum<L::LPK, 32>(l);
#pragma unroll
  for (int k = 0; k < kSlice; ++k) acc[k] = xor_sum<L::LPK, 32>(acc[k]);
  // the new token attends itself, last
  float part_s = 0.f;
  if (live) {
#pragma unroll
    for (int k = 0; k < kSlice; ++k)
      part_s += q[k] * load_f32(kn, off + ds * kSlice + k);
  }
  const float s_t = xor_sum<1, L::LPK>(part_s);
  const float m_new = fmaxf(m, s_t);
  const float alpha = expf(m - m_new);
  const float p_t = expf(s_t - m_new);
  const float den = fmaxf(l * alpha + p_t, 1e-20f);
  if (kg == 0 && live) {
#pragma unroll
    for (int k = 0; k < kSlice; ++k) {
      const int d = ds * kSlice + k;
      store_from_f32(orow, d,
                     (acc[k] * alpha + p_t * load_f32(vn, off + d)) / den);
    }
  }
}

// The page loop: this CTA's pages [j0, j1) pass through a ring of STAGES
// slots of `slot` bytes at `ring`, up to STAGES - 1 pages in flight behind
// the one being read.  fetch(j, dst) issues the cp.async copies of page j
// into dst (every thread its share); row(src, t, d, v, ks, vs) gives this
// lane's 16-dim slice of key t of the page at src: d = q . k over the
// slice, v the value slice, ks and vs the key's and value's scales.  An
// idle slice (Lanes::live false) never calls row: d and v stay 0, and
// the key's scales come from a live lane of its group by a shuffle.
// Positions j * ps + t >= len (the partial last page) are masked.
template <int DH, int STAGES, typename Fetch, typename Row>
__device__ __forceinline__ void walk_pages(Softmax<DH>& sm,
                                           unsigned char* ring, int slot,
                                           int j0, int j1, int ps, int len,
                                           int lane, Fetch fetch, Row row) {
  using L = Lanes<DH>;
  const int kg = lane / L::LPK;
  const bool live = L::live(lane % L::LPK);
  for (int i = 0; i < STAGES - 1; ++i) {
    if (j0 + i < j1) fetch(j0 + i, ring + ((j0 + i) % STAGES) * slot);
    cp_async_commit();
  }
  for (int j = j0; j < j1; ++j) {
    cp_async_wait<STAGES - 2>();         // page j has landed
    __syncthreads();                     // ... for every thread; page j-1
                                         // is consumed by every warp
    const int next = j + STAGES - 1;
    if (next < j1) fetch(next, ring + (next % STAGES) * slot);
    cp_async_commit();
    const unsigned char* src = ring + (j % STAGES) * slot;
    for (int t0 = 0; t0 < ps; t0 += L::KPP) {
      const int t = t0 + kg;
      const bool in_page = t < ps;
      const bool ok = in_page && j * ps + t < len;
      float d = 0.f, v[kSlice], ks = 0.f, vs = 0.f;
      if (in_page && live) {
        row(src, t, d, v, ks, vs);
      } else {
#pragma unroll
        for (int k = 0; k < kSlice; ++k) v[k] = 0.f;
      }
      if (L::SLICES != L::LPK) {         // slice 0 of the group is live
        ks = __shfl_sync(0xffffffffu, ks, kg * L::LPK);
        vs = __shfl_sync(0xffffffffu, vs, kg * L::LPK);
      }
      d = xor_sum<1, L::LPK>(d);         // the key's dot over its lanes
      const float s = ok ? d * ks : REPRO_NEG_INF;
      sm.fold(s, ok, v, ok ? vs : 0.f);
    }
  }
}

// launcher.run<DH>() for the head dims the paged kernels take
template <typename Launcher>
cudaError_t dispatch_dh(int Dh, const Launcher& launcher) {
  switch (Dh) {
    case 16: return launcher.template run<16>();
    case 32: return launcher.template run<32>();
    case 64: return launcher.template run<64>();
    case 80: return launcher.template run<80>();
    case 128: return launcher.template run<128>();
    default: return cudaErrorInvalidValue;
  }
}

// Launch a paged kernel on a grid (S, KVH, B) of 32 G threads a CTA (one
// warp a query head), a cluster of S CTAs along x per (kv head, batch
// row); returns the launch's error.
template <typename... Params, typename... Args>
cudaError_t launch_split(void (*kernel)(Params...), int S, int KVH, int B,
                         int G, size_t smem, cudaStream_t stream,
                         Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, KVH, B);
  cfg.blockDim = dim3(32 * G, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace split
