// Flash prefill attention for Hopper (sm_90a): causal or non-causal GQA
// online-softmax attention with a query offset and per-row valid KV length.
//
// Replaces: repro/kernels/flash_attention.py::_flash_kernel (the Pallas TPU
// kernel behind flash_attention_bhsd).  Same contract: q [B,H,Sq,Dh],
// k/v [B,KVH,Sk,Dh], query i sits at key position q_offset + i, keys at or
// past kv_valid[b] never get weight, kv tiles that hold no live key are
// skipped, and rows with no live key output exactly 0.
//
// What bounds it on this card: at prefill lengths the QK^T and PV products
// are ~Sk/2 FMAs per loaded element, so it is compute bound.  This first
// version runs both products on the CUDA cores in fp32 (bf16 inputs are
// widened when a tile lands in shared memory), which keeps fp32 inputs
// within 1e-5 of the plain version; tensor cores (mma/wgmma) are later
// work.  Its design: one block per (q tile of 64 rows, head, batch row);
// the TPU's sequential kv grid axis becomes a loop inside the block, K/V
// tiles of 32 keys are staged once in shared memory and reused by all 64
// queries, and the online-softmax state (running max, denominator, fp32
// accumulator) lives in registers.  TPQ threads share one query row, each
// owning Dh/TPQ interleaved dims, so shared-memory reads are conflict free.
// GQA maps q head h to kv head h / G; nothing is expanded in memory.
#include "common.cuh"

namespace {

constexpr int BQ = 64;   // queries per block
constexpr int BK = 32;   // keys per shared-memory tile

template <int DH>
struct FlashShape {
  static constexpr int TPQ = DH >= 32 ? DH / 32 : 1;   // threads per query
  static constexpr int DPT = DH / TPQ;                 // dims per thread
  static constexpr int NT = BQ * TPQ;                  // threads per block
};

template <typename T, int DH>
__global__ void __launch_bounds__(FlashShape<DH>::NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 const int* __restrict__ kv_valid, int G, int Sq, int Sk,
                 int q_offset, int causal, float scale,
                 int64_t qsb, int64_t qsh, int64_t qss,
                 int64_t ksb, int64_t ksh, int64_t kss,
                 int64_t vsb, int64_t vsh, int64_t vss,
                 int64_t osb, int64_t osh, int64_t oss) {
  using S = FlashShape<DH>;
  constexpr int TPQ = S::TPQ, DPT = S::DPT, NT = S::NT;
  __shared__ float ks[BK][DH];
  __shared__ float vs[BK][DH];
  __shared__ float ss[BQ][BK + 1];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const int tid = threadIdx.x;
  const int row = tid / TPQ, sub = tid % TPQ;
  const int qi = qt * BQ + row;
  const bool active = qi < Sq;
  const int qpos = q_offset + qi;

  const int valid = min(max(kv_valid[b], 0), Sk);
  // keys that can be live for some query of this tile: past the row's
  // valid length, or (causal) past the tile's last query, a tile is dead
  int kv_end = valid;
  if (causal) {
    const int last_q = q_offset + min(qt * BQ + BQ, Sq) - 1;
    kv_end = min(kv_end, last_q + 1);
  }
  kv_end = max(kv_end, 0);
  const int n_tiles = (kv_end + BK - 1) / BK;

  float qr[DPT];
  float acc[DPT];
  const T* qrow = q + b * qsb + h * qsh + (int64_t)qi * qss;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = active ? load_f32(qrow, sub + TPQ * i) : 0.f;
    acc[i] = 0.f;
  }
  float m = REPRO_NEG_INF, l = 0.f;

  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * BK;
    __syncthreads();                       // the previous tile is consumed
    for (int idx = tid; idx < BK * DH; idx += NT) {
      const int r = idx / DH, c = idx % DH;
      const int j = j0 + r;
      float kk = 0.f, vv = 0.f;
      if (j < Sk) {
        kk = load_f32(kb, (int64_t)j * kss + c);
        vv = load_f32(vb, (int64_t)j * vss + c);
      }
      ks[r][c] = kk;
      vs[r][c] = vv;
    }
    __syncthreads();

    // scores of this tile, masked exactly as the TPU kernel masks them
    float tmax = REPRO_NEG_INF;
    for (int r = 0; r < BK; ++r) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part += qr[i] * ks[r][sub + TPQ * i];
#pragma unroll
      for (int off = TPQ / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const int kpos = j0 + r;
      const bool ok = kpos < valid && (!causal || kpos <= qpos);
      const float s = ok ? part * scale : REPRO_NEG_INF;
      tmax = fmaxf(tmax, s);
      if (sub == 0) ss[row][r] = s;
    }
    __syncwarp();

    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    for (int r = 0; r < BK; ++r) {
      const int kpos = j0 + r;
      const bool ok = kpos < valid && (!causal || kpos <= qpos);
      // a row with no live key yet has m_new == NEG_INF and exp(0) == 1:
      // zero masked keys so such rows stay exactly 0
      const float p = ok ? expf(ss[row][r] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += p * vs[r][sub + TPQ * i];
    }
    m = m_new;
  }

  if (active) {
    const float den = fmaxf(l, 1e-20f);
    T* orow = o + b * osb + h * osh + (int64_t)qi * oss;
#pragma unroll
    for (int i = 0; i < DPT; ++i) store_from_f32(orow, sub + TPQ * i,
                                                 acc[i] / den);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* kv_valid, int B, int H, int KVH, int Sq, int Sk,
                   int q_offset, int causal, float scale, const int64_t* st,
                   cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DH><<<grid, FlashShape<DH>::NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), kv_valid, H / KVH, Sq,
      Sk, q_offset, causal, scale, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int Dh, const void* q, const void* k, const void* v,
                        void* o, const int* kv_valid, int B, int H, int KVH,
                        int Sq, int Sk, int q_offset, int causal, float scale,
                        const int64_t* st, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, o, kv_valid, B, H, KVH, Sq, Sk,
                                  q_offset, causal, scale, st, stream);
    case 32: return launch<T, 32>(q, k, v, o, kv_valid, B, H, KVH, Sq, Sk,
                                  q_offset, causal, scale, st, stream);
    case 64: return launch<T, 64>(q, k, v, o, kv_valid, B, H, KVH, Sq, Sk,
                                  q_offset, causal, scale, st, stream);
    case 128: return launch<T, 128>(q, k, v, o, kv_valid, B, H, KVH, Sq, Sk,
                                    q_offset, causal, scale, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 int64 element strides, (batch, head, seq) for q, k, v, out;
// the head-dim stride must be 1.  kv_valid: [B] int32 on the device.
REPRO_EXPORT int flash_attention_fwd(const void* q, const void* k,
                                     const void* v, void* o,
                                     const void* kv_valid, int B, int H,
                                     int KVH, int Sq, int Sk, int Dh,
                                     int q_offset, int causal, float scale,
                                     int dtype, const void* strides,
                                     void* stream) {
  const int* kvv = static_cast<const int*>(kv_valid);
  const int64_t* st = static_cast<const int64_t*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (KVH <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == kF32)
    err = dispatch_dh<float>(Dh, q, k, v, o, kvv, B, H, KVH, Sq, Sk,
                             q_offset, causal, scale, st, s);
  else if (dtype == kBF16)
    err = dispatch_dh<__nv_bfloat16>(Dh, q, k, v, o, kvv, B, H, KVH, Sq, Sk,
                                     q_offset, causal, scale, st, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
