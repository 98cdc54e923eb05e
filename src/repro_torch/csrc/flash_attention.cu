// Flash prefill attention for Hopper (sm_90a): causal or non-causal GQA
// online-softmax attention with a query offset and per-row valid KV length.
//
// Replaces: repro/kernels/flash_attention.py::_flash_kernel (the Pallas TPU
// kernel behind flash_attention_bhsd).  Same contract: q [B,H,Sq,Dh],
// k/v [B,KVH,Sk,Dh] (strided views, head dim contiguous), query i sits at
// key position q_offset + i, keys at or past kv_valid[b] never get weight,
// kv tiles that hold no live key are skipped, rows with no live key output
// exactly 0, and GQA maps q head h to kv head h / G with nothing expanded
// in memory.
//
// What bounds it on this card: at prefill lengths QK^T and PV do ~Sk/2
// multiply-adds per loaded element, so it is compute bound, and only the
// tensor cores (989 bf16 TFLOP/s against 67 fp32 on the CUDA cores) come
// near the bound.  The entry point dispatches by dtype to one of two
// kernels of this file; a dtype always reaches the same one.
//
// bf16 (the serving dtype), flash_mma_kernel: one CTA of four warps per
// (64 queries, head, batch row), each warp owning 16 query rows.  Both
// products run on the tensor cores as mma.sync.m16n8k16 with bf16 operands
// and fp32 accumulators, operands read from shared memory by ldmatrix
// (V through its transposing form).  Q's fragments stay in registers for
// the whole kv loop; the online-softmax state (row max, denominator, the
// [16 x Dh] O accumulator) lives in the accumulator fragments, and the
// causal / kv_valid masks are applied there, per element, only on tiles
// that straddle a mask edge.  K/V tiles of 64 keys arrive by 16-byte
// cp.async into a two-stage ring, so tile t+1 loads while tile t is
// multiplied; rows past Sk are zero-filled, rows past Sq are never
// stored.  Shared tiles are XOR-swizzled in 16-byte chunks so that every
// ldmatrix phase hits eight distinct bank groups.  The grid runs the last
// q tiles (the most kv tiles under the causal mask) first.
// Departure from the TPU kernel's all-fp32 products: P is rounded to bf16
// in registers and fed straight back as the A operand of PV, as
// FlashAttention-2/3 do (the denominator sums P in fp32); the CPU test
// tests/test_torch_kernels.py emulates exactly this rounding against the
// plain version and the Pallas kernel.
// Why mma.sync and not wgmma: wgmma (m64nNk16, K/V from 128-byte-swizzled
// shared memory through matrix descriptors, P from registers) is the only
// route to the card's full rate, but its descriptors and layouts can be
// checked only on the card; mma.sync is the FlashAttention-2 shape, still
// valid on sm_90a, and at the serving shapes (ragged prompts of <= 512
// tokens, Dh 64) the kernel is bound by its tail and the softmax, not the
// products.  wgmma is the next step (ROADMAP, rule 2).
//
// fp32, flash_fwd_kernel: the CUDA-core kernel of the first port, kept for
// fp32's contract (rtol = atol = 1e-5 against the plain version, greedy
// tokens equal across card and CPU), which TF32 tensor cores would break:
// 64-query tiles against 32-key tiles widened in shared memory, scalar
// FMAs, TPQ threads per query row.
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

// ---- fp32: CUDA cores -----------------------------------------------------

namespace simt {

constexpr int BQ = 64;   // queries per block
constexpr int BK = 32;   // keys per shared-memory tile

template <int DH>
struct FlashShape {
  static constexpr int TPQ = DH >= 32 ? DH / 32 : 1;   // threads per query
  static constexpr int DPT = DH / TPQ;                 // dims per thread
  static constexpr int NT = BQ * TPQ;                  // threads per block
};

template <int DH>
__global__ void __launch_bounds__(FlashShape<DH>::NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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
  const float* qrow = q + b * qsb + h * qsh + (int64_t)qi * qss;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = active ? load_f32(qrow, sub + TPQ * i) : 0.f;
    acc[i] = 0.f;
  }
  float m = REPRO_NEG_INF, l = 0.f;

  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;
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
    float* orow = o + b * osb + h * osh + (int64_t)qi * oss;
#pragma unroll
    for (int i = 0; i < DPT; ++i) store_from_f32(orow, sub + TPQ * i,
                                                 acc[i] / den);
  }
}

}  // namespace simt

// ---- bf16: tensor cores ---------------------------------------------------

namespace tc {

constexpr int BQ = 64;        // queries per CTA: 16 per warp
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int NT = 128;       // four warps
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Tile {
  static constexpr int NCH = DH / 8;                 // 16-byte chunks a row
  // XOR swizzle of the chunk index: rows that share a 128-byte line
  // (NCH < 8) step the pattern together, so the 8 rows of an ldmatrix
  // phase always cover the 8 bank groups
  static constexpr int ROWS_PER_STEP = NCH >= 8 ? 1 : 8 / NCH;
  static constexpr int MASK = (NCH >= 8 ? 8 : NCH) - 1;
  static constexpr int BYTES = BK * DH * 2;          // one 64-row tile
  static constexpr int SMEM = 5 * BYTES;             // Q + 2 x (K, V)
};

// shared byte offset of 16-byte chunk c of row r in a swizzled tile
template <int DH>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  using S = Tile<DH>;
  return static_cast<uint32_t>(
      (r * S::NCH + (c ^ ((r / S::ROWS_PER_STEP) & S::MASK))) * 16);
}

// rows [row0, row0 + 64) of a [rows, DH] strided bf16 matrix into a
// swizzled tile; rows at or past n_rows are zero-filled
template <int DH>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int64_t row_stride, int row0,
                                          int n_rows) {
  using S = Tile<DH>;
#pragma unroll
  for (int i = 0; i < BK * S::NCH / NT; ++i) {
    const int idx = i * NT + threadIdx.x;
    const int r = idx / S::NCH, c = idx % S::NCH;
    const bool in = row0 + r < n_rows;
    const __nv_bfloat16* p =
        src + (in ? (int64_t)(row0 + r) * row_stride + c * 8 : 0);
    cp_async16(dst + swz<DH>(r, c), p, in ? 16 : 0);
  }
}

template <int DH>
__global__ void __launch_bounds__(NT)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 const int* __restrict__ kv_valid, int G, int Sq, int Sk,
                 int q_offset, int causal, float scale_log2,
                 int64_t qsb, int64_t qsh, int64_t qss,
                 int64_t ksb, int64_t ksh, int64_t kss,
                 int64_t vsb, int64_t vsh, int64_t vss,
                 int64_t osb, int64_t osh, int64_t oss) {
  using S = Tile<DH>;
  constexpr int KS = DH / 16;            // k-steps of QK^T
  constexpr int ND = DH / 8;             // n-tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_k[2] = {s_q + S::BYTES, s_q + 2 * S::BYTES};
  const uint32_t s_v[2] = {s_q + 3 * S::BYTES, s_q + 4 * S::BYTES};

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;      // longest work first
  const int hk = h / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = qt * BQ;

  const int valid = min(max(kv_valid[b], 0), Sk);
  int kv_end = valid;
  if (causal) kv_end = min(kv_end, q_offset + min(q0 + BQ, Sq));
  kv_end = max(kv_end, 0);
  const int n_tiles = (kv_end + BK - 1) / BK;

  __nv_bfloat16* ob = o + b * osb + h * osh;
  if (n_tiles == 0) {                    // no live key: the rows are 0
    for (int idx = threadIdx.x; idx < BQ * S::NCH; idx += NT) {
      const int r = idx / S::NCH, c = idx % S::NCH;
      if (q0 + r < Sq)
        *reinterpret_cast<uint4*>(ob + (int64_t)(q0 + r) * oss + c * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  const __nv_bfloat16* kb = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vb = v + b * vsb + hk * vsh;
  load_tile<DH>(s_q, q + b * qsb + h * qsh + (int64_t)q0 * qss, qss, 0,
                Sq - q0);
  load_tile<DH>(s_k[0], kb, kss, 0, Sk);
  load_tile<DH>(s_v[0], vb, vss, 0, Sk);
  cp_async_commit();

  uint32_t qf[KS][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // this thread's two rows: g and g + 8 of the warp's 16
  const int qpos[2] = {q_offset + q0 + warp * 16 + g,
                       q_offset + q0 + warp * 16 + g + 8};
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF};   // running max (log2 units)
  float l[2] = {0.f, 0.f};                       // this thread's share of
                                                 // the denominator

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {               // next tile into the other stage
      load_tile<DH>(s_k[st ^ 1], kb, kss, (t + 1) * BK, Sk);
      load_tile<DH>(s_v[st ^ 1], vb, vss, (t + 1) * BK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldmatrix_x4(qf[ks], s_q + swz<DH>(warp * 16 + (lane & 15),
                                          2 * ks + (lane >> 4)));
    }

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t kf[4];
        ldmatrix_x4(kf, s_k[st] + swz<DH>(jp * 16 + (lane >> 4) * 8 +
                                              (lane & 7),
                                          2 * ks + ((lane >> 3) & 1)));
        mma_bf16_16816(s[2 * jp], qf[ks], kf[0], kf[1]);
        mma_bf16_16816(s[2 * jp + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // mask exactly as the TPU kernel does, in the fragment layout; a tile
    // below the diagonal and inside kv_valid for every row needs none
    const int j0 = t * BK;
    const bool edge = j0 + BK > valid ||
                      (causal && j0 + BK - 1 > q_offset + q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = j0 + 8 * j + 2 * t4 + (e & 1);
        const bool ok = !edge || (kpos < valid &&
                                  (!causal || kpos <= qpos[e >> 1]));
        s[j][e] = ok ? s[j][e] * scale_log2 : REPRO_NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {        // the 4 threads of a row agree
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // P = exp2(S - m); a row with no live key yet has m == NEG_INF and
    // exp2(0) == 1, so masked keys are zeroed by rule and such rows stay
    // exactly 0
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = j0 + 8 * j + 2 * t4 + (e & 1);
        const bool ok = !edge || (kpos < valid &&
                                  (!causal || kpos <= qpos[e >> 1]));
        s[j][e] = ok ? exp2f(s[j][e] - m[e >> 1]) : 0.f;
        l[e >> 1] += s[j][e];
      }

    // O += P V: P's accumulator fragments are the A fragments of PV
    // (keys 16kk..16kk+15 are n-tiles 2kk and 2kk+1), rounded to bf16
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pf[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16x2(s[2 * kk + 1][2],
                                          s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, s_v[st] + swz<DH>(kk * 16 +
                                                    ((lane >> 3) & 1) * 8 +
                                                    (lane & 7),
                                                2 * dp + (lane >> 4)));
        mma_bf16_16816(acc[2 * dp], pf, vf[0], vf[1]);
        mma_bf16_16816(acc[2 * dp + 1], pf, vf[2], vf[3]);
      }
    }
    __syncthreads();                     // stage st is free for tile t+2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv[2] = {1.f / fmaxf(l[0], 1e-20f), 1.f / fmaxf(l[1], 1e-20f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi >= Sq) continue;
    __nv_bfloat16* orow = ob + (int64_t)qi * oss;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t4) =
          __floats2bfloat162_rn(acc[n][2 * r] * inv[r],
                                acc[n][2 * r + 1] * inv[r]);
  }
}

}  // namespace tc

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       const int* kv_valid, int B, int H, int KVH, int Sq,
                       int Sk, int q_offset, int causal, float scale,
                       const int64_t* st, cudaStream_t stream) {
  dim3 grid((Sq + simt::BQ - 1) / simt::BQ, H, B);
  simt::flash_fwd_kernel<DH><<<grid, simt::FlashShape<DH>::NT, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), kv_valid,
      H / KVH, Sq, Sk, q_offset, causal, scale, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* o, const int* kv_valid, int B, int H, int KVH,
                        int Sq, int Sk, int q_offset, int causal, float scale,
                        const int64_t* st, cudaStream_t stream) {
  constexpr int smem = tc::Tile<DH>::SMEM;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tc::flash_mma_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(H, B, (Sq + tc::BQ - 1) / tc::BQ);
  tc::flash_mma_kernel<DH><<<grid, tc::NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      kv_valid, H / KVH, Sq, Sk, q_offset, causal, scale * tc::LOG2E, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11]);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t dispatch_dh(int Dh, const void* q, const void* k, const void* v,
                        void* o, const int* kv_valid, int B, int H, int KVH,
                        int Sq, int Sk, int q_offset, int causal, float scale,
                        const int64_t* st, cudaStream_t stream) {
#define REPRO_FLASH_DH(D)                                                    \
  case D:                                                                    \
    return (BF16 ? launch_bf16<D> : launch_f32<D>)(                          \
        q, k, v, o, kv_valid, B, H, KVH, Sq, Sk, q_offset, causal, scale,    \
        st, stream);
  switch (Dh) {
    REPRO_FLASH_DH(16)
    REPRO_FLASH_DH(32)
    REPRO_FLASH_DH(64)
    REPRO_FLASH_DH(128)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_DH
}

}  // namespace

// strides: 12 int64 element strides, (batch, head, seq) for q, k, v, out;
// the head-dim stride must be 1.  kv_valid: [B] int32 on the device.  bf16
// takes rows that start on 16 bytes (the wrapper checks pointers and
// strides).
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
    err = dispatch_dh<false>(Dh, q, k, v, o, kvv, B, H, KVH, Sq, Sk,
                             q_offset, causal, scale, st, s);
  else if (dtype == kBF16)
    err = dispatch_dh<true>(Dh, q, k, v, o, kvv, B, H, KVH, Sq, Sk,
                            q_offset, causal, scale, st, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
