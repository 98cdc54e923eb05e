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
// Tiles are template parameters: BQ queries a CTA and BK keys a shared-
// memory tile, over the few pairs each dtype builds (pick_bf16 / pick_f32
// below, the wrapper's FLASH_PAIRS; the registry's autotune sweeps them,
// and an untuned call takes the defaults, bf16 (64, 64), fp32 (64, 32)).
// A pair that was not built is refused, never replaced by another.
//
// bf16 (the serving dtype), flash_mma_kernel: one CTA of BQ / 16 warps
// (4 or 8) per (BQ queries, head, batch row), each warp owning 16 rows.  Both
// products run on the tensor cores as mma.sync.m16n8k16 with bf16 operands
// and fp32 accumulators, operands read from shared memory by ldmatrix
// (V through its transposing form).  Q's fragments stay in registers for
// the whole kv loop; the online-softmax state (row max, denominator, the
// [16 x Dh] O accumulator) lives in the accumulator fragments, and the
// causal / kv_valid masks are applied there, per element, only on tiles
// that straddle a mask edge.  K/V tiles of BK keys arrive by 16-byte
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
// Head dims: 16, 32, 64, 80 and 128 (stablelm-3b's 2560 / 32 = 80), the
// TPU kernel's blocks spanning the whole of any Dh.  At Dh 80 a row is
// 10 chunks: KS = 5 k-steps of QK^T and ND = 10 n-tiles of O, both fine
// for m16n8k16 and the x4 ldmatrix; the swizzle keeps the last 2 chunks
// of each row in place (Tile::SWZ_CHUNKS), so every address stays inside
// its row.
//
// fp32, flash_fwd_kernel: the CUDA-core kernel of the first port, kept for
// fp32's contract (rtol = atol = 1e-5 against the plain version, greedy
// tokens equal across card and CPU), which TF32 tensor cores would break:
// BQ-query tiles against BK-key tiles widened in static shared memory
// (every built pair fits 48 KB at Dh 128), scalar FMAs, TPQ threads per
// query row.
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

// ---- fp32: CUDA cores -----------------------------------------------------

namespace simt {

// BQ queries per block, BK keys per shared-memory tile (the wrapper's
// FLASH_PAIRS[fp32]; static shared memory, so every pair stays under 48 KB
// at Dh 128).  TPQ is a power of two at every built head dim (1, 1, 2, 2,
// 4 at Dh 16, 32, 64, 80, 128), which the shuffle reduction of a score
// needs; Dh 80 gives each of a query's 2 threads 40 dims.
template <int DH, int BQ>
struct FlashShape {
  static constexpr int TPQ = DH >= 32 ? DH / 32 : 1;   // threads per query
  static constexpr int DPT = DH / TPQ;                 // dims per thread
  static constexpr int NT = BQ * TPQ;                  // threads per block
};

template <int DH, int BQ, int BK>
__global__ void __launch_bounds__(FlashShape<DH, BQ>::NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 const int* __restrict__ kv_valid, int G, int Sq, int Sk,
                 int q_offset, int causal, float scale,
                 int64_t qsb, int64_t qsh, int64_t qss,
                 int64_t ksb, int64_t ksh, int64_t kss,
                 int64_t vsb, int64_t vsh, int64_t vss,
                 int64_t osb, int64_t osh, int64_t oss) {
  using S = FlashShape<DH, BQ>;
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

constexpr float LOG2E = 1.4426950408889634f;

// BQ queries per CTA (16 per warp: 4 or 8 warps), BK keys per shared-memory
// tile (the wrapper's FLASH_PAIRS[bf16])
template <int DH, int BQ, int BK>
struct Tile {
  static constexpr int NCH = DH / 8;                 // 16-byte chunks a row
  // XOR swizzle of the chunk index: rows that share a 128-byte line
  // (NCH < 8) step the pattern together, so the 8 rows of an ldmatrix
  // phase always cover the 8 bank groups.  Only the whole groups of 8
  // chunks are swizzled (SWZ_CHUNKS): at Dh 80 a row has 10 chunks, and
  // c ^ mask would send chunks 8 and 9 past the row, so those two stay
  // where they are (a 2-way bank conflict on their ldmatrix phases)
  static constexpr int ROWS_PER_STEP = NCH >= 8 ? 1 : 8 / NCH;
  static constexpr int MASK = (NCH >= 8 ? 8 : NCH) - 1;
  static constexpr int SWZ_CHUNKS = NCH >= 8 ? NCH / 8 * 8 : NCH;
  static constexpr int NT = 2 * BQ;                  // BQ / 16 warps
  static constexpr int Q_BYTES = BQ * DH * 2;        // the Q tile
  static constexpr int KV_BYTES = BK * DH * 2;       // one K or V tile
  static constexpr int SMEM = Q_BYTES + 4 * KV_BYTES;   // Q + 2 x (K, V)
};

// shared byte offset of 16-byte chunk c of row r in a swizzled tile
template <int DH>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  using S = Tile<DH, 64, 64>;            // the swizzle depends on DH only
  const int sc = c < S::SWZ_CHUNKS
                     ? c ^ ((r / S::ROWS_PER_STEP) & S::MASK)
                     : c;
  return static_cast<uint32_t>((r * S::NCH + sc) * 16);
}

// rows [row0, row0 + ROWS) of a [rows, DH] strided bf16 matrix into a
// swizzled tile by NT threads; rows at or past n_rows are zero-filled
template <int DH, int ROWS, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int64_t row_stride, int row0,
                                          int n_rows) {
  constexpr int NCH = DH / 8;
  constexpr int TOTAL = ROWS * NCH;
#pragma unroll
  for (int i = 0; i < (TOTAL + NT - 1) / NT; ++i) {
    const int idx = i * NT + threadIdx.x;
    if (TOTAL % NT != 0 && idx >= TOTAL) break;
    const int r = idx / NCH, c = idx % NCH;
    const bool in = row0 + r < n_rows;
    const __nv_bfloat16* p =
        src + (in ? (int64_t)(row0 + r) * row_stride + c * 8 : 0);
    cp_async16(dst + swz<DH>(r, c), p, in ? 16 : 0);
  }
}

template <int DH, int BQ, int BK>
__global__ void __launch_bounds__(2 * BQ)
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
  using S = Tile<DH, BQ, BK>;
  constexpr int NT = S::NT;
  constexpr int KS = DH / 16;            // k-steps of QK^T
  constexpr int ND = DH / 8;             // n-tiles of O
  constexpr int NJ = BK / 8;             // n-tiles of S (8 keys each)
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_k[2] = {s_q + S::Q_BYTES, s_q + S::Q_BYTES + S::KV_BYTES};
  const uint32_t s_v[2] = {s_q + S::Q_BYTES + 2 * S::KV_BYTES,
                           s_q + S::Q_BYTES + 3 * S::KV_BYTES};

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
  load_tile<DH, BQ, NT>(s_q, q + b * qsb + h * qsh + (int64_t)q0 * qss,
                        qss, 0, Sq - q0);
  load_tile<DH, BK, NT>(s_k[0], kb, kss, 0, Sk);
  load_tile<DH, BK, NT>(s_v[0], vb, vss, 0, Sk);
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
      load_tile<DH, BK, NT>(s_k[st ^ 1], kb, kss, (t + 1) * BK, Sk);
      load_tile<DH, BK, NT>(s_v[st ^ 1], vb, vss, (t + 1) * BK, Sk);
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

    // S = Q K^T for this warp's 16 rows x BK keys (NJ n-tiles of 8 keys)
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
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
    for (int j = 0; j < NJ; ++j)
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
    for (int j = 0; j < NJ; ++j)
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
    for (int kk = 0; kk < BK / 16; ++kk) {
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

template <int DH, int BQ, int BK>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       const int* kv_valid, int B, int H, int KVH, int Sq,
                       int Sk, int q_offset, int causal, float scale,
                       const int64_t* st, cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  simt::flash_fwd_kernel<DH, BQ, BK>
      <<<grid, simt::FlashShape<DH, BQ>::NT, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), kv_valid,
      H / KVH, Sq, Sk, q_offset, causal, scale, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <int DH, int BQ, int BK>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* o, const int* kv_valid, int B, int H, int KVH,
                        int Sq, int Sk, int q_offset, int causal, float scale,
                        const int64_t* st, cudaStream_t stream) {
  using S = tc::Tile<DH, BQ, BK>;
  constexpr int smem = S::SMEM;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tc::flash_mma_kernel<DH, BQ, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  tc::flash_mma_kernel<DH, BQ, BK><<<grid, S::NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      kv_valid, H / KVH, Sq, Sk, q_offset, causal, scale * tc::LOG2E, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11]);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void*, const void*, const void*, void*,
                               const int*, int, int, int, int, int, int, int,
                               float, const int64_t*, cudaStream_t);

// the (BQ, BK) pairs built for each dtype: the wrapper's FLASH_PAIRS, which
// must list the same pairs; any other pair is refused, never replaced
template <int DH>
Launch pick_bf16(int bq, int bk) {
#define REPRO_FLASH_PAIR(Q, K) \
  if (bq == Q && bk == K) return launch_bf16<DH, Q, K>;
  REPRO_FLASH_PAIR(64, 32)
  REPRO_FLASH_PAIR(64, 64)
  REPRO_FLASH_PAIR(64, 128)
  REPRO_FLASH_PAIR(128, 32)
  REPRO_FLASH_PAIR(128, 64)
  REPRO_FLASH_PAIR(128, 128)
#undef REPRO_FLASH_PAIR
  return nullptr;
}

template <int DH>
Launch pick_f32(int bq, int bk) {
#define REPRO_FLASH_PAIR(Q, K) \
  if (bq == Q && bk == K) return launch_f32<DH, Q, K>;
  REPRO_FLASH_PAIR(32, 32)
  REPRO_FLASH_PAIR(64, 16)
  REPRO_FLASH_PAIR(64, 32)
  REPRO_FLASH_PAIR(128, 16)
#undef REPRO_FLASH_PAIR
  return nullptr;
}

Launch pick(bool bf16, int Dh, int bq, int bk) {
  switch (Dh) {
    case 16: return bf16 ? pick_bf16<16>(bq, bk) : pick_f32<16>(bq, bk);
    case 32: return bf16 ? pick_bf16<32>(bq, bk) : pick_f32<32>(bq, bk);
    case 64: return bf16 ? pick_bf16<64>(bq, bk) : pick_f32<64>(bq, bk);
    case 80: return bf16 ? pick_bf16<80>(bq, bk) : pick_f32<80>(bq, bk);
    case 128: return bf16 ? pick_bf16<128>(bq, bk) : pick_f32<128>(bq, bk);
    default: return nullptr;
  }
}

}  // namespace

// strides: 12 int64 element strides, (batch, head, seq) for q, k, v, out;
// the head-dim stride must be 1.  kv_valid: [B] int32 on the device.  bf16
// takes rows that start on 16 bytes (the wrapper checks pointers and
// strides).  (bq, bk): one of the pairs built for the dtype (pick_bf16 /
// pick_f32); any other pair, head dim or dtype returns
// cudaErrorInvalidValue.
REPRO_EXPORT int flash_attention_fwd(const void* q, const void* k,
                                     const void* v, void* o,
                                     const void* kv_valid, int B, int H,
                                     int KVH, int Sq, int Sk, int Dh,
                                     int q_offset, int causal, float scale,
                                     int dtype, int bq, int bk,
                                     const void* strides, void* stream) {
  const int* kvv = static_cast<const int*>(kv_valid);
  const int64_t* st = static_cast<const int64_t*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  const Launch launch = pick(dtype == kBF16, Dh, bq, bk);
  if (launch == nullptr) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (KVH <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  return static_cast<int>(launch(q, k, v, o, kvv, B, H, KVH, Sq, Sk,
                                 q_offset, causal, scale, st, s));
}
