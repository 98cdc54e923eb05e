// Flash attention for the training step on Hopper (sm_90a): the forward,
// which also writes each row's logsumexp, and the backward's two kernels
// (dQ; dK and dV), bf16 on the tensor cores, causal or not, GQA.
//
// Replaces no TPU kernel.  The JAX package trains through plain ops
// (repro/models/attention.py::_full_attention_offset, softmax "naive"):
// it has no Pallas backward.  The port's first training step copied
// that, and its [B, KVH, G, S, S] fp32 scores (mask, softmax, casts,
// three times a layer with the remat recompute) took ~72% of the step's
// device time at qwen2-0.5b's 10 x 2048 tokens.  These kernels compute
// the same masked softmax attention and never hold a [., S, S] tensor.
//
// Contract: q [B,S,H,Dh], k/v [B,S,KVH,Dh] and every gradient in the
// layout _project_qkv produces, read and written through (batch, seq,
// head) element strides, the head dim contiguous, rows on 16 bytes;
// H % KVH == 0, q head h reads kv head h / G; query i sees key j iff
// j <= i (causal) or always.  The forward writes out [B,S,H,Dh] and lse
// [B,H,S] fp32, the natural-log logsumexp of each row's scaled scores;
// the backward reads them (P = exp(s - lse) is recomputed, never stored)
// and dO, and writes D = rowsum(dO * O) [B,H,S] fp32 (dQ kernel) before
// dK and dV read it.
//
// What bounds it on this card: the products.  At qwen2-0.5b's cell
// (B 10, H 14, KVH 2, S 2048, Dh 64, causal) a forward is 2 B H S^2 Dh =
// 75.2 GFLOP of QK^T and PV (the mask keeps half of 4 B H S^2 Dh), 76 us
// at 989 TFLOP/s, against ~20 MB of q, k, v, out and lse, 6 us at 3.35
// TB/s;
// the backward's five products (S, dP, dV, dK and dQ; this design
// recomputes S and dP once more for dQ, seven in all) are 2.5x (3.5x) the
// forward's FLOPs.  So the design keeps the tensor cores fed and keeps
// everything of size S^2 in registers:
//
// * Every product is mma.sync.m16n8k16 (bf16 in, fp32 accumulators), its
//   operands read from XOR-swizzled shared tiles by ldmatrix (the
//   transposing form where the tile's rows are the product's k), as in
//   flash_attention.cu, whose tile loader and swizzle this file repeats.
//   wgmma (64-row warpgroup products from shared-memory descriptors) is
//   the route to the card's full rate and the next step; mma.sync is the
//   FlashAttention-2 shape the port has checked on this card.
// * Each warp owns 16 rows of the product whose accumulators it holds;
//   an accumulator fragment of S or S^T is, rounded to bf16, the A
//   fragment of the next product, so P, dS and their transposes never
//   leave registers.  K/V (forward, dQ) or Q/dO (dK/dV) tiles arrive by
//   16-byte cp.async into two stages, so the next tile loads while this
//   one is multiplied.
// * Forward (flash_train_fwd_kernel): one CTA a (head, batch row, BQ
//   queries), the online softmax in fp32 with base-2 exponentials (one
//   FFMA and one ex2 an element), P rounded to bf16 before PV (as the
//   plain path rounds its fp32 probabilities before its bf16 PV
//   product), the denominator summed in fp32; the grid runs the longest
//   causal query tiles first.
// * dQ (flash_train_bwd_dq_kernel): one CTA a (head, batch row, BQ
//   queries), looping over the key tiles the mask leaves: S = Q K^T,
//   P = exp2(S log2e / sqrt(Dh) - lse log2e), dP = dO V^T, dS = P (dP - D)
//   in fp32, dQ += dS K with dS rounded to bf16.  Its prologue computes
//   D for its rows from dO and the bf16 output and writes it for the next
//   kernel.  No atomics: each CTA owns its dQ rows, so the backward is
//   deterministic.  FlashAttention-2 instead accumulates dQ from the
//   dK/dV kernel with fp32 atomics, saving the second S and dP (2 of 7
//   products) at the price of run-to-run sums and an fp32 dQ buffer; this
//   file takes the deterministic route, and the chip's split of the
//   backward between its two kernels (PERF.md) says what that costs.
// * dK, dV (flash_train_bwd_dkdv_kernel): one CTA a (kv head, batch row,
//   BKV keys), K and V resident in shared memory, looping over the G =
//   H / KVH query heads of its kv head and, for each, the query tiles the
//   mask leaves.  It computes the transposed products, S^T = K Q^T and
//   dP^T = V dO^T, so that a warp's accumulator rows are its 16 keys:
//   dV += P^T dO and dK += dS^T Q then take P^T and dS^T from registers,
//   and dK and dV accumulate over the whole group in registers, so GQA
//   needs no reduction pass and no atomics.  Key tiles near the start
//   see the most queries and run first.
//
// Built: bf16, Dh 64, 80 and 128, one tile pair a Dh and kernel
// (pick_* below); any other Dh is refused (cudaErrorInvalidValue).  At
// Dh 64 the tiles and the CTAs an SM must hold (__launch_bounds__, which
// caps the registers) were picked by timing variants at the cell's shape
// on the card: the forward holds two CTAs of 8 warps (128 registers a
// thread), dQ and dK/dV three of 4 (170); a wider key tile, a larger CTA
// or one CTA an SM was slower in each kernel.
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

// 2^x on the special-function unit, subnormal results flushed to 0 (a
// probability under 2^-126 of its row's largest)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- swizzled tiles (flash_attention.cu's scheme) -------------------------

// A [rows, DH] bf16 tile in shared memory, 16-byte chunks XOR-swizzled by
// row so that the 8 rows of an ldmatrix phase hit 8 distinct bank groups;
// rows that share a 128-byte line (Dh < 64) step the pattern together,
// and at Dh 80 the last 2 chunks of a row stay in place
template <int DH>
struct Swz {
  static constexpr int NCH = DH / 8;
  static constexpr int ROWS_PER_STEP = NCH >= 8 ? 1 : 8 / NCH;
  static constexpr int MASK = (NCH >= 8 ? 8 : NCH) - 1;
  static constexpr int SWZ_CHUNKS = NCH >= 8 ? NCH / 8 * 8 : NCH;
};

// shared byte offset of 16-byte chunk c of row r
template <int DH>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  using W = Swz<DH>;
  const int sc = c < W::SWZ_CHUNKS ? c ^ ((r / W::ROWS_PER_STEP) & W::MASK)
                                   : c;
  return static_cast<uint32_t>((r * W::NCH + sc) * 16);
}

// rows [row0, row0 + ROWS) of a strided bf16 matrix into a swizzled tile
// by NT threads; rows at or past n_rows are zero-filled
template <int DH, int ROWS, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
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
    const bf16* p = src + (in ? (int64_t)(row0 + r) * row_stride + c * 8 : 0);
    cp_async16(dst + swz<DH>(r, c), p, in ? 16 : 0);
  }
}

// A fragment (16 rows x 16 k, k-step ks) of the rows row0.. of a tile
// stored [row][k]
template <int DH>
__device__ __forceinline__ void lda(uint32_t (&a)[4], uint32_t tile,
                                    int row0, int ks) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(a, tile + swz<DH>(row0 + (lane & 15), 2 * ks + (lane >> 4)));
}

// B fragments of n-tiles 2jp, 2jp+1 (n rows n0 = 16 jp ..) at k-step ks,
// from a tile stored [n][k] (b[0], b[1]: n-tile 2jp; b[2], b[3]: 2jp + 1)
template <int DH>
__device__ __forceinline__ void ldb(uint32_t (&b)[4], uint32_t tile, int jp,
                                    int ks) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(b, tile + swz<DH>(jp * 16 + (lane >> 4) * 8 + (lane & 7),
                                2 * ks + ((lane >> 3) & 1)));
}

// B fragments of n-tiles 2dp, 2dp+1 (Dh columns 16 dp ..) at k-step kk,
// from a tile stored [k][n] (its rows are the product's k)
template <int DH>
__device__ __forceinline__ void ldb_t(uint32_t (&b)[4], uint32_t tile,
                                      int kk, int dp) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4_trans(b, tile + swz<DH>(kk * 16 + ((lane >> 3) & 1) * 8 +
                                          (lane & 7),
                                      2 * dp + (lane >> 4)));
}

// the A fragment of k-step kk of a product whose k runs over the n-tiles
// of the accumulator x (2kk and 2kk+1), rounded to bf16
template <int NJ>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&x)[NJ][4], int kk) {
  a[0] = pack_bf16x2(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16x2(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
}

// rows of this thread's accumulator fragments, (g, g + 8) of its warp's 16,
// stored from fp32 as bf16 times `mul`; rows at or past n_rows are skipped
template <int ND>
__device__ __forceinline__ void store_rows(bf16* base, int64_t row_stride,
                                           int row0, int n_rows,
                                           const float (&x)[ND][4],
                                           float mul) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n_rows) continue;
    bf16* p = base + (int64_t)row * row_stride;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * n + 2 * t4) =
          __floats2bfloat162_rn(x[n][2 * r] * mul, x[n][2 * r + 1] * mul);
  }
}

// element strides (batch, seq, head) of one [B, S, heads, Dh] tensor
struct Strides {
  int64_t b, s, h;
};

__device__ __forceinline__ const bf16* at(const bf16* p, Strides st, int b,
                                          int h) {
  return p + b * st.b + h * st.h;
}
__device__ __forceinline__ bf16* at(bf16* p, Strides st, int b, int h) {
  return p + b * st.b + h * st.h;
}

// ---- forward ------------------------------------------------------------

template <int DH, int BQ, int BK>
struct FwdTile {
  static constexpr int NT = 2 * BQ;                  // BQ / 16 warps
  static constexpr int Q_BYTES = BQ * DH * 2;
  static constexpr int KV_BYTES = BK * DH * 2;
  static constexpr int SMEM = Q_BYTES + 4 * KV_BYTES;   // Q + 2 x (K, V)
};

template <int DH, int BQ, int BK, int MINB>
__global__ void __launch_bounds__(2 * BQ, MINB)
flash_train_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ lse, int G, int S, int causal,
                       float scale_log2, Strides qs, Strides ks, Strides vs,
                       Strides os) {
  using T = FwdTile<DH, BQ, BK>;
  constexpr int NT = T::NT, KS = DH / 16, ND = DH / 8, NJ = BK / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_k[2] = {s_q + T::Q_BYTES, s_q + T::Q_BYTES + T::KV_BYTES};
  const uint32_t s_v[2] = {s_q + T::Q_BYTES + 2 * T::KV_BYTES,
                           s_q + T::Q_BYTES + 3 * T::KV_BYTES};

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;      // longest work first
  const int hk = h / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = qt * BQ;
  const int kv_end = causal ? min(q0 + BQ, S) : S;
  const int n_tiles = (kv_end + BK - 1) / BK;

  const bf16* kb = at(k, ks, b, hk);
  const bf16* vb = at(v, vs, b, hk);
  load_tile<DH, BQ, NT>(s_q, at(q, qs, b, h) + (int64_t)q0 * qs.s, qs.s, 0,
                        S - q0);
  load_tile<DH, BK, NT>(s_k[0], kb, ks.s, 0, S);
  load_tile<DH, BK, NT>(s_v[0], vb, vs.s, 0, S);
  cp_async_commit();

  uint32_t qf[KS][4];
  float acc[ND][4];
  zero(acc);
  const int qpos[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF};   // running max of S
  float l[2] = {0.f, 0.f};                       // this thread's share of
                                                 // the denominator
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {               // next tile into the other stage
      load_tile<DH, BK, NT>(s_k[st ^ 1], kb, ks.s, (t + 1) * BK, S);
      load_tile<DH, BK, NT>(s_v[st ^ 1], vb, vs.s, (t + 1) * BK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) lda<DH>(qf[kk], s_q, warp * 16, kk);
    }

    // S = Q K^T: the warp's 16 queries x BK keys
    float s[NJ][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t kf[4];
        ldb<DH>(kf, s_k[st], jp, kk);
        mma_bf16_16816(s[2 * jp], qf[kk], kf[0], kf[1]);
        mma_bf16_16816(s[2 * jp + 1], qf[kk], kf[2], kf[3]);
      }

    // the mask, on tiles that cross the diagonal or the sequence's end
    const int j0 = t * BK;
    const bool edge = j0 + BK > S || (causal && j0 + BK - 1 > q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = j0 + 8 * j + 2 * t4 + (e & 1);
        const bool ok =
            !edge || (kpos < S && (!causal || kpos <= qpos[e >> 1]));
        if (!ok) s[j][e] = REPRO_NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {        // the 4 threads of a row agree
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      ms[r] = mx[r] * scale_log2;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // P = exp2((S - m) log2e / sqrt(Dh)); every row has a live key in
    // its first tile (the diagonal, or any key), so m is finite here and
    // masked keys give 0
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(fmaf(s[j][e], scale_log2, -ms[e >> 1]));
        l[e >> 1] += s[j][e];
      }

    // O += P V, P rounded to bf16
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pf[4];
      acc_to_a(pf, s, kk);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t vf[4];
        ldb_t<DH>(vf, s_v[st], kk, dp);
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
  // out = acc / l and the row's lse, ln(sum of exp(scaled scores))
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qpos[r];
    if (qi >= S) continue;
    const float inv = 1.f / l[r];
    bf16* orow = at(o, os, b, h) + (int64_t)qi * os.s;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t4) =
          __floats2bfloat162_rn(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (t4 == 0) lse[((int64_t)b * gridDim.x + h) * S + qi] =
        (m[r] * scale_log2 + log2f(l[r])) * LN2;
  }
}

// ---- backward: dQ (and D) --------------------------------------------------

template <int DH, int BQ, int BK>
struct DqTile {
  static constexpr int NT = 2 * BQ;
  static constexpr int Q_BYTES = BQ * DH * 2;        // Q, then dO
  static constexpr int KV_BYTES = BK * DH * 2;
  static constexpr int ROWF = 2 * Q_BYTES + 4 * KV_BYTES;   // lse2, D
  static constexpr int SMEM = ROWF + 2 * BQ * 4;
};

template <int DH, int BQ, int BK, int MINB>
__global__ void __launch_bounds__(2 * BQ, MINB)
flash_train_bwd_dq_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ o,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ dd, bf16* __restrict__ dq,
                          int G, int S, int causal, float scale_log2,
                          float scale, Strides qs, Strides ks, Strides vs,
                          Strides os, Strides dos, Strides dqs) {
  using T = DqTile<DH, BQ, BK>;
  constexpr int NT = T::NT, KS = DH / 16, ND = DH / 8, NJ = BK / 8;
  constexpr int NCH = DH / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_do = s_q + T::Q_BYTES;
  const uint32_t s_k[2] = {s_q + 2 * T::Q_BYTES,
                           s_q + 2 * T::Q_BYTES + T::KV_BYTES};
  const uint32_t s_v[2] = {s_q + 2 * T::Q_BYTES + 2 * T::KV_BYTES,
                           s_q + 2 * T::Q_BYTES + 3 * T::KV_BYTES};
  float* s_lse = reinterpret_cast<float*>(smem + T::ROWF);
  float* s_d = s_lse + BQ;

  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int qt = gridDim.z - 1 - blockIdx.z;      // longest work first
  const int hk = h / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = qt * BQ;
  const int kv_end = causal ? min(q0 + BQ, S) : S;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const int64_t row_base = ((int64_t)b * H + h) * S;

  const bf16* kb = at(k, ks, b, hk);
  const bf16* vb = at(v, vs, b, hk);
  load_tile<DH, BQ, NT>(s_q, at(q, qs, b, h) + (int64_t)q0 * qs.s, qs.s, 0,
                        S - q0);
  load_tile<DH, BQ, NT>(s_do, at(dout, dos, b, h) + (int64_t)q0 * dos.s,
                        dos.s, 0, S - q0);
  load_tile<DH, BK, NT>(s_k[0], kb, ks.s, 0, S);
  load_tile<DH, BK, NT>(s_v[0], vb, vs.s, 0, S);
  cp_async_commit();

  // D = rowsum(dO * O) of the tile's rows (fp32 over the bf16 inputs),
  // two threads a row, and each row's lse in log2 units
  {
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    const int qi = q0 + r;
    float d = 0.f;
    if (qi < S) {
      const bf16* orow = at(o, os, b, h) + (int64_t)qi * os.s;
      const bf16* drow = at(dout, dos, b, h) + (int64_t)qi * dos.s;
      for (int c = half; c < NCH; c += 2) {
        const uint4 a4 = *reinterpret_cast<const uint4*>(orow + 8 * c);
        const uint4 d4 = *reinterpret_cast<const uint4*>(drow + 8 * c);
        const __nv_bfloat162* a2 =
            reinterpret_cast<const __nv_bfloat162*>(&a4);
        const __nv_bfloat162* d2 =
            reinterpret_cast<const __nv_bfloat162*>(&d4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          d += __low2float(a2[i]) * __low2float(d2[i]) +
               __high2float(a2[i]) * __high2float(d2[i]);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      s_d[r] = d;
      if (qi < S) dd[row_base + qi] = d;
    } else {
      s_lse[r] = qi < S ? lse[row_base + qi] * LOG2E : 0.f;
    }
  }

  uint32_t qf[KS][4], dof[KS][4];
  float dqa[ND][4];
  zero(dqa);
  const int qpos[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse2[2], drow[2];

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      load_tile<DH, BK, NT>(s_k[st ^ 1], kb, ks.s, (t + 1) * BK, S);
      load_tile<DH, BK, NT>(s_v[st ^ 1], vb, vs.s, (t + 1) * BK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        lda<DH>(qf[kk], s_q, warp * 16, kk);
        lda<DH>(dof[kk], s_do, warp * 16, kk);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = s_lse[warp * 16 + g + 8 * r];
        drow[r] = s_d[warp * 16 + g + 8 * r];
      }
    }

    // S = Q K^T and dP = dO V^T: the warp's 16 queries x BK keys
    float s[NJ][4], dp[NJ][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t kf[4], vf[4];
        ldb<DH>(kf, s_k[st], jp, kk);
        ldb<DH>(vf, s_v[st], jp, kk);
        mma_bf16_16816(s[2 * jp], qf[kk], kf[0], kf[1]);
        mma_bf16_16816(s[2 * jp + 1], qf[kk], kf[2], kf[3]);
        mma_bf16_16816(dp[2 * jp], dof[kk], vf[0], vf[1]);
        mma_bf16_16816(dp[2 * jp + 1], dof[kk], vf[2], vf[3]);
      }

    // P from the saved logsumexp, dS = P (dP - D) in fp32
    const int j0 = t * BK;
    const bool edge = j0 + BK > S || (causal && j0 + BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = j0 + 8 * j + 2 * t4 + (e & 1);
        const bool ok =
            !edge || (kpos < S && (!causal || kpos <= qpos[e >> 1]));
        const float p =
            ok ? ex2(fmaf(s[j][e], scale_log2, -lse2[e >> 1])) : 0.f;
        dp[j][e] = p * (dp[j][e] - drow[e >> 1]);
      }

    // dQ += dS K, dS rounded to bf16
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4];
      acc_to_a(af, dp, kk);
#pragma unroll
      for (int dq2 = 0; dq2 < ND / 2; ++dq2) {
        uint32_t kf[4];
        ldb_t<DH>(kf, s_k[st], kk, dq2);
        mma_bf16_16816(dqa[2 * dq2], af, kf[0], kf[1]);
        mma_bf16_16816(dqa[2 * dq2 + 1], af, kf[2], kf[3]);
      }
    }
    __syncthreads();
  }
  store_rows<ND>(at(dq, dqs, b, h), dqs.s, q0 + warp * 16, S, dqa, scale);
}

// ---- backward: dK and dV ---------------------------------------------------

template <int DH, int BKV, int BQ>
struct DkvTile {
  static constexpr int NT = 2 * BKV;                 // BKV / 16 warps
  static constexpr int KV_BYTES = BKV * DH * 2;      // K, then V
  static constexpr int Q_BYTES = BQ * DH * 2;        // one Q or dO tile
  static constexpr int ROWF = 2 * KV_BYTES + 4 * Q_BYTES;
  static constexpr int SMEM = ROWF + 4 * BQ * 4;     // 2 x (lse, D)
};

template <int DH, int BKV, int BQ, int MINB>
__global__ void __launch_bounds__(2 * BKV, MINB)
flash_train_bwd_dkdv_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ dd,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int G, int S, int causal, float scale_log2,
                            float scale, Strides qs, Strides ks, Strides vs,
                            Strides dos, Strides dks, Strides dvs) {
  using T = DkvTile<DH, BKV, BQ>;
  constexpr int NT = T::NT, KS = DH / 16, ND = DH / 8, NJ = BQ / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_k = smem_u32(smem);
  const uint32_t s_v = s_k + T::KV_BYTES;
  const uint32_t s_q[2] = {s_k + 2 * T::KV_BYTES,
                           s_k + 2 * T::KV_BYTES + T::Q_BYTES};
  const uint32_t s_do[2] = {s_k + 2 * T::KV_BYTES + 2 * T::Q_BYTES,
                            s_k + 2 * T::KV_BYTES + 3 * T::Q_BYTES};
  float* s_lse[2] = {reinterpret_cast<float*>(smem + T::ROWF),
                     reinterpret_cast<float*>(smem + T::ROWF) + BQ};
  float* s_d[2] = {s_lse[0] + 2 * BQ, s_lse[0] + 3 * BQ};

  const int hk = blockIdx.x, b = blockIdx.y, KVH = gridDim.x;
  const int kt = blockIdx.z;             // causal: the first keys see the
  const int H = KVH * G;                 // most queries, and run first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int k0 = kt * BKV;
  const int qt0 = causal ? k0 / BQ : 0;  // the first tile a key is seen in
  const int nqt = (S + BQ - 1) / BQ;
  const int per_head = nqt - qt0;
  const int n_it = G * per_head;

  // iteration it: query head hk * G + it / per_head, tile qt0 + it % ..
  auto load_it = [&](int it, int st) {
    const int h = hk * G + it / per_head;
    const int q0 = (qt0 + it % per_head) * BQ;
    load_tile<DH, BQ, NT>(s_q[st], at(q, qs, b, h) + (int64_t)q0 * qs.s,
                          qs.s, 0, S - q0);
    load_tile<DH, BQ, NT>(s_do[st],
                          at(dout, dos, b, h) + (int64_t)q0 * dos.s, dos.s,
                          0, S - q0);
    // rows past S read row q0's values: their columns are masked below
    const int64_t base = ((int64_t)b * H + h) * S;
    for (int i = threadIdx.x; i < BQ; i += NT) {
      const int qi = q0 + i < S ? q0 + i : q0;
      cp_async4(s_lse[st] + i, lse + base + qi);
      cp_async4(s_d[st] + i, dd + base + qi);
    }
  };

  load_tile<DH, BKV, NT>(s_k, at(k, ks, b, hk), ks.s, k0, S);
  load_tile<DH, BKV, NT>(s_v, at(v, vs, b, hk), vs.s, k0, S);
  load_it(0, 0);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
  zero(dka);
  zero(dva);
  const int kpos[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) {
      load_it(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (qt0 + it % per_head) * BQ;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x BQ queries
    float s[NJ][4], dp[NJ][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kf[4], vf[4];
      lda<DH>(kf, s_k, warp * 16, kk);
      lda<DH>(vf, s_v, warp * 16, kk);
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t qf[4], df[4];
        ldb<DH>(qf, s_q[st], jp, kk);
        ldb<DH>(df, s_do[st], jp, kk);
        mma_bf16_16816(s[2 * jp], kf, qf[0], qf[1]);
        mma_bf16_16816(s[2 * jp + 1], kf, qf[2], qf[3]);
        mma_bf16_16816(dp[2 * jp], vf, df[0], df[1]);
        mma_bf16_16816(dp[2 * jp + 1], vf, df[2], df[3]);
      }
    }

    // P^T from the saved logsumexp (a column is a query), masked: a query
    // past S, or (causal) before the key
    const bool edge = q0 + BQ > S || (causal && q0 < k0 + BKV - 1);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t4 + (e & 1);
        const int qpos = q0 + c;
        const bool ok =
            !edge || (qpos < S && (!causal || kpos[e >> 1] <= qpos));
        s[j][e] = ok ? ex2(fmaf(s[j][e], scale_log2,
                                -s_lse[st][c] * LOG2E))
                     : 0.f;
        dp[j][e] = s[j][e] * (dp[j][e] - s_d[st][c]);
      }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pf[4], sf[4];
      acc_to_a(pf, s, kk);
      acc_to_a(sf, dp, kk);
#pragma unroll
      for (int d2 = 0; d2 < ND / 2; ++d2) {
        uint32_t df[4], qf[4];
        ldb_t<DH>(df, s_do[st], kk, d2);
        ldb_t<DH>(qf, s_q[st], kk, d2);
        mma_bf16_16816(dva[2 * d2], pf, df[0], df[1]);
        mma_bf16_16816(dva[2 * d2 + 1], pf, df[2], df[3]);
        mma_bf16_16816(dka[2 * d2], sf, qf[0], qf[1]);
        mma_bf16_16816(dka[2 * d2 + 1], sf, qf[2], qf[3]);
      }
    }
    __syncthreads();                     // stage st is free for it + 2
  }
  store_rows<ND>(at(dk, dks, b, hk), dks.s, k0 + warp * 16, S, dka, scale);
  store_rows<ND>(at(dv, dvs, b, hk), dvs.s, k0 + warp * 16, S, dva, 1.f);
}

// ---- launches -----------------------------------------------------------

Strides strides_at(const int64_t* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <int DH, int BQ, int BK, int MINB>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int KVH, int S, int causal,
                       float scale, const int64_t* st, cudaStream_t stream) {
  using T = FwdTile<DH, BQ, BK>;
  static SmemOptIn opt_in;
  const cudaError_t err = opt_in(flash_train_fwd_kernel<DH, BQ, BK, MINB>);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash_train_fwd_kernel<DH, BQ, BK, MINB><<<grid, T::NT, T::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), H / KVH, S, causal, scale * LOG2E,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3));
  return cudaGetLastError();
}

template <int DH, int BQ, int BK, int MINB>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* dd, void* dq, int B, int H, int KVH, int S,
                      int causal, float scale, const int64_t* st,
                      cudaStream_t stream) {
  using T = DqTile<DH, BQ, BK>;
  static SmemOptIn opt_in;
  const cudaError_t err = opt_in(flash_train_bwd_dq_kernel<DH, BQ, BK, MINB>);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash_train_bwd_dq_kernel<DH, BQ, BK, MINB><<<grid, T::NT, T::SMEM,
                                               stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(dd), static_cast<bf16*>(dq), H / KVH, S, causal,
      scale * LOG2E, scale, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4),
      strides_at(st, 5));
  return cudaGetLastError();
}

template <int DH, int BKV, int BQ, int MINB>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* dd,
                        void* dk, void* dv, int B, int H, int KVH, int S,
                        int causal, float scale, const int64_t* st,
                        cudaStream_t stream) {
  using T = DkvTile<DH, BKV, BQ>;
  static SmemOptIn opt_in;
  const cudaError_t err =
      opt_in(flash_train_bwd_dkdv_kernel<DH, BKV, BQ, MINB>);
  if (err != cudaSuccess) return err;
  dim3 grid(KVH, B, (S + BKV - 1) / BKV);
  flash_train_bwd_dkdv_kernel<DH, BKV, BQ, MINB><<<grid, T::NT, T::SMEM,
                                             stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H / KVH, S, causal,
      scale * LOG2E, scale, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4),
      strides_at(st, 5));
  return cudaGetLastError();
}

// one tile pair a head dim and kernel, with the CTAs an SM must hold
// (__launch_bounds__' second argument, which caps the registers): (BQ, BK)
// forward and dQ, (BKV, BQ) dK/dV; the wrapper's SUPPORTED_HEAD_DIMS lists
// the head dims
using Fwd = decltype(&launch_fwd<64, 128, 64, 1>);
using Dq = decltype(&launch_dq<64, 64, 64, 1>);
using Dkv = decltype(&launch_dkdv<64, 64, 64, 1>);

Fwd pick_fwd(int dh) {
  switch (dh) {
    case 64: return launch_fwd<64, 128, 64, 2>;
    case 80: return launch_fwd<80, 128, 64, 1>;
    case 128: return launch_fwd<128, 128, 64, 1>;
    default: return nullptr;
  }
}

Dq pick_dq(int dh) {
  switch (dh) {
    case 64: return launch_dq<64, 64, 64, 3>;
    case 80: return launch_dq<80, 64, 64, 1>;
    case 128: return launch_dq<128, 64, 32, 1>;
    default: return nullptr;
  }
}

Dkv pick_dkdv(int dh) {
  switch (dh) {
    case 64: return launch_dkdv<64, 64, 64, 3>;
    case 80: return launch_dkdv<80, 64, 64, 1>;
    case 128: return launch_dkdv<128, 64, 32, 1>;
    default: return nullptr;
  }
}

bool shape_ok(int B, int H, int KVH, int S) {
  return B >= 0 && S >= 0 && KVH > 0 && H > 0 && H % KVH == 0;
}

}  // namespace

// strides: int64 element strides (batch, seq, head) of each tensor named,
// in the order named; every head-dim stride is 1 and every row starts on
// 16 bytes (the wrapper checks).  lse, dd: [B, H, S] fp32, contiguous.
// Dh 64, 80 or 128, bf16 only; anything else is cudaErrorInvalidValue.

// forward; strides of q, k, v, o
REPRO_EXPORT int flash_train_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int H, int KVH,
                                 int S, int Dh, int causal, float scale,
                                 const void* strides, void* stream) {
  const Fwd launch = pick_fwd(Dh);
  if (launch == nullptr || !shape_ok(B, H, KVH, S))
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  return static_cast<int>(launch(q, k, v, o, lse, B, H, KVH, S, causal,
                                 scale, static_cast<const int64_t*>(strides),
                                 static_cast<cudaStream_t>(stream)));
}

// dQ, and D = rowsum(dO * O) into dd; strides of q, k, v, o, dout, dq
REPRO_EXPORT int flash_train_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const void* lse,
                                    void* dd, void* dq, int B, int H, int KVH,
                                    int S, int Dh, int causal, float scale,
                                    const void* strides, void* stream) {
  const Dq launch = pick_dq(Dh);
  if (launch == nullptr || !shape_ok(B, H, KVH, S))
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  return static_cast<int>(launch(q, k, v, o, dout, lse, dd, dq, B, H, KVH,
                                 S, causal, scale,
                                 static_cast<const int64_t*>(strides),
                                 static_cast<cudaStream_t>(stream)));
}

// dK and dV, after flash_train_bwd_dq wrote dd on the same stream;
// strides of q, k, v, dout, dk, dv
REPRO_EXPORT int flash_train_bwd_dkdv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* dd,
                                      void* dk, void* dv, int B, int H,
                                      int KVH, int S, int Dh, int causal,
                                      float scale, const void* strides,
                                      void* stream) {
  const Dkv launch = pick_dkdv(Dh);
  if (launch == nullptr || !shape_ok(B, H, KVH, S))
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  return static_cast<int>(launch(q, k, v, dout, lse, dd, dk, dv, B, H, KVH,
                                 S, causal, scale,
                                 static_cast<const int64_t*>(strides),
                                 static_cast<cudaStream_t>(stream)));
}
