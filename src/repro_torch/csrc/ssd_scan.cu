// Chunked gated linear attention for Hopper (sm_90a): the Mamba2 SSD / mLSTM
// scan, y_t = q_t @ C_t with C_t = f_t C_{t-1} + i_t k_t v_t^T, evaluated
// chunk by chunk with the state carried across chunks.
//
// Replaces: repro/kernels/ssd_scan.py::_ssd_kernel (the Pallas TPU kernel
// behind ssd_scan_flat, which walks a (B*H, chunks) grid and keeps C and n
// in VMEM scratch between chunk steps).  Same contract, per chunk of c
// steps: the inclusive cumsum Bc of log_f; the inter-chunk term
// exp(Bc_t) q_t @ C_prev; the intra-chunk causal, decay-masked term
// sum_{j<=t} exp(Bc_t - Bc_j + li_j) (q_t . k_j) v_j; the optional
// normalizer max(|exp(Bc_t) q_t . n_prev + row-sum(scores)|, eps); the state
// update C = exp(Bc_c) C + sum_j exp(Bc_c - Bc_j + li_j) k_j v_j^T (n alike).
// fp32 math throughout; y is stored in v's dtype, C and n in fp32.  Beyond
// the TPU kernel it takes an optional initial state (C0, n0): a serving
// prefill continues from a carried state.  Steps past S take no part (the
// TPU kernel pads them with log_i = -1e9, which gives the same result).
//
// What bounds it on this card: operations.  At Mamba2's shapes (dk = dv =
// 64, chunk 256) a step does ~150 fp32 FLOPs per byte it reads; the
// tensor-core peak would make it memory-bound, but this kernel runs on the
// fp32 CUDA cores (67 TFLOP/s peak), where it is compute-bound.
//
// Its design: one CTA per (batch, head, 64-column tile of dv), so dv up to
// 512 splits over CTAs and each CTA keeps only C[:, tile] (dk x 64 fp32,
// 128 KiB at dk = 512) and n in shared memory; the scores and the
// normalizer do not depend on dv and are recomputed by every tile.  A loop
// over chunks inside the CTA replaces the TPU's sequential grid axis.  A
// chunk's c x c score tile does not fit shared memory at c = 256 (256 KiB),
// so rows go in tiles of 64 against key tiles of 64 up to the diagonal, and
// dk in slices of 64; 256 threads each own a 4 x 4 block of every 64 x 64
// tile.  The decay is masked BEFORE the exp: above the diagonal the gap is
// positive and could overflow to inf, and inf * 0 would be NaN.  The
// inputs are read through (batch, seq, head) strides, so the model layout
// [B,S,H,d] needs no copy and q, k may be broadcast over heads (stride 0).
// Simple and right first: no tensor cores, no asynchronous copies.
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;        // query rows per tile
constexpr int kJ = 64;        // key rows per tile
constexpr int kD = 64;        // dk slice
constexpr int kE = 64;        // dv columns per CTA
constexpr int kLd = 65;       // padded tile row: no bank conflicts
constexpr int kMaxDim = 512;  // dk and dv (mLSTM's state)
constexpr int kMaxChunk = 1024;
constexpr int kMaxSmem = 232448;

// element strides of the inputs, (batch, seq, head) each
struct Strides {
  long long q[3], k[3], v[3], lf[3], li[3];
};

// dst[r][c] = src[r * row_stride + c] (times row_scale[r]) as fp32 for
// r < rows, c < cols; zero elsewhere in the 64 x 64 tile
template <typename T>
__device__ __forceinline__ void load_tile(
    float* __restrict__ dst, const T* __restrict__ src, long long row_stride,
    int rows, int cols, const float* __restrict__ row_scale) {
  for (int i = threadIdx.x; i < 64 * 64; i += kThreads) {
    const int r = i >> 6, c = i & 63;
    float x = 0.f;
    if (r < rows && c < cols) {
      x = load_f32(src, (int64_t)r * row_stride + c);
      if (row_scale != nullptr) x *= row_scale[r];
    }
    dst[r * kLd + c] = x;
  }
}

// inclusive prefix sum of x[0, n) by one warp
__device__ void warp_inclusive_scan(float* x, int n, int lane) {
  const int per = (n + 31) / 32;
  const int lo = min(lane * per, n), hi = min(lo + per, n);
  float s = 0.f;
  for (int i = lo; i < hi; ++i) {
    s += x[i];
    x[i] = s;
  }
  float incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const float up = __shfl_up_sync(0xffffffffu, incl, 1);
  const float base = lane == 0 ? 0.f : up;
  for (int i = lo; i < hi; ++i) x[i] += base;
}

int smem_floats(int dk, int chunk) {
  const int dkp = (dk + kD - 1) / kD * kD;
  return dkp * kE + dkp + 4 * 64 * kLd + 2 * chunk + kT;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ lf,
                const float* __restrict__ li, const float* __restrict__ c0,
                const float* __restrict__ n0, T* __restrict__ y,
                float* __restrict__ c_out, float* __restrict__ n_out, int H,
                int S, int dk, int dv, int chunk, int normalize, float eps,
                Strides st) {
  extern __shared__ float smem[];
  const int dkp = (dk + kD - 1) / kD * kD;
  float* Cs = smem;               // [dkp][kE] the carried C[:, tile]
  float* ns = Cs + dkp * kE;      // [dkp]     the carried normalizer n
  float* Qs = ns + dkp;           // [kT][kLd] query rows, one dk slice
  float* Ks = Qs + kT * kLd;      // [kJ][kLd] key rows, one dk slice
  float* Vs = Ks + kJ * kLd;      // [kJ][kLd] value rows of the tile
  float* Ps = Vs + kJ * kLd;      // [kT][kLd] decay-masked scores
  float* Bc = Ps + kT * kLd;      // [chunk]   inclusive cumsum of log_f
  float* Wl = Bc + chunk;         // [chunk]   log_i, then state weights
  float* qn = Wl + chunk;         // [kT]      q_t . n_prev of the row tile

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int e0 = blockIdx.y * kE;
  const int ne = min(kE, dv - e0);  // valid columns of this tile
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long sq = st.q[1], sk = st.k[1], sv = st.v[1];

  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* kb = k + b * st.k[0] + h * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[2] + e0;
  const float* lfb = lf + b * st.lf[0] + h * st.lf[2];
  const float* lib = li + b * st.li[0] + h * st.li[2];
  const int64_t ys = (int64_t)H * dv;  // y is [B,S,H,dv], contiguous
  T* yb = y + (int64_t)b * S * ys + (int64_t)h * dv + e0;

  for (int i = tid; i < dkp * kE; i += kThreads) {
    const int d = i / kE, e = i % kE;
    Cs[i] = (c0 != nullptr && d < dk && e < ne)
                ? c0[((int64_t)bh * dk + d) * dv + e0 + e]
                : 0.f;
  }
  for (int d = tid; d < dkp; d += kThreads)
    ns[d] = (n0 != nullptr && d < dk) ? n0[(int64_t)bh * dk + d] : 0.f;

  for (int cs = 0; cs < S; cs += chunk) {
    const int nv = min(chunk, S - cs);  // steps of this chunk inside S
    __syncthreads();
    for (int t = tid; t < nv; t += kThreads) {
      Bc[t] = lfb[(int64_t)(cs + t) * st.lf[1]];
      Wl[t] = lib[(int64_t)(cs + t) * st.li[1]];
    }
    __syncthreads();
    if (tid < 32) warp_inclusive_scan(Bc, nv, tid);
    __syncthreads();
    const float total = Bc[nv - 1];
    const T* qc = qb + (int64_t)cs * sq;
    const T* kc = kb + (int64_t)cs * sk;
    const T* vc = vb + (int64_t)cs * sv;

    for (int tb = 0; tb < nv; tb += kT) {
      float acc[4][4] = {};
      float rs[4] = {};
      if (tid < kT) qn[tid] = 0.f;
      // inter-chunk: q_t @ C_prev and q_t . n_prev, over dk slices
      for (int d0 = 0; d0 < dkp; d0 += kD) {
        load_tile(Qs, qc + (int64_t)tb * sq + d0, sq, nv - tb, dk - d0,
                  (const float*)nullptr);
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kD; ++kk) {
          float a[4], c[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * kLd + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) c[j] = Cs[(d0 + kk) * kE + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
        }
        if (normalize && tid < kT) {
          float s = 0.f;
          for (int kk = 0; kk < kD; ++kk)
            s = fmaf(Qs[tid * kLd + kk], ns[d0 + kk], s);
          qn[tid] += s;
        }
        __syncthreads();
      }
      float g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tb + ty + 16 * i;
        g[i] = t < nv ? expf(Bc[t]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= g[i];
      }
      // intra-chunk: key tiles up to the row tile's diagonal
      for (int jb = 0; jb <= tb; jb += kJ) {
        float sc[4][4] = {};
        for (int d0 = 0; d0 < dkp; d0 += kD) {
          // with one dk slice the row tile is still in Qs
          if (dkp > kD)
            load_tile(Qs, qc + (int64_t)tb * sq + d0, sq, nv - tb, dk - d0,
                      (const float*)nullptr);
          load_tile(Ks, kc + (int64_t)jb * sk + d0, sk, nv - jb, dk - d0,
                    (const float*)nullptr);
          __syncthreads();
#pragma unroll 4
          for (int kk = 0; kk < kD; ++kk) {
            float a[4], c[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * kLd + kk];
#pragma unroll
            for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * kLd + kk];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                sc[i][j] = fmaf(a[i], c[j], sc[i][j]);
          }
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = tb + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int jj = jb + tx + 16 * j;
            float p = 0.f;
            // mask first: above the diagonal the gap is positive
            if (t < nv && jj <= t)
              p = sc[i][j] * expf(Bc[t] - Bc[jj] + Wl[jj]);
            Ps[(ty + 16 * i) * kLd + tx + 16 * j] = p;
            rs[i] += p;
          }
        }
        load_tile(Vs, vc + (int64_t)jb * sv, sv, nv - jb, ne,
                  (const float*)nullptr);
        __syncthreads();
#pragma unroll 4
        for (int jj = 0; jj < kJ; ++jj) {
          float p[4], c[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kLd + jj];
#pragma unroll
          for (int j = 0; j < 4; ++j) c[j] = Vs[jj * kLd + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(p[i], c[j], acc[i][j]);
        }
        __syncthreads();
      }
      if (normalize) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float r = rs[i];  // the 16 lanes of one ty hold one row's parts
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            r += __shfl_xor_sync(0xffffffffu, r, off);
          const float den = fmaxf(fabsf(g[i] * qn[ty + 16 * i] + r), eps);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] /= den;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tb + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = tx + 16 * j;
          if (t < nv && e < ne)
            store_from_f32(yb, (int64_t)(cs + t) * ys + e, acc[i][j]);
        }
      }
      __syncthreads();
    }

    // state update, after every row of the chunk has read C_prev
    const float decay = expf(total);
    for (int t = tid; t < nv; t += kThreads)
      Wl[t] = expf(total - Bc[t] + Wl[t]);
    __syncthreads();
    for (int d0 = 0; d0 < dkp; d0 += kD) {
      float cacc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          cacc[i][j] = decay * Cs[(d0 + ty + 16 * i) * kE + tx + 16 * j];
      float nacc = tid < kD ? decay * ns[d0 + tid] : 0.f;
      for (int jb = 0; jb < nv; jb += kJ) {
        load_tile(Ks, kc + (int64_t)jb * sk + d0, sk, nv - jb, dk - d0,
                  (const float*)nullptr);
        load_tile(Vs, vc + (int64_t)jb * sv, sv, nv - jb, ne, Wl + jb);
        __syncthreads();
#pragma unroll 4
        for (int jj = 0; jj < kJ; ++jj) {
          float a[4], c[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = Ks[jj * kLd + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) c[j] = Vs[jj * kLd + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              cacc[i][j] = fmaf(a[i], c[j], cacc[i][j]);
        }
        if (tid < kD) {
          const int m = min(kJ, nv - jb);
          for (int jj = 0; jj < m; ++jj)
            nacc = fmaf(Ks[jj * kLd + tid], Wl[jb + jj], nacc);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Cs[(d0 + ty + 16 * i) * kE + tx + 16 * j] = cacc[i][j];
      if (tid < kD) ns[d0 + tid] = nacc;
    }
  }
  __syncthreads();
  for (int i = tid; i < dk * kE; i += kThreads) {
    const int d = i / kE, e = i % kE;
    if (e < ne) c_out[((int64_t)bh * dk + d) * dv + e0 + e] = Cs[i];
  }
  if (blockIdx.y == 0)
    for (int d = tid; d < dk; d += kThreads)
      n_out[(int64_t)bh * dk + d] = ns[d];
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lf,
           const void* li, const void* c0, const void* n0, void* y,
           void* c_out, void* n_out, int B, int H, int S, int dk, int dv,
           int chunk, int normalize, float eps, const Strides& st,
           cudaStream_t stream) {
  const int bytes = smem_floats(dk, chunk) * (int)sizeof(float);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (dv + kE - 1) / kE);
  ssd_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lf),
      static_cast<const float*>(li), static_cast<const float*>(c0),
      static_cast<const float*>(n0), static_cast<T*>(y),
      static_cast<float*>(c_out), static_cast<float*>(n_out), H, S, dk, dv,
      chunk, normalize, eps, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k: [B,S,H,dk] and v: [B,S,H,dv] in one dtype (fp32 or bf16), unit
// stride along the last dim, other strides in `strides` (15 int64: batch,
// seq, head for q, k, v, log_f, log_i); log_f, log_i: [B,S,H] fp32.
// c0 [B,H,dk,dv] / n0 [B,H,dk] fp32 contiguous, or both null (zero state).
// Out: y [B,S,H,dv] contiguous in v's dtype, c_out [B,H,dk,dv] and n_out
// [B,H,dk] fp32 contiguous.  1 <= dk, dv <= 512; 1 <= chunk <= 1024 (the
// wrapper passes min(chunk, S)); S >= 1.  A larger state is refused.
REPRO_EXPORT int ssd_scan_fwd(const void* q, const void* k, const void* v,
                              const void* lf, const void* li, const void* c0,
                              const void* n0, void* y, void* c_out,
                              void* n_out, int B, int H, int S, int dk, int dv,
                              int chunk, int normalize, float eps, int dtype,
                              const void* strides, void* stream) {
  if (B < 1 || H < 1 || S < 1 || chunk < 1 || chunk > kMaxChunk)
    return cudaErrorInvalidValue;
  if (dk < 1 || dk > kMaxDim || dv < 1 || dv > kMaxDim)
    return cudaErrorInvalidValue;
  if ((long long)B * H > 0x7fffffffLL) return cudaErrorInvalidValue;
  Strides st;
  memcpy(&st, strides, sizeof st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(q, k, v, lf, li, c0, n0, y, c_out, n_out, B, H, S,
                         dk, dv, chunk, normalize, eps, st, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k, v, lf, li, c0, n0, y, c_out, n_out, B,
                                 H, S, dk, dv, chunk, normalize, eps, st, s);
  return cudaErrorInvalidValue;
}
