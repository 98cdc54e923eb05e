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
// y is stored in v's dtype, C and n in fp32.  Beyond the TPU kernel it
// takes an optional initial state (C0, n0): a serving prefill continues
// from a carried state.  Steps past S take no part (the TPU kernel pads
// them with log_i = -1e9, which gives the same result).  The inputs are
// read through (batch, seq, head) strides, so the model layout [B,S,H,d]
// needs no copy and q, k may be broadcast over heads (stride 0).  The entry
// point dispatches by dtype to one of two routes; a dtype always reaches
// the same one.
//
// What bounds it on this card.  At zamba2's generate call ([8,512,64,64,64]
// in bf16, chunk 256, a carried state) the algorithm needs 12.9 GFLOP and
// 87.6 MB read or written once: 0.0261 ms at 3.35 TB/s, against 0.013 ms
// of bf16 tensor-core time at 989 TFLOP/s (0.026 ms with the state
// update's second, lo product, below), so bytes bound it, but only just;
// on the fp32 CUDA cores (67 TFLOP/s) the FLOPs alone take 0.19 ms.
//
// bf16 (the serving dtype): three passes, Mamba2's own SSD split, launched
// in a row on the caller's stream, so every chunk is worked on in parallel
// and a one-row admission (B = 1, H = 64, S = 512: 512 CTAs in pass (c))
// still fills the card:
//  (a) ssd_local_states_kernel, grid (b*h, chunk, dk tile, dv tile): each
//      chunk's own state dC = (k*w)^T v, w_j = exp(total - Bc_j + li_j),
//      dn = sum_j k_j w_j and its total into fp32 scratch, and the gates
//      pass (c) reads (Bc, Bc - li, and the key factors below);
//  (b) ssd_state_pass_kernel, grid (b*h, state elements): the chunks in
//      order from (C0, n0): C_prev[c] = running, running = exp(total_c)
//      running + dC_c; writes C_prev (bf16), n_prev, c_out and n_out;
//  (c) ssd_outputs_kernel, grid (b*h, chunk, 64-row tile, dv tile), the
//      row tiles with the most key tiles first: y = exp(Bc) q @ C_prev[c]
//      plus the causal decay-masked key tiles up to the diagonal, then the
//      normalizer.
// A CTA is one warpgroup, and all four products are wgmma.m64n64k16 with
// bf16 operands and fp32 accumulators: B (and Q as A) read from shared
// 64 x 64 tiles through matrix descriptors, P and k*w as A from registers.
// Tiles arrive by 16-byte cp.async (4-byte when a row start is not 16-byte
// aligned; zero past S, dk and dv) into a ring (4 tiles deep in (c), 3
// (K, V) pairs in (a)), XOR-swizzled in 16-byte chunks by row, which is
// wgmma's 128-byte swizzle.  Rounding points, where the TPU kernel
// multiplies in fp32 (emulated on the CPU, with the errors it observes, in
// tests/test_torch_ssm.py):
//  - the state update keeps fp32 accuracy: k*w (fp32) is split into its
//    bf16 rounding hi and the bf16 rounding of k*w - hi, and both go
//    through the tensor cores against the exact bf16 v (~2^-17 relative a
//    term; hi alone misses the fp32 tolerance on C ~70-fold); dn, the
//    decays and the pass over states stay in fp32;
//  - C_prev is rounded to bf16 once, as the B operand of q @ C_prev (y is
//    bf16; the row scale exp(Bc_t) is applied to the fp32 product);
//  - P = (q k^T) * decay is formed in fp32 registers, summed in fp32 for
//    the normalizer and rounded to bf16 only as the A operand of P @ V, as
//    in flash attention.  The decay of a 64 x 64 tile is a row factor
//    exp(Bc_t - Bc_jb) times a key factor exp(Bc_jb - Bc_j + li_j) when
//    the tile's keys span at most 64 in Bc (two exps a row and a key, not
//    one an element; neither factor overflows); else it is taken element by
//    element, masked BEFORE the exp (above the diagonal the gap is
//    positive and could overflow, and inf * 0 would be NaN).
// Scratch (the wrapper allocates one buffer, torch.empty): dC fp32 and
// C_prev bf16 [b*h][chunks][dk][dv] (dk, dv padded to 64), dn, n_prev
// [b*h][chunks][dk] fp32, totals [b*h][chunks], gates [b*h][chunks][3]
// [chunk] fp32: 8*64*2*64*64*4 B = 16.8 MB of dC at the generate shape
// (28.8 MB in all); 1 MiB of dC per (b, h, chunk) at mLSTM's dk = dv =
// 512.  It is traffic, not work: the wrapper leaves it out of the bytes it
// declares.  What is left on the table: the scores q k^T do not depend on
// dv or, with q and k broadcast over heads, on the head, and each (dv
// tile, head) CTA recomputes them; every wgmma is waited on at once, so a
// CTA's products, exps and copies overlap only with other CTAs'.
//
// fp32: ssd_scan_kernel, the CUDA-core kernel of the first port, unchanged:
// TF32 tensor cores would break fp32's contract (rtol 2e-4 against the
// plain version).  One CTA per (batch, head, 64-column tile of dv) keeps
// C[:, tile] (dk x 64 fp32) and n in shared memory and walks the chunks in
// order; a chunk's rows go in tiles of 64 against key tiles of 64 up to
// the diagonal, dk in slices of 64; 256 threads each own a 4 x 4 block of
// every 64 x 64 tile; scalar FMAs, synchronous loads.
#include <string.h>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kMaxDim = 512;  // dk and dv (mLSTM's state)
constexpr int kMaxChunk = 1024;

// element strides of the inputs, (batch, seq, head) each
struct Strides {
  long long q[3], k[3], v[3], lf[3], li[3];
};

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

// ---- fp32: CUDA cores ----------------------------------------------------

namespace simt {

constexpr int kThreads = 256;
constexpr int kT = 64;        // query rows per tile
constexpr int kJ = 64;        // key rows per tile
constexpr int kD = 64;        // dk slice
constexpr int kE = 64;        // dv columns per CTA
constexpr int kLd = 65;       // padded tile row: no bank conflicts
constexpr int kMaxSmem = 232448;

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


}  // namespace simt

// ---- bf16: tensor cores, three passes -------------------------------------

namespace tc {

constexpr int NT = 128;                 // four warps
constexpr int TILE_BYTES = 64 * 64 * 2; // one 64 x 64 bf16 tile
constexpr int STAGES = 4;               // pass (c)'s ring depth (tiles)
constexpr int A_STAGES = 3;             // pass (a)'s ((K, V) tile pairs)
constexpr float MAX_SPAN = 64.f;        // see ssd_outputs_kernel

__host__ __device__ inline int pad64(int n) { return (n + 63) / 64 * 64; }

// byte offset of 16-byte chunk c (0..7) of row r in a swizzled 64 x 64 bf16
// tile: the 8 rows of an ldmatrix phase hit 8 distinct bank groups
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>((r * 8 + (c ^ (r & 7))) * 16);
}

// rows [0, rows) x cols [0, cols) of a strided bf16 matrix into a swizzled
// 64 x 64 tile at `dst`, every other element zero.  wide: 16-byte copies
// (row starts 16-byte aligned; a partial chunk is zero-filled by the copy);
// else 4-byte copies (row starts 4-byte aligned, cols even).
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int rows,
                                          int cols, bool wide) {
  if (wide) {
    const uint32_t base = smem_u32(dst);
#pragma unroll
    for (int i = 0; i < 64 * 8 / NT; ++i) {
      const int idx = i * NT + threadIdx.x;
      const int r = idx >> 3, c = idx & 7;
      const int n = r < rows ? min(max(cols - 8 * c, 0), 8) : 0;
      const __nv_bfloat16* p =
          n > 0 ? src + (long long)r * row_stride + 8 * c : src;
      cp_async16(base + swz(r, c), p, 2 * n);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < 64 * 32 / NT; ++i) {
      const int idx = i * NT + threadIdx.x;
      const int r = idx >> 5, w = idx & 31;
      unsigned char* a = dst + swz(r, w >> 2) + 4 * (w & 3);
      if (r < rows && 2 * w < cols)
        cp_async4(a, src + (long long)r * row_stride + 2 * w);
      else
        *reinterpret_cast<uint32_t*>(a) = 0u;
    }
  }
}

// the first 1024-byte boundary at or after p (wgmma's swizzled tiles start
// on one); the kernels ask for 1024 bytes more shared memory than they use
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// descriptors of a swizzled tile at `addr`, advanced to k-step kk (16 of
// its k): K-major (k along the 128-byte rows) and MN-major (k down them)
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, int kk) {
  return wgmma_desc(addr + 32 * kk, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, int kk) {
  return wgmma_desc(addr + 2048 * kk, 1024, 1024);
}

// a bf16 pair (low half first) times (w0, w1) in fp32, split into its bf16
// rounding `hi` and the bf16 rounding of the remainder `lo`; the two fp32
// products are added to `sum`
__device__ __forceinline__ void scale_split(uint32_t x, float w0, float w1,
                                            uint32_t& hi, uint32_t& lo,
                                            float& sum) {
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&x);
  const float a0 = __low2float(b) * w0, a1 = __high2float(b) * w1;
  hi = pack_bf16x2(a0, a1);
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  lo = pack_bf16x2(a0 - __low2float(h), a1 - __high2float(h));
  sum += a0 + a1;
}

// the scratch of the three passes, carved from one buffer: dC and C_prev
// [BH][nc][dkp][dvp] (fp32, bf16), dn and n_prev [BH][nc][dkp] fp32, the
// chunks' log-decays tot [BH][nc] and their gates [BH][nc][3][cp] (cp =
// chunk padded to 64: Bc, Bc - log_i, and the key factors of the decay);
// every piece 256-byte aligned
struct Scratch {
  float* dC;
  __nv_bfloat16* cprev;
  float *dn, *nprev, *tot, *gates;
};

inline long long align256(long long n) { return (n + 255) / 256 * 256; }

inline long long scratch_layout(long long bh, int nc, int dkp, int dvp,
                                int cp, unsigned char* base, Scratch* out) {
  const long long plane = bh * nc * dkp * dvp, vec = bh * nc * dkp;
  const long long sizes[6] = {4 * plane, 2 * plane, 4 * vec, 4 * vec,
                              4 * bh * nc, 4 * bh * nc * 3 * cp};
  long long off[6], total = 0;
  for (int i = 0; i < 6; ++i) {
    off[i] = total;
    total += align256(sizes[i]);
  }
  if (out != nullptr) {
    out->dC = reinterpret_cast<float*>(base + off[0]);
    out->cprev = reinterpret_cast<__nv_bfloat16*>(base + off[1]);
    out->dn = reinterpret_cast<float*>(base + off[2]);
    out->nprev = reinterpret_cast<float*>(base + off[3]);
    out->tot = reinterpret_cast<float*>(base + off[4]);
    out->gates = reinterpret_cast<float*>(base + off[5]);
  }
  return total;
}

// (a) local chunk states.  One CTA per (b*h, chunk, 64-row dk tile,
// 64-column dv tile): dC[d][e] = sum_j k_j[d] w_j v_j[e] over the chunk's
// keys, w_j = exp(total - Bc_j + li_j); k*w is split into bf16 hi + lo, two
// products against the exact bf16 v on the tensor cores; dn[d] = sum_j
// k_j[d] w_j in fp32 from the same products.  The first CTA of each (b*h,
// chunk) also writes the chunk's total and its gates for pass (c).  Warp w
// owns dk rows 16w..16w+15 of the tile.
__global__ void __launch_bounds__(NT)
ssd_local_states_kernel(const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ lf,
                        const float* __restrict__ li, Scratch sc, int H,
                        int S, int dk, int dv, int chunk, int nc, int ndk,
                        int ndv, int wide, Strides st) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int cp = pad64(chunk);
  float* Bc = reinterpret_cast<float*>(smem + A_STAGES * 2 * TILE_BYTES);
  float* Wl = Bc + cp;
  const int dkp = ndk * 64, dvp = ndv * 64;

  long long id = blockIdx.x;
  const int et = static_cast<int>(id % ndv);
  id /= ndv;
  const int dt = static_cast<int>(id % ndk);
  id /= ndk;
  const int c = static_cast<int>(id % nc);
  const long long bh = id / nc;
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  const int cs = c * chunk, nv = min(chunk, S - cs);
  const int d0 = dt * 64, e0 = et * 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long long sk = st.k[1], sv = st.v[1];
  const __nv_bfloat16* kc =
      k + b * st.k[0] + h * st.k[2] + (long long)cs * sk + d0;
  const __nv_bfloat16* vc =
      v + b * st.v[0] + h * st.v[2] + (long long)cs * sv + e0;
  const int nkt = (nv + 63) / 64;

  auto issue = [&](int i) {
    if (i < nkt) {
      unsigned char* slot = smem + (i % A_STAGES) * 2 * TILE_BYTES;
      load_tile(slot, kc + (long long)i * 64 * sk, sk, nv - 64 * i, dk - d0,
                wide);
      load_tile(slot + TILE_BYTES, vc + (long long)i * 64 * sv, sv,
                nv - 64 * i, dv - e0, wide);
    }
    cp_async_commit();
  };
  // log_f into Bc and log_i into Wl, 4-byte copies in tile 0's group
  const float* lfb = lf + b * st.lf[0] + h * st.lf[2] + cs * st.lf[1];
  const float* lib = li + b * st.li[0] + h * st.li[2] + cs * st.li[1];
  for (int t = threadIdx.x; t < nv; t += NT) {
    cp_async4(Bc + t, lfb + (long long)t * st.lf[1]);
    cp_async4(Wl + t, lib + (long long)t * st.li[1]);
  }
  for (int i = 0; i < A_STAGES - 1; ++i) issue(i);
  cp_async_wait<A_STAGES - 2>();
  __syncthreads();
  if (threadIdx.x < 32) warp_inclusive_scan(Bc, nv, threadIdx.x);  // Bc
  __syncthreads();
  const float total = Bc[nv - 1];
  const bool first = et == 0 && dt == 0;
  if (first) {
    // pass (c)'s gates: Bc; Bc - li (the per-element decay is
    // exp(Bc_t - that)); the key factor exp(Bc_jb - Bc_j + li_j) against
    // the first key jb of j's 64-key tile.  Zero past the chunk's end.
    float* gt = sc.gates + (bh * nc + c) * 3 * cp;
    for (int t = threadIdx.x; t < nkt * 64; t += NT) {
      const bool in = t < nv;
      gt[t] = in ? Bc[t] : 0.f;
      gt[cp + t] = in ? Bc[t] - Wl[t] : 0.f;
      gt[2 * cp + t] = in ? expf(Bc[t & ~63] - Bc[t] + Wl[t]) : 0.f;
    }
    if (threadIdx.x == 0) sc.tot[bh * nc + c] = total;
  }
  __syncthreads();  // every read of log_i is done
  for (int t = threadIdx.x; t < nkt * 64; t += NT)  // keys past S weigh 0
    Wl[t] = t < nv ? expf(total - Bc[t] + Wl[t]) : 0.f;

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float nsum[2] = {0.f, 0.f};  // dn of rows g and g + 8, this lane's keys

  for (int i = 0; i < nkt; ++i) {
    cp_async_wait<A_STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // tile i landed; tile i-1's slot is free (and Wl set)
    issue(i + A_STAGES - 1);
    const uint32_t ku = smem_u32(smem + (i % A_STAGES) * 2 * TILE_BYTES);
    const uint32_t vu = ku + TILE_BYTES;
    // A = (k*w)^T: rows dk (warp w: 16w..16w+15), columns the 16 keys of
    // k-step kk, from the [key][d] tile through ldmatrix's transpose,
    // scaled by w and split into hi + lo
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, ku + swz(16 * kk + (lane & 7) +
                                        ((lane >> 4) & 1) * 8,
                                    2 * warp + ((lane >> 3) & 1)));
      const float* w = Wl + i * 64 + 16 * kk + 2 * t4;
      scale_split(a[0], w[0], w[1], hi[kk][0], lo[kk][0], nsum[0]);
      scale_split(a[1], w[0], w[1], hi[kk][1], lo[kk][1], nsum[1]);
      scale_split(a[2], w[8], w[9], hi[kk][2], lo[kk][2], nsum[0]);
      scale_split(a[3], w[8], w[9], hi[kk][3], lo[kk][3], nsum[1]);
    }
    // acc += hi @ V + lo @ V, V [key][dv] MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_64x64x16_rs<1>(acc, hi[kk], desc_mn(vu, kk));
      wgmma_64x64x16_rs<1>(acc, lo[kk], desc_mn(vu, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
  }
  cp_async_wait<0>();

  const long long row0 = (bh * nc + c) * dkp + d0 + 16 * warp + g;
  float* out = sc.dC + row0 * dvp + e0;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + 8 * r * dvp + 8 * n + 2 * t4) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the 4 lanes of a row hold its key parts
    nsum[r] += __shfl_xor_sync(0xffffffffu, nsum[r], 1);
    nsum[r] += __shfl_xor_sync(0xffffffffu, nsum[r], 2);
  }
  if (et == 0 && t4 == 0) {
    sc.dn[row0] = nsum[0];
    sc.dn[row0 + 8] = nsum[1];
  }
}

// (b) the pass over states, in chunk order from (C0, n0): C_prev[c] =
// running (stored in bf16, the B operand of pass (c)), running =
// exp(total_c) running + dC_c; n alike in fp32.  Four elements of the
// padded [dkp][dvp] plane a thread; the first block of each b*h also walks
// n.  The last running state is (c_out, n_out).
constexpr int PASS_THREADS = 256;

__global__ void __launch_bounds__(PASS_THREADS)
ssd_state_pass_kernel(Scratch sc, const float* __restrict__ c0,
                      const float* __restrict__ n0,
                      float* __restrict__ c_out, float* __restrict__ n_out,
                      int nc, int dk, int dv, int dkp, int dvp,
                      int blocks_per_bh) {
  const long long bh = blockIdx.x / blocks_per_bh;
  const int blk = blockIdx.x % blocks_per_bh;
  const long long plane = (long long)dkp * dvp;
  const float* tot = sc.tot + bh * nc;
  const int i4 = (blk * PASS_THREADS + threadIdx.x) * 4;
  if (i4 < plane) {
    const int d = i4 / dvp, e = i4 % dvp;  // 4 elements of one row
    float r[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      r[u] = (c0 != nullptr && d < dk && e + u < dv)
                 ? c0[(bh * dk + d) * dv + e + u]
                 : 0.f;
    for (int c = 0; c < nc; ++c) {
      const long long o = (bh * nc + c) * plane + i4;
      uint2 packed;
      packed.x = pack_bf16x2(r[0], r[1]);
      packed.y = pack_bf16x2(r[2], r[3]);
      *reinterpret_cast<uint2*>(sc.cprev + o) = packed;
      const float f = expf(tot[c]);
      const float4 x = *reinterpret_cast<const float4*>(sc.dC + o);
      r[0] = f * r[0] + x.x;
      r[1] = f * r[1] + x.y;
      r[2] = f * r[2] + x.z;
      r[3] = f * r[3] + x.w;
    }
    if (d < dk)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (e + u < dv) c_out[(bh * dk + d) * dv + e + u] = r[u];
  }
  if (blk == 0)
    for (int d = threadIdx.x; d < dkp; d += PASS_THREADS) {
      float r = (n0 != nullptr && d < dk) ? n0[bh * dk + d] : 0.f;
      for (int c = 0; c < nc; ++c) {
        const long long o = (bh * nc + c) * dkp + d;
        sc.nprev[o] = r;
        r = expf(tot[c]) * r + sc.dn[o];
      }
      if (d < dk) n_out[bh * dk + d] = r;
    }
}

// (c) the outputs.  One CTA per (b*h, chunk, 64-row tile, 64-column dv
// tile), the row tiles with the most key tiles first.  Q's 64 rows stay in
// shared memory (dkp / 64 swizzled tiles) beside the chunk's gates from
// pass (a); C_prev's dk slices, then for each key tile up to the diagonal
// its K dk slices and its V tile stream through a STAGES-deep cp.async
// ring of 64 x 64 tiles.  Warp w owns rows 16w..16w+15: acc = exp(Bc_t) (Q
// @ C_prev) on the tensor cores (the row scale in fp32 after the product),
// then per key tile S = Q K^T, P = S * decay in fp32 registers, P's row
// sums in fp32, and acc += bf16(P) @ V; on the diagonal tile a warp skips
// the key blocks past its rows.  The decay exp(Bc_t - Bc_j + li_j) is
// exp(Bc_t - Bc_jb) times the key factor exp(Bc_jb - Bc_j + li_j) (jb the
// tile's first key) when the tile's keys span at most MAX_SPAN in Bc, so
// neither factor overflows (the row factor is <= 1, the key factor <=
// e^64); else it is taken element by element and masked BEFORE the exp.
// normalize divides by max(|exp(Bc_t) q_t . n_prev + row sum|, eps), q .
// n_prev in fp32 from the shared Q.
__global__ void __launch_bounds__(NT, 4)
ssd_outputs_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, Scratch sc,
                   __nv_bfloat16* __restrict__ y, long long BH, int H, int S,
                   int dk, int dv, int chunk, int nc, int nrt, int ndk,
                   int ndv, int normalize, float eps, int wide, Strides st) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int ns = ndk, dkp = ndk * 64, dvp = ndv * 64, cp = pad64(chunk);
  unsigned char* Qs = smem;
  unsigned char* ring = smem + ns * TILE_BYTES;
  float* Bc = reinterpret_cast<float*>(ring + STAGES * TILE_BYTES);
  float* Bj = Bc + cp;  // Bc - log_i
  float* Kf = Bj + cp;  // key factors
  float* qn = Kf + cp;

  long long id = blockIdx.x;
  const long long per_rt = BH * nc * ndv;
  const int rt = nrt - 1 - static_cast<int>(id / per_rt);
  id %= per_rt;
  const int et = static_cast<int>(id % ndv);
  id /= ndv;
  const int c = static_cast<int>(id % nc);
  const long long bh = id / nc;
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  const int cs = c * chunk, nv = min(chunk, S - cs), tb = rt * 64;
  if (tb >= nv) return;  // the last chunk is short
  const int e0 = et * 64, rows = min(64, nv - tb);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long long sq = st.q[1], sk = st.k[1], sv = st.v[1];
  const __nv_bfloat16* qc =
      q + b * st.q[0] + h * st.q[2] + (long long)(cs + tb) * sq;
  const __nv_bfloat16* kc =
      k + b * st.k[0] + h * st.k[2] + (long long)cs * sk;
  const __nv_bfloat16* vc =
      v + b * st.v[0] + h * st.v[2] + (long long)cs * sv + e0;
  const __nv_bfloat16* cpv = sc.cprev + (bh * nc + c) * dkp * dvp + e0;
  const int n_tiles = ns + (rt + 1) * (ns + 1);

  // tile i of the stream: C_prev slices 0..ns-1, then per key tile jt its
  // K slices 0..ns-1 and its V tile
  auto issue = [&](int i) {
    if (i < n_tiles) {
      unsigned char* slot = ring + (i % STAGES) * TILE_BYTES;
      if (i < ns) {
        load_tile(slot, cpv + (long long)i * 64 * dvp, dvp, 64, 64, true);
      } else {
        const int jt = (i - ns) / (ns + 1), s = (i - ns) % (ns + 1);
        const int keys = nv - 64 * jt;
        if (s < ns)
          load_tile(slot, kc + (long long)64 * jt * sk + 64 * s, sk, keys,
                    dk - 64 * s, wide);
        else
          load_tile(slot, vc + (long long)64 * jt * sv, sv, keys, dv - e0,
                    wide);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < ns; ++s)
    load_tile(Qs + s * TILE_BYTES, qc + 64 * s, sq, rows, dk - 64 * s, wide);
  {  // the gates of keys and rows [0, tb + 64), 16 bytes a copy
    const float* gt = sc.gates + (bh * nc + c) * 3 * cp;
    const int n4 = (tb + 64) / 4;
    for (int i = threadIdx.x; i < 3 * n4; i += NT) {
      const int a = i / n4, o = 4 * (i % n4);
      cp_async16(smem_u32(Bc + a * cp + o), gt + a * cp + o, 16);
    }
  }
  cp_async_commit();
  for (int i = 0; i < STAGES - 1; ++i) issue(i);

  float acc[8][4], sacc[8][4];
  float rs[2] = {0.f, 0.f}, bct[2], gr[2];
  int trow[2];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = sacc[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // tile i (and Q, gates) landed; i-1's slot is free
    issue(i + STAGES - 1);
    if (i == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // this thread's rows: g, g + 8
        trow[r] = tb + 16 * warp + g + 8 * r;
        bct[r] = trow[r] < nv ? Bc[trow[r]] : 0.f;
        gr[r] = trow[r] < nv ? expf(bct[r]) : 0.f;
      }
    }
    const uint32_t tile = smem_u32(ring + (i % STAGES) * TILE_BYTES);
    if (i < ns) {
      // acc += Q[:, slice i] @ C_prev[slice i, tile] (C_prev [d][dv]:
      // MN-major)
      const uint32_t qs = smem_u32(Qs + i * TILE_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_64x64x16_ss<1>(acc, desc_k(qs, kk), desc_mn(tile, kk));
      wgmma_commit();
      wgmma_wait<0>();
      if (i == ns - 1)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          acc[n][0] *= gr[0];
          acc[n][1] *= gr[0];
          acc[n][2] *= gr[1];
          acc[n][3] *= gr[1];
        }
      continue;
    }
    const int jt = (i - ns) / (ns + 1), s = (i - ns) % (ns + 1);
    if (s < ns) {
      // sacc += Q[:, slice s] @ K[key tile jt, slice s]^T (K [key][d]:
      // K-major)
      const uint32_t qs = smem_u32(Qs + s * TILE_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_64x64x16_ss<0>(sacc, desc_k(qs, kk), desc_k(tile, kk));
      wgmma_commit();
      wgmma_wait<0>();
      if (s < ns - 1) continue;
      const int jb = 64 * jt;
      const bool edge = jt == rt || tb + 64 > nv;
      if (Bc[jb] - Bc[min(jb + 63, nv - 1)] <= MAX_SPAN) {
        float rowf[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          rowf[r] = trow[r] < nv ? expf(bct[r] - Bc[jb]) : 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int j = jb + 8 * n + 2 * t4;
          const float2 kf = *reinterpret_cast<const float2*>(Kf + j);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            float p = sacc[n][e] * rowf[r] * ((e & 1) ? kf.y : kf.x);
            if (edge && !(trow[r] < nv && j + (e & 1) <= trow[r])) p = 0.f;
            sacc[n][e] = p;
            rs[r] += p;
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, j = jb + 8 * n + 2 * t4 + (e & 1);
            float p = 0.f;
            // mask first: above the diagonal the gap is positive
            if (!edge || (trow[r] < nv && j <= trow[r]))
              p = sacc[n][e] * expf(bct[r] - Bj[j]);
            sacc[n][e] = p;
            rs[r] += p;
          }
      }
      continue;
    }
    // acc += bf16(P) @ V[key tile jt]: P's accumulator fragments are the A
    // fragments (keys 16kk..16kk+15 are n-tiles 2kk and 2kk+1); V [key][dv]
    // MN-major
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pf[kk][0] = pack_bf16x2(sacc[2 * kk][0], sacc[2 * kk][1]);
      pf[kk][1] = pack_bf16x2(sacc[2 * kk][2], sacc[2 * kk][3]);
      pf[kk][2] = pack_bf16x2(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
      pf[kk][3] = pack_bf16x2(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_64x64x16_rs<1>(acc, pf[kk], desc_mn(tile, kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
  }
  cp_async_wait<0>();

  if (normalize) {
    // q_t . n_prev in fp32: two threads a row, each every other 16-byte
    // chunk of it (Q and n_prev are zero past dk)
    const float* np_ = sc.nprev + (bh * nc + c) * dkp;
    const int r = threadIdx.x >> 1;
    float s = 0.f;
    for (int ch = threadIdx.x & 1; ch < dkp / 8; ch += 2) {
      const uint4 x = *reinterpret_cast<const uint4*>(
          Qs + (ch >> 3) * TILE_BYTES + swz(r, ch & 7));
      const __nv_bfloat162* qp = reinterpret_cast<const __nv_bfloat162*>(&x);
      const float4* nq = reinterpret_cast<const float4*>(np_ + 8 * ch);
      const float4 n0 = nq[0], n1 = nq[1];
      s += __low2float(qp[0]) * n0.x + __high2float(qp[0]) * n0.y +
           __low2float(qp[1]) * n0.z + __high2float(qp[1]) * n0.w +
           __low2float(qp[2]) * n1.x + __high2float(qp[2]) * n1.y +
           __low2float(qp[3]) * n1.z + __high2float(qp[3]) * n1.w;
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if ((threadIdx.x & 1) == 0) qn[r] = s;
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float x = rs[rr];  // the 4 threads of a row hold its parts
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      const float inv =
          1.f / fmaxf(fabsf(gr[rr] * qn[16 * warp + g + 8 * rr] + x), eps);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[n][2 * rr] *= inv;
        acc[n][2 * rr + 1] *= inv;
      }
    }
  }

  const int ne = min(64, dv - e0);
  const long long ys = (long long)H * dv;  // y is [B,S,H,dv], contiguous
  __nv_bfloat16* yb = y + ((long long)b * S + cs) * ys + (long long)h * dv + e0;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (trow[rr] >= nv) continue;
    __nv_bfloat16* yr = yb + (long long)trow[rr] * ys;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int e = 8 * n + 2 * t4;
      if (e + 1 < ne && (dv & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(yr + e) =
            __floats2bfloat162_rn(acc[n][2 * rr], acc[n][2 * rr + 1]);
      } else {
        if (e < ne) yr[e] = __float2bfloat16(acc[n][2 * rr]);
        if (e + 1 < ne) yr[e + 1] = __float2bfloat16(acc[n][2 * rr + 1]);
      }
    }
  }
}

int outputs_smem(int dk, int chunk) {
  return 1024 + (pad64(dk) / 64 + STAGES) * TILE_BYTES +
         (3 * pad64(chunk) + 64) * 4;
}

int states_smem(int chunk) {
  return 1024 + A_STAGES * 2 * TILE_BYTES + 2 * pad64(chunk) * 4;
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lf, const void* li, const void* c0,
                   const void* n0, void* y, void* c_out, void* n_out, int B,
                   int H, int S, int dk, int dv, int chunk, int normalize,
                   float eps, int wide, const Strides& st, void* scratch,
                   long long scratch_bytes, cudaStream_t stream) {
  const long long BH = (long long)B * H;
  const int nc = (S + chunk - 1) / chunk, ndk = pad64(dk) / 64,
            ndv = pad64(dv) / 64, nrt = pad64(chunk) / 64;
  const int dkp = ndk * 64, dvp = ndv * 64;
  Scratch sc;
  if (scratch == nullptr ||
      scratch_layout(BH, nc, dkp, dvp, pad64(chunk),
                     static_cast<unsigned char*>(scratch),
                     &sc) > scratch_bytes)
    return cudaErrorInvalidValue;
  const long long grid_a = BH * nc * ndk * ndv, grid_c = BH * nc * nrt * ndv;
  const int blocks_per_bh = (dkp * dvp / 4 + PASS_THREADS - 1) / PASS_THREADS;
  const long long grid_b = BH * blocks_per_bh;
  if (grid_a > 0x7fffffffLL || grid_b > 0x7fffffffLL ||
      grid_c > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int smem_a = states_smem(chunk), smem_c = outputs_smem(dk, chunk);
  static SmemOptIn opt_in_a, opt_in_c;
  cudaError_t e;
  if (smem_a > 48 * 1024 &&
      (e = opt_in_a(ssd_local_states_kernel)) != cudaSuccess)
    return e;
  if (smem_c > 48 * 1024 && (e = opt_in_c(ssd_outputs_kernel)) != cudaSuccess)
    return e;
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  ssd_local_states_kernel<<<(unsigned)grid_a, NT, smem_a, stream>>>(
      kb, vb, static_cast<const float*>(lf), static_cast<const float*>(li),
      sc, H, S, dk, dv, chunk, nc, ndk, ndv, wide, st);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_state_pass_kernel<<<(unsigned)grid_b, PASS_THREADS, 0, stream>>>(
      sc, static_cast<const float*>(c0), static_cast<const float*>(n0),
      static_cast<float*>(c_out), static_cast<float*>(n_out), nc, dk, dv,
      dkp, dvp, blocks_per_bh);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_outputs_kernel<<<(unsigned)grid_c, NT, smem_c, stream>>>(
      qb, kb, vb, sc, static_cast<__nv_bfloat16*>(y), BH, H, S, dk, dv,
      chunk, nc, nrt, ndk, ndv, normalize, eps, wide, st);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q, k: [B,S,H,dk] and v: [B,S,H,dv] in one dtype (fp32 or bf16), unit
// stride along the last dim, other strides in `strides` (15 int64: batch,
// seq, head for q, k, v, log_f, log_i); log_f, log_i: [B,S,H] fp32.
// c0 [B,H,dk,dv] / n0 [B,H,dk] fp32 contiguous, or both null (zero state).
// Out: y [B,S,H,dv] contiguous in v's dtype, c_out [B,H,dk,dv] and n_out
// [B,H,dk] fp32 contiguous.  1 <= dk, dv <= 512; 1 <= chunk <= 1024 (the
// wrapper passes min(chunk, S)); S >= 1.  A larger state is refused.
// bf16 only: `wide` = 1 when every row start of q, k, v is 16-byte aligned,
// 0 when 4-byte aligned with dk and dv even (the wrapper checks pointers
// and strides); `scratch` holds at least the ssd_scan_scratch_bytes of
// these sizes (the fp32 route takes none: null, 0).
// The scratch bytes a bf16 call of these sizes needs (chunk as passed to
// ssd_scan_fwd) into *bytes; returns cudaErrorInvalidValue for sizes
// ssd_scan_fwd refuses.
REPRO_EXPORT int ssd_scan_scratch_bytes(int B, int H, int S, int dk, int dv,
                                        int chunk, long long* bytes) {
  if (B < 1 || H < 1 || S < 1 || chunk < 1) return cudaErrorInvalidValue;
  *bytes = tc::scratch_layout((long long)B * H, (S + chunk - 1) / chunk,
                              tc::pad64(dk), tc::pad64(dv), tc::pad64(chunk),
                              nullptr, nullptr);
  return cudaSuccess;
}

REPRO_EXPORT int ssd_scan_fwd(const void* q, const void* k, const void* v,
                              const void* lf, const void* li, const void* c0,
                              const void* n0, void* y, void* c_out,
                              void* n_out, int B, int H, int S, int dk, int dv,
                              int chunk, int normalize, float eps, int dtype,
                              const void* strides, int wide, void* scratch,
                              long long scratch_bytes, void* stream) {
  if (B < 1 || H < 1 || S < 1 || chunk < 1 || chunk > kMaxChunk)
    return cudaErrorInvalidValue;
  if (dk < 1 || dk > kMaxDim || dv < 1 || dv > kMaxDim)
    return cudaErrorInvalidValue;
  if ((long long)B * H > 0x7fffffffLL) return cudaErrorInvalidValue;
  Strides st;
  memcpy(&st, strides, sizeof st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return simt::launch<float>(q, k, v, lf, li, c0, n0, y, c_out, n_out, B,
                               H, S, dk, dv, chunk, normalize, eps, st, s);
  if (dtype == kBF16)
    return static_cast<int>(tc::launch(
        q, k, v, lf, li, c0, n0, y, c_out, n_out, B, H, S, dk, dv, chunk,
        normalize, eps, wide, st, scratch, scratch_bytes, s));
  return cudaErrorInvalidValue;
}
