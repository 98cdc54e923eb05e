// 7-point 3D Jacobi, T valid-mode sweeps per residency, for Hopper (sm_90a).
//
// Replaces: repro/kernels/jacobi7.py::_wavefront_kernel (the Pallas TPU
// kernel behind jacobi7_wavefront, and jacobi7_naive with T = 1): each
// sweep maps [X,Y,Z] -> [X-2,Y-2,Z-2] with
//   out = omega * (x-1 + x+1 + y-1 + y+1 + z-1 + z+1),
// summed in that order in fp32, so results equal the plain PyTorch sweep.
//
// What bounds it on this card: memory.  A sweep does 6 FLOPs per point
// against 8 bytes moved, so T sweeps fused do 6T FLOPs for the same 8
// bytes: at T = 4 and 512^3 the bytes take ~0.31 ms at 3.35 TB/s, the
// FLOPs ~0.05 ms at the 67 TFLOP/s fp32 peak.  That is the point of
// temporal blocking (paper §IV-V): T sweeps for one trip to HBM.
//
// Its design: the TPU kernel keeps an x-slab of whole Y-Z planes in VMEM;
// a 512^2 plane is 1 MiB, far over the 227 KiB a block may have, so here
// one CTA owns one output tile (bx, by, bz), loads the (bx+2T, by+2T,
// bz+2T) input tile into shared memory (coalesced along z), and runs the
// T sweeps there, ping-ponging between two buffers whose valid region
// shrinks by one point per side per sweep, with a __syncthreads() between
// sweeps; the last sweep writes straight to HBM.  Halos are re-read by
// neighbouring tiles and recomputed inside each tile: the price of
// independence between CTAs (the HBM bytes with halos are the wrapper's
// kernel_bytes).  Edge tiles of a ragged output use their true extents, so
// no point outside the input is read and results do not depend on the
// tile.  Buffers above 48 KiB need the dynamic shared-memory opt-in; a
// tile whose two buffers do not fit 227 KiB is refused, not shrunk.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmem = 232448;   // 227 KiB, the opt-in limit per block

__global__ void __launch_bounds__(kThreads)
jacobi7_kernel(const float* __restrict__ x, float* __restrict__ out, int X,
               int Y, int Z, int T, float omega, int bx, int by, int bz,
               int buf_b_offset) {
  extern __shared__ float smem[];
  float* bufs[2] = {smem, smem + buf_b_offset};
  const int OY = Y - 2 * T, OZ = Z - 2 * T, OX = X - 2 * T;
  const int ox0 = blockIdx.z * bx, oy0 = blockIdx.y * by,
            oz0 = blockIdx.x * bz;
  // this tile's true output extent (edge tiles are smaller)
  const int ex = min(bx, OX - ox0), ey = min(by, OY - oy0),
            ez = min(bz, OZ - oz0);

  // load the input tile [ex+2T, ey+2T, ez+2T] into buffer 0
  {
    const int lx = ex + 2 * T, ly = ey + 2 * T, lz = ez + 2 * T;
    const int total = lx * ly * lz;
    for (int idx = threadIdx.x; idx < total; idx += kThreads) {
      const int k = idx % lz, rest = idx / lz;
      const int j = rest % ly, i = rest / ly;
      bufs[0][idx] =
          x[((int64_t)(ox0 + i) * Y + (oy0 + j)) * Z + (oz0 + k)];
    }
  }
  __syncthreads();

  for (int s = 1; s <= T; ++s) {
    const float* src = bufs[(s - 1) & 1];
    float* dst = bufs[s & 1];
    // destination extent after sweep s; source pitch is 2 larger
    const int dx = ex + 2 * (T - s), dy = ey + 2 * (T - s),
              dz = ez + 2 * (T - s);
    const int sy = dy + 2, sz = dz + 2, plane = sy * sz;
    const int total = dx * dy * dz;
    const bool last = s == T;
    for (int idx = threadIdx.x; idx < total; idx += kThreads) {
      const int k = idx % dz, rest = idx / dz;
      const int j = rest % dy, i = rest / dy;
      const int c = ((i + 1) * sy + (j + 1)) * sz + (k + 1);
      float v = src[c - plane];
      v += src[c + plane];
      v += src[c - sz];
      v += src[c + sz];
      v += src[c - 1];
      v += src[c + 1];
      v *= omega;
      if (last)
        out[((int64_t)(ox0 + i) * OY + (oy0 + j)) * OZ + (oz0 + k)] = v;
      else
        dst[idx] = v;
    }
    __syncthreads();
  }
}

int smem_bytes(int T, int bx, int by, int bz, int* buf_b_offset) {
  const long long in = (long long)(bx + 2 * T) * (by + 2 * T) * (bz + 2 * T);
  const long long mid =
      T >= 2 ? (long long)(bx + 2 * T - 2) * (by + 2 * T - 2) *
                   (bz + 2 * T - 2)
             : 0;
  const long long bytes = (in + mid) * (long long)sizeof(float);
  if (bytes > kMaxSmem) return -1;
  *buf_b_offset = (int)in;
  return (int)bytes;
}

}  // namespace

// x: [X,Y,Z] fp32 contiguous; out: [X-2T, Y-2T, Z-2T] fp32 contiguous;
// T >= 1 sweeps; output tile (bx, by, bz).  The wrapper checks that every
// output extent is >= 1 and that the tile fits (smem_footprint).
REPRO_EXPORT int jacobi7_fwd(const void* x, void* out, int X, int Y, int Z,
                             int T, float omega, int bx, int by, int bz,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 1 || bx < 1 || by < 1 || bz < 1) return cudaErrorInvalidValue;
  const int OX = X - 2 * T, OY = Y - 2 * T, OZ = Z - 2 * T;
  if (OX < 1 || OY < 1 || OZ < 1) return cudaErrorInvalidValue;
  int off = 0;
  const int bytes = smem_bytes(T, bx, by, bz, &off);
  if (bytes < 0) return cudaErrorInvalidValue;
  const dim3 grid((OZ + bz - 1) / bz, (OY + by - 1) / by, (OX + bx - 1) / bx);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      jacobi7_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  jacobi7_kernel<<<grid, kThreads, bytes, st>>>(
      static_cast<const float*>(x), static_cast<float*>(out), X, Y, Z, T,
      omega, bx, by, bz, off);
  return static_cast<int>(cudaGetLastError());
}
