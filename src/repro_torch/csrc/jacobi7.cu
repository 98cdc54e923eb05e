// 7-point 3D Jacobi, T valid-mode sweeps per residency, for Hopper (sm_90a).
//
// Replaces: repro/kernels/jacobi7.py::_wavefront_kernel (the Pallas TPU
// kernel behind jacobi7_wavefront, and jacobi7_naive with T = 1): each
// sweep maps [X,Y,Z] -> [X-2,Y-2,Z-2] with
//   out = omega * (x-1 + x+1 + y-1 + y+1 + z-1 + z+1),
// summed in that order in fp32, so results equal the plain PyTorch sweep
// bit for bit, whatever the tile.
//
// What bounds it on this card: memory for one sweep, shared memory for
// several.  A sweep does 6 FLOPs per point against 8 bytes moved, so T
// sweeps fused do 6T FLOPs for the same 8 bytes: at T = 4 and 512^3 the
// bytes read once take ~0.31 ms at 3.35 TB/s, the FLOPs ~0.05 ms at the
// 67 TFLOP/s fp32 peak.  What the fusion costs instead is shared-memory
// traffic (each level's plane is stored and read back for its y and z
// neighbours) and the registers that hold the levels' planes.
//
// Its design: 2.5D blocking (Datta et al.), the GPU form of the paper's
// wavefront.  A CTA owns an output column: bx points along x and a by x bz
// tile in y-z.  It walks its input box, (ex+2T) x (ey+2T) x (ez+2T) for
// the column's true extents e (edge columns are short), plane by plane
// along x.  Input planes arrive by cp.async into a ring of kRing slots,
// kRing - 3 of them in flight while the compute reads the others (16-byte
// copies when z rows start 16-byte aligned, 4-byte copies otherwise, never
// past the box).  Every plane has the box's y-z layout, rows padded to a
// multiple of 4 floats, and each thread owns one 4-point chunk of it for
// the whole walk.  When input plane p has landed, level s = 1..T computes
// its plane p - 2s over the points at least s from the box's edge (each
// level's plane shrinks by one point a side).  The thread keeps its chunk
// of every level's last three planes in registers (the input's as it
// lands, the others as it computes them), so x-1, x and x+1 of level s-1
// cost no load; z+-1 past the chunk's ends come from the neighbouring
// lanes by shuffles, and y+-1 from level s-1's previous plane in shared
// memory (two 16-byte loads for 4 points).  Levels 1..T-1 store their
// plane in one of two shared buffers, the one the next level does not
// read this step, so every level of a step reads only what the previous
// step wrote: one __syncthreads() a step.  Level T stores its plane
// straight to HBM: from each chunk when every output row of a column is
// whole 32-byte sectors, else transposed across the warp through a free
// ring slot so that each store instruction writes 32 consecutive floats.
// A CTA reads each point of its box exactly once (the halo is paid in y-z
// and as 2T planes a column along x, which is what the wrapper's
// kernel_bytes counts), and its shared memory, kRing + 2 (T-1) planes,
// does not depend on bx.  Above 48 KiB it takes the dynamic shared-memory
// opt-in, set once per device; a y-z tile whose planes do not fit 227 KiB,
// or whose plane has more 4-point chunks than a block has threads, is
// refused, not shrunk.
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kRing = 6;           // input planes in the shared ring
constexpr int kMaxThreads = 1024;  // one thread a 4-point chunk of a plane

// row pitch of every plane, in floats (16-byte aligned rows)
__host__ __device__ inline int plane_pitch(int T, int bz) {
  return (bz + 2 * T + 3) / 4 * 4;
}

// Issue the copies of one input plane of the box into `dst`: ly rows of
// lz floats, row j at dst + j * pitch.
__device__ __forceinline__ void fetch_plane(float* dst, const float* src,
                                            int ly, int lz, int pitch,
                                            int Z, bool vec) {
  if (vec) {
    const int vpr = (lz + 3) / 4;
    for (int idx = threadIdx.x; idx < ly * vpr; idx += blockDim.x) {
      const int j = idx / vpr, v = 4 * (idx - j * vpr);
      cp_async16(smem_u32(dst + j * pitch + v), src + (int64_t)j * Z + v,
                 4 * min(4, lz - v));
    }
  } else {
    for (int idx = threadIdx.x; idx < ly * lz; idx += blockDim.x) {
      const int j = idx / lz, k = idx - j * lz;
      cp_async4(dst + j * pitch + k, src + (int64_t)j * Z + k);
    }
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One level's 4 points: xm, mid and xp are level s-1's values at the
// chunk at x-1, x and x+1; ym and yp its neighbour chunks at y-1 and y+1,
// zl and zr its points just past the chunk's ends along z.  Summed in the
// plain sweep's order.
__device__ __forceinline__ float4 sweep4(float4 xm, float4 xp, float4 mid,
                                         float4 ym, float4 yp, float zl,
                                         float zr, float omega) {
  float4 v;
  v.x = ((((xm.x + xp.x) + ym.x) + yp.x) + zl) + mid.y;
  v.y = ((((xm.y + xp.y) + ym.y) + yp.y) + mid.x) + mid.z;
  v.z = ((((xm.z + xp.z) + ym.z) + yp.z) + mid.y) + mid.w;
  v.w = ((((xm.w + xp.w) + ym.w) + yp.w) + mid.z) + zr;
  v.x *= omega;
  v.y *= omega;
  v.z *= omega;
  v.w *= omega;
  return v;
}

template <int T, bool DIRECT>
__global__ void __launch_bounds__(kMaxThreads)
jacobi7_kernel(const float* __restrict__ x, float* __restrict__ out, int X,
               int Y, int Z, float omega, int bx, int by, int bz, int pitch,
               int plane, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                       // kRing input planes
  float* levels = smem + kRing * plane;     // levels 1..T-1, 2 planes each
  const int OX = X - 2 * T, OY = Y - 2 * T, OZ = Z - 2 * T;
  const int ox0 = blockIdx.z * bx, oy0 = blockIdx.y * by,
            oz0 = blockIdx.x * bz;
  // this column's box: its true output extent plus a halo of T a side
  const int LX = min(bx, OX - ox0) + 2 * T, LY = min(by, OY - oy0) + 2 * T,
            LZ = min(bz, OZ - oz0) + 2 * T;
  const float* box = x + ((int64_t)ox0 * Y + oy0) * Z + oz0;
  const int64_t in_plane = (int64_t)Y * Z;
  // this thread's chunk: row jr of the box, points [kz, kz + 4) of it, at
  // c = 4 * threadIdx.x of every plane (rows are 4-point aligned), so the
  // chunks of neighbouring lanes are neighbours along z
  const int cpr = pitch / 4;
  const int jr = threadIdx.x / cpr, kz = 4 * (threadIdx.x - jr * cpr);
  const int c = min(4 * (int)threadIdx.x, plane - 4);  // idle threads: clamp
  const int lane = threadIdx.x % 32;
  // level s computes the chunk when it meets the points >= s from the edge
  bool live[T + 1];
#pragma unroll
  for (int s = 1; s <= T; ++s)
    live[s] = jr >= s && jr < LY - s && kz + 4 > s && kz < LZ - s;
  // Level T's points go to HBM straight from the chunk when every CTA's
  // output rows are whole 32-byte sectors (DIRECT); else transposed
  // through the warp's share of a ring slot no step reads now, so a store
  // instruction covers 32 consecutive points: the warp holds the 128
  // consecutive points from 128 * warp, and in round q lane l stores point
  // 128 * warp + 32 q + l (at out_off[q]) if it lies inside level T's
  // domain (bit q of `inside`).
  const int64_t out_plane = (int64_t)OY * OZ;
  float* obox = out + ((int64_t)ox0 * OY + oy0) * OZ + oz0;
  int out_off[DIRECT ? 1 : 4];
  unsigned inside = 0;
  if (DIRECT) {
    out_off[0] = (jr - T) * OZ + kz - T;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int f = 128 * (threadIdx.x / 32) + 32 * q + lane;
      const int j = f / pitch, z = f - j * pitch;
      out_off[q] = (j - T) * OZ + z - T;
      if (j >= T && j < LY - T && z >= T && z < LZ - T) inside |= 1u << q;
    }
  }

  auto fetch = [&](int p) {
    fetch_plane(ring + (p % kRing) * plane, box + p * in_plane, LY, LZ, pitch,
                Z, vec);
  };
  // level s's values at the chunk two steps ago, one step ago and at this
  // step (level 0: the input planes p-2, p-1 and p)
  float4 prev2[T], prev1[T], now[T];

  for (int p = 0; p < kRing - 3; ++p) {
    if (p < LX) fetch(p);
    cp_async_commit();
  }
  for (int p = 0; p < LX; ++p) {
    cp_async_wait<kRing - 4>();          // plane p has landed ...
    __syncthreads();                     // ... for every thread; the last
                                         // step's planes are written and
                                         // read
    if (p + kRing - 3 < LX) fetch(p + kRing - 3);
    cp_async_commit();
    now[0] = lds4(ring + (p % kRing) * plane + c);
#pragma unroll
    for (int s = 1; s <= T; ++s) {
      const int i = p - 2 * s;           // level s's plane at this step
      if (i < 0) continue;               // (the same for the whole CTA)
      // level s-1's plane i+1: the chunk's own values, its neighbours'
      // along z from the lanes beside it (the warp's end lanes read them)
      const float* ctr = s == 1
          ? ring + ((i + 1) % kRing) * plane
          : levels + (2 * (s - 2) + ((i + 1) & 1)) * plane;
      const float4 mid = prev1[s - 1];
      float zl = __shfl_up_sync(0xffffffffu, mid.w, 1);
      float zr = __shfl_down_sync(0xffffffffu, mid.x, 1);
      float4 v = mid;                    // (unused where not live)
      if (live[s]) {
        if (lane == 0) zl = ctr[c - 1];
        if (lane == 31) zr = ctr[c + 4];
        v = sweep4(prev2[s - 1], now[s - 1], mid, lds4(ctr + c - pitch),
                   lds4(ctr + c + pitch), zl, zr, omega);
        if (s < T) {
          *reinterpret_cast<float4*>(
              levels + (2 * (s - 1) + (i & 1)) * plane + c) = v;
          now[s] = v;
        }
      }
      if (s == T) {
        float* o = obox + i * out_plane;
        if (DIRECT) {
          if (!live[T]) continue;
          o += out_off[0];
          // with T a multiple of 4 the chunk is 16-byte aligned in `out`
          if (T % 4 == 0 && kz >= T && kz + 3 < LZ - T) {
            *reinterpret_cast<float4*>(o) = v;
            continue;
          }
          if (kz >= T && kz < LZ - T) o[0] = v.x;
          if (kz + 1 >= T && kz + 1 < LZ - T) o[1] = v.y;
          if (kz + 2 >= T && kz + 2 < LZ - T) o[2] = v.z;
          if (kz + 3 >= T && kz + 3 < LZ - T) o[3] = v.w;
        } else {                         // plane p-2's slot is free now
          float* t = ring + ((p + kRing - 2) % kRing) * plane +
                     128 * (threadIdx.x / 32);
          if (4 * (int)threadIdx.x < plane)   // not past the slot
            *reinterpret_cast<float4*>(t + 4 * lane) = v;
          __syncwarp();
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (inside >> q & 1u) o[out_off[q]] = t[32 * q + lane];
        }
      }
    }
#pragma unroll
    for (int s = 0; s < T; ++s) {
      prev2[s] = prev1[s];
      prev1[s] = now[s];
    }
  }
}

// Shared-memory bytes of one CTA (the wrapper's twin: jacobi7.py::
// smem_footprint); -1 when they do not fit a block.
long long smem_bytes(int T, int by, int bz, int* plane) {
  *plane = (by + 2 * T) * plane_pitch(T, bz);
  const long long bytes =
      (long long)(kRing + 2 * (T - 1)) * *plane * (long long)sizeof(float);
  return bytes > kMaxSmemOptIn ? -1 : bytes;
}

template <int T>
cudaError_t launch(const float* x, float* out, int X, int Y, int Z,
                   float omega, int bx, int by, int bz, cudaStream_t st) {
  const int OX = X - 2 * T, OY = Y - 2 * T, OZ = Z - 2 * T;
  if (OX < 1 || OY < 1 || OZ < 1) return cudaErrorInvalidValue;
  int plane = 0;
  const long long bytes = smem_bytes(T, by, bz, &plane);
  const int pitch = plane_pitch(T, bz);
  const int chunks = (by + 2 * T) * (pitch / 4);   // one thread each
  if (bytes < 0 || chunks > kMaxThreads) return cudaErrorInvalidValue;
  const dim3 grid((OZ + bz - 1) / bz, (OY + by - 1) / by, (OX + bx - 1) / bx);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  // 16-byte copies need every box row to start 16-byte aligned; stores
  // go straight out when every output row of a column is whole sectors
  const bool vec = Z % 4 == 0 && bz % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool direct = OZ % 8 == 0 && bz % 8 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 32 == 0;
  auto kernel = direct ? jacobi7_kernel<T, true> : jacobi7_kernel<T, false>;
  static SmemOptIn opt_in[2];
  if (bytes > 48 * 1024) {
    const cudaError_t e = opt_in[direct](kernel);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, (chunks + 31) / 32 * 32, (size_t)bytes, st>>>(
      x, out, X, Y, Z, omega, bx, by, bz, pitch, plane, vec);
  return cudaGetLastError();
}

}  // namespace

// x: [X,Y,Z] fp32 contiguous; out: [X-2T, Y-2T, Z-2T] fp32 contiguous;
// 1 <= T <= 8 sweeps; output tile (bx, by, bz): bx points a column along
// x, a by x bz tile in y-z.  The wrapper checks that every output extent
// is >= 1 and that the tile fits (smem_footprint, block_threads).
REPRO_EXPORT int jacobi7_fwd(const void* x, void* out, int X, int Y, int Z,
                             int T, float omega, int bx, int by, int bz,
                             void* stream) {
  if (bx < 1 || by < 1 || bz < 1) return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 1: return launch<1>(xf, of, X, Y, Z, omega, bx, by, bz, st);
    case 2: return launch<2>(xf, of, X, Y, Z, omega, bx, by, bz, st);
    case 3: return launch<3>(xf, of, X, Y, Z, omega, bx, by, bz, st);
    case 4: return launch<4>(xf, of, X, Y, Z, omega, bx, by, bz, st);
    case 5: return launch<5>(xf, of, X, Y, Z, omega, bx, by, bz, st);
    case 6: return launch<6>(xf, of, X, Y, Z, omega, bx, by, bz, st);
    case 7: return launch<7>(xf, of, X, Y, Z, omega, bx, by, bz, st);
    case 8: return launch<8>(xf, of, X, Y, Z, omega, bx, by, bz, st);
    default: return cudaErrorInvalidValue;
  }
}
