// Capped receptor field values on a rectilinear grid, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel openmmgridforce_tpu/ops/pallas_gridgen.py
// (_gen_kernel, entry generate_grid_values_pallas). For every grid point
// (flat index i*ny*nz + j*nz + k, position origin + (i, j, k) * spacing)
// it computes
//
//     cap * tanh(sum_a K_a * r_a^-p / cap),   p = 1 (charge), 12 (ljr), 6 (lja)
//
// with r^2 clamped at 1e-12 nm^2 and tanh saturated to +-1 for |u| > 20.
// The host computes the per-atom strength K (k q, sqrt(eps) Rmin^6 or
// -2 sqrt(eps) Rmin^3).
//
// Bound: operations, on the special-function (MUFU) pipe. The points of
// one z-column share dx, dy and dx^2 + dy^2 for an atom, so a point-atom
// pair needs dz, dz^2 + (dx^2 + dy^2), the clamp, one rsqrt (charge) or
// one reciprocal (ljr, lja: 1/r^2), the power (0 / 3 / 2 multiplies), the
// multiply by K and the add: 7 / 10 / 9 FP32 operations and one MUFU
// result. The main path's grids have about 1.5e6 points x 9133 atoms =
// 1.4e10 pairs. The MUFU pipe gives 16 results per SM per clock (4.2e12
// per second on the H100 SXM): 3.3 ms per grid, above the FP32 pipe's
// 1.4 - 2.0 ms at 67 TFLOP/s. The bytes (16 per atom in, 4 per point out)
// are negligible. What the kernel can reach is set by the instructions it
// issues, one per clock on each of the SM's four schedulers (3.3e13 per
// second on the card), against the MUFU pipe's one warp-wide result per 8
// clocks.
//
// Design.
// - Register tiling along z. A thread owns kPoints consecutive points of
//   one z-column (z is the fastest axis, so they are consecutive flat
//   indices). Per atom it loads (x, y, z, K) once, forms dx, dy and
//   dxy2 = fmaf(dy, dy, dx * dx) once, and then per point dz,
//   fmaf(dz, dz, dxy2), the clamp, the MUFU result, the power and one FMA
//   into the point's sum: 5 / 8 / 7 instructions a pair plus the shared 5
//   spread over the tile, where one point per thread paid 11 / 15 / 14.
//   The kPoints independent chains also hide the MUFU latency. The atom
//   loop is 6.5 / 9.5 / 8.5 instructions per pair in the machine code; on
//   an H100 SXM at 700 W a grid of the main path takes 4.1 / 4.7 / 4.3 ms
//   (one point per thread: 7.0 / 8.7 / 7.9 ms), 1.25 - 1.45x the bound.
//   Two points per thread are 11% slower than four, eight are no faster.
// - For ljr and lja the even power comes from 1/r^2, one approximate
//   reciprocal of the clamped r^2, which saves the multiply that squares
//   1/r. On an atom the clamp gives 1e12, its sixth power overflows to
//   infinity, and the saturated tanh returns exactly the cap, as with the
//   rsqrt.
// - A thread never straddles a row: the grid is cut into nx * ny rows of
//   ceil(nz / kPoints) tiles, and the points of a row's last tile that lie
//   beyond nz are computed and dropped.
// - Coalesced stores. The points of a block's threads are one contiguous
//   run of the output (dropped points leave no gap: the next row starts
//   where the row ends), so the block stages its values in shared memory
//   at their offset in that run and copies the run out.
// - Small blocks (kThreads threads, kPoints * kThreads points) keep the
//   last wave short: the main path's grid is 2,939 blocks, 2.2 waves of
//   the 10 blocks an SM holds, and a few resident warps per scheduler
//   already fill the issue slots (64 threads run alike, 256 are 4%
//   slower).
// - Receptor atoms stream through shared memory in tiles of kTile float4;
//   every thread of the block reads the same atom at once (a broadcast).
//   Each point's sum is two f32 registers: a partial over kAtomBlock atoms
//   and the total, which keeps the rounding of the 9k-term sum small. A
//   partial takes a whole tile: shorter ones (32 atoms) cost 3-7% of the
//   time in loop ends and gave the same error against the plain twin. The
//   atom loop bounds itself, so no padding atoms are needed. Flat indices
//   are 64-bit. The grid point is formed with a rounded multiply and a
//   rounded add as the reference forms it.
// - Not done, on purpose: cluster multicast of the atom tiles. The atoms
//   are 146 KB and live in L2, and shared memory sees one broadcast load
//   per kPoints pairs per warp: there is nothing to win.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// consecutive z points per thread
constexpr int kPoints = 4;
// atoms per shared-memory tile, a multiple of kThreads
constexpr int kTile = 256;
// atoms summed into a partial before it joins the point's total
constexpr int kAtomBlock = 256;
// atoms in flight in the atom loop
constexpr int kUnroll = 4;
// resident blocks per SM that the register allocator is told to leave
// room for: 10 gives it 48 registers, with which it schedules the atom
// loop best (unasked it takes 55-56 and the kernel runs 2-5% slower)
constexpr int kMinBlocks = 10;

static_assert(kTile % kThreads == 0 && kTile % kAtomBlock == 0, "tile");

// one MUFU.RSQ or MUFU.RCP; the argument is clamped to a normal number
// first
__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// thread-tile t: its row (i * ny + j), its first k, its first flat index
struct TileStart {
  long long row;
  int k0;
  long long flat;
};
__device__ __forceinline__ TileStart tile_start(long long t,
                                                int tiles_per_row, int nz) {
  TileStart s;
  s.row = t / tiles_per_row;
  s.k0 = (int)(t - s.row * tiles_per_row) * kPoints;
  s.flat = s.row * nz + s.k0;
  return s;
}

template <int GRID_TYPE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gridgen_values_kernel(const float4* __restrict__ atoms, int n_atoms,
                      float* __restrict__ out, long long n_tiles, int ny,
                      int nz, int tiles_per_row, float ox, float oy,
                      float oz, float sx, float sy, float sz, float cap) {
  __shared__ float4 tile[kTile];
  __shared__ float stage[kThreads * kPoints];

  const long long t0 = (long long)blockIdx.x * kThreads;
  const long long t = t0 + threadIdx.x;
  const bool valid = t < n_tiles;
  float gx, gy;
  float gz[kPoints];
  float acc[kPoints];
  {
    const TileStart mine =
        tile_start(valid ? t : n_tiles - 1, tiles_per_row, nz);
    const long long i = mine.row / ny;
    const int j = (int)(mine.row - i * ny);
    // rounded multiply, then rounded add, as the reference forms the
    // point: a contracted FMA moves it by an ulp, and dx = gx - x_atom
    // turns that into a relative error of 1e-5 near an atom
    gx = __fadd_rn(ox, __fmul_rn((float)i, sx));
    gy = __fadd_rn(oy, __fmul_rn((float)j, sy));
#pragma unroll
    for (int p = 0; p < kPoints; ++p) {
      gz[p] = __fadd_rn(oz, __fmul_rn((float)(mine.k0 + p), sz));
      acc[p] = 0.0f;
    }
  }

  for (int a0 = 0; a0 < n_atoms; a0 += kTile) {
#pragma unroll
    for (int l = threadIdx.x; l < kTile; l += kThreads)
      if (a0 + l < n_atoms) tile[l] = atoms[a0 + l];
    __syncthreads();
    const int n_tile = min(kTile, n_atoms - a0);
    for (int b0 = 0; b0 < n_tile; b0 += kAtomBlock) {
      const int b1 = min(b0 + kAtomBlock, n_tile);
      float part[kPoints];
#pragma unroll
      for (int p = 0; p < kPoints; ++p) part[p] = 0.0f;
#pragma unroll(kUnroll)
      for (int b = b0; b < b1; ++b) {
        const float4 at = tile[b];
        const float dx = __fsub_rn(gx, at.x);
        const float dy = __fsub_rn(gy, at.y);
        const float dxy2 = fmaf(dy, dy, dx * dx);
#pragma unroll
        for (int p = 0; p < kPoints; ++p) {
          const float dz = __fsub_rn(gz[p], at.z);
          // r >= 1e-6 nm
          const float r2 = fmaxf(fmaf(dz, dz, dxy2), 1e-12f);
          float c;
          if (GRID_TYPE == 0) {  // charge: K / r
            c = rsqrt_approx(r2);
          } else {
            const float inv_r2 = rcp_approx(r2);
            const float inv_r4 = inv_r2 * inv_r2;
            if (GRID_TYPE == 1) {  // ljr: K / r^12
              c = inv_r4 * inv_r4 * inv_r4;
            } else {               // lja: K / r^6
              c = inv_r4 * inv_r2;
            }
          }
          part[p] = fmaf(at.w, c, part[p]);
        }
      }
#pragma unroll
      for (int p = 0; p < kPoints; ++p) acc[p] += part[p];
    }
    __syncthreads();
  }

  // the block's points are one contiguous run of out, from its first
  // thread's first point to its last thread's last point inside the row
  const long long run0 = tile_start(t0, tiles_per_row, nz).flat;
  const long long t_last =
      (t0 + kThreads < n_tiles ? t0 + kThreads : n_tiles) - 1;
  const TileStart last = tile_start(t_last, tiles_per_row, nz);
  const int n_out = (int)(last.flat + min(kPoints, nz - last.k0) - run0);
  if (valid) {
    // the thread's place, formed again: nothing of it stays in registers
    // through the atom loop
    const TileStart mine = tile_start(t, tiles_per_row, nz);
#pragma unroll
    for (int p = 0; p < kPoints; ++p) {
      if (mine.k0 + p < nz) {
        const float u = acc[p] / cap;
        const float th = u > 20.0f ? 1.0f : (u < -20.0f ? -1.0f : tanhf(u));
        stage[mine.flat - run0 + p] = cap * th;
      }
    }
  }
  __syncthreads();
  float* dst = out + run0;
  for (int s = threadIdx.x; s < n_out; s += kThreads) dst[s] = stage[s];
}

// thread-tiles that cover one z-column
int row_tiles(int nz) { return (nz + kPoints - 1) / kPoints; }

template <int GRID_TYPE>
int launch(const float4* atoms, int n_atoms, float* out, long long n_tiles,
           int ny, int nz, float ox, float oy, float oz, float sx, float sy,
           float sz, float cap, unsigned blocks, cudaStream_t stream) {
  gridgen_values_kernel<GRID_TYPE><<<blocks, kThreads, 0, stream>>>(
      atoms, n_atoms, out, n_tiles, ny, nz, row_tiles(nz), ox, oy, oz,
      sx, sy, sz, cap);
  return (int)cudaGetLastError();
}

template <int GRID_TYPE>
int resident_blocks(int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, gridgen_values_kernel<GRID_TYPE>, kThreads, 0);
}

}  // namespace

extern "C" int gridgen_values_launch(const void* atoms, int n_atoms,
                                     void* out, int nx, int ny, int nz,
                                     float ox, float oy, float oz, float sx,
                                     float sy, float sz, float cap,
                                     int grid_type, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nx <= 0 || ny <= 0 || nz <= 0) return 0;
  const long long n_tiles = (long long)nx * ny * row_tiles(nz);
  const long long blocks = (n_tiles + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float4* a = static_cast<const float4*>(atoms);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (grid_type) {
    case 0:
      return launch<0>(a, n_atoms, o, n_tiles, ny, nz, ox, oy, oz, sx, sy,
                       sz, cap, (unsigned)blocks, s);
    case 1:
      return launch<1>(a, n_atoms, o, n_tiles, ny, nz, ox, oy, oz, sx, sy,
                       sz, cap, (unsigned)blocks, s);
    case 2:
      return launch<2>(a, n_atoms, o, n_tiles, ny, nz, ox, oy, oz, sx, sy,
                       sz, cap, (unsigned)blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the launch's shape for a grid of nx x ny x nz points: blocks, threads
// per block, and the blocks of this kernel that one SM holds at a time
extern "C" int gridgen_values_launch_shape(int nx, int ny, int nz,
                                           int grid_type, int device,
                                           long long* blocks, int* threads,
                                           int* blocks_per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (long long)nx * ny * row_tiles(nz);
  *blocks = (n_tiles + kThreads - 1) / kThreads;
  *threads = kThreads;
  switch (grid_type) {
    case 0:
      return resident_blocks<0>(blocks_per_sm);
    case 1:
      return resident_blocks<1>(blocks_per_sm);
    case 2:
      return resident_blocks<2>(blocks_per_sm);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* gridgen_values_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
