// Capped receptor field values on a rectilinear grid, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel openmmgridforce_tpu/ops/pallas_gridgen.py
// (_gen_kernel, entry generate_grid_values_pallas). For every grid point
// (flat index i*ny*nz + j*nz + k, position origin + (i0 + i, j0 + j,
// k0 + k) * spacing, where (i0, j0, k0) places the launch's points in a
// larger grid: a slab of a tiled file is the same function of the global
// index as the whole grid) it computes
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
//
// Float64. The kernel is a template on the scalar type; the float64
// instantiation (gridgen_values_launch_f64) takes a [A, 4] float64 atom
// table. FP64 has no special-function pipe, so 1/r is the double rsqrt()
// and 1/r^2 a rounded reciprocal, both a few FP64 operations; the bound is
// the FP64 pipe (about 34 TFLOP/s on an H100 SXM, half the FP32 rate). Its
// launch shape is its own (kThreads64 ... kMinBlocks64): the float32
// constants were tuned for 48 registers a thread, which double values
// would overrun.

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

// the float64 instantiation's launch: 4 blocks an SM leave it up to 128
// registers a thread for the doubled accumulators and the double rsqrt's
// Newton steps (it takes 65-69). Timed on an H100 SXM at 700 W
// (kernel_variants.py): 2 or 8 points a thread are 6% and 9% slower, 256
// threads 4%, no unrolling 5%, room for 2 or 6 blocks the same; unrolling
// by 4 is 1% faster than by 2
constexpr int kThreads64 = 128;
constexpr int kPoints64 = 4;
constexpr int kTile64 = 128;
constexpr int kAtomBlock64 = 128;
constexpr int kUnroll64 = 4;
constexpr int kMinBlocks64 = 4;

static_assert(kTile % kThreads == 0 && kTile % kAtomBlock == 0, "tile");
static_assert(kTile64 % kThreads64 == 0 && kTile64 % kAtomBlock64 == 0,
              "tile");

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

// a float64 atom (x, y, z, K): two 16-byte loads
struct __align__(16) Atom64 {
  double x, y, z, w;
};

// the scalar type's arithmetic and launch shape
template <typename T>
struct Real;
template <>
struct Real<float> {
  using Atom = float4;
  static constexpr int threads = kThreads, points = kPoints, tile = kTile,
                       atom_block = kAtomBlock, min_blocks = kMinBlocks;
  static constexpr float r2_min = 1e-12f;
  static __device__ __forceinline__ float mul_rn(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add_rn(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub_rn(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float fma(float a, float b, float c) {
    return fmaf(a, b, c);
  }
  static __device__ __forceinline__ float max(float a, float b) {
    return fmaxf(a, b);
  }
  static __device__ __forceinline__ float rsqrt(float x) {
    return rsqrt_approx(x);
  }
  static __device__ __forceinline__ float rcp(float x) {
    return rcp_approx(x);
  }
  static __device__ __forceinline__ float tanh(float x) { return tanhf(x); }
};
template <>
struct Real<double> {
  using Atom = Atom64;
  static constexpr int threads = kThreads64, points = kPoints64,
                       tile = kTile64, atom_block = kAtomBlock64,
                       min_blocks = kMinBlocks64;
  static constexpr double r2_min = 1e-12;
  static __device__ __forceinline__ double mul_rn(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add_rn(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub_rn(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double fma(double a, double b,
                                               double c) {
    return ::fma(a, b, c);
  }
  static __device__ __forceinline__ double max(double a, double b) {
    return fmax(a, b);
  }
  static __device__ __forceinline__ double rsqrt(double x) {
    return ::rsqrt(x);
  }
  static __device__ __forceinline__ double rcp(double x) {
    return __drcp_rn(x);
  }
  static __device__ __forceinline__ double tanh(double x) {
    return ::tanh(x);
  }
};

// thread-tile t: its row (i * ny + j), its first k, its first flat index
struct TileStart {
  long long row;
  int k0;
  long long flat;
};
template <int POINTS>
__device__ __forceinline__ TileStart tile_start(long long t,
                                                int tiles_per_row, int nz) {
  TileStart s;
  s.row = t / tiles_per_row;
  s.k0 = (int)(t - s.row * tiles_per_row) * POINTS;
  s.flat = s.row * nz + s.k0;
  return s;
}

template <int GRID_TYPE, typename T>
__global__ void __launch_bounds__(Real<T>::threads, Real<T>::min_blocks)
gridgen_values_kernel(const typename Real<T>::Atom* __restrict__ atoms,
                      int n_atoms, T* __restrict__ out, long long n_tiles,
                      int ny, int nz, int tiles_per_row, int i0, int j0,
                      int k0, T ox, T oy, T oz, T sx, T sy, T sz, T cap) {
  using R = Real<T>;
  constexpr int kThreadsT = R::threads, kPointsT = R::points,
                kTileT = R::tile, kAtomBlockT = R::atom_block;
  __shared__ typename R::Atom tile[kTileT];
  __shared__ T stage[kThreadsT * kPointsT];

  const long long t0 = (long long)blockIdx.x * kThreadsT;
  const long long t = t0 + threadIdx.x;
  const bool valid = t < n_tiles;
  T gx, gy;
  T gz[kPointsT];
  T acc[kPointsT];
  {
    const TileStart mine = tile_start<kPointsT>(valid ? t : n_tiles - 1,
                                                tiles_per_row, nz);
    const long long i = mine.row / ny;
    const int j = (int)(mine.row - i * ny);
    // rounded multiply, then rounded add, as the reference forms the
    // point: a contracted FMA moves it by an ulp, and dx = gx - x_atom
    // turns that into a relative error of 1e-5 near an atom
    gx = R::add_rn(ox, R::mul_rn((T)(i0 + i), sx));
    gy = R::add_rn(oy, R::mul_rn((T)(j0 + j), sy));
#pragma unroll
    for (int p = 0; p < kPointsT; ++p) {
      gz[p] = R::add_rn(oz, R::mul_rn((T)(k0 + mine.k0 + p), sz));
      acc[p] = T(0);
    }
  }

  for (int a0 = 0; a0 < n_atoms; a0 += kTileT) {
#pragma unroll
    for (int l = threadIdx.x; l < kTileT; l += kThreadsT)
      if (a0 + l < n_atoms) tile[l] = atoms[a0 + l];
    __syncthreads();
    const int n_tile = min(kTileT, n_atoms - a0);
    for (int b0 = 0; b0 < n_tile; b0 += kAtomBlockT) {
      const int b1 = min(b0 + kAtomBlockT, n_tile);
      T part[kPointsT];
#pragma unroll
      for (int p = 0; p < kPointsT; ++p) part[p] = T(0);
#pragma unroll(sizeof(T) == 4 ? kUnroll : kUnroll64)
      for (int b = b0; b < b1; ++b) {
        const typename R::Atom at = tile[b];
        const T dx = R::sub_rn(gx, at.x);
        const T dy = R::sub_rn(gy, at.y);
        const T dxy2 = R::fma(dy, dy, dx * dx);
#pragma unroll
        for (int p = 0; p < kPointsT; ++p) {
          const T dz = R::sub_rn(gz[p], at.z);
          // r >= 1e-6 nm
          const T r2 = R::max(R::fma(dz, dz, dxy2), R::r2_min);
          T c;
          if (GRID_TYPE == 0) {  // charge: K / r
            c = R::rsqrt(r2);
          } else {
            const T inv_r2 = R::rcp(r2);
            const T inv_r4 = inv_r2 * inv_r2;
            if (GRID_TYPE == 1) {  // ljr: K / r^12
              c = inv_r4 * inv_r4 * inv_r4;
            } else {               // lja: K / r^6
              c = inv_r4 * inv_r2;
            }
          }
          part[p] = R::fma(at.w, c, part[p]);
        }
      }
#pragma unroll
      for (int p = 0; p < kPointsT; ++p) acc[p] += part[p];
    }
    __syncthreads();
  }

  // the block's points are one contiguous run of out, from its first
  // thread's first point to its last thread's last point inside the row
  const long long run0 = tile_start<kPointsT>(t0, tiles_per_row, nz).flat;
  const long long t_last =
      (t0 + kThreadsT < n_tiles ? t0 + kThreadsT : n_tiles) - 1;
  const TileStart last = tile_start<kPointsT>(t_last, tiles_per_row, nz);
  const int n_out = (int)(last.flat + min(kPointsT, nz - last.k0) - run0);
  if (valid) {
    // the thread's place, formed again: nothing of it stays in registers
    // through the atom loop
    const TileStart mine = tile_start<kPointsT>(t, tiles_per_row, nz);
#pragma unroll
    for (int p = 0; p < kPointsT; ++p) {
      if (mine.k0 + p < nz) {
        const T u = acc[p] / cap;
        const T th = u > T(20) ? T(1) : (u < T(-20) ? T(-1) : R::tanh(u));
        stage[mine.flat - run0 + p] = cap * th;
      }
    }
  }
  __syncthreads();
  T* dst = out + run0;
  for (int s = threadIdx.x; s < n_out; s += kThreadsT) dst[s] = stage[s];
}

// thread-tiles that cover one z-column
template <typename T>
int row_tiles(int nz) {
  return (nz + Real<T>::points - 1) / Real<T>::points;
}

template <int GRID_TYPE, typename T>
int launch(const void* atoms, int n_atoms, void* out, long long n_tiles,
           int ny, int nz, int i0, int j0, int k0, T ox, T oy, T oz, T sx,
           T sy, T sz, T cap, unsigned blocks, cudaStream_t stream) {
  gridgen_values_kernel<GRID_TYPE, T><<<blocks, Real<T>::threads, 0,
                                        stream>>>(
      static_cast<const typename Real<T>::Atom*>(atoms), n_atoms,
      static_cast<T*>(out), n_tiles, ny, nz, row_tiles<T>(nz), i0, j0, k0,
      ox, oy, oz, sx, sy, sz, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(const void* atoms, int n_atoms, void* out, int nx, int ny,
               int nz, int i0, int j0, int k0, T ox, T oy, T oz, T sx, T sy,
               T sz, T cap, int grid_type, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nx <= 0 || ny <= 0 || nz <= 0) return 0;
  const long long n_tiles = (long long)nx * ny * row_tiles<T>(nz);
  const long long blocks =
      (n_tiles + Real<T>::threads - 1) / Real<T>::threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (grid_type) {
    case 0:
      return launch<0, T>(atoms, n_atoms, out, n_tiles, ny, nz, i0, j0, k0,
                          ox, oy, oz, sx, sy, sz, cap, (unsigned)blocks, s);
    case 1:
      return launch<1, T>(atoms, n_atoms, out, n_tiles, ny, nz, i0, j0, k0,
                          ox, oy, oz, sx, sy, sz, cap, (unsigned)blocks, s);
    case 2:
      return launch<2, T>(atoms, n_atoms, out, n_tiles, ny, nz, i0, j0, k0,
                          ox, oy, oz, sx, sy, sz, cap, (unsigned)blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int GRID_TYPE, typename T>
int resident_blocks(int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, gridgen_values_kernel<GRID_TYPE, T>, Real<T>::threads, 0);
}

template <typename T>
int launch_shape(int nx, int ny, int nz, int grid_type, long long* blocks,
                 int* threads, int* blocks_per_sm) {
  const long long n_tiles = (long long)nx * ny * row_tiles<T>(nz);
  *blocks = (n_tiles + Real<T>::threads - 1) / Real<T>::threads;
  *threads = Real<T>::threads;
  switch (grid_type) {
    case 0:
      return resident_blocks<0, T>(blocks_per_sm);
    case 1:
      return resident_blocks<1, T>(blocks_per_sm);
    case 2:
      return resident_blocks<2, T>(blocks_per_sm);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// float32 atoms [A, 4] -> float32 out [nx, ny, nz]; (i0, j0, k0) is the
// index of the launch's first point in the grid that origin and spacing
// describe
extern "C" int gridgen_values_launch(const void* atoms, int n_atoms,
                                     void* out, int nx, int ny, int nz,
                                     int i0, int j0, int k0, float ox,
                                     float oy, float oz, float sx, float sy,
                                     float sz, float cap, int grid_type,
                                     int device, void* stream) {
  return launch_any<float>(atoms, n_atoms, out, nx, ny, nz, i0, j0, k0, ox,
                           oy, oz, sx, sy, sz, cap, grid_type, device,
                           stream);
}

// the same in float64
extern "C" int gridgen_values_launch_f64(const void* atoms, int n_atoms,
                                         void* out, int nx, int ny, int nz,
                                         int i0, int j0, int k0, double ox,
                                         double oy, double oz, double sx,
                                         double sy, double sz, double cap,
                                         int grid_type, int device,
                                         void* stream) {
  return launch_any<double>(atoms, n_atoms, out, nx, ny, nz, i0, j0, k0, ox,
                            oy, oz, sx, sy, sz, cap, grid_type, device,
                            stream);
}

// the launch's shape for a grid of nx x ny x nz points: blocks, threads
// per block, and the blocks of this kernel that one SM holds at a time;
// f64 selects the float64 instantiation
extern "C" int gridgen_values_launch_shape(int nx, int ny, int nz,
                                           int grid_type, int f64,
                                           int device, long long* blocks,
                                           int* threads,
                                           int* blocks_per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return f64 ? launch_shape<double>(nx, ny, nz, grid_type, blocks, threads,
                                    blocks_per_sm)
             : launch_shape<float>(nx, ny, nz, grid_type, blocks, threads,
                                   blocks_per_sm);
}

extern "C" const char* gridgen_values_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
