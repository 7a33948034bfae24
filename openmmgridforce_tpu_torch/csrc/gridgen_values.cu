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
// Float64 (gridgen_values_launch_f64, a [A, 4] float64 atom table) has a
// body of its own, values_f64. FP64 has no special-function pipe and
// half the FP32 rate: 64 FP64 lanes an SM, so a warp's FP64 instruction
// holds its scheduler's FP64 unit for 2 clocks, and the FP64 instructions
// a pair set the pace (34 TFLOP/s on an H100 SXM). libdevice's double
// rsqrt() and __drcp_rn spend about 20 more instructions a pair on
// special cases (a guarded slow-path CALL and its selects), which the
// clamped r^2 never reaches. So:
// - 1/sqrt(r^2) and 1/r^2 are written out: a MUFU.RSQ64H / MUFU.RCP64H
//   seed from the high word (20 fraction bits in the result's high word;
//   on an NVIDIA H100 80GB HBM3 at 700.00 W its relative error reached
//   2^-20.15 / 2^-19.96 over r^2 in [1e-12, 1e4]), then kNewton64
//   third-order Newton steps in FMAs. rsqrt: e = 1 - x y^2 (y^2 exact,
//   since the seed has 21 significant bits), y + (e y)(1/2 + 3/8 e): 5
//   FP64 instructions. Reciprocal: e = 1 - x y, e = e + e^2, y + y e: 3.
//   One step leaves 2.5 eps^3 and eps^3 of the seed's eps, below 2^-56,
//   so both are within an ulp of the correctly rounded value (on that
//   card 99.96% / 98.8% of them correctly rounded; chip_smoke.py's
//   float64_reciprocal_probe and float64_pair_ulps measure it).
// - The clamp is shared by a z-column. r^2 = fma(dz, dz, dx^2 + dy^2) is
//   at least dx^2 + dy^2, so only an atom within 1e-6 nm of a thread's
//   z-line can reach the clamp. Per group of kUnroll64 atoms a thread
//   tests its lines on the high words (integer compares, which can only
//   err towards clamping), the warp votes, and the group runs without
//   clamps unless a lane is near; then it runs with the exact clamp on
//   every pair. Near an atom the clamp gives exactly the float32 path's
//   r^2 = 1e-12, and the sixth power 1e72 stays finite.
// - A thread owns kRows64 x kPoints64 points (rows along y, points along
//   z): dx and dx^2 are shared by the tile, dy and dx^2 + dy^2 by a row,
//   dz by a column of the tile. A pair then issues fma(dz, dz, dxy2), the
//   Newton steps, the power and fma(K, c, acc): 7 / 8 / 7 FP64
//   instructions, plus the shared ones (7.56 / 8.56 / 7.56 in all in the
//   machine code, 10.0 / 10.9 / 9.9 instructions). The sum is one
//   register a point (a 9k-term float64 sum rounds to about 1e-12 of its
//   terms' sum, under the 1e-10 gate), the atom tile is padded with far
//   atoms of zero strength to whole groups, and outputs go straight to
//   memory (12 MB a grid: microseconds).
// - Shipped: 4 x 8 points, groups of 1 atom, room for 2 blocks an SM
//   (214-246 registers, no spills). kernel_variants.py on an NVIDIA H100
//   80GB HBM3 at 700.00 W, a bench-box grid (1.49e6 points x 9,133 atoms)
//   per grid type: 8.31 / 8.69 / 7.67 ms; 4 z-points a thread (groups of
//   4 atoms, 4 blocks) 8.95 / 9.13 / 8.38; the clamp on every pair 9.70 /
//   9.75 / 8.89; two Newton steps 13.21 / 11.41 / 10.44; libdevice's
//   rsqrt() and __drcp_rn with the clamp on every pair 16.76 / 17.77 /
//   17.28 (the loop before this design, libdevice's in 1 x 4 tiles with
//   partial sums, took 15.86 / 16.42 / 15.61); 2 x 8, 3 x 4,
//   4 x 4 and 8 x 4 tiles and groups of 2 atoms 1-2% slower in sum, room
//   for 3 blocks (168 registers) 8%, 256 threads a block 25%.

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

// the float64 body's launch and tile (values_f64), chosen with
// kernel_variants.py: the note above
constexpr int kThreads64 = 128;
constexpr int kRows64 = 4;
constexpr int kPoints64 = 8;
constexpr int kTile64 = 128;
// atoms a group: the unit of the near-line vote and of the unrolling
constexpr int kUnroll64 = 1;
constexpr int kMinBlocks64 = 2;
// third-order Newton steps after the MUFU seed
constexpr int kNewton64 = 1;
// 1: clamp every pair and skip the vote
constexpr int kClampEvery64 = 0;

static_assert(kTile % kThreads == 0 && kTile % kAtomBlock == 0, "tile");
static_assert(kTile64 % kThreads64 == 0 && kTile64 % kUnroll64 == 0,
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
  static constexpr int threads = kThreads, rows = 1, points = kPoints,
                       tile = kTile, atom_block = kAtomBlock,
                       min_blocks = kMinBlocks;
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
  static constexpr int threads = kThreads64, rows = kRows64,
                       points = kPoints64, min_blocks = kMinBlocks64;
};

// float64 seeds: MUFU.RSQ64H / MUFU.RCP64H of the argument's high word,
// 20 fraction bits in the result's high word, zeros in its low word
__device__ __forceinline__ double rsqrt_seed(double x) {
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  return y;
}
__device__ __forceinline__ double rcp_seed(double x) {
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  return y;
}

// 1/sqrt(x) and 1/x for normal x > 0, within an ulp (the source note)
__device__ __forceinline__ double rsqrt64(double x) {
  double y = rsqrt_seed(x);
#pragma unroll
  for (int s = 0; s < kNewton64; ++s) {
    // y * y is exact at the first step (the seed has 21 significant
    // bits), so e = 1 - x y^2 rounds once
    const double e = ::fma(-x, y * y, 1.0);
    y = ::fma(e * y, ::fma(e, 0.375, 0.5), y);
  }
  return y;
}
__device__ __forceinline__ double rcp64(double x) {
  double y = rcp_seed(x);
#pragma unroll
  for (int s = 0; s < kNewton64; ++s) {
    double e = ::fma(-x, y, 1.0);
    e = ::fma(e, e, e);
    y = ::fma(y, e, y);
  }
  return y;
}

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

// the float32 body: one thread-tile is kPoints points of a z-column
template <int GRID_TYPE>
__device__ __forceinline__ void values_f32(
    const float4* __restrict__ atoms, int n_atoms, float* __restrict__ out,
    long long n_tiles, int ny, int nz, int tiles_per_row, int i0, int j0,
    int k0, float ox, float oy, float oz, float sx, float sy, float sz,
    float cap) {
  using T = float;
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
#pragma unroll(kUnroll)
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

// the pairs of one group of kUnroll64 atoms with the thread's tile;
// CLAMP: r^2 >= 1e-12 on every pair
template <int GRID_TYPE, bool CLAMP>
__device__ __forceinline__ void group_f64(
    const Atom64 (&at)[kUnroll64], const double (&dxy2)[kUnroll64][kRows64],
    const double (&gz)[kPoints64], double (&acc)[kRows64][kPoints64]) {
#pragma unroll
  for (int u = 0; u < kUnroll64; ++u) {
#pragma unroll
    for (int p = 0; p < kPoints64; ++p) {
      const double dz = gz[p] - at[u].z;
#pragma unroll
      for (int r = 0; r < kRows64; ++r) {
        double r2 = ::fma(dz, dz, dxy2[u][r]);
        if (CLAMP) r2 = r2 < 1e-12 ? 1e-12 : r2;   // r >= 1e-6 nm
        double c;
        if (GRID_TYPE == 0) {  // charge: K / r
          c = rsqrt64(r2);
        } else {
          const double inv_r2 = rcp64(r2);
          const double inv_r4 = inv_r2 * inv_r2;
          if (GRID_TYPE == 1) {  // ljr: K / r^12
            c = inv_r4 * inv_r4 * inv_r4;
          } else {               // lja: K / r^6
            c = inv_r4 * inv_r2;
          }
        }
        acc[r][p] = ::fma(at[u].w, c, acc[r][p]);
      }
    }
  }
}

// the float64 body: one thread-tile is kRows64 rows x kPoints64 points of
// an x-plane; the tiles of a plane run z-fastest
template <int GRID_TYPE>
__device__ __forceinline__ void values_f64(
    const Atom64* __restrict__ atoms, int n_atoms, double* __restrict__ out,
    long long n_tiles, int ny, int nz, int tiles_per_row, int i0, int j0,
    int k0, double ox, double oy, double oz, double sx, double sy,
    double sz, double cap) {
  __shared__ Atom64 tile[kTile64];
  // 1e-12's high word: a line whose dx^2 + dy^2 has a larger one is
  // farther than 1e-6 nm from the atom
  constexpr int kR2MinHi = 0x3d719799;
  // padding: zero strength, r^2 about 3e60, nothing overflows
  const Atom64 far = {1e30, 1e30, 1e30, 0.0};

  const long long t = (long long)blockIdx.x * kThreads64 + threadIdx.x;
  const bool valid = t < n_tiles;
  const int row_blocks = (ny + kRows64 - 1) / kRows64;
  const long long tt = valid ? t : n_tiles - 1;
  const long long rb = tt / tiles_per_row;
  const int k = (int)(tt - rb * tiles_per_row) * kPoints64;
  const long long i = rb / row_blocks;
  const int j = (int)(rb - i * row_blocks) * kRows64;
  // rounded multiply, then rounded add, as the reference forms the point
  const double gx = __dadd_rn(ox, __dmul_rn((double)(i0 + i), sx));
  double gy[kRows64], gz[kPoints64], acc[kRows64][kPoints64];
#pragma unroll
  for (int r = 0; r < kRows64; ++r)
    gy[r] = __dadd_rn(oy, __dmul_rn((double)(j0 + j + r), sy));
#pragma unroll
  for (int p = 0; p < kPoints64; ++p) {
    gz[p] = __dadd_rn(oz, __dmul_rn((double)(k0 + k + p), sz));
#pragma unroll
    for (int r = 0; r < kRows64; ++r) acc[r][p] = 0.0;
  }

  for (int a0 = 0; a0 < n_atoms; a0 += kTile64) {
#pragma unroll
    for (int l = threadIdx.x; l < kTile64; l += kThreads64)
      tile[l] = a0 + l < n_atoms ? atoms[a0 + l] : far;
    __syncthreads();
    const int n_tile = min(kTile64, n_atoms - a0);
#pragma unroll 1
    for (int b = 0; b < n_tile; b += kUnroll64) {
      Atom64 at[kUnroll64];
      double dxy2[kUnroll64][kRows64];
      bool near = false;
#pragma unroll
      for (int u = 0; u < kUnroll64; ++u) {
        at[u] = tile[b + u];
        const double dx = gx - at[u].x;
        const double dx2 = dx * dx;
#pragma unroll
        for (int r = 0; r < kRows64; ++r) {
          const double dy = gy[r] - at[u].y;
          dxy2[u][r] = ::fma(dy, dy, dx2);
          near |= __double2hiint(dxy2[u][r]) <= kR2MinHi;
        }
      }
      if (kClampEvery64 || __any_sync(0xffffffffu, near))
        group_f64<GRID_TYPE, true>(at, dxy2, gz, acc);
      else
        group_f64<GRID_TYPE, false>(at, dxy2, gz, acc);
    }
    __syncthreads();
  }

  if (!valid) return;
#pragma unroll
  for (int r = 0; r < kRows64; ++r) {
#pragma unroll
    for (int p = 0; p < kPoints64; ++p) {
      if (j + r < ny && k + p < nz) {
        const double u = acc[r][p] / cap;
        const double th = u > 20.0 ? 1.0 : (u < -20.0 ? -1.0 : ::tanh(u));
        out[(i * ny + j + r) * nz + k + p] = cap * th;
      }
    }
  }
}

template <int GRID_TYPE, typename T>
__global__ void __launch_bounds__(Real<T>::threads, Real<T>::min_blocks)
gridgen_values_kernel(const typename Real<T>::Atom* __restrict__ atoms,
                      int n_atoms, T* __restrict__ out, long long n_tiles,
                      int ny, int nz, int tiles_per_row, int i0, int j0,
                      int k0, T ox, T oy, T oz, T sx, T sy, T sz, T cap) {
  if constexpr (sizeof(T) == 4)
    values_f32<GRID_TYPE>(atoms, n_atoms, out, n_tiles, ny, nz,
                          tiles_per_row, i0, j0, k0, ox, oy, oz, sx, sy, sz,
                          cap);
  else
    values_f64<GRID_TYPE>(atoms, n_atoms, out, n_tiles, ny, nz,
                          tiles_per_row, i0, j0, k0, ox, oy, oz, sx, sy, sz,
                          cap);
}

// thread-tiles that cover one z-column
template <typename T>
int row_tiles(int nz) {
  return (nz + Real<T>::points - 1) / Real<T>::points;
}

// thread-tiles that cover the grid
template <typename T>
long long grid_tiles(int nx, int ny, int nz) {
  return (long long)nx * ((ny + Real<T>::rows - 1) / Real<T>::rows) *
         row_tiles<T>(nz);
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
  const long long n_tiles = grid_tiles<T>(nx, ny, nz);
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
  const long long n_tiles = grid_tiles<T>(nx, ny, nz);
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

// the float64 reciprocals alone: per x, the rsqrt and reciprocal seeds
// and the finished 1/sqrt(x) and 1/x of the atom loop
__global__ void reciprocal_probe_kernel(const double* __restrict__ x, int n,
                                        double* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const double v = x[i];
  out[4 * i] = rsqrt_seed(v);
  out[4 * i + 1] = rcp_seed(v);
  out[4 * i + 2] = rsqrt64(v);
  out[4 * i + 3] = rcp64(v);
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

// float64 x [n] -> out [n, 4]: the seeds of 1/sqrt(x) and 1/x (MUFU, from
// the high word) and the values the float64 atom loop finishes from them
extern "C" int gridgen_values_reciprocal_probe(const void* x, int n,
                                               void* out, int device,
                                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  reciprocal_probe_kernel<<<(n + 127) / 128, 128, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), n, static_cast<double*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* gridgen_values_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
