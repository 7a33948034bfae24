// Raw 27-derivative receptor field sums on a rectilinear grid, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// openmmgridforce_tpu/ops/pallas_gridgen_derivs.py (_derivs_kernel, entry
// generate_raw_derivs_pallas). For every grid point (flat index
// i*ny*nz + j*nz + k, position origin + (i, j, k) * spacing) it computes
// the 27 uncapped, unscaled mixed partials d^(a+b+c)/dx^a dy^b dz^c,
// a, b, c <= 2, of
//
//     sum_a K_a / r_a^m,   m = 1 (charge), 12 (ljr), 6 (lja)
//
// in the canonical slot order (f; x y z; xx xy xz yy yz zz; xxy xxz xyy xyz
// yyz xzz yzz; xxyy xxzz yyzz xxyz xyyz xyzz; xxyyz xxyzz xyyzz; xxyyzz),
// with r^2 clamped at 4e-4 nm^2. Per pair: one rsqrt, the radial
// derivatives d^n U / dr^n = coef[n] K / r^(m+n) for n <= 6, the cascade
// combinations A2..D6 and the direction-cosine products, exactly the
// arithmetic of the Pallas kernel. Powers of 1/r are formed by repeated
// multiplication: at the clamp the ljr sixth derivative is of order 1e35,
// inside float32 but near its end. The host computes the per-atom strength
// K. The tanh cap, the inverse-power chain rule and the cell-fractional
// scaling are a per-point pass in PyTorch afterwards.
//
// Bound: operations. The function needs about 145 FP32 operations per
// pair (145 / 149 / 148 for charge / ljr / lja, an FMA counted as two) and
// one MUFU rsqrt, when the work is shared: for a pure power law every
// cascade combination of order n folds to one constant times K / r^(m+n),
// and each product of direction cosines is formed once. The main path's
// grids have 1.49e6 points x 9133 atoms = 1.36e10 pairs, so 2e12
// operations: about 30 ms per grid at the H100 SXM's 67 TFLOP/s FP32 peak.
// The rsqrt pipe needs 3.3 ms and the bytes (16 per atom in, 108 per point
// out: 161 MB) 0.05 ms. This kernel does not share that work yet: it forms
// the six radial derivatives and the cascade as the Pallas kernel writes
// them, 287 / 298 / 292 operations per pair as written, which is the first
// thing to change when the kernel is made faster.
//
// Design: the all-pairs N-body pattern of the values kernel. One thread per
// grid point; receptor atoms stream through shared memory in tiles of
// blockDim.x float4 (x, y, z, K), every thread of the block reading the
// same atom at once (a broadcast). Each thread keeps 27 running totals and
// 27 partials in registers: the partials take 8 atoms, as the TPU kernel
// sums blocks of 8, before they join the totals, which keeps the float32
// rounding of a 9k-term signed sum close to the reference's. 128 threads
// per block leave each thread up to 255 registers, so nothing spills. The
// grid type is a template parameter: the power and the coefficients fold
// to constants. The atom loop bounds itself (no padding atoms), flat
// indices are 64-bit (27 x points passes 2^31 on large grids), and the
// grid point is formed with a rounded multiply and a rounded add as the
// reference forms it.
//
// Output layout: [points, 27], point-major, which is what the callers
// index ([nx, ny, nz, 27]). A thread's 27 sums are 27 floats apart from
// its neighbour's, so storing them straight from registers would be
// strided; writing 27 point-major planes would be coalesced but needs a
// transpose of 161 MB per grid afterwards. Instead the block stages its
// 128 x 27 sums in shared memory (stride 27 is odd: no bank conflicts) and
// copies them out as one contiguous, coalesced run.
// Register tiling of several points per thread and cluster multicast of
// the atom tiles are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAtomBlock = 8;
constexpr int kSlots = 27;

// (-1)^n m (m+1) ... (m+n-1), n = 1..6, for U = K / r^m
template <int GRID_TYPE>
struct Field;
template <>
struct Field<0> {  // charge, m = 1
  static constexpr int m = 1;
  static constexpr float c1 = -1.0f, c2 = 2.0f, c3 = -6.0f, c4 = 24.0f,
                         c5 = -120.0f, c6 = 720.0f;
};
template <>
struct Field<1> {  // ljr, m = 12
  static constexpr int m = 12;
  static constexpr float c1 = -12.0f, c2 = 156.0f, c3 = -2184.0f,
                         c4 = 32760.0f, c5 = -524160.0f, c6 = 8910720.0f;
};
template <>
struct Field<2> {  // lja, m = 6
  static constexpr int m = 6;
  static constexpr float c1 = -6.0f, c2 = 42.0f, c3 = -336.0f, c4 = 3024.0f,
                         c5 = -30240.0f, c6 = 332640.0f;
};

// adds one atom's 27 derivative terms at displacement (dx, dy, dz) to part
template <int GRID_TYPE>
__device__ __forceinline__ void add_pair(float dx, float dy, float dz,
                                         float K, float (&part)[kSlots]) {
  using F = Field<GRID_TYPE>;
  float r2 = dx * dx + dy * dy + dz * dz;
  r2 = fmaxf(r2, 4e-4f);  // r >= 0.02 nm
  const float inv_r = rsqrtf(r2);

  float inv_rm = inv_r;
#pragma unroll
  for (int q = 1; q < F::m; ++q) inv_rm *= inv_r;
  const float base = K * inv_rm;  // U
  const float i2 = inv_r * inv_r;
  const float i3 = i2 * inv_r;
  const float i4 = i2 * i2;
  const float i5 = i4 * inv_r;
  const float i6 = i4 * i2;
  const float dU = F::c1 * base * inv_r;
  const float d2U = F::c2 * base * i2;
  const float d3U = F::c3 * base * i3;
  const float d4U = F::c4 * base * i4;
  const float d5U = F::c5 * base * i5;
  const float d6U = F::c6 * base * i6;

  const float nx = dx * inv_r;
  const float ny = dy * inv_r;
  const float nz = dz * inv_r;
  const float nx2 = nx * nx;
  const float ny2 = ny * ny;
  const float nz2 = nz * nz;

  const float A2 = d2U - dU * inv_r;
  const float A3 = d3U - 3.0f * d2U * inv_r + 3.0f * dU * i2;
  const float B3 = d2U * inv_r - dU * i2;
  const float A4 =
      d4U - 6.0f * d3U * inv_r + 15.0f * d2U * i2 - 15.0f * dU * i3;
  const float B4 = d3U * inv_r - 3.0f * d2U * i2 + 3.0f * dU * i3;
  const float C4 = d2U * i2 - dU * i3;
  const float A5 = d5U - 10.0f * d4U * inv_r + 45.0f * d3U * i2 -
                   105.0f * d2U * i3 + 105.0f * dU * i4;
  const float B5 =
      d4U * inv_r - 6.0f * d3U * i2 + 15.0f * d2U * i3 - 15.0f * dU * i4;
  const float C5 = d3U * i2 - 3.0f * d2U * i3 + 3.0f * dU * i4;
  const float A6 = d6U - 15.0f * d5U * inv_r + 105.0f * d4U * i2 -
                   420.0f * d3U * i3 + 945.0f * d2U * i4 - 945.0f * dU * i5;
  const float B6 = d5U * inv_r - 10.0f * d4U * i2 + 45.0f * d3U * i3 -
                   105.0f * d2U * i4 + 105.0f * dU * i5;
  const float C6 =
      d4U * i2 - 6.0f * d3U * i3 + 15.0f * d2U * i4 - 15.0f * dU * i5;
  const float D6 = d3U * i3 - 3.0f * d2U * i4 + 3.0f * dU * i5;
  const float dUr = dU * inv_r;

  part[0] += base;
  part[1] += dU * nx;
  part[2] += dU * ny;
  part[3] += dU * nz;
  part[4] += A2 * nx2 + dUr;
  part[5] += A2 * nx * ny;
  part[6] += A2 * nx * nz;
  part[7] += A2 * ny2 + dUr;
  part[8] += A2 * ny * nz;
  part[9] += A2 * nz2 + dUr;
  part[10] += A3 * nx2 * ny + B3 * ny;
  part[11] += A3 * nx2 * nz + B3 * nz;
  part[12] += A3 * nx * ny2 + B3 * nx;
  part[13] += A3 * nx * ny * nz;
  part[14] += A3 * ny2 * nz + B3 * nz;
  part[15] += A3 * nx * nz2 + B3 * nx;
  part[16] += A3 * ny * nz2 + B3 * ny;
  part[17] += A4 * nx2 * ny2 + B4 * (nx2 + ny2) + C4;
  part[18] += A4 * nx2 * nz2 + B4 * (nx2 + nz2) + C4;
  part[19] += A4 * ny2 * nz2 + B4 * (ny2 + nz2) + C4;
  part[20] += A4 * nx2 * ny * nz + B4 * ny * nz;
  part[21] += A4 * nx * ny2 * nz + B4 * nx * nz;
  part[22] += A4 * nx * ny * nz2 + B4 * nx * ny;
  part[23] += A5 * nx2 * ny2 * nz + B5 * (nx2 + ny2) * nz + C5 * nz;
  part[24] += A5 * nx2 * ny * nz2 + B5 * (ny * nz2 + nx2 * ny) + C5 * ny;
  part[25] += A5 * nx * ny2 * nz2 + B5 * (nx * nz2 + nx * ny2) + C5 * nx;
  part[26] += A6 * nx2 * ny2 * nz2 +
              B6 * (nx2 * ny2 + nx2 * nz2 + ny2 * nz2) +
              C6 * (nx2 + ny2 + nz2) + D6;
}

template <int GRID_TYPE>
__global__ void __launch_bounds__(kThreads)
gridgen_derivs_kernel(const float4* __restrict__ atoms, int n_atoms,
                      float* __restrict__ out, long long total, int ny,
                      int nz, float ox, float oy, float oz, float sx,
                      float sy, float sz) {
  __shared__ float4 tile[kThreads];
  __shared__ float stage[kThreads * kSlots];

  const long long p0 = (long long)blockIdx.x * kThreads;
  const long long p = p0 + threadIdx.x;
  const long long q = p < total ? p : total - 1;
  const long long nyz = (long long)ny * nz;
  const long long i = q / nyz;
  const long long rem = q - i * nyz;
  const int j = (int)(rem / nz);
  const int k = (int)(rem - (long long)j * nz);
  // rounded multiply, then rounded add, as the reference forms the point:
  // a contracted FMA moves it by an ulp, and dx = gx - x_atom turns that
  // into a relative error of 1e-5 near an atom
  const float gx = __fadd_rn(ox, __fmul_rn((float)i, sx));
  const float gy = __fadd_rn(oy, __fmul_rn((float)j, sy));
  const float gz = __fadd_rn(oz, __fmul_rn((float)k, sz));

  float acc[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) acc[s] = 0.0f;

  for (int a0 = 0; a0 < n_atoms; a0 += kThreads) {
    const int a = a0 + threadIdx.x;
    if (a < n_atoms) tile[threadIdx.x] = atoms[a];
    __syncthreads();
    const int n_tile = min(kThreads, n_atoms - a0);
    for (int b0 = 0; b0 < n_tile; b0 += kAtomBlock) {
      const int b1 = min(b0 + kAtomBlock, n_tile);
      float part[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) part[s] = 0.0f;
#pragma unroll 1
      for (int b = b0; b < b1; ++b) {
        const float4 at = tile[b];
        add_pair<GRID_TYPE>(gx - at.x, gy - at.y, gz - at.z, at.w, part);
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s) acc[s] += part[s];
    }
    __syncthreads();
  }

#pragma unroll
  for (int s = 0; s < kSlots; ++s) stage[threadIdx.x * kSlots + s] = acc[s];
  __syncthreads();
  // the block's points are one contiguous run of out; the ragged tail of
  // the last block is cut here
  const long long left = total - p0;
  const int n_out = (int)(left < kThreads ? left : kThreads) * kSlots;
  float* dst = out + p0 * kSlots;
  for (int t = threadIdx.x; t < n_out; t += kThreads) dst[t] = stage[t];
}

}  // namespace

extern "C" int gridgen_derivs_launch(const void* atoms, int n_atoms,
                                     void* out, int nx, int ny, int nz,
                                     float ox, float oy, float oz, float sx,
                                     float sy, float sz, int grid_type,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)nx * ny * nz;
  if (total <= 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  const float4* a = static_cast<const float4*>(atoms);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (grid_type) {
    case 0:
      gridgen_derivs_kernel<0><<<grid, kThreads, 0, s>>>(
          a, n_atoms, o, total, ny, nz, ox, oy, oz, sx, sy, sz);
      break;
    case 1:
      gridgen_derivs_kernel<1><<<grid, kThreads, 0, s>>>(
          a, n_atoms, o, total, ny, nz, ox, oy, oz, sx, sy, sz);
      break;
    case 2:
      gridgen_derivs_kernel<2><<<grid, kThreads, 0, s>>>(
          a, n_atoms, o, total, ny, nz, ox, oy, oz, sx, sy, sz);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gridgen_derivs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
