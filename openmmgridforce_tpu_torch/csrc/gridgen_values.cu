// Capped receptor field values on a rectilinear grid, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel openmmgridforce_tpu/ops/pallas_gridgen.py
// (_gen_kernel, entry generate_grid_values_pallas). For every grid point
// (flat index i*ny*nz + j*nz + k, position origin + (i, j, k) * spacing)
// it computes
//
//     cap * tanh(sum_a K_a * r_a^-p / cap),   p = 1 (charge), 12 (ljr), 6 (lja)
//
// with r^2 clamped at 1e-12 nm^2 and tanh saturated to +-1 for |u| > 20,
// forming the powers exactly as the Pallas kernel does. The host computes
// the per-atom strength K (k q, sqrt(eps) Rmin^6 or -2 sqrt(eps) Rmin^3).
//
// Bound: operations. Per point-atom pair: 3 subtractions, r^2 (3
// multiplies, 2 adds), the clamp, one MUFU rsqrt, the power (0 / 4 / 3
// multiplies for charge / ljr / lja), the multiply by K and the add: 12 /
// 16 / 15 FP32 operations. The main path's grids have about 1.5e6 points
// x 9133 atoms = 1.4e10 pairs. At the H100 SXM's FP32 peak (132 SMs x 128
// lanes x 2 x 1.98 GHz = 67 TFLOP/s) that is 2.4 / 3.3 / 3.0 ms per grid.
// Counted as issued instructions (ptxas fuses the r^2 and K terms into
// FMAs: about 9 / 13 / 12 per pair at 3.3e13 per second) it is 3.7 - 5.3
// ms, and the MUFU pipe (16 lanes per SM, 4.2e12 rsqrt/s) needs 3.3 ms.
// The bytes (16 per atom in, 4 per point out) are negligible.
//
// Design: the all-pairs N-body pattern. One thread per grid point, so each
// warp stores 32 consecutive floats. Receptor atoms stream through shared
// memory in tiles of blockDim.x float4 (x, y, z, K); every thread of the
// block reads the same atom at once (a broadcast), so shared memory costs
// one load per pair per warp against ~10 arithmetic instructions. The sum
// is two f32 registers: a partial over 32 atoms and the point's total.
// The atom loop bounds itself, so no padding atoms are needed; the ragged
// tail of points is masked at the store. Flat indices are 64-bit.
// Register tiling of several points per thread and cluster multicast of
// the atom tiles are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// atoms summed into a partial before it joins the point's total, as the
// TPU kernel sums blocks of 32 atoms: this keeps the f32 rounding of the
// 9k-term sum close to the reference's
constexpr int kAtomBlock = 32;

template <int GRID_TYPE>
__global__ void __launch_bounds__(kThreads)
gridgen_values_kernel(const float4* __restrict__ atoms, int n_atoms,
                      float* __restrict__ out, long long total, int ny,
                      int nz, float ox, float oy, float oz, float sx,
                      float sy, float sz, float cap) {
  __shared__ float4 tile[kThreads];

  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool valid = p < total;
  const long long q = valid ? p : total - 1;
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

  float acc = 0.0f;
  for (int a0 = 0; a0 < n_atoms; a0 += kThreads) {
    const int a = a0 + threadIdx.x;
    if (a < n_atoms) tile[threadIdx.x] = atoms[a];
    __syncthreads();
    const int n_tile = min(kThreads, n_atoms - a0);
    for (int b0 = 0; b0 < n_tile; b0 += kAtomBlock) {
      const int b1 = min(b0 + kAtomBlock, n_tile);
      float part = 0.0f;
      for (int b = b0; b < b1; ++b) {
        const float4 at = tile[b];
        const float dx = gx - at.x;
        const float dy = gy - at.y;
        const float dz = gz - at.z;
        float r2 = dx * dx + dy * dy + dz * dz;
        r2 = fmaxf(r2, 1e-12f);  // r >= 1e-6 nm
        const float inv_r = rsqrtf(r2);
        float c;
        if (GRID_TYPE == 0) {         // charge: K / r
          c = at.w * inv_r;
        } else if (GRID_TYPE == 1) {  // ljr: K / r^12
          const float inv_r2 = inv_r * inv_r;
          const float inv_r4 = inv_r2 * inv_r2;
          c = at.w * (inv_r4 * inv_r4 * inv_r4);
        } else {                      // lja: K / r^6
          const float inv_r2 = inv_r * inv_r;
          c = at.w * (inv_r2 * inv_r2 * inv_r2);
        }
        part += c;
      }
      acc += part;
    }
    __syncthreads();
  }

  if (valid) {
    const float u = acc / cap;
    const float t = u > 20.0f ? 1.0f : (u < -20.0f ? -1.0f : tanhf(u));
    out[p] = cap * t;
  }
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
      gridgen_values_kernel<0><<<grid, kThreads, 0, s>>>(
          a, n_atoms, o, total, ny, nz, ox, oy, oz, sx, sy, sz, cap);
      break;
    case 1:
      gridgen_values_kernel<1><<<grid, kThreads, 0, s>>>(
          a, n_atoms, o, total, ny, nz, ox, oy, oz, sx, sy, sz, cap);
      break;
    case 2:
      gridgen_values_kernel<2><<<grid, kThreads, 0, s>>>(
          a, n_atoms, o, total, ny, nz, ox, oy, oz, sx, sy, sz, cap);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gridgen_values_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
