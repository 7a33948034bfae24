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
// with r^2 clamped at 4e-4 nm^2. The host computes the per-atom strength
// K. The tanh cap, the inverse-power chain rule and the cell-fractional
// scaling are a per-point pass in PyTorch afterwards.
//
// Bound: operations. With the work shared the function needs 145 / 149 /
// 148 FP32 operations per pair (charge / ljr / lja, an FMA counted as two;
// the plain twin in ops/cuda_gridgen_derivs.py is that formulation and a
// test traces its count) and one rsqrt. The main path's grids have 1.49e6
// points x 9133 atoms = 1.36e10 pairs, so 2e12 operations: about 30 ms per
// grid at the H100 SXM's 67 TFLOP/s FP32 peak. The rsqrt (MUFU) pipe needs
// 3.3 ms and the bytes (16 per atom in, 108 per point out: 161 MB) 0.05
// ms. The peak assumes that every instruction is an FMA; what the kernel
// can reach is set by the instructions it issues, one per clock on each of
// the SM's four schedulers (3.3e13 per second on the card), so the design
// below counts instructions.
//
// Design.
// - The cascade is folded. For U = K / r^m every radial combination of
//   order n is a constant times P_n = K / r^(m+n):
//   A_n = t_n P_n, B_n = t_(n-1) P_n, C_n = t_(n-2) P_n, D_6 = t_3 P_6,
//   dU = t_1 P_1, with t_n = (-1)^n m (m+2) ... (m+2n-2). A slot of order n
//   is therefore P_n times a polynomial in the direction products with
//   constant coefficients, e.g. xxyy = P_4 (t_4 nx^2 ny^2 + t_3 (nx^2 +
//   ny^2) + t_2). 1/r^m comes from squarings, P_1..P_6 from a chain of
//   multiplies by 1/r (at the clamp the ljr P_6 is of order 1e31 K, inside
//   float32 but near its end: the large constants only ever multiply
//   direction products, which are at most 1).
// - Every term is shaped as FMAs that end in the accumulator: the
//   polynomial is built by fmaf on constants and the slot finishes with
//   part = fmaf(P_n * (cosine), polynomial, part). Each direction product
//   is formed once. Slots that are one constant times a sum (x y z, xy xz
//   yz, xyz) take their constant where the partial joins the total, inside
//   that FMA. The atom loop is 98 / 102 / 101 instructions per pair in
//   the machine code (52 FFMA, 30-34 FMUL, 10 FADD, one MUFU, one LDS, the
//   clamp and the loop's 3), of them 64 for the 27 slots; the unfolded
//   cascade issued about 240. On an H100 SXM at 700 W that is 49 - 53 ms
//   per grid of the main path, 1.7x the bound and about 82% of the issue
//   rate (the unfolded kernel took 100 - 104 ms).
// - All-pairs N-body pattern: one thread per grid point; receptor atoms
//   stream through shared memory in tiles of blockDim.x float4 (x, y, z,
//   K), every thread of the block reading the same atom at once (a
//   broadcast). The atom loop is unrolled by kUnroll so that two pairs'
//   rsqrt and multiply chains overlap. A thread keeps one point: a second
//   point would share only the load, dx, dy and dx^2 + dy^2 (4 of 100
//   instructions) and double the 54 accumulators, which already fill most
//   of the 91 - 93 registers (5 blocks, 20 warps an SM).
// - Each thread keeps 27 totals and 27 partials in registers; a partial
//   takes kAtomBlock atoms before it joins its total, which keeps the
//   float32 rounding of a 9k-term signed sum small (the gate is 5e-5 of a
//   slot's largest value against the float32 twin and 2e-4 against the
//   float64 twin). Partials of 8 atoms cost 7% more time; 32 and 128 run
//   alike and all three give the same error, which the float32 grid
//   positions set, not the sums. 128 threads per block leave each thread
//   up to 255 registers; nothing spills.
// - The grid type is a template parameter: the power and the constants
//   fold into the instructions. The atom loop bounds itself (no padding
//   atoms), flat indices are 64-bit (27 x points passes 2^31 on large
//   grids), and the grid point is formed with a rounded multiply and a
//   rounded add as the reference forms it.
// - Output layout: [points, 27], point-major, which is what the callers
//   index ([nx, ny, nz, 27]). A thread's 27 sums are 27 floats apart from
//   its neighbour's, so storing them straight from registers would be
//   strided; writing 27 point-major planes would be coalesced but needs a
//   transpose of 161 MB per grid afterwards. Instead the block stages its
//   128 x 27 sums in shared memory (stride 27 is odd: no bank conflicts)
//   and copies them out as one contiguous, coalesced run.
// - Not done, on purpose: tensor cores (the sums are no matrix product at
//   a precision the gates allow) and cluster multicast of the atom tiles
//   (the atoms are 146 KB and live in L2; shared memory sees one broadcast
//   load per pair per warp against ~100 arithmetic instructions).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// atoms summed into a partial before it joins the point's total
constexpr int kAtomBlock = 32;
// pairs in flight in the atom loop
constexpr int kUnroll = 2;
constexpr int kSlots = 27;

// U = K / r^m. c_n = (-1)^n m (m+1) ... (m+n-1) is the coefficient of the
// n-th radial derivative (kept for reference: the kernel needs only
// c1 = t1); t_n = (-1)^n m (m+2) ... (m+2n-2) is what the cascade
// combinations fold to. All are exact in float32.
template <int GRID_TYPE>
struct Field;
template <>
struct Field<0> {  // charge, m = 1
  static constexpr int m = 1;
  static constexpr float c1 = -1.0f, c2 = 2.0f, c3 = -6.0f, c4 = 24.0f,
                         c5 = -120.0f, c6 = 720.0f;
  static constexpr float t2 = 3.0f, t3 = -15.0f, t4 = 105.0f, t5 = -945.0f,
                         t6 = 10395.0f;
};
template <>
struct Field<1> {  // ljr, m = 12
  static constexpr int m = 12;
  static constexpr float c1 = -12.0f, c2 = 156.0f, c3 = -2184.0f,
                         c4 = 32760.0f, c5 = -524160.0f, c6 = 8910720.0f;
  static constexpr float t2 = 168.0f, t3 = -2688.0f, t4 = 48384.0f,
                         t5 = -967680.0f, t6 = 21288960.0f;
};
template <>
struct Field<2> {  // lja, m = 6
  static constexpr int m = 6;
  static constexpr float c1 = -6.0f, c2 = 42.0f, c3 = -336.0f, c4 = 3024.0f,
                         c5 = -30240.0f, c6 = 332640.0f;
  static constexpr float t2 = 48.0f, t3 = -480.0f, t4 = 5760.0f,
                         t5 = -80640.0f, t6 = 1290240.0f;
};

// one MUFU.RSQ; the argument is clamped to a normal number first
__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// adds one atom's 27 derivative terms at displacement (dx, dy, dz) to
// part; slots 1-3, 5, 6, 8 and 13 lack their constant (see join)
template <int GRID_TYPE>
__device__ __forceinline__ void add_pair(float dx, float dy, float dz,
                                         float K, float (&part)[kSlots]) {
  using F = Field<GRID_TYPE>;
  const float r2 = fmaxf(fmaf(dz, dz, fmaf(dy, dy, dx * dx)), 4e-4f);
  const float inv_r = rsqrt_approx(r2);  // r >= 0.02 nm

  float inv_rm = inv_r;
  if (F::m > 1) {
    const float i3 = inv_r * inv_r * inv_r;
    inv_rm = i3 * i3;
    if (F::m == 12) inv_rm *= inv_rm;
  }
  const float P0 = K * inv_rm;  // U
  const float P1 = P0 * inv_r;
  const float P2 = P1 * inv_r;
  const float P3 = P2 * inv_r;
  const float P4 = P3 * inv_r;
  const float P5 = P4 * inv_r;
  const float P6 = P5 * inv_r;

  const float nx = dx * inv_r;
  const float ny = dy * inv_r;
  const float nz = dz * inv_r;
  const float nx2 = nx * nx;
  const float ny2 = ny * ny;
  const float nz2 = nz * nz;
  const float xy = nx * ny;
  const float xz = nx * nz;
  const float yz = ny * nz;
  const float qxy = nx2 * ny2;
  const float qxz = nx2 * nz2;
  const float qyz = ny2 * nz2;
  const float sxy = nx2 + ny2;
  const float sxz = nx2 + nz2;
  const float syz = ny2 + nz2;

  part[0] += P0;
  // order 1: t1 P1 n (t1 at the join)
  part[1] = fmaf(P1, nx, part[1]);
  part[2] = fmaf(P1, ny, part[2]);
  part[3] = fmaf(P1, nz, part[3]);
  // order 2: P2 (t2 n_i n_j + t1 delta_ij) (t2 of xy, xz, yz at the join)
  part[4] = fmaf(P2, fmaf(F::t2, nx2, F::c1), part[4]);
  part[5] = fmaf(P2, xy, part[5]);
  part[6] = fmaf(P2, xz, part[6]);
  part[7] = fmaf(P2, fmaf(F::t2, ny2, F::c1), part[7]);
  part[8] = fmaf(P2, yz, part[8]);
  part[9] = fmaf(P2, fmaf(F::t2, nz2, F::c1), part[9]);
  // order 3: iij = P3 n_j (t3 n_i^2 + t2); xyz = t3 P3 nx ny nz (t3 at
  // the join)
  const float P3x = P3 * nx;
  const float P3y = P3 * ny;
  const float P3z = P3 * nz;
  const float g3x = fmaf(F::t3, nx2, F::t2);
  const float g3y = fmaf(F::t3, ny2, F::t2);
  const float g3z = fmaf(F::t3, nz2, F::t2);
  part[10] = fmaf(P3y, g3x, part[10]);
  part[11] = fmaf(P3z, g3x, part[11]);
  part[12] = fmaf(P3x, g3y, part[12]);
  part[13] = fmaf(P3z, xy, part[13]);
  part[14] = fmaf(P3z, g3y, part[14]);
  part[15] = fmaf(P3x, g3z, part[15]);
  part[16] = fmaf(P3y, g3z, part[16]);
  // order 4: iijj = P4 (t4 n_i^2 n_j^2 + t3 (n_i^2 + n_j^2) + t2);
  // iijk = P4 n_j n_k (t4 n_i^2 + t3)
  part[17] = fmaf(P4, fmaf(F::t4, qxy, fmaf(F::t3, sxy, F::t2)), part[17]);
  part[18] = fmaf(P4, fmaf(F::t4, qxz, fmaf(F::t3, sxz, F::t2)), part[18]);
  part[19] = fmaf(P4, fmaf(F::t4, qyz, fmaf(F::t3, syz, F::t2)), part[19]);
  part[20] = fmaf(P4 * yz, fmaf(F::t4, nx2, F::t3), part[20]);
  part[21] = fmaf(P4 * xz, fmaf(F::t4, ny2, F::t3), part[21]);
  part[22] = fmaf(P4 * xy, fmaf(F::t4, nz2, F::t3), part[22]);
  // order 5: iijjk = P5 n_k (t5 n_i^2 n_j^2 + t4 (n_i^2 + n_j^2) + t3)
  part[23] = fmaf(P5 * nz, fmaf(F::t5, qxy, fmaf(F::t4, sxy, F::t3)),
                  part[23]);
  part[24] = fmaf(P5 * ny, fmaf(F::t5, qxz, fmaf(F::t4, sxz, F::t3)),
                  part[24]);
  part[25] = fmaf(P5 * nx, fmaf(F::t5, qyz, fmaf(F::t4, syz, F::t3)),
                  part[25]);
  // order 6: P6 (t6 nx^2 ny^2 nz^2 + t5 (sum of n_i^2 n_j^2)
  //              + t4 (sum of n_i^2) + t3)
  part[26] = fmaf(
      P6,
      fmaf(F::t6, qxy * nz2,
           fmaf(F::t5, (qxy + qxz) + qyz, fmaf(F::t4, sxy + nz2, F::t3))),
      part[26]);
}

// adds a block of partials to the totals; the slots that one constant
// multiplies as a whole take it here, inside the FMA
template <int GRID_TYPE>
__device__ __forceinline__ void join(const float (&part)[kSlots],
                                     float (&acc)[kSlots]) {
  using F = Field<GRID_TYPE>;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const float c = (s >= 1 && s <= 3)             ? F::c1
                    : (s == 5 || s == 6 || s == 8) ? F::t2
                    : (s == 13)                    ? F::t3
                                                   : 1.0f;
    acc[s] = fmaf(c, part[s], acc[s]);
  }
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
#pragma unroll(kUnroll)
      for (int b = b0; b < b1; ++b) {
        const float4 at = tile[b];
        add_pair<GRID_TYPE>(__fsub_rn(gx, at.x), __fsub_rn(gy, at.y),
                            __fsub_rn(gz, at.z), at.w, part);
      }
      join<GRID_TYPE>(part, acc);
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

template <int GRID_TYPE>
int launch(const float4* atoms, int n_atoms, float* out, long long total,
           int ny, int nz, float ox, float oy, float oz, float sx, float sy,
           float sz, unsigned blocks, cudaStream_t stream) {
  gridgen_derivs_kernel<GRID_TYPE><<<blocks, kThreads, 0, stream>>>(
      atoms, n_atoms, out, total, ny, nz, ox, oy, oz, sx, sy, sz);
  return (int)cudaGetLastError();
}

template <int GRID_TYPE>
int resident_blocks(int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, gridgen_derivs_kernel<GRID_TYPE>, kThreads, 0);
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
  const float4* a = static_cast<const float4*>(atoms);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (grid_type) {
    case 0:
      return launch<0>(a, n_atoms, o, total, ny, nz, ox, oy, oz, sx, sy, sz,
                       (unsigned)blocks, s);
    case 1:
      return launch<1>(a, n_atoms, o, total, ny, nz, ox, oy, oz, sx, sy, sz,
                       (unsigned)blocks, s);
    case 2:
      return launch<2>(a, n_atoms, o, total, ny, nz, ox, oy, oz, sx, sy, sz,
                       (unsigned)blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the launch's shape for a grid of nx x ny x nz points: blocks, threads
// per block, and the blocks of this kernel that one SM holds at a time
extern "C" int gridgen_derivs_launch_shape(int nx, int ny, int nz,
                                           int grid_type, int device,
                                           long long* blocks, int* threads,
                                           int* blocks_per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)nx * ny * nz;
  *blocks = (total + kThreads - 1) / kThreads;
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

extern "C" const char* gridgen_derivs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
