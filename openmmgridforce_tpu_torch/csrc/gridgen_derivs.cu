// Raw 27-derivative receptor field sums on a rectilinear grid, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// openmmgridforce_tpu/ops/pallas_gridgen_derivs.py (_derivs_kernel, entry
// generate_raw_derivs_pallas). For every grid point (flat index
// i*ny*nz + j*nz + k, position origin + (i0 + i, j0 + j, k0 + k) *
// spacing, where (i0, j0, k0) places the launch's points in a larger grid,
// so that a slab of a tiled file is the same function of the global index
// as the whole grid) it computes
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
// - Float64. The kernel is a template on the scalar type; the float64
//   instantiation (gridgen_derivs_launch_f64) takes a [A, 4] float64 atom
//   table and writes float64 sums. FP64 has no special-function pipe: 1/r
//   is the double rsqrt(), a few FP64 operations. It keeps no partials:
//   a float64 sum of 9k terms rounds at about 1e-12 of its largest term,
//   far inside its 1e-10 gate, and 27 partials more (54 registers) would
//   crowd the 27 totals and the pair's terms out of the register file
//   (ptxas prints its count and spills). The slot constants that the
//   float32 kernel applies where a partial joins its total are applied
//   once, after the atom loop. Its bound is the FP64 pipe, about 34
//   TFLOP/s on an H100 SXM, half the FP32 rate.
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

// the float64 instantiation's launch: no partials (see the note above);
// unrolled by 2 it takes 122-124 registers and runs 1-3% faster than not
// unrolled (118), 64 threads a block the same (kernel_variants.py, an H100
// SXM at 700 W)
constexpr int kThreads64 = 128;
constexpr int kUnroll64 = 2;

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
  static constexpr int threads = kThreads, atom_block = kAtomBlock;
  // partials of atom_block atoms, joined into the totals
  static constexpr bool partials = true;
  static constexpr float r2_min = 4e-4f;
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
};
template <>
struct Real<double> {
  using Atom = Atom64;
  static constexpr int threads = kThreads64, atom_block = kThreads64;
  static constexpr bool partials = false;
  static constexpr double r2_min = 4e-4;
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
};

// adds one atom's 27 derivative terms at displacement (dx, dy, dz) to
// part; slots 1-3, 5, 6, 8 and 13 lack their constant (see join)
template <int GRID_TYPE, typename T>
__device__ __forceinline__ void add_pair(T dx, T dy, T dz, T K,
                                         T (&part)[kSlots]) {
  using F = Field<GRID_TYPE>;
  using R = Real<T>;
  const T r2 = R::max(R::fma(dz, dz, R::fma(dy, dy, dx * dx)), R::r2_min);
  const T inv_r = R::rsqrt(r2);  // r >= 0.02 nm

  T inv_rm = inv_r;
  if (F::m > 1) {
    const T i3 = inv_r * inv_r * inv_r;
    inv_rm = i3 * i3;
    if (F::m == 12) inv_rm *= inv_rm;
  }
  const T P0 = K * inv_rm;  // U
  const T P1 = P0 * inv_r;
  const T P2 = P1 * inv_r;
  const T P3 = P2 * inv_r;
  const T P4 = P3 * inv_r;
  const T P5 = P4 * inv_r;
  const T P6 = P5 * inv_r;

  const T nx = dx * inv_r;
  const T ny = dy * inv_r;
  const T nz = dz * inv_r;
  const T nx2 = nx * nx;
  const T ny2 = ny * ny;
  const T nz2 = nz * nz;
  const T xy = nx * ny;
  const T xz = nx * nz;
  const T yz = ny * nz;
  const T qxy = nx2 * ny2;
  const T qxz = nx2 * nz2;
  const T qyz = ny2 * nz2;
  const T sxy = nx2 + ny2;
  const T sxz = nx2 + nz2;
  const T syz = ny2 + nz2;

  part[0] += P0;
  // order 1: t1 P1 n (t1 at the join)
  part[1] = R::fma(P1, nx, part[1]);
  part[2] = R::fma(P1, ny, part[2]);
  part[3] = R::fma(P1, nz, part[3]);
  // order 2: P2 (t2 n_i n_j + t1 delta_ij) (t2 of xy, xz, yz at the join)
  part[4] = R::fma(P2, R::fma(F::t2, nx2, F::c1), part[4]);
  part[5] = R::fma(P2, xy, part[5]);
  part[6] = R::fma(P2, xz, part[6]);
  part[7] = R::fma(P2, R::fma(F::t2, ny2, F::c1), part[7]);
  part[8] = R::fma(P2, yz, part[8]);
  part[9] = R::fma(P2, R::fma(F::t2, nz2, F::c1), part[9]);
  // order 3: iij = P3 n_j (t3 n_i^2 + t2); xyz = t3 P3 nx ny nz (t3 at
  // the join)
  const T P3x = P3 * nx;
  const T P3y = P3 * ny;
  const T P3z = P3 * nz;
  const T g3x = R::fma(F::t3, nx2, F::t2);
  const T g3y = R::fma(F::t3, ny2, F::t2);
  const T g3z = R::fma(F::t3, nz2, F::t2);
  part[10] = R::fma(P3y, g3x, part[10]);
  part[11] = R::fma(P3z, g3x, part[11]);
  part[12] = R::fma(P3x, g3y, part[12]);
  part[13] = R::fma(P3z, xy, part[13]);
  part[14] = R::fma(P3z, g3y, part[14]);
  part[15] = R::fma(P3x, g3z, part[15]);
  part[16] = R::fma(P3y, g3z, part[16]);
  // order 4: iijj = P4 (t4 n_i^2 n_j^2 + t3 (n_i^2 + n_j^2) + t2);
  // iijk = P4 n_j n_k (t4 n_i^2 + t3)
  part[17] = R::fma(P4, R::fma(F::t4, qxy, R::fma(F::t3, sxy, F::t2)),
                    part[17]);
  part[18] = R::fma(P4, R::fma(F::t4, qxz, R::fma(F::t3, sxz, F::t2)),
                    part[18]);
  part[19] = R::fma(P4, R::fma(F::t4, qyz, R::fma(F::t3, syz, F::t2)),
                    part[19]);
  part[20] = R::fma(P4 * yz, R::fma(F::t4, nx2, F::t3), part[20]);
  part[21] = R::fma(P4 * xz, R::fma(F::t4, ny2, F::t3), part[21]);
  part[22] = R::fma(P4 * xy, R::fma(F::t4, nz2, F::t3), part[22]);
  // order 5: iijjk = P5 n_k (t5 n_i^2 n_j^2 + t4 (n_i^2 + n_j^2) + t3)
  part[23] = R::fma(P5 * nz, R::fma(F::t5, qxy, R::fma(F::t4, sxy, F::t3)),
                    part[23]);
  part[24] = R::fma(P5 * ny, R::fma(F::t5, qxz, R::fma(F::t4, sxz, F::t3)),
                    part[24]);
  part[25] = R::fma(P5 * nx, R::fma(F::t5, qyz, R::fma(F::t4, syz, F::t3)),
                    part[25]);
  // order 6: P6 (t6 nx^2 ny^2 nz^2 + t5 (sum of n_i^2 n_j^2)
  //              + t4 (sum of n_i^2) + t3)
  part[26] = R::fma(
      P6,
      R::fma(F::t6, qxy * nz2,
             R::fma(F::t5, (qxy + qxz) + qyz,
                    R::fma(F::t4, sxy + nz2, F::t3))),
      part[26]);
}

// the constant that multiplies slot s as a whole: applied where a partial
// joins the total (float32), or once after the atom loop (float64)
template <int GRID_TYPE>
__device__ __forceinline__ float slot_constant(int s) {
  using F = Field<GRID_TYPE>;
  return (s >= 1 && s <= 3)             ? F::c1
         : (s == 5 || s == 6 || s == 8) ? F::t2
         : (s == 13)                    ? F::t3
                                        : 1.0f;
}

// adds a block of partials to the totals; the slots that one constant
// multiplies as a whole take it here, inside the FMA
template <int GRID_TYPE, typename T>
__device__ __forceinline__ void join(const T (&part)[kSlots],
                                     T (&acc)[kSlots]) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const float c = slot_constant<GRID_TYPE>(s);
    acc[s] = Real<T>::fma(c, part[s], acc[s]);
  }
}

template <int GRID_TYPE, typename T>
__global__ void __launch_bounds__(Real<T>::threads)
gridgen_derivs_kernel(const typename Real<T>::Atom* __restrict__ atoms,
                      int n_atoms, T* __restrict__ out, long long total,
                      int ny, int nz, int i0, int j0, int k0, T ox, T oy,
                      T oz, T sx, T sy, T sz) {
  using R = Real<T>;
  constexpr int kThreadsT = R::threads, kAtomBlockT = R::atom_block;
  __shared__ typename R::Atom tile[kThreadsT];
  __shared__ T stage[kThreadsT * kSlots];

  const long long p0 = (long long)blockIdx.x * kThreadsT;
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
  const T gx = R::add_rn(ox, R::mul_rn((T)(i0 + i), sx));
  const T gy = R::add_rn(oy, R::mul_rn((T)(j0 + j), sy));
  const T gz = R::add_rn(oz, R::mul_rn((T)(k0 + k), sz));

  T acc[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) acc[s] = T(0);

  for (int a0 = 0; a0 < n_atoms; a0 += kThreadsT) {
    const int a = a0 + threadIdx.x;
    if (a < n_atoms) tile[threadIdx.x] = atoms[a];
    __syncthreads();
    const int n_tile = min(kThreadsT, n_atoms - a0);
    if constexpr (R::partials) {
      for (int b0 = 0; b0 < n_tile; b0 += kAtomBlockT) {
        const int b1 = min(b0 + kAtomBlockT, n_tile);
        T part[kSlots];
#pragma unroll
        for (int s = 0; s < kSlots; ++s) part[s] = T(0);
#pragma unroll(kUnroll)
        for (int b = b0; b < b1; ++b) {
          const typename R::Atom at = tile[b];
          add_pair<GRID_TYPE, T>(R::sub_rn(gx, at.x), R::sub_rn(gy, at.y),
                                 R::sub_rn(gz, at.z), at.w, part);
        }
        join<GRID_TYPE, T>(part, acc);
      }
    } else {
#pragma unroll(kUnroll64)
      for (int b = 0; b < n_tile; ++b) {
        const typename R::Atom at = tile[b];
        add_pair<GRID_TYPE, T>(R::sub_rn(gx, at.x), R::sub_rn(gy, at.y),
                               R::sub_rn(gz, at.z), at.w, acc);
      }
    }
    __syncthreads();
  }
  if constexpr (!R::partials) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      acc[s] *= (T)slot_constant<GRID_TYPE>(s);
  }

#pragma unroll
  for (int s = 0; s < kSlots; ++s) stage[threadIdx.x * kSlots + s] = acc[s];
  __syncthreads();
  // the block's points are one contiguous run of out; the ragged tail of
  // the last block is cut here
  const long long left = total - p0;
  const int n_out = (int)(left < kThreadsT ? left : kThreadsT) * kSlots;
  T* dst = out + p0 * kSlots;
  for (int t = threadIdx.x; t < n_out; t += kThreadsT) dst[t] = stage[t];
}

template <int GRID_TYPE, typename T>
int launch(const void* atoms, int n_atoms, void* out, long long total,
           int ny, int nz, int i0, int j0, int k0, T ox, T oy, T oz, T sx,
           T sy, T sz, unsigned blocks, cudaStream_t stream) {
  gridgen_derivs_kernel<GRID_TYPE, T><<<blocks, Real<T>::threads, 0,
                                        stream>>>(
      static_cast<const typename Real<T>::Atom*>(atoms), n_atoms,
      static_cast<T*>(out), total, ny, nz, i0, j0, k0, ox, oy, oz, sx, sy,
      sz);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(const void* atoms, int n_atoms, void* out, int nx, int ny,
               int nz, int i0, int j0, int k0, T ox, T oy, T oz, T sx, T sy,
               T sz, int grid_type, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)nx * ny * nz;
  if (total <= 0) return 0;
  const long long blocks = (total + Real<T>::threads - 1) / Real<T>::threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (grid_type) {
    case 0:
      return launch<0, T>(atoms, n_atoms, out, total, ny, nz, i0, j0, k0, ox,
                          oy, oz, sx, sy, sz, (unsigned)blocks, s);
    case 1:
      return launch<1, T>(atoms, n_atoms, out, total, ny, nz, i0, j0, k0, ox,
                          oy, oz, sx, sy, sz, (unsigned)blocks, s);
    case 2:
      return launch<2, T>(atoms, n_atoms, out, total, ny, nz, i0, j0, k0, ox,
                          oy, oz, sx, sy, sz, (unsigned)blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int GRID_TYPE, typename T>
int resident_blocks(int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, gridgen_derivs_kernel<GRID_TYPE, T>, Real<T>::threads, 0);
}

template <typename T>
int launch_shape(int nx, int ny, int nz, int grid_type, long long* blocks,
                 int* threads, int* blocks_per_sm) {
  const long long total = (long long)nx * ny * nz;
  *blocks = (total + Real<T>::threads - 1) / Real<T>::threads;
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

// float32 atoms [A, 4] -> float32 out [nx, ny, nz, 27]; (i0, j0, k0) is
// the index of the launch's first point in the grid that origin and
// spacing describe
extern "C" int gridgen_derivs_launch(const void* atoms, int n_atoms,
                                     void* out, int nx, int ny, int nz,
                                     int i0, int j0, int k0, float ox,
                                     float oy, float oz, float sx, float sy,
                                     float sz, int grid_type, int device,
                                     void* stream) {
  return launch_any<float>(atoms, n_atoms, out, nx, ny, nz, i0, j0, k0, ox,
                           oy, oz, sx, sy, sz, grid_type, device, stream);
}

// the same in float64
extern "C" int gridgen_derivs_launch_f64(const void* atoms, int n_atoms,
                                         void* out, int nx, int ny, int nz,
                                         int i0, int j0, int k0, double ox,
                                         double oy, double oz, double sx,
                                         double sy, double sz, int grid_type,
                                         int device, void* stream) {
  return launch_any<double>(atoms, n_atoms, out, nx, ny, nz, i0, j0, k0, ox,
                            oy, oz, sx, sy, sz, grid_type, device, stream);
}

// the launch's shape for a grid of nx x ny x nz points: blocks, threads
// per block, and the blocks of this kernel that one SM holds at a time;
// f64 selects the float64 instantiation
extern "C" int gridgen_derivs_launch_shape(int nx, int ny, int nz,
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

extern "C" const char* gridgen_derivs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
