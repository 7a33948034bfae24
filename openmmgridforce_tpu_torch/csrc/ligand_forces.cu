// The MD step's intra-ligand terms for Hopper (sm_90a): the bonded terms
// (harmonic bonds and angles, periodic torsions) and the intra-ligand
// pairs (Coulomb and Lennard-Jones), each one launch a step.
//
// Replaces no TPU kernel. The JAX package computes these terms with XLA
// operations (openmmgridforce_tpu/mm/forcefield.py, bonded_energy_forces;
// openmmgridforce_tpu/ops/pairwise.py, pair_energy_forces); in the port
// they were chains of ATen operations (mm/forcefield.py and
// ops/pairwise.py, now the plain twins): about 135 launches a step for
// the bonded terms, with a fixed-order row sum (ops/scatter.py), and 35
// for the pairs, whose dense [R, N, N, 3] broadcasts move 26 MB each at
// 1000 replicas of 47 atoms. They held 93% of a step's device time.
//
// Bound: launches and latency. A step reads R x N positions and writes as
// many forces (1.1 MB in float32 at 1000 x 47: 0.34 us at 3.35 TB/s) and
// computes about 55 MFLOP (under 1 us at 67 TFLOP/s). The work of one
// replica is a few hundred terms, each a short dependent chain (a torsion
// is a few hundred instructions, with atan2, sin and cos), so a kernel
// takes the latency of one block's chain, a few microseconds.
//
// Design (ops/cuda_ligand_forces.py builds the tables and the launch plan).
// - A block takes one or more whole replicas (several when N is small):
//   it stages their positions in shared memory, and every read of a
//   position after that is from shared memory. Nothing is shared between
//   blocks, and no atomics are used.
// - The per-atom tables are staged in shared memory too, in 16-byte loads
//   with several in flight a thread, so that each loop over an atom's rows
//   or partners waits on shared memory, not on a chain of dependent reads
//   from L2 or HBM (at d = 6 K3's rows evict them from L2 between steps).
//   A pair table too large to stage beside a replica is read from device
//   memory with the same loads.
// - Bonded: each thread computes whole terms (bonds, then angles, then
//   torsions) and writes each term's rows of force into shared memory at
//   the row's place in the twin's concatenation; then each atom's thread
//   sums the rows it receives, in the order of the host's per-atom table
//   (ops/scatter.py, row_table). Each term's energy is kept in shared
//   memory too. 128 threads a replica: the MD cells' 1000 blocks fit the
//   card in one wave at 44 registers, where 256 took two.
// - Pairs: each atom's thread loops over its live partners in the host's
//   fixed order (both directions of every pair of the dense table, each
//   entry qq, sigma, epsilon and the partner in one 16-byte load in
//   float32) and sums its force in registers; a pair's energy counts on
//   the lower atom's thread only. The epilogue adds the bonded kernel's
//   energies and forces, so the step has no separate sums.
// - Energies: a warp per replica adds the replica's values (the terms',
//   or the atoms') lane by lane in index order, then by xor shuffles, which
//   give every lane the same sum. A replica's result does not depend on
//   the block it lies in, so a replica computes alike in any batch.
// - Precise maths (sqrt, acos, atan2, sin, cos; no fast-math flags) and a
//   fixed order everywhere: two launches give the same bits, and a
//   recorded segment equals its eager twin.
// - Every launch argument is a device pointer or a shape: the launch can
//   be captured into a CUDA graph.
// - Same-run times (NVIDIA H100 80GB HBM3, 700 W), a recorded call at
//   1000 x 47: bonded 10.0 us float32 / 19.6 float64, pairs 10.2 / 17.6;
//   the previous design (tables copied a value at a time, 256 threads a
//   bonded block) 12.1 / 20.4 and 13.7 / 20.1. Registers 44 / 72
//   (bonded), 42 / 58 (pairs), no spills. Both stay latency bound: one
//   block's chain of dependent instructions (a torsion with atan2, sin
//   and cos; the longest row or partner list, 48 rows and 46 partners at
//   the bench ligand).

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 256;     // threads a block (the host's plan)
constexpr int kMaxShared = 232448;   // bytes of shared memory a block
constexpr int kDevices = 64;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float p_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double p_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float p_rsqrt(float v) { return rsqrtf(v); }
__device__ __forceinline__ double p_rsqrt(double v) { return rsqrt(v); }
__device__ __forceinline__ float p_acos(float v) { return acosf(v); }
__device__ __forceinline__ double p_acos(double v) { return acos(v); }
__device__ __forceinline__ float p_atan2(float y, float x) {
  return atan2f(y, x);
}
__device__ __forceinline__ double p_atan2(double y, double x) {
  return atan2(y, x);
}
__device__ __forceinline__ float p_sin(float v) { return sinf(v); }
__device__ __forceinline__ double p_sin(double v) { return sin(v); }
__device__ __forceinline__ float p_cos(float v) { return cosf(v); }
__device__ __forceinline__ double p_cos(double v) { return cos(v); }

// v < lo ? lo : v, keeping a NaN as torch's clamp does
template <typename T>
__device__ __forceinline__ T at_least(T v, T lo) {
  return v < lo ? lo : v;
}

template <typename T>
__device__ __forceinline__ T clamp_unit(T v) {
  return v < T(-1) ? T(-1) : (v > T(1) ? T(1) : v);
}

template <typename T>
__device__ __forceinline__ void load3(const T* x, int atom, T* v) {
  v[0] = x[3 * atom];
  v[1] = x[3 * atom + 1];
  v[2] = x[3 * atom + 2];
}

template <typename T>
__device__ __forceinline__ T dot3(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// torch.linalg.cross's order
template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename T>
__device__ __forceinline__ void store3(T* rows, int row, T x, T y, T z) {
  rows[3 * row] = x;
  rows[3 * row + 1] = y;
  rows[3 * row + 2] = z;
}

// The bonded terms of one System: its own index and parameter tensors.
template <typename T>
struct Terms {
  const long long* bond_idx;      // [B, 2]
  const T* bond_k;
  const T* bond_r0;
  const long long* angle_idx;     // [A, 3]
  const T* angle_k;
  const T* angle_t0;
  const long long* torsion_idx;   // [T, 4]
  const T* torsion_k;
  const T* torsion_per;
  const T* torsion_phase;
  int n_bonds;
  int n_angles;
  int n_torsions;
};

// Rows of the twin's concatenation: bonds' first atoms, bonds' second,
// angles' first, third and centre atoms, torsions' four atoms in turn.

// E = k/2 (r - r0)^2
template <typename T>
__device__ T bond_term(const Terms<T>& t, int b, const T* x, T* rows) {
  T xi[3], xj[3];
  load3(x, (int)t.bond_idx[2 * b], xi);
  load3(x, (int)t.bond_idx[2 * b + 1], xj);
  const T d[3] = {xi[0] - xj[0], xi[1] - xj[1], xi[2] - xj[2]};
  const T r = p_sqrt(dot3(d, d));
  const T k = t.bond_k[b];
  const T dr = r - t.bond_r0[b];
  const T c = -k * dr / r;
  const T f[3] = {c * d[0], c * d[1], c * d[2]};
  store3(rows, b, f[0], f[1], f[2]);
  store3(rows, t.n_bonds + b, -f[0], -f[1], -f[2]);
  return T(0.5) * k * dr * dr;
}

// E = k/2 (theta - theta0)^2
template <typename T>
__device__ T angle_term(const Terms<T>& t, int a, const T* x, T* rows) {
  T xi[3], xj[3], xk[3];
  load3(x, (int)t.angle_idx[3 * a], xi);
  load3(x, (int)t.angle_idx[3 * a + 1], xj);
  load3(x, (int)t.angle_idx[3 * a + 2], xk);
  const T va[3] = {xi[0] - xj[0], xi[1] - xj[1], xi[2] - xj[2]};
  const T vb[3] = {xk[0] - xj[0], xk[1] - xj[1], xk[2] - xj[2]};
  const T na = p_sqrt(dot3(va, va));
  const T nb = p_sqrt(dot3(vb, vb));
  const T ah[3] = {va[0] / na, va[1] / na, va[2] / na};
  const T bh[3] = {vb[0] / nb, vb[1] / nb, vb[2] / nb};
  const T cos_t = clamp_unit(dot3(ah, bh));
  const T theta = p_acos(cos_t);
  const T sin_t = p_sqrt(at_least(T(1) - cos_t * cos_t, T(1e-12)));
  const T k = t.angle_k[a];
  const T dt = theta - t.angle_t0[a];
  // the force on the first and the third atom; the centre takes minus
  // their sum
  const T coef = k * dt / sin_t;
  T fi[3], fk[3];
  for (int c = 0; c < 3; ++c) {
    fi[c] = coef * (bh[c] - cos_t * ah[c]) / na;
    fk[c] = coef * (ah[c] - cos_t * bh[c]) / nb;
  }
  const int base = 2 * t.n_bonds;
  store3(rows, base + a, fi[0], fi[1], fi[2]);
  store3(rows, base + t.n_angles + a, fk[0], fk[1], fk[2]);
  store3(rows, base + 2 * t.n_angles + a, -(fi[0] + fk[0]),
         -(fi[1] + fk[1]), -(fi[2] + fk[2]));
  return T(0.5) * k * dt * dt;
}

// E = k (1 + cos(n phi - phase)), phi = atan2(m1 . n2, n1 . n2)
template <typename T>
__device__ T torsion_term(const Terms<T>& t, int q, const T* x, T* rows) {
  T p0[3], p1[3], p2[3], p3[3];
  load3(x, (int)t.torsion_idx[4 * q], p0);
  load3(x, (int)t.torsion_idx[4 * q + 1], p1);
  load3(x, (int)t.torsion_idx[4 * q + 2], p2);
  load3(x, (int)t.torsion_idx[4 * q + 3], p3);
  T b1[3], b2[3], b3[3];
  for (int c = 0; c < 3; ++c) {
    b1[c] = p1[c] - p0[c];
    b2[c] = p2[c] - p1[c];
    b3[c] = p3[c] - p2[c];
  }
  T n1[3], n2[3], m1[3];
  cross3(b1, b2, n1);
  cross3(b2, b3, n2);
  const T nb2 = p_sqrt(dot3(b2, b2));
  const T u[3] = {b2[0] / nb2, b2[1] / nb2, b2[2] / nb2};
  cross3(n1, u, m1);
  const T phi = p_atan2(dot3(m1, n2), dot3(n1, n2));
  const T k = t.torsion_k[q];
  const T per = t.torsion_per[q];
  const T arg = per * phi - t.torsion_phase[q];
  const T de_dphi = -k * per * p_sin(arg);
  const T n1_sq = at_least(dot3(n1, n1), T(1e-12));
  const T n2_sq = at_least(dot3(n2, n2), T(1e-12));
  const T s0 = nb2 / n1_sq;
  const T s3 = -nb2 / n2_sq;
  const T nb2_sq = nb2 * nb2;
  const T c12 = dot3(b1, b2) / nb2_sq;
  const T c32 = dot3(b3, b2) / nb2_sq;
  T d[4][3];
  for (int c = 0; c < 3; ++c) {
    d[0][c] = s0 * n1[c];
    d[3][c] = s3 * n2[c];
    d[1][c] = -(T(1) + c12) * d[0][c] + c32 * d[3][c];
    d[2][c] = -d[0][c] - d[1][c] - d[3][c];
  }
  const int base = 2 * t.n_bonds + 3 * t.n_angles;
  for (int s = 0; s < 4; ++s)
    store3(rows, base + s * t.n_torsions + q, -de_dphi * d[s][0],
           -de_dphi * d[s][1], -de_dphi * d[s][2]);
  return k * (T(1) + p_cos(arg));
}

// Each of the first `count` replicas' `n` values of `vals` (replica p's at
// vals + p * n) added lane by lane in index order, then across the warp;
// warp p of the block takes replica p. Returns the sum on every lane of
// the replica's warp (and 0 elsewhere); `*replica` is the warp's replica,
// or -1.
template <typename T>
__device__ __forceinline__ T replica_sum(const T* vals, int n, int count,
                                         int* replica) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  *replica = warp < count ? warp : -1;
  if (warp >= count) return T(0);
  T s = T(0);
  for (int i = lane; i < n; i += kWarp) s += vals[warp * n + i];
  for (int off = kWarp / 2; off > 0; off /= 2)
    s += __shfl_xor_sync(kFullMask, s, off);
  return s;
}

// Stages replicas [r0, r0 + count) of x [R, N, 3] in shared memory.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ x, long long r0,
                                      int count, int n_atoms, T* s_x) {
  const T* src = x + r0 * n_atoms * 3;
  const int n = count * n_atoms * 3;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_x[i] = src[i];
}

// Copies n values of src to shared memory, several loads in flight a
// thread (V: a 16-byte vector type where the table is made of them).
template <typename V>
__device__ __forceinline__ void stage_table(const V* __restrict__ src, int n,
                                            V* dst) {
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// A pair entry: qq, sigma, epsilon and the partner (its index held as a
// value of T), read as one or two 16-byte loads.
template <typename T>
struct Entry {
  T qq, sigma, eps;
  int partner;
};

__device__ __forceinline__ Entry<float> load_entry(const float* e) {
  const float4 v = *reinterpret_cast<const float4*>(e);
  return {v.x, v.y, v.z, (int)v.w};
}

__device__ __forceinline__ Entry<double> load_entry(const double* e) {
  const double2 a = *reinterpret_cast<const double2*>(e);
  const double2 b = *reinterpret_cast<const double2*>(e + 2);
  return {a.x, a.y, b.x, (int)b.y};
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    ligand_bonded_kernel(const T* __restrict__ x, Terms<T> t,
                         const int* __restrict__ row_start,
                         const int* __restrict__ rows, long long n_replicas,
                         int n_atoms, int per_block, T* __restrict__ energy,
                         T* __restrict__ forces) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_terms = t.n_bonds + t.n_angles + t.n_torsions;
  const int n_rows = 2 * t.n_bonds + 3 * t.n_angles + 4 * t.n_torsions;
  T* s_x = reinterpret_cast<T*>(smem);              // [P, N, 3]
  T* s_rows = s_x + per_block * n_atoms * 3;        // [P, rows, 3]
  T* s_e = s_rows + per_block * n_rows * 3;         // [P, terms]
  int* s_start = reinterpret_cast<int*>(s_e + per_block * n_terms);
  int* s_list = s_start + n_atoms + 1;              // [rows]
  const long long r0 = (long long)blockIdx.x * per_block;
  const int count = (int)min((long long)per_block, n_replicas - r0);

  stage(x, r0, count, n_atoms, s_x);
  stage_table(row_start, n_atoms + 1, s_start);
  stage_table(rows, n_rows, s_list);
  __syncthreads();

  for (int item = threadIdx.x; item < count * n_terms; item += blockDim.x) {
    const int p = item / n_terms;
    const int term = item - p * n_terms;
    const T* xp = s_x + p * n_atoms * 3;
    T* rp = s_rows + p * n_rows * 3;
    T e;
    if (term < t.n_bonds)
      e = bond_term(t, term, xp, rp);
    else if (term < t.n_bonds + t.n_angles)
      e = angle_term(t, term - t.n_bonds, xp, rp);
    else
      e = torsion_term(t, term - t.n_bonds - t.n_angles, xp, rp);
    s_e[p * n_terms + term] = e;
  }
  __syncthreads();

  for (int item = threadIdx.x; item < count * n_atoms; item += blockDim.x) {
    const int p = item / n_atoms;
    const int atom = item - p * n_atoms;
    const T* rp = s_rows + p * n_rows * 3;
    T f0 = T(0), f1 = T(0), f2 = T(0);
    const int end = s_start[atom + 1];
#pragma unroll 4
    for (int q = s_start[atom]; q < end; ++q) {
      const int row = s_list[q];
      f0 += rp[3 * row];
      f1 += rp[3 * row + 1];
      f2 += rp[3 * row + 2];
    }
    T* out = forces + ((r0 + p) * n_atoms + atom) * 3;
    out[0] = f0;
    out[1] = f1;
    out[2] = f2;
  }
  int replica;
  const T e = replica_sum(s_e, n_terms, count, &replica);
  if (replica >= 0 && threadIdx.x % kWarp == 0) energy[r0 + replica] = e;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    ligand_pairs_kernel(const T* __restrict__ x,
                        const int* __restrict__ start,
                        const T* __restrict__ entries, int n_entries,
                        int staged, T coulomb, long long n_replicas,
                        int n_atoms, int per_block,
                        const T* __restrict__ energy_in,
                        const T* __restrict__ forces_in,
                        T* __restrict__ energy, T* __restrict__ forces) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_x = reinterpret_cast<T*>(smem);              // [P, N, 3]
  T* s_e = s_x + per_block * n_atoms * 3;           // [P, N]
  T* s_tab = s_e + per_block * n_atoms;             // [E, 4], if staged
  int* s_start = reinterpret_cast<int*>(s_tab + 4 * n_entries);
  const long long r0 = (long long)blockIdx.x * per_block;
  const int count = (int)min((long long)per_block, n_replicas - r0);

  stage(x, r0, count, n_atoms, s_x);
  if (staged) {
    // [E, 4] rows of 16 (float32) or 32 (float64) bytes
    stage_table(reinterpret_cast<const int4*>(entries),
                n_entries * (int)sizeof(T) / 4,
                reinterpret_cast<int4*>(s_tab));
    stage_table(start, n_atoms + 1, s_start);
  }
  __syncthreads();
  // the partners from shared memory where the block staged them, else from
  // device memory (generic loads serve both)
  const T* tab = staged ? s_tab : entries;
  const int* first = staged ? s_start : start;

  for (int item = threadIdx.x; item < count * n_atoms; item += blockDim.x) {
    const int p = item / n_atoms;
    const int i = item - p * n_atoms;
    const T* xp = s_x + p * n_atoms * 3;
    T xi[3];
    load3(xp, i, xi);
    T e = T(0), f0 = T(0), f1 = T(0), f2 = T(0);
    const int end = first[i + 1];
#pragma unroll 4
    for (int q = first[i]; q < end; ++q) {
      const Entry<T> en = load_entry(tab + 4 * q);
      const int j = en.partner;
      const T d0 = xi[0] - xp[3 * j];
      const T d1 = xi[1] - xp[3 * j + 1];
      const T d2 = xi[2] - xp[3 * j + 2];
      const T inv_r = p_rsqrt(d0 * d0 + d1 * d1 + d2 * d2);
      const T inv_r2 = inv_r * inv_r;
      const T coul = coulomb * en.qq * inv_r;
      const T sig_r2 = en.sigma * en.sigma * inv_r2;
      const T sig_r6 = sig_r2 * sig_r2 * sig_r2;
      const T sig_r12 = sig_r6 * sig_r6;
      const T four_eps = T(4) * en.eps;
      if (j > i) e += coul + four_eps * (sig_r12 - sig_r6);
      const T f_over_r =
          (coul + four_eps * (T(12) * sig_r12 - T(6) * sig_r6)) * inv_r2;
      f0 += f_over_r * d0;
      f1 += f_over_r * d1;
      f2 += f_over_r * d2;
    }
    s_e[item] = e;
    const long long at = ((r0 + p) * n_atoms + i) * 3;
    forces[at] = forces_in[at] + f0;
    forces[at + 1] = forces_in[at + 1] + f1;
    forces[at + 2] = forces_in[at + 2] + f2;
  }
  __syncthreads();
  int replica;
  const T e = replica_sum(s_e, n_atoms, count, &replica);
  if (replica >= 0 && threadIdx.x % kWarp == 0)
    energy[r0 + replica] = energy_in[r0 + replica] + e;
}

// Checks a launch's shape; returns the blocks, or 0 where it is refused.
long long blocks_of(long long n_replicas, int n_atoms, int per_block,
                    int threads, int device, long long shared) {
  if (n_replicas <= 0 || n_atoms <= 0 || per_block < 1
      || per_block * kWarp > threads || threads > kMaxThreads
      || threads % kWarp || device < 0 || device >= kDevices
      || shared > kMaxShared)
    return 0;
  const long long blocks = (n_replicas + per_block - 1) / per_block;
  return blocks > 0x7fffffffLL ? 0 : blocks;
}

// Dynamic shared memory above 48 KB, asked for once per kernel and device
// at the most a launch has needed.
template <typename Kernel>
cudaError_t grant_shared(Kernel kernel, int* granted, int device,
                         long long shared) {
  if (shared <= 48 * 1024 || shared <= granted[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err == cudaSuccess) granted[device] = (int)shared;
  return err;
}

template <typename T>
int launch_bonded(const void* positions, const Terms<T>& t,
                  const void* row_start, const void* rows,
                  long long n_replicas, int n_atoms, int per_block,
                  int threads, int device, void* energy, void* forces,
                  cudaStream_t stream) {
  static int granted[kDevices] = {};
  const long long n_terms = (long long)t.n_bonds + t.n_angles + t.n_torsions;
  const long long n_rows =
      2LL * t.n_bonds + 3LL * t.n_angles + 4LL * t.n_torsions;
  const long long shared =
      (long long)per_block * (3LL * n_atoms + 3 * n_rows + n_terms)
          * (long long)sizeof(T)
      + (n_atoms + 1LL + n_rows) * (long long)sizeof(int);
  const long long blocks =
      blocks_of(n_replicas, n_atoms, per_block, threads, device, shared);
  if (!blocks) return (int)cudaErrorInvalidValue;
  cudaError_t err = grant_shared(ligand_bonded_kernel<T>, granted, device,
                                 shared);
  if (err != cudaSuccess) return (int)err;
  ligand_bonded_kernel<T><<<(unsigned)blocks, threads, (size_t)shared,
                            stream>>>(
      static_cast<const T*>(positions), t, static_cast<const int*>(row_start),
      static_cast<const int*>(rows), n_replicas, n_atoms, per_block,
      static_cast<T*>(energy), static_cast<T*>(forces));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pairs(const void* positions, const void* start,
                 const void* entries, int n_entries, int staged,
                 double coulomb, long long n_replicas, int n_atoms,
                 int per_block, int threads, const void* energy_in,
                 const void* forces_in, int device, void* energy,
                 void* forces, cudaStream_t stream) {
  static int granted[kDevices] = {};
  if (n_entries < 0 || n_atoms >= (1 << 24)) return (int)cudaErrorInvalidValue;
  const long long shared =
      (long long)per_block * 4LL * n_atoms * (long long)sizeof(T)
      + (staged ? 4LL * n_entries * (long long)sizeof(T)
                      + (n_atoms + 1LL) * (long long)sizeof(int)
                : 0LL);
  const long long blocks =
      blocks_of(n_replicas, n_atoms, per_block, threads, device, shared);
  if (!blocks) return (int)cudaErrorInvalidValue;
  cudaError_t err = grant_shared(ligand_pairs_kernel<T>, granted, device,
                                 shared);
  if (err != cudaSuccess) return (int)err;
  ligand_pairs_kernel<T><<<(unsigned)blocks, threads, (size_t)shared,
                           stream>>>(
      static_cast<const T*>(positions), static_cast<const int*>(start),
      static_cast<const T*>(entries), n_entries, staged, T(coulomb),
      n_replicas, n_atoms, per_block, static_cast<const T*>(energy_in),
      static_cast<const T*>(forces_in), static_cast<T*>(energy),
      static_cast<T*>(forces));
  return (int)cudaGetLastError();
}

}  // namespace

// positions [n_replicas, n_atoms, 3]; the System's bond_idx [B, 2],
// angle_idx [A, 3], torsion_idx [T, 4] (int64) and their parameters [B],
// [A], [T] (each a row of its own); row_start [n_atoms + 1] and rows
// [2B + 3A + 4T] (int32): atom n receives rows rows[row_start[n] ..
// row_start[n + 1]), in that order. Writes energy [n_replicas] and forces
// [n_replicas, n_atoms, 3]. Every pointer is device memory of one scalar
// type (f64: float64, else float32) but the int tables. A block takes
// per_block replicas with `threads` threads (the host's launch plan).
extern "C" int ligand_bonded_launch(
    const void* positions, const void* bond_idx, const void* bond_k,
    const void* bond_r0, const void* angle_idx, const void* angle_k,
    const void* angle_t0, const void* torsion_idx, const void* torsion_k,
    const void* torsion_per, const void* torsion_phase, int n_bonds,
    int n_angles, int n_torsions, const void* row_start, const void* rows,
    long long n_replicas, int n_atoms, int per_block, int threads, int f64,
    void* energy, void* forces, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_bonds < 0 || n_angles < 0 || n_torsions < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* bi = static_cast<const long long*>(bond_idx);
  const long long* ai = static_cast<const long long*>(angle_idx);
  const long long* ti = static_cast<const long long*>(torsion_idx);
  if (f64) {
    const Terms<double> t{
        bi, static_cast<const double*>(bond_k),
        static_cast<const double*>(bond_r0), ai,
        static_cast<const double*>(angle_k),
        static_cast<const double*>(angle_t0), ti,
        static_cast<const double*>(torsion_k),
        static_cast<const double*>(torsion_per),
        static_cast<const double*>(torsion_phase), n_bonds, n_angles,
        n_torsions};
    return launch_bonded<double>(positions, t, row_start, rows, n_replicas,
                                 n_atoms, per_block, threads, device, energy,
                                 forces, st);
  }
  const Terms<float> t{
      bi, static_cast<const float*>(bond_k),
      static_cast<const float*>(bond_r0), ai,
      static_cast<const float*>(angle_k),
      static_cast<const float*>(angle_t0), ti,
      static_cast<const float*>(torsion_k),
      static_cast<const float*>(torsion_per),
      static_cast<const float*>(torsion_phase), n_bonds, n_angles,
      n_torsions};
  return launch_bonded<float>(positions, t, row_start, rows, n_replicas,
                              n_atoms, per_block, threads, device, energy,
                              forces, st);
}

// positions [n_replicas, n_atoms, 3]; start [n_atoms + 1] (int32) and
// entries [E, 4] (qq, sigma, epsilon and the partner's index as a value):
// atom i's partners are entries start[i] .. start[i + 1]. staged: the
// block copies the entries and start into shared memory (the host's plan,
// where they fit). Writes energy = energy_in + the pairs' energy
// [n_replicas] and forces = forces_in + the pairs' forces [n_replicas,
// n_atoms, 3]; coulomb is the Coulomb constant.
extern "C" int ligand_pairs_launch(const void* positions, const void* start,
                                   const void* entries, int n_entries,
                                   int staged, double coulomb,
                                   long long n_replicas, int n_atoms,
                                   int per_block, int threads, int f64,
                                   const void* energy_in,
                                   const void* forces_in, void* energy,
                                   void* forces, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f64 ? launch_pairs<double>(positions, start, entries, n_entries,
                                    staged, coulomb, n_replicas, n_atoms,
                                    per_block, threads, energy_in, forces_in,
                                    device, energy, forces, st)
             : launch_pairs<float>(positions, start, entries, n_entries,
                                   staged, coulomb, n_replicas, n_atoms,
                                   per_block, threads, energy_in, forces_in,
                                   device, energy, forces, st);
}

extern "C" const char* ligand_forces_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
