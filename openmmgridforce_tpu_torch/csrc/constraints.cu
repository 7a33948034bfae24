// The constraint solver for Hopper (sm_90a): SHAKE (positions) and RATTLE
// (velocities) over a batch of replicas, one launch a call, every sweep of
// a replica inside one block.
//
// Replaces no Pallas kernel. It is the JAX package's lax.while_loop sweeps
// (openmmgridforce_tpu/mm/constraints.py, apply_shake and apply_rattle).
// In the port they were chains of ATen operations (mm/constraints.py, now
// the plain twin): about 20 launches a SHAKE sweep and 15 a RATTLE sweep,
// with a fixed-order row sum (ops/scatter.py), in blocks of 4 sweeps inside
// a conditional WHILE node of each recorded step. At the BPMF ladder's 21
// rungs of 27 constraints over 47 atoms a step walked about 1,750 graph
// nodes in 3.9 ms: 98.8% of the step.
//
// Bound: latency. A call reads the replicas' reference and state (positions
// or velocities) and writes the state once (35 KB at 21 x 47 in float32),
// and a sweep is a few dozen operations a constraint: bytes and FLOPs take
// well under a microsecond. What is left is a chain of dependent sweeps,
// up to max_iter of them, each a pass over the constraints, a block-wide
// vote and a pass over the atoms.
//
// Design (ops/cuda_constraints.py builds the tables and the launch plan).
// - One block a replica. It stages the replica's state, the pairs'
//   directions and scalars and the per-atom row table in shared memory, and
//   the chain of sweeps never leaves the block: no host check, no graph
//   node, no device memory between sweeps. Threads stride over the
//   constraints, then over the atoms, so any N and C that fit in shared
//   memory are taken.
// - Across the sweeps each thread keeps its first constraint (its atoms'
//   offsets, direction and scalars) and its first atom's rows (up to four:
//   each row's update offset and weight) in registers, so a sweep's chain
//   reads only the state and the updates from shared memory.
// - The stop is the JAX package's, replica by replica: the first sweep
//   always runs; a sweep measures its error before its update (the largest
//   |r^2 - d0^2| / d0^2 for SHAKE, |(v_i - v_j) . d| for RATTLE); the
//   replica stops after the first sweep whose error is within the threshold,
//   or at max_iter. The vote rides on the two barriers a sweep needs anyway
//   (__syncthreads_or): any error above the threshold after the constraint
//   pass, any NaN error after the atom pass (a NaN error stops a replica,
//   as the twin's NaN-propagating maximum does).
// - Each sweep does the twin's arithmetic in the twin's order: the dot
//   products as ((a0 b0 + a1 b1) + a2 b2), the update's quotient with the
//   1e-12 floor, and each atom's rows (-1/m_i u, +1/m_j u) in
//   ops/scatter.py::row_table's order, summed as ATen sums the twin's slots
//   on the card (slot k into accumulator k mod 4, then the four in turn),
//   then added to the atom. The library is compiled with -fmad=false
//   (cuda_build.EXTRA_FLAGS), so no product is fused into an addition: a
//   replica's result equals the twin's on the card bit for bit, and does
//   not depend on the batch it lies in.
// - The counters of mm/constraints.py::SweepStats are updated in the
//   epilogue: each block adds its replica's sweeps and raises the maxima
//   with atomics; the last block to finish adds the call, its replicas and
//   the call's executed sweeps (its slowest replica's) and clears the
//   call's scratch for the next.
// - Every launch argument is a device pointer, a shape or a constant: the
//   launch can be captured into a CUDA graph.
// - Same-run times (NVIDIA H100 80GB HBM3, 700 W), a recorded call at the
//   ladder's 21 x 47 atoms, 27 constraints, float32: SHAKE 7.5 us (7
//   sweeps), RATTLE 55.8 us (100 sweeps, 0.56 us a sweep); at 1000
//   replicas 9.6 / 66.2 us; float64 at 21 8.7 / 13.4 us (RATTLE 17
//   sweeps). The twin's masked sweeps recorded in one graph take 0.33 /
//   3.57 ms. The first design, whose passes read the pairs and the row
//   table from shared memory in every sweep, took 9.3 / 77.3 us. 64
//   threads a block; registers 52 / 48 (float64 78 / 71), no spills.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 256;     // threads a block (the host's plan)
constexpr int kMaxShared = 232448;   // bytes of shared memory a block
constexpr int kDevices = 64;

// A constraint set's tables (ops/cuda_constraints.py, constraint_tables).
template <typename T>
struct Tables {
  const int* pairs;       // [C, 2] atoms i, j of each constraint
  const T* length_sq;     // [C] d0^2
  const T* two_im;        // [C] 2 (1/m_i + 1/m_j)
  const T* im_sum;        // [C] 1/m_i + 1/m_j
  const int* row_start;   // [N + 1] atom n's rows: row_start[n] .. [n + 1]
  const int* row_pair;    // [2C] the constraint of each row
  const T* row_weight;    // [2C] -1/m_i or +1/m_j
  int n_atoms;
  int n_pairs;
};

// SweepStats' device buffers, or null pointers (a warm-up: not counted).
struct Stats {
  long long* sums;         // [4] calls, replicas, sweeps, executed
  long long* maxes;        // [2] a replica's sweeps, a call's executed
  unsigned int* scratch;   // [2] blocks done, the call's slowest replica
};

template <typename T>
__device__ __forceinline__ T dot3(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

template <typename T>
__device__ __forceinline__ T abs_of(T v) {
  return v < T(0) ? -v : v;
}

// acc += u * w, a row of an atom's sum
template <typename T>
__device__ __forceinline__ void add_row(T* acc, const T* u, T w) {
  acc[0] += u[0] * w;
  acc[1] += u[1] * w;
  acc[2] += u[2] * w;
}

// x[a] += the sum of the rows lo .. hi of the atom's table (from shared
// memory): row m into accumulator m mod 4, then the four in turn
template <typename T>
__device__ __forceinline__ void sum_rows(T* xa, const T* upd, const int* rp,
                                         const T* w, int lo, int hi) {
  T acc0[3] = {T(0), T(0), T(0)};
  T acc1[3] = {T(0), T(0), T(0)};
  T acc2[3] = {T(0), T(0), T(0)};
  T acc3[3] = {T(0), T(0), T(0)};
  for (int k = lo; k < hi; k += 4) {
    add_row(acc0, upd + 3 * rp[k], w[k]);
    if (k + 1 < hi) add_row(acc1, upd + 3 * rp[k + 1], w[k + 1]);
    if (k + 2 < hi) add_row(acc2, upd + 3 * rp[k + 2], w[k + 2]);
    if (k + 3 < hi) add_row(acc3, upd + 3 * rp[k + 3], w[k + 3]);
  }
  for (int q = 0; q < 3; ++q)
    xa[q] += ((acc0[q] + acc1[q]) + acc2[q]) + acc3[q];
}

// One constraint's part of a sweep: its update u = k e from the state x,
// and whether its error is above the threshold or NaN. i3, j3: its atoms'
// offsets in x; e: d_ref (SHAKE) or d (RATTLE); sa: d0^2 (SHAKE) or den
// (RATTLE); sb: 2 (1/m_i + 1/m_j) (SHAKE).
template <typename T, bool kShake>
__device__ __forceinline__ void update_pair(const T* x, int i3, int j3,
                                            const T* e, T sa, T sb, T omega,
                                            T threshold, T* u, bool& over,
                                            bool& bad) {
  const T d[3] = {x[i3] - x[j3], x[i3 + 1] - x[j3 + 1],
                  x[i3 + 2] - x[j3 + 2]};
  T k, err;
  if (kShake) {
    const T diff = dot3(d, d) - sa;
    const T den = sb * dot3(d, e);
    k = omega * diff / (abs_of(den) > T(1e-12) ? den : T(1e-12));
    err = abs_of(diff / sa);
  } else {
    const T vrel = dot3(d, e);
    k = omega * vrel / sa;
    err = abs_of(vrel);
  }
  u[0] = k * e[0];
  u[1] = k * e[1];
  u[2] = k * e[2];
  over |= err > threshold;
  bad |= err != err;
}

template <typename T>
__host__ __device__ constexpr long long shared_bytes(long long n,
                                                     long long c) {
  return (3 * n + 10 * c) * (long long)sizeof(T)
         + (4 * c + n + 1) * (long long)sizeof(int);
}

// ref: SHAKE's pre-step positions or RATTLE's constrained positions, and
// state: the positions or velocities to correct, both [R, N, 3]. Writes
// out [R, N, 3] and sweeps [R].
template <typename T, bool kShake>
__global__ void __launch_bounds__(kMaxThreads)
    constraint_kernel(const T* __restrict__ ref, const T* __restrict__ state,
                      Tables<T> t, int max_iter, T threshold, T omega,
                      T* __restrict__ out, long long* __restrict__ sweeps,
                      Stats stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = t.n_atoms;
  const int nc = t.n_pairs;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  T* x = reinterpret_cast<T*>(smem);   // [3N] the state
  T* dir = x + 3 * n;                  // [3C] d_ref (SHAKE), d (RATTLE)
  T* upd = dir + 3 * nc;               // [3C] the sweep's update
  T* s_a = upd + 3 * nc;               // [C] d0^2 (SHAKE), den (RATTLE)
  T* s_b = s_a + nc;                   // [C] 2 (1/m_i + 1/m_j) (SHAKE)
  T* w = s_b + nc;                     // [2C] the rows' weights
  int* pr = reinterpret_cast<int*>(w + 2 * nc);   // [2C] pairs
  int* rs = pr + 2 * nc;               // [N + 1] row starts
  int* rp = rs + n + 1;                // [2C] the rows' constraints

  const long long base = (long long)blockIdx.x * 3 * n;
  const T* xr = ref + base;
  for (int k = tid; k < 3 * n; k += nt) x[k] = state[base + k];
  for (int k = tid; k < 2 * nc; k += nt) {
    pr[k] = t.pairs[k];
    rp[k] = t.row_pair[k];
    w[k] = t.row_weight[k];
  }
  for (int k = tid; k <= n; k += nt) rs[k] = t.row_start[k];
  for (int c = tid; c < nc; c += nt) {
    const int i = t.pairs[2 * c];
    const int j = t.pairs[2 * c + 1];
    T* d = dir + 3 * c;
    d[0] = xr[3 * i] - xr[3 * j];
    d[1] = xr[3 * i + 1] - xr[3 * j + 1];
    d[2] = xr[3 * i + 2] - xr[3 * j + 2];
    if (kShake) {
      s_a[c] = t.length_sq[c];
      s_b[c] = t.two_im[c];
    } else {
      s_a[c] = t.im_sum[c] * dot3(d, d);
    }
  }
  __syncthreads();

  // what stays fixed across the sweeps, in registers: the thread's first
  // constraint, and its first atom's rows where it has at most four (the
  // rest, if any, are read from shared memory in each sweep)
  const bool own_pair = tid < nc;
  int i3 = 0, j3 = 0;
  T e[3] = {T(0), T(0), T(0)};
  T sa = T(1), sb = T(0);
  if (own_pair) {
    i3 = 3 * pr[2 * tid];
    j3 = 3 * pr[2 * tid + 1];
    for (int q = 0; q < 3; ++q) e[q] = dir[3 * tid + q];
    sa = s_a[tid];
    if (kShake) sb = s_b[tid];
  }
  int lo = 0, rows = 0;
  int off[4] = {0, 0, 0, 0};
  T wt[4] = {T(0), T(0), T(0), T(0)};
  if (tid < n) {
    lo = rs[tid];
    rows = rs[tid + 1] - lo;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (m < rows) {
        off[m] = 3 * rp[lo + m];
        wt[m] = w[lo + m];
      }
    }
  }

  int it = 0;
  bool go = max_iter > 0;
  while (go) {
    // the constraints: each one's update and error, from this sweep's state
    bool over = false;
    bool bad = false;
    if (own_pair)
      update_pair<T, kShake>(x, i3, j3, e, sa, sb, omega, threshold,
                             upd + 3 * tid, over, bad);
    for (int c = tid + nt; c < nc; c += nt)
      update_pair<T, kShake>(x, 3 * pr[2 * c], 3 * pr[2 * c + 1],
                             dir + 3 * c, s_a[c], kShake ? s_b[c] : T(0),
                             omega, threshold, upd + 3 * c, over, bad);
    const bool any_over = __syncthreads_or(over);
    // the atoms: each one's rows, in the table's order
    if (rows > 4) {
      sum_rows(x + 3 * tid, upd, rp, w, lo, lo + rows);
    } else if (rows > 0) {
      T acc0[3] = {T(0), T(0), T(0)};
      T acc1[3] = {T(0), T(0), T(0)};
      T acc2[3] = {T(0), T(0), T(0)};
      T acc3[3] = {T(0), T(0), T(0)};
      add_row(acc0, upd + off[0], wt[0]);
      if (rows > 1) add_row(acc1, upd + off[1], wt[1]);
      if (rows > 2) add_row(acc2, upd + off[2], wt[2]);
      if (rows > 3) add_row(acc3, upd + off[3], wt[3]);
      T* xa = x + 3 * tid;
      for (int q = 0; q < 3; ++q)
        xa[q] += ((acc0[q] + acc1[q]) + acc2[q]) + acc3[q];
    }
    for (int a = tid + nt; a < n; a += nt)
      sum_rows(x + 3 * a, upd, rp, w, rs[a], rs[a + 1]);
    const bool any_bad = __syncthreads_or(bad);
    ++it;
    go = any_over && !any_bad && it < max_iter;
  }

  for (int k = tid; k < 3 * n; k += nt) out[base + k] = x[k];
  if (tid != 0) return;
  sweeps[blockIdx.x] = it;
  if (stats.sums == nullptr) return;
  atomicAdd(reinterpret_cast<unsigned long long*>(stats.sums + 2),
            (unsigned long long)it);
  atomicMax(stats.maxes, (long long)it);
  atomicMax(stats.scratch + 1, (unsigned int)it);
  __threadfence();
  if (atomicAdd(stats.scratch, 1u) != gridDim.x - 1) return;
  // the last block: every block's sweeps are in
  __threadfence();
  const long long executed = atomicExch(stats.scratch + 1, 0u);
  atomicExch(stats.scratch, 0u);
  unsigned long long* sums = reinterpret_cast<unsigned long long*>(stats.sums);
  atomicAdd(sums, 1ULL);
  atomicAdd(sums + 1, (unsigned long long)gridDim.x);
  atomicAdd(sums + 3, (unsigned long long)executed);
  atomicMax(stats.maxes + 1, executed);
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

template <typename T, bool kShake>
int launch(const void* ref, const void* state, const Tables<T>& t,
           long long n_replicas, int threads, int max_iter, double threshold,
           double omega, void* out, void* sweeps, const Stats& stats,
           int device, cudaStream_t stream) {
  static int granted[kDevices] = {};
  const long long shared = shared_bytes<T>(t.n_atoms, t.n_pairs);
  if (n_replicas <= 0 || n_replicas > 0x7fffffffLL || t.n_atoms <= 0
      || t.n_pairs <= 0 || max_iter < 0 || threads < kWarp
      || threads > kMaxThreads || threads % kWarp || device < 0
      || device >= kDevices || shared > kMaxShared)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = grant_shared(constraint_kernel<T, kShake>, granted,
                                 device, shared);
  if (err != cudaSuccess) return (int)err;
  constraint_kernel<T, kShake><<<(unsigned)n_replicas, threads,
                                 (size_t)shared, stream>>>(
      static_cast<const T*>(ref), static_cast<const T*>(state), t, max_iter,
      T(threshold), T(omega), static_cast<T*>(out),
      static_cast<long long*>(sweeps), stats);
  return (int)cudaGetLastError();
}

template <bool kShake>
int launch_typed(const void* ref, const void* state, const void* pairs,
                 const void* length_sq, const void* two_im,
                 const void* im_sum, const void* row_start,
                 const void* row_pair, const void* row_weight, int n_atoms,
                 int n_pairs, long long n_replicas, int threads, int max_iter,
                 double threshold, double omega, int f64, void* out,
                 void* sweeps, void* sums, void* maxes, void* scratch,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Stats stats{static_cast<long long*>(sums),
                    static_cast<long long*>(maxes),
                    static_cast<unsigned int*>(scratch)};
  if ((sums == nullptr) != (maxes == nullptr)
      || (sums == nullptr) != (scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pairs);
  const int* rs = static_cast<const int*>(row_start);
  const int* rp = static_cast<const int*>(row_pair);
  if (f64) {
    const Tables<double> t{p, static_cast<const double*>(length_sq),
                           static_cast<const double*>(two_im),
                           static_cast<const double*>(im_sum), rs, rp,
                           static_cast<const double*>(row_weight), n_atoms,
                           n_pairs};
    return launch<double, kShake>(ref, state, t, n_replicas, threads,
                                  max_iter, threshold, omega, out, sweeps,
                                  stats, device, st);
  }
  const Tables<float> t{p, static_cast<const float*>(length_sq),
                        static_cast<const float*>(two_im),
                        static_cast<const float*>(im_sum), rs, rp,
                        static_cast<const float*>(row_weight), n_atoms,
                        n_pairs};
  return launch<float, kShake>(ref, state, t, n_replicas, threads, max_iter,
                               threshold, omega, out, sweeps, stats, device,
                               st);
}

}  // namespace

// x_ref, x_new [n_replicas, n_atoms, 3]: SHAKE x_new along x_ref's
// directions into out [n_replicas, n_atoms, 3]; each replica's sweeps into
// sweeps [n_replicas] (int64). pairs [C, 2], row_start [n_atoms + 1],
// row_pair [2C] (int32) and length_sq, two_im, im_sum [C], row_weight [2C]
// in the scalar type (f64: float64, else float32) are the constraint set's
// tables. A replica stops after the first sweep whose error was at most
// threshold, or after max_iter. sums, maxes and scratch: SweepStats'
// buffers (int64 [4], int64 [2], int32 [2], scratch zero between calls),
// or all null. One block of `threads` threads a replica.
extern "C" int constraint_shake_launch(
    const void* x_ref, const void* x_new, const void* pairs,
    const void* length_sq, const void* two_im, const void* im_sum,
    const void* row_start, const void* row_pair, const void* row_weight,
    int n_atoms, int n_pairs, long long n_replicas, int threads,
    int max_iter, double threshold, double omega, int f64, void* out,
    void* sweeps, void* sums, void* maxes, void* scratch, int device,
    void* stream) {
  return launch_typed<true>(x_ref, x_new, pairs, length_sq, two_im, im_sum,
                            row_start, row_pair, row_weight, n_atoms, n_pairs,
                            n_replicas, threads, max_iter, threshold, omega,
                            f64, out, sweeps, sums, maxes, scratch, device,
                            stream);
}

// x, v [n_replicas, n_atoms, 3]: RATTLE v along x's constrained bonds into
// out; the rest as constraint_shake_launch.
extern "C" int constraint_rattle_launch(
    const void* x, const void* v, const void* pairs, const void* length_sq,
    const void* two_im, const void* im_sum, const void* row_start,
    const void* row_pair, const void* row_weight, int n_atoms, int n_pairs,
    long long n_replicas, int threads, int max_iter, double threshold,
    double omega, int f64, void* out, void* sweeps, void* sums, void* maxes,
    void* scratch, int device, void* stream) {
  return launch_typed<false>(x, v, pairs, length_sq, two_im, im_sum,
                             row_start, row_pair, row_weight, n_atoms,
                             n_pairs, n_replicas, threads, max_iter,
                             threshold, omega, f64, out, sweeps, sums, maxes,
                             scratch, device, stream);
}

extern "C" const char* constraints_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
