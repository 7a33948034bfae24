// Fused evaluation of a polynomial pack (K3) at a batch of positions, for
// Hopper (sm_90a).
//
// Replaces the JAX package's per-step evaluation of a fused pack,
// openmmgridforce_tpu/ops/packed.py (evaluate_multi): there it is XLA
// einsums, not a Pallas kernel, and in the port it was a chain of about a
// dozen small ATen ops (ops/cuda_packed_eval.py, packed_eval_plain). Per
// atom it locates the cell as ops/interpolate.py (locate) does, reads the
// cell's row of G * d^3 coefficients once, evaluates the G tensor-product
// polynomials sum R[p,q,r] b_p(fx) b_q(fy) b_r(fz) and their three
// fraction-partials (b_p(v) = v^p, or T_p(2v - 1) with derivative
// 2p U_(p-1)(2v - 1)), applies each grid's back-transform sign|v|^n, the
// spacing, the per-atom scalings, and the out-of-box restraint once for
// the set. A rank of a table split over x-cells (parallel/sharded_grid.py)
// passes its slab of cell x-indices: it counts only the atoms whose cell
// it holds, and the restraint only where asked.
//
// Bound: bytes. A step of the main path evaluates 1000 replicas x 47
// atoms, each reading its row: 3 x 64 float32 (768 B, B-spline) or 3 x 216
// (2,592 B, triquintic), 36 or 122 MB gathered a step. The replicas of one
// ligand atom share cells, so the distinct rows are fewer: 17 or 58 MB,
// 5.5 or 17.7 us at the H100 SXM's 3.35 TB/s. The arithmetic (about
// 2 d^3 + 4 d^2 FMAs a grid) is far below the card's FP32 rate. What
// bounds the kernel is how fast rows reach the SMs: most come from L2,
// which holds the last step's rows (all 17 MB at d = 4, most of the 58 MB
// at d = 6), at more than the gather bound's rate.
//
// Design (the variants are timed side by side by kernel_variants.py
// packed_eval; PERF.md has the figures).
// - Rows staged in shared memory by Hopper's bulk copies (kStaged): a
//   block is a tile of atoms, 4 lanes each. Lane 0 of every atom whose
//   cell it counts issues one cp.async.bulk of the atom's whole row
//   (768 - 5,184 B) into the atom's slot and arrives on the block's
//   mbarrier with the bytes to expect; the others arrive without. A row
//   is one request in flight, not 27 - 81 loads of 8 - 16 B a lane that
//   each touch 8 rows' sectors, and the lanes then read it from shared
//   memory. The blocks resident on an SM (shared memory bounds them)
//   overlap one tile's copies with another's arithmetic. A slot is the
//   row's bytes, 64 more where the row is a multiple of 128 B, so that
//   the two atoms a quarter-warp reads start on different banks. The
//   host's plan (ops/cuda_packed_eval.py, launch_plan) sets the tile;
//   dynamic shared memory above 48 KB is asked for once per
//   instantiation and device.
// - Launch order: the [B, N] order of the positions. The atom-major
//   order (kAtomMajor: the replicas of one ligand atom side by side, so
//   that rows they share are reused while hot) measured slower: a step
//   reads the rows in the same order as the last one, so at d = 6 the
//   58 MB sweep evicts from the 50 MB L2 what the next step wants first,
//   while the [B, N] order reads them scattered and keeps most of them;
//   and its writes land N atoms apart.
// - Lanes: a grid's d^3 coefficients are d^2 runs of d contiguous
//   z-coefficients R[p,q,0..d-1]; lane l takes the runs i = l + 4k and
//   contracts each with the z-basis at once (2d FMAs, 4 more for the
//   x-y weights b_p b_q, b'_p b_q, b_p b'_q, which the lane forms once an
//   atom: a select over the d basis values keeps them in registers).
// - The grid loop is unrolled for G = 1, 2, 3 (an instantiation each; other
//   G take a runtime loop), so every grid's reads issue before the first
//   reduction.
// - Each lane's four sums of a grid are added over the atom's lanes by two
//   xor shuffles, (l0 + l1) + (l2 + l3) on every lane alike. Lane g then
//   applies grid g's tail (back power, spacing, scaling) (kSplitTail), and
//   the atom's energy and forces add the grids' terms in grid order: a
//   fixed order, no atomics, so a replayed graph equals the eager launch
//   bit for bit. Lane 0 writes the energy, lanes 1-3 the forces.
// - Atoms that no grid counts (outside the box, or outside a rank's slab)
//   read no row and wait for no copy.
// - spacing, origin and the back powers are read from device memory, so
//   the launch takes no value that the host would have to fetch: it can
//   be captured into a CUDA graph. A scaling shared by every grid is read
//   with a grid stride of 0.
// - Dividing by the spacing (locate's cell, the gradient) is IEEE
//   division without its slow-path CALL (Spacing below); indices are 32-bit
//   (a 64-bit division is a CALL too).
// - Registers (ptxas, NVIDIA H100 80GB HBM3 build), G = 3: float32 57 /
//   79-80 / 105-110 at d = 2 / 4 / 6, float64 80 / 126-128 / 172; G = 1,
//   2 and the runtime loop 48-176. No spills (chip_smoke.py fails on a
//   spill). Shared memory a block at 16 atoms, G = 3: float32 1,552 /
//   13,328 / 41,488 B, float64 3,088 / 25,616 / 82,960 B.
// - Same-run times (kernel_variants.py packed_eval, H100, 700 W), a
//   recorded call at 1000 x 47 atoms, d = 4 / 6: 10.0 / 28.3 us (62% of
//   the bound at d = 6), the first design 10.2-10.4 / 41.2 us.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 4;          // lanes an atom
constexpr int kMaxThreads = 128;   // threads a block at most: 32 atoms
constexpr int kAtomMajor = 0;      // replicas of one ligand atom together
constexpr int kStaged = 1;         // rows staged by bulk copies
constexpr int kSplitTail = 1;      // grid g's tail on lane g
constexpr int kUnrollGrids = 1;    // instantiations for G = 1, 2, 3
constexpr int kMaxShared = 232448; // shared memory a block may use
constexpr int kBarrierBytes = 16;  // the static mbarrier's share of it
constexpr int kDevices = 64;       // devices whose attribute is cached

static_assert(kMaxThreads % 32 == 0 && 32 % kLanes == 0, "lanes");

// ---------------------------------------------------------------------
// mbarrier and bulk copies (PTX)
// ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(shared_address(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void barrier_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(shared_address(bar)) : "memory");
}

__device__ __forceinline__ void barrier_arrive_tx(uint64_t* bar,
                                                  uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(shared_address(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void barrier_wait(uint64_t* bar,
                                             uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n"
      :: "r"(shared_address(bar)), "r"(parity) : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned; completes on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(shared_address(dst)), "l"(src), "r"(bytes),
         "r"(shared_address(bar))
      : "memory");
}

// ---------------------------------------------------------------------
// Arithmetic
// ---------------------------------------------------------------------

template <bool kGlobal, typename V>
__device__ __forceinline__ V load_vec(const V* p) {
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// the d coefficients of a run: one to three vector loads, from device
// memory (kGlobal) or a staged slot; rows are 16-byte aligned and a run
// starts at a multiple of 8 (float, d = 2 and 6) or 16 bytes
template <int D, typename T>
struct Run;
template <>
struct Run<2, float> {
  template <bool kGlobal>
  static __device__ __forceinline__ void load(const float* p,
                                              float (&c)[2]) {
    const float2 a = load_vec<kGlobal>(reinterpret_cast<const float2*>(p));
    c[0] = a.x; c[1] = a.y;
  }
};
template <>
struct Run<4, float> {
  template <bool kGlobal>
  static __device__ __forceinline__ void load(const float* p,
                                              float (&c)[4]) {
    const float4 a = load_vec<kGlobal>(reinterpret_cast<const float4*>(p));
    c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w;
  }
};
template <>
struct Run<6, float> {
  template <bool kGlobal>
  static __device__ __forceinline__ void load(const float* p,
                                              float (&c)[6]) {
    const float2* v = reinterpret_cast<const float2*>(p);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float2 a = load_vec<kGlobal>(v + j);
      c[2 * j] = a.x; c[2 * j + 1] = a.y;
    }
  }
};
template <int D>
struct Run<D, double> {
  template <bool kGlobal>
  static __device__ __forceinline__ void load(const double* p,
                                              double (&c)[D]) {
    const double2* v = reinterpret_cast<const double2*>(p);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) {
      const double2 a = load_vec<kGlobal>(v + j);
      c[2 * j] = a.x; c[2 * j + 1] = a.y;
    }
  }
};

// basis values b[p] and derivatives db[p] at cell fraction v, as
// ops/packed.py's _poly_powers and _poly_dpowers form them
template <int D, bool CHEB, typename T>
__device__ __forceinline__ void basis(T v, T (&b)[D], T (&db)[D]) {
  if (!CHEB) {
    b[0] = T(1);
    db[0] = T(0);
#pragma unroll
    for (int p = 1; p < D; ++p) {
      db[p] = T(p) * b[p - 1];
      b[p] = b[p - 1] * v;
    }
  } else {
    const T u = T(2) * v - T(1);
    T t[D], w[D];
    t[0] = T(1);
    t[1] = u;
    w[0] = T(1);
    w[1] = T(2) * u;
#pragma unroll
    for (int p = 2; p < D; ++p) {
      t[p] = T(2) * u * t[p - 1] - t[p - 2];
      w[p] = T(2) * u * w[p - 1] - w[p - 2];
    }
    b[0] = T(1);
    db[0] = T(0);
#pragma unroll
    for (int p = 1; p < D; ++p) {
      b[p] = t[p];
      db[p] = T(2 * p) * w[p - 1];
    }
  }
}

// v[i] for a runtime i in [0, D): selects, so v stays in registers
template <int D, typename T>
__device__ __forceinline__ T pick(const T (&v)[D], int i) {
  T out = v[0];
#pragma unroll
  for (int j = 1; j < D; ++j) out = (i == j) ? v[j] : out;
  return out;
}

// the scalar type's math, spelled out for each type
__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float clamp_(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ double clamp_(double v, double lo, double hi) {
  return fmin(fmax(v, lo), hi);
}
__device__ __forceinline__ float floor_(float v) { return floorf(v); }
__device__ __forceinline__ double floor_(double v) { return floor(v); }
__device__ __forceinline__ float abs_(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_(double v) { return fabs(v); }
__device__ __forceinline__ float pow_(float a, float n) {
  return powf(a, n);
}
__device__ __forceinline__ double pow_(double a, double n) {
  return pow(a, n);
}

// 1/x for normal x, within an ulp: the MUFU seed (20 fraction bits) and a
// third-order Newton step, as float64 K1 finishes it (gridgen_values.cu)
__device__ __forceinline__ double rcp64(double x) {
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  double e = fma(-x, y, 1.0);
  e = fma(e, e, e);
  return fma(y, e, y);
}

// Division by the spacing, as IEEE division rounds it. A float quotient
// is the float64 product with the reciprocal rounded to float: the exact
// quotient of two floats lies at least 2^-49 (relative) from every
// rounding boundary of float, the product within 2^-51 of it, so both
// round alike. That spares the division's slow-path CALL, across which
// ptxas spilled registers.
template <typename T>
struct Spacing;
template <>
struct Spacing<float> {
  float h[3];
  double inv[3];
  __device__ __forceinline__ explicit Spacing(const float* s) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      h[k] = s[k];
      inv[k] = rcp64(double(h[k]));
    }
  }
  __device__ __forceinline__ float div(float a, int k) const {
    return float(double(a) * inv[k]);
  }
};
template <>
struct Spacing<double> {
  double h[3];
  __device__ __forceinline__ explicit Spacing(const double* s) {
#pragma unroll
    for (int k = 0; k < 3; ++k) h[k] = s[k];
  }
  __device__ __forceinline__ double div(double a, int k) const {
    return a / h[k];
  }
};

struct Shape {
  int n_total;            // atoms in all, B * N (below 2^31)
  int n_atoms;            // N: atoms a replica (the scalings' columns)
  int replicas;           // B
  int scale_stride;       // elements from one grid's scalings to the next
  int n_grids;
  int nx, ny, nz;         // grid points
  int x_lo, x_count;      // the cells [x_lo, x_lo + x_count) along x held
  int restrain;
  int slot_bytes;         // a staged row's bytes in shared memory
};

// The atom of launch slot j, and its column n of the scalings: in the
// [B, N] order, or atom-major (kAtomMajor), slot j is then replica j % B
// of ligand atom j / B (ops/cuda_packed_eval.py, atom_order). 32-bit
// division: a 64-bit one is a CALL, across which ptxas spills.
__device__ __forceinline__ int atom_of(int j, const Shape& s, int& n) {
  if (!kAtomMajor) {
    n = j % s.n_atoms;
    return j;
  }
  n = j / s.replicas;
  return (j - n * s.replicas) * s.n_atoms + n;
}

// One grid's sums over this lane's runs: value and fraction-gradient
template <int D, typename T, bool kGlobal, int kRuns>
__device__ __forceinline__ void contract(const T* rg, int lane,
                                         const T (&bz)[D], const T (&dbz)[D],
                                         const T (&wxy)[kRuns],
                                         const T (&wdx)[kRuns],
                                         const T (&wdy)[kRuns], T& v, T& gx,
                                         T& gy, T& gz) {
  v = gx = gy = gz = T(0);
#pragma unroll
  for (int k = 0; k < kRuns; ++k) {
    T c[D];
    Run<D, T>::template load<kGlobal>(rg + (lane + kLanes * k) * D, c);
    T s0 = T(0), s1 = T(0);
#pragma unroll
    for (int r = 0; r < D; ++r) {
      s0 = fma_(c[r], bz[r], s0);
      s1 = fma_(c[r], dbz[r], s1);
    }
    v = fma_(wxy[k], s0, v);
    gx = fma_(wdx[k], s0, gx);
    gy = fma_(wdy[k], s0, gy);
    gz = fma_(wxy[k], s1, gz);
  }
}

// A grid's back-transform sign|v|^n of its value and fraction-gradient
template <typename T>
__device__ __forceinline__ void back_transform(T bp, T& v, T& gx, T& gy,
                                               T& gz) {
  const T mag = abs_(v);
  if (bp != T(0) && mag > T(1e-10)) {
    const T pf = bp * pow_(mag, bp - T(1));
    v = (v >= T(0) ? T(1) : T(-1)) * pow_(mag, bp);
    gx *= pf;
    gy *= pf;
    gz *= pf;
  }
}

// A grid's term of the atom's energy and forces: scaling times value and
// spatial gradient, as fused multiply-adds onto the sums; none where the
// scaling is 0
template <typename T>
__device__ __forceinline__ void add_grid(T sc, T v, T dx, T dy, T dz, T& e,
                                         T& fx, T& fy, T& fz) {
  if (sc != T(0)) {
    e = fma_(sc, v, e);
    fx = fma_(sc, dx, fx);
    fy = fma_(sc, dy, fy);
    fz = fma_(sc, dz, fz);
  }
}

// room for 2 blocks of kMaxThreads asked of ptxas: without it, it spilled
// 8-12 bytes at 72 registers in three instantiations
template <int D, bool CHEB, typename T, int GS>
__global__ void __launch_bounds__(kMaxThreads, 2)
packed_eval_kernel(const T* __restrict__ coeffs,
                   const T* __restrict__ positions,
                   const T* __restrict__ scaling,
                   const T* __restrict__ spacing,
                   const T* __restrict__ origin,
                   const T* __restrict__ back_powers, Shape s, T half_k,
                   T neg_k, T* __restrict__ energy, T* __restrict__ forces) {
  constexpr int kRuns = D * D / kLanes;
  constexpr int kRow = D * D * D;
  static_assert(kRuns * kLanes == D * D, "4 lanes must divide d^2");
  extern __shared__ __align__(128) unsigned char staged[];
  __shared__ __align__(8) uint64_t full;
  const int G = GS > 0 ? GS : s.n_grids;
  const int tile = blockDim.x / kLanes;
  const int slot = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const long long j = (long long)blockIdx.x * tile + slot;
  int n;                             // the atom's column of the scalings
  if (kStaged) {
    // one arrival an atom slot of the tile
    if (threadIdx.x == 0) barrier_init(&full, tile);
    __syncthreads();
  }
  if (j >= s.n_total) {
    if (kStaged && lane == 0) barrier_arrive(&full);
    return;                          // the atom's four lanes together
  }
  const long long a = atom_of(int(j), s, n);
  const unsigned group = 0xFu << (threadIdx.x % 32 / kLanes * kLanes);

  // locate (ops/interpolate.py: locate)
  const int counts[3] = {s.nx, s.ny, s.nz};
  const Spacing<T> h(spacing);
  T pos[3], f[3], corner[3];
  int ixyz[3];
  bool inside = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pos[k] = positions[3 * a + k] - origin[k];
    corner[k] = h.h[k] * T(counts[k] - 1);
    inside = inside && pos[k] >= T(0) && pos[k] <= corner[k];
    const T u = h.div(pos[k], k);
    // clamped before the conversion: far and non-finite positions give
    // some cell, which only atoms outside the box reach, and they read
    // no row
    const T c = clamp_(floor_(u), T(0), T(counts[k] - 2));
    ixyz[k] = (int)c;
    f[k] = clamp_(u - c, T(0), T(1));
  }
  const int local_x = ixyz[0] - s.x_lo;
  const bool owned = inside && local_x >= 0 && local_x < s.x_count;
  const long long cell =
      ((long long)local_x * (s.ny - 1) + ixyz[1]) * (s.nz - 1) + ixyz[2];
  const T* row = coeffs + cell * (long long)(G * kRow);
  T* slot_row = reinterpret_cast<T*>(staged + slot * s.slot_bytes);
  if (kStaged && lane == 0) {
    if (owned) {
      const uint32_t bytes = uint32_t(G * kRow * sizeof(T));
      barrier_arrive_tx(&full, bytes);
      bulk_copy(slot_row, row, bytes, &full);
    } else {
      barrier_arrive(&full);
    }
  }

  T e = T(0), fx = T(0), fy = T(0), fz = T(0);
  if (owned) {
    T bx[D], dbx[D], by[D], dby[D], bz[D], dbz[D];
    basis<D, CHEB>(f[0], bx, dbx);
    basis<D, CHEB>(f[1], by, dby);
    basis<D, CHEB>(f[2], bz, dbz);
    // this lane's runs (p, q) and their x-y weights
    T wxy[kRuns], wdx[kRuns], wdy[kRuns];
#pragma unroll
    for (int k = 0; k < kRuns; ++k) {
      const int i = lane + kLanes * k;
      const int p = i / D, q = i % D;
      const T xp = pick(bx, p), dxp = pick(dbx, p);
      const T yq = pick(by, q), dyq = pick(dby, q);
      wxy[k] = xp * yq;
      wdx[k] = dxp * yq;
      wdy[k] = xp * dyq;
    }
    if (kStaged) {
      barrier_wait(&full, 0);
      row = slot_row;
    }
    const int n_groups = (G + kLanes - 1) / kLanes;
#pragma unroll
    for (int gi = 0; gi < n_groups; ++gi) {
      const int g0 = gi * kLanes;
      // this lane's grid (g0 + lane) of the group of kLanes grids
      T mv = T(0), mx = T(0), my = T(0), mz = T(0);
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        const int g = g0 + l;
        if (g >= G) break;
        T v, gx, gy, gz;
        contract<D, T, !kStaged>(row + g * kRow, lane, bz, dbz, wxy, wdx,
                                 wdy, v, gx, gy, gz);
#pragma unroll
        for (int m = 1; m < kLanes; m <<= 1) {
          v += __shfl_xor_sync(group, v, m);
          gx += __shfl_xor_sync(group, gx, m);
          gy += __shfl_xor_sync(group, gy, m);
          gz += __shfl_xor_sync(group, gz, m);
        }
        if (kSplitTail) {
          if (lane == l) {
            mv = v; mx = gx; my = gy; mz = gz;
          }
        } else {
          const T sc = scaling[g * (long long)s.scale_stride + n];
          back_transform(back_powers[g], v, gx, gy, gz);
          if (sc != T(0))
            add_grid(sc, v, h.div(gx, 0), h.div(gy, 1), h.div(gz, 2), e, fx,
                     fy, fz);
        }
      }
      if (kSplitTail) {
        // lane l: grid g0 + l's back-transform, scaling and division by
        // the spacing
        T sc = T(0);
        const int g = g0 + lane;
        if (g < G) {
          sc = scaling[g * (long long)s.scale_stride + n];
          back_transform(back_powers[g], mv, mx, my, mz);
          if (sc != T(0)) {
            mx = h.div(mx, 0);
            my = h.div(my, 1);
            mz = h.div(mz, 2);
          }
        }
        // the grids' terms in grid order, on every lane of the atom
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
          if (g0 + l >= G) break;
          add_grid(__shfl_sync(group, sc, l, kLanes),
                   __shfl_sync(group, mv, l, kLanes),
                   __shfl_sync(group, mx, l, kLanes),
                   __shfl_sync(group, my, l, kLanes),
                   __shfl_sync(group, mz, l, kLanes), e, fx, fy, fz);
        }
      }
    }
    fx = -fx;
    fy = -fy;
    fz = -fz;
  }
  if (s.restrain && !inside) {
    T dev[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dev[k] = pos[k] < T(0) ? pos[k]
               : (pos[k] > corner[k] ? pos[k] - corner[k] : T(0));
    e += half_k * (dev[0] * dev[0] + dev[1] * dev[1] + dev[2] * dev[2]);
    fx += neg_k * dev[0];
    fy += neg_k * dev[1];
    fz += neg_k * dev[2];
  }
  if (lane == 0)
    energy[a] = e;
  else
    forces[3 * a + lane - 1] = lane == 1 ? fx : (lane == 2 ? fy : fz);
}

template <int D, bool CHEB, typename T, int GS>
int launch(const void* coeffs, const void* positions, const void* scaling,
           const void* spacing, const void* origin, const void* back_powers,
           const Shape& s, double oob_k, int tile, int device, void* energy,
           void* forces, cudaStream_t stream) {
  // the dynamic shared memory asked for so far, by device
  static int granted[kDevices] = {};
  const long long blocks = ((long long)s.n_total + tile - 1) / tile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int shared = kStaged ? tile * s.slot_bytes : 0;
  if (shared > 48 * 1024 && shared > granted[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        packed_eval_kernel<D, CHEB, T, GS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
    granted[device] = shared;
  }
  packed_eval_kernel<D, CHEB, T, GS>
      <<<(unsigned)blocks, tile * kLanes, shared, stream>>>(
          static_cast<const T*>(coeffs), static_cast<const T*>(positions),
          static_cast<const T*>(scaling), static_cast<const T*>(spacing),
          static_cast<const T*>(origin), static_cast<const T*>(back_powers),
          s, T(0.5 * oob_k), T(-oob_k), static_cast<T*>(energy),
          static_cast<T*>(forces));
  return (int)cudaGetLastError();
}

template <int D, bool CHEB, typename T>
int launch_grids(const void* coeffs, const void* positions,
                 const void* scaling, const void* spacing,
                 const void* origin, const void* back_powers,
                 const Shape& s, double oob_k, int tile, int device,
                 void* energy, void* forces, cudaStream_t stream) {
  const int g = kUnrollGrids && s.n_grids <= 3 ? s.n_grids : 0;
#define PACKED_EVAL_GRIDS(G)                                               \
  case G:                                                                  \
    return launch<D, CHEB, T, G>(coeffs, positions, scaling, spacing,      \
                                 origin, back_powers, s, oob_k, tile,      \
                                 device, energy, forces, stream);
  switch (g) {
    PACKED_EVAL_GRIDS(1)
    PACKED_EVAL_GRIDS(2)
    PACKED_EVAL_GRIDS(3)
    default:
      return launch<D, CHEB, T, 0>(coeffs, positions, scaling, spacing,
                                   origin, back_powers, s, oob_k, tile,
                                   device, energy, forces, stream);
  }
#undef PACKED_EVAL_GRIDS
}

template <typename T>
int launch_any(int degree, int chebyshev, const void* coeffs,
               const void* positions, const void* scaling,
               const void* spacing, const void* origin,
               const void* back_powers, const Shape& s, double oob_k,
               int tile, int device, void* energy, void* forces,
               cudaStream_t stream) {
#define PACKED_EVAL_CASE(D)                                                 \
  case D:                                                                   \
    return chebyshev                                                        \
               ? launch_grids<D, true, T>(coeffs, positions, scaling,       \
                                          spacing, origin, back_powers, s,  \
                                          oob_k, tile, device, energy,      \
                                          forces, stream)                   \
               : launch_grids<D, false, T>(coeffs, positions, scaling,      \
                                           spacing, origin, back_powers, s, \
                                           oob_k, tile, device, energy,     \
                                           forces, stream);
  switch (degree) {
    PACKED_EVAL_CASE(2)
    PACKED_EVAL_CASE(4)
    PACKED_EVAL_CASE(6)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PACKED_EVAL_CASE
}

}  // namespace

// coeffs [ncells_held, n_grids * degree^3], positions [n_total, 3],
// scaling [n_grids, n_atoms] with grid stride scale_stride (n_atoms, or 0
// for one row shared by every grid), spacing and origin [3], back_powers
// [n_grids] (0 = no back-transform): all device memory of one scalar type
// (f64: float64, else float32). Writes energy [n_total] and forces
// [n_total, 3]. Cells [x_lo, x_lo + x_count) along x are the rows held;
// restrain adds the out-of-box restraint of strength oob_k. A block is
// tile_atoms atoms (at most 32), each staged in slot_bytes of shared
// memory (at least its row's bytes, a multiple of 16): the host's launch
// plan.
extern "C" int packed_eval_launch(const void* coeffs, const void* positions,
                                  const void* scaling, const void* spacing,
                                  const void* origin,
                                  const void* back_powers, void* energy,
                                  void* forces, long long n_total,
                                  int n_atoms, int scale_stride, int n_grids,
                                  int degree, int chebyshev, int f64, int nx,
                                  int ny, int nz, int x_lo, int x_count,
                                  int restrain, double oob_k, int tile_atoms,
                                  int slot_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_total <= 0) return 0;
  const long long row = (long long)n_grids * degree * degree * degree
                        * (f64 ? 8 : 4);
  if (n_total > 0x7fffffffLL || n_atoms <= 0 || n_total % n_atoms
      || n_grids <= 0 || nx < 2
      || ny < 2 || nz < 2 || device < 0 || device >= kDevices
      || tile_atoms < 1 || tile_atoms * kLanes > kMaxThreads
      || slot_bytes < row || slot_bytes % 16
      || (long long)tile_atoms * slot_bytes + kBarrierBytes > kMaxShared)
    return (int)cudaErrorInvalidValue;
  const Shape s{int(n_total), n_atoms, int(n_total / n_atoms),
                scale_stride, n_grids, nx, ny, nz, x_lo, x_count,
                restrain, slot_bytes};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f64 ? launch_any<double>(degree, chebyshev, coeffs, positions,
                                  scaling, spacing, origin, back_powers, s,
                                  oob_k, tile_atoms, device, energy, forces,
                                  st)
             : launch_any<float>(degree, chebyshev, coeffs, positions,
                                 scaling, spacing, origin, back_powers, s,
                                 oob_k, tile_atoms, device, energy, forces,
                                 st);
}

extern "C" const char* packed_eval_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
