// K3's first design, kept for timing beside the shipped kernel
// (csrc/packed_eval.cu): python -m openmmgridforce_tpu_torch.kernel_variants
// packed_eval builds it in place of the shipped source. It is not part of
// the package's build.
//
// One row gathered per atom straight from device memory, in the launch
// order of the [B, N] flattening (replica-major): kLanes = 4 lanes an
// atom, 8 atoms a warp; lane l takes the runs of d z-coefficients i = l +
// 4k of a grid as one to three vector loads and contracts them with the
// z-basis; the four lanes' sums are added by two xor shuffles, and every
// lane applies each grid's tail (back power, spacing, scaling). The grid
// loop is not unrolled. It takes the shipped kernel's C entry point; the
// tile and slot arguments are not used (128 threads a block).
//
// Registers (ptxas, NVIDIA H100 80GB HBM3 build): float32 56 / 71-72 / 96
// at d = 2 / 4 / 6, float64 78 / 110-112 / 128, no spills.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 4;
constexpr int kThreads = 128;

static_assert(kThreads % 32 == 0 && 32 % kLanes == 0, "lanes");

// the d coefficients of a run: one to three vector loads; rows are
// 16-byte aligned (the wrapper checks the table's base) and a run starts
// at a multiple of 8 (float, d = 2 and 6) or 16 bytes
template <int D, typename T>
struct Run;
template <>
struct Run<2, float> {
  static __device__ __forceinline__ void load(const float* p, float (&c)[2]) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    c[0] = a.x; c[1] = a.y;
  }
};
template <>
struct Run<4, float> {
  static __device__ __forceinline__ void load(const float* p, float (&c)[4]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w;
  }
};
template <>
struct Run<6, float> {
  static __device__ __forceinline__ void load(const float* p, float (&c)[6]) {
    const float2* v = reinterpret_cast<const float2*>(p);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float2 a = __ldg(v + j);
      c[2 * j] = a.x; c[2 * j + 1] = a.y;
    }
  }
};
template <int D>
struct Run<D, double> {
  static __device__ __forceinline__ void load(const double* p,
                                              double (&c)[D]) {
    const double2* v = reinterpret_cast<const double2*>(p);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) {
      const double2 a = __ldg(v + j);
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
  long long n_total;      // atoms in all, B * N
  int n_atoms;            // N: atoms a replica (the scalings' columns)
  int scale_stride;       // elements from one grid's scalings to the next
  int n_grids;
  int nx, ny, nz;         // grid points
  int x_lo, x_count;      // the cells [x_lo, x_lo + x_count) along x held
  int restrain;
};

template <int D, bool CHEB, typename T>
__global__ void __launch_bounds__(kThreads)
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
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long a = t / kLanes;
  const int lane = threadIdx.x % kLanes;
  if (a >= s.n_total) return;       // the atom's four lanes together
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
    const long long cell =
        ((long long)local_x * (s.ny - 1) + ixyz[1]) * (s.nz - 1) + ixyz[2];
    const T* row = coeffs + cell * (long long)(s.n_grids * kRow);
    const long long n = a % s.n_atoms;
    for (int g = 0; g < s.n_grids; ++g) {
      const T* rg = row + g * kRow;
      T v = T(0), gx = T(0), gy = T(0), gz = T(0);
#pragma unroll
      for (int k = 0; k < kRuns; ++k) {
        T c[D];
        Run<D, T>::load(rg + (lane + kLanes * k) * D, c);
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
#pragma unroll
      for (int m = 1; m < kLanes; m <<= 1) {
        v += __shfl_xor_sync(group, v, m);
        gx += __shfl_xor_sync(group, gx, m);
        gy += __shfl_xor_sync(group, gy, m);
        gz += __shfl_xor_sync(group, gz, m);
      }
      const T bp = back_powers[g];
      const T mag = abs_(v);
      if (bp != T(0) && mag > T(1e-10)) {
        const T pf = bp * pow_(mag, bp - T(1));
        v = (v >= T(0) ? T(1) : T(-1)) * pow_(mag, bp);
        gx *= pf;
        gy *= pf;
        gz *= pf;
      }
      const T sc = scaling[g * (long long)s.scale_stride + n];
      if (sc != T(0)) {
        e += sc * v;
        fx += sc * h.div(gx, 0);
        fy += sc * h.div(gy, 1);
        fz += sc * h.div(gz, 2);
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

template <int D, bool CHEB, typename T>
int launch(const void* coeffs, const void* positions, const void* scaling,
           const void* spacing, const void* origin, const void* back_powers,
           const Shape& s, double oob_k, void* energy, void* forces,
           cudaStream_t stream) {
  const long long blocks = (s.n_total * kLanes + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  packed_eval_kernel<D, CHEB, T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(coeffs), static_cast<const T*>(positions),
      static_cast<const T*>(scaling), static_cast<const T*>(spacing),
      static_cast<const T*>(origin), static_cast<const T*>(back_powers), s,
      T(0.5 * oob_k), T(-oob_k), static_cast<T*>(energy),
      static_cast<T*>(forces));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(int degree, int chebyshev, const void* coeffs,
               const void* positions, const void* scaling,
               const void* spacing, const void* origin,
               const void* back_powers, const Shape& s, double oob_k,
               void* energy, void* forces, cudaStream_t stream) {
#define PACKED_EVAL_CASE(D)                                                 \
  case D:                                                                   \
    return chebyshev                                                        \
               ? launch<D, true, T>(coeffs, positions, scaling, spacing,    \
                                    origin, back_powers, s, oob_k, energy,  \
                                    forces, stream)                         \
               : launch<D, false, T>(coeffs, positions, scaling, spacing,   \
                                     origin, back_powers, s, oob_k, energy, \
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

// The shipped kernel's entry point (csrc/packed_eval.cu); tile_atoms and
// slot_bytes are not used.
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
  (void)tile_atoms;
  (void)slot_bytes;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_total <= 0) return 0;
  if (n_atoms <= 0 || n_grids <= 0 || nx < 2 || ny < 2 || nz < 2)
    return (int)cudaErrorInvalidValue;
  const Shape s{n_total, n_atoms, scale_stride, n_grids, nx, ny, nz, x_lo,
                x_count, restrain};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f64 ? launch_any<double>(degree, chebyshev, coeffs, positions,
                                  scaling, spacing, origin, back_powers, s,
                                  oob_k, energy, forces, st)
             : launch_any<float>(degree, chebyshev, coeffs, positions,
                                 scaling, spacing, origin, back_powers, s,
                                 oob_k, energy, forces, st);
}

extern "C" const char* packed_eval_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
