// The se_e2_a environment matrix for Hopper (sm_90a), forward and backward:
// each neighbour slot's row R~ = s (1, x/r, y/r, z/r) of paper Eq. 1, scaled
// by its centre type's dstd, and the gradient dE/dr_ij from the gradients of
// that row and of s. Plain C entry points, built by build.py into the same
// library as dp_fused.cu and loaded with ctypes.
//
// Replaces no Pallas kernel: the reference writes descriptor.env_matrix and
// normalize_env as jnp ops, which XLA fuses into one or two loops on the
// TPU. Run eagerly in PyTorch, the same ops are ~28 passes over every
// (atom, slot) forward and ~58 in their autograd backward (the norm, the
// quintic switch in a dozen ops, five wheres, the unit vector, a cat, two
// divides, and the backward of each).
//
// What bounds it: device memory. Per slot the forward reads r_ij (12 bytes)
// and the mask (1) and writes the scaled row (16) and s (4), 33 bytes; the
// backward reads r_ij, the mask, the row's gradient (16) and s's (4) and
// writes dE/dr_ij (12), 45 bytes. A padded slot reads only its mask. The
// arithmetic (a square root and eight divides a slot forward) stays under the
// bytes' time.
//
// The design follows from that:
//   * One thread per (atom, slot) in a grid-stride loop over A x N. A warp's
//     r_ij loads cover 384 contiguous bytes; the row goes out as one float4
//     store (16 bytes a thread, coalesced) and s as one float.
//   * The centre's scale is dstd[atype[a]] (ntypes x 4 floats, read through
//     the cache; a warp's slots share one or two centres).
//   * No intermediate is saved: the backward recomputes r, s, s' and the
//     unit vector from r_ij. It has no atomics and no reductions, so it is
//     the same bit for bit from run to run.
//   * Float32 throughout, the configuration's precision. The forward follows
//     the eager ops' order of operations where it decides the last bit: each
//     op of the quintic switch rounds on its own (no contraction), the
//     switch's 1/(rcut - rcut_smth) is a float reciprocal as ATen's division
//     by a scalar makes it, w/r, x/r and the divisions by dstd are
//     correctly rounded, and the norm sums its squares as ATen's reduction
//     over a row of three does, (x^2 + z^2) + y^2 with no fused multiply-add
//     (measured on the H100: r equal bit for bit on 4 M random rows).
//   * A padded slot (mask false) writes zeros, forward and backward. A type
//     outside [0, ntypes) writes NaN rather than read past dstd.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// w(u) = u^3 (-6 u^2 + 15 u - 10) + 1, each product and sum rounded as the
// eager ops round them: ((u u) u) (((-6 u) u + 15 u) - 10) + 1.
__device__ __forceinline__ float quintic(float uu) {
  const float cube = __fmul_rn(__fmul_rn(uu, uu), uu);
  const float poly = __fsub_rn(
      __fadd_rn(__fmul_rn(__fmul_rn(-6.f, uu), uu), __fmul_rn(15.f, uu)),
      10.f);
  return __fadd_rn(__fmul_rn(cube, poly), 1.f);
}

// One live slot's geometry as descriptor.env_matrix computes it.
struct Geometry {
  float r;      // |r_ij|, or 1 where |r_ij| <= 1e-6 (the plain safe_r)
  float u;      // (r - rcut_smth) / (rcut - rcut_smth), unclamped
  float w;      // the switch w(clamp(u, 0, 1))
  float s;      // w / r where 1e-6 < r < rcut, else 0
  bool inside;  // 1e-6 < r < rcut
};

__device__ __forceinline__ Geometry geometry(float x, float y, float z,
                                             float rcut_smth, float rcut,
                                             float inv_span) {
  const float r = __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(z, z)), __fmul_rn(y, y)));
  Geometry g;
  g.u = __fmul_rn(__fsub_rn(r, rcut_smth), inv_span);
  g.w = quintic(fminf(fmaxf(g.u, 0.f), 1.f));
  const bool live = r > 1e-6f;
  g.r = live ? r : 1.f;
  g.inside = live && r < rcut;
  g.s = g.inside ? __fdiv_rn(g.w, r) : 0.f;
  return g;
}

__global__ void __launch_bounds__(kThreads)
    env_mat_forward_kernel(const float* __restrict__ rij,
                           const unsigned char* __restrict__ nmask,
                           const long long* __restrict__ atype,
                           const float* __restrict__ dstd,
                           float4* __restrict__ env, float* __restrict__ s_n,
                           long long slots, int N, int ntypes,
                           float rcut_smth, float rcut, float inv_span) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < slots; i += (long long)gridDim.x * blockDim.x) {
    float4 row = make_float4(0.f, 0.f, 0.f, 0.f);
    if (nmask[i]) {
      const long long t = __ldg(atype + i / N);
      if (t < 0 || t >= ntypes) {
        const float nan = __int_as_float(0x7fc00000);
        row = make_float4(nan, nan, nan, nan);
      } else {
        const float x = rij[3 * i], y = rij[3 * i + 1], z = rij[3 * i + 2];
        const Geometry g = geometry(x, y, z, rcut_smth, rcut, inv_span);
        const float* sd = dstd + 4 * t;
        // env = (s, s x/r, s y/r, s z/r), then each column over its scale
        row.x = __fdiv_rn(g.s, __ldg(sd));
        row.y = __fdiv_rn(__fmul_rn(g.s, __fdiv_rn(x, g.r)), __ldg(sd + 1));
        row.z = __fdiv_rn(__fmul_rn(g.s, __fdiv_rn(y, g.r)), __ldg(sd + 2));
        row.w = __fdiv_rn(__fmul_rn(g.s, __fdiv_rn(z, g.r)), __ldg(sd + 3));
      }
    }
    env[i] = row;
    s_n[i] = row.x;  // s / dstd_0, the same division as the row's first
  }
}

// dE/dr_b = g0 s' rh_b + sum_a g_a [s' rh_a rh_b + s (delta_ab - rh_a rh_b)/r]
//         = rh_b (s' (g0 + G) - (s/r) G) + (s/r) g_b,   G = sum_a g_a rh_a,
// with g0 = (denv_0 + ds) / dstd_0, g_a = denv_a / dstd_a, rh = r_ij / r,
// s' = (w' r - w) / r^2 and w' = -30 u^2 (u - 1)^2 / (rcut - rcut_smth) for
// 0 < u < 1, else 0. Outside 1e-6 < r < rcut, s and s' are 0 (the plain
// wheres), and so is the gradient.
__global__ void __launch_bounds__(kThreads)
    env_mat_backward_kernel(const float* __restrict__ rij,
                            const unsigned char* __restrict__ nmask,
                            const long long* __restrict__ atype,
                            const float* __restrict__ dstd,
                            const float4* __restrict__ denv,
                            const float* __restrict__ ds,
                            float* __restrict__ drij, long long slots, int N,
                            int ntypes, float rcut_smth, float rcut,
                            float inv_span) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < slots; i += (long long)gridDim.x * blockDim.x) {
    float dx = 0.f, dy = 0.f, dz = 0.f;
    if (nmask[i]) {
      const long long t = __ldg(atype + i / N);
      if (t < 0 || t >= ntypes) {
        dx = dy = dz = __int_as_float(0x7fc00000);
      } else {
        const float x = rij[3 * i], y = rij[3 * i + 1], z = rij[3 * i + 2];
        const Geometry g = geometry(x, y, z, rcut_smth, rcut, inv_span);
        if (g.inside) {
          const float* sd = dstd + 4 * t;
          const float4 de = denv[i];
          const float u = g.u, um1 = u - 1.f;
          const float dw = (u > 0.f && u < 1.f)
                               ? -30.f * u * u * um1 * um1 * inv_span
                               : 0.f;
          const float r = g.r;
          const float s_r = (dw * r - g.w) / (r * r);     // s'
          const float g0 = (de.x + ds[i]) / __ldg(sd);
          const float gx = de.y / __ldg(sd + 1);
          const float gy = de.z / __ldg(sd + 2);
          const float gz = de.w / __ldg(sd + 3);
          const float hx = x / r, hy = y / r, hz = z / r;
          const float dot = gx * hx + gy * hy + gz * hz;
          const float sor = g.s / r;
          const float c = s_r * (g0 + dot) - sor * dot;
          dx = c * hx + sor * gx;
          dy = c * hy + sor * gy;
          dz = c * hz + sor * gz;
        }
      }
    }
    drij[3 * i] = dx;
    drij[3 * i + 1] = dy;
    drij[3 * i + 2] = dz;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Enough blocks to fill the card, at most one slot a thread.
cudaError_t grid_for(const void* kernel, long long slots, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;  // the launch reports the shortfall
  long long n = (slots + kThreads - 1) / kThreads;
  if (n > (long long)sms * per_sm) n = (long long)sms * per_sm;
  *grid = (int)n;
  return cudaSuccess;
}

bool bad_args(long long slots, int N, int ntypes, float span) {
  return slots < 0 || N < 1 || slots % N != 0 || ntypes < 1 || !(span > 0.f);
}

}  // namespace

extern "C" {

// rij (slots, 3) float, nmask (slots) bool, atype (slots / N) int64, dstd
// (ntypes, 4) float; env (slots, 4) 16-byte aligned and s_n (slots) are
// written whole. span = rcut - rcut_smth. Returns cudaGetLastError() after
// the launch (0: launched).
int env_mat_fwd(const void* rij, const void* nmask, const void* atype,
                const void* dstd, void* env, void* s_n, long long slots, int N,
                int ntypes, float rcut_smth, float rcut, float span,
                void* stream) {
  if (bad_args(slots, N, ntypes, span) || !aligned16(env))
    return (int)cudaErrorInvalidValue;
  if (slots == 0) return (int)cudaSuccess;
  int grid = 0;
  cudaError_t err = grid_for((const void*)env_mat_forward_kernel, slots, &grid);
  if (err != cudaSuccess) return (int)err;
  env_mat_forward_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rij, (const unsigned char*)nmask, (const long long*)atype,
      (const float*)dstd, (float4*)env, (float*)s_n, slots, N, ntypes,
      rcut_smth, rcut, 1.0f / span);
  return (int)cudaGetLastError();
}

// denv (slots, 4) 16-byte aligned and ds (slots): the gradients of env and
// s_n; drij (slots, 3) is written whole.
int env_mat_bwd(const void* rij, const void* nmask, const void* atype,
                const void* dstd, const void* denv, const void* ds,
                void* drij, long long slots, int N, int ntypes,
                float rcut_smth, float rcut, float span, void* stream) {
  if (bad_args(slots, N, ntypes, span) || !aligned16(denv))
    return (int)cudaErrorInvalidValue;
  if (slots == 0) return (int)cudaSuccess;
  int grid = 0;
  cudaError_t err =
      grid_for((const void*)env_mat_backward_kernel, slots, &grid);
  if (err != cudaSuccess) return (int)err;
  env_mat_backward_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rij, (const unsigned char*)nmask, (const long long*)atype,
      (const float*)dstd, (const float4*)denv, (const float*)ds, (float*)drij,
      slots, N, ntypes, rcut_smth, rcut, 1.0f / span);
  return (int)cudaGetLastError();
}

}  // extern "C"
