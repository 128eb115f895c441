// Fused Chebyshev tabulation + R~^T G contraction, forward and backward, for
// Hopper (sm_90a). Plain C entry points, loaded with ctypes by build.py.
//
// Replaces the TPU kernels of src/repro/kernels/dp_fused/dp_fused.py:
//   dp_fused_fwd  <- fused_fwd (kernel body _fwd_kernel)
//   dp_fused_bwd  <- fused_bwd (kernel body _bwd_kernel)
//
// Per atom a with live slots n < count[a] (slots past it are padding and are
// never read):
//   u  = clip((2 s - lo - hi) / (hi - lo), -1, 1)
//   B  = [T_0 .. T_{K-1}](u), B' its derivative       (recurrence)
//   G  = B C,  G' = B' C                              (K x M coefficients)
//   fwd: T[a] = sum_n env[a,n,:]^T G[n,:]             -> (4, M)
//   bwd: denv[a,n,:] = G[n,:] dT[a]^T,
//        ds[a,n] = sum_m (env[a,n,:] dT[a])_m G'[n,m] 2/(hi-lo) [|u_raw|<1],
//        both zero for n >= count[a].
//
// What bounds it on the H100. At the copper shapes (K = 32, M = 128, about
// 350 live slots per atom out of N = 824 after capacity escalation) a live
// slot costs 2KM + 8M = 9.2 kFLOP forward and 4KM + 18M = 18.7 kFLOP
// backward, but brings in only 20 bytes (s and one env row). That is
// several hundred FLOP per byte against the card's FP32 balance of about
// 20 (67 TFLOP/s over 3.35 TB/s), so both kernels are bound by FP32
// operations, not by memory; the backward also writes ds and denv for every
// slot (20 bytes each), which stays far below the operation bound.
//
// What the design does about it:
//   * G and G' never reach device memory: each lane forms its columns of a
//     G row in registers and uses them at once (the point of the TPU kernel).
//   * C sits in shared memory (K*M*4 bytes: 16 KB at K=32, M=128). Blocks
//     are persistent and walk many atoms, so C is read from L2 once a block.
//   * A warp evaluates kSlots slots together, so each C[k][m] read from
//     shared memory feeds kSlots FMAs. Each lane runs the basis recurrence
//     in registers (a few ops per k against kSlots*NCOL FMAs).
//   * The block walks only n < count[a]: the per-atom skip removes the ~60%
//     padding of an escalated neighbour list (the TPU kernel skipped whole
//     128-slot tiles instead).
// Simple scalar FP32 FMAs, no wgmma or TMA: tensor cores in TF32 would
// loosen the FP32 result, and speed is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                 // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kSlots = 4;                 // slots a warp evaluates together
constexpr int kMaxCols = 8;               // M <= 32 * kMaxCols = 256

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float u_raw_of(float s, float lower, float upper) {
  return (2.f * s - lower - upper) / (upper - lower);
}

// A count outside [0, N] is clamped, so no slot outside the row is touched.
__device__ __forceinline__ int live_count(int c, int N) {
  return c < 0 ? 0 : (c > N ? N : c);
}

template <int NCOL>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ s, const float* __restrict__ env,
           const float* __restrict__ coeffs, const int* __restrict__ counts,
           float* __restrict__ out, int A, int N, int K, int M, float lower,
           float upper) {
  extern __shared__ float smem[];
  float* c_sh = smem;                     // (K, M)
  float* part = smem + K * M;             // (kWarps, 4, M) per-warp partial T
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < K * M; i += blockDim.x) c_sh[i] = coeffs[i];
  __syncthreads();

  for (int a = blockIdx.x; a < A; a += gridDim.x) {
    const int cnt = live_count(counts[a], N);
    const float* s_a = s + (size_t)a * N;
    const float* e_a = env + (size_t)a * N * 4;
    float acc[4][NCOL];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int j = 0; j < NCOL; ++j) acc[c][j] = 0.f;

    for (int n0 = warp * kSlots; n0 < cnt; n0 += kWarps * kSlots) {
      float u[kSlots], tk[kSlots], tkm1[kSlots], e[kSlots][4];
      float g[kSlots][NCOL];
#pragma unroll
      for (int p = 0; p < kSlots; ++p) {
        const int n = n0 + p;
        const bool live = n < cnt;
        const float sv = live ? s_a[n] : 0.f;
        u[p] = fminf(fmaxf(u_raw_of(sv, lower, upper), -1.f), 1.f);
        tk[p] = 1.f;        // T_0
        tkm1[p] = u[p];     // T_{-1} := T_1, so the recurrence yields T_1 = u
#pragma unroll
        for (int c = 0; c < 4; ++c) e[p][c] = live ? e_a[4 * n + c] : 0.f;
#pragma unroll
        for (int j = 0; j < NCOL; ++j) g[p][j] = 0.f;
      }
      for (int k = 0; k < K; ++k) {
        const float* c_row = c_sh + k * M;
        float ck[NCOL];
#pragma unroll
        for (int j = 0; j < NCOL; ++j) {
          const int m = lane + 32 * j;
          ck[j] = m < M ? c_row[m] : 0.f;
        }
#pragma unroll
        for (int p = 0; p < kSlots; ++p) {
#pragma unroll
          for (int j = 0; j < NCOL; ++j) g[p][j] = fmaf(tk[p], ck[j], g[p][j]);
          const float next = 2.f * u[p] * tk[p] - tkm1[p];
          tkm1[p] = tk[p];
          tk[p] = next;
        }
      }
#pragma unroll
      for (int p = 0; p < kSlots; ++p)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int j = 0; j < NCOL; ++j)
            acc[c][j] = fmaf(e[p][c], g[p][j], acc[c][j]);
    }

    // Sum the warps' partial T in shared memory, then write T[a].
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int j = 0; j < NCOL; ++j) {
        const int m = lane + 32 * j;
        if (m < M) part[(warp * 4 + c) * M + m] = acc[c][j];
      }
    __syncthreads();
    float* out_a = out + (size_t)a * 4 * M;
    for (int i = threadIdx.x; i < 4 * M; i += blockDim.x) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += part[w * 4 * M + i];
      out_a[i] = t;
    }
    __syncthreads();                      // part is reused by the next atom
  }
}

template <int NCOL>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const float* __restrict__ s, const float* __restrict__ env,
           const float* __restrict__ coeffs, const int* __restrict__ counts,
           const float* __restrict__ dt, float* __restrict__ ds,
           float* __restrict__ denv, int A, int N, int K, int M, float lower,
           float upper) {
  extern __shared__ float smem[];
  float* c_sh = smem;                     // (K, M)
  float* dt_sh = smem + K * M;            // (4, M) cotangent of T[a]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float du_ds = 2.f / (upper - lower);
  for (int i = threadIdx.x; i < K * M; i += blockDim.x) c_sh[i] = coeffs[i];

  for (int a = blockIdx.x; a < A; a += gridDim.x) {
    __syncthreads();                      // C loaded; last atom's dt_sh read
    for (int i = threadIdx.x; i < 4 * M; i += blockDim.x)
      dt_sh[i] = dt[(size_t)a * 4 * M + i];
    __syncthreads();
    const int cnt = live_count(counts[a], N);
    const float* s_a = s + (size_t)a * N;
    const float* e_a = env + (size_t)a * N * 4;
    float* ds_a = ds + (size_t)a * N;
    float* denv_a = denv + (size_t)a * N * 4;
    float dtr[4][NCOL];                   // this lane's columns of dT[a]
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int j = 0; j < NCOL; ++j) {
        const int m = lane + 32 * j;
        dtr[c][j] = m < M ? dt_sh[c * M + m] : 0.f;
      }

    for (int n0 = warp * kSlots; n0 < cnt; n0 += kWarps * kSlots) {
      float u[kSlots], tk[kSlots], tkm1[kSlots], dk[kSlots], dkm1[kSlots];
      float e[kSlots][4], in_dom[kSlots];
      float g[kSlots][NCOL], gp[kSlots][NCOL];
#pragma unroll
      for (int p = 0; p < kSlots; ++p) {
        const int n = n0 + p;
        const bool live = n < cnt;
        const float ur = u_raw_of(live ? s_a[n] : 0.f, lower, upper);
        in_dom[p] = fabsf(ur) < 1.f ? 1.f : 0.f;
        u[p] = fminf(fmaxf(ur, -1.f), 1.f);
        tk[p] = 1.f;        // T_0
        tkm1[p] = u[p];     // T_{-1} := T_1
        dk[p] = 0.f;        // T'_0
        dkm1[p] = 1.f;      // T'_{-1} := T'_1
#pragma unroll
        for (int c = 0; c < 4; ++c) e[p][c] = live ? e_a[4 * n + c] : 0.f;
#pragma unroll
        for (int j = 0; j < NCOL; ++j) {
          g[p][j] = 0.f;
          gp[p][j] = 0.f;
        }
      }
      for (int k = 0; k < K; ++k) {
        const float* c_row = c_sh + k * M;
        float ck[NCOL];
#pragma unroll
        for (int j = 0; j < NCOL; ++j) {
          const int m = lane + 32 * j;
          ck[j] = m < M ? c_row[m] : 0.f;
        }
#pragma unroll
        for (int p = 0; p < kSlots; ++p) {
#pragma unroll
          for (int j = 0; j < NCOL; ++j) {
            g[p][j] = fmaf(tk[p], ck[j], g[p][j]);
            gp[p][j] = fmaf(dk[p], ck[j], gp[p][j]);
          }
          const float next_d = 2.f * tk[p] + 2.f * u[p] * dk[p] - dkm1[p];
          const float next_t = 2.f * u[p] * tk[p] - tkm1[p];
          dkm1[p] = dk[p];
          dk[p] = next_d;
          tkm1[p] = tk[p];
          tk[p] = next_t;
        }
      }
#pragma unroll
      for (int p = 0; p < kSlots; ++p) {
        float de[4] = {0.f, 0.f, 0.f, 0.f};
        float dsv = 0.f;
#pragma unroll
        for (int j = 0; j < NCOL; ++j) {
          float w = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            de[c] = fmaf(g[p][j], dtr[c][j], de[c]);
            w = fmaf(e[p][c], dtr[c][j], w);
          }
          dsv = fmaf(w, gp[p][j], dsv);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) de[c] = warp_sum(de[c]);
        dsv = warp_sum(dsv);
        const int n = n0 + p;
        if (n < cnt) {
          // every lane holds the sums after the butterfly: lanes 0-3 write
          // the denv row, lane 4 writes ds
          if (lane < 4) {
            float v = de[0];
            if (lane == 1) v = de[1];
            if (lane == 2) v = de[2];
            if (lane == 3) v = de[3];
            denv_a[4 * n + lane] = v;
          } else if (lane == 4) {
            ds_a[n] = dsv * du_ds * in_dom[p];
          }
        }
      }
    }

    // Slots at and past the live count get zero gradients.
    for (int i = cnt + threadIdx.x; i < N; i += blockDim.x) {
      ds_a[i] = 0.f;
      denv_a[4 * i + 0] = 0.f;
      denv_a[4 * i + 1] = 0.f;
      denv_a[4 * i + 2] = 0.f;
      denv_a[4 * i + 3] = 0.f;
    }
  }
}

using FwdFn = void (*)(const float*, const float*, const float*, const int*,
                       float*, int, int, int, int, float, float);
using BwdFn = void (*)(const float*, const float*, const float*, const int*,
                       const float*, float*, float*, int, int, int, int, float,
                       float);

FwdFn pick_fwd(int ncol) {
  switch (ncol) {
    case 1: return fwd_kernel<1>;
    case 2: return fwd_kernel<2>;
    case 3: return fwd_kernel<3>;
    case 4: return fwd_kernel<4>;
    case 5: return fwd_kernel<5>;
    case 6: return fwd_kernel<6>;
    case 7: return fwd_kernel<7>;
    case 8: return fwd_kernel<8>;
    default: return nullptr;
  }
}

BwdFn pick_bwd(int ncol) {
  switch (ncol) {
    case 1: return bwd_kernel<1>;
    case 2: return bwd_kernel<2>;
    case 3: return bwd_kernel<3>;
    case 4: return bwd_kernel<4>;
    case 5: return bwd_kernel<5>;
    case 6: return bwd_kernel<6>;
    case 7: return bwd_kernel<7>;
    case 8: return bwd_kernel<8>;
    default: return nullptr;
  }
}

// Opt the kernel into `smem` bytes of dynamic shared memory and size a
// persistent grid: as many blocks as fit on the card at once, at most A.
cudaError_t prepare(const void* fn, size_t smem, int A, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;             // the launch reports the shortfall
  const long long g = (long long)sms * per_sm;
  *grid = (int)(g < A ? g : A);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launch (0: launched).

int dp_fused_fwd(const void* s, const void* env, const void* coeffs,
                 const void* counts, void* out, int A, int N, int K, int M,
                 float lower, float upper, void* stream) {
  if (K < 1 || M < 1 || M > 32 * kMaxCols || N < 0 || A < 0)
    return (int)cudaErrorInvalidValue;
  if (A == 0) return (int)cudaSuccess;
  const FwdFn fn = pick_fwd((M + 31) / 32);
  const size_t smem = sizeof(float) * ((size_t)K * M + (size_t)kWarps * 4 * M);
  int grid = 0;
  cudaError_t err = prepare((const void*)fn, smem, A, &grid);
  if (err != cudaSuccess) return (int)err;
  fn<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)s, (const float*)env, (const float*)coeffs,
      (const int*)counts, (float*)out, A, N, K, M, lower, upper);
  return (int)cudaGetLastError();
}

int dp_fused_bwd(const void* s, const void* env, const void* coeffs,
                 const void* counts, const void* dt, void* ds, void* denv,
                 int A, int N, int K, int M, float lower, float upper,
                 void* stream) {
  if (K < 1 || M < 1 || M > 32 * kMaxCols || N < 0 || A < 0)
    return (int)cudaErrorInvalidValue;
  if (A == 0) return (int)cudaSuccess;
  const BwdFn fn = pick_bwd((M + 31) / 32);
  const size_t smem = sizeof(float) * ((size_t)K * M + (size_t)4 * M);
  int grid = 0;
  cudaError_t err = prepare((const void*)fn, smem, A, &grid);
  if (err != cudaSuccess) return (int)err;
  fn<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)s, (const float*)env, (const float*)coeffs,
      (const int*)counts, (const float*)dt, (float*)ds, (float*)denv, A, N, K,
      M, lower, upper);
  return (int)cudaGetLastError();
}

const char* dp_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
