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
// The TPU kernel builds G tile by tile and contracts it at once, which costs
// 2KM FLOP per slot. G is linear in C, so the kernels here factor it out:
//   fwd: T[a] = S[a] C,     S[a] = sum_n env[n,:]^T B[n,:]        (4 x K)
//   bwd: D[a] = C dT[a]^T                                        (K x 4)
//        denv[n,:] = B[n,:] D,
//        ds[n] = 2/(hi-lo) [|u_raw|<1] env[n,:] . (B'[n,:] D).
// A live slot then costs 11K FLOP forward (recurrence and the 4 x K outer
// product) and about 24K backward, and an atom 8KM more for S C or C dT^T:
// at copper widths (K = 32, M = 128, ~350 live slots of N = 1320) that is
// ~17 FLOP per byte moved forward and ~8 backward, under the H100's FP32
// balance of ~20 (67 TFLOP/s over 3.35 TB/s). Both kernels are bound by
// device memory: the live rows of s and env read once, T or dT, and in the
// backward ds and denv written over every slot of the row (~75% of its
// bytes on the main path).
//
// The design follows from that:
//   * The basis rounds as the plain version's does on the card: u through
//     the reciprocal of hi - lo, the recurrences step by step (next_cheb
//     below), so the kernels differ from it mainly in the order of sums.
//   * One warp owns one atom; blocks of kWarps warps walk a grid-stride
//     loop over atoms. A lane takes one slot per pass of 32: s as a float,
//     the env row as one float4, so a warp's loads are contiguous. Only
//     slots n < count are read (the NaN poison of the tests never enters a
//     sum), and no alignment of N is assumed.
//   * Forward: the rows come through a per-warp ring of kStages passes in
//     shared memory, filled by cp.async (zero-fill past the count), so each
//     warp keeps three passes of loads in flight and the next atom's first
//     passes load while this atom is reduced. Each lane runs the recurrence
//     in registers and adds env[n,c] T_k(u_n) into its own 4 x kChunk sums
//     (128 registers at kChunk = 32: one sweep over the rows for copper's
//     K = 32, one sweep per 32 columns for larger K). At the end of the atom
//     a reduce-scatter (31 shuffles for each c) leaves S[c][k] on lane k,
//     and T = S C is formed with C held in shared memory (one float4 of C
//     a k where M % 4 == 0). Staging each warp's 32 x K basis tile in
//     shared memory instead, with lanes owning columns k, is bound by
//     shared-memory traffic (PERF.md).
//   * Backward: D = C dT^T first, 8 rows of D at a time: lanes own columns
//     m (coalesced reads of C and dT), and a reduce-scatter leaves D[k][c]
//     on lane 4 (k - k0) + c. D sits in shared memory and is read as
//     broadcast float4s. Each lane then runs both recurrences for its slot
//     and accumulates B[n,:] D and B'[n,:] D in 8 registers: no cross-lane
//     work per slot. The next pass's rows are loaded into registers before
//     this pass is summed. ds and denv are written as one float and one
//     float4 per slot, zeros past the count included.
// Scalar FP32 FMAs throughout, no tensor cores: the kernels are bound by
// bytes, so TF32 would only lose precision. The forward still runs about
// 3,400 instructions an atom (6 per basis term and slot, plus the
// reduce-scatter and S C), which keeps it above its byte bound.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;                 // warps per block, one atom each
constexpr int kMaxM = 256;
constexpr unsigned kFull = 0xffffffffu;

// (2 s - lo - hi) / (hi - lo), as PyTorch evaluates it on the card: its
// division of a tensor by a scalar multiplies by the scalar's reciprocal.
__device__ __forceinline__ float u_raw_of(float s, float lower, float upper,
                                          float inv_width) {
  return (2.f * s - lower - upper) * inv_width;
}

// A count outside [0, N] is clamped, so no slot outside the row is touched.
__device__ __forceinline__ int live_count(int c, int N) {
  return c < 0 ? 0 : (c > N ? N : c);
}

constexpr int kChunk = 32;    // columns of S a forward sweep holds in registers
constexpr int kStages = 4;    // passes of rows a forward warp keeps in flight

// Shared memory a forward block holds C in: K x M floats, rounded up to a
// multiple of 16 bytes.
__host__ __device__ __forceinline__ size_t coeff_bytes(int K, int M) {
  return 16 * (((size_t)K * M + 3) / 4);
}

// Shared memory of one forward warp: a ring of kStages passes of env rows
// (32 float4 each) and of s (32 floats each), then S (K float4). A multiple
// of 16 bytes.
__host__ __device__ __forceinline__ size_t fwd_warp_bytes(int K) {
  return (size_t)kStages * 32 * (16 + 4) + 16 * (size_t)K;
}

// Shared memory of one backward warp: D (K float4).
__host__ __device__ __forceinline__ size_t bwd_warp_bytes(int K) {
  return 16 * (size_t)K;
}

// The recurrences T_{k+1} = 2u T_k - T_{k-1} and
// T'_{k+1} = 2 T_k + 2u T'_k - T'_{k-1}, rounded step by step as the plain
// version (ref.cheb_basis_pair) rounds them, with no FMA contraction. Near
// |u| = 1, T'_k grows as k^2 and the recurrence carries each rounding on, so
// a contracted recurrence alone moves ds by more than the summation order.
__device__ __forceinline__ float next_cheb(float u2, float t, float tm1) {
  return __fsub_rn(__fmul_rn(u2, t), tm1);
}

__device__ __forceinline__ float next_cheb_deriv(float u2, float t, float d,
                                                 float dm1) {
  return __fsub_rn(__fadd_rn(2.f * t, __fmul_rn(u2, d)), dm1);
}

__device__ __forceinline__ void fma4(float4& acc, const float4& x, float w) {
  acc.x = fmaf(x.x, w, acc.x);
  acc.y = fmaf(x.y, w, acc.y);
  acc.z = fmaf(x.z, w, acc.z);
  acc.w = fmaf(x.w, w, acc.w);
}

// One halving step of a reduce-scatter over the warp: lanes with bit H set
// keep the upper half of v, the others the lower half, and each adds the
// half its partner (lane ^ H) kept.
template <int H>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool hi = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = hi ? v[i] : v[i + H];
    const float keep = hi ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, H);
  }
}

// Returns, on lane l, the sum of v[l] over the warp (31 shuffles).
__device__ __forceinline__ float reduce_scatter(float (&v)[32], int lane) {
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0];
}

// Asynchronous copies (cp.async) of one 4- or 16-byte element from device
// to shared memory. With `live` false nothing is read and the destination
// is zero-filled: slots past the count never reach the sums.
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool live) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy16(float4* dst, const float4* src,
                                       bool live) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// A warp's ring of passes: pass p of an atom lands in slot p % kStages.
// Each lane copies and later reads only its own element of a slot, so the
// ring needs no synchronisation between lanes.
struct RowRing {
  float4* e;                              // (kStages, 32) env rows
  float* s;                               // (kStages, 32) s

  __device__ __forceinline__ void fetch(const float* s_a, const float4* e_a,
                                        int cnt, int p, int lane) const {
    const int slot = (p % kStages) * 32 + lane;
    const int n = p * 32 + lane;
    const bool live = n < cnt;
    copy4(s + slot, s_a + (live ? n : 0), live);
    copy16(e + slot, e_a + (live ? n : 0), live);
  }

  // The first kStages - 1 passes of a sweep, one commit group each (empty
  // past the last pass, so every sweep counts groups the same way).
  __device__ __forceinline__ void prologue(const float* s_a, const float4* e_a,
                                           int cnt, int lane) const {
#pragma unroll
    for (int p = 0; p < kStages - 1; ++p) {
      if (p * 32 < cnt) fetch(s_a, e_a, cnt, p, lane);
      copy_commit();
    }
  }
};

// acc[c][j] += env[c] T_{k0 + j}(u) for the kChunk columns of a sweep (the
// first `cols` of them in the last, partial sweep), from T_{k0} = t and
// T_{k0 - 1} = tm1.
template <bool kPartial>
__device__ __forceinline__ void add_slot(float (&acc)[4][kChunk], float4 ev,
                                         float u2, float t, float tm1,
                                         int cols) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (!kPartial || j < cols) {
      acc[0][j] = fmaf(ev.x, t, acc[0][j]);
      acc[1][j] = fmaf(ev.y, t, acc[1][j]);
      acc[2][j] = fmaf(ev.z, t, acc[2][j]);
      acc[3][j] = fmaf(ev.w, t, acc[3][j]);
    }
    const float next = next_cheb(u2, t, tm1);
    tm1 = t;
    t = next;
  }
}

// Registers bounded to 170 (3 blocks an SM): the 4 x kChunk sums stay in
// registers, and the ring keeps each warp's loads in flight.
__global__ void __launch_bounds__(32 * kWarps, 3)
fwd_kernel(const float* __restrict__ s, const float4* __restrict__ env,
           const float* __restrict__ coeffs, const int* __restrict__ counts,
           float* __restrict__ out, int A, int N, int K, int M, float lower,
           float upper) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* c_sh = reinterpret_cast<float*>(smem);                  // (K, M)
  for (int i = threadIdx.x; i < K * M; i += blockDim.x) c_sh[i] = coeffs[i];
  __syncthreads();
  float4* base = smem + coeff_bytes(K, M) / 16 +
                 (size_t)warp * (fwd_warp_bytes(K) / 16);
  const RowRing ring{base, reinterpret_cast<float*>(base + kStages * 32)};
  float4* s_sh = base + kStages * 32 + kStages * 8;              // S[k], (K,)
  const float inv_width = 1.f / (upper - lower);
  const long long step = (long long)gridDim.x * warps;
  long long a = (long long)blockIdx.x * warps + warp;
  if (a >= A) return;
  int cnt = live_count(counts[a], N);
  ring.prologue(s + a * N, env + a * N, cnt, lane);

  while (a < A) {
    const long long a_next = a + step;
    const int cnt_next = a_next < A ? live_count(counts[a_next], N) : 0;
    const float* s_a = s + a * N;
    const float4* e_a = env + a * N;
    const int passes = (cnt + 31) / 32;
    // S[:, k0 : k0 + kChunk] per sweep over the atom's rows; copper's K = 32
    // takes one sweep
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      if (k0 > 0) ring.prologue(s_a, e_a, cnt, lane);
      float acc[4][kChunk];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int j = 0; j < kChunk; ++j) acc[c][j] = 0.f;
      for (int p = 0; p < passes; ++p) {
        if (p + kStages - 1 < passes)
          ring.fetch(s_a, e_a, cnt, p + kStages - 1, lane);
        copy_commit();
        copy_wait<kStages - 1>();         // this lane's pass p has landed
        const int slot = (p % kStages) * 32 + lane;
        const float sv = ring.s[slot];
        const float4 ev = ring.e[slot];   // zero past the count
        const float u =
            fminf(fmaxf(u_raw_of(sv, lower, upper, inv_width), -1.f), 1.f);
        const float u2 = 2.f * u;
        float t = 1.f;    // T_0
        float tm1 = u;    // T_{-1} := T_1, so the recurrence yields T_1 = u
        for (int k = 0; k < k0; ++k) {
          const float next = next_cheb(u2, t, tm1);
          tm1 = t;
          t = next;
        }
        if (K - k0 >= kChunk)
          add_slot<false>(acc, ev, u2, t, tm1, kChunk);
        else
          add_slot<true>(acc, ev, u2, t, tm1, K - k0);
      }
      // after the last sweep, the next atom's rows load during the sums
      if (k0 + kChunk >= K && a_next < A)
        ring.prologue(s + a_next * N, env + a_next * N, cnt_next, lane);
      float4 sk;
      sk.x = reduce_scatter(acc[0], lane);  // S[c][k0 + lane]
      sk.y = reduce_scatter(acc[1], lane);
      sk.z = reduce_scatter(acc[2], lane);
      sk.w = reduce_scatter(acc[3], lane);
      if (k0 + lane < K) s_sh[k0 + lane] = sk;
    }
    __syncwarp();

    // T[a] = S C
    float* out_a = out + a * 4 * M;
    if ((M & 3) == 0) {
      // lane owns 4 neighbouring columns: one float4 of C per k
      for (int m = 4 * lane; m < M; m += 128) {
        float4 acc[4] = {};
#pragma unroll 8
        for (int k = 0; k < K; ++k) {
          const float4 sk = s_sh[k];
          const float4 c = *reinterpret_cast<const float4*>(c_sh + k * M + m);
          fma4(acc[0], c, sk.x);
          fma4(acc[1], c, sk.y);
          fma4(acc[2], c, sk.z);
          fma4(acc[3], c, sk.w);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
          *reinterpret_cast<float4*>(out_a + c * M + m) = acc[c];
      }
    } else {
      for (int m = lane; m < M; m += 32) {
        float acc[4] = {};
#pragma unroll 8
        for (int k = 0; k < K; ++k) {
          const float4 sk = s_sh[k];
          const float c = c_sh[k * M + m];
          acc[0] = fmaf(sk.x, c, acc[0]);
          acc[1] = fmaf(sk.y, c, acc[1]);
          acc[2] = fmaf(sk.z, c, acc[2]);
          acc[3] = fmaf(sk.w, c, acc[3]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) out_a[c * M + m] = acc[c];
      }
    }
    __syncwarp();                         // S is rewritten for the next atom
    a = a_next;
    cnt = cnt_next;
  }
}

__global__ void __launch_bounds__(32 * kWarps)
bwd_kernel(const float* __restrict__ s, const float4* __restrict__ env,
           const float* __restrict__ coeffs, const int* __restrict__ counts,
           const float* __restrict__ dt, float* __restrict__ ds,
           float4* __restrict__ denv, int A, int N, int K, int M, float lower,
           float upper) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float4* d_sh = smem + (size_t)warp * K;               // D[k], (K,)
  float* d_flat = reinterpret_cast<float*>(d_sh);
  const float inv_width = 1.f / (upper - lower);
  const float du_ds = 2.f / (upper - lower);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (long long a = (long long)blockIdx.x * warps + warp; a < A;
       a += (long long)gridDim.x * warps) {
    // D = C dT[a]^T, rows k0 .. k0+7 at a time
    const float* dt_a = dt + a * 4 * M;
    for (int k0 = 0; k0 < K; k0 += 8) {
      float v[32];                        // v[4 r + c]: partial D[k0 + r][c]
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] = 0.f;
      for (int m = lane; m < M; m += 32) {
        const float d0 = dt_a[m], d1 = dt_a[M + m], d2 = dt_a[2 * M + m],
                    d3 = dt_a[3 * M + m];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int k = k0 + r;
          const float c = k < K ? __ldg(coeffs + (size_t)k * M + m) : 0.f;
          v[4 * r + 0] = fmaf(c, d0, v[4 * r + 0]);
          v[4 * r + 1] = fmaf(c, d1, v[4 * r + 1]);
          v[4 * r + 2] = fmaf(c, d2, v[4 * r + 2]);
          v[4 * r + 3] = fmaf(c, d3, v[4 * r + 3]);
        }
      }
      const float dkc = reduce_scatter(v, lane);
      if (k0 + (lane >> 2) < K) d_flat[4 * k0 + lane] = dkc;
    }
    __syncwarp();

    const int cnt = live_count(counts[a], N);
    const float* s_a = s + a * N;
    const float4* e_a = env + a * N;
    float* ds_a = ds + a * N;
    float4* denv_a = denv + a * N;
    float sv = 0.f;
    float4 ev = zero4;
    if (lane < cnt) {
      sv = s_a[lane];
      ev = e_a[lane];
    }
    for (int base = 0; base < cnt; base += 32) {
      const int nn = base + 32 + lane;    // the next pass, loaded early
      float sn = 0.f;
      float4 en = zero4;
      if (nn < cnt) {
        sn = s_a[nn];
        en = e_a[nn];
      }
      const float ur = u_raw_of(sv, lower, upper, inv_width);
      const float u = fminf(fmaxf(ur, -1.f), 1.f);
      const float u2 = 2.f * u;
      float t = 1.f, tm1 = u;             // T_0, T_{-1} := T_1
      float d = 0.f, dm1 = 1.f;           // T'_0, T'_{-1} := T'_1
      float4 de = zero4;                  // B[n,:] D
      float4 dd = zero4;                  // B'[n,:] D
      for (int k = 0; k < K; ++k) {
        const float4 dk = d_sh[k];
        fma4(de, dk, t);
        fma4(dd, dk, d);
        const float next_d = next_cheb_deriv(u2, t, d, dm1);
        const float next_t = next_cheb(u2, t, tm1);
        dm1 = d;
        d = next_d;
        tm1 = t;
        t = next_t;
      }
      const int n = base + lane;
      if (n < N) {
        const bool live = n < cnt;
        const float w = ev.x * dd.x + ev.y * dd.y + ev.z * dd.z + ev.w * dd.w;
        ds_a[n] = live && fabsf(ur) < 1.f ? w * du_ds : 0.f;
        denv_a[n] = live ? de : zero4;
      }
      sv = sn;
      ev = en;
    }
    // slots past the passes get zero gradients
    for (int n = ((cnt + 31) & ~31) + lane; n < N; n += 32) {
      ds_a[n] = 0.f;
      denv_a[n] = zero4;
    }
    __syncwarp();                         // D is rewritten for the next atom
  }
}

struct Launch {
  int warps;
  size_t smem;
  int grid;
};

// Shared memory and a grid for `fn`: `fixed` bytes a block and up to kWarps
// warps a block, as many as fit in the card's opt-in shared memory at
// `per_warp` bytes each, and as many blocks as fit on the card at once, at
// most one warp per atom.
cudaError_t prepare(const void* fn, size_t fixed, size_t per_warp, int A,
                    Launch* l) {
  int dev = 0, sms = 0, max_smem = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (fixed + per_warp > (size_t)max_smem) return cudaErrorInvalidValue;
  int warps = kWarps;
  while (warps > 1 && fixed + warps * per_warp > (size_t)max_smem) --warps;
  const size_t smem = fixed + warps * per_warp;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, 32 * warps,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;             // the launch reports the shortfall
  const long long resident = (long long)sms * per_sm;
  const long long need = ((long long)A + warps - 1) / warps;
  l->warps = warps;
  l->smem = smem;
  l->grid = (int)(need < resident ? need : resident);
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launch (0: launched).

int dp_fused_fwd(const void* s, const void* env, const void* coeffs,
                 const void* counts, void* out, int A, int N, int K, int M,
                 float lower, float upper, void* stream) {
  if (K < 1 || M < 1 || M > kMaxM || N < 0 || A < 0 || !aligned16(env))
    return (int)cudaErrorInvalidValue;
  if (A == 0) return (int)cudaSuccess;
  Launch l;
  cudaError_t err = prepare((const void*)fwd_kernel, coeff_bytes(K, M),
                            fwd_warp_bytes(K), A, &l);
  if (err != cudaSuccess) return (int)err;
  fwd_kernel<<<l.grid, 32 * l.warps, l.smem, (cudaStream_t)stream>>>(
      (const float*)s, (const float4*)env, (const float*)coeffs,
      (const int*)counts, (float*)out, A, N, K, M, lower, upper);
  return (int)cudaGetLastError();
}

int dp_fused_bwd(const void* s, const void* env, const void* coeffs,
                 const void* counts, const void* dt, void* ds, void* denv,
                 int A, int N, int K, int M, float lower, float upper,
                 void* stream) {
  if (K < 1 || M < 1 || M > kMaxM || N < 0 || A < 0 || !aligned16(env) ||
      !aligned16(denv))
    return (int)cudaErrorInvalidValue;
  if (A == 0) return (int)cudaSuccess;
  Launch l;
  cudaError_t err =
      prepare((const void*)bwd_kernel, 0, bwd_warp_bytes(K), A, &l);
  if (err != cudaSuccess) return (int)err;
  bwd_kernel<<<l.grid, 32 * l.warps, l.smem, (cudaStream_t)stream>>>(
      (const float*)s, (const float4*)env, (const float*)coeffs,
      (const int*)counts, (const float*)dt, (float*)ds, (float4*)denv, A, N,
      K, M, lower, upper);
  return (int)cudaGetLastError();
}

const char* dp_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
