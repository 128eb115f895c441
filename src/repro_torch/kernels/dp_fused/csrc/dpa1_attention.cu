// DPA-1's gated attention core, one layer, forward and backward, for Hopper
// (sm_90a). Plain C entry points, built by build.py into the same library as
// dp_fused.cu and prod_force_virial.cu and loaded with ctypes.
//
// Replaces no Pallas kernel: DPA-1 (DeePMD-kit's se_atten_v2) has no
// counterpart in the JAX package. Added because the attention's plain torch
// composition (core/dpa1.attention_layer before these kernels) wrote the
// per-layer (A, S, S) logits, shifted logits, softmax and weights to device
// memory, saved three of them for the backward, and went back through each.
// For atom a, its S slots (queries j, keys k) and features f < D:
//
//   L_jk = (q_j . k_k + shift) ww_jk + pad_k
//   P_jk = softmax_k(L_jk)    over the live keys only
//   O_j  = sum_k P_jk gate_jk v_k
//
// A slot is live where pad > masked (the model adds MASKED - SHIFT, -10020,
// on padded slots and -SHIFT on live ones). A padded key takes no weight: its
// exp(L - max) is exactly 0 in float32 anyway. A padded query row gives zeros
// (O, dq, dww, dgate): in the model its ww and gate rows are 0 and its
// output's gradient is 0, so nothing downstream reads it.
//
// Backward (dO given; the statistics lse_j = max + log(sum) saved by the
// forward, so P is recomputed and never stored):
//   dW_jk = dO_j . v_k           D_j = sum_k P_jk gate_jk dW_jk = dO_j . O_j
//   dL_jk = P_jk (gate_jk dW_jk - D_j)     (the weights are softmax o gate)
//   dww_jk = dL_jk (q_j . k_k + shift)     dgate_jk = dW_jk P_jk
//   dq_j = sum_k dL_jk ww_jk k_k    dk_k = sum_j dL_jk ww_jk q_j
//   dv_k = sum_j P_jk gate_jk dO_j
// dww and dgate are the only S x S writes; the forward and the backward each
// read ww and gate once, on live pairs.
//
// What bounds it: FP32 FFMA and device memory. A live pair costs 2D
// multiply-adds for each of the forward's two products (q.k, P v) and the
// backward's five (q.k, dO.v, dq, dk, dv): at D = 128 and ~84 live slots of
// 120 (dpa1.h2o.1card) that is 87 GFLOP forward and 219 GFLOP backward a
// layer at 24,000 atoms, 1.3 and 3.3 ms at 67 TFLOP/s. Bytes: q, k, v, dO,
// O read on live slots, ww and gate on live pairs, O, dq, dk, dv, dww and
// dgate written whole: 1.8 and 4.1 ms at 3.35 TB/s (attention.kernel_cost).
// FP32 only: the configuration states float32 with TF32 off, and a TF32
// product fails every limit of the benchmark's check. expf and logf, not
// the fast intrinsics.
//
// The design follows from that:
//   * One block an atom walks its slots in passes of 16 rows a warp (the
//     forward 4 warps, 64 rows; the backward 8 warps, 128 rows, so one pass
//     at S <= 128), stages the pass's q (and dO) once in shared memory and
//     walks the keys in tiles of 32; every product's operands come from
//     shared memory, and each staging issues all its loads before its first
//     store, so a tile waits for device memory once.
//   * A lane holds a 4 x 4 block of an S x S tile (rows 4 rg.., keys
//     cg + 8 j, lane = 8 rg + cg) and 4 rows x D/8 features of a D-wide
//     output; a step of a product is 16-byte shared loads that a quarter warp
//     either shares (broadcast) or spreads over the 32 banks.
//   * An online softmax (a running max and sum a row) over the key tiles, so
//     any S works and the forward writes only O and lse.
//   * The backward needs no atomics and recomputes no product (5 a pair):
//     the block owns every row of its atom, so for each key tile it finishes
//     the tile's dk and dv (sums over the pass's rows by all 8 warps, added
//     to an earlier pass's by the same thread) and adds the tile's share of
//     dq; D_j comes from O and dO in the same block.
//   * Tiles are skipped by the mask the block reads, never by an assumed
//     layout: a key tile with no live key is not computed (its outputs are
//     written as zeros), a warp whose 16 rows are all padded computes no
//     S x S product, and the sums over rows stop after the last live warp.
//     The model's compacted section packs each row's live slots first, so an
//     atom with n live slots computes about (16 ceil(n/16)) x (32 ceil(n/32))
//     of its S^2 pairs.
//   * Launched on the caller's stream; no sync and no allocation (the wrapper
//     allocates the outputs), so a CUDA graph can record it.
//
// On one H100 at dpa1.h2o.1card's shape (24,000 x 120, 70% live): forward
// 6.20 ms, backward 13.36 ms a layer (PERF.md). What holds them there: the
// backward runs one block an SM (253 registers a thread, 186 KB of shared
// memory), so its memory phases (staging, the gates, the stores) and its
// products take turns, and a lane's 4 x 4 block asks one shared-memory
// float for every two FFMAs, half the rate at which the SM's FP32 units
// would keep busy.

#include <cuda_runtime.h>

#include <cmath>

namespace {

// Warps a block: a pass holds 16 rows a warp. The forward takes 4 (64 rows,
// 3 blocks an SM); the backward 8 (128 rows: one pass at S <= 128, where
// 4 warps and two passes an atom, two blocks an SM, ran 19% slower).
constexpr int kFwdWarps = 4;
constexpr int kBwdWarps = 8;
constexpr int kTile = 32;            // keys a tile
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// acc[i][j] += sum_t a[i * lda + t] b[8 j * ldb + t] over t < N: both
// operands' rows in shared memory with the summed index innermost; a at the
// lane's first row, b at its first key (16-byte aligned, N % 4 == 0).
template <int N>
__device__ __forceinline__ void mma_rows(const float* __restrict__ a, int lda,
                                         const float* __restrict__ b, int ldb,
                                         float (&acc)[4][4]) {
#pragma unroll 2
  for (int t = 0; t < N; t += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(a + i * lda + t);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(b + 8 * j * ldb + t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// acc[c][i][j] += sum_t a[t * lda + i] b[t * ldb + 32 c + j] over t < N:
// the summed index outermost in both; a at the lane's first row, b at its
// first feature.
template <int NC, int N>
__device__ __forceinline__ void mma_cols(const float* __restrict__ a, int lda,
                                         const float* __restrict__ b, int ldb,
                                         float (&acc)[NC][4][4]) {
#pragma unroll 4
  for (int t = 0; t < N; ++t) {
    const float4 x4 = *reinterpret_cast<const float4*>(a + t * lda);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 y4 = *reinterpret_cast<const float4*>(b + t * ldb + 32 * c);
      const float y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[c][i][j] = fmaf(x[i], y[j], acc[c][i][j]);
    }
  }
}

// acc[c][i][j] += sum_t a[i * lda + t] b[t * ldb + 32 c + j] over t < n
// (n % 4 == 0): a's rows with the summed index innermost, b's with it
// outermost.
template <int NC>
__device__ __forceinline__ void mma_keys(const float* __restrict__ a, int lda,
                                         const float* __restrict__ b, int ldb,
                                         int n, float (&acc)[NC][4][4]) {
#pragma unroll 2
  for (int t = 0; t < n; t += 4) {
    float x[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(a + i * lda + t);
      x[i][0] = v.x, x[i][1] = v.y, x[i][2] = v.z, x[i][3] = v.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(b + (t + u) * ldb + 32 * c);
        const float y[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[c][i][j] = fmaf(x[i][u], y[j], acc[c][i][j]);
      }
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[NC][4][4]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[c][i][j] = 0.f;
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// dst[r * (D + 4) + f] = src[r * D + f] for r < R; rows at or past `valid`
// read as 0. Every load is issued before the first store, so the block
// waits for device memory once a tile.
template <int R, int D, int T>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int valid) {
  constexpr int q4 = D / 4, n = R * q4 / T;
  static_assert(R * q4 % T == 0, "a tile is whole float4s a thread");
  float4 x[n];
#pragma unroll
  for (int u = 0; u < n; ++u) {
    const int idx = threadIdx.x + u * T, r = idx / q4, c = idx % q4;
    x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) x[u] = __ldg(reinterpret_cast<const float4*>(src + (size_t)r * D) + c);
  }
#pragma unroll
  for (int u = 0; u < n; ++u) {
    const int idx = threadIdx.x + u * T, r = idx / q4, c = idx % q4;
    *reinterpret_cast<float4*>(dst + r * (D + 4) + 4 * c) = x[u];
  }
}

// Max or sum over the 8 lanes of one row group (lanes 8 rg .. 8 rg + 7).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x = fmaxf(x, __shfl_xor_sync(kAll, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}

// Does any of the slots [s0, s0 + kTile) of this atom live? Block-wide.
__device__ __forceinline__ bool tile_live(const float* __restrict__ prow,
                                          int s0, int S, float masked) {
  const int s = s0 + threadIdx.x;
  return __syncthreads_or(threadIdx.x < kTile && s < S && __ldg(prow + s) > masked);
}

// The rows of one pass [row0, row0 + kRows) that live, the lane's 4, and the
// number of rows up to the last warp with a live row (a multiple of 16).
struct Rows {
  bool ok[4];
  bool warp_live;
  int live_end;
};

template <int W>
__device__ __forceinline__ Rows pass_rows(const float* __restrict__ prow,
                                          int row0, int rw, int S,
                                          float masked, int* flags) {
  Rows rows;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + rw + i;
    rows.ok[i] = r < S && __ldg(prow + r) > masked;
  }
  rows.warp_live = __any_sync(
      kAll, rows.ok[0] || rows.ok[1] || rows.ok[2] || rows.ok[3]);
  if ((threadIdx.x & 31) == 0) flags[threadIdx.x >> 5] = rows.warp_live;
  __syncthreads();
  rows.live_end = 0;
#pragma unroll
  for (int w = 0; w < W; ++w)
    if (flags[w]) rows.live_end = 16 * (w + 1);
  return rows;
}

// Writes the lane's part of a D-wide output (rows r .. r + 3 of the atom,
// features 32 c + 4 cg ..), zeros where `keep` is false.
template <int NC>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, int r,
                                           int S, int D, int cg,
                                           const bool (&keep)[4],
                                           const float (&acc)[NC][4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (r + i >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
      if (keep[i])
        y = make_float4(acc[c][i][0], acc[c][i][1], acc[c][i][2], acc[c][i][3]);
      *reinterpret_cast<float4*>(dst + (size_t)(r + i) * D + 32 * c + 4 * cg) = y;
    }
  }
}

// ------------------------------------------------------------------ forward

template <int D>
constexpr int fwd_smem() {
  constexpr int rows = 16 * kFwdWarps, ldw = rows + 4;
  return 4 * (rows * (D + 4) + kTile * imax(D + 4, ldw) + kTile * (D + 4) +
              kFwdWarps);
}

template <int D>
__global__ void __launch_bounds__(32 * kFwdWarps, 3)
    attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ ww,
                    const float* __restrict__ gate,
                    const float* __restrict__ pad, float* __restrict__ out,
                    float* __restrict__ lse, int S, float shift, float masked) {
  constexpr int NC = D / 32, LD = D + 4;
  constexpr int kThreads = 32 * kFwdWarps, kRows = 16 * kFwdWarps;
  constexpr int kLdW = kRows + 4;  // leading dim of [key][row] tiles
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][LD]
  float* kw = qs + kRows * LD;  // [kTile][LD] keys, then W^T [kTile][kLdW]
  float* vs = kw + kTile * imax(LD, kLdW);      // [kTile][LD]
  int* flags = reinterpret_cast<int*>(vs + kTile * LD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cg = lane & 7, rw = 16 * warp + 4 * (lane >> 3);
  const size_t base = (size_t)blockIdx.x * S;
  const float* prow = pad + base;
  const float* qa = q + base * D;
  const float* ka = k + base * D;
  const float* va = v + base * D;
  const float* wwa = ww + base * S;
  const float* ga = gate + base * S;

  for (int row0 = 0; row0 < S; row0 += kRows) {
    __syncthreads();  // the previous pass's readers are done
    const Rows rows = pass_rows<kFwdWarps>(prow, row0, rw, S, masked, flags);
    float m[4], l[4], o[NC][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
    zero(o);
    if (rows.live_end > 0)
      stage<kRows, D, kThreads>(qs, qa + (size_t)row0 * D, min(S - row0, rows.live_end));
    for (int k0 = 0; rows.live_end > 0 && k0 < S; k0 += kTile) {
      if (!tile_live(prow, k0, S, masked)) continue;
      stage<kTile, D, kThreads>(kw, ka + (size_t)k0 * D, S - k0);
      stage<kTile, D, kThreads>(vs, va + (size_t)k0 * D, S - k0);
      __syncthreads();
      float s[4][4];
      zero(s);
      if (rows.warp_live) mma_rows<D>(qs + rw * LD, LD, kw + cg * LD, LD, s);
      __syncthreads();  // kw is rewritten as W^T below
      if (rows.warp_live) {
        bool key_ok[4];
        float pk[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + cg + 8 * j;
          pk[j] = key < S ? __ldg(prow + key) : 0.f;
          key_ok[j] = key < S && pk[j] > masked;
        }
        // the lane's live logits, then its gates: each time 16 loads in
        // flight at once, into as few registers as 3 blocks an SM allow
        float w[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const size_t at = (size_t)(row0 + rw + i) * S + k0 + cg + 8 * j;
            w[i][j] = rows.ok[i] && key_ok[j] ? __ldg(wwa + at) : 0.f;
          }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[i][j] = rows.ok[i] && key_ok[j]
                          ? (s[i][j] + shift) * w[i][j] + pk[j] : -INFINITY;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const size_t at = (size_t)(row0 + rw + i) * S + k0 + cg + 8 * j;
            w[i][j] = rows.ok[i] && key_ok[j] ? __ldg(ga + at) : 0.f;
          }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float tmax = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j) tmax = fmaxf(tmax, s[i][j]);
          tmax = group_max(tmax);
          // every live row sees the tile's live keys: tmax is finite there
          const float mnew = rows.ok[i] ? fmaxf(m[i], tmax) : m[i];
          const float alpha = rows.ok[i] ? expf(m[i] - mnew) : 1.f;
          float psum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float p = 0.f;
            if (rows.ok[i] && key_ok[j]) p = expf(s[i][j] - mnew);
            w[i][j] *= p;
            psum += p;
          }
          l[i] = l[i] * alpha + group_sum(psum);
          m[i] = mnew;
#pragma unroll
          for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int j = 0; j < 4; ++j) o[c][i][j] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(kw + (cg + 8 * j) * kLdW + rw) =
              make_float4(w[0][j], w[1][j], w[2][j], w[3][j]);
      }
      __syncthreads();
      if (rows.warp_live) mma_cols<NC, kTile>(kw + rw, kLdW, vs + 4 * cg, LD, o);
    }
    // O = o / l (divided, as the plain version does); lse = m + log(l)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + rw + i;
      if (r >= S) continue;
      if (cg == 0) lse[base + r] = rows.ok[i] ? m[i] + logf(l[i]) : 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
        if (rows.ok[i])
          y = make_float4(o[c][i][0] / l[i], o[c][i][1] / l[i],
                          o[c][i][2] / l[i], o[c][i][3] / l[i]);
        *reinterpret_cast<float4*>(out + (base + r) * D + 32 * c + 4 * cg) = y;
      }
    }
  }
}

// ----------------------------------------------------------------- backward

template <int D>
constexpr int bwd_smem() {
  constexpr int rows = 16 * kBwdWarps, ldw = rows + 4;
  return 4 * (2 * rows * (D + 4) + kTile * (D + 4) + kTile * imax(D + 4, ldw) +
              kTile * ldw + rows + kBwdWarps);
}

template <int D>
__global__ void __launch_bounds__(32 * kBwdWarps, 1)
    attn_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ ww,
                    const float* __restrict__ gate,
                    const float* __restrict__ pad,
                    const float* __restrict__ out,
                    const float* __restrict__ lse,
                    const float* __restrict__ dout, float* __restrict__ dq,
                    float* __restrict__ dk, float* __restrict__ dv,
                    float* __restrict__ dww, float* __restrict__ dgate, int S,
                    float shift, float masked) {
  constexpr int NC = D / 32, LD = D + 4;
  constexpr int kWarps = kBwdWarps, kThreads = 32 * kWarps, kRows = 16 * kWarps;
  constexpr int kLdW = kRows + 4;  // leading dim of [key][row] tiles
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][LD]
  float* dos = qs + kRows * LD;                 // [kRows][LD]
  float* ks = dos + kRows * LD;                 // [kTile][LD]
  float* vw = ks + kTile * LD;  // [kTile][LD] values, then W^T [kTile][kLdW]
  float* dst = vw + kTile * imax(LD, kLdW);     // (dL ww)^T [kTile][kLdW]
  float* drow = dst + kTile * kLdW;             // [kRows]
  int* flags = reinterpret_cast<int*>(drow + kRows);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cg = lane & 7, rw = 16 * warp + 4 * (lane >> 3);
  // dk and dv of a key tile, KW warps each, side by side or (D = 128) one
  // after the other: warp (fb, kh) of a group its keys 16 kh + 4 kq .. and
  // features 32 NF fb + 4 fg + 32 u (u < NF)
  constexpr int NF = D >= 64 ? 2 : 1, KW = D / (16 * NF);
  static_assert(kWarps % KW == 0, "whole groups of warps a product");
  const int kw_ = warp % KW, fb = kw_ % (D / (32 * NF)), kh = kw_ / (D / (32 * NF));
  const int kq = lane >> 3, fg = lane & 7;
  const size_t base = (size_t)blockIdx.x * S;
  const float* prow = pad + base;
  const float* qa = q + base * D;
  const float* ka = k + base * D;
  const float* va = v + base * D;
  const float* doa = dout + base * D;
  const float* wwa = ww + base * S;
  const float* ga = gate + base * S;

  for (int row0 = 0; row0 < S; row0 += kRows) {
    __syncthreads();  // the previous pass's readers are done
    const Rows rows = pass_rows<kWarps>(prow, row0, rw, S, masked, flags);
    const int valid = min(S - row0, rows.live_end);
    if (rows.live_end > 0) {
      stage<kRows, D, kThreads>(qs, qa + (size_t)row0 * D, valid);
      stage<kRows, D, kThreads>(dos, doa + (size_t)row0 * D, valid);
    }
    {
      // D_j = dO_j . O_j: two threads a row, half the features each
      constexpr int h4 = D / 8;
      const int r = threadIdx.x >> 1, f0 = (threadIdx.x & 1) * (D / 2);
      const float* o_r = out + (base + row0 + r) * D + f0;
      const float* d_r = doa + (size_t)(row0 + r) * D + f0;
      float4 a[h4], b[h4];
#pragma unroll
      for (int u = 0; u < h4; ++u) {
        a[u] = b[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < valid) {
          a[u] = __ldg(reinterpret_cast<const float4*>(o_r) + u);
          b[u] = __ldg(reinterpret_cast<const float4*>(d_r) + u);
        }
      }
      float acc = 0.f;
#pragma unroll
      for (int u = 0; u < h4; ++u)
        acc = fmaf(a[u].x, b[u].x, fmaf(a[u].y, b[u].y,
                   fmaf(a[u].z, b[u].z, fmaf(a[u].w, b[u].w, acc))));
      acc += __shfl_xor_sync(kAll, acc, 1);
      if ((threadIdx.x & 1) == 0) drow[r] = acc;
    }
    __syncthreads();
    float dj[4], lj[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dj[i] = drow[rw + i];
      lj[i] = rows.ok[i] ? __ldg(lse + base + row0 + rw + i) : 0.f;
    }

    float g[NC][4][4];
    zero(g);
    for (int k0 = 0; k0 < S; k0 += kTile) {
      const bool live = rows.live_end > 0 && tile_live(prow, k0, S, masked);
      float s[4][4], dw[4][4];
      zero(s);
      zero(dw);
      if (live) {
        stage<kTile, D, kThreads>(ks, ka + (size_t)k0 * D, S - k0);
        stage<kTile, D, kThreads>(vw, va + (size_t)k0 * D, S - k0);
        __syncthreads();
        if (rows.warp_live) {
          mma_rows<D>(qs + rw * LD, LD, ks + cg * LD, LD, s);
          mma_rows<D>(dos + rw * LD, LD, vw + cg * LD, LD, dw);
        }
        __syncthreads();  // vw is rewritten as W^T below
      }
      // dww and dgate of the lane's 4 x 4 pairs (zeros where not both live);
      // W = P gate and dL ww, transposed, for the products
      bool key_ok[4];
      float pk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + cg + 8 * j;
        pk[j] = key < S ? __ldg(prow + key) : 0.f;
        key_ok[j] = live && key < S && pk[j] > masked;
      }
      // the gates of the lane's live pairs, all loads in flight at once
      float wt[4][4], dt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const size_t at = (size_t)(row0 + rw + i) * S + k0 + cg + 8 * j;
          const bool ok = rows.ok[i] && key_ok[j];
          wt[i][j] = ok ? __ldg(wwa + at) : 0.f;
          dt[i][j] = ok ? __ldg(ga + at) : 0.f;
        }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + rw + i;
        const size_t rs = (size_t)r * S;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + cg + 8 * j;
          float a = 0.f, b = 0.f;
          const float w = wt[i][j], gk = dt[i][j];
          wt[i][j] = 0.f;
          dt[i][j] = 0.f;
          if (rows.ok[i] && key_ok[j]) {
            const float sh = s[i][j] + shift;
            const float p = expf(sh * w + pk[j] - lj[i]);
            const float dl = p * (gk * dw[i][j] - dj[i]);
            a = dl * sh;
            b = dw[i][j] * p;
            wt[i][j] = p * gk;
            dt[i][j] = dl * w;
          }
          if (r < S && key < S) {
            dww[base * S + rs + key] = a;
            dgate[base * S + rs + key] = b;
          }
        }
      }
      if (live) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          *reinterpret_cast<float4*>(vw + (cg + 8 * j) * kLdW + rw) =
              make_float4(wt[0][j], wt[1][j], wt[2][j], wt[3][j]);
          *reinterpret_cast<float4*>(dst + (cg + 8 * j) * kLdW + rw) =
              make_float4(dt[0][j], dt[1][j], dt[2][j], dt[3][j]);
        }
        __syncthreads();
        if (rows.warp_live)
          mma_cols<NC, kTile>(dst + rw, kLdW, ks + 4 * cg, LD, g);
      }
      // dk and dv of the tile's keys: sums over every row of the atom
      // dk_k = sum_j (dL ww)_jk q_j, dv_k = sum_j W_jk dO_j
      for (int prod = warp / KW; (live || row0 == 0) && prod < 2;
           prod += kWarps / KW) {
        const bool is_dk = prod == 0;
        float acc[NF][4][4];
        zero(acc);
        const int kl = 16 * kh + 4 * kq, f = 32 * NF * fb + 4 * fg;
        if (live)
          mma_keys<NF>((is_dk ? dst : vw) + kl * kLdW, kLdW,
                       (is_dk ? qs : dos) + f, LD, rows.live_end, acc);
        float* grad = is_dk ? dk : dv;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + kl + i;
          if (key >= S) continue;
          const bool keep = live && __ldg(prow + key) > masked;
#pragma unroll
          for (int u = 0; u < NF; ++u) {
            float4* at = reinterpret_cast<float4*>(grad + (base + key) * D + f + 32 * u);
            float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
            if (keep) a = make_float4(acc[u][i][0], acc[u][i][1], acc[u][i][2], acc[u][i][3]);
            if (row0 > 0) {  // a later pass adds to the first's sums
              const float4 a0 = *at;
              a = make_float4(a0.x + a.x, a0.y + a.y, a0.z + a.z, a0.w + a.w);
            }
            *at = a;
          }
        }
      }
    }
    store_rows<NC>(dq + base * D, row0 + rw, S, D, cg, rows.ok, g);
  }
}

// ------------------------------------------------------------ host helpers

constexpr int kMaxDevices = 64;

// Raise each kernel's dynamic shared-memory limit once a device, before its
// first launch there (a launch may then be recorded into a CUDA graph).
template <int D>
cudaError_t allow_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(attn_fwd_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             fwd_smem<D>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_bwd_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bwd_smem<D>());
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, const float* ww,
               const float* gate, const float* pad, float* out, float* lse,
               int A, int S, float shift, float masked, cudaStream_t st) {
  cudaError_t err = allow_smem<D>();
  if (err != cudaSuccess) return (int)err;
  attn_fwd_kernel<D><<<A, 32 * kFwdWarps, fwd_smem<D>(), st>>>(
      q, k, v, ww, gate, pad, out, lse, S, shift, masked);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(const float* q, const float* k, const float* v, const float* ww,
               const float* gate, const float* pad, const float* out,
               const float* lse, const float* dout, float* dq, float* dk,
               float* dv, float* dww, float* dgate, int A, int S, float shift,
               float masked, cudaStream_t st) {
  cudaError_t err = allow_smem<D>();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_kernel<D><<<A, 32 * kBwdWarps, bwd_smem<D>(), st>>>(
      q, k, v, ww, gate, pad, out, lse, dout, dq, dk, dv, dww, dgate, S,
      shift, masked);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: (A, S, D); ww, gate: (A, S, S); pad: (A, S); lse: (A, S).
// All float32, contiguous, 16-byte aligned; D one of 32, 64, 128. A slot is
// live where pad > masked. Returns cudaGetLastError() after the launch (0:
// launched).
int dpa1_attention_fwd(const void* q, const void* k, const void* v,
                       const void* ww, const void* gate, const void* pad,
                       void* out, void* lse, int A, int S, int D, float shift,
                       float masked, void* stream) {
  if (A < 0 || S < 0) return (int)cudaErrorInvalidValue;
  if (A == 0 || S == 0) return 0;
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
#define DPA1_FWD(DIM)                                                      \
  launch_fwd<DIM>(f(q), f(k), f(v), f(ww), f(gate), f(pad), (float*)out, \
                  (float*)lse, A, S, shift, masked, st)
  switch (D) {
    case 32:
      return DPA1_FWD(32);
    case 64:
      return DPA1_FWD(64);
    case 128:
      return DPA1_FWD(128);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DPA1_FWD
}

// The forward's inputs, its out and lse, and dout (A, S, D); writes dq, dk,
// dv (A, S, D) and dww, dgate (A, S, S) whole.
int dpa1_attention_bwd(const void* q, const void* k, const void* v,
                       const void* ww, const void* gate, const void* pad,
                       const void* out, const void* lse, const void* dout,
                       void* dq, void* dk, void* dv, void* dww, void* dgate,
                       int A, int S, int D, float shift, float masked,
                       void* stream) {
  if (A < 0 || S < 0) return (int)cudaErrorInvalidValue;
  if (A == 0 || S == 0) return 0;
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  auto w = [](void* p) { return (float*)p; };
#define DPA1_BWD(DIM)                                                         \
  launch_bwd<DIM>(f(q), f(k), f(v), f(ww), f(gate), f(pad), f(out), f(lse), \
                  f(dout), w(dq), w(dk), w(dv), w(dww), w(dgate), A, S,     \
                  shift, masked, st)
  switch (D) {
    case 32:
      return DPA1_BWD(32);
    case 64:
      return DPA1_BWD(64);
    case 128:
      return DPA1_BWD(128);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DPA1_BWD
}

}  // extern "C"
