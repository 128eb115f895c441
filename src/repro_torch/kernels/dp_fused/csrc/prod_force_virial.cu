// Force-and-virial reduction for Hopper (sm_90a): the per-slot gradients
// dE/dr_ij of a neighbour list to per-atom forces and the 3x3 virial (the
// "force and virial production" that the paper's Sec. 3.4 writes by hand).
// Plain C entry point, built by build.py into the same library as
// dp_fused.cu and loaded with ctypes.
//
// Replaces no Pallas kernel: the reference scatters the pair forces with
// `.at[].add` (src/repro/core/dp_model.py:201), an XLA scatter, and sums the
// virial with an einsum. For centre a (row offset + a of f) and each slot n
// with j = nlist[a, n] >= 0:
//   f[j]          -= de[a, n, :]                 (action on the neighbour)
//   f[offset + a] += de[a, n, :]                 (reaction on the centre)
//   W[k][l]       -= rij[a, n, k] de[a, n, l]
// A padded slot (j < 0) adds nothing and its de and rij are never loaded, so
// whatever they hold (the autograd gradient is an exact zero there) never
// enters a sum. An index at or past `rows` is treated as padding: it is never
// written.
//
// What bounds it: L2 atomics, then device memory. nlist is read whole (8
// bytes a slot), de and rij only on live slots (12 bytes each), f written
// once (12 bytes a row); each live slot adds its -de to its neighbour's row
// with an atomic in L2 (f is 1.5 MB at 123,008 atoms). On the H100 three
// scalar reds a live slot took 1.57 ms at cu.weak's shape (131 M reds; the
// bytes' bound is 0.70 ms) and one vector red a slot 1.01 ms (PERF.md). The
// PyTorch composition this replaces (a mask, index_add_, a row sum, an
// einsum) made every padded slot add its zero into row 0: same-address
// atomics that the card serialises, about 0.6 ns each (216 ms a call there).
//
// The design follows from that:
//   * One warp per centre, blocks of kWarps warps over a grid-stride loop
//     (prod_force_virial_kernel). Lanes take consecutive slots, so the nlist
//     row is read coalesced and a live slot's de and rij rows lie in the
//     sectors its neighbours' do.
//   * The forces are summed as float4 rows of a zeroed scratch (x, y, z,
//     and a zero), so a slot's action on its neighbour is one vector red
//     (sm_90's atomicAdd on float4) and not three scalar ones.
//   * The reaction on the centre is summed in registers and reduced by
//     shuffles; lane 0 adds it with one vector red. A plain store would race
//     with the reds of other warps whose neighbour the centre is.
//   * The virial is held in nine registers a lane, reduced in the warp and
//     across the block's warps through shared memory in a fixed order, and
//     written as the block's nine partial sums to scratch. A second kernel
//     (prod_force_finish_kernel) sums the blocks' partials in a fixed order
//     and copies the float4 rows into the (rows, 3) forces. The virial takes
//     no atomics and is the same bit for bit from run to run on one card;
//     the forces' reds sum in an order that changes from run to run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;                 // warps per block, one centre each
constexpr unsigned kAll = 0xffffffffu;

// Every lane ends with the same bits: each step adds two partial sums in
// either order, and float addition commutes.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}

__global__ void __launch_bounds__(32 * kWarps)
    prod_force_virial_kernel(const float* __restrict__ de,
                             const float* __restrict__ rij,
                             const long long* __restrict__ nlist,
                             float4* __restrict__ f4,
                             float* __restrict__ partial, int A, int S,
                             long long rows, long long offset) {
  __shared__ float block_w[kWarps][9];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float w[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) w[k] = 0.f;

  for (long long a = (long long)blockIdx.x * kWarps + warp; a < A;
       a += (long long)gridDim.x * kWarps) {
    const size_t row = (size_t)a * S;
    float fx = 0.f, fy = 0.f, fz = 0.f;
    for (int n = lane; n < S; n += 32) {
      const long long j = __ldg(nlist + row + n);
      if (j < 0 || j >= rows) continue;
      const size_t s3 = 3 * (row + n);
      const float dx = __ldg(de + s3), dy = __ldg(de + s3 + 1),
                  dz = __ldg(de + s3 + 2);
      const float rx = __ldg(rij + s3), ry = __ldg(rij + s3 + 1),
                  rz = __ldg(rij + s3 + 2);
      fx += dx;
      fy += dy;
      fz += dz;
      atomicAdd(f4 + j, make_float4(-dx, -dy, -dz, 0.f));
      w[0] = fmaf(rx, dx, w[0]);
      w[1] = fmaf(rx, dy, w[1]);
      w[2] = fmaf(rx, dz, w[2]);
      w[3] = fmaf(ry, dx, w[3]);
      w[4] = fmaf(ry, dy, w[4]);
      w[5] = fmaf(ry, dz, w[5]);
      w[6] = fmaf(rz, dx, w[6]);
      w[7] = fmaf(rz, dy, w[7]);
      w[8] = fmaf(rz, dz, w[8]);
    }
    fx = warp_sum(fx);
    fy = warp_sum(fy);
    fz = warp_sum(fz);
    if (lane == 0) atomicAdd(f4 + offset + a, make_float4(fx, fy, fz, 0.f));
  }

#pragma unroll
  for (int k = 0; k < 9; ++k) w[k] = warp_sum(w[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) block_w[warp][k] = w[k];
  }
  __syncthreads();
  if (threadIdx.x < 9) {
    float s = 0.f;
    for (int q = 0; q < kWarps; ++q) s += block_w[q][threadIdx.x];
    partial[(size_t)blockIdx.x * 9 + threadIdx.x] = s;
  }
}

constexpr int kFinishThreads = 32 * 9;

// Block 0's warp k sums component k of the `blocks` partials in a fixed
// order and writes W[k] = -sum (zeros when there are none); every block
// copies float4 rows into f (rows, 3) in a grid-stride loop.
__global__ void __launch_bounds__(kFinishThreads)
    prod_force_finish_kernel(const float4* __restrict__ f4,
                             float* __restrict__ f, long long rows,
                             const float* __restrict__ partial, int blocks,
                             float* __restrict__ virial) {
  if (blockIdx.x == 0) {
    const int lane = threadIdx.x & 31;
    const int k = threadIdx.x >> 5;
    float s = 0.f;
    for (int b = lane; b < blocks; b += 32) s += partial[(size_t)b * 9 + k];
    s = warp_sum(s);
    if (lane == 0) virial[k] = -s;
  }
  for (long long r = (long long)blockIdx.x * kFinishThreads + threadIdx.x;
       r < rows; r += (long long)gridDim.x * kFinishThreads) {
    const float4 v = f4[r];
    f[3 * r] = v.x;
    f[3 * r + 1] = v.y;
    f[3 * r + 2] = v.z;
  }
}

}  // namespace

extern "C" {

// f4 (rows, 4) must hold zeros and be 16-byte aligned; partial holds
// max_blocks x 9 floats of scratch; f (rows, 3) and the virial (3, 3) are
// written whole. Returns cudaGetLastError() after the launches (0:
// launched).
int prod_force_virial(const void* de, const void* rij, const void* nlist,
                      void* f4, void* f, void* virial, void* partial,
                      int max_blocks, int A, int S, long long rows,
                      long long offset, void* stream) {
  if (A < 0 || S < 0 || max_blocks < 1 || offset < 0 || offset + A > rows ||
      (reinterpret_cast<uintptr_t>(f4) & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  if (A > 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, prod_force_virial_kernel, 32 * kWarps, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) per_sm = 1;           // the launch reports the shortfall
    long long n = ((long long)A + kWarps - 1) / kWarps;
    if (n > (long long)sms * per_sm) n = (long long)sms * per_sm;
    if (n > max_blocks) n = max_blocks;
    blocks = (int)n;
    prod_force_virial_kernel<<<blocks, 32 * kWarps, 0, st>>>(
        (const float*)de, (const float*)rij, (const long long*)nlist,
        (float4*)f4, (float*)partial, A, S, rows, offset);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  long long grid = (rows + kFinishThreads - 1) / kFinishThreads;
  if (grid > 8LL * sms) grid = 8LL * sms;
  if (grid < 1) grid = 1;
  prod_force_finish_kernel<<<(int)grid, kFinishThreads, 0, st>>>(
      (const float4*)f4, (float*)f, rows, (const float*)partial, blocks,
      (float*)virial);
  return (int)cudaGetLastError();
}

}  // extern "C"
