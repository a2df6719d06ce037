// Hand-written Hopper kernels for the NestedLoRA EVD loss.
//
// They replace the three Pallas kernels of neuralsvd_tpu/ops/pallas_gram.py:
//
//   masked_gram_*   <- _masked_gram_kernel   (Λ1 = f1ᵀf1/B, Λ2 = f2ᵀf2/B,
//                                             loss = Σ M⊙Λ1⊙Λ2)
//   weighted_dot_*  <- _weighted_dot_kernel  (Σ_b Σ_l w_l f[b,l] Tf[b,l])
//   metric_grads_*  <- _metric_grads_kernel  (g1 = f1·s1(M⊙Λ2), g2 = f2·s2(M⊙Λ1))
//
// Plain C interface: every launcher takes device pointers, sizes and the
// stream, launches on that stream, never synchronises or allocates (the
// Python wrapper in ops/cuda_gram.py allocates outputs and scratch) and
// returns cudaGetLastError().  Built by one nvcc call into a shared library
// loaded with ctypes; no PyTorch header is included.
//
// What bounds them: on the E4 path (B = 256..512 rows, L = 16 modes, f32)
// each kernel moves 35-67 KB and does at most 0.27 MFLOP, so the bound at
// 3.35 TB/s is 10-20 nanoseconds and launch latency (microseconds)
// dominates.  On the CDK path (f, g: 4096 x 513) K1 and K3 each do 4.3
// GFLOP, bound by f32 arithmetic at ~64 us, and K2 moves 16.8 MB (~5 us).
// The design is simple and right, not fast: f32 FMAs through 32x32
// shared-memory tiles (4 FMAs per 5 shared loads), no float atomics, and
// every cross-block sum taken by a later pass in a fixed order, so results
// repeat bit for bit.  L is never padded: tiles mask their ragged edges.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                     // output tile edge
constexpr int kRows = 8;                      // threadIdx.y extent
constexpr int kPerThread = kTile / kRows;     // outputs per thread
constexpr int kReduceThreads = 256;

// Block-wide sum for a 1-D block of kReduceThreads threads: shuffles within
// each warp, then the warp sums through shared memory.  The result is valid
// in thread 0 only.  The order of additions is fixed by the thread layout.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[kReduceThreads / 32];
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kReduceThreads / 32 ? warp_sums[lane] : 0.f;
    for (int offset = 16; offset > 0; offset >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, offset);
    }
  }
  return v;
}

// ---------------------------------------------------------------------------
// K1: masked pair-gram.  Pass 1: block (chunk c, tile (l0, m0), half z)
// accumulates Σ_{b in chunk} f_z[b, l] f_z[b, m] over rows_per_chunk rows
// and writes it to partial[c][z][l][m].  Pass 2: one thread per (l, m)
// sums the chunks in order, normalises, writes Λ1/Λ2, and each block
// writes its share of the masked loss Σ M⊙Λ1⊙Λ2.  Pass 3 (skipped when
// pass 2 is one block): one block sums those shares in order.
//
// Pass 2 was one block once; at 4096 x 513 it read the 67 MB of partials
// on one SM in 4.3 ms, ten times pass 1.  Spread over L²/256 blocks it
// reads them at the memory's rate.
// ---------------------------------------------------------------------------

__global__ void masked_gram_partial_kernel(const float* __restrict__ f1,
                                           const float* __restrict__ f2,
                                           float* __restrict__ partial,
                                           int B, int L, int rows_per_chunk) {
  __shared__ float sl[kTile][kTile + 1];  // [row][l - l0]
  __shared__ float sm[kTile][kTile + 1];  // [row][m - m0]
  const int tiles = (L + kTile - 1) / kTile;
  const int l0 = (blockIdx.y / tiles) * kTile;
  const int m0 = (blockIdx.y % tiles) * kTile;
  const int z = blockIdx.z;
  const float* __restrict__ f = z == 0 ? f1 : f2;
  const int b_begin = blockIdx.x * rows_per_chunk;
  const int b_end = min(B, b_begin + rows_per_chunk);
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;

  float acc[kPerThread] = {0.f, 0.f, 0.f, 0.f};
  for (int b0 = b_begin; b0 < b_end; b0 += kTile) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int r = ty + k * kRows;
      const int b = b0 + r;
      const bool row_ok = b < b_end;
      sl[r][tx] = (row_ok && l0 + tx < L) ? f[(size_t)b * L + l0 + tx] : 0.f;
      sm[r][tx] = (row_ok && m0 + tx < L) ? f[(size_t)b * L + m0 + tx] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kTile; ++r) {
      const float mv = sm[r][tx];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        acc[k] = fmaf(sl[r][ty + k * kRows], mv, acc[k]);
      }
    }
    __syncthreads();
  }
  float* __restrict__ out =
      partial + ((size_t)blockIdx.x * 2 + z) * (size_t)L * L;
  const int m = m0 + tx;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int l = l0 + ty + k * kRows;
    if (l < L && m < L) out[(size_t)l * L + m] = acc[k];
  }
}

__global__ void masked_gram_reduce_kernel(const float* __restrict__ partial,
                                          const float* __restrict__ mmask,
                                          float* __restrict__ lam1,
                                          float* __restrict__ lam2,
                                          float* __restrict__ loss_part,
                                          int L, int nchunk, float inv_b1,
                                          float inv_b2) {
  const size_t LL = (size_t)L * L;
  const size_t i = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
  float local = 0.f;
  if (i < LL) {
    float a = 0.f;
    float b = 0.f;
    for (int c = 0; c < nchunk; ++c) {
      a += partial[(2 * (size_t)c) * LL + i];
      b += partial[(2 * (size_t)c + 1) * LL + i];
    }
    a *= inv_b1;
    b *= inv_b2;
    lam1[i] = a;
    lam2[i] = b;
    local = mmask[i] * a * b;
  }
  const float total = block_sum(local);
  if (threadIdx.x == 0) loss_part[blockIdx.x] = total;
}

// ---------------------------------------------------------------------------
// K2: weighted dot.  Grid-stride product w[l]·f·Tf over the flat (B, L)
// arrays, one partial per block; a one-block second pass sums the partials
// in order (skipped when the grid is one block).
// ---------------------------------------------------------------------------

__global__ void weighted_dot_partial_kernel(const float* __restrict__ f,
                                            const float* __restrict__ tf,
                                            const float* __restrict__ w,
                                            float* __restrict__ out,
                                            int n, int L) {
  float acc = 0.f;
  for (int i = blockIdx.x * kReduceThreads + threadIdx.x; i < n;
       i += gridDim.x * kReduceThreads) {
    acc = fmaf(w[i % L] * f[i], tf[i], acc);
  }
  const float total = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = total;
}

__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int n) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kReduceThreads) acc += partial[i];
  const float total = block_sum(acc);
  if (threadIdx.x == 0) out[0] = total;
}

// ---------------------------------------------------------------------------
// K3: metric gradients.  Block (row tile, column tile, half z) computes a
// 32x32 tile of g_z = f_z · C_z, C_1 = s1·(M⊙Λ2), C_2 = s2·(M⊙Λ1); C is
// formed while its 32x32 slices are staged in shared memory, so it never
// goes to device memory.  The TPU kernel received C formed outside; here
// forming it costs nothing extra and saves two launches.
// ---------------------------------------------------------------------------

__global__ void metric_grads_kernel(const float* __restrict__ f1,
                                    const float* __restrict__ f2,
                                    const float* __restrict__ lam1,
                                    const float* __restrict__ lam2,
                                    const float* __restrict__ mmask,
                                    float s1, float s2,
                                    float* __restrict__ g1,
                                    float* __restrict__ g2, int B, int L) {
  __shared__ float sf[kTile][kTile + 1];  // [row][k - k0]
  __shared__ float sc[kTile][kTile + 1];  // [k - k0][m - m0]
  const int z = blockIdx.z;
  const float* __restrict__ f = z == 0 ? f1 : f2;
  const float* __restrict__ lam = z == 0 ? lam2 : lam1;
  const float s = z == 0 ? s1 : s2;
  float* __restrict__ g = z == 0 ? g1 : g2;
  const int b0 = blockIdx.x * kTile;
  const int m0 = blockIdx.y * kTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;

  float acc[kPerThread] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < L; k0 += kTile) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int r = ty + k * kRows;
      const int b = b0 + r;
      sf[r][tx] = (b < B && k0 + tx < L) ? f[(size_t)b * L + k0 + tx] : 0.f;
      const int kk = k0 + r;
      const int m = m0 + tx;
      const size_t idx = (size_t)kk * L + m;
      sc[r][tx] = (kk < L && m < L) ? s * (mmask[idx] * lam[idx]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      const float cv = sc[kk][tx];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        acc[k] = fmaf(sf[ty + k * kRows][kk], cv, acc[k]);
      }
    }
    __syncthreads();
  }
  const int m = m0 + tx;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int b = b0 + ty + k * kRows;
    if (b < B && m < L) g[(size_t)b * L + m] = acc[k];
  }
}

}  // namespace

extern "C" {

// partial: (nchunk, 2, L, L) scratch, nchunk = ceil(B / rows_per_chunk);
// rows_per_chunk a multiple of 32.  loss_part: reduce_blocks floats of
// scratch, reduce_blocks = ceil(L² / 256), unused (may be null) when it is
// 1.  loss: 1 float; lam1, lam2: (L, L).
int gram_masked_gram_pair(const float* f1, const float* f2, const float* mmask,
                          float* partial, float* loss_part, float* lam1,
                          float* lam2, float* loss, int B, int L,
                          int rows_per_chunk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nchunk = (B + rows_per_chunk - 1) / rows_per_chunk;
  const int tiles = (L + kTile - 1) / kTile;
  const dim3 grid(nchunk, tiles * tiles, 2);
  const dim3 block(kTile, kRows);
  masked_gram_partial_kernel<<<grid, block, 0, s>>>(f1, f2, partial, B, L,
                                                    rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int reduce_blocks =
      static_cast<int>(((size_t)L * L + kReduceThreads - 1) / kReduceThreads);
  float* first = reduce_blocks > 1 ? loss_part : loss;
  masked_gram_reduce_kernel<<<reduce_blocks, kReduceThreads, 0, s>>>(
      partial, mmask, lam1, lam2, first, L, nchunk, 1.f / B, 1.f / B);
  err = cudaGetLastError();
  if (err != cudaSuccess || reduce_blocks == 1) return static_cast<int>(err);
  sum_partials_kernel<<<1, kReduceThreads, 0, s>>>(loss_part, loss,
                                                   reduce_blocks);
  return static_cast<int>(cudaGetLastError());
}

// partial: nblocks floats when nblocks > 1 (unused, may be null, otherwise);
// out: 1 float.
int gram_weighted_dot(const float* f, const float* tf, const float* w,
                      float* partial, float* out, int B, int L, int nblocks,
                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* first = nblocks > 1 ? partial : out;
  weighted_dot_partial_kernel<<<nblocks, kReduceThreads, 0, s>>>(
      f, tf, w, first, B * L, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nblocks == 1) return static_cast<int>(err);
  sum_partials_kernel<<<1, kReduceThreads, 0, s>>>(partial, out, nblocks);
  return static_cast<int>(cudaGetLastError());
}

const char* gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// g1, g2: (B, L) outputs.
int gram_metric_grads(const float* f1, const float* f2, const float* lam1,
                      const float* lam2, const float* mmask, float s1,
                      float s2, float* g1, float* g2, int B, int L,
                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + kTile - 1) / kTile, (L + kTile - 1) / kTile, 2);
  const dim3 block(kTile, kRows);
  metric_grads_kernel<<<grid, block, 0, s>>>(f1, f2, lam1, lam2, mmask, s1,
                                             s2, g1, g2, B, L);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
