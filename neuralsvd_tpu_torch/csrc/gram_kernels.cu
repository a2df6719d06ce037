// Hand-written Hopper kernels for the NestedLoRA EVD loss.
//
// They replace the three Pallas kernels of neuralsvd_tpu/ops/pallas_gram.py:
//
//   masked_gram_*   <- _masked_gram_kernel   (Λ1 = f1ᵀf1/B, Λ2 = f2ᵀf2/B,
//                                             loss = Σ M⊙Λ1⊙Λ2, and
//                                             M⊙Λ1, M⊙Λ2 for the backward)
//   weighted_dot_*  <- _weighted_dot_kernel  (Σ_b Σ_l w_l f[b,l] Tf[b,l])
//   metric_grads_*  <- _metric_grads_kernel  (g1 = s1·f1·(M⊙Λ2),
//                                             g2 = s2·f2·(M⊙Λ1))
//
// Plain C interface: every launcher takes device pointers, sizes and the
// stream, launches on that stream, never synchronises or allocates (the
// Python wrapper in ops/cuda_gram.py allocates outputs and scratch) and
// returns cudaGetLastError().  Built by one nvcc call into a shared library
// loaded with ctypes; no PyTorch header is included.
//
// What bounds them.  On the E4 path (B = 256..512 rows, L = 16 modes, f32)
// each kernel moves 35-67 KB and does at most 0.27 MFLOP: bound 10-20 ns by
// bytes, and launch latency (microseconds) is what a call costs, so each
// wrapper call is as few launches as the kernel allows (K2: one).  On the
// CDK path (f, g: 4096 x 513) K1's two symmetric grams need 2.16 GFLOP and
// K3's two products 4.3 GFLOP, bound by f32 arithmetic at 67 TFLOP/s (32
// and 64 us); K2 moves 16.8 MB (5 us, bytes).
//
// Precision: f32 FFMA only, no tensor cores.  The JAX package pins its
// grams to full f32 and the kernels are held to 1e-5 of their plain
// versions; TF32 keeps ~10 mantissa bits.
//
// Design of K1 and K3 for the arithmetic bound:
// - Register blocking: a 256-thread block owns a 64x64 (K1) or 128x64 /
//   128x96 (K3) output tile, each thread a 4x4 or 8x4 / 8x6 register tile,
//   so a 16-byte shared-memory load feeds 8-12 FMAs (0.8 in the first
//   port's 32x32 tiles).  Operands are staged with the reduction index k
//   outermost where the tile edge is contiguous in memory (f's columns for
//   K1, C's for K3), and K3's f slice row-major, so a thread's 4 values
//   are one float4.
// - A 3-stage cp.async ring of BK = 16 rows overlaps the next slices' copies
//   with the FMAs of this one.  Rows of f are L floats: at L = 513 a row is
//   2052 bytes, not a multiple of 16, so neither 16-byte cp.async nor TMA
//   (which needs 16-byte global strides) can address them.  The copy width
//   is a template parameter: 16 bytes where L % 4 == 0 and the pointers are
//   16-byte aligned, 4 bytes (cp.async.ca) otherwise; nothing pads L in
//   device memory.  TMA is left out for that reason.
// - What the 4-byte path costs (NVIDIA H100 80GB HBM3, 700 W, measured by
//   profile_torch_e4.py --path kernels): at 4096 x 513 against 4096 x 512
//   K1's pass 1 runs 1.47x and K3 1.31x slower, more than their extra work,
//   so at the CDK shape the copies, not the FMAs, bound them.  Each thread's
//   copies of a stage therefore sit at fixed offsets from one pointer
//   (immediate offsets in the instruction) with their bounds tests taken
//   outside the loop, and K3's 4-byte path takes 96-column tiles (22% fewer
//   copies an FMA).  Deeper rings, register-staged loads, 8x8 thread tiles
//   and 96x96 K1 tiles were measured and were no faster.
// - K1 is a SYRK: only the tiles with l0 <= m0 are computed, from a table
//   of tile origins the wrapper builds once per L.  Its split-K over rows
//   uses few fixed chunks (a function of B and L only, chosen by the
//   wrapper for whole waves of 132 SMs: 4 chunks of 1024 rows, 360 blocks,
//   at the CDK shape), so the partial buffer is 8.4 MB there, inside L2.
//   At L = 513 the 64-tiles run 513·514/2 useful of 45·4096 computed
//   entries a gram: 72% of the issued FMAs are useful.
// - No float atomics.  Every cross-block sum is taken by a later pass in a
//   fixed order (chunks in order, then block shares in order), and the
//   number of chunks depends on B and L only, so results repeat bit for
//   bit.  The finish pass reads the upper partial of each (l, m) for both
//   Λ[l][m] and Λ[m][l] (diagonal tiles hold both halves, equal because a
//   product commutes exactly), so the mirrored grams are exactly symmetric.
//   The mask M is not assumed symmetric: sequential nesting makes it upper
//   triangular, so the loss and M⊙Λ use the full M against the mirrored Λ.
// - K1's finish pass also writes C1 = M⊙Λ1 and C2 = M⊙Λ2, which the
//   backward keeps in place of Λ; K3 streams C with cp.async (C is not
//   symmetric either) and applies the scale s in its epilogue.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // every kernel's block size
constexpr int kReduceThreads = kThreads;
constexpr int kStages = 3;           // cp.async ring depth
constexpr int kBK = 16;              // rows of the reduction per stage
constexpr int kSyrkTile = 64;        // K1 output tile edge (4x4 a thread)
constexpr int kFinishTile = 32;      // K1 finish-pass tile edge
constexpr int kGradRows = 128;       // K3 output tile: rows of g (8 a thread)
// K3's columns a tile: 64 (4 a thread) with 16-byte copies, where the FMAs
// bound it, and 96 (4 of the first 64 and 2 of the last 32 a thread) with
// 4-byte copies, where the copies do: 22% fewer copies an FMA, and the same
// 576 columns computed at L = 513
template <int kVec>
constexpr int kGradColsOf = kVec == 4 ? 64 : 96;

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

// Asynchronous global -> shared copy of kBytes (4 or 16); when !ok the
// source size is 0: nothing is read from src and the bytes are zero-filled.
template <int kBytes>
__device__ __forceinline__ void cp_async_zfill(float* smem, const float* src,
                                               bool ok) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_size = ok ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_size)
                 : "memory");
  } else {
    static_assert(kBytes == 4, "copy width is 4 or 16 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_size)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ---------------------------------------------------------------------------
// K1: masked pair-gram.
//
// Pass 1 (masked_gram_syrk_kernel): block (tile t, gram z, chunk c) sums
// f_z[b, l] f_z[b, m] over the chunk's rows for the 64x64 tile at
// tiles[t] = (l0, m0), l0 <= m0, and writes it to partial[c][z][l][m].
// Pass 2 (masked_gram_finish_kernel): one 32x32 tile of (l, m) a block;
// each element sums its chunks in order from the upper partial (a tile
// below the diagonal reads its mirror tile through shared memory, so both
// reads and writes stay coalesced), normalises, writes Λ1, Λ2, M⊙Λ1, M⊙Λ2,
// and the block writes its share of Σ M⊙Λ1⊙Λ2.  Pass 3 (skipped when pass 2
// is one block): one block sums those shares in order.
// ---------------------------------------------------------------------------

template <int kVec>  // floats per copy: 4 (16-byte cp.async) or 1 (4-byte)
__global__ void __launch_bounds__(kThreads)
    masked_gram_syrk_kernel(const float* __restrict__ f1,
                            const float* __restrict__ f2,
                            const int* __restrict__ tiles,
                            float* __restrict__ partial, int B, int L,
                            int rows_per_chunk) {
  __shared__ __align__(16) float sl[kStages][kBK][kSyrkTile];  // [k][l - l0]
  __shared__ __align__(16) float sm[kStages][kBK][kSyrkTile];  // [k][m - m0]
  const int l0 = tiles[2 * blockIdx.x];
  const int m0 = tiles[2 * blockIdx.x + 1];
  const int z = blockIdx.y;
  const float* __restrict__ f = z == 0 ? f1 : f2;
  const int b_begin = blockIdx.z * rows_per_chunk;
  const int b_end = min(B, b_begin + rows_per_chunk);
  const int nk = (b_end - b_begin + kBK - 1) / kBK;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns m0 + 4 tx .. + 3
  const int ty = tid / 16;  // rows    l0 + 4 ty .. + 3

  // Copies: thread t fills row t / 16 of both slices of a stage, columns
  // t % 16 + 16 j (4-byte copies, j < 4) or 4 (t % 16) .. + 3 (one 16-byte
  // copy), so each copy sits at a fixed offset from one row pointer a stage
  // and a warp's copies cover two rows' contiguous 64 or 256 bytes.  The
  // column tests are the same every stage; only the last stage of the last
  // chunk has rows past B.
  constexpr int kCopies = kSyrkTile / (16 * kVec);  // copies a slice a thread
  const int r = tid / 16;
  const int c = kVec == 4 ? 4 * (tid % 16) : tid % 16;
  const float* row0 = f + (size_t)(b_begin + r) * L + c;
  bool l_ok[kCopies], m_ok[kCopies];
#pragma unroll
  for (int j = 0; j < kCopies; ++j) {
    l_ok[j] = l0 + c + 16 * j < L;  // L % kVec == 0: whole vector
    m_ok[j] = m0 + c + 16 * j < L;
  }
  auto load = [&](int stage, int kt) {
    const bool row_ok = b_begin + kt * kBK + r < b_end;
    const float* src = row0 + (size_t)kt * kBK * L;
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      const int col = c + (kVec == 4 ? 0 : 16 * j);
      cp_async_zfill<4 * kVec>(&sl[stage][r][col], src + l0 + 16 * j,
                               row_ok && l_ok[j]);
      cp_async_zfill<4 * kVec>(&sm[stage][r][col], src + m0 + 16 * j,
                               row_ok && m_ok[j]);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage kt landed
    __syncthreads();  // everyone's copies landed; stage kt - 1 is consumed
    const int next = kt + kStages - 1;
    if (next < nk) load(next % kStages, next);
    cp_async_commit();
    const int st = kt % kStages;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&sl[st][k][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&sm[st][k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }

  float* __restrict__ out =
      partial + ((size_t)blockIdx.z * 2 + z) * (size_t)L * L;
  const int m = m0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + 4 * ty + i;
    if (l >= L) continue;
    float* row = out + (size_t)l * L;
    if constexpr (kVec == 4) {
      if (m < L) {
        *reinterpret_cast<float4*>(row + m) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (m + j < L) row[m + j] = acc[i][j];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    masked_gram_finish_kernel(const float* __restrict__ partial,
                              const float* __restrict__ mmask,
                              float* __restrict__ lam1,
                              float* __restrict__ lam2,
                              float* __restrict__ mlam1,
                              float* __restrict__ mlam2,
                              float* __restrict__ loss_part, int L, int nchunk,
                              float inv_b1, float inv_b2) {
  __shared__ float s1[kFinishTile][kFinishTile + 1];
  __shared__ float s2[kFinishTile][kFinishTile + 1];
  constexpr int kRowsPerPass = kThreads / kFinishTile;
  const size_t LL = (size_t)L * L;
  const int ti = blockIdx.y;  // output rows    l in [32 ti, 32 ti + 32)
  const int tj = blockIdx.x;  // output columns m in [32 tj, 32 tj + 32)
  const bool flip = ti > tj;  // below the diagonal: read the mirror tile
  const int r0 = (flip ? tj : ti) * kFinishTile;
  const int c0 = (flip ? ti : tj) * kFinishTile;
  const int tx = threadIdx.x % kFinishTile;
  const int ty = threadIdx.x / kFinishTile;

#pragma unroll
  for (int k = 0; k < kFinishTile / kRowsPerPass; ++k) {
    const int rr = ty + k * kRowsPerPass;
    const int r = r0 + rr;
    const int c = c0 + tx;
    float a = 0.f;
    float b = 0.f;
    if (r < L && c < L) {
      const float* p = partial + (size_t)r * L + c;
#pragma unroll 4
      for (int ch = 0; ch < nchunk; ++ch) {
        a += p[(2 * (size_t)ch) * LL];
        b += p[(2 * (size_t)ch + 1) * LL];
      }
    }
    s1[rr][tx] = a;
    s2[rr][tx] = b;
  }
  __syncthreads();

  float local = 0.f;
#pragma unroll
  for (int k = 0; k < kFinishTile / kRowsPerPass; ++k) {
    const int rr = ty + k * kRowsPerPass;
    const int l = ti * kFinishTile + rr;
    const int m = tj * kFinishTile + tx;
    if (l < L && m < L) {
      const float a = (flip ? s1[tx][rr] : s1[rr][tx]) * inv_b1;
      const float b = (flip ? s2[tx][rr] : s2[rr][tx]) * inv_b2;
      const size_t i = (size_t)l * L + m;
      const float mm = mmask[i];
      const float ma = mm * a;
      lam1[i] = a;
      lam2[i] = b;
      mlam1[i] = ma;
      mlam2[i] = mm * b;
      local += ma * b;
    }
  }
  const float total = block_sum(local);
  if (threadIdx.x == 0) loss_part[blockIdx.y * gridDim.x + blockIdx.x] = total;
}

// ---------------------------------------------------------------------------
// K2: weighted dot, Σ_b Σ_l w_l f[b,l] Tf[b,l], in one launch.
//
// Bytes bound it: it reads f and Tf once (16.8 MB at 4096 x 513, 5 us at
// 3.35 TB/s) and does 3 flops a pair.  A warp's lanes lie along a row, so
// its loads are coalesced, and each lane works out its column(s) once and
// keeps its weights in registers: the row loop has no division.  Rows of
// at most 32 vectors (kVec floats each: 4 where L % 4 == 0 and the
// pointers are 16-byte aligned, else 1) put 32 / cols whole rows in a warp
// (8 rows of 16 floats at E4); wider rows are cut into chunks of 32
// vectors, a warp per (chunk, slot).  Slot s of a chunk takes row groups
// s, s + slots, ..., kDotUnroll at a time, with no branch around the loads
// (rows past B re-read row B - 1 and are not summed), so a lane has up to
// 2·kDotUnroll loads in flight.  The wrapper sizes the grid (k2_plan): one
// block where whole-row warps need at most two rounds (E4: 8 warps of 8
// row groups), else one round a warp where that fits in DOT_MAX_BLOCKS
// blocks, else the most blocks, whole chunks (527 at 4096 x 513).
//
// A grid of more than one block ends by a ticket: each block writes its
// partial, fences, and takes an integer ticket (atomicInc, which wraps the
// counter back to 0 for the next launch); the block that draws the last
// ticket sums the partials in index order.  No float atomics and a grid
// fixed by (B, L, kVec): results repeat bit for bit, and the launch leaves
// the counter as it found it, so it can be replayed in a CUDA graph.
// ---------------------------------------------------------------------------

constexpr int kDotUnroll = 4;

template <int kVec>
struct DotVec;
template <>
struct DotVec<4> {
  using T = float4;
  __device__ static float dot3(const float4 w, const float4 a, const float4 b,
                               float acc) {
    acc = fmaf(w.x * a.x, b.x, acc);
    acc = fmaf(w.y * a.y, b.y, acc);
    acc = fmaf(w.z * a.z, b.z, acc);
    return fmaf(w.w * a.w, b.w, acc);
  }
  __device__ static float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};
template <>
struct DotVec<1> {
  using T = float;
  __device__ static float dot3(const float w, const float a, const float b,
                               float acc) {
    return fmaf(w * a, b, acc);
  }
  __device__ static float zero() { return 0.f; }
};

template <int kVec>
__global__ void __launch_bounds__(kThreads)
    weighted_dot_kernel(const float* __restrict__ f,
                        const float* __restrict__ tf,
                        const float* __restrict__ w,
                        float* __restrict__ partial,
                        unsigned* __restrict__ ticket, float* __restrict__ out,
                        int B, int L, int slots) {
  using Ops = DotVec<kVec>;
  using V = typename Ops::T;
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int cols = L / kVec;  // vectors a row: L % kVec == 0
  int rows_per_group, r, vc, slot;
  if (cols <= 32) {  // whole rows in a warp
    rows_per_group = 32 / cols;
    r = lane / cols;
    vc = lane - r * cols;
    slot = warp;
  } else {  // a chunk of 32 vectors of one row
    const int nchunks = (cols + 31) / 32;
    rows_per_group = 1;
    r = 0;
    vc = (warp % nchunks) * 32 + lane;
    slot = warp / nchunks;
  }
  float acc = 0.f;
  if (r < rows_per_group && vc < cols && slot < slots) {
    const V wv = reinterpret_cast<const V*>(w)[vc];
    const int groups = (B + rows_per_group - 1) / rows_per_group;
    const V* __restrict__ fv = reinterpret_cast<const V*>(f) + vc;
    const V* __restrict__ tv = reinterpret_cast<const V*>(tf) + vc;
    for (int g0 = slot; g0 < groups; g0 += kDotUnroll * slots) {
      V a[kDotUnroll], b[kDotUnroll];
      bool ok[kDotUnroll];
#pragma unroll
      for (int u = 0; u < kDotUnroll; ++u) {
        const int row = (g0 + u * slots) * rows_per_group + r;
        ok[u] = row < B;
        const int at = min(row, B - 1) * cols;  // B·L < 2^31 (wrapper)
        a[u] = fv[at];
        b[u] = tv[at];
      }
#pragma unroll
      for (int u = 0; u < kDotUnroll; ++u) {
        if (ok[u]) acc = Ops::dot3(wv, a[u], b[u], acc);
      }
    }
  }
  const float total = block_sum(acc);
  if (gridDim.x == 1) {  // a one-block grid (E4) takes no ticket
    if (threadIdx.x == 0) *out = total;
    return;
  }
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = total;
    __threadfence();
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float sum = 0.f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) {
    sum += __ldcg(partial + i);
  }
  const float all = block_sum(sum);
  if (threadIdx.x == 0) *out = all;
}

// K1's pass 3: one block sums the finish pass's loss shares in order.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int n) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kReduceThreads) acc += partial[i];
  const float total = block_sum(acc);
  if (threadIdx.x == 0) out[0] = total;
}

// ---------------------------------------------------------------------------
// K3: metric gradients.  Block (row tile, column tile, half z) computes a
// 128x64 tile of g_z = s_z · f_z · C, C = M⊙Λ2 for z = 0 and M⊙Λ1 for
// z = 1 (both written by K1's finish pass), over L in kBK-deep stages.  f
// is staged row-major ([row][k], a row's k-slice is contiguous in f), C
// k-major ([k][m], as it lies in memory); a thread reads its 8 rows as one
// float4 of 4 k each and C as one float4 of 4 m per k.
// ---------------------------------------------------------------------------

template <int kVec>
__global__ void __launch_bounds__(kThreads, 2)
    metric_grads_kernel(const float* __restrict__ f1,
                        const float* __restrict__ f2,
                        const float* __restrict__ mlam1,
                        const float* __restrict__ mlam2, float s1, float s2,
                        float* __restrict__ g1, float* __restrict__ g2, int B,
                        int L) {
  __shared__ __align__(16) float sf[kStages][kGradRows][kBK];  // [row][k]
  constexpr int kGradCols = kGradColsOf<kVec>;
  constexpr int kNC = kGradCols / 16;  // columns a thread: 4 or 6
  __shared__ __align__(16) float sc[kStages][kBK][kGradCols];  // [k][m - m0]
  const int z = blockIdx.z;
  const float* __restrict__ f = z == 0 ? f1 : f2;
  const float* __restrict__ c = z == 0 ? mlam2 : mlam1;
  const float s = z == 0 ? s1 : s2;
  float* __restrict__ g = z == 0 ? g1 : g2;
  const int b0 = blockIdx.x * kGradRows;
  const int m0 = blockIdx.y * kGradCols;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns m0 + 4 tx .. + 3 (and 64 + 2 tx, + 1)
  const int ty = tid / 16;  // rows    b0 + 8 ty .. + 7
  const int nk = (L + kBK - 1) / kBK;

  // Copies of f: thread t fills rows t / 16 + 16 p (p < 8) of the [row][k]
  // slice at column t % 16 (4-byte) or rows t / 4 + 64 p (p < 2) at
  // columns 4 (t % 4) .. + 3 (16-byte); of C: row t / 16 of the [k][m]
  // slice at columns t % 16 + 16 j (4-byte, j < 6) or 4 (t % 16) .. + 3
  // (16-byte).  Every copy is a fixed
  // offset from one pointer a stage; the row and column tests are the
  // same every stage but the last.
  constexpr int kRowsPerPass = kThreads * kVec / kBK;       // 16 or 64
  constexpr int kFCopies = kGradRows / kRowsPerPass;        // 8 or 2
  constexpr int kCStep = 16 * kVec;                         // columns a pass
  constexpr int kCCopies = kGradCols / kCStep;              // 6 or 1
  const int fr = tid / (kBK / kVec);
  const int fk = kVec * (tid % (kBK / kVec));
  const float* f0 = f + (size_t)(b0 + fr) * L + fk;
  bool f_ok[kFCopies];
#pragma unroll
  for (int p = 0; p < kFCopies; ++p) f_ok[p] = b0 + fr + kRowsPerPass * p < B;
  const int cr = tid / 16;
  const int cc = kVec * (tid % 16);
  const float* c0 = c + (size_t)cr * L + m0 + cc;
  bool c_ok[kCCopies];
#pragma unroll
  for (int j = 0; j < kCCopies; ++j) c_ok[j] = m0 + cc + kCStep * j < L;
  const size_t f_stride = (size_t)kRowsPerPass * L;
  auto load = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    const bool fk_ok = k0 + fk < L;  // L % kVec == 0: whole vector
    const float* fs = f0 + k0;
#pragma unroll
    for (int p = 0; p < kFCopies; ++p) {
      cp_async_zfill<4 * kVec>(&sf[stage][fr + kRowsPerPass * p][fk],
                               fs + p * f_stride, fk_ok && f_ok[p]);
    }
    const bool ck_ok = k0 + cr < L;
    const float* cs = c0 + (size_t)k0 * L;
#pragma unroll
    for (int j = 0; j < kCCopies; ++j) {
      cp_async_zfill<4 * kVec>(&sc[stage][cr][cc + kCStep * j],
                               cs + kCStep * j, ck_ok && c_ok[j]);
    }
  };

  float acc[8][kNC];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < kNC; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < nk) load(next % kStages, next);
    cp_async_commit();
    const int st = kt % kStages;
#pragma unroll
    for (int k4 = 0; k4 < kBK; k4 += 4) {
      float a[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(&sf[st][8 * ty + i][k4]);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[kNC];
        const float4 b4 =
            *reinterpret_cast<const float4*>(&sc[st][k4 + kk][4 * tx]);
        bv[0] = b4.x;
        bv[1] = b4.y;
        bv[2] = b4.z;
        bv[3] = b4.w;
        if constexpr (kNC == 6) {
          const float2 b2 =
              *reinterpret_cast<const float2*>(&sc[st][k4 + kk][64 + 2 * tx]);
          bv[4] = b2.x;
          bv[5] = b2.y;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < kNC; ++j) {
            acc[i][j] = fmaf(a[i][kk], bv[j], acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int b = b0 + 8 * ty + i;
    if (b >= B) continue;
    float* row = g + (size_t)b * L + m0;
    const int m4 = 4 * tx;
    if constexpr (kVec == 4) {  // kNC == 4
      if (m0 + m4 < L) {
        *reinterpret_cast<float4*>(row + m4) = make_float4(
            s * acc[i][0], s * acc[i][1], s * acc[i][2], s * acc[i][3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kNC; ++j) {
        const int m = j < 4 ? m4 + j : 64 + 2 * tx + (j - 4);
        if (m0 + m < L) row[m] = s * acc[i][j];
      }
    }
  }
}

}  // namespace

extern "C" {

// tiles: ntiles (l0, m0) int pairs, l0 <= m0, multiples of 64 below L.
// partial: (nchunk, 2, L, L) scratch, nchunk = ceil(B / rows_per_chunk).
// loss_part: finish_blocks = ceil(L / 32)² floats of scratch, unused (may
// be null) when that is 1.  loss: 1 float; lam1, lam2, mlam1, mlam2:
// (L, L).  vec: 4 when L % 4 == 0 and f1, f2, partial are 16-byte aligned,
// else 1.
int gram_masked_gram_pair(const float* f1, const float* f2, const float* mmask,
                          const int* tiles, int ntiles, float* partial,
                          float* loss_part, float* lam1, float* lam2,
                          float* mlam1, float* mlam2, float* loss, int B,
                          int L, int rows_per_chunk, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nchunk = (B + rows_per_chunk - 1) / rows_per_chunk;
  const dim3 grid(ntiles, 2, nchunk);
  if (vec == 4) {
    masked_gram_syrk_kernel<4><<<grid, kThreads, 0, s>>>(
        f1, f2, tiles, partial, B, L, rows_per_chunk);
  } else {
    masked_gram_syrk_kernel<1><<<grid, kThreads, 0, s>>>(
        f1, f2, tiles, partial, B, L, rows_per_chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int t32 = (L + kFinishTile - 1) / kFinishTile;
  const int finish_blocks = t32 * t32;
  float* first = finish_blocks > 1 ? loss_part : loss;
  masked_gram_finish_kernel<<<dim3(t32, t32), kThreads, 0, s>>>(
      partial, mmask, lam1, lam2, mlam1, mlam2, first, L, nchunk, 1.f / B,
      1.f / B);
  err = cudaGetLastError();
  if (err != cudaSuccess || finish_blocks == 1) return static_cast<int>(err);
  sum_partials_kernel<<<1, kReduceThreads, 0, s>>>(loss_part, loss,
                                                   finish_blocks);
  return static_cast<int>(cudaGetLastError());
}

// partial: nblocks floats of scratch; ticket: one unsigned, 0 before the
// first launch (each launch leaves it 0); out: 1 float.  slots: warps per
// row chunk, as k2_plan in ops/cuda_gram.py sets it.  vec: 4 when
// L % 4 == 0 and f, tf, w are 16-byte aligned, else 1.
int gram_weighted_dot(const float* f, const float* tf, const float* w,
                      float* partial, unsigned* ticket, float* out, int B,
                      int L, int slots, int nblocks, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    weighted_dot_kernel<4><<<nblocks, kThreads, 0, s>>>(
        f, tf, w, partial, ticket, out, B, L, slots);
  } else {
    weighted_dot_kernel<1><<<nblocks, kThreads, 0, s>>>(
        f, tf, w, partial, ticket, out, B, L, slots);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// mlam1 = M⊙Λ1, mlam2 = M⊙Λ2: (L, L); g1 = s1·f1·mlam2 and g2 = s2·f2·mlam1:
// (B, L) outputs.  vec: 4 when L % 4 == 0 and every pointer is 16-byte
// aligned, else 1.
int gram_metric_grads(const float* f1, const float* f2, const float* mlam1,
                      const float* mlam2, float s1, float s2, float* g1,
                      float* g2, int B, int L, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cols = vec == 4 ? kGradColsOf<4> : kGradColsOf<1>;
  const dim3 grid((B + kGradRows - 1) / kGradRows, (L + cols - 1) / cols, 2);
  if (vec == 4) {
    metric_grads_kernel<4><<<grid, kThreads, 0, s>>>(f1, f2, mlam1, mlam2, s1,
                                                     s2, g1, g2, B, L);
  } else {
    metric_grads_kernel<1><<<grid, kThreads, 0, s>>>(f1, f2, mlam1, mlam2, s1,
                                                     s2, g1, g2, B, L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
