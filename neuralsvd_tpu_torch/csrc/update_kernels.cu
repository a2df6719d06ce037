// Hand-written Hopper kernels for the train step's update: from the summed
// gradients to the new parameters, optimizer moments and EMA in two passes.
//
//   grad_norm_kernel  ‖g‖² and a count of non-finite entries over every
//                     gradient tensor; the block that draws the last ticket
//                     writes ‖g‖, the clip scale and the skip flag
//   apply_kernel      every element once: the clip scale, RMSprop
//                     (ν ← αν + (1-α)g², u = g/(√ν+eps)) or the optax trace
//                     (m ← g + βm, u = m), p ← p - lr·u, all kept on a
//                     skipped step; then ema ← d·ema + (1-d)·p from the p
//                     in registers
//
// They replace no Pallas kernel: the JAX package leaves its update to XLA,
// which fuses it into a few loops.  The port's plain update (the rules of
// training/optimizers.py and the two train steps) is one PyTorch op per
// rule and tensor, each a full pass over device memory: ~45 passes over
// E4's 4.7M parameters, ~25 over the CDK's 16.8M.  It stays as the route of
// every other chain, of the CPU and of a tp mesh, and as the kernels' test
// oracle.
//
// What bounds them: bytes.  An element costs a few flops against 24-32
// bytes, far below the card's ridge.  The least traffic is one read of g
// for the norm, then one read of g, the moment, p (and the EMA) and one
// write of the moment, p (and the EMA): 8 x 4 bytes an element for
// RMSprop with an EMA (E4: 151 MB, 0.045 ms at 3.35 TB/s) and 6 x 4 for
// momentum SGD (the CDK: 403 MB, 0.120 ms).  The design is that traffic:
// each block streams one chunk of kChunk elements of one tensor with
// 16-byte loads, kUnroll of them in flight a thread, and nothing else
// touches device memory but the per-block partials of the norm.
//
// Arithmetic: the plain path's f32 operations in its order, each rounded on
// its own (__fmul_rn and kin: nvcc contracts no a*b+c into an FMA), so the
// new state equals the plain path's bit for bit for the same ‖g‖.  ‖g‖ is
// summed in another order than PyTorch's norms, so it, and the clip scale
// where a clip acts, may differ from the plain path in the last bits.
//
// Determinism: no float atomics.  The norm's partials are summed by one
// block in index order, and the grid is a function of the tensor sizes
// alone, so results repeat bit for bit.  The ticket (an integer atomicInc
// that wraps back to 0) is left as it was found, so a CUDA graph may
// replay the launch.
//
// Tensor lists: the launchers take host arrays of pointers and sizes and
// pass up to kMaxTensors of them by value in the kernel's parameters, one
// launch per such chunk of the list: no device table and no host-to-device
// copy, so an eager step may pass fresh gradients every call and a CUDA
// graph bakes in its pool's addresses.  The norm's chunks share one
// partial buffer and one ticket count (the blocks of all chunks), so the
// block that finishes is in the last chunk's launch.
//
// Plain C interface, as csrc/gram_kernels.cu: launch on the given stream,
// never synchronise or allocate, return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte loads a thread has in flight an array
constexpr int kChunk = kThreads * 4 * kUnroll;  // elements a block: 4096
constexpr int kMaxTensors = 32;  // tensors a launch

// kMode of apply_kernel: the rule, plus kEma where an EMA is kept
constexpr int kRmsprop = 0;
constexpr int kTrace = 1;
constexpr int kEma = 2;

struct TensorChunk {
  const float* g[kMaxTensors];
  float* p[kMaxTensors];
  float* s[kMaxTensors];  // RMSprop's ν or the trace's m
  float* e[kMaxTensors];  // the EMA, or null
  long long n[kMaxTensors];
  int first_block[kMaxTensors + 1];  // prefix sums of ceil(n / kChunk)
  int count;
};

struct Rule {
  float decay;            // α or β
  float one_minus_decay;  // 1 - α, rounded from double as PyTorch's scalar
  float eps;
  float lr;               // used where lr_ptr is null
  const float* lr_ptr;    // lr(count), the schedule's value on the device
  float ema_decay;
  const long long* step;  // the train step counter (the EMA's ramp)
  int* count;             // the schedule's count, or null
};

// The tensor of block b: the last whose first block is at most b.
__device__ __forceinline__ int tensor_of(const TensorChunk& c, int b) {
  int t = 0;
  while (t + 1 < c.count && c.first_block[t + 1] <= b) ++t;
  return t;
}

// Block-wide sums of two values, valid in thread 0: shuffles within each
// warp, then warp 0 sums the warps' shares in order.
__device__ void block_sum2(float& a, float& b) {
  __shared__ float share_a[kThreads / 32];
  __shared__ float share_b[kThreads / 32];
  for (int offset = 16; offset > 0; offset >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, offset);
    b += __shfl_down_sync(0xffffffffu, b, offset);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    share_a[warp] = a;
    share_b[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kThreads / 32 ? share_a[lane] : 0.f;
    b = lane < kThreads / 32 ? share_b[lane] : 0.f;
    for (int offset = 16; offset > 0; offset >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, offset);
      b += __shfl_down_sync(0xffffffffu, b, offset);
    }
  }
}

__device__ __forceinline__ void take(float v, float& sq, float& bad) {
  sq = fmaf(v, v, sq);
  bad += isfinite(v) ? 0.f : 1.f;
}

// grid: every block of the list's chunks of kChunk elements, this launch's
// from block0 on.  partial: 2 x total floats (squares, then non-finite
// counts), total the blocks of every launch.
__global__ void __launch_bounds__(kThreads)
    grad_norm_kernel(const TensorChunk c, int block0, int total,
                     float* __restrict__ partial, unsigned* __restrict__ ticket,
                     const float* __restrict__ loss, float clip,
                     float clip_eps, int by_entries, float* __restrict__ out,
                     unsigned char* __restrict__ skipped) {
  const int b = blockIdx.x;
  const int t = tensor_of(c, b);
  const long long start = static_cast<long long>(b - c.first_block[t]) * kChunk;
  const int m = static_cast<int>(min(static_cast<long long>(kChunk), c.n[t] - start));
  const float* __restrict__ g = c.g[t] + start;
  float sq = 0.f, bad = 0.f;
  // a chunk starts kChunk elements from the last, so g is 16-byte aligned
  // where the tensor is
  const bool vec = (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  if (vec && m == kChunk) {
    const float4* __restrict__ g4 = reinterpret_cast<const float4*>(g);
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = g4[threadIdx.x + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      take(v[u].x, sq, bad);
      take(v[u].y, sq, bad);
      take(v[u].z, sq, bad);
      take(v[u].w, sq, bad);
    }
  } else {
    for (int i = threadIdx.x; i < m; i += kThreads) take(g[i], sq, bad);
  }
  block_sum2(sq, bad);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[block0 + b] = sq;
    partial[total + block0 + b] = bad;
    __threadfence();
    last = atomicInc(ticket, total - 1) == static_cast<unsigned>(total - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  sq = 0.f;
  bad = 0.f;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    sq += __ldcg(partial + i);
    bad += __ldcg(partial + total + i);
  }
  block_sum2(sq, bad);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn(sq);
    // E4's rule: a finite loss and norm; the CDK's: every entry finite
    // (the clipped entries are then finite too, the scale lying in [0, 1])
    bool finite = by_entries ? bad == 0.f : static_cast<bool>(isfinite(norm));
    if (loss != nullptr) finite = finite && isfinite(*loss);
    // the plain path's min(1/(‖g‖ + eps) · c, 1): PyTorch takes c / x as
    // reciprocal(x) · c
    out[0] = norm;
    out[1] = clip > 0.f
                 ? fminf(__fmul_rn(__frcp_rn(__fadd_rn(norm, clip_eps)), clip), 1.f)
                 : 1.f;
    *skipped = finite ? 0 : 1;
  }
}

// One element.  p, s and e are read and written through references; on a
// skipped step p and s are left as they are.
template <int kMode>
__device__ __forceinline__ void update_one(float g, float& p, float& s, float& e,
                                           const Rule& r, float scale, float lr,
                                           float d, float one_minus_d, bool skip) {
  if (!skip) {
    g = __fmul_rn(g, scale);
    float u;
    if ((kMode & 1) == kRmsprop) {
      s = __fadd_rn(__fmul_rn(r.decay, s), __fmul_rn(__fmul_rn(r.one_minus_decay, g), g));
      u = __fdiv_rn(g, __fadd_rn(__fsqrt_rn(s), r.eps));
    } else {
      s = __fadd_rn(g, __fmul_rn(r.decay, s));
      u = s;
    }
    // the plain path adds (-lr)·u, whose rounding mirrors lr·u's
    p = __fsub_rn(p, __fmul_rn(lr, u));
  }
  if (kMode & kEma) e = __fadd_rn(__fmul_rn(d, e), __fmul_rn(one_minus_d, p));
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const TensorChunk c, const Rule r,
                 const float* __restrict__ scale_ptr,
                 const unsigned char* __restrict__ skipped, int bump_count) {
  const bool skip = *skipped != 0;
  if (bump_count && r.count != nullptr && !skip && blockIdx.x == 0 &&
      threadIdx.x == 0) {
    *r.count += 1;  // nothing else reads the count: lr(count) is in lr_ptr
  }
  const float scale = *scale_ptr;
  const float lr = r.lr_ptr != nullptr ? *r.lr_ptr : r.lr;
  float d = 0.f, one_minus_d = 0.f;
  if (kMode & kEma) {  // min(decay, (1+t)/(10+t)), as train_state.ema_decay_at
    const float t = static_cast<float>(*r.step);
    d = fminf(__fdiv_rn(__fadd_rn(t, 1.f), __fadd_rn(t, 10.f)), r.ema_decay);
    one_minus_d = __fsub_rn(1.f, d);
  }
  const int b = blockIdx.x;
  const int t = tensor_of(c, b);
  const long long start = static_cast<long long>(b - c.first_block[t]) * kChunk;
  const int m = static_cast<int>(min(static_cast<long long>(kChunk), c.n[t] - start));
  const float* __restrict__ g = c.g[t] + start;
  float* __restrict__ p = c.p[t] + start;
  float* __restrict__ s = c.s[t] + start;
  float* __restrict__ e = (kMode & kEma) ? c.e[t] + start : nullptr;
  float dummy = 0.f;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(p) |
                         reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(e);
  if ((bits & 15) == 0 && m == kChunk) {
    const float4* __restrict__ g4 = reinterpret_cast<const float4*>(g);
    float4* __restrict__ p4 = reinterpret_cast<float4*>(p);
    float4* __restrict__ s4 = reinterpret_cast<float4*>(s);
    float4* __restrict__ e4 = reinterpret_cast<float4*>(e);
    float4 gv[kUnroll], pv[kUnroll], sv[kUnroll], ev[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = threadIdx.x + u * kThreads;
      gv[u] = g4[i];
      pv[u] = p4[i];
      sv[u] = s4[i];
      if (kMode & kEma) ev[u] = e4[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      update_one<kMode>(gv[u].x, pv[u].x, sv[u].x, ev[u].x, r, scale, lr, d, one_minus_d, skip);
      update_one<kMode>(gv[u].y, pv[u].y, sv[u].y, ev[u].y, r, scale, lr, d, one_minus_d, skip);
      update_one<kMode>(gv[u].z, pv[u].z, sv[u].z, ev[u].z, r, scale, lr, d, one_minus_d, skip);
      update_one<kMode>(gv[u].w, pv[u].w, sv[u].w, ev[u].w, r, scale, lr, d, one_minus_d, skip);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (!skip) {
        p4[i] = pv[u];
        s4[i] = sv[u];
      }
      if (kMode & kEma) e4[i] = ev[u];
    }
  } else {
    for (int i = threadIdx.x; i < m; i += kThreads) {
      float pi = p[i], si = s[i];
      float& ei = (kMode & kEma) ? e[i] : dummy;
      update_one<kMode>(g[i], pi, si, ei, r, scale, lr, d, one_minus_d, skip);
      if (!skip) {
        p[i] = pi;
        s[i] = si;
      }
    }
  }
}

int blocks_of(long long n) { return static_cast<int>((n + kChunk - 1) / kChunk); }

int chunk_size(int ntensors, int first) {
  return ntensors - first < kMaxTensors ? ntensors - first : kMaxTensors;
}

// Fills ``c`` with tensors [first, first + count) of the list; returns
// their blocks.
int fill_chunk(TensorChunk& c, const float* const* g, float* const* p,
               float* const* s, float* const* e, const long long* n, int first,
               int count) {
  c.count = count;
  c.first_block[0] = 0;
  for (int i = 0; i < count; ++i) {
    c.g[i] = g[first + i];
    c.p[i] = p != nullptr ? p[first + i] : nullptr;
    c.s[i] = s != nullptr ? s[first + i] : nullptr;
    c.e[i] = e != nullptr ? e[first + i] : nullptr;
    c.n[i] = n[first + i];
    c.first_block[i + 1] = c.first_block[i] + blocks_of(n[first + i]);
  }
  return c.first_block[count];
}

}  // namespace

extern "C" {

// grads: ntensors device pointers, sizes: their element counts (each >= 1).
// partial: 2 x (sum of ceil(size / 4096)) floats of scratch, partial_len
// its length (checked); ticket: one unsigned, 0 before the first launch
// (each call leaves it 0).  loss: a float whose finiteness the step also
// requires, or null.  clip > 0: the clip scale min(c / (‖g‖ + clip_eps), 1),
// else 1.  by_entries: skip where any entry is not finite (else where the
// norm or the loss is not).  out: ‖g‖ and the scale; skipped: one byte.
int update_grad_norm(const float* const* grads, const long long* sizes,
                     int ntensors, float* partial, int partial_len,
                     unsigned* ticket, const float* loss, float clip,
                     float clip_eps, int by_entries, float* out,
                     unsigned char* skipped, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int total = 0;
  for (int i = 0; i < ntensors; ++i) {
    if (sizes[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    total += blocks_of(sizes[i]);
  }
  if (ntensors < 1 || partial_len != 2 * total) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int block0 = 0;
  for (int first = 0; first < ntensors; first += kMaxTensors) {
    TensorChunk c;
    const int blocks = fill_chunk(c, grads, nullptr, nullptr, nullptr, sizes, first,
                                  chunk_size(ntensors, first));
    grad_norm_kernel<<<blocks, kThreads, 0, st>>>(
        c, block0, total, partial, ticket, loss, clip, clip_eps, by_entries, out,
        skipped);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    block0 += blocks;
  }
  return 0;
}

// grads, params, moments (ν or m), emas (or null): ntensors device
// pointers each, sizes their element counts (each >= 1).  rule: 0 RMSprop,
// 1 the trace.  lr_ptr: lr(count) on the device, or null for the constant
// lr.  step: the train step counter, read where emas is given.  count: the
// schedule's count (int32), +1 unless the step is skipped, or null.
// scale and skipped: update_grad_norm's out[1] and skipped.
int update_apply(const float* const* grads, float* const* params,
                 float* const* moments, float* const* emas,
                 const long long* sizes, int ntensors, int rule, float decay,
                 float one_minus_decay, float eps, float lr,
                 const float* lr_ptr, float ema_decay, const long long* step,
                 int* count, const float* scale,
                 const unsigned char* skipped, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ntensors < 1 || (rule != kRmsprop && rule != kTrace) ||
      (emas != nullptr && step == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < ntensors; ++i) {
    if (sizes[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  const Rule r{decay, one_minus_decay, eps, lr, lr_ptr, ema_decay, step, count};
  const int mode = rule + (emas != nullptr ? kEma : 0);
  for (int first = 0; first < ntensors; first += kMaxTensors) {
    TensorChunk c;
    const int blocks = fill_chunk(c, grads, params, moments, emas, sizes, first,
                                  chunk_size(ntensors, first));
    const int bump = first == 0;
    if (mode == kRmsprop) {
      apply_kernel<0><<<blocks, kThreads, 0, st>>>(c, r, scale, skipped, bump);
    } else if (mode == kTrace) {
      apply_kernel<1><<<blocks, kThreads, 0, st>>>(c, r, scale, skipped, bump);
    } else if (mode == kRmsprop + kEma) {
      apply_kernel<2><<<blocks, kThreads, 0, st>>>(c, r, scale, skipped, bump);
    } else {
      apply_kernel<3><<<blocks, kThreads, 0, st>>>(c, r, scale, skipped, bump);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
