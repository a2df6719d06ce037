// A CPU stand-in for the CUDA runtime, enough to run the kernels of
// neuralsvd_tpu_torch/csrc/gram_kernels.cu and update_kernels.cu on the
// host for tests/test_torch_kernel_emulation.py and
// tests/test_torch_fused_update.py.
//
// A launch runs its blocks one after another, in grid order or, with
// emu_reverse = 1, in reverse (so the block that draws a kernel's last
// ticket is a different one); a block's threads are host threads;
// __syncthreads is a barrier of the block, __shfl_down_sync one of the
// warp.  cp.async copies run at once (emu_defer = 0) or at the wait that
// must see them (emu_defer = 1), so a stage read before its wait, or
// written while another warp still reads it, gives wrong sums in one of
// the two modes.  A copy from or to a misaligned address counts in
// emu_faults.  Integer atomics take a lock; __threadfence is a full fence.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 {
  unsigned x, y, z;
};
struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
using std::isfinite;
using std::min;

// IEEE round-to-nearest operations, one rounding each (the tests compile
// with -ffp-contract=off, so nothing is fused into an FMA)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __frcp_rn(float a) { return 1.f / a; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }

inline thread_local uint3 threadIdx;
inline uint3 blockIdx;
inline dim3 gridDim, blockDim;

extern "C" {
int emu_defer = 0;
int emu_reverse = 0;
int emu_faults = 0;
}

inline std::barrier<>* emu_block_barrier;
inline std::barrier<>* emu_warp_barrier[32];
inline float emu_lanes[1024];

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }

inline std::mutex emu_atomic_mutex;

inline unsigned atomicInc(unsigned* address, unsigned val) {
  std::lock_guard<std::mutex> lock(emu_atomic_mutex);
  const unsigned old = *address;
  *address = old >= val ? 0u : old + 1u;
  return old;
}

inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }

inline float __ldcg(const float* p) { return *p; }

inline float __shfl_down_sync(unsigned, float v, int offset) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  std::barrier<>* warp = emu_warp_barrier[t >> 5];
  emu_lanes[t] = v;
  warp->arrive_and_wait();
  const float r = lane + offset < 32 ? emu_lanes[t + offset] : v;
  warp->arrive_and_wait();
  return r;
}

struct EmuCopy {
  float* dst;
  const float* src;
  int bytes;
  bool ok;
};
inline thread_local std::vector<std::vector<EmuCopy>> emu_groups;
inline thread_local std::vector<EmuCopy> emu_open;
inline std::atomic<int> emu_fault_count{0};

inline void emu_do_copy(const EmuCopy& c) {
  if (reinterpret_cast<uintptr_t>(c.dst) % c.bytes != 0 ||
      (c.ok && reinterpret_cast<uintptr_t>(c.src) % c.bytes != 0)) {
    ++emu_fault_count;
    return;
  }
  if (c.ok) {
    std::memcpy(c.dst, c.src, c.bytes);
  } else {
    std::memset(c.dst, 0, c.bytes);
  }
}

template <int kBytes>
inline void cp_async_zfill(float* smem, const float* src, bool ok) {
  const EmuCopy c{smem, src, kBytes, ok};
  if (emu_defer) {
    emu_open.push_back(c);
  } else {
    emu_do_copy(c);
  }
}

inline void cp_async_commit() {
  if (emu_defer) {
    emu_groups.push_back(emu_open);
    emu_open.clear();
  }
}

template <int kPending>
inline void cp_async_wait() {
  while (static_cast<int>(emu_groups.size()) > kPending) {
    for (const EmuCopy& c : emu_groups.front()) emu_do_copy(c);
    emu_groups.erase(emu_groups.begin());
  }
}

// Runs the grid block by block (in reverse when emu_reverse is set), each
// block's threads at once: the same host threads serve every block.
inline void emu_launch(dim3 grid, int threads,
                       const std::function<void()>& body) {
  gridDim = grid;
  blockDim = dim3(threads);
  std::vector<uint3> order;
  for (unsigned z = 0; z < grid.z; ++z) {
    for (unsigned y = 0; y < grid.y; ++y) {
      for (unsigned x = 0; x < grid.x; ++x) order.push_back({x, y, z});
    }
  }
  if (emu_reverse) std::reverse(order.begin(), order.end());
  size_t next = 0;
  auto advance = [&]() noexcept { blockIdx = order[next++]; };
  std::barrier<decltype(advance)> gate(threads, advance);
  std::barrier<> block(threads);
  emu_block_barrier = &block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  for (int w = 0; w < threads / 32; ++w) {
    warps.emplace_back(new std::barrier<>(32));
    emu_warp_barrier[w] = warps.back().get();
  }
  std::vector<std::thread> team;
  for (int t = 0; t < threads; ++t) {
    team.emplace_back([&, t] {
      threadIdx = {static_cast<unsigned>(t), 0, 0};
      for (size_t i = 0; i < order.size(); ++i) {
        gate.arrive_and_wait();  // the last thread to arrive sets blockIdx
        emu_groups.clear();
        emu_open.clear();
        body();
      }
    });
  }
  for (std::thread& th : team) th.join();
  emu_faults = emu_fault_count.load();
}
