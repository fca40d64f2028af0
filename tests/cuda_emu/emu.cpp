// Runs a kernel source of the port on the CPU: one std::thread per CUDA
// thread of a block, the blocks one after another, a barrier for
// __syncthreads and a warp-wide exchange for __shfl_xor_sync.  The source
// is included as KERNEL_INC with its launches rewritten as
// emu_launch(grid, threads, smem, stream, kernel, args...) (see
// tests/test_torch_scan_bwd_emulated.py); dynamic shared memory is the
// `smem` array below.  For small shapes only: it checks what a kernel
// computes, not how fast.
#include <barrier>
#include <cstring>
#include <thread>
#include <vector>

#include "cuda_runtime.h"
#include "cuda_bf16.h"

thread_local uint3_ threadIdx;
uint3_ blockIdx, blockDim, gridDim;
static std::barrier<>* g_block = nullptr;
static std::vector<std::barrier<>*> g_warps;
static float g_slots[1024];

void __syncthreads() { g_block->arrive_and_wait(); }

float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int t = threadIdx.x, w = t / 32;
  g_slots[t] = v;
  g_warps[w]->arrive_and_wait();
  const float r = g_slots[(t & ~31) | ((t & 31) ^ lane_mask)];
  g_warps[w]->arrive_and_wait();
  return r;
}

float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = (uint32_t)b.v << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

__nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  __nv_bfloat16 b;
  b.v = (unsigned short)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
  return b;
}

template <class F, class... A>
void emu_launch(dim3 grid, int threads, size_t, cudaStream_t, F kernel,
                A... args) {
  gridDim = {grid.x, grid.y, grid.z};
  blockDim = {(unsigned)threads, 1, 1};
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = {bx, by, 0};
      std::barrier<> block(threads);
      g_block = &block;
      std::vector<std::barrier<>*> warps;
      for (int w = 0; w * 32 < threads; ++w)
        warps.push_back(new std::barrier<>(std::min(32, threads - 32 * w)));
      g_warps = warps;
      std::vector<std::thread> pool;
      for (int t = 0; t < threads; ++t)
        pool.emplace_back([=] {
          threadIdx = {(unsigned)t, 0, 0};
          kernel(args...);
        });
      for (auto& th : pool) th.join();
      for (auto* w : warps) delete w;
    }
}

namespace {
alignas(16) float smem[1 << 16];   // the blocks' dynamic shared memory
}

#include KERNEL_INC
