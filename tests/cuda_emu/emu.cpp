// Runs a kernel source of the port on the CPU: one std::thread per CUDA
// thread; the blocks of a thread-block cluster at once (a launch without
// a cluster attribute: one block at a time), each with its own dynamic
// shared memory (filled with NaN bytes at the start, as the card leaves
// it unset); a barrier per block for __syncthreads, per cluster for
// cluster.sync(), and a warp-wide exchange for __shfl_xor_sync.  The
// source is included as KERNEL_INC with its <<<grid, threads, smem,
// stream>>> launches rewritten as emu_launch(grid, threads, smem, stream,
// kernel, args...) and its `extern __shared__` array as a pointer to
// emu_shared() (see tests/test_torch_scan_bwd_emulated.py);
// cudaLaunchKernelEx takes the cluster dimension from its attributes.  For
// small shapes only: it checks what a kernel computes, not how fast.
#include <barrier>
#include <deque>
#include <memory>
#include <thread>
#include <vector>

#include "cuda_runtime.h"
#include "cuda_bf16.h"
#include "hopper.cuh"

thread_local uint3_ threadIdx, blockIdx;
uint3_ blockDim, gridDim;

namespace {

struct Block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<float> slots;
  std::vector<uint4> smem;
};

struct Cluster {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<Block*> blocks;
};

struct Copy {
  char* dst;
  const char* src;
  int bytes, size;
};

thread_local Block* t_block = nullptr;
thread_local Cluster* t_cluster = nullptr;
thread_local unsigned t_rank = 0;
thread_local std::vector<Copy> t_open;             // not yet committed
thread_local std::deque<std::vector<Copy>> t_groups;

// Runs grid (in clusters of cluster_x blocks along x) with `call` as the
// body of every thread.
template <class F>
void run_grid(dim3 grid, int threads, size_t smem_bytes, unsigned cluster_x,
              F call) {
  gridDim = {grid.x, grid.y, grid.z};
  blockDim = {(unsigned)threads, 1, 1};
  if (cluster_x < 1) cluster_x = 1;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx0 = 0; bx0 < grid.x; bx0 += cluster_x) {
      std::vector<std::unique_ptr<Block>> blocks;
      Cluster cluster;
      cluster.bar = std::make_unique<std::barrier<>>(cluster_x * threads);
      for (unsigned k = 0; k < cluster_x; ++k) {
        auto blk = std::make_unique<Block>();
        blk->bar = std::make_unique<std::barrier<>>(threads);
        for (int w = 0; w * 32 < threads; ++w)
          blk->warps.push_back(std::make_unique<std::barrier<>>(
              std::min(32, threads - 32 * w)));
        blk->slots.resize(threads);
        blk->smem.resize((smem_bytes + 15) / 16);
        memset(blk->smem.data(), 0xff, blk->smem.size() * 16);
        cluster.blocks.push_back(blk.get());
        blocks.push_back(std::move(blk));
      }
      std::vector<std::thread> pool;
      for (unsigned k = 0; k < cluster_x; ++k)
        for (int t = 0; t < threads; ++t)
          pool.emplace_back([&, k, t] {
            threadIdx = {(unsigned)t, 0, 0};
            blockIdx = {bx0 + k, by, 0};
            t_block = cluster.blocks[k];
            t_cluster = &cluster;
            t_rank = k;
            call();
          });
      for (auto& th : pool) th.join();
    }
}

}  // namespace

void __syncthreads() { t_block->bar->arrive_and_wait(); }

float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int t = threadIdx.x, w = t / 32;
  t_block->slots[t] = v;
  t_block->warps[w]->arrive_and_wait();
  const float r = t_block->slots[(t & ~31) | ((t & 31) ^ lane_mask)];
  t_block->warps[w]->arrive_and_wait();
  return r;
}

void* emu_shared() { return t_block->smem.data(); }

void* emu_map_shared(const void* p, unsigned rank) {
  const ptrdiff_t off =
      static_cast<const char*>(p) -
      reinterpret_cast<const char*>(t_block->smem.data());
  return reinterpret_cast<char*>(t_cluster->blocks.at(rank)->smem.data()) +
         off;
}

unsigned emu_block_rank() { return t_rank; }

void emu_cluster_sync() { t_cluster->bar->arrive_and_wait(); }

namespace hopper {
uint32_t smem_u32(const void* p) {
  return (uint32_t)(static_cast<const char*>(p) -
                    reinterpret_cast<const char*>(emu_shared()));
}
void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  t_open.push_back({static_cast<char*>(emu_shared()) + dst,
                    static_cast<const char*>(src), src_bytes, 16});
}
void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
  t_open.push_back({static_cast<char*>(emu_shared()) + dst,
                    static_cast<const char*>(src), src_bytes, 4});
}
void cp_async_commit() {
  t_groups.push_back(std::move(t_open));
  t_open.clear();
}
void emu_cp_async_wait(int pending) {
  while ((int)t_groups.size() > pending) {
    for (const Copy& c : t_groups.front()) {
      memcpy(c.dst, c.src, c.bytes);
      memset(c.dst + c.bytes, 0, c.size - c.bytes);
    }
    t_groups.pop_front();
  }
}
}  // namespace hopper

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
void emu_launch(dim3 grid, int threads, size_t smem, cudaStream_t, F kernel,
                A... args) {
  run_grid(grid, threads, smem, 1, [=] { kernel(args...); });
}

template <class... Exp, class... Act>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(Exp...), Act&&... args) {
  unsigned cx = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cx = cfg->attrs[i].val.clusterDim.x;
  if (cfg->gridDim.x % cx != 0) return cudaErrorInvalidValue;
  auto call = [kernel](Exp... a) { kernel(a...); };
  run_grid(cfg->gridDim, (int)cfg->blockDim.x, cfg->dynamicSmemBytes, cx,
           [&] { call(args...); });
  return cudaSuccess;
}

#include KERNEL_INC
