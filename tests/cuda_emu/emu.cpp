// Runs a kernel source of the port on the CPU: one fiber (a ucontext with
// its own stack) per CUDA thread, all on the calling OS thread; the blocks
// of a thread-block cluster at once (a launch without a cluster attribute:
// one block at a time), each with its own dynamic shared memory (filled
// with NaN bytes at the start, as the card leaves it unset); a barrier per
// block for __syncthreads, per cluster for cluster.sync(), and a warp-wide
// exchange for __shfl_xor_sync (f32 and int32) and __ballot_sync, and a
// warp barrier for __syncwarp.  A fiber runs until it waits at a barrier
// that not every participant has reached, then yields; the scheduler
// resumes the fibers in thread order, so a warp's 32 threads go through a
// shuffle together, as in lockstep.  A barrier that no thread can leave
// aborts the process.  The source is included as KERNEL_INC with its
// <<<grid, threads, smem, stream>>> launches rewritten as emu_launch(grid,
// threads, smem, stream, kernel, args...) and its `extern __shared__`
// array as a pointer to emu_shared() (see
// tests/test_torch_scan_bwd_emulated.py); cudaLaunchKernelEx takes the
// cluster dimension from its attributes.  For small shapes only: it checks
// what a kernel computes, not how fast.
#include <sys/mman.h>
#include <ucontext.h>
#include <unistd.h>

#include <cstdio>
#include <cstdlib>
#include <deque>
#include <functional>
#include <memory>
#include <vector>

#include "cuda_runtime.h"
#include "cuda_bf16.h"
#include "hopper.cuh"

uint3_ threadIdx, blockIdx;
uint3_ blockDim, gridDim;

namespace {

// A barrier of `expected` fibers: the last to arrive opens the next
// generation and runs on; the others yield until it has opened.
struct Barrier {
  int expected, arrived = 0;
  unsigned gen = 0;
  explicit Barrier(int n) : expected(n) {}
  void arrive_and_wait();
};

struct Block {
  std::unique_ptr<Barrier> bar;
  std::vector<std::unique_ptr<Barrier>> warps;
  std::vector<float> slots;
  std::vector<uint32_t> words;
  std::vector<uint4> smem;
};

struct Cluster {
  std::unique_ptr<Barrier> bar;
  std::vector<Block*> blocks;
};

struct Copy {
  char* dst;
  const char* src;
  int bytes, size;
};

constexpr size_t STACK_BYTES = 256 << 10;

// A fiber's stack, mapped with an inaccessible page at each end, so that
// a kernel overrunning its frames faults here instead of writing into the
// process's heap.
struct Stack {
  char* base;
  size_t page;
  Stack() : page((size_t)sysconf(_SC_PAGESIZE)) {
    void* p = mmap(nullptr, STACK_BYTES + 2 * page, PROT_NONE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED ||
        mprotect(static_cast<char*>(p) + page, STACK_BYTES,
                 PROT_READ | PROT_WRITE) != 0) {
      fprintf(stderr, "emu: cannot map a fiber stack\n");
      abort();
    }
    base = static_cast<char*>(p);
  }
  ~Stack() { munmap(base, STACK_BYTES + 2 * page); }
  char* bottom() const { return base + page; }
};

// One CUDA thread: its context and stack (kept for the next cluster), its
// indices and its cp.async groups.
struct Fiber {
  ucontext_t ctx;
  Stack stack;
  uint3_ tid, bid;
  Block* block;
  Cluster* cluster;
  unsigned rank;
  bool done;
  std::vector<Copy> open;                 // not yet committed
  std::deque<std::vector<Copy>> groups;
};

ucontext_t g_main;
Fiber* g_cur = nullptr;
const std::function<void()>* g_body = nullptr;
std::vector<std::unique_ptr<Fiber>> g_pool;
unsigned long g_progress = 0;             // barrier arrivals, all time

void Barrier::arrive_and_wait() {
  ++g_progress;
  const unsigned g = gen;
  if (++arrived == expected) {
    arrived = 0;
    ++gen;
    return;
  }
  while (gen == g) swapcontext(&g_cur->ctx, &g_main);
}

void trampoline() {
  (*g_body)();
  g_cur->done = true;                     // uc_link returns to g_main
}

// Runs grid (in clusters of cluster_x blocks along x) with `call` as the
// body of every thread.
void run_grid(dim3 grid, int threads, size_t smem_bytes, unsigned cluster_x,
              const std::function<void()>& call) {
  gridDim = {grid.x, grid.y, grid.z};
  blockDim = {(unsigned)threads, 1, 1};
  if (cluster_x < 1) cluster_x = 1;
  const size_t n = (size_t)cluster_x * threads;
  while (g_pool.size() < n) g_pool.push_back(std::make_unique<Fiber>());
  g_body = &call;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx0 = 0; bx0 < grid.x; bx0 += cluster_x) {
      std::vector<std::unique_ptr<Block>> blocks;
      Cluster cluster;
      cluster.bar = std::make_unique<Barrier>(cluster_x * threads);
      for (unsigned k = 0; k < cluster_x; ++k) {
        auto blk = std::make_unique<Block>();
        blk->bar = std::make_unique<Barrier>(threads);
        for (int w = 0; w * 32 < threads; ++w)
          blk->warps.push_back(
              std::make_unique<Barrier>(std::min(32, threads - 32 * w)));
        blk->slots.resize(threads);
        blk->words.resize(threads);
        blk->smem.resize((smem_bytes + 15) / 16);
        memset(blk->smem.data(), 0xff, blk->smem.size() * 16);
        cluster.blocks.push_back(blk.get());
        blocks.push_back(std::move(blk));
      }
      for (unsigned k = 0; k < cluster_x; ++k)
        for (int t = 0; t < threads; ++t) {
          Fiber& f = *g_pool[(size_t)k * threads + t];
          f.tid = {(unsigned)t, 0, 0};
          f.bid = {bx0 + k, by, 0};
          f.block = cluster.blocks[k];
          f.cluster = &cluster;
          f.rank = k;
          f.done = false;
          f.open.clear();
          f.groups.clear();
          getcontext(&f.ctx);
          f.ctx.uc_stack.ss_sp = f.stack.bottom();
          f.ctx.uc_stack.ss_size = STACK_BYTES;
          f.ctx.uc_link = &g_main;
          makecontext(&f.ctx, trampoline, 0);
        }
      for (size_t live = n; live > 0;) {
        const unsigned long before = g_progress;
        live = 0;
        for (size_t i = 0; i < n; ++i) {
          Fiber& f = *g_pool[i];
          if (f.done) continue;
          g_cur = &f;
          threadIdx = f.tid;
          blockIdx = f.bid;
          swapcontext(&g_main, &f.ctx);
          live += !f.done;
        }
        if (live > 0 && g_progress == before) {
          fprintf(stderr, "emu: every live thread waits at a barrier\n");
          abort();
        }
      }
      g_cur = nullptr;
    }
}

}  // namespace

void __syncthreads() { g_cur->block->bar->arrive_and_wait(); }

float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int t = threadIdx.x, w = t / 32;
  Block* blk = g_cur->block;
  blk->slots[t] = v;
  blk->warps[w]->arrive_and_wait();
  const float r = blk->slots[(t & ~31) | ((t & 31) ^ lane_mask)];
  blk->warps[w]->arrive_and_wait();
  return r;
}

int __shfl_xor_sync(unsigned, int v, int lane_mask) {
  const int t = threadIdx.x, w = t / 32;
  Block* blk = g_cur->block;
  blk->words[t] = (uint32_t)v;
  blk->warps[w]->arrive_and_wait();
  const int r = (int)blk->words[(t & ~31) | ((t & 31) ^ lane_mask)];
  blk->warps[w]->arrive_and_wait();
  return r;
}

unsigned __ballot_sync(unsigned, int predicate) {
  const int t = threadIdx.x, w = t / 32;
  Block* blk = g_cur->block;
  blk->words[t] = predicate != 0;
  blk->warps[w]->arrive_and_wait();
  unsigned m = 0;
  const int n = std::min(32, (int)blk->words.size() - 32 * w);
  for (int i = 0; i < n; ++i) m |= blk->words[32 * w + i] << i;
  blk->warps[w]->arrive_and_wait();
  return m;
}

void __syncwarp(unsigned) {
  g_cur->block->warps[threadIdx.x / 32]->arrive_and_wait();
}

void* emu_shared() { return g_cur->block->smem.data(); }

void* emu_map_shared(const void* p, unsigned rank) {
  const ptrdiff_t off =
      static_cast<const char*>(p) -
      reinterpret_cast<const char*>(g_cur->block->smem.data());
  return reinterpret_cast<char*>(
             g_cur->cluster->blocks.at(rank)->smem.data()) +
         off;
}

unsigned emu_block_rank() { return g_cur->rank; }

void emu_cluster_sync() { g_cur->cluster->bar->arrive_and_wait(); }

namespace hopper {
uint32_t smem_u32(const void* p) {
  return (uint32_t)(static_cast<const char*>(p) -
                    reinterpret_cast<const char*>(emu_shared()));
}
void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  g_cur->open.push_back({static_cast<char*>(emu_shared()) + dst,
                         static_cast<const char*>(src), src_bytes, 16});
}
void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
  g_cur->open.push_back({static_cast<char*>(emu_shared()) + dst,
                         static_cast<const char*>(src), src_bytes, 4});
}
void cp_async_commit() {
  g_cur->groups.push_back(std::move(g_cur->open));
  g_cur->open.clear();
}
void emu_cp_async_wait(int pending) {
  auto& groups = g_cur->groups;
  while ((int)groups.size() > pending) {
    for (const Copy& c : groups.front()) {
      memcpy(c.dst, c.src, c.bytes);
      memset(c.dst + c.bytes, 0, c.size - c.bytes);
    }
    groups.pop_front();
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
