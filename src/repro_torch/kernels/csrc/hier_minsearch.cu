// Two-stage hierarchical min-search task mapping (paper Sec 4.1) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/hier_minsearch.py:
// _assign_kernel.  For t = 0..T-1, in order: stage 1 picks the cluster c
// with the least row sum of the (k, m/k) load matrix, stage 2 the unit p
// with the least load inside row c, then loads[c, p] += costs[t].  Ties
// go to the lowest index, as jnp.argmin / torch.argmin break them.
//
// What bounds it: nothing the card's peaks describe.  The work is a
// chain of T dependent decisions over a tiny matrix (1 KB at m = 256):
// (2*k*m/k + 3*T)*4 bytes is about 1 ns at 3.35 TB/s, and the arithmetic
// about as little.  The time is launch latency plus the latency of T
// rounds of block reductions and barriers.  The design keeps the whole
// chain in one launch of one block: the matrix lives in shared memory
// for all T steps, and only costs[t] and assign[t] touch device memory.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): 0.147 ms at
// m=256, k=16, T=100, about 1.5 us per decision.
//
// Row sums are recomputed every step, left to right, as the reference
// recomputes loads.sum(axis=1); carrying incremental sums would round
// differently in f32 and flip near-ties.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void better(float v, int i, float& bv, int& bi) {
  // (value, index) order: smaller value wins, ties to the lower index
  if (v < bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__device__ __forceinline__ void warp_argmin(float& bv, int& bi) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    better(ov, oi, bv, bi);
  }
}

// Index of the least of vals[0..n) over the whole block; every thread
// returns it.  Starts from (+inf, INT_MAX) so an all-inf input still
// yields index 0, as argmin does.
__device__ int block_argmin(const float* vals, int n, float* s_val,
                            int* s_idx) {
  float bv = INFINITY;
  int bi = INT_MAX;
  for (int i = threadIdx.x; i < n; i += kThreads) better(vals[i], i, bv, bi);
  warp_argmin(bv, bi);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_val[warp] = bv;
    s_idx[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < kWarps ? s_val[lane] : INFINITY;
    bi = lane < kWarps ? s_idx[lane] : INT_MAX;
    warp_argmin(bv, bi);
    if (lane == 0) s_idx[kWarps] = bi;
  }
  __syncthreads();
  const int r = s_idx[kWarps];
  __syncthreads();  // s_val/s_idx are reused by the next call
  return r;
}

__global__ void __launch_bounds__(kThreads)
    assign_kernel(const float* __restrict__ loads_in,
                  const float* __restrict__ costs, int k, int mpk, int n_tasks,
                  int* __restrict__ assign, float* __restrict__ loads_out) {
  extern __shared__ float smem[];
  float* loads = smem;                   // k * mpk
  float* rowsum = loads + k * mpk;       // k
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps + 1];

  const int n = k * mpk;
  for (int i = threadIdx.x; i < n; i += kThreads) loads[i] = loads_in[i];
  __syncthreads();

  for (int t = 0; t < n_tasks; ++t) {
    // stage 1: row sums, each summed left to right by one thread
    for (int r = threadIdx.x; r < k; r += kThreads) {
      float s = 0.0f;
      const float* row = loads + r * mpk;
      for (int j = 0; j < mpk; ++j) s += row[j];
      rowsum[r] = s;
    }
    __syncthreads();
    const int c = block_argmin(rowsum, k, s_val, s_idx);
    // stage 2: least-loaded unit inside cluster c
    const int p = block_argmin(loads + c * mpk, mpk, s_val, s_idx);
    if (threadIdx.x == 0) {
      assign[2 * t] = c;
      assign[2 * t + 1] = p;
      loads[c * mpk + p] += costs[t];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += kThreads) loads_out[i] = loads[i];
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// Map n_tasks tasks onto the (k, mpk) f32 matrix loads_in: writes the
// (n_tasks, 2) int32 assignments and the final loads.  Device pointers,
// row-major and contiguous; launched on `stream`.  Returns the launch's
// cudaError_t (0 = launched).
int hier_minsearch_assign(const void* loads_in, const void* costs,
                          void* assign, void* loads_out, int k, int mpk,
                          int n_tasks, void* stream) {
  const size_t smem = sizeof(float) * (size_t(k) * mpk + k);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
  }
  assign_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(loads_in), static_cast<const float*>(costs),
      k, mpk, n_tasks, static_cast<int*>(assign),
      static_cast<float*>(loads_out));
  return int(cudaGetLastError());
}

// An empty one-thread launch on `stream`: the practical floor under any
// single-launch kernel, timed beside the mapper.
int hier_minsearch_empty(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return int(cudaGetLastError());
}

}  // extern "C"
