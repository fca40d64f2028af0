// A stand-in for the CUDA runtime header, for running a kernel source of
// the port on the CPU in tests (see emu.cpp): the qualifiers compile away,
// the thread and block indices are globals set for the running thread,
// and the intrinsics and runtime calls a kernel uses are declared here and
// defined in emu.cpp.
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(x)
struct uint3_ { unsigned x, y, z; };
extern uint3_ threadIdx, blockIdx;   // the running fiber's (emu.cpp)
extern uint3_ blockDim, gridDim;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
float __shfl_xor_sync(unsigned mask, float v, int lane_mask);
int __shfl_xor_sync(unsigned mask, int v, int lane_mask);
unsigned __ballot_sync(unsigned mask, int predicate);
void __syncwarp(unsigned mask = 0xffffffffu);
void __syncthreads();
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
// f32 arithmetic rounded once (the host compiles no FMA without -mfma)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
// the calling thread's block: its dynamic shared memory, and the same
// byte of block `rank` of its cluster
void* emu_shared();
void* emu_map_shared(const void* p, unsigned rank);
unsigned emu_block_rank();
void emu_cluster_sync();

// cudaLaunchKernelEx and its configuration: the cluster dimension is the
// one attribute read (defined in emu.cpp)
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
  struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes = 0;
  cudaStream_t stream = nullptr;
  cudaLaunchAttribute* attrs = nullptr;
  unsigned numAttrs = 0;
};
template <class... Exp, class... Act>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(Exp...), Act&&... args);
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = 1;
  return 0;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, F,
                                           const cudaLaunchConfig_t*) {
  *n = 1;
  return 0;
}
