// A stand-in for the CUDA runtime header, for running a kernel source of
// the port on the CPU in tests (see emu.cpp): the qualifiers compile away,
// the thread and block indices are per-thread globals, and the intrinsics
// a kernel uses are declared here and defined in emu.cpp.
#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__
#define __align__(x)
struct uint3_ { unsigned x, y, z; };
extern thread_local uint3_ threadIdx;
extern uint3_ blockIdx, blockDim, gridDim;
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
void __syncthreads();
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
