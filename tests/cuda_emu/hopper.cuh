// A stand-in for csrc/hopper.cuh (see cuda_runtime.h): `cp.async` as a
// copy queued by the calling thread at cp_async_16 and done at the
// cp_async_wait that retires its group, so a read of a buffer before its
// wait sees what was there before.  Shared addresses are byte offsets
// into the calling thread's block's shared memory.
#pragma once
#include "cuda_bf16.h"
#include "cuda_runtime.h"
namespace hopper {
uint32_t smem_u32(const void* p);
void cp_async_16(uint32_t dst, const void* src, int src_bytes);
void cp_async_4(uint32_t dst, const void* src, int src_bytes);
void cp_async_commit();
void emu_cp_async_wait(int pending);
template <int N>
inline void cp_async_wait() { emu_cp_async_wait(N); }
}  // namespace hopper
