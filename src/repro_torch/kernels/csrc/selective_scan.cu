// Mamba-1 selective scan (forward), for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/selective_scan.py
// `_scan_kernel` (wrapper `selective_scan`):
//     h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
//     y_t = sum_n h_t[n] * C_t[n] + D * x_t
// with x, dt (B, S, Di), A (Di, N) f32, B, C (B, S, N), D (Di,) f32, y in
// x's dtype and all math in f32 (`expf`, not the approximate `__expf`).
//
// What bounds it on this card: per (batch, channel, step) it does N
// exponentials and ~4N flops but moves only a few bytes, so the ideal
// time is the larger of the exponentials over the f32 rate and the
// bytes of x, dt, B, C and y over the memory rate; at the model's shapes
// (B=2, S=4096, Di=8192, N=16) both are a fraction of a millisecond.  The
// real limit of this design is latency: the S steps of one channel are a
// chain, so the kernel needs many channels in flight and must not wait
// on device memory inside the chain.
//
// Design: one thread per (batch, channel) holds its state h[N] in
// registers for the whole sequence — on Hopper this replaces the TPU's
// sequential chunk grid and its VMEM carry; nothing carries between
// blocks.  A block of 64 threads covers 64 channels of one batch row.
// The time axis goes in runs of CHUNK steps: the block first stages x and
// dt for the run (loads coalesced along the channel axis) and B_t, C_t
// (shared by all channels) into shared memory, with many loads in flight
// at once, then each thread walks the run from shared memory.  Any S and
// Di: ragged channel blocks and the last run are masked.  N is a template
// bound (4..64, loops guarded by the runtime N) so h stays in registers.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;   // channels per block
constexpr int CHUNK = 32;     // time steps per staged run

__device__ __forceinline__ float load_f(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i,
                                        float v) {
  p[i] = __float2bfloat16(v);
}

template <typename T, int NMAX>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bc,
            const T* __restrict__ Cc, const float* __restrict__ Dskip,
            T* __restrict__ y, int S, int Di, int N) {
  __shared__ float xs[CHUNK][THREADS];
  __shared__ float dts[CHUNK][THREADS];
  __shared__ float bs[CHUNK][NMAX];
  __shared__ float cs[CHUNK][NMAX];

  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < Di;

  float a[NMAX], h[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    a[n] = (live && n < N) ? A[(int64_t)d * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float dsk = live ? Dskip[d] : 0.f;

  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    const int len = min(CHUNK, S - t0);
    __syncthreads();                  // previous run fully consumed
#pragma unroll 8
    for (int i = 0; i < CHUNK; ++i) {
      if (i < len && live) {
        int64_t idx = ((int64_t)b * S + t0 + i) * Di + d;
        xs[i][threadIdx.x] = load_f(x, idx);
        dts[i][threadIdx.x] = load_f(dt, idx);
      }
    }
    for (int idx = threadIdx.x; idx < len * N; idx += THREADS) {
      int i = idx / N, n = idx % N;
      int64_t g = ((int64_t)b * S + t0 + i) * N + n;
      bs[i][n] = load_f(Bc, g);
      cs[i][n] = load_f(Cc, g);
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < len; ++i) {
      const float xt = xs[i][threadIdx.x];
      const float dtt = dts[i][threadIdx.x];
      const float dbx = dtt * xt;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < N) {
          h[n] = expf(dtt * a[n]) * h[n] + dbx * bs[i][n];
          acc += h[n] * cs[i][n];
        }
      }
      store_f(y, ((int64_t)b * S + t0 + i) * Di + d, acc + dsk * xt);
    }
  }
}

template <typename T, int NMAX>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const void* Bc, const void* Cc, const float* D, void* y,
                   int B, int S, int Di, int N, cudaStream_t stream) {
  dim3 grid((Di + THREADS - 1) / THREADS, B);
  scan_kernel<T, NMAX><<<grid, THREADS, 0, stream>>>(
      (const T*)x, (const T*)dt, A, (const T*)Bc, (const T*)Cc, D, (T*)y,
      S, Di, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const void* x, const void* dt, const float* A,
                       const void* Bc, const void* Cc, const float* D,
                       void* y, int B, int S, int Di, int N,
                       cudaStream_t stream) {
  if (N <= 4) return launch<T, 4>(x, dt, A, Bc, Cc, D, y, B, S, Di, N, stream);
  if (N <= 8) return launch<T, 8>(x, dt, A, Bc, Cc, D, y, B, S, Di, N, stream);
  if (N <= 16)
    return launch<T, 16>(x, dt, A, Bc, Cc, D, y, B, S, Di, N, stream);
  if (N <= 32)
    return launch<T, 32>(x, dt, A, Bc, Cc, D, y, B, S, Di, N, stream);
  if (N <= 64)
    return launch<T, 64>(x, dt, A, Bc, Cc, D, y, B, S, Di, N, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, dt, y (B, S, Di); Bc, Cc (B, S, N) in `dtype` (0 = float32,
// 1 = bfloat16); A (Di, N) and D (Di,) float32; all contiguous;
// 1 <= N <= 64.  Returns the launch's cudaError_t.
int selective_scan_fwd(const void* x, const void* dt, const void* A,
                       const void* Bc, const void* Cc, const void* D,
                       void* y, int B, int S, int Di, int N, int dtype,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch_n<float>(x, dt, (const float*)A, Bc, Cc,
                                  (const float*)D, y, B, S, Di, N, s);
  if (dtype == 1)
    return (int)dispatch_n<__nv_bfloat16>(x, dt, (const float*)A, Bc, Cc,
                                          (const float*)D, y, B, S, Di, N,
                                          s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
