// Mamba-1 selective scan (forward), for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/selective_scan.py
// `_scan_kernel` (wrapper `selective_scan`):
//     h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
//     y_t = sum_n h_t[n] * C_t[n] + D * x_t
// with x, dt (B, S, Di), A (Di, N) f32, B, C (B, S, N), D (Di,) f32, y in
// x's dtype and all math in f32 (`expf`, not the approximate `__expf`).
// The recurrence runs in time order, as the TPU kernel's: each state's
// sequence of roundings is the reference's; only the sum over n in y is
// taken in another order (over lanes by shuffles).
//
// What bounds it on this card: per (batch, channel, step, state) one
// exponential and ~5 f32 operations, against a few bytes per (batch,
// channel, step): at the model's shapes (B=2, S=4096, Di=8192, N=16) the
// bytes take ~0.12 ms at the memory rate and the f32 operations about as
// long, but the instruction issue of an accurate `expf` (~8 instructions
// beside its SFU op) and of the state update sets the real floor at a
// few tenths of a millisecond.  The S steps of one state are a chain, so
// the kernel needs many independent chains in flight and must never wait
// on device memory inside one.
//
// Design: a channel's N states are spread over L lanes of a warp, 4 states
// a lane (L = 1, 2, 4, 8, 16 for N up to 4, 8, 16, 32, 64), so a block of
// 128 threads covers 128 / L channels of one batch row; y is the sum of
// the lanes' partial sums, reduced by log2(L) xor-shuffles. At the model's
// shape that is 512 blocks of 4 warps, all resident at once (~16 warps per
// SM, 4 independent exponential chains per thread), against 4 warps per SM
// with one thread per channel.  The time axis goes in runs of RUN steps
// through a double buffer in shared memory: while a run is walked, the
// next run's x, dt (16-byte `cp.async` along the channel axis) and B, C
// (16-byte `cp.async` along the state axis) are in flight; y goes to a
// shared run buffer and leaves in 16-byte stores after the run.  A bf16
// run is converted to f32 in shared memory once (each B, C value is read
// by 128 / L channels, each x, dt by L lanes). The walk takes steps in
// unrolled groups of UNROLL with no branch (the states n >= N see A = B =
// C = 0), so the compiler interleaves a group's 4 x UNROLL exponentials;
// only h carries from step to step.  Shapes whose rows are not 16-byte
// multiples (Di or N not a multiple of 16 bytes' worth of elements) or
// whose bases are not 16-byte aligned take element copies and stores
// instead, in the same kernel.  Any S and Di: the ragged channel block and
// the last run are masked.  Nothing carries between blocks: the TPU's
// sequential chunk grid and its VMEM carry become the loop over runs
// inside the block.
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int THREADS = 128;
constexpr int RUN = 64;       // time steps per staged run
constexpr int NPER = 4;       // states per lane
constexpr int UNROLL = 4;     // time steps per unrolled group

__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int L>
struct Cfg {
  static constexpr int NMAX = L * NPER;        // state row in shared memory
  static constexpr int CB = THREADS / L;       // channels per block
  static constexpr int E = 16 / sizeof(T);     // elements per 16 bytes
  static constexpr int XT = RUN * CB;          // one run of x (or dt, y)
  static constexpr int BT = RUN * NMAX;        // one run of B (or C)
  // bf16 runs are converted to f32 once: x, dt, B, C in f32
  static constexpr int F32_BYTES =
      std::is_same<T, float>::value ? 0 : (2 * XT + 2 * BT) * 4;
  // + x, dt, B, C double-buffered as loaded, + y once
  static constexpr int SMEM =
      F32_BYTES + (2 * (2 * XT + 2 * BT) + XT) * sizeof(T);
  static_assert(CB % E == 0, "a channel block is whole 16-byte chunks");
};

// Start copying run [t0, t0 + len) of x, dt (channels d0..d0+CB-1 below
// Di) and of B, C into one buffer.
template <typename T, int L>
__device__ __forceinline__ void stage_run(
    T* xs, T* dts, T* bs, T* cs, const T* x, const T* dt, const T* Bc,
    const T* Cc, int b, int t0, int len, int S, int Di, int N, int d0,
    bool vec_x, bool vec_bc) {
  using C = Cfg<T, L>;
  if (vec_x) {                   // Di % E == 0: chunks are all in or out
    constexpr int CPR = C::CB / C::E;
    for (int idx = threadIdx.x; idx < len * CPR; idx += THREADS) {
      const int i = idx / CPR, c = idx % CPR, d = d0 + c * C::E;
      if (d < Di) {
        const int64_t gi = ((int64_t)b * S + t0 + i) * Di + d;
        cp_async_16(smem_u32(xs + i * C::CB + c * C::E), x + gi, 16);
        cp_async_16(smem_u32(dts + i * C::CB + c * C::E), dt + gi, 16);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < len * C::CB; idx += THREADS) {
      const int i = idx / C::CB, c = idx % C::CB, d = d0 + c;
      if (d < Di) {
        const int64_t gi = ((int64_t)b * S + t0 + i) * Di + d;
        xs[i * C::CB + c] = x[gi];
        dts[i * C::CB + c] = dt[gi];
      }
    }
  }
  const int64_t g0 = ((int64_t)b * S + t0) * N;
  if (vec_bc) {                  // N % E == 0
    const int cpr = N / C::E;
    for (int idx = threadIdx.x; idx < len * cpr; idx += THREADS) {
      const int i = idx / cpr, c = idx % cpr;
      const int64_t gi = g0 + (int64_t)i * N + c * C::E;
      cp_async_16(smem_u32(bs + i * C::NMAX + c * C::E), Bc + gi, 16);
      cp_async_16(smem_u32(cs + i * C::NMAX + c * C::E), Cc + gi, 16);
    }
  } else {
    for (int idx = threadIdx.x; idx < len * N; idx += THREADS) {
      const int i = idx / N, n = idx % N;
      bs[i * C::NMAX + n] = Bc[g0 + idx];
      cs[i * C::NMAX + n] = Cc[g0 + idx];
    }
  }
}

template <typename T, int L>
__global__ void __launch_bounds__(THREADS)
ssm_scan_fwd(const T* __restrict__ x, const T* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ Bc,
             const T* __restrict__ Cc, const float* __restrict__ Dskip,
             T* __restrict__ y, int S, int Di, int N, int vec_x,
             int vec_bc) {
  using C = Cfg<T, L>;
  constexpr bool WIDE = !std::is_same<T, float>::value;   // convert runs
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // f32 runs (bf16 input only), then the raw double buffers, then y
  float* const xf = reinterpret_cast<float*>(smem_raw);
  float* const dtf = xf + C::XT;
  float* const bf = dtf + C::XT;
  float* const cf = bf + C::BT;
  T* const raw = reinterpret_cast<T*>(smem_raw + C::F32_BYTES);
  constexpr int RAW = 2 * C::XT + 2 * C::BT;   // one buffer: x, dt, B, C
  T* const ys = raw + 2 * RAW;

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * C::CB;
  const int ch = threadIdx.x / L;              // channel in the block
  const int sub = threadIdx.x % L;             // lane in the channel's L
  const int d = d0 + ch;
  const bool live = d < Di;

  float a[NPER], h[NPER];
#pragma unroll
  for (int j = 0; j < NPER; ++j) {
    const int n = sub * NPER + j;
    a[j] = (live && n < N) ? A[(int64_t)d * N + n] : 0.f;
    h[j] = 0.f;
  }
  const float dsk = live ? Dskip[d] : 0.f;

  // Zero shared memory once: the copies never write the states n >= N of
  // a B, C row or the channels d >= Di of an x, dt row, so those stay 0
  // and, with a = 0 and D = 0 there, the walk below needs no per-state
  // branch (a branch would split each step into blocks the compiler
  // cannot interleave).
  for (int i = threadIdx.x; i < C::SMEM / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  auto stage = [&](int buf, int t0) {
    T* base = raw + buf * RAW;
    stage_run<T, L>(base, base + C::XT, base + 2 * C::XT,
                    base + 2 * C::XT + C::BT, x, dt, Bc, Cc, b, t0,
                    min(RUN, S - t0), S, Di, N, d0, vec_x, vec_bc);
    cp_async_commit();
  };
  stage(0, 0);
  for (int r = 0, t0 = 0; t0 < S; ++r, t0 += RUN) {
    const int len = min(RUN, S - t0);
    const T* cur = raw + (r & 1) * RAW;
    cp_async_wait<0>();
    __syncthreads();             // run r in place, run r-1 consumed
    if (t0 + RUN < S) stage((r + 1) & 1, t0 + RUN);
    const float *xw, *dtw, *bw, *cw;
    if constexpr (WIDE) {
      // each x, dt is read by L lanes and each B, C by 128 / L channels:
      // convert the run to f32 once
      for (int idx = threadIdx.x; idx < len * C::CB; idx += THREADS) {
        xf[idx] = to_f(cur[idx]);
        dtf[idx] = to_f(cur[C::XT + idx]);
      }
      for (int idx = threadIdx.x; idx < len * C::NMAX; idx += THREADS) {
        bf[idx] = to_f(cur[2 * C::XT + idx]);
        cf[idx] = to_f(cur[2 * C::XT + C::BT + idx]);
      }
      __syncthreads();
      xw = xf; dtw = dtf; bw = bf; cw = cf;
    } else {
      xw = cur; dtw = cur + C::XT; bw = cur + 2 * C::XT;
      cw = cur + 2 * C::XT + C::BT;
    }
    bw += sub * NPER;
    cw += sub * NPER;
    auto step = [&](int i) {
      const float xt = xw[i * C::CB + ch];
      const float dtt = dtw[i * C::CB + ch];
      const float dbx = dtt * xt;
      const float4 bq = *reinterpret_cast<const float4*>(bw + i * C::NMAX);
      const float4 cq = *reinterpret_cast<const float4*>(cw + i * C::NMAX);
      const float bv[NPER] = {bq.x, bq.y, bq.z, bq.w};
      const float cv[NPER] = {cq.x, cq.y, cq.z, cq.w};
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NPER; ++j) {   // states n >= N: a = B = C = 0
        h[j] = expf(dtt * a[j]) * h[j] + dbx * bv[j];
        acc += h[j] * cv[j];
      }
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (sub == 0) ys[i * C::CB + ch] = from_f<T>(acc + dsk * xt);
    };
    // steps in groups of UNROLL: only h carries from step to step, so
    // the loads, exponentials and y sums of a group overlap
    int i = 0;
    for (; i + UNROLL <= len; i += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) step(i + u);
    }
    for (; i < len; ++i) step(i);
    __syncthreads();             // the run's y is complete
    if (vec_x) {
      constexpr int CPR = C::CB / C::E;
      for (int idx = threadIdx.x; idx < len * CPR; idx += THREADS) {
        const int i = idx / CPR, c = idx % CPR, dd = d0 + c * C::E;
        if (dd < Di)
          *reinterpret_cast<uint4*>(y + ((int64_t)b * S + t0 + i) * Di + dd) =
              *reinterpret_cast<const uint4*>(ys + i * C::CB + c * C::E);
      }
    } else {
      for (int idx = threadIdx.x; idx < len * C::CB; idx += THREADS) {
        const int i = idx / C::CB, c = idx % C::CB, dd = d0 + c;
        if (dd < Di) y[((int64_t)b * S + t0 + i) * Di + dd] = ys[idx];
      }
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <typename T, int L>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const void* Bc, const void* Cc, const float* D, void* y,
                   int B, int S, int Di, int N, cudaStream_t stream) {
  using C = Cfg<T, L>;
  const int vec_x = Di % C::E == 0 && aligned16(x) && aligned16(dt)
                    && aligned16(y);
  const int vec_bc = N % C::E == 0 && aligned16(Bc) && aligned16(Cc);
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_fwd<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Di + C::CB - 1) / C::CB, B);
  ssm_scan_fwd<T, L><<<grid, THREADS, C::SMEM, stream>>>(
      (const T*)x, (const T*)dt, A, (const T*)Bc, (const T*)Cc, D, (T*)y,
      S, Di, N, vec_x, vec_bc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const void* x, const void* dt, const float* A,
                       const void* Bc, const void* Cc, const float* D,
                       void* y, int B, int S, int Di, int N,
                       cudaStream_t stream) {
  if (N <= 4) return launch<T, 1>(x, dt, A, Bc, Cc, D, y, B, S, Di, N, stream);
  if (N <= 8) return launch<T, 2>(x, dt, A, Bc, Cc, D, y, B, S, Di, N, stream);
  if (N <= 16)
    return launch<T, 4>(x, dt, A, Bc, Cc, D, y, B, S, Di, N, stream);
  if (N <= 32)
    return launch<T, 8>(x, dt, A, Bc, Cc, D, y, B, S, Di, N, stream);
  if (N <= 64)
    return launch<T, 16>(x, dt, A, Bc, Cc, D, y, B, S, Di, N, stream);
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
