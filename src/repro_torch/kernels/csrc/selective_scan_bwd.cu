// Mamba-1 selective scan, backward (the VJP of csrc/selective_scan.cu), for
// sm_90a.
//
// Replaces no TPU kernel: the JAX package's Pallas scan has no VJP, and
// its gradient is XLA autodiff of `_chunked_selective_scan`
// (src/repro/kernels/ops.py:217, `jax.checkpoint` per chunk).  With
// a_t = exp(dt_t * A), h_t = a_t * h_{t-1} + dt_t * x_t * B_t, y_t =
// sum_n h_t * C_t + D * x_t and g_t = dy[b, t, d], per (b, d, n):
//     lam_t = a_{t+1} * lam_{t+1} + g_t * C_t[n]     (lam after the end: 0)
//     dx_t  = D * g_t + dt_t * sum_n lam_t * B_t[n]
//     ddt_t = sum_n lam_t * (x_t * B_t[n] + A[d, n] * a_t * h_{t-1})
//     dB_t[n] = sum_d lam_t * dt_t * x_t,   dC_t[n] = sum_d g_t * h_t
//     dA[d, n] = sum_{b,t} lam_t * dt_t * a_t * h_{t-1}
//     dD[d] = sum_{b,t} g_t * x_t
// x, dt, dy, dx, ddt (B, S, Di) and B, C, dB, dC (B, S, N) in one dtype
// (f32 or bf16); A, dA (Di, N) and D, dD (Di,) f32; all math in f32.
//
// What bounds it on this card: per (batch, channel, step, state) three
// exponentials (the checkpoint walk, the run's recomputation, the
// adjoint step) and ~20 f32 operations, against a few bytes per (batch,
// channel, step): at falcon_mamba_7b's training shape (B=4, S=2048,
// Di=8192, N=16, bf16) the bytes (x, dt, dy in; dx, ddt out: ~0.67 GB)
// take ~0.2 ms at the memory rate and the f32 operations about as long;
// the instruction issue of `expf` and of the sums over states and
// channels sets the real floor higher.  Like the forward, the S steps of
// one state are a chain.
//
// Design: the forward's lane layout (a channel's N states over L lanes of
// a warp, 4 states a lane; 128 threads take 128 / L channels of one batch
// row; grid (ceil(Di / (128 / L)), B)).  h_{t-1} is never recovered by
// dividing by a_t (which underflows to 0 for large dt * |A|): a first
// forward walk writes h at the start of every run of RUN steps to a
// checkpoint buffer in device memory ((B, Di, ceil(S / RUN), 4 L) f32,
// each thread reading back only what it wrote); then the runs are taken
// last to first: each run's h is recomputed from its checkpoint into
// shared memory (RUN steps x 4 states x 128 threads, 32 KB) and walked
// backward.  Both walks compute h with the forward's expression and
// `expf`, so their h are the forward's.  Sums over the states (dx, ddt)
// take log2(L) xor-shuffles; the sums over channels (dB, dC) are first a
// reduce-scatter over the warp's channels (each halving step sends half
// of a lane's values: 4 + 2 + 1 shuffles for 8 values over 8 channels,
// where a butterfly on each value takes 24), then a sum of the block's
// warps in shared memory after the run, written as one f32 partial per
// (b, block, t, n); dA and dD sum over t in registers and are written per
// (b, d).  A second small kernel sums the partials over the blocks (dB,
// dC) and over b (dA, dD) in a fixed order.  No atomics: two launches
// give the same bits.  Any S, Di and 1 <= N <= 64: the ragged channel
// block, the states n >= N (A = B = C = 0 there) and the last run are
// masked or zero.
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
// time steps per run: 16 keeps a block's shared memory at 52 KB for
// N <= 16, so 4 blocks share an SM (2 at 32 steps) to hide the chains'
// latency; shorter runs add checkpoint bytes (S / RUN per state)
constexpr int RUN = 16;
constexpr int NPER = 4;       // states per lane
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
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

__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v / 2);
}

template <int L>
struct Cfg {
  static constexpr int NMAX = L * NPER;        // state row
  static constexpr int CB = THREADS / L;       // channels per block
  static constexpr int XT = RUN * CB;          // one run of x (dt, dy, ...)
  static constexpr int BT = RUN * NMAX;        // one run of B (or C)
  static constexpr int HT = RUN * THREADS * NPER;   // the run's h
  static constexpr int RT = RUN * WARPS * 2 * NMAX;  // warp sums of dB, dC
  // x, dt, dy, dx, ddt; B, C; h; the warps' dB, dC sums (all f32)
  static constexpr int SMEM = (5 * XT + 2 * BT + HT + RT) * 4;
  static_assert(SMEM <= 232448, "a block's shared memory");
};

// Where the workspace's parts start (in floats): the checkpoints, the
// dB and dC partials per block, the dA and dD partials per batch row.
struct Work {
  int64_t ck, pb, pc, pa, pd, total;
};

template <int L>
Work workspace(int B, int S, int Di, int N) {
  using C = Cfg<L>;
  const int64_t nr = (S + RUN - 1) / RUN, nblk = (Di + C::CB - 1) / C::CB;
  Work w;
  w.ck = 0;
  w.pb = w.ck + (int64_t)B * Di * nr * C::NMAX;
  w.pc = w.pb + (int64_t)B * nblk * S * N;
  w.pa = w.pc + (int64_t)B * nblk * S * N;
  w.pd = w.pa + (int64_t)B * Di * N;
  w.total = w.pd + (int64_t)B * Di;
  return w;
}

// Sum v[0..7] (4 dB then 4 dC values of the lane's states) over the
// warp's channels (the lane bits log2(L)..4): halving steps on the top
// channel bits, each keeping one half of the values and adding the
// partner's copy of it, then xor-adds on the channel bits left.  Writes
// each sum once to red[kind * NMAX + n] (kind 0: dB, 1: dC).
template <int L>
__device__ __forceinline__ void channel_sums(float (&v)[2 * NPER],
                                             float* red, int lane,
                                             int sub) {
  constexpr int CBITS = 5 - log2i(L);
  constexpr int HALV = CBITS < 3 ? CBITS : 3;
  constexpr int K = (2 * NPER) >> HALV;        // values a lane keeps
  int base = 0;
#pragma unroll
  for (int s = 0; s < HALV; ++s) {
    const int o = 16 >> s;
    const int half = NPER >> s;
    const bool up = lane & o;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float send = up ? v[k] : v[k + half];
      const float keep = up ? v[k + half] : v[k];
      v[k] = keep + __shfl_xor_sync(FULL, send, o);
    }
    if (up) base += half;
  }
#pragma unroll
  for (int s = HALV; s < CBITS; ++s)
    v[0] += __shfl_xor_sync(FULL, v[0], 16 >> s);
  // the lanes that differ only in the xor-added bits hold the same sums
  constexpr int COPIES = ((16 >> (HALV - 1)) - 1) & ~(L - 1);
  if ((lane & COPIES) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int idx = base + k;
      red[(idx >> 2) * Cfg<L>::NMAX + sub * NPER + (idx & 3)] = v[k];
    }
  }
}

template <typename T, int L>
__global__ void __launch_bounds__(THREADS)
ssm_scan_bwd(const T* __restrict__ x, const T* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ Bc,
             const T* __restrict__ Cc, const float* __restrict__ Dskip,
             const T* __restrict__ dy, T* __restrict__ dx,
             T* __restrict__ ddt, float* __restrict__ ws, Work w, int S,
             int Di, int N) {
  using C = Cfg<L>;
  extern __shared__ __align__(16) float smem[];
  float* const xs = smem;
  float* const dts = xs + C::XT;
  float* const dys = dts + C::XT;
  float* const dxs = dys + C::XT;
  float* const ddts = dxs + C::XT;
  float* const bs = ddts + C::XT;
  float* const cs = bs + C::BT;
  float* const hs = cs + C::BT;
  float* const red = hs + C::HT;

  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int d0 = blk * C::CB;
  const int ch = threadIdx.x / L;              // channel in the block
  const int sub = threadIdx.x % L;             // lane in the channel's L
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int d = d0 + ch;
  const bool live = d < Di;
  const int nr = (S + RUN - 1) / RUN;

  float a[NPER];
#pragma unroll
  for (int j = 0; j < NPER; ++j) {
    const int n = sub * NPER + j;
    a[j] = (live && n < N) ? A[(int64_t)d * N + n] : 0.f;
  }
  const float dsk = live ? Dskip[d] : 0.f;
  float* const ck = ws + w.ck + ((int64_t)b * Di + d) * nr * C::NMAX
                    + sub * NPER;

  // stage run [t0, t0 + len) in f32: x, dt (and dy, C with `grad`), B;
  // channels d >= Di and states n >= N read as 0
  auto stage = [&](int t0, int len, bool grad) {
    for (int idx = threadIdx.x; idx < len * C::CB; idx += THREADS) {
      const int i = idx / C::CB, dd = d0 + idx % C::CB;
      const int64_t gi = ((int64_t)b * S + t0 + i) * Di + dd;
      const bool in = dd < Di;
      xs[idx] = in ? to_f(x[gi]) : 0.f;
      dts[idx] = in ? to_f(dt[gi]) : 0.f;
      if (grad) dys[idx] = in ? to_f(dy[gi]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < len * C::NMAX; idx += THREADS) {
      const int i = idx / C::NMAX, n = idx % C::NMAX;
      const int64_t gi = ((int64_t)b * S + t0 + i) * N + n;
      const bool in = n < N;
      bs[idx] = in ? to_f(Bc[gi]) : 0.f;
      if (grad) cs[idx] = in ? to_f(Cc[gi]) : 0.f;
    }
  };
  // one forward step of the lane's states, the forward kernel's
  // expression (states n >= N: a = B = 0, so h stays 0)
  auto fwd_step = [&](float (&h)[NPER], int i) {
    const float xt = xs[i * C::CB + ch];
    const float dtt = dts[i * C::CB + ch];
    const float dbx = dtt * xt;
    const float4 bq =
        *reinterpret_cast<const float4*>(bs + i * C::NMAX + sub * NPER);
    const float bv[NPER] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
    for (int j = 0; j < NPER; ++j)
      h[j] = expf(dtt * a[j]) * h[j] + dbx * bv[j];
  };

  // 1. forward walk: h at the start of every run
  {
    float h[NPER] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < nr; ++r) {
      if (live)
        *reinterpret_cast<float4*>(ck + (int64_t)r * C::NMAX) =
            make_float4(h[0], h[1], h[2], h[3]);
      if (r + 1 == nr) break;       // the last run is recomputed below
      __syncthreads();              // the previous run is consumed
      stage(r * RUN, RUN, false);
      __syncthreads();
      for (int i = 0; i < RUN; ++i) fwd_step(h, i);
    }
  }

  // 2. the runs last to first: recompute h, then walk back
  float lam[NPER] = {0.f, 0.f, 0.f, 0.f};
  float anext[NPER] = {0.f, 0.f, 0.f, 0.f};     // a_{t+1}
  float dA[NPER] = {0.f, 0.f, 0.f, 0.f};
  float dD = 0.f;
  for (int r = nr - 1; r >= 0; --r) {
    const int t0 = r * RUN, len = min(RUN, S - t0);
    __syncthreads();                // the previous run is consumed
    stage(t0, len, true);
    float hc[NPER] = {0.f, 0.f, 0.f, 0.f};      // h_{t0 - 1}
    if (live) {
      const float4 q =
          *reinterpret_cast<const float4*>(ck + (int64_t)r * C::NMAX);
      hc[0] = q.x; hc[1] = q.y; hc[2] = q.z; hc[3] = q.w;
    }
    __syncthreads();
    {
      float h[NPER] = {hc[0], hc[1], hc[2], hc[3]};
      for (int i = 0; i < len; ++i) {
        fwd_step(h, i);
        *reinterpret_cast<float4*>(hs + (i * THREADS + threadIdx.x) * NPER) =
            make_float4(h[0], h[1], h[2], h[3]);
      }
    }
    // each thread reads back only its own h: no barrier
    for (int i = len - 1; i >= 0; --i) {
      const float xt = xs[i * C::CB + ch];
      const float dtt = dts[i * C::CB + ch];
      const float g = dys[i * C::CB + ch];
      const float dbx = dtt * xt;
      const float4 bq =
          *reinterpret_cast<const float4*>(bs + i * C::NMAX + sub * NPER);
      const float4 cq =
          *reinterpret_cast<const float4*>(cs + i * C::NMAX + sub * NPER);
      const float4 hq = *reinterpret_cast<const float4*>(
          hs + (i * THREADS + threadIdx.x) * NPER);
      float hp[NPER] = {hc[0], hc[1], hc[2], hc[3]};
      if (i > 0) {
        const float4 pq = *reinterpret_cast<const float4*>(
            hs + ((i - 1) * THREADS + threadIdx.x) * NPER);
        hp[0] = pq.x; hp[1] = pq.y; hp[2] = pq.z; hp[3] = pq.w;
      }
      const float bv[NPER] = {bq.x, bq.y, bq.z, bq.w};
      const float cv[NPER] = {cq.x, cq.y, cq.z, cq.w};
      const float hv[NPER] = {hq.x, hq.y, hq.z, hq.w};
      float lb = 0.f, lah = 0.f;    // sum_n lam B, sum_n lam A a h_{t-1}
      float v[2 * NPER];
#pragma unroll
      for (int j = 0; j < NPER; ++j) {
        lam[j] = anext[j] * lam[j] + g * cv[j];
        const float at = expf(dtt * a[j]);
        const float ah = at * hp[j];
        lb += lam[j] * bv[j];
        lah += lam[j] * a[j] * ah;
        dA[j] += lam[j] * dtt * ah;
        v[j] = lam[j] * dbx;
        v[NPER + j] = g * hv[j];
        anext[j] = at;
      }
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) {
        lb += __shfl_xor_sync(FULL, lb, o);
        lah += __shfl_xor_sync(FULL, lah, o);
      }
      if (sub == 0) {
        dxs[i * C::CB + ch] = dsk * g + dtt * lb;
        ddts[i * C::CB + ch] = xt * lb + lah;
      }
      dD += g * xt;
      channel_sums<L>(v, red + (i * WARPS + warp) * 2 * C::NMAX, lane, sub);
    }
    __syncthreads();                // the run's dx, ddt and warp sums
    for (int idx = threadIdx.x; idx < len * C::CB; idx += THREADS) {
      const int i = idx / C::CB, dd = d0 + idx % C::CB;
      if (dd < Di) {
        const int64_t gi = ((int64_t)b * S + t0 + i) * Di + dd;
        dx[gi] = from_f<T>(dxs[idx]);
        ddt[gi] = from_f<T>(ddts[idx]);
      }
    }
    for (int idx = threadIdx.x; idx < len * N; idx += THREADS) {
      const int i = idx / N, n = idx % N;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) {
        sb += red[((i * WARPS + k) * 2) * C::NMAX + n];
        sc += red[((i * WARPS + k) * 2 + 1) * C::NMAX + n];
      }
      const int64_t pi = (((int64_t)b * nblk + blk) * S + t0 + i) * N + n;
      ws[w.pb + pi] = sb;
      ws[w.pc + pi] = sc;
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < NPER; ++j) {
      const int n = sub * NPER + j;
      if (n < N) ws[w.pa + ((int64_t)b * Di + d) * N + n] = dA[j];
    }
    if (sub == 0) ws[w.pd + (int64_t)b * Di + d] = dD;
  }
}

// dB, dC: the blocks' partials summed in block order; dA, dD: the batch
// rows' partials summed in row order.
template <typename T>
__global__ void ssm_scan_bwd_sum(const float* __restrict__ ws, Work w,
                                 T* __restrict__ dB, T* __restrict__ dC,
                                 float* __restrict__ dA,
                                 float* __restrict__ dD, int B, int S,
                                 int Di, int N, int nblk) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t sn = (int64_t)S * N, nbc = (int64_t)B * sn,
                na = (int64_t)Di * N;
  if (idx < nbc) {
    const int64_t b = idx / sn, r = idx % sn;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < nblk; ++k) {
      const int64_t pi = (b * nblk + k) * sn + r;
      sb += ws[w.pb + pi];
      sc += ws[w.pc + pi];
    }
    dB[idx] = from_f<T>(sb);
    dC[idx] = from_f<T>(sc);
    return;
  }
  idx -= nbc;
  if (idx < na) {
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += ws[w.pa + b * na + idx];
    dA[idx] = s;
    return;
  }
  idx -= na;
  if (idx < Di) {
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += ws[w.pd + (int64_t)b * Di + idx];
    dD[idx] = s;
  }
}

template <typename T, int L>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const void* Bc, const void* Cc, const float* D,
                   const void* dy, void* dx, void* ddt, void* dB, void* dC,
                   float* dA, float* dD, float* ws, int B, int S, int Di,
                   int N, cudaStream_t stream) {
  using C = Cfg<L>;
  const Work w = workspace<L>(B, S, Di, N);
  const int nblk = (Di + C::CB - 1) / C::CB;
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return err;
  ssm_scan_bwd<T, L><<<dim3(nblk, B), THREADS, C::SMEM, stream>>>(
      (const T*)x, (const T*)dt, A, (const T*)Bc, (const T*)Cc, D,
      (const T*)dy, (T*)dx, (T*)ddt, ws, w, S, Di, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = (int64_t)B * S * N + (int64_t)Di * N + Di;
  const int threads = 256;
  ssm_scan_bwd_sum<T><<<(unsigned)((total + threads - 1) / threads), threads,
                        0, stream>>>(ws, w, (T*)dB, (T*)dC, dA, dD, B, S,
                                     Di, N, nblk);
  return cudaGetLastError();
}

// The lanes per channel for N states: 4 states a lane, a power of two.
int lanes_for(int N) {
  return N <= 4 ? 1 : N <= 8 ? 2 : N <= 16 ? 4 : N <= 32 ? 8 : 16;
}

template <typename T>
cudaError_t dispatch_n(const void* x, const void* dt, const float* A,
                       const void* Bc, const void* Cc, const float* D,
                       const void* dy, void* dx, void* ddt, void* dB,
                       void* dC, float* dA, float* dD, float* ws, int B,
                       int S, int Di, int N, cudaStream_t s) {
#define SSB_ARGS x, dt, A, Bc, Cc, D, dy, dx, ddt, dB, dC, dA, dD, ws, B, S, \
                 Di, N, s
  switch (lanes_for(N)) {
    case 1: return launch<T, 1>(SSB_ARGS);
    case 2: return launch<T, 2>(SSB_ARGS);
    case 4: return launch<T, 4>(SSB_ARGS);
    case 8: return launch<T, 8>(SSB_ARGS);
    default: return launch<T, 16>(SSB_ARGS);
  }
#undef SSB_ARGS
}

}  // namespace

extern "C" {

// Floats of f32 workspace `selective_scan_bwd` needs at this shape
// (1 <= N <= 64).
long long selective_scan_bwd_workspace(int B, int S, int Di, int N) {
  switch (lanes_for(N)) {
    case 1: return workspace<1>(B, S, Di, N).total;
    case 2: return workspace<2>(B, S, Di, N).total;
    case 4: return workspace<4>(B, S, Di, N).total;
    case 8: return workspace<8>(B, S, Di, N).total;
    default: return workspace<16>(B, S, Di, N).total;
  }
}

// x, dt, dy, dx, ddt (B, S, Di); Bc, Cc, dB, dC (B, S, N) in `dtype`
// (0 = float32, 1 = bfloat16); A, dA (Di, N) and D, dD (Di,) float32;
// ws float32 of selective_scan_bwd_workspace(B, S, Di, N) floats; all
// contiguous; B, S, Di >= 1; 1 <= N <= 64.  Launches the backward kernel
// and the partials' sum on `stream`; returns the first cudaError_t.
int selective_scan_bwd(const void* x, const void* dt, const void* A,
                       const void* Bc, const void* Cc, const void* D,
                       const void* dy, void* dx, void* ddt, void* dB,
                       void* dC, void* dA, void* dD, void* ws, int B, int S,
                       int Di, int N, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || S < 1 || Di < 1 || N < 1 || N > 64)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch_n<float>(x, dt, (const float*)A, Bc, Cc,
                                  (const float*)D, dy, dx, ddt, dB, dC,
                                  (float*)dA, (float*)dD, (float*)ws, B, S,
                                  Di, N, s);
  if (dtype == 1)
    return (int)dispatch_n<__nv_bfloat16>(
        x, dt, (const float*)A, Bc, Cc, (const float*)D, dy, dx, ddt, dB,
        dC, (float*)dA, (float*)dD, (float*)ws, B, S, Di, N, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
