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
// What bounds it on this card: per (batch, channel, step, state) one
// accurate exponential (~8 instructions around one MUFU.EX2) and ~20 f32
// operations, and the shuffles of the sums over states and channels,
// against a few bytes per (batch, channel, step): at falcon_mamba_7b's
// training shape (B=4, S=2048, Di=8192, N=16, bf16) the bytes (x, dt, dy
// in; dx, ddt out: ~0.67 GB) take ~0.2 ms at the memory rate and the f32
// operations ~0.3 ms at the f32 peak, but the instruction issue (~34 a
// state-step in the built SASS, 1.07e9 state-steps: ~1.2 ms at 128 a
// clock an SM) and the latency of each lane's dependent chains at 12
// warps an SM (~160 registers a thread: 3 blocks) set the real floor;
// the shuffles of the sums are the largest part of the walk back.  Like
// the forward, the S steps of one state are a chain.
//
// Design: the forward's lane layout (a channel's N states over L lanes of
// a warp, 4 states a lane; 128 threads take 128 / L channels of one batch
// row).  h_{t-1} is never recovered by dividing by a_t (which underflows
// to 0 for large dt * |A|): the forward's training variant wrote h at the
// start of every run of RUN = 8 steps (`scan::STATE_RUN`, shared with it
// in selective_scan.cuh; `states`, (B, Di, ceil(S / 8), N) f32), and the
// runs are taken last to first.  Each run is recomputed
// from its start state with the forward's expression and `expf`, so its h
// are the forward's, keeping a_t and h_t of its 8 steps in registers (64
// a thread), and walked back reading them: one exponential a
// state-step, none in the walk back.  The time axis is staged STAGE = 16
// steps (two runs) at a time: x, dt, dy, B, C and the runs' start states
// arrive by `cp.async` into one of two buffers while the stage before it
// is walked, and are converted once to f32, a (step, channel)'s x, dt,
// dy and dt * x in one float4.  Sums over the states (dx, ddt) take
// log2(L) xor-shuffles; the sums over channels (dB, dC) are first a
// reduce-scatter over the warp's channels (4 + 2 + 1 shuffles for 8
// values over 8 channels) into the block's warp sums, then summed across
// a thread-block cluster of CLUSTER = 8 blocks along the channel blocks:
// block rank q adds slice q of every block's warp sums of a stage through
// distributed shared memory, in rank then warp order, and writes one f32
// partial per (b, cluster, t, n).  One `cluster.sync()` a stage orders
// the reads of its warp sums after every block's writes, and, with two
// warp-sum buffers, the next stage's writes after the reads.  dA and dD
// sum over t in registers and are written per (b, d); a second small
// kernel sums the partials over the clusters (dB, dC) and over b (dA, dD)
// in a fixed order.  No atomics: two launches give the same bits.  Any S,
// Di and 1 <= N <= 64: the grid is padded to whole clusters (a padding
// block only meets the barriers and sums its slice), the ragged channel
// block, the states n >= N (A = B = C = 0 there) and the steps past S
// (zeros: lam stays 0 through them) are masked or zero.
#include <type_traits>

#include <cooperative_groups.h>

#include "hopper.cuh"
#include "selective_scan.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace hopper;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int NPER = 4;       // states per lane
// time steps of a run, recomputed into registers and walked back: the
// forward's training variant keeps the states every RUN steps
constexpr int RUN = scan::STATE_RUN;
// time steps staged, walked and summed across the cluster at a time (two
// runs): 8 ran 1.27x slower, 32 (106 KB a block, 2 blocks an SM) 1.2x
constexpr int STAGE = 16;
// blocks an SM the register budget is set for (~160 registers a thread);
// 4 (128 registers) ran 1.1x slower
constexpr int MIN_BLOCKS = 3;
// blocks a cluster along the channel blocks (8, the portable maximum: at
// the training shape 256 channel blocks make 32 clusters, so 32 partials
// a (b, t, n) reach device memory instead of 256)
constexpr int CLUSTER = 8;
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

// One instance: T and the lanes a channel L.
template <typename T, int L>
struct Cfg {
  static constexpr int NMAX = L * NPER;        // state row
  static constexpr int CB = THREADS / L;       // channels per block
  static constexpr int E = 16 / sizeof(T);     // elements per 16 bytes
  static constexpr int RUNS = STAGE / RUN;     // runs a stage
  static constexpr int XT = STAGE * CB;        // a stage of x (dt, dy, ...)
  static constexpr int BT = STAGE * NMAX;      // a stage of B (or C)
  static constexpr int RAW = 3 * XT + 2 * BT;  // x, dt, dy, B, C as loaded
  // the stage in f32: {x, dt, dy, dt * x} a (step, channel), then B, C
  static constexpr int F32 = 4 * XT + 2 * BT;
  static constexpr int OUT = 3 * XT;           // dx, x lb, lah (ddt: sum)
  static constexpr int RT = STAGE * WARPS * 2 * NMAX;  // warp sums dB, dC
  static constexpr int ST = RUNS * THREADS * NPER;     // runs' start states
  // two start-state buffers; two warp-sum buffers; dx, ddt; the f32
  // stage; two raw buffers
  static constexpr int SMEM =
      (2 * ST + 2 * RT + OUT + F32) * 4 + 2 * RAW * (int)sizeof(T);
  static_assert(STAGE % RUN == 0, "a stage is whole runs");
  static_assert(CB % E == 0, "a channel block is whole 16-byte chunks");
  static_assert(SMEM <= 232448, "a block's shared memory");
};

// Where the workspace's parts start (in floats): the dB and dC partials
// per cluster, the dA and dD partials per batch row.
struct Work {
  int64_t pb, pc, pa, pd, total;
};

template <int L>
int clusters(int Di) {
  const int nblk = (Di + THREADS / L - 1) / (THREADS / L);
  return (nblk + CLUSTER - 1) / CLUSTER;
}

template <int L>
Work workspace(int B, int S, int Di, int N) {
  const int64_t ncl = clusters<L>(Di);
  Work w;
  w.pb = 0;
  w.pc = w.pb + (int64_t)B * ncl * S * N;
  w.pa = w.pc + (int64_t)B * ncl * S * N;
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
      red[(idx >> 2) * (L * NPER) + sub * NPER + (idx & 3)] = v[k];
    }
  }
}

template <typename T, int L>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ssm_scan_bwd(const T* __restrict__ x, const T* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ Bc,
             const T* __restrict__ Cc, const float* __restrict__ Dskip,
             const T* __restrict__ dy, const float* __restrict__ states,
             T* __restrict__ dx, T* __restrict__ ddt, float* __restrict__ ws,
             Work w, int S, int Di, int N, int vec_x, int vec_bc) {
  using C = Cfg<T, L>;
  extern __shared__ __align__(16) float smem[];
  float* const sts = smem;                     // start states, 2 buffers
  float* const red0 = sts + 2 * C::ST;         // warp sums, 2 buffers
  float* const outs = red0 + 2 * C::RT;        // dx, x lb, lah
  float4* const xr = reinterpret_cast<float4*>(outs + C::OUT);
  float* const bcf = reinterpret_cast<float*>(xr + C::XT);   // B, then C
  T* const raw = reinterpret_cast<T*>(bcf + 2 * C::BT);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y, cl = blockIdx.x / CLUSTER;
  const int ncl = gridDim.x / CLUSTER;
  const int nblk = (Di + C::CB - 1) / C::CB;
  const int d0 = blockIdx.x * C::CB;
  const bool pad = d0 >= Di;                   // a block of no channel
  const int ch = threadIdx.x / L;              // channel in the block
  const int sub = threadIdx.x % L;             // lane in the channel's L
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int d = d0 + ch;
  const bool live = d < Di;
  const int nrun = (S + RUN - 1) / RUN;        // the forward's states
  const int nst = (S + STAGE - 1) / STAGE;

  float a[NPER];
#pragma unroll
  for (int j = 0; j < NPER; ++j) {
    const int n = sub * NPER + j;
    a[j] = (live && n < N) ? A[(int64_t)d * N + n] : 0.f;
  }
  const float dsk = live ? Dskip[d] : 0.f;

  // Zero shared memory once: the copies never write the channels d >= Di,
  // the states n >= N or the steps past S, so those read as 0 throughout
  // (the ragged last stage is the first one staged).
  for (int i = threadIdx.x; i < C::SMEM / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // start copying stage [t0, t0 + STAGE): x, dt, dy and B, C into raw
  // buffer buf, and the start states of its runs (h_{t-1} at each run's
  // first step t; 0 past S) into state buffer buf
  auto stage = [&](int buf, int t0) {
    T* const xs = raw + buf * C::RAW;
    T* const dts = xs + C::XT;
    T* const dys = dts + C::XT;
    T* const bs = dys + C::XT;
    T* const cs = bs + C::BT;
    const int len = min(STAGE, S - t0);
    if (vec_x) {                 // Di % E == 0: chunks are all in or out
      constexpr int CPR = C::CB / C::E;
      for (int idx = threadIdx.x; idx < len * CPR; idx += THREADS) {
        const int i = idx / CPR, c = idx % CPR, dd = d0 + c * C::E;
        if (dd < Di) {
          const int64_t gi = ((int64_t)b * S + t0 + i) * Di + dd;
          const int o = i * C::CB + c * C::E;
          cp_async_16(smem_u32(xs + o), x + gi, 16);
          cp_async_16(smem_u32(dts + o), dt + gi, 16);
          cp_async_16(smem_u32(dys + o), dy + gi, 16);
        }
      }
    } else {
      for (int idx = threadIdx.x; idx < len * C::CB; idx += THREADS) {
        const int i = idx / C::CB, dd = d0 + idx % C::CB;
        if (dd < Di) {
          const int64_t gi = ((int64_t)b * S + t0 + i) * Di + dd;
          xs[idx] = x[gi];
          dts[idx] = dt[gi];
          dys[idx] = dy[gi];
        }
      }
    }
    const int64_t g0 = ((int64_t)b * S + t0) * N;
    if (vec_bc) {                // N % E == 0
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
    float* const st = sts + buf * C::ST + threadIdx.x * NPER;
#pragma unroll
    for (int q = 0; q < C::RUNS; ++q) {
      const int run = t0 / RUN + q;
#pragma unroll
      for (int j = 0; j < NPER; ++j) {
        const int n = sub * NPER + j;
        const bool in = live && n < N && run < nrun;
        const float* src =
            in ? states + (((int64_t)b * Di + d) * nrun + run) * N + n
               : states;
        cp_async_4(smem_u32(st + q * THREADS * NPER + j), src, in ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  // this block's slice of stage r's (kind, i, n) sums over the cluster:
  // the blocks in rank order (padding blocks, the last ranks, add
  // nothing), each block's warps in order; one partial per (b, cluster,
  // t, n)
  const int live_blocks = min(CLUSTER, nblk - cl * CLUSTER);
  auto cluster_slice = [&](int r) {
    const int t0 = r * STAGE, len = min(STAGE, S - t0);
    const float* const red = red0 + (r & 1) * C::RT;
    const int n4 = (N + 3) / 4;                // 4 states a float4
    const int items = 2 * len * n4;
    const int per = (items + CLUSTER - 1) / CLUSTER;
    for (int idx = rank * per + threadIdx.x;
         idx < min(items, (rank + 1) * per); idx += THREADS) {
      const int kind = idx / (len * n4), in = idx % (len * n4);
      const int i = in / n4, n = 4 * (in % n4);
      const int at = ((i * WARPS) * 2 + kind) * C::NMAX + n;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < CLUSTER; ++k) {
        if (k < live_blocks) {
          const float* const peer = cluster.map_shared_rank(red, k);
          float sb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int wp = 0; wp < WARPS; ++wp) {
            const float4 q = *reinterpret_cast<const float4*>(
                peer + at + wp * 2 * C::NMAX);
            sb[0] += q.x; sb[1] += q.y; sb[2] += q.z; sb[3] += q.w;
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) s[c] += sb[c];
        }
      }
      float* const out = ws + (kind ? w.pc : w.pb)
                         + (((int64_t)b * ncl + cl) * S + t0 + i) * N;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (n + c < N) out[n + c] = s[c];
    }
  };

  float lam[NPER] = {0.f, 0.f, 0.f, 0.f};
  float anext[NPER] = {0.f, 0.f, 0.f, 0.f};     // a_{t+1}
  float dA[NPER] = {0.f, 0.f, 0.f, 0.f};
  float dD = 0.f;
  if (!pad) stage((nst - 1) & 1, (nst - 1) * STAGE);

  for (int r = nst - 1; r >= 0; --r) {
    const int t0 = r * STAGE, len = min(STAGE, S - t0);
    float* const red = red0 + (r & 1) * C::RT;
    if (!pad) {
      cp_async_wait<0>();
      __syncthreads();           // stage r in place, stage r + 1 consumed
      if (r > 0) stage((r - 1) & 1, t0 - STAGE);
      {
        // the stage in f32, once: a (step, channel)'s x, dt, dy and the
        // forward's dt * x in one float4 (read by the L lanes of the
        // channel), and B, C (read by 128 / L channels)
        const T* const cur = raw + (r & 1) * C::RAW;
        for (int idx = threadIdx.x; idx < C::XT; idx += THREADS) {
          const float xv = to_f(cur[idx]), dv = to_f(cur[C::XT + idx]);
          xr[idx] = make_float4(xv, dv, to_f(cur[2 * C::XT + idx]), dv * xv);
        }
        for (int idx = threadIdx.x; idx < 2 * C::BT; idx += THREADS)
          bcf[idx] = to_f(cur[3 * C::XT + idx]);
        __syncthreads();
      }
      const float* const st = sts + (r & 1) * C::ST + threadIdx.x * NPER;

      // the stage's runs last to first
      for (int q = C::RUNS - 1; q >= 0; --q) {
        const float4* const xq = xr + q * RUN * C::CB + ch;
        const float* const bw = bcf + q * RUN * C::NMAX + sub * NPER;
        const float* const cw = bw + C::BT;
        float* const outq = outs + q * RUN * C::CB;
        float* const redq = red + q * RUN * WARPS * 2 * C::NMAX;
        float hc[NPER];                          // h before the run
        {
          const float4 q4 =
              *reinterpret_cast<const float4*>(st + q * THREADS * NPER);
          hc[0] = q4.x; hc[1] = q4.y; hc[2] = q4.z; hc[3] = q4.w;
        }
        // recompute the run from its start state, the forward's
        // expression and exponential, keeping a_t and h_t in registers
        float ar[RUN][NPER], hr[RUN][NPER];
        {
          float h[NPER] = {hc[0], hc[1], hc[2], hc[3]};
#pragma unroll
          for (int i = 0; i < RUN; ++i) {
            const float4 xi = xq[i * C::CB];
            const float dtt = xi.y, dbx = xi.w;
            const float4 bq =
                *reinterpret_cast<const float4*>(bw + i * C::NMAX);
            const float bv[NPER] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
            for (int j = 0; j < NPER; ++j) {
              ar[i][j] = expf(dtt * a[j]);
              h[j] = ar[i][j] * h[j] + dbx * bv[j];
              hr[i][j] = h[j];
            }
          }
        }
        // walk the run back (steps past S: zeros, so lam stays 0)
#pragma unroll
        for (int i = RUN - 1; i >= 0; --i) {
          const float4 xi = xq[i * C::CB];
          const float xt = xi.x, dtt = xi.y, g = xi.z, dbx = xi.w;
          const float4 bq =
              *reinterpret_cast<const float4*>(bw + i * C::NMAX);
          const float4 cq =
              *reinterpret_cast<const float4*>(cw + i * C::NMAX);
          const float bv[NPER] = {bq.x, bq.y, bq.z, bq.w};
          const float cv[NPER] = {cq.x, cq.y, cq.z, cq.w};
          float lb = 0.f, lah = 0.f;  // sum_n lam B, sum_n lam A a h_{t-1}
          float v[2 * NPER];
#pragma unroll
          for (int j = 0; j < NPER; ++j) {
            const float at = ar[i][j];
            const float hp = i > 0 ? hr[i - 1][j] : hc[j];   // h_{t-1}
            lam[j] = anext[j] * lam[j] + g * cv[j];
            const float lah_j = lam[j] * (at * hp);   // lam a_t h_{t-1}
            lb += lam[j] * bv[j];
            lah += a[j] * lah_j;
            dA[j] += dtt * lah_j;
            v[j] = lam[j] * dbx;
            v[NPER + j] = g * hr[i][j];
            anext[j] = at;
          }
          // the channel's sums over its L lanes, reduce-scattered: the
          // lower half of the lanes ends with lb, the upper half with lah
          float ls = lb;
          if constexpr (L > 1) {
            const bool up = sub & (L / 2);
            ls = (up ? lah : lb) +
                 __shfl_xor_sync(FULL, up ? lb : lah, L / 2);
#pragma unroll
            for (int o = L / 4; o > 0; o >>= 1)
              ls += __shfl_xor_sync(FULL, ls, o);
          }
          if (sub == 0) {
            outq[i * C::CB + ch] = dsk * g + dtt * ls;
            outq[C::XT + i * C::CB + ch] = xt * ls;
          }
          if (sub == L / 2) {
            float lah_sum = ls;
            if constexpr (L == 1) lah_sum = lah;
            outq[2 * C::XT + i * C::CB + ch] = lah_sum;
          }
          dD += g * xt;
          channel_sums<L>(v, redq + (i * WARPS + warp) * 2 * C::NMAX, lane,
                          sub);
        }
      }
    }
    // every block's warp sums of the stage, and this block's dx, ddt,
    // are complete
    cluster.sync();
    if (!pad) {
      for (int idx = threadIdx.x; idx < len * C::CB; idx += THREADS) {
        const int i = idx / C::CB, dd = d0 + idx % C::CB;
        if (dd < Di) {
          const int64_t gi = ((int64_t)b * S + t0 + i) * Di + dd;
          dx[gi] = from_f<T>(outs[idx]);
          ddt[gi] = from_f<T>(outs[C::XT + idx] + outs[2 * C::XT + idx]);
        }
      }
    }
    cluster_slice(r);
  }
  // no block leaves while a peer may still read its shared memory
  cluster.sync();
  if (live) {
#pragma unroll
    for (int j = 0; j < NPER; ++j) {
      const int n = sub * NPER + j;
      if (n < N) ws[w.pa + ((int64_t)b * Di + d) * N + n] = dA[j];
    }
    if (sub == 0) ws[w.pd + (int64_t)b * Di + d] = dD;
  }
}

// dB, dC: the clusters' partials summed in cluster order; dA, dD: the
// batch rows' partials summed in row order.
template <typename T>
__global__ void ssm_scan_bwd_sum(const float* __restrict__ ws, Work w,
                                 T* __restrict__ dB, T* __restrict__ dC,
                                 float* __restrict__ dA,
                                 float* __restrict__ dD, int B, int S,
                                 int Di, int N, int ncl) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t sn = (int64_t)S * N, nbc = (int64_t)B * sn,
                na = (int64_t)Di * N;
  if (idx < nbc) {
    const int64_t b = idx / sn, r = idx % sn;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < ncl; ++k) {
      const int64_t pi = (b * ncl + k) * sn + r;
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

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// The launch configuration of an instance: grid padded to whole clusters
// of CLUSTER blocks along the channel blocks.
template <typename T, int L>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                      int B, int Di, cudaStream_t stream) {
  using C = Cfg<T, L>;
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd<T, L>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(clusters<L>(Di) * CLUSTER, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename T, int L>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const void* Bc, const void* Cc, const float* D,
                   const void* dy, const float* states, void* dx, void* ddt,
                   void* dB, void* dC, float* dA, float* dD, float* ws,
                   int B, int S, int Di, int N, cudaStream_t stream) {
  using C = Cfg<T, L>;
  const Work w = workspace<L>(B, S, Di, N);
  const int vec_x = Di % C::E == 0 && aligned16(x) && aligned16(dt)
                    && aligned16(dy);
  const int vec_bc = N % C::E == 0 && aligned16(Bc) && aligned16(Cc);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<T, L>(cfg, attr, B, Di, stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, ssm_scan_bwd<T, L>, (const T*)x,
                           (const T*)dt, A, (const T*)Bc, (const T*)Cc, D,
                           (const T*)dy, states, (T*)dx, (T*)ddt, ws, w, S,
                           Di, N, vec_x, vec_bc);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = (int64_t)B * S * N + (int64_t)Di * N + Di;
  const int threads = 256;
  ssm_scan_bwd_sum<T><<<(unsigned)((total + threads - 1) / threads), threads,
                        0, stream>>>(ws, w, (T*)dB, (T*)dC, dA, dD, B, S,
                                     Di, N, clusters<L>(Di));
  return cudaGetLastError();
}

// What an instance runs with: out[0] RUN, out[1] STAGE, out[2] CLUSTER,
// out[3] its shared memory a block, out[4] its resident blocks an SM,
// out[5] its clusters resident at once on the card.
template <typename T, int L>
cudaError_t info(int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<T, L>(cfg, attr, 1, 1 << 16, nullptr);
  if (err != cudaSuccess) return err;
  out[0] = RUN;
  out[1] = STAGE;
  out[2] = CLUSTER;
  out[3] = Cfg<T, L>::SMEM;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[4], ssm_scan_bwd<T, L>, THREADS, out[3]);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(&out[5], ssm_scan_bwd<T, L>,
                                        &cfg);
}

// The lanes per channel for N states: 4 states a lane, a power of two.
int lanes_for(int N) {
  return N <= 4 ? 1 : N <= 8 ? 2 : N <= 16 ? 4 : N <= 32 ? 8 : 16;
}

#define SSB_DISPATCH(FN, ARGS)                                        \
  switch (lanes_for(N)) {                                             \
    case 1: return FN<T, 1> ARGS;                                     \
    case 2: return FN<T, 2> ARGS;                                     \
    case 4: return FN<T, 4> ARGS;                                     \
    case 8: return FN<T, 8> ARGS;                                     \
    default: return FN<T, 16> ARGS;                                   \
  }

template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const float* A,
                     const void* Bc, const void* Cc, const float* D,
                     const void* dy, const float* states, void* dx,
                     void* ddt, void* dB, void* dC, float* dA, float* dD,
                     float* ws, int B, int S, int Di, int N,
                     cudaStream_t s) {
  SSB_DISPATCH(launch, (x, dt, A, Bc, Cc, D, dy, states, dx, ddt, dB, dC,
                        dA, dD, ws, B, S, Di, N, s))
}

template <typename T>
cudaError_t dispatch_info(int N, int* out) {
  SSB_DISPATCH(info, (out))
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

// The backward's run: selective_scan_fwd keeps the states every this
// many steps.
int selective_scan_bwd_run() { return RUN; }

// x, dt, dy, dx, ddt (B, S, Di); Bc, Cc, dB, dC (B, S, N) in `dtype`
// (0 = float32, 1 = bfloat16); A, dA (Di, N) and D, dD (Di,) float32;
// states (B, Di, ceil(S / RUN), N) float32 from selective_scan_fwd with
// states; ws float32 of selective_scan_bwd_workspace(B, S, Di, N)
// floats; all contiguous; B, S, Di >= 1; 1 <= N <= 64.  Launches the
// backward kernel and the partials' sum on `stream`; returns the first
// cudaError_t.
int selective_scan_bwd(const void* x, const void* dt, const void* A,
                       const void* Bc, const void* Cc, const void* D,
                       const void* dy, const void* states, void* dx,
                       void* ddt, void* dB, void* dC, void* dA, void* dD,
                       void* ws, int B, int S, int Di, int N, int dtype,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || S < 1 || Di < 1 || N < 1 || N > 64)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch<float>(x, dt, (const float*)A, Bc, Cc,
                                (const float*)D, dy, (const float*)states,
                                dx, ddt, dB, dC, (float*)dA, (float*)dD,
                                (float*)ws, B, S, Di, N, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(
        x, dt, (const float*)A, Bc, Cc, (const float*)D, dy,
        (const float*)states, dx, ddt, dB, dC, (float*)dA, (float*)dD,
        (float*)ws, B, S, Di, N, s);
  return (int)cudaErrorInvalidValue;
}

// The launch facts of the instance for (N, dtype): out[0..5] = RUN,
// STAGE, CLUSTER, shared memory a block (bytes), resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), resident clusters
// (cudaOccupancyMaxActiveClusters).  Returns the first cudaError_t.
int selective_scan_bwd_info(int N, int dtype, int* out) {
  if (N < 1 || N > 64) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_info<float>(N, out);
  if (dtype == 1) return (int)dispatch_info<__nv_bfloat16>(N, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
