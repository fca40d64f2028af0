// Backward of flash attention with GQA, causal and sliding-window masks,
// for sm_90a: the gradients dq, dk, dv of K2's forward (flash_attention.cu)
// from its output and the per-row log-sum-exp it writes.
//
// It replaces no TPU kernel: the reference differentiates its attention
// through `_fa_bwd_scan` (src/repro/kernels/ops.py:88, the custom VJP of
// `flash_attention_xla`), an XLA scan, not a Pallas kernel.  It keeps that
// function's arithmetic:
//   delta = sum_d dout * out               (f32, from out in the input type)
//   s     = (q . k) * (1/sqrt(D))          (f32)
//   p     = exp(s - lse), 0 where masked   (f32, never rounded)
//   dv    = p^T dout,  dp = dout v^T,  ds = p (dp - delta) scale
//   dq    = ds k,      dk = ds^T q         (ds rounded to the input type
//                                           first, as `_fa_bwd_scan` does)
// with f32 sums throughout, outputs in the input type, end-aligned
// positions (q row i sits at i + Skv - Sq) and GQA through h / (Hq/Hkv).
//
// Three kernels, launched in order on the caller's stream by one entry
// point:
//   bwd_delta  one warp per (batch, q row, q head): delta into (B, Hq, Sq);
//   bwd_dkdv   one block per (64-key tile, kv head, batch), looping over
//              the G q heads of its group and over the 64-row q tiles that
//              see its keys: dk and dv of its keys summed in registers, so
//              no two blocks write one element and no atomics are needed;
//   bwd_dq     one block per (64-row q tile, q head, batch), looping over
//              the key tiles its rows see.
// Without atomics the sums run in a fixed order: two launches on the same
// inputs give the same bits.
//
// What bounds it on this card: about 5 * 2 * S^2/2 * D flops per (batch,
// q head) under a causal mask (the five products above; the two kernels
// recompute s and dp, seven products in all) against 4 * S * D elements
// in and out, so it is bound by operations.  This first kernel is the
// simple one that is right: f32 FMAs on the CUDA cores (67 TFLOP/s), tiles
// of f32 in shared memory read as float4 along D, 4 x 4 register blocks.
// The bf16 tensor cores (`wgmma`, as K2's forward) are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // q rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // 16 x 16: thread (ty, tx)
constexpr int PS = BK + 16;    // row stride of the P / dS tiles (no bank
                               // conflict between rows ty and ty + 1)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and back (identity for float)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// rows [row0, row0 + 64) of head h of a (B, S, H, D) tensor into a
// (64, D + 4) f32 tile; rows past S are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int row0, int S, int H, int h) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int s = row0 + r;
    dst[r * (D + 4) + d] =
        s < S ? to_f(src[(((int64_t)b * S + s) * H + h) * D + d]) : 0.f;
  }
}

// acc[a][c] = sum_d X[ty + 16a][d] * Y[tx + 16c][d] over two (64, D + 4)
// tiles, float4 along d
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* X,
                                         const float* Y, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      x[a] = *reinterpret_cast<const float4*>(X + (ty + 16 * a) * (D + 4) + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      y[c] = *reinterpret_cast<const float4*>(Y + (tx + 16 * c) * (D + 4) + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float t = fmaf(x[a].x, y[c].x, acc[a][c]);
        t = fmaf(x[a].y, y[c].y, t);
        t = fmaf(x[a].z, y[c].z, t);
        acc[a][c] = fmaf(x[a].w, y[c].w, t);
      }
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, int Skv, int causal,
                                        int window) {
  bool ok = kp < Skv;
  if (causal) ok = ok && qp >= kp;
  if (window) ok = ok && (qp - kp) < window;
  return ok;
}

// p and ds of one (64 q rows x 64 keys) tile from s = Q K^T and dp =
// dO V^T (this thread's 4 x 4), into the shared dS tile and, with WRITE_P,
// the shared P tile
template <typename T, bool WRITE_P>
__device__ __forceinline__ void p_ds(float* Ps, float* dSs,
                                     const float (&s)[4][4],
                                     const float (&dp)[4][4],
                                     const float* lse_s, const float* delta_s,
                                     int q0, int k0, int Sq, int Skv,
                                     int off, int causal, int window,
                                     float scale, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const int i = q0 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      const bool ok = i < Sq && visible(i + off, k0 + j, Skv, causal, window);
      const float p = ok ? expf(s[a][c] * scale - lse_s[r]) : 0.f;
      const float ds = round_to<T>(p * (dp[a][c] - delta_s[r]) * scale);
      if (WRITE_P) Ps[r * PS + j] = p;
      dSs[r * PS + j] = ds;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_delta(const T* __restrict__ out, const T* __restrict__ dout,
          float* __restrict__ delta, int B, int Sq, int Hq) {
  const int64_t row = (int64_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= (int64_t)B * Sq * Hq) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc += to_f(dout[row * D + d]) * to_f(out[row * D + d]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) {
    // (B, Sq, Hq) row -> (B, Hq, Sq) as lse
    const int h = row % Hq;
    const int64_t bs = row / Hq;
    const int i = bs % Sq, b = bs / Sq;
    delta[((int64_t)b * Hq + h) * Sq + i] = acc;
  }
}

template <int D>
struct Smem {
  static constexpr int TILE = 64 * (D + 4);   // floats of one Q/K/V/dO tile
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int Hq,
         int Hkv, int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Ks = smem;
  float* Vs = Ks + Smem<D>::TILE;
  float* Qs = Vs + Smem<D>::TILE;
  float* dOs = Qs + Smem<D>::TILE;
  float* Ps = dOs + Smem<D>::TILE;
  float* dSs = Ps + BQ * PS;
  float* lse_s = dSs + BQ * PS;
  float* delta_s = lse_s + BQ;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int k0 = kt * BK;
  const int off = Skv - Sq;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<T, D>(Ks, k, b, k0, Skv, Hkv, hk);
  load_tile<T, D>(Vs, v, b, k0, Skv, Hkv, hk);

  constexpr int NC = D / 16;       // output columns per thread
  float adk[4][NC], adv[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[a][c] = adv[a][c] = 0.f;

  // the q rows that see any key of this tile
  int i_lo = causal ? max(0, k0 - off) : 0;
  int i_hi = Sq - 1;
  if (window) i_hi = min(i_hi, k0 + BK - 2 + window - off);
  const int qt_lo = i_lo / BQ, qt_hi = i_hi >= i_lo ? i_hi / BQ : -1;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();                 // previous q tile fully consumed
      load_tile<T, D>(Qs, q, b, q0, Sq, Hq, h);
      load_tile<T, D>(dOs, dout, b, q0, Sq, Hq, h);
      if (threadIdx.x < BQ) {
        const int i = q0 + threadIdx.x;
        const int64_t at = ((int64_t)b * Hq + h) * Sq + i;
        lse_s[threadIdx.x] = i < Sq ? lse[at] : 0.f;
        delta_s[threadIdx.x] = i < Sq ? delta[at] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dot<D>(s, Qs, Ks, ty, tx);
      tile_dot<D>(dp, dOs, Vs, ty, tx);
      p_ds<T, true>(Ps, dSs, s, dp, lse_s, delta_s, q0, k0, Sq, Skv, off,
                    causal, window, scale, ty, tx);
      __syncthreads();
      // dv[j] += sum_i p[i][j] dout[i];  dk[j] += sum_i ds[i][j] q[i]
      // for this thread's keys j = ty + 16a and columns tx + 16c
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float pj[4], dsj[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pj[a] = Ps[i * PS + ty + 16 * a];
          dsj[a] = dSs[i * PS + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float dov = dOs[i * (D + 4) + tx + 16 * c];
          const float qv = Qs[i * (D + 4) + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            adv[a][c] += pj[a] * dov;
            adk[a][c] += dsj[a] * qv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= Skv) continue;
    const int64_t base = (((int64_t)b * Skv + j) * Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[base + tx + 16 * c] = from_f<T>(adk[a][c]);
      dv[base + tx + 16 * c] = from_f<T>(adv[a][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ delta,
       T* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int causal,
       int window, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem;
  float* dOs = Qs + Smem<D>::TILE;
  float* Ks = dOs + Smem<D>::TILE;
  float* Vs = Ks + Smem<D>::TILE;
  float* dSs = Vs + Smem<D>::TILE;
  float* lse_s = dSs + BQ * PS;
  float* delta_s = lse_s + BQ;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int off = Skv - Sq;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<T, D>(Qs, q, b, q0, Sq, Hq, h);
  load_tile<T, D>(dOs, dout, b, q0, Sq, Hq, h);
  if (threadIdx.x < BQ) {
    const int i = q0 + threadIdx.x;
    const int64_t at = ((int64_t)b * Hq + h) * Sq + i;
    lse_s[threadIdx.x] = i < Sq ? lse[at] : 0.f;
    delta_s[threadIdx.x] = i < Sq ? delta[at] : 0.f;
  }

  constexpr int NC = D / 16;
  float adq[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) adq[a][c] = 0.f;

  // the key tiles this tile's rows see
  const int q_hi = min(q0 + BQ - 1, Sq - 1);
  int kt_lo = 0, kt_hi = (Skv - 1) / BK;
  if (causal) kt_hi = min(kt_hi, (q_hi + off) / BK);
  if (window) kt_lo = max(0, q0 + off - window + 1) / BK;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                   // previous key tile fully consumed
    load_tile<T, D>(Ks, k, b, k0, Skv, Hkv, hk);
    load_tile<T, D>(Vs, v, b, k0, Skv, Hkv, hk);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(s, Qs, Ks, ty, tx);
    tile_dot<D>(dp, dOs, Vs, ty, tx);
    p_ds<T, false>(nullptr, dSs, s, dp, lse_s, delta_s, q0, k0, Sq, Skv,
                   off, causal, window, scale, ty, tx);
    __syncthreads();
    // dq[i] += sum_j ds[i][j] k[j] for rows i = ty + 16a, columns tx + 16c
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float dsi[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) dsi[a] = dSs[(ty + 16 * a) * PS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = Ks[j * (D + 4) + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) adq[a][c] += dsi[a] * kv;
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= Sq) continue;
    const int64_t base = (((int64_t)b * Sq + i) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[base + tx + 16 * c] = from_f<T>(adq[a][c]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const float* lse, const void* dout,
                   void* dq, void* dk, void* dv, float* delta, int B, int Sq,
                   int Skv, int Hq, int Hkv, int causal, int window,
                   cudaStream_t stream) {
  // four (64, D + 4) tiles, the P (dk/dv only) and dS tiles, lse and
  // delta of a q tile
  const int smem_dkdv = (int)sizeof(float)
                        * (4 * Smem<D>::TILE + 2 * BQ * PS + 2 * BQ);
  const int smem_dq = smem_dkdv - (int)sizeof(float) * BQ * PS;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      bwd_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  const int64_t rows = (int64_t)B * Sq * Hq;
  const int per_block = THREADS / 32;
  bwd_delta<T, D><<<(unsigned)((rows + per_block - 1) / per_block), THREADS,
                    0, stream>>>((const T*)o, (const T*)dout, delta, B, Sq,
                                 Hq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv<T, D><<<dim3((Skv + BK - 1) / BK, Hkv, B), THREADS, smem_dkdv,
                   stream>>>((const T*)q, (const T*)k, (const T*)v,
                             (const T*)dout, lse, delta, (T*)dk, (T*)dv, Sq,
                             Skv, Hq, Hkv, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq<T, D><<<dim3((Sq + BQ - 1) / BQ, Hq, B), THREADS, smem_dq,
                 stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, Sq, Skv, Hq, Hkv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* lse, const void* dout, void* dq, void* dk, void* dv,
             void* delta, int B, int Sq, int Skv, int Hq, int Hkv, int D,
             int causal, int window, void* stream) {
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return (int)launch<T, 16>(q, k, v, o, l, dout, dq, dk, dv, dl, B,
                                       Sq, Skv, Hq, Hkv, causal, window, s);
    case 32: return (int)launch<T, 32>(q, k, v, o, l, dout, dq, dk, dv, dl, B,
                                       Sq, Skv, Hq, Hkv, causal, window, s);
    case 64: return (int)launch<T, 64>(q, k, v, o, l, dout, dq, dk, dv, dl, B,
                                       Sq, Skv, Hq, Hkv, causal, window, s);
    case 128: return (int)launch<T, 128>(q, k, v, o, l, dout, dq, dk, dv, dl,
                                         B, Sq, Skv, Hq, Hkv, causal, window,
                                         s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o, dout, dq (B, Sq, Hq, D); k, v, dk, dv (B, Skv, Hkv, D), contiguous,
// all float32 or all bfloat16; lse (B, Hq, Sq) float32 from the forward;
// delta (B, Hq, Sq) float32 scratch.  D in {16, 32, 64, 128}; Hq % Hkv ==
// 0; Sq <= Skv.  Launches the three kernels in order and returns the
// first launch error (cudaError_t), else 0.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* lse, const void* dout,
                            void* dq, void* dk, void* dv, void* delta, int B,
                            int Sq, int Skv, int Hq, int Hkv, int D,
                            int causal, int window, void* stream) {
  return dispatch<float>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq,
                         Skv, Hq, Hkv, D, causal, window, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* lse,
                             const void* dout, void* dq, void* dk, void* dv,
                             void* delta, int B, int Sq, int Skv, int Hq,
                             int Hkv, int D, int causal, int window,
                             void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, lse, dout, dq, dk, dv, delta, B,
                                 Sq, Skv, Hq, Hkv, D, causal, window, stream);
}

}  // extern "C"
