// Forward flash attention (online softmax) with GQA, causal and
// sliding-window masks, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// `_fa_kernel` (wrapper `flash_attention`).  Same arithmetic: f32 scores
// `(q . k) * (1/sqrt(D))`, the finite sentinel NEG_INF = -1e30 for masked
// entries, end-aligned positions (q row i sits at i + Skv - Sq), the
// TPU kernel's whole-tile skip conditions, running max/sum/accumulator in
// f32, rows whose sum stays 0 written as 0, output in q's dtype.
//
// What bounds it on this card: at the model's shapes (S=4096, D=128) the
// work is ~2*2*S*S/2*D flops per (batch, q head), far above the byte
// traffic, so it is bound by operations.  This first design runs them on
// the CUDA cores in f32 (67 TFLOP/s peak), not on the tensor cores
// (989 TFLOP/s bf16), and feeds them from shared memory at about one
// shared load per FMA, so it sits well above even the f32 bound.  The
// design keeps what the TPU kernel keeps out of device memory: scores,
// probabilities and the running statistics never leave the SM, and each
// K/V tile is read once per 64-row q tile.
//
// Layout: one block of 256 threads per (64-row q tile, q head, batch).
// Thread t owns q row r = t/4 of the tile and, with its three row
// neighbours (lanes 4r..4r+3 of the warp), splits that row's work:
//   - scores: columns c = sub + 4j (j < 16) of each 64-key tile;
//   - output: head dims sub + 4i (i < D/4), held in registers.
// The row's max and sum are reduced over the four lanes with shuffles;
// probabilities go from the lane that holds them to the others by
// shuffle, so no score tile is written to shared memory.  Q, K and V
// tiles are staged in shared memory as f32 (rows of Q and K padded by one
// float so the per-row reads fall in distinct banks).  GQA: q head h reads
// kv head h / (Hq/Hkv); K and V are never repeated.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 4 threads per q row
constexpr int COLS = BK / 4;  // score columns per thread
constexpr float NEG_INF = -1e30f;

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

// load rows [row0, row0 + 64) of one head of a (B, S, H, D) tensor into a
// (64, stride) f32 tile; rows past S are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* src, int b, int row0,
                                          int S, int H, int h) {
  for (int idx = threadIdx.x; idx < BQ * D; idx += THREADS) {
    int r = idx / D, d = idx % D;
    int s = row0 + r;
    float v = 0.f;
    if (s < S) v = load_f(src, (((int64_t)b * S + s) * H + h) * D + d);
    dst[r * stride + d] = v;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
              int Hq, int Hkv, int causal, int window, float scale) {
  extern __shared__ float smem[];
  constexpr int QS = D + 1;       // padded row stride of Q and K
  float* Qs = smem;               // (BQ, QS)
  float* Ks = Qs + BQ * QS;       // (BK, QS)
  float* Vs = Ks + BK * QS;       // (BK, D)

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int lane = threadIdx.x & 31;
  const int r = threadIdx.x >> 2;     // q row in the tile
  const int sub = threadIdx.x & 3;    // lane within the row's four
  const int base = lane & ~3;
  const int off = Skv - Sq;           // end alignment
  const int q0 = qt * BQ;
  const int q_pos = q0 + r + off;

  load_tile<T, D>(Qs, QS, q, b, q0, Sq, Hq, h);

  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;

  const int nk = (Skv + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    // the TPU kernel's block_needed: skip tiles wholly above the diagonal
    // or wholly outside the window
    if (causal && k0 > q0 + BQ - 1 + off) break;
    if (window && !(k0 + BK - 1 > q0 + off - window)) continue;

    __syncthreads();                  // previous tile fully consumed
    load_tile<T, D>(Ks, QS, k, b, k0, Skv, Hkv, hk);
    load_tile<T, D>(Vs, D, v, b, k0, Skv, Hkv, hk);
    __syncthreads();

    float s[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) s[j] = 0.f;
    const float* qrow = Qs + r * QS;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[j] += qd * Ks[(sub + 4 * j) * QS + d];
    }
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      int k_pos = k0 + sub + 4 * j;
      bool ok = k_pos < Skv;
      if (causal) ok = ok && q_pos >= k_pos;
      if (window) ok = ok && (q_pos - k_pos) < window;
      s[j] = ok ? s[j] * scale : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) acc[i] *= alpha;
    // acc += P V, P[r][4j + u] fetched from lane base + u
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float p = __shfl_sync(0xffffffffu, s[j], base + u);
        const float* vrow = Vs + (4 * j + u) * D;
#pragma unroll
        for (int i = 0; i < D / 4; ++i) acc[i] += p * vrow[sub + 4 * i];
      }
    }
  }

  const int row = q0 + r;
  if (row < Sq) {
    const float inv_l = 1.f / (l == 0.f ? 1.f : l);
    const int64_t o_base = (((int64_t)b * Sq + row) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < D / 4; ++i)
      store_f(o, o_base + sub + 4 * i, acc[i] * inv_l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                   int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * BQ * (D + 1) + BK * D);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  fa_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Skv, Hq, Hkv,
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Skv, int Hq, int Hkv, int D,
                       int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal,
                                  window, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal,
                                  window, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal,
                                  window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal,
                                    window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), o (B, Sq, Hq, D), contiguous;
// dtype 0 = float32, 1 = bfloat16 for all four; D in {16, 32, 64, 128};
// Hq % Hkv == 0; Sq <= Skv.  Returns the launch's cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, int B, int Sq, int Skv, int Hq, int Hkv,
                        int D, int causal, int window, int dtype,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D,
                                  causal, window, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hkv,
                                          D, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
