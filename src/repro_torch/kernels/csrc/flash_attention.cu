// Forward flash attention (online softmax) with GQA, causal and
// sliding-window masks, for sm_90a.  Two kernels, one per input type:
//
//   fa_fwd_wgmma_bf16  bf16 q, k, v: the tensor-core design below;
//   fa_fwd_simt_f32    f32 q, k, v: the first port's CUDA-core design,
//                      kept as it was (the tensor cores' TF32 would
//                      break the f32 tolerance).
//
// Both replace the Pallas TPU kernel src/repro/kernels/flash_attention.py
// `_fa_kernel` (wrapper `flash_attention`) and keep its arithmetic: f32
// scores `(q . k) * (1/sqrt(D))`, the finite sentinel NEG_INF = -1e30 for
// masked entries, end-aligned positions (q row i sits at i + Skv - Sq),
// the TPU kernel's whole-tile skip conditions (`block_needed`), running
// max/sum/accumulator in f32, rows whose sum stays 0 written as 0, output
// in q's dtype.  GQA: q head h reads kv head h / (Hq/Hkv); K and V are
// never repeated.
// Given a non-null `lse`, each also writes every row's log-sum-exp of
// its scaled scores, m + log(l) (`_fa_fwd_scan`'s lse,
// src/repro/kernels/ops.py:46), which the backward
// (flash_attention_bwd.cu) reads; with a null one nothing else changes.
//
// What bounds it on this card: at the model's shapes (S=4096, D=128,
// causal) the work is ~4*S*S/2*D flops per (batch, q head), far above the
// byte traffic, so attention is bound by operations — on the bf16 tensor
// cores (989 TFLOP/s), which only `wgmma` reaches.
//
// bf16 design.  One block of 256 threads (two warpgroups) per (128-row q
// tile, q head, batch); warpgroup w owns q rows 64w..64w+63.  The q
// tiles go heaviest first under a causal mask (grid y reversed, heads and
// batch in grid x), so the long rows of the causal triangle start in the
// first wave and the short ones fill its tail.  Per key tile of 128 keys:
//   - S = Q K^T: `wgmma.mma_async` m64n128k16, bf16 -> f32, A (Q) and B (K)
//     both from shared memory, K-major, D/16 k-steps;
//   - online softmax on the accumulator fragment in registers: each thread
//     holds two rows (g and g+8 of its warp's 16) and 32 columns of each;
//     row max and sum are reduced over the quad (lanes 4g..4g+3) with two
//     shuffles; masks are applied only on tiles that cross the diagonal,
//     the window's edge or Skv (interior tiles take the unmasked path);
//     exponentials are 2^x of (s - m) * log2(e) on the SFU;
//   - P is rounded to bf16 in registers, where the score accumulator's
//     layout is already the A-operand layout of the next product, and
//     O += P V runs as `wgmma` m64n64k16 with A from registers and V from
//     shared memory as the MN-major (transposed) B operand, one product
//     per 64-column panel of D.  This bf16 rounding of P is the one
//     rounding the f32 Pallas kernel does not make (its P V product is
//     f32); the sums l are taken over the unrounded f32 P.
// K and V tiles sit in a two-stage ring in shared memory, filled with
// `cp.async` (16 bytes a thread, zero-filled past Skv and past D): the
// next tile's copy is in flight while the current one is computed.  On
// each tile warpgroup 1 starts its Q K^T only when warpgroup 0's is done
// (a named barrier), so one warpgroup's softmax runs on the CUDA cores
// and the SFU while the other's products run on the tensor cores.  cp.async
// rather than TMA: one copy path handles the (B, S, H, D) strides, GQA,
// the ragged ends and the zero padding of D < 64 without tensor maps
// built on the host for every call; a TMA producer warp is the next step
// if the copies show up in the time.  Head dims 16, 32 and 64 are padded
// to one 64-column panel in shared memory (zeros), D = 128 takes two.
// Shared memory: Q 128 x max(D, 64), K and V two stages each of 128 x
// max(D, 64), bf16 (160 KB at D = 128): one block per SM.
//
// f32 design (unchanged): one block of 256 threads per (64-row q tile, q
// head, batch); thread t owns q row t/4 of the tile and, with its three
// row neighbours, splits that row's 64-key score tile and its D output
// columns; f32 FMAs from shared memory on the CUDA cores.
#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// --------------------------------------------------------------------
// f32: the CUDA-core kernel
// --------------------------------------------------------------------
namespace simt {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 4 threads per q row
constexpr int COLS = BK / 4;  // score columns per thread

// load rows [row0, row0 + 64) of one head of a (B, S, H, D) tensor into a
// (64, stride) f32 tile; rows past S are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* src, int b, int row0,
                                          int S, int H, int h) {
  for (int idx = threadIdx.x; idx < BQ * D; idx += THREADS) {
    int r = idx / D, d = idx % D;
    int s = row0 + r;
    float v = 0.f;
    if (s < S) v = src[(((int64_t)b * S + s) * H + h) * D + d];
    dst[r * stride + d] = v;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
fa_fwd_simt_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv,
                int causal, int window, float scale) {
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

  load_tile<D>(Qs, QS, q, b, q0, Sq, Hq, h);

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
    load_tile<D>(Ks, QS, k, b, k0, Skv, Hkv, hk);
    load_tile<D>(Vs, D, v, b, k0, Skv, Hkv, hk);
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
    for (int i = 0; i < D / 4; ++i) o[o_base + sub + 4 * i] = acc[i] * inv_l;
    if (lse != nullptr && sub == 0)
      lse[((int64_t)b * Hq + h) * Sq + row] = m + logf(l == 0.f ? 1.f : l);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                   int causal, int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * BQ * (D + 1) + BK * D);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_simt_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  fa_fwd_simt_f32<D><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, Sq,
      Skv, Hq, Hkv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace simt

// --------------------------------------------------------------------
// bf16: the tensor-core kernel
// --------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int BQ = 128;        // q rows per block, 64 per warpgroup
constexpr int BK = 128;        // keys per tile
constexpr int THREADS = 256;   // two warpgroups
constexpr int ROW = 128;       // bytes of one swizzled panel row (64 bf16)
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int DP = D < 64 ? 64 : D;   // columns in shared memory
  static constexpr int PANELS = DP / 64;       // 64-column panels
  static constexpr int KSTEPS = D / 16;        // k-steps of Q K^T
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2; // one K or V tile
  // Q, two stages of K and of V, and slack to align the base to 1024
  static constexpr int SMEM = Q_BYTES + 4 * KV_BYTES + 1024;
};

// Start copying rows [row0, row0 + R) of one head of a (B, S, H, D) bf16
// tensor into the swizzled tile at shared address `dst` (panels of R rows
// x 128 bytes); rows past S and columns past D are zero-filled.
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, int b,
                                          int row0, int S, int H, int h) {
  constexpr int CPR = Cfg<D>::DP / 8;          // 16-byte chunks per row
  static_assert((R * CPR) % THREADS == 0, "tile chunks per thread");
#pragma unroll
  for (int i = 0; i < R * CPR / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx / CPR, c = idx % CPR;
    const int s = row0 + r;
    const bool ok = s < S && c * 8 < D;
    const __nv_bfloat16* g =
        ok ? src + (((int64_t)b * S + s) * H + h) * D + c * 8 : src;
    const uint32_t at = (c >> 3) * (R * ROW) + r * ROW
                        + (((c & 7) ^ (r & 7)) << 4);
    cp_async_16(dst + at, g, ok ? 16 : 0);
  }
}

// Online softmax of one score tile `s` (this thread's two rows, 32
// columns each) into bf16 P fragments `p`, updating the running max `m`
// and this thread's partial row sums `l`, and rescaling the output
// accumulator.  EDGE: the tile crosses the diagonal, the window's edge or
// Skv, so entries are masked to NEG_INF; then the exponent is formed as
// (s - m) * log2(e), exact when s = m = NEG_INF (p = 1, as in the TPU
// kernel), instead of the fused s * log2(e) - m * log2(e).
template <bool EDGE, int PANELS>
__device__ __forceinline__ void softmax_tile(
    float (&s)[64], uint32_t (&p)[8][4], float (&m)[2], float (&l)[2],
    float (&o)[PANELS][32], float scale, int k0, int q_pos0, int Skv,
    int causal, int window, int t) {
  // EDGE: s becomes the masked, scaled score; otherwise s stays q . k
  // and the scale is folded into the exponent (max(s) * scale is the max
  // of the scaled scores: the scale is positive and rounding monotone)
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float x = s[4 * j + 2 * e + u];
        if (EDGE) {
          const int kp = k0 + 8 * j + 2 * t + u;
          const int qp = q_pos0 + 8 * e;
          bool ok = kp < Skv;
          if (causal) ok = ok && qp >= kp;
          if (window) ok = ok && (qp - kp) < window;
          x = ok ? x * scale : NEG_INF;
          s[4 * j + 2 * e + u] = x;
        }
        mx[e] = fmaxf(mx[e], x);
      }
    }
  }
  const float scale_log2e = scale * LOG2E;
  float alpha[2], mb[2], ls[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
    if (!EDGE) mx[e] *= scale;
    const float m_new = fmaxf(m[e], mx[e]);
    alpha[e] = ex2((m[e] - m_new) * LOG2E);
    m[e] = m_new;
    mb[e] = m_new * LOG2E;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float x0 = s[4 * j + 2 * e], x1 = s[4 * j + 2 * e + 1];
      float p0, p1;
      if (EDGE) {
        p0 = ex2((x0 - m[e]) * LOG2E);
        p1 = ex2((x1 - m[e]) * LOG2E);
      } else {
        p0 = ex2(fmaf(x0, scale_log2e, -mb[e]));
        p1 = ex2(fmaf(x1, scale_log2e, -mb[e]));
      }
      ls[e] += p0 + p1;
      // the accumulator's columns 16kk..16kk+15 are the A fragment of
      // k-step kk: registers (row g, cols 2t..), (row g+8, 2t..),
      // (row g, 8+2t..), (row g+8, 8+2t..)
      p[j >> 1][(j & 1) * 2 + e] = pack_bf16(p0, p1);
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) l[e] = l[e] * alpha[e] + ls[e];
#pragma unroll
  for (int pn = 0; pn < PANELS; ++pn)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        o[pn][4 * j + 2 * e] *= alpha[e];
        o[pn][4 * j + 2 * e + 1] *= alpha[e];
      }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fa_fwd_wgmma_bf16(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  int Sq, int Skv, int Hq, int Hkv, int causal, int window,
                  float scale) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;         // two stages
  const uint32_t sV = sK + 2 * C::KV_BYTES;    // two stages

  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hkv);
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int off = Skv - Sq;                    // end alignment

  // the key tiles the TPU kernel's block_needed keeps for this q tile
  int kt_hi = (Skv + BK - 1) / BK - 1;
  if (causal) kt_hi = min(kt_hi, (q0 + BQ - 1 + off) / BK);
  int kt_lo = 0;
  if (window) {
    const int x = q0 + off - window - (BK - 1);
    if (x >= 0) kt_lo = x / BK + 1;
  }

  const int tid = threadIdx.x;
  const int wg = tid >> 7;                     // warpgroup
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // this thread's accumulator rows: r0 and r0 + 8 of the block's tile
  const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + g;

  float acc[C::PANELS][32];
#pragma unroll
  for (int pn = 0; pn < C::PANELS; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pn][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float s[64];                                 // score tile (overwritten)
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;

  if (kt_lo <= kt_hi) {
    load_tile<D, BQ>(sQ, q, b, q0, Sq, Hq, h);
    load_tile<D, BK>(sK, k, b, kt_lo * BK, Skv, Hkv, hk);
    load_tile<D, BK>(sV, v, b, kt_lo * BK, Skv, Hkv, hk);
    cp_async_commit();
  }
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    if (kt < kt_hi) {                          // prefetch the next tile
      load_tile<D, BK>(sK + (stage ^ 1) * C::KV_BYTES, k, b, (kt + 1) * BK,
                       Skv, Hkv, hk);
      load_tile<D, BK>(sV + (stage ^ 1) * C::KV_BYTES, v, b, (kt + 1) * BK,
                       Skv, Hkv, hk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();                           // this tile is in place
    const uint32_t kS = sK + stage * C::KV_BYTES;
    const uint32_t vS = sV + stage * C::KV_BYTES;

    // S = Q K^T for this warpgroup's 64 rows.  Warpgroup 1 starts its
    // product only when warpgroup 0's is done, so that from then on one
    // warpgroup's softmax runs beside the other's products instead of
    // both contending for the tensor cores and then both for the SFU.
    if (wg == 1) named_barrier_sync(1, THREADS);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      const uint32_t col = (kk & 3) * 32;        // k-step in its panel
      const uint64_t da = sw128_desc(
          sQ + (kk >> 2) * (BQ * ROW) + wg * 64 * ROW + col, 16);
      const uint64_t db = sw128_desc(kS + (kk >> 2) * (BK * ROW) + col, 16);
      wgmma_m64n128k16_ss(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) reg_fence(s[i]);
    if (wg == 0) named_barrier_arrive(1, THREADS);

    const int k0 = kt * BK;
    const bool edge = k0 + BK > Skv
                      || (causal && k0 + BK - 1 > q0 + off)
                      || (window && k0 <= q0 + BQ - 1 + off - window);
    uint32_t p[8][4];
    if (edge)
      softmax_tile<true, C::PANELS>(s, p, m, l, acc, scale, k0,
                                    q0 + r0 + off, Skv, causal, window, t);
    else
      softmax_tile<false, C::PANELS>(s, p, m, l, acc, scale, k0,
                                     q0 + r0 + off, Skv, causal, window, t);

    // O += P V: 8 k-steps of 16 keys, one product per 64-column panel
#pragma unroll
    for (int pn = 0; pn < C::PANELS; ++pn)
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(acc[pn][i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int pn = 0; pn < C::PANELS; ++pn)
        wgmma_m64n64k16_rs(
            acc[pn], p[kk],
            sw128_desc(vS + pn * (BK * ROW) + kk * 16 * ROW, 1024));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int pn = 0; pn < C::PANELS; ++pn)
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(acc[pn][i]);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) reg_fence(p[kk][i]);
    __syncthreads();                           // stage free for refill
  }

  // epilogue: full row sums over the quad, O / l (0 where l stays 0)
  float inv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    inv[e] = 1.f / (l[e] == 0.f ? 1.f : l[e]);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = q0 + r0 + 8 * e;
    if (row >= Sq) continue;
    // the log-sum-exp of the row's scaled scores, for the backward: m
    // is the same on the quad's four lanes, l their reduced sum
    if (lse != nullptr && t == 0)
      lse[((int64_t)b * Hq + h) * Sq + row] =
          m[e] + logf(l[e] == 0.f ? 1.f : l[e]);
    __nv_bfloat16* orow = o + (((int64_t)b * Sq + row) * Hq + h) * D;
#pragma unroll
    for (int pn = 0; pn < C::PANELS; ++pn)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = pn * 64 + 8 * j + 2 * t;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[pn][4 * j + 2 * e] * inv[e],
                                    acc[pn][4 * j + 2 * e + 1] * inv[e]);
      }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                   int causal, int window, cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_wgmma_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  fa_fwd_wgmma_bf16<D><<<grid, THREADS, C::SMEM, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, lse, Sq, Skv, Hq, Hkv,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace tc

#define FA_DISPATCH_D(NS)                                                  \
  switch (D) {                                                             \
    case 16: return (int)NS::launch<16>(q, k, v, o, (float*)lse, B, Sq,    \
                                        Skv, Hq, Hkv, causal, window, s);  \
    case 32: return (int)NS::launch<32>(q, k, v, o, (float*)lse, B, Sq,    \
                                        Skv, Hq, Hkv, causal, window, s);  \
    case 64: return (int)NS::launch<64>(q, k, v, o, (float*)lse, B, Sq,    \
                                        Skv, Hq, Hkv, causal, window, s);  \
    case 128: return (int)NS::launch<128>(q, k, v, o, (float*)lse, B, Sq,  \
                                          Skv, Hq, Hkv, causal, window,    \
                                          s);                              \
    default: return (int)cudaErrorInvalidValue;                            \
  }

}  // namespace

extern "C" {

// q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), o (B, Sq, Hq, D), contiguous,
// all float32 (fa_fwd_simt_f32) or all bfloat16 with 16-byte-aligned
// bases (fa_fwd_wgmma_bf16); D in {16, 32, 64, 128}; Hq % Hkv == 0;
// Sq <= Skv.  lse: null, or float32 (B, Hq, Sq) that receives each row's
// log-sum-exp m + log(l) of its scaled scores (the backward's input).
// Each returns the launch's cudaError_t.
int flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int Sq, int Skv,
                            int Hq, int Hkv, int D, int causal, int window,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  FA_DISPATCH_D(simt)
}

int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int Sq, int Skv,
                             int Hq, int Hkv, int D, int causal,
                             int window, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  FA_DISPATCH_D(tc)
}

}  // extern "C"
