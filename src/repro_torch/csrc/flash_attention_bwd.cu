// Flash attention backward for Hopper, sm_90a.
//
// The reference has no backward kernel: src/repro/kernels/ops.py::_fa_bwd
// reruns the jnp oracle under jax.vjp, which materialises the float32 scores
// (0.94 GB a layer at qwen2-0.5b's batch 4 x 2048). This is the
// FlashAttention-2 backward (arXiv 2307.08691, Alg. 2) of flash_attention.cu:
// from q, k, v (B,S,H|K,hd), the forward's output o, its log-sum-exp lse
// (B,H,Sq) float32 and the output's gradient dO, it recomputes
// P = exp(S - lse) tile by tile and returns dq, dk, dv in q's type:
//   D = rowsum(dO * O)                       (pre-pass, float32 (B,H,Sq))
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D) * (1 - (s/cap)^2 with a cap)
//   dK = dS^T Q * scale   (pass 1: a block owns one K/V tile of one (b, kv head))
//   dQ = dS K * scale     (pass 2: a block owns a tile of folded query rows)
// Masking, the GQA fold (row = q * G + g) and the causal / window tile
// skipping follow the forward. In pass 1 a block walks the folded G*Sq rows
// from its causal frontier up to its window edge, so dK and dV sum the G
// heads in registers.
//
// Deterministic: no atomics. dQ is not accumulated across the key blocks of
// pass 1 (FA2's float atomics, whose order changes from run to run) but
// computed by its own pass, which recomputes S, P and dP. That costs 7 tile
// products instead of 5: 1.4x the backward's counted operations (which are
// 2.5x the forward's). Exact resume of a crashed training run relies on
// gradients that repeat bit for bit.
//
// What bounds it: operations, as the forward. Tensor-core variant (bfloat16,
// hd 64 and 128): 4 warps of 16 rows, mma.sync.m16n8k16 bf16 products with
// float32 accumulators, ldmatrix from padded shared rows, and a
// double-buffered cp.async ring for the tiles a block streams (Q/dO row
// tiles in pass 1, K/V tiles in pass 2); P and dS are rounded to bf16 as
// product operands, dK, dV and dQ accumulate in float32. CUDA-core variant
// (float32 at every head dim, bfloat16 at hd 8, 16, 32 and 256): hd/8 threads
// own a key (pass 1) or a query row (pass 2), 8 dims each, with shuffle
// reductions for the dot products, as the forward's CUDA-core variant.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ bool visible(int qi, int key, int causal, int window) {
  return (!causal || key <= qi) && (window <= 0 || qi - key < window);
}

// ---- D = rowsum(dO * O): one warp a row --------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dO, float* __restrict__ delta,
             int Sq, int H, int HD, long long rows) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32) acc += to_f(o[row * HD + d]) * to_f(dO[row * HD + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {  // row = (b * Sq + qi) * H + h -> delta (B,H,Sq)
    const long long b = row / ((long long)Sq * H), rem = row % ((long long)Sq * H);
    delta[(b * H + rem % H) * Sq + rem / H] = acc;
  }
}

// ---- CUDA-core variant ------------------------------------------------------

template <int HD>
struct Tiling {
  static constexpr int kTpr = HD >= 8 ? HD / 8 : 1;  // threads per key / row
  static constexpr int kDpt = HD / kTpr;             // dims per thread
  static constexpr int kRows = kThreads / kTpr;      // keys (pass 1) or rows (pass 2) a block
  static constexpr int kTile = HD <= 64 ? 64 : (HD <= 128 ? 32 : 16);  // staged rows / keys
};

template <int TPR>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// pass 1: dK, dV for kRows keys of one (b, kv head)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dO, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
            int Sq, int Sk, int H, int K, int causal, int window, float cap, float scale) {
  using Tl = Tiling<HD>;
  constexpr int TPR = Tl::kTpr, DPT = Tl::kDpt, NK = Tl::kRows, R = Tl::kTile;
  __shared__ float qs[R][HD];
  __shared__ float dos[R][HD];
  __shared__ float ls[R], dl[R];
  __shared__ int qpos[R];

  const int G = H / K;
  const int kvh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int lane = tid % TPR;
  const int k0 = blockIdx.x * NK;
  const int key = k0 + tid / TPR;
  const bool key_ok = key < Sk;
  const int k_last = min(Sk, k0 + NK) - 1;
  // the folded rows whose queries see a key of this block
  const int r_begin = causal ? k0 * G : 0;
  const int r_end = (window > 0 ? min(Sq, k_last + window) : Sq) * G;

  const size_t kv_off = (((size_t)b * Sk + (key_ok ? key : 0)) * K + kvh) * HD;
  float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    kr[i] = key_ok ? to_f(k[kv_off + lane + TPR * i]) : 0.f;
    vr[i] = key_ok ? to_f(v[kv_off + lane + TPR * i]) : 0.f;
    dka[i] = dva[i] = 0.f;
  }

  for (int r = r_begin; r < r_end; r += R) {
    __syncthreads();  // the previous tile has been consumed
    for (int idx = tid; idx < R * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD, rr = r + j;
      float qx = 0.f, dx = 0.f;
      if (rr < r_end) {
        const size_t off = (((size_t)b * Sq + rr / G) * H + (size_t)kvh * G + rr % G) * HD + d;
        qx = to_f(q[off]);
        dx = to_f(dO[off]);
      }
      qs[j][d] = qx;
      dos[j][d] = dx;
    }
    for (int j = tid; j < R; j += kThreads) {
      const int rr = r + j;
      const bool ok = rr < r_end;
      const size_t li = ((size_t)b * H + (size_t)kvh * G + rr % G) * Sq + rr / G;
      ls[j] = ok ? lse[li] : 0.f;
      dl[j] = ok ? delta[li] : 0.f;
      qpos[j] = ok ? rr / G : -1;
    }
    __syncthreads();

    const int n = min(R, r_end - r);  // block-uniform
    for (int j = 0; j < n; ++j) {
      float part = 0.f, dpart = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        part += qs[j][lane + TPR * i] * kr[i];
        dpart += dos[j][lane + TPR * i] * vr[i];
      }
      part = group_sum<TPR>(part);
      dpart = group_sum<TPR>(dpart);
      float x = part * scale;
      if (cap > 0.f) x = cap * tanhf(x / cap);
      const bool ok = key_ok && visible(qpos[j], key, causal, window);
      const float p = ok ? expf(x - ls[j]) : 0.f;
      float ds = p * (dpart - dl[j]);
      if (cap > 0.f) ds *= 1.f - (x / cap) * (x / cap);
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        dva[i] += p * dos[j][lane + TPR * i];
        dka[i] += ds * qs[j][lane + TPR * i];
      }
    }
  }
  if (key_ok) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      store(&dk[kv_off + lane + TPR * i], dka[i] * scale);
      store(&dv[kv_off + lane + TPR * i], dva[i]);
    }
  }
}

// pass 2: dQ for kRows folded query rows of one (b, kv head)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dO, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int H,
          int K, int causal, int window, float cap, float scale) {
  using Tl = Tiling<HD>;
  constexpr int TPR = Tl::kTpr, DPT = Tl::kDpt, NR = Tl::kRows, BK = Tl::kTile;
  __shared__ float ks[BK][HD];
  __shared__ float vs[BK][HD];

  const int G = H / K;
  const int kvh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int lane = tid % TPR;
  const int row = blockIdx.x * NR + tid / TPR;  // = qi * G + g
  const int qi = row / G, g = row % G;
  const bool row_ok = qi < Sq;
  const int q_first = (blockIdx.x * NR) / G;
  const int q_last = min(Sq - 1, (blockIdx.x * NR + NR - 1) / G);
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;

  const size_t q_off = (((size_t)b * Sq + (row_ok ? qi : 0)) * H + (size_t)kvh * G + g) * HD;
  const size_t li = ((size_t)b * H + (size_t)kvh * G + g) * Sq + (row_ok ? qi : 0);
  const float lr = row_ok ? lse[li] : 0.f;
  const float dr = row_ok ? delta[li] : 0.f;
  float qr[DPT], dor[DPT], dqa[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = row_ok ? to_f(q[q_off + lane + TPR * i]) : 0.f;
    dor[i] = row_ok ? to_f(dO[q_off + lane + TPR * i]) : 0.f;
    dqa[i] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD, key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < k_end) {
        const size_t off = (((size_t)b * Sk + key) * K + kvh) * HD + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
    __syncthreads();
    const int n = min(BK, k_end - k0);  // block-uniform
    for (int j = 0; j < n; ++j) {
      float part = 0.f, dpart = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        part += qr[i] * ks[j][lane + TPR * i];
        dpart += dor[i] * vs[j][lane + TPR * i];
      }
      part = group_sum<TPR>(part);
      dpart = group_sum<TPR>(dpart);
      float x = part * scale;
      if (cap > 0.f) x = cap * tanhf(x / cap);
      const bool ok = row_ok && visible(qi, k0 + j, causal, window);
      const float p = ok ? expf(x - lr) : 0.f;
      float ds = p * (dpart - dr);
      if (cap > 0.f) ds *= 1.f - (x / cap) * (x / cap);
#pragma unroll
      for (int i = 0; i < DPT; ++i) dqa[i] += ds * ks[j][lane + TPR * i];
    }
  }
  if (row_ok) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) store(&dq[q_off + lane + TPR * i], dqa[i] * scale);
  }
}

// ---- tensor-core variant (bf16, hd 64 and 128) ------------------------------

template <int HD>
struct TcTiling {
  static constexpr int kThreads = 128;               // 4 warps, 16 rows each
  static constexpr int kBN = 64;                     // pass 1: keys a block
  static constexpr int kBM = HD <= 64 ? 64 : 32;     // pass 1: folded rows a step
  static constexpr int kBQ = 64;                     // pass 2: folded rows a block
  static constexpr int kBK = 64;                     // pass 2: keys a step
  static constexpr int kSt = HD + 8;                 // padded shared row, bf16 elements
  static constexpr int kSmem1 = (2 * kBN + 4 * kBM) * kSt * 2 + 4 * kBM * 4;
  static constexpr int kSmem2 = (2 * kBQ + 4 * kBK) * kSt * 2;
};

// pass 1: dK, dV for kBN keys of one (b, kv head)
template <int HD>
__global__ void __launch_bounds__(128)
dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dO,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H, int K,
               int causal, int window, float cap, float scale) {
  using C = TcTiling<HD>;
  constexpr int BN = C::kBN, BM = C::kBM, ST = C::kSt, NT = C::kThreads;
  constexpr int ND = HD / 8, NM = BM / 8, CH = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [BN][ST]
  bf16* vs = ks + BN * ST;                   // [BN][ST]
  bf16* qs = vs + BN * ST;                   // [2][BM][ST]
  bf16* dos = qs + 2 * BM * ST;              // [2][BM][ST]
  float* ls = reinterpret_cast<float*>(dos + 2 * BM * ST);  // [2][BM]
  float* dl = ls + 2 * BM;                                  // [2][BM]

  const int G = H / K;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * BN;
  const int k_last = min(Sk, k0 + BN) - 1;
  const int r_begin = causal ? k0 * G / BM * BM : 0;
  const int r_end = (window > 0 ? min(Sq, k_last + window) : Sq) * G;

  for (int c = tid; c < BN * CH; c += NT) {
    const int j = c / CH, cc = (c % CH) * 8, key = k0 + j;
    const bool ok = key < Sk;
    const size_t off = ok ? (((size_t)b * Sk + key) * K + kvh) * HD + cc : 0;
    cp_async16(ks + j * ST + cc, k + off, ok);
    cp_async16(vs + j * ST + cc, v + off, ok);
  }
  auto load_rows = [&](int r, int buf) {
    for (int c = tid; c < BM * CH; c += NT) {
      const int j = c / CH, cc = (c % CH) * 8, rr = r + j;
      const bool ok = rr < r_end;
      const size_t off =
          ok ? (((size_t)b * Sq + rr / G) * H + (size_t)kvh * G + rr % G) * HD + cc : 0;
      cp_async16(qs + (buf * BM + j) * ST + cc, q + off, ok);
      cp_async16(dos + (buf * BM + j) * ST + cc, dO + off, ok);
    }
    for (int j = tid; j < BM; j += NT) {
      const int rr = r + j;
      const bool ok = rr < r_end;
      const size_t li = ((size_t)b * H + (size_t)kvh * G + rr % G) * Sq + rr / G;
      ls[buf * BM + j] = ok ? lse[li] : 0.f;
      dl[buf * BM + j] = ok ? delta[li] : 0.f;
    }
  };

  // this thread's keys: warp*16 + lane/4 (acc[.][0..1]) and + 8 (acc[.][2..3])
  const int key_a = k0 + warp * 16 + (lane >> 2);
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  if (r_begin < r_end) load_rows(r_begin, 0);
  cp_async_commit();
  int buf = 0;
  for (int r = r_begin; r < r_end; r += BM, buf ^= 1) {
    if (r + BM < r_end) {
      load_rows(r + BM, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = qs + buf * BM * ST;
    const bf16* dot = dos + buf * BM * ST;
    const float* lt = ls + buf * BM;
    const float* dt = dl + buf * BM;

    // S^T = K Q^T: 16 keys x BM rows a warp; then the capped, masked scores
    float st[NM][4];
#pragma unroll
    for (int n = 0; n < NM; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
    mma_abt<HD, NM, ST>(st, ks + warp * 16 * ST, qt, lane);
    const int q_lo = r / G, q_hi = (r + BM - 1) / G;
    const bool edge = (causal && q_lo < k_last) || (window > 0 && q_hi - k0 >= window) ||
                      k0 + BN > Sk || r + BM > r_end;
#pragma unroll
    for (int n = 0; n < NM; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = st[n][e] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        if (edge) {
          const int rr = r + n * 8 + ((lane & 3) << 1) + (e & 1);
          const int key = key_a + ((e >> 1) << 3);
          if (rr >= r_end || key >= Sk || !visible(rr / G, key, causal, window)) x = -INFINITY;
        }
        st[n][e] = x;
      }
    }

    // dV += P^T dO
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      float p[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = (2 * kk + h) * 8 + ((lane & 3) << 1) + (e & 1);
          p[h][e] = exp2f((st[2 * kk + h][e] - lt[col]) * kLog2e);
        }
      const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
      mma_ab<HD, ST>(dva, pa, dot + kk * 16 * ST, lane);
    }

    // dP^T = V dO^T; dS^T = P^T * (dP^T - D) (* the softcap factor)
    float dp[NM][4];
#pragma unroll
    for (int n = 0; n < NM; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    mma_abt<HD, NM, ST>(dp, vs + warp * 16 * ST, dot, lane);

    // dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      float ds[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 2 * kk + h;
          const int col = n * 8 + ((lane & 3) << 1) + (e & 1);
          const float x = st[n][e];
          const float p = exp2f((x - lt[col]) * kLog2e);
          float d = p * (dp[n][e] - dt[col]);
          if (cap > 0.f && p > 0.f) d *= 1.f - (x / cap) * (x / cap);
          ds[h][e] = d;
        }
      const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                              pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
      mma_ab<HD, ST>(dka, da, qt + kk * 16 * ST, lane);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_a + 8 * i;
    if (key >= Sk) continue;
    const size_t off = (((size_t)b * Sk + key) * K + kvh) * HD + ((lane & 3) << 1);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8) =
          pack_bf16(dka[n][2 * i] * scale, dka[n][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8) =
          pack_bf16(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

// pass 2: dQ for kBQ folded query rows of one (b, kv head)
template <int HD>
__global__ void __launch_bounds__(128)
dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int Sq, int Sk, int H, int K, int causal, int window,
             float cap, float scale) {
  using C = TcTiling<HD>;
  constexpr int BQ = C::kBQ, BK = C::kBK, ST = C::kSt, NT = C::kThreads;
  constexpr int ND = HD / 8, NN = BK / 8, CH = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [BQ][ST]
  bf16* dos = qs + BQ * ST;                  // [BQ][ST]
  bf16* ks = dos + BQ * ST;                  // [2][BK][ST]
  bf16* vs = ks + 2 * BK * ST;               // [2][BK][ST]

  const int G = H / K;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal rows first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q_first = r0 / G;
  const int q_last = min(Sq - 1, (r0 + BQ - 1) / G);
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) / BK * BK : 0;

  for (int c = tid; c < BQ * CH; c += NT) {
    const int rr = c / CH, cc = (c % CH) * 8;
    const int r = r0 + rr, qi = r / G;
    const bool ok = qi < Sq;
    const size_t off = ok ? (((size_t)b * Sq + qi) * H + (size_t)kvh * G + r % G) * HD + cc : 0;
    cp_async16(qs + rr * ST + cc, q + off, ok);
    cp_async16(dos + rr * ST + cc, dO + off, ok);
  }
  auto load_kv = [&](int kb, int buf) {
    for (int c = tid; c < BK * CH; c += NT) {
      const int j = c / CH, cc = (c % CH) * 8, key = kb + j;
      const bool ok = key < Sk;
      const size_t off = ok ? (((size_t)b * Sk + key) * K + kvh) * HD + cc : 0;
      cp_async16(ks + (buf * BK + j) * ST + cc, k + off, ok);
      cp_async16(vs + (buf * BK + j) * ST + cc, v + off, ok);
    }
  };
  load_kv(k_begin, 0);
  cp_async_commit();

  // this thread's rows: warp*16 + lane/4 (acc[.][0..1]) and + 8 (acc[.][2..3])
  const int ra = r0 + warp * 16 + (lane >> 2);
  float lr[2], dr[2];
  int qr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 8 * i;
    qr[i] = r / G;
    const bool ok = qr[i] < Sq;
    const size_t li = ((size_t)b * H + (size_t)kvh * G + r % G) * Sq + (ok ? qr[i] : 0);
    lr[i] = ok ? lse[li] : 0.f;
    dr[i] = ok ? delta[li] : 0.f;
  }
  float dqa[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  int buf = 0;
  for (int kb = k_begin; kb < k_end; kb += BK, buf ^= 1) {
    if (kb + BK < k_end) {
      load_kv(kb + BK, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + buf * BK * ST;
    const bf16* vt = vs + buf * BK * ST;

    // S = Q K^T and dP = dO V^T: 16 rows x BK keys a warp
    float s[NN][4], dp[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<HD, NN, ST>(s, qs + warp * 16 * ST, kt, lane);
    mma_abt<HD, NN, ST>(dp, dos + warp * 16 * ST, vt, lane);

    const bool edge = (causal && kb + BK - 1 > q_first) ||
                      (window > 0 && q_last - kb >= window) || kb + BK > Sk;
    // dS = P * (dP - D) (* the softcap factor); dQ += dS K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      float ds[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 2 * kk + h, i = e >> 1;
          float x = s[n][e] * scale;
          if (cap > 0.f) x = cap * tanhf(x / cap);
          float p = exp2f((x - lr[i]) * kLog2e);
          if (edge) {
            const int key = kb + n * 8 + ((lane & 3) << 1) + (e & 1);
            if (key >= Sk || !visible(qr[i], key, causal, window)) p = 0.f;
          }
          float d = p * (dp[n][e] - dr[i]);
          if (cap > 0.f) d *= 1.f - (x / cap) * (x / cap);
          ds[h][e] = d;
        }
      const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                              pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
      mma_ab<HD, ST>(dqa, da, kt + kk * 16 * ST, lane);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 8 * i;
    if (qr[i] >= Sq) continue;
    bf16* row = dq + (((size_t)b * Sq + qr[i]) * H + (size_t)kvh * G + r % G) * HD +
                ((lane & 3) << 1);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) =
          pack_bf16(dqa[n][2 * i] * scale, dqa[n][2 * i + 1] * scale);
  }
}

struct Args {
  const void *q, *k, *v, *o, *dO;
  const float* lse;
  void *dq, *dk, *dv;
  float* delta;
  int B, Sq, Sk, H, K, causal, window;
  float cap, scale;
  cudaStream_t s;
};

template <typename T>
cudaError_t launch_delta(const Args& a, int hd) {
  const long long rows = (long long)a.B * a.Sq * a.H;
  const long long nb = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (nb > 0x7fffffffLL) return cudaErrorInvalidValue;
  delta_kernel<T><<<(unsigned)nb, kThreads, 0, a.s>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dO), a.delta, a.Sq, a.H, hd, rows);
  return cudaSuccess;
}

template <typename T, int HD>
cudaError_t launch(const Args& a) {
  using Tl = Tiling<HD>;
  const int G = a.H / a.K;
  const long long nk = (a.Sk + Tl::kRows - 1) / Tl::kRows;
  const long long nq = ((long long)G * a.Sq + Tl::kRows - 1) / Tl::kRows;
  if (nq > 0x7fffffffLL || a.K > 65535 || a.B > 65535) return cudaErrorInvalidValue;
  cudaError_t err = launch_delta<T>(a, HD);
  if (err != cudaSuccess) return err;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *dO = static_cast<const T*>(a.dO);
  dkdv_kernel<T, HD><<<dim3((unsigned)nk, a.K, a.B), kThreads, 0, a.s>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Sq, a.Sk,
      a.H, a.K, a.causal, a.window, a.cap, a.scale);
  dq_kernel<T, HD><<<dim3((unsigned)nq, a.K, a.B), kThreads, 0, a.s>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<T*>(a.dq), a.Sq, a.Sk, a.H, a.K, a.causal,
      a.window, a.cap, a.scale);
  return cudaSuccess;
}

template <int HD>
cudaError_t launch_tc(const Args& a) {
  using C = TcTiling<HD>;
  static const cudaError_t attr1 = cudaFuncSetAttribute(
      dkdv_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem1);
  static const cudaError_t attr2 = cudaFuncSetAttribute(
      dq_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem2);
  if (attr1 != cudaSuccess) return attr1;
  if (attr2 != cudaSuccess) return attr2;
  const int G = a.H / a.K;
  const long long nk = (a.Sk + C::kBN - 1) / C::kBN;
  const long long nq = ((long long)G * a.Sq + C::kBQ - 1) / C::kBQ;
  if (nq > 0x7fffffffLL || a.K > 65535 || a.B > 65535) return cudaErrorInvalidValue;
  cudaError_t err = launch_delta<bf16>(a, HD);
  if (err != cudaSuccess) return err;
  const bf16 *q = static_cast<const bf16*>(a.q), *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v), *dO = static_cast<const bf16*>(a.dO);
  dkdv_tc_kernel<HD><<<dim3((unsigned)nk, a.K, a.B), C::kThreads, C::kSmem1, a.s>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.Sq,
      a.Sk, a.H, a.K, a.causal, a.window, a.cap, a.scale);
  dq_tc_kernel<HD><<<dim3((unsigned)nq, a.K, a.B), C::kThreads, C::kSmem2, a.s>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<bf16*>(a.dq), a.Sq, a.Sk, a.H, a.K, a.causal,
      a.window, a.cap, a.scale);
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(int hd, const Args& a) {
  switch (hd) {
    case 8: return launch<T, 8>(a);
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    case 256: return launch<T, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/o/dO/dq (B,Sq,H,hd), k/v/dk/dv
// (B,Sk,K,hd), lse and delta (scratch for D) (B,H,Sq) float32, all
// contiguous. Launches the D pre-pass, the dK/dV pass and the dQ pass on
// ``stream``. Returns a cudaError_t: the launches', else cudaGetLastError().
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                   const void* o, const void* dO, const void* lse, void* dq,
                                   void* dk, void* dv, void* delta, int B, int Sq, int Sk,
                                   int H, int K, int hd, int causal, int window,
                                   float softcap, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || K <= 0 || H % K != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dO, static_cast<const float*>(lse), dq, dk, dv,
               static_cast<float*>(delta), B, Sq, Sk, H, K, causal, window, softcap,
               scale, static_cast<cudaStream_t>(stream)};
  // the tensor-core variant copies 16-byte chunks
  if (dtype == 1 && (hd == 64 || hd == 128) &&
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dO) & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(hd, a);
  else if (dtype == 1 && hd == 64)
    err = launch_tc<64>(a);
  else if (dtype == 1 && hd == 128)
    err = launch_tc<128>(a);
  else if (dtype == 1)
    err = dispatch<bf16>(hd, a);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
