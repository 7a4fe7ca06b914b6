// Flash attention (prefill and training forward) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel). Computes causal / sliding-window / tanh-softcapped GQA
// attention of q (B,Sq,H,hd) against k/v (B,Sk,K,hd) at implicit arange
// positions, with a streaming softmax whose (m, l, acc) state is float32.
// Optionally writes each row's log-sum-exp m + log(l) in float32, laid out
// (B,H,Sq) contiguous with h = kv_head * G + g; the backward kernel
// (flash_attention_bwd.cu) reads it. A null pointer skips it (serving).
//
// Both variants give one thread block a tile of query rows of one (batch, kv
// head). The G query heads of the kv group are folded into the tile's rows
// (row = q * G + g), so the G heads share every K/V tile staged in shared
// memory. The block walks K/V tiles only up to the causal frontier of its
// last row and from the window edge of its first row; the ragged last tile
// is masked, so any Sq == Sk works. Masking follows the reference: masked
// scores are the finite -1e30 and l is clamped at 1e-30.
//
// Tensor-core variant: bfloat16 at hd 64 and 128, the training path.
// What bounds it: operations (4*hd FLOPs per causal (q, k) pair of each
// head, ~300 per byte moved at the training shape), so the products must run
// on the tensor cores. Design (FlashAttention-2): 4 warps, 64 folded rows
// (16 a warp) against K/V tiles of 64 keys. S = Q K^T and O += P V are
// mma.sync.m16n8k16 bf16 products with float32 accumulators, fed by ldmatrix
// from shared memory whose rows are padded by 16 bytes (no bank conflicts).
// K/V tiles stream through a double-buffered ring in dynamic shared memory by
// cp.async, the next tile in flight while the current one is used. The
// softmax state stays in registers; P is rounded to bf16 for P V, where the
// oracle rounds its probabilities too (models/layers.py, probs.to(v.dtype)).
// Blocks run the longest causal row tiles first. mma.sync, not wgmma: it is
// a warp-level instruction that needs no shared-memory descriptors or
// warpgroup fences, so a kernel can be checked one warp's fragment at a time;
// wgmma with TMA and warp specialisation is the next step up (later work).
//
// CUDA-core variant: float32 at every head dim (serving runs float32, and
// TF32 would not hold its 1e-4 tolerances), and bfloat16 at hd 8, 16, 32 and
// 256. Each row is owned by hd/8 threads holding 8 of its dims each (dims
// lane + TPR*i); a row's dot product is a shuffle reduction over them; K/V
// tiles are staged as float32 in static shared memory (32 KB at every hd: 64
// keys at hd <= 64, 32 at hd 128, 16 at hd 256).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

// ---- CUDA-core variant ------------------------------------------------------

template <int HD>
struct Tiling {
  static constexpr int kTpr = HD >= 8 ? HD / 8 : 1;  // threads per query row
  static constexpr int kDpt = HD / kTpr;             // dims per thread
  static constexpr int kRows = kThreads / kTpr;      // query rows per block
  static constexpr int kBk = HD <= 64 ? 64 : (HD <= 128 ? 32 : 16);  // keys per tile
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
             int Sq, int Sk, int H, int K, int causal, int window, float cap,
             float scale) {
  using Tl = Tiling<HD>;
  constexpr int TPR = Tl::kTpr, DPT = Tl::kDpt, R = Tl::kRows, BK = Tl::kBk;
  __shared__ float ks[BK][HD];
  __shared__ float vs[BK][HD];

  const int G = H / K;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % TPR;
  const int row = blockIdx.x * R + tid / TPR;  // = qi * G + g
  const int qi = row / G;
  const int g = row % G;
  const bool row_ok = qi < Sq;

  // block-uniform key range: every thread runs the same tiles, so the
  // barriers and full-warp shuffles below are safe
  const int q_first = (blockIdx.x * R) / G;
  const int q_last = min(Sq - 1, (blockIdx.x * R + R - 1) / G);
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;

  const size_t q_off = (((size_t)b * Sq + (row_ok ? qi : 0)) * H + (size_t)kvh * G + g) * HD;
  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = row_ok ? to_f(q[q_off + lane + TPR * i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile has been consumed
    for (int idx = tid; idx < BK * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD;
      const int key = k0 + j;
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

    float s[BK];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part += qr[i] * ks[j][lane + TPR * i];
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      float sc = part * scale;
      if (cap > 0.f) sc = cap * tanhf(sc / cap);
      const int dpos = qi - (k0 + j);
      const bool ok = (!causal || dpos >= 0) && (window <= 0 || dpos < window);
      s[j] = ok ? sc : kNegInf;
      if (k0 + j < k_end) tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      if (k0 + j < k_end) {
        const float p = expf(s[j] - m_new);
        l += p;
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] += p * vs[j][lane + TPR * i];
      }
    }
    m = m_new;
  }

  if (row_ok) {
    const float lc = fmaxf(l, 1e-30f);
    const float inv = 1.f / lc;
#pragma unroll
    for (int i = 0; i < DPT; ++i) store(&o[q_off + lane + TPR * i], acc[i] * inv);
    if (lse != nullptr && lane == 0)
      lse[((size_t)b * H + (size_t)kvh * G + g) * Sq + qi] = m + logf(lc);
  }
}

// ---- tensor-core variant (bf16, hd 64 and 128) ------------------------------

template <int HD>
struct TcTiling {
  static constexpr int kThreads = 128;  // 4 warps
  static constexpr int kBM = 64;        // folded query rows per block, 16 a warp
  static constexpr int kBN = 64;        // keys per K/V tile
  static constexpr int kSt = HD + 8;    // padded shared row, bf16 elements
  static constexpr int kSmem = (kBM + 4 * kBN) * kSt * (int)sizeof(bf16);  // Q; 2 x (K, V)
};

template <int HD>
__global__ void __launch_bounds__(128)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                float* __restrict__ lse, int Sq, int Sk, int H, int K, int causal,
                int window, float cap, float scale) {
  using C = TcTiling<HD>;
  constexpr int BM = C::kBM, BN = C::kBN, ST = C::kSt, NT = C::kThreads;
  constexpr int KD = HD / 16, ND = HD / 8, NN = BN / 8, CH = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [BM][ST]
  bf16* ks = qs + BM * ST;                   // [2][BN][ST]
  bf16* vs = ks + 2 * BN * ST;               // [2][BN][ST]

  const int G = H / K;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;  // the longest causal rows first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q_first = r0 / G;
  const int q_last = min(Sq - 1, (r0 + BM - 1) / G);
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) / BN * BN : 0;

  for (int c = tid; c < BM * CH; c += NT) {
    const int rr = c / CH, cc = (c % CH) * 8;
    const int r = r0 + rr, qi = r / G;
    const bool ok = qi < Sq;
    const size_t off = ok ? (((size_t)b * Sq + qi) * H + (size_t)kvh * G + r % G) * HD + cc : 0;
    cp_async16(qs + rr * ST + cc, q + off, ok);
  }
  auto load_kv = [&](int k0, int buf) {
    for (int c = tid; c < BN * CH; c += NT) {
      const int j = c / CH, cc = (c % CH) * 8;
      const int key = k0 + j;
      const bool ok = key < Sk;
      const size_t off = ok ? (((size_t)b * Sk + key) * K + kvh) * HD + cc : 0;
      cp_async16(ks + (buf * BN + j) * ST + cc, k + off, ok);
      cp_async16(vs + (buf * BN + j) * ST + cc, v + off, ok);
    }
  };
  load_kv(k_begin, 0);
  cp_async_commit();

  // this thread's rows of the tile: warp*16 + lane/4 (d[0], d[1]) and + 8 (d[2], d[3])
  const int ra = r0 + warp * 16 + (lane >> 2);
  const int qa = ra / G, qb = (ra + 8) / G;
  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BN, buf ^= 1) {
    if (k0 + BN < k_end) {
      load_kv(k0 + BN, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (k0 == k_begin) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qf[kk], qs + (warp * 16 + a_row(lane)) * ST + kk * 16 + a_col(lane));
    }
    const bf16* kt = ks + buf * BN * ST;
    const bf16* vt = vs + buf * BN * ST;

    // S = Q K^T, 16 rows x BN keys a warp
    float s[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int n = 0; n < NN; n += 2) {
        uint32_t bb[4];
        ldsm_x4(bb, kt + (n * 8 + bn_row(lane)) * ST + kk * 16 + bn_col(lane));
        mma16816(s[n], qf[kk], bb[0], bb[1]);
        mma16816(s[n + 1], qf[kk], bb[2], bb[3]);
      }
    }

    // scale, cap and mask; a tile inside every row's range skips the mask
    const bool edge = (causal && k0 + BN - 1 > q_first) ||
                      (window > 0 && q_last - k0 >= window) || k0 + BN > Sk;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        if (edge) {
          const int key = k0 + n * 8 + ((lane & 3) << 1) + (e & 1);
          const int qi = e < 2 ? qa : qb;
          if (key >= Sk) x = -INFINITY;  // not a key: no weight even in a row with none valid
          else if ((causal && key > qi) || (window > 0 && qi - key >= window)) x = kNegInf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float alpha = exp2f((m[i] - mx[i]) * kLog2e);
      m[i] = mx[i];
      l[i] *= alpha;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * i] *= alpha;
        acc[n][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < NN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[n][e] - m[e >> 1]) * kLog2e);
        s[n][e] = p;
        l[e >> 1] += p;  // this thread's share; the quad sums at the end
      }
    }

    // O += P V, P in bf16
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      mma_ab<HD, ST>(acc, pa, vt + kk * 16 * ST, lane);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 8 * i, qi = r / G;
    if (qi >= Sq) continue;
    const int h = kvh * G + r % G;
    const float lc = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lc;
    bf16* orow = o + (((size_t)b * Sq + qi) * H + h) * HD + ((lane & 3) << 1);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (lse != nullptr && (lane & 3) == 0)
      lse[((size_t)b * H + h) * Sq + qi] = m[i] + logf(lc);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int Sq, int Sk, int H, int K, int causal, int window,
                   float cap, float scale, cudaStream_t stream) {
  const int G = H / K;
  const long long rows = (long long)G * Sq;
  const long long nx = (rows + Tiling<HD>::kRows - 1) / Tiling<HD>::kRows;
  if (nx > 0x7fffffffLL || K > 65535 || B > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)nx, K, B);
  flash_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Sq, Sk, H, K, causal, window, cap, scale);
  return cudaSuccess;
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, float* lse,
                      int B, int Sq, int Sk, int H, int K, int causal, int window,
                      float cap, float scale, cudaStream_t stream) {
  using C = TcTiling<HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return attr;
  const long long rows = (long long)(H / K) * Sq;
  const long long nx = (rows + C::kBM - 1) / C::kBM;
  if (nx > 0x7fffffffLL || K > 65535 || B > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)nx, K, B);
  flash_tc_kernel<HD><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, Sq, Sk, H, K, causal, window, cap, scale);
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int Sq, int Sk, int H, int K, int causal,
                     int window, float cap, float scale, cudaStream_t s) {
  switch (hd) {
    case 8: return launch<T, 8>(q, k, v, o, lse, B, Sq, Sk, H, K, causal, window, cap, scale, s);
    case 16: return launch<T, 16>(q, k, v, o, lse, B, Sq, Sk, H, K, causal, window, cap, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, Sq, Sk, H, K, causal, window, cap, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, Sq, Sk, H, K, causal, window, cap, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, Sq, Sk, H, K, causal, window, cap, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, lse, B, Sq, Sk, H, K, causal, window, cap, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/o (B,Sq,H,hd), k/v (B,Sk,K,hd), all
// contiguous; lse (B,H,Sq) float32 or null. Returns a cudaError_t: the
// launch's, else cudaGetLastError().
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* o, void* lse, int B, int Sq,
                               int Sk, int H, int K, int hd, int causal,
                               int window, float softcap, float scale,
                               void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || K <= 0 || H % K != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const bool tc = dtype == 1 && (hd == 64 || hd == 128);
  // the tensor-core variant copies 16-byte chunks
  if (tc && (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(hd, q, k, v, o, l, B, Sq, Sk, H, K, causal, window, softcap, scale, s);
  else if (dtype == 1 && hd == 64)
    err = launch_tc<64>(q, k, v, o, l, B, Sq, Sk, H, K, causal, window, softcap, scale, s);
  else if (dtype == 1 && hd == 128)
    err = launch_tc<128>(q, k, v, o, l, B, Sq, Sk, H, K, causal, window, softcap, scale, s);
  else if (dtype == 1)
    err = dispatch<bf16>(hd, q, k, v, o, l, B, Sq, Sk, H, K, causal, window, softcap, scale, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
