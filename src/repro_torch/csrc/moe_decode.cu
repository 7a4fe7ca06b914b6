// The gathered MoE decode for Hopper, sm_90a: a few tokens' products on
// the experts they chose, the chosen ids read on the card.
//
// Replaces no TPU kernel. The reference's decode of at most 16 tokens on an
// arch whose expert count is not a multiple of 16 (mixtral-8x7b),
// src/repro/models/layers.py::_moe_gathered, takes the chosen experts'
// weights with jnp.take and contracts them with two einsums inside its
// jitted step: XLA never leaves the device. PyTorch has no call that reads
// an expert's weights by an id held on the device without first copying
// them ((B, K, D, F) a weight, 5.6 GB a layer for mixtral at batch 4 in
// float32), and the port's plain loop reads the ids to the host. This
// kernel reads them on the card, so a decode step can be captured whole.
//
// Function: x (B, D) in T (float32 or bf16), B <= 16; eidx (B, K) int64;
// gate (B, K) in T, normalised; wi, wg (E_l, D, F) and wo (E_l, F, D) in
// their stored type W, each weight rounded to T as it is loaded (what
// .to(dt) does); an expert offset e0. For each (token b, choice k), a
// "pair" p = b K + k, with e = eidx[b,k] - e0 in [0, E_l):
//   g = x_b Wg[e], i = x_b Wi[e]  (float32 sums, each rounded to T)
//   h = T(T(silu(g)) * i), hg = T(h * gate[b,k])
//   y_p = T(hg Wo[e])             (float32 sums, rounded to T)
// and y_b = y_{b,0} + y_{b,1} + ... in k order, rounded to T after each
// add; a choice outside [e0, e0 + E_l) adds nothing and a token with none
// gets 0. These are the rounding points of the port's plain loop
// (models/layers.py::_gathered_loop); kernels/ref.py::moe_gathered_ref is
// this algorithm step by step.
//
// What bounds it on this card: bytes. The chosen experts' weights are
// 3 D F values each (704.6 MB for a mixtral expert in float32, 0.21 ms at
// 3.35 TB/s), and a pair does 6 D F FLOPs on them: at most 2 FLOPs a byte
// at batch 16. The design reads each distinct chosen expert's weights once,
// whatever number of tokens chose it, with 16-byte loads that neighbouring
// threads take from neighbouring addresses, and keeps every pair's sums in
// registers. Three launches:
//  (1) moe_up_kernel, a grid of (column tiles of F, experts, 2 x row splits
//      of D): a block finds the pairs that chose its expert (warp 0 reads
//      eidx; a block whose expert no pair chose exits at once), stages
//      their x rows in shared memory chunk by chunk, and streams its tile
//      of Wi or Wg (grid z picks which) once: 4 warps, each thread 16 bytes
//      of every row of its split, 8 rows' loads in flight before any FMA.
//      It writes each pair's float32 partial sums over its rows.
//  (2) moe_down_kernel, a grid of (column tiles of D, experts, row splits
//      of F): the same over Wo, with each pair's hg formed while staging
//      (the up pass's partials added in split order, then the rounding
//      points above); it writes float32 partial sums over its rows.
//  (3) moe_combine_kernel: each pair's partials added in split order and
//      rounded to T, then a token's K outputs added in k order.
// A thread keeps NP pairs' sums (NP: B rounded up to a power of two, the
// most pairs one expert can have when a token's K ids are distinct); more
// pairs on one expert (repeated ids) take further passes over the tile.
// The splits (kernels/moe_decode.py::plan) depend on the shapes alone and
// every sum runs in a fixed order, with no atomics: two runs give the same
// bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPairs = 64;  // B * K
constexpr int kChunk = 256;    // rows of the pairs' inputs staged at once
constexpr int kUnroll = 8;     // rows whose loads a thread keeps in flight

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T (round to nearest even, as .to(bfloat16)) and back
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

template <typename W>
struct Vec {
  static constexpr int N = 16 / sizeof(W);
};

// 16 loaded bytes as N values of W, each rounded to T
template <typename T, typename W>
__device__ __forceinline__ void unpack(const uint4& raw, float (&w)[Vec<W>::N]) {
  const W* v = reinterpret_cast<const W*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<W>::N; ++i) w[i] = rnd<T>(to_f(v[i]));
}

// The pairs p < P with eidx[p] == want, in increasing p, into pairs[]; their
// number into *npairs. Warp 0 reads eidx; every thread waits for it.
__device__ __forceinline__ void find_pairs(const long long* __restrict__ eidx, int P,
                                           long long want, int* pairs, int* npairs) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int base = 0;
    for (int p0 = 0; p0 < P; p0 += 32) {
      const int p = p0 + lane;
      const bool hit = p < P && eidx[p] == want;
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (hit) pairs[base + __popc(m & ((1u << lane) - 1u))] = p;
      base += __popc(m);
    }
    if (lane == 0) *npairs = base;
  }
  __syncthreads();
}

// acc[j][:] += in[j] * w[:] for one row of the weight tile
template <typename T, typename W, int NP>
__device__ __forceinline__ void fma_row(float (&acc)[NP][Vec<W>::N], const uint4& raw,
                                        const float* in) {
  float w[Vec<W>::N];
  unpack<T, W>(raw, w);
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const float a = in[j];
#pragma unroll
    for (int v = 0; v < Vec<W>::N; ++v) acc[j][v] = fmaf(a, w[v], acc[j][v]);
  }
}

// The shared body of both GEMV passes: out[p][col..] = sum over the rows
// [r0, r1) of in_p[r] * w[r][col..] for the block's pairs, where ``stage``
// writes in_p[c0 + r] for the pairs j of group g0 into xs[r][j] (0 past the
// pairs). w is one expert's (rows, cols) matrix; out_base + p * cols the
// pair's row of float32 partial sums.
template <typename T, typename W, int NP, typename Stage>
__device__ __forceinline__ void gemv_pass(const W* __restrict__ w, int cols, int r0, int r1,
                                          const int* pairs, int n, float* __restrict__ out,
                                          float (*xs)[NP], Stage stage) {
  constexpr int V = Vec<W>::N;
  const int col = (blockIdx.x * kThreads + threadIdx.x) * V;
  const bool live = col < cols;
  for (int g0 = 0; g0 < n; g0 += NP) {
    float acc[NP][V];
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[j][v] = 0.0f;
    for (int c0 = r0; c0 < r1; c0 += kChunk) {
      const int cn = min(kChunk, r1 - c0);
      __syncthreads();  // the previous chunk's reads of xs are done
      for (int i = threadIdx.x; i < kChunk * NP; i += kThreads) {
        const int j = i / kChunk, r = i % kChunk;
        xs[r][j] = (r < cn && g0 + j < n) ? stage(pairs[g0 + j], c0 + r) : 0.0f;
      }
      __syncthreads();
      if (!live) continue;
      const W* wp = w + (size_t)c0 * cols + col;
      int r = 0;
      for (; r + kUnroll <= cn; r += kUnroll) {
        uint4 raw[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          raw[u] = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)(r + u) * cols));
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) fma_row<T, W, NP>(acc, raw[u], xs[r + u]);
      }
      for (; r < cn; ++r) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)r * cols));
        fma_row<T, W, NP>(acc, raw, xs[r]);
      }
    }
    if (live) {
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        if (g0 + j >= n) break;
        float4* dst = reinterpret_cast<float4*>(out + (size_t)pairs[g0 + j] * cols + col);
#pragma unroll
        for (int v = 0; v < V; v += 4)
          dst[v / 4] = make_float4(acc[j][v], acc[j][v + 1], acc[j][v + 2], acc[j][v + 3]);
      }
    }
  }
}

// (1): up[(split * 2 + which) * P + p][f], which 0 for Wi, 1 for Wg
template <typename T, typename W, int NP>
__global__ void __launch_bounds__(kThreads)
    moe_up_kernel(const T* __restrict__ x, const long long* __restrict__ eidx,
                  const W* __restrict__ wi, const W* __restrict__ wg, float* __restrict__ up,
                  int P, int K, int D, int F, long long e0, int rows) {
  __shared__ int pairs[kMaxPairs];
  __shared__ int npairs;
  __shared__ float xs[kChunk][NP];
  const int e = blockIdx.y, which = blockIdx.z & 1, split = blockIdx.z >> 1;
  find_pairs(eidx, P, e0 + e, pairs, &npairs);
  const int n = npairs;
  if (n == 0) return;
  const int r0 = split * rows, r1 = min(D, r0 + rows);
  const W* w = (which ? wg : wi) + (size_t)e * D * F;
  float* out = up + (size_t)(split * 2 + which) * P * F;
  gemv_pass<T, W, NP>(w, F, r0, r1, pairs, n, out, xs,
                      [&](int p, int d) { return to_f(x[(size_t)(p / K) * D + d]); });
}

// (2): down[split * P + p][d]
template <typename T, typename W, int NP>
__global__ void __launch_bounds__(kThreads)
    moe_down_kernel(const float* __restrict__ up, const T* __restrict__ gate,
                    const long long* __restrict__ eidx, const W* __restrict__ wo,
                    float* __restrict__ down, int P, int D, int F, long long e0, int s_up,
                    int rows) {
  __shared__ int pairs[kMaxPairs];
  __shared__ int npairs;
  __shared__ float xs[kChunk][NP];
  const int e = blockIdx.y, split = blockIdx.z;
  find_pairs(eidx, P, e0 + e, pairs, &npairs);
  const int n = npairs;
  if (n == 0) return;
  const int r0 = split * rows, r1 = min(F, r0 + rows);
  const W* w = wo + (size_t)e * F * D;
  float* out = down + (size_t)split * P * D;
  gemv_pass<T, W, NP>(w, D, r0, r1, pairs, n, out, xs, [&](int p, int f) {
    float si = 0.0f, sg = 0.0f;
    for (int s = 0; s < s_up; ++s) {
      si += up[((size_t)(s * 2) * P + p) * F + f];
      sg += up[((size_t)(s * 2 + 1) * P + p) * F + f];
    }
    const float h = rnd<T>(rnd<T>(silu(rnd<T>(sg))) * rnd<T>(si));
    return rnd<T>(h * to_f(gate[p]));
  });
}

// (3): y[b][d] = each in-range pair's output (its partials added in split
// order, rounded to T), added in k order
template <typename T>
__global__ void __launch_bounds__(256)
    moe_combine_kernel(const float* __restrict__ down, const long long* __restrict__ eidx,
                       T* __restrict__ y, int B, int K, int D, long long e0, int E_l,
                       int s_down) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * D) return;
  const int b = i / D, d = i % D, P = B * K;
  float acc = 0.0f;
  bool any = false;
  for (int k = 0; k < K; ++k) {
    const int p = b * K + k;
    const long long e = eidx[p] - e0;
    if (e < 0 || e >= E_l) continue;
    float s = 0.0f;
    for (int sd = 0; sd < s_down; ++sd) s += down[((size_t)sd * P + p) * D + d];
    const float yk = rnd<T>(s);
    acc = any ? rnd<T>(acc + yk) : yk;
    any = true;
  }
  y[i] = from_f<T>(acc);
}

template <typename T, typename W, int NP>
cudaError_t launch(const void* x, const void* eidx, const void* gate, const void* wi,
                   const void* wg, const void* wo, void* up, void* down, void* y, int B, int K,
                   int D, int F, int E_l, long long e0, int s_up, int rows_up, int s_down,
                   int rows_down, cudaStream_t stream) {
  constexpr int tile = kThreads * Vec<W>::N;
  const int P = B * K;
  const long long* ids = static_cast<const long long*>(eidx);
  moe_up_kernel<T, W, NP><<<dim3((F + tile - 1) / tile, E_l, 2 * s_up), kThreads, 0, stream>>>(
      static_cast<const T*>(x), ids, static_cast<const W*>(wi), static_cast<const W*>(wg),
      static_cast<float*>(up), P, K, D, F, e0, rows_up);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_down_kernel<T, W, NP><<<dim3((D + tile - 1) / tile, E_l, s_down), kThreads, 0, stream>>>(
      static_cast<const float*>(up), static_cast<const T*>(gate), ids,
      static_cast<const W*>(wo), static_cast<float*>(down), P, D, F, e0, s_up, rows_down);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_combine_kernel<T><<<(B * D + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(down), ids, static_cast<T*>(y), B, K, D, e0, E_l, s_down);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t dispatch(int np, const void* x, const void* eidx, const void* gate, const void* wi,
                     const void* wg, const void* wo, void* up, void* down, void* y, int B, int K,
                     int D, int F, int E_l, long long e0, int s_up, int rows_up, int s_down,
                     int rows_down, cudaStream_t s) {
#define MOE_NP(N)                                                                              \
  if (np == N)                                                                                 \
    return launch<T, W, N>(x, eidx, gate, wi, wg, wo, up, down, y, B, K, D, F, E_l, e0, s_up, \
                           rows_up, s_down, rows_down, s);
  MOE_NP(1)
  MOE_NP(2)
  MOE_NP(4)
  MOE_NP(8)
  MOE_NP(16)
#undef MOE_NP
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: x's type (0 float32, 1 bf16); wtype: the weights' (0 float32, 1
// bf16; float32 x takes float32 weights). np: pairs a thread keeps (1, 2,
// 4, 8 or 16). up: 2 s_up B K F floats; down: s_down B K D floats.
extern "C" int moe_decode(int dtype, int wtype, int np, const void* x, const void* eidx,
                          const void* gate, const void* wi, const void* wg, const void* wo,
                          void* up, void* down, void* y, int B, int K, int D, int F, int E_l,
                          long long e0, int s_up, int rows_up, int s_down, int rows_down,
                          void* stream) {
  if (B <= 0 || K <= 0 || B * K > kMaxPairs || D <= 0 || F <= 0 || E_l <= 0 || s_up <= 0 ||
      s_down <= 0 || rows_up <= 0 || rows_down <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && wtype == 0)
    return (int)dispatch<float, float>(np, x, eidx, gate, wi, wg, wo, up, down, y, B, K, D, F,
                                       E_l, e0, s_up, rows_up, s_down, rows_down, s);
  if (dtype == 1 && wtype == 0)
    return (int)dispatch<__nv_bfloat16, float>(np, x, eidx, gate, wi, wg, wo, up, down, y, B,
                                               K, D, F, E_l, e0, s_up, rows_up, s_down,
                                               rows_down, s);
  if (dtype == 1 && wtype == 1)
    return (int)dispatch<__nv_bfloat16, __nv_bfloat16>(np, x, eidx, gate, wi, wg, wo, up, down,
                                                        y, B, K, D, F, E_l, e0, s_up, rows_up,
                                                        s_down, rows_down, s);
  return (int)cudaErrorInvalidValue;
}
