// Decode attention for Hopper, sm_90a: one new token per sequence against a
// linear or ring KV cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::decode_attention
// (body _decode_kernel). q (B,H,hd), k/v (B,Smax,K,hd), pos_ids (B,Smax) int32
// (slot -> absolute position, -1 = empty), lengths (B,) int32 (the new token's
// position). A slot is valid iff pos_id >= 0, pos_id <= length and, with a
// window, length - pos_id < window, so slot order does not matter and a ring
// cache mid-wrap works. Any Smax; hd 8, 16, 32, 64, 128 and 256 (gemma2-2b:
// a row of 32 threads, 8 rows a block, so G <= 8 there).
//
// What bounds it on this card: bytes. Each call reads the whole cache,
// 2*B*Smax*K*hd*4 bytes of K/V in float32, and does ~4 FLOPs per byte read.
// Design: one thread block per (batch, kv head) serves the G query heads of the
// group, so each K/V slot is read from device memory once for all G heads (the
// G readers of a slot hit L1). Each head's row is owned by hd/8 threads holding
// 8 dims each; the block's remaining rows are slot groups that walk disjoint,
// interleaved slots with their own (m, l, acc) state in float32, merged through
// shared memory at the end. This keeps 256 threads busy at G = 2.
// Known limit, left for a later PR: the grid is only B*K blocks (32 at 4 slots
// and 8 kv heads, on 132 SMs); splitting the slots across blocks
// (flash-decoding) with a second merge pass is what fills the card.
//
// Masking follows the reference: masked scores are the finite -1e30 and l is
// clamped at 1e-30, so a row with no valid slot gives the mean of V, not NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int HD>
struct Tiling {
  static constexpr int kTpr = HD >= 8 ? HD / 8 : 1;  // threads per head row
  static constexpr int kDpt = HD / kTpr;             // dims per thread
  static constexpr int kRows = kThreads / kTpr;      // rows per block
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ pos_ids,
              const int* __restrict__ lengths, T* __restrict__ o, int H, int K,
              int Smax, int window, float cap, float scale) {
  using Tl = Tiling<HD>;
  constexpr int TPR = Tl::kTpr, DPT = Tl::kDpt, ROWS = Tl::kRows;
  __shared__ float sm_m[ROWS];
  __shared__ float sm_l[ROWS];
  __shared__ float sm_acc[ROWS * HD];

  const int G = H / K;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % TPR;
  const int row = tid / TPR;   // = grp * G + g
  const int g = row % G;
  const int grp = row / G;
  const int ngrp = ROWS / G;   // >= 1: the host checks G <= ROWS
  const bool active = grp < ngrp;
  const int qpos = lengths[b];

  const size_t q_off = ((size_t)b * H + (size_t)kvh * G + g) * HD;
  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = to_f(q[q_off + lane + TPR * i]);
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // block-uniform trip count, so the full-warp shuffles are safe
  for (int j0 = 0; j0 < Smax; j0 += ngrp) {
    const int j = j0 + grp;
    const bool has = active && j < Smax;
    const size_t off = (((size_t)b * Smax + (has ? j : 0)) * K + kvh) * HD;
    float part = 0.f;
    if (has) {
#pragma unroll
      for (int i = 0; i < DPT; ++i) part += qr[i] * to_f(k[off + lane + TPR * i]);
    }
#pragma unroll
    for (int sh = TPR / 2; sh > 0; sh >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, sh);
    if (has) {
      float sc = part * scale;
      if (cap > 0.f) sc = cap * tanhf(sc / cap);
      const int pid = pos_ids[(size_t)b * Smax + j];
      const bool valid = pid >= 0 && pid <= qpos && (window <= 0 || qpos - pid < window);
      sc = valid ? sc : kNegInf;
      const float m_new = fmaxf(m, sc);
      const float alpha = expf(m - m_new);
      const float p = expf(sc - m_new);
      l = l * alpha + p;
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[i] = acc[i] * alpha + p * to_f(v[off + lane + TPR * i]);
      m = m_new;
    }
  }

  // merge the slot groups of each head
  if (lane == 0) {
    sm_m[row] = m;
    sm_l[row] = l;
  }
#pragma unroll
  for (int i = 0; i < DPT; ++i) sm_acc[row * HD + lane + TPR * i] = acc[i];
  __syncthreads();
  if (grp == 0) {
    float mx = kNegInf;
    for (int gg = 0; gg < ngrp; ++gg) mx = fmaxf(mx, sm_m[gg * G + g]);
    float tot = 0.f, out[DPT];
#pragma unroll
    for (int i = 0; i < DPT; ++i) out[i] = 0.f;
    for (int gg = 0; gg < ngrp; ++gg) {
      const int r = gg * G + g;
      const float w = expf(sm_m[r] - mx);
      tot += sm_l[r] * w;
#pragma unroll
      for (int i = 0; i < DPT; ++i) out[i] += sm_acc[r * HD + lane + TPR * i] * w;
    }
    const float inv = 1.f / fmaxf(tot, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) store(&o[q_off + lane + TPR * i], out[i] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pos,
                   const void* len, void* o, int B, int H, int K, int Smax,
                   int window, float cap, float scale, cudaStream_t stream) {
  if (H / K > Tiling<HD>::kRows || B > 65535)
    return cudaErrorInvalidValue;
  dim3 grid(K, B);
  decode_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pos), static_cast<const int*>(len), static_cast<T*>(o),
      H, K, Smax, window, cap, scale);
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     const void* pos, const void* len, void* o, int B, int H,
                     int K, int Smax, int window, float cap, float scale,
                     cudaStream_t s) {
  switch (hd) {
    case 8: return launch<T, 8>(q, k, v, pos, len, o, B, H, K, Smax, window, cap, scale, s);
    case 16: return launch<T, 16>(q, k, v, pos, len, o, B, H, K, Smax, window, cap, scale, s);
    case 32: return launch<T, 32>(q, k, v, pos, len, o, B, H, K, Smax, window, cap, scale, s);
    case 64: return launch<T, 64>(q, k, v, pos, len, o, B, H, K, Smax, window, cap, scale, s);
    case 128: return launch<T, 128>(q, k, v, pos, len, o, B, H, K, Smax, window, cap, scale, s);
    case 256: return launch<T, 256>(q, k, v, pos, len, o, B, H, K, Smax, window, cap, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/o (B,H,hd), k/v (B,Smax,K,hd),
// pos_ids (B,Smax) int32, lengths (B,) int32, all contiguous. Returns a
// cudaError_t: the launch's, else cudaGetLastError().
extern "C" int decode_attention(int dtype, const void* q, const void* k,
                                const void* v, const void* pos_ids,
                                const void* lengths, void* o, int B, int H,
                                int K, int Smax, int hd, int window,
                                float softcap, float scale, void* stream) {
  if (B <= 0 || Smax <= 0 || K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(hd, q, k, v, pos_ids, lengths, o, B, H, K, Smax, window, softcap, scale, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(hd, q, k, v, pos_ids, lengths, o, B, H, K, Smax, window, softcap, scale, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
