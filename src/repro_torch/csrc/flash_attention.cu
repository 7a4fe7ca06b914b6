// Flash attention (prefill) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel). Computes causal / sliding-window / tanh-softcapped GQA
// attention of q (B,Sq,H,hd) against k/v (B,Sk,K,hd) at implicit arange
// positions, with a streaming softmax whose (m, l, acc) state is float32.
//
// What bounds it on this card: at the served shapes (S of a few hundred, hd 64,
// float32) the work is 4*B*H*Sq*Sk*hd/2 FLOPs on the CUDA cores against a few
// MB of q/k/v, so the float32 operation rate bounds it, not the bytes.
// Design: one thread block per (batch, kv head, tile of query rows). The G query
// heads of the kv group are folded into the tile's rows (row = q * G + g), so the
// G heads share every K/V tile staged in shared memory and each K/V element is
// read from device memory once per tile of rows. Each row is owned by hd/8
// threads, each holding 8 of its dims (dims lane + TPR*i, so neighbouring
// threads read neighbouring shared-memory words), and a row's dot product is a
// shuffle reduction over those threads. The block walks K/V tiles only up to the
// causal frontier of its last row and from the window edge of its first row;
// the ragged last tile is masked, so any Sq == Sk works.
//
// Masking follows the reference: masked scores are the finite -1e30 and l is
// clamped at 1e-30, so a row with no valid key gives the mean of V, not NaN.
// Not done here (later work): tensor cores (wgmma), TMA loads, pipelining.
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
  static constexpr int kTpr = HD >= 8 ? HD / 8 : 1;  // threads per query row
  static constexpr int kDpt = HD / kTpr;             // dims per thread
  static constexpr int kRows = kThreads / kTpr;      // query rows per block
  static constexpr int kBk = HD <= 64 ? 64 : 32;     // keys per shared tile
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
             int K, int causal, int window, float cap, float scale) {
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
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) store(&o[q_off + lane + TPR * i], acc[i] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Sk, int H, int K, int causal, int window,
                   float cap, float scale, cudaStream_t stream) {
  const int G = H / K;
  const long long rows = (long long)G * Sq;
  const long long nx = (rows + Tiling<HD>::kRows - 1) / Tiling<HD>::kRows;
  if (nx > 0x7fffffffLL || K > 65535 || B > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)nx, K, B);
  flash_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, K, causal, window, cap, scale);
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Sk, int H, int K, int causal, int window,
                     float cap, float scale, cudaStream_t s) {
  switch (hd) {
    case 8: return launch<T, 8>(q, k, v, o, B, Sq, Sk, H, K, causal, window, cap, scale, s);
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Sk, H, K, causal, window, cap, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, K, causal, window, cap, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, K, causal, window, cap, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, K, causal, window, cap, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/o (B,Sq,H,hd), k/v (B,Sk,K,hd), all
// contiguous. Returns a cudaError_t: the launch's, else cudaGetLastError().
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* o, int B, int Sq, int Sk,
                               int H, int K, int hd, int causal, int window,
                               float softcap, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || K <= 0 || H % K != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(hd, q, k, v, o, B, Sq, Sk, H, K, causal, window, softcap, scale, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Sk, H, K, causal, window, softcap, scale, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
