// Mamba2 SSD chunked scan for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel). From a zero state, for each (batch, head) and each chunk of Q
// steps, with cs the inclusive prefix sum of dt*A inside the chunk:
//   y     = ((C Bᵀ) ⊙ exp(cs_q - cs_k)[q >= k] ⊙ dt_k) x  +  (C ⊙ exp(cs)) stateᵀ
//   state = exp(cs_last) state + xᵀ (B ⊙ exp(cs_last - cs) dt)
// x (B,S,H,P), B_/C_ (B,S,H,N) in float32 or bfloat16 (B_ and C_ by strides:
// a head stride of 0 reads the single group that the model broadcasts over the
// heads without materialising it); dt (B,S,H) and A (H,) float32. Returns y in
// x's type and the final state (B,H,P,N) in float32. S % Q == 0, any Q in
// 1..128, any P and N in 1..128.
//
// What bounds it on this card: operations. At the served shape (S 384, Q 128,
// H 80, P 64, N 128, float32) it does ~7.4 MFLOP per (head, chunk) on the CUDA
// cores against ~19 MB of device memory, ~26 us of float32 work against ~6 us
// of bytes.
// Design: one thread block per (batch, head) walks the chunks in order, as the
// TPU grid does, and carries the (P, N) state in shared memory; nothing crosses
// blocks, so there is no second pass. At B=1, H=80 that fills 80 of the 132
// SMs; the SSD paper's chunk-parallel split (chunk states and outputs over
// B*H*chunks blocks, then a short sequential pass over the chunks) is the
// later step that fills the card. Shared memory holds the chunk's x (Q x P)
// and B (Q x N) whole, C and the Q x Q decay-weighted scores in tiles of 32
// rows, and the state: at Q = P = N = 128 that is exactly the 227 KB a block
// may have. Each product is register-tiled (every thread owns a small grid of
// outputs, rows strided by 8 and columns by 32), and rows read across a warp
// are padded to N + 1 words so that they fall in distinct banks.
// The decay exp(cs_q - cs_k) is computed only for q >= k: above the diagonal
// it may overflow to inf, and inf * 0 would be NaN.
// Not done here (later work): the chunk-parallel split, tensor cores, TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTx = 32;                // threads along a tile's columns
constexpr int kTy = kThreads / kTx;    // threads along its rows
constexpr int kR = 32;                 // rows of C, scores and y per tile
constexpr int kRi = kR / kTy;          // tile rows per thread
constexpr int kQmax = 128;
constexpr int kKj = kQmax / kTx;       // score columns per thread
constexpr size_t kMaxSmem = 232448;    // bytes a block may have on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

size_t smem_floats(int Q, int P, int N) {
  return (size_t)Q * P + (size_t)Q * (N + 1) + (size_t)kR * N + (size_t)kR * Q +
         (size_t)P * (N + 1) + 4 * kQmax;
}

// PB >= P and NB >= N fix the per-thread register tiles at compile time; the
// runtime P, N and Q are masked.
template <typename T, int PB, int NB>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y, float* __restrict__ fstate,
           int S, int H, int P, int N, int Q, long long sbb, long long sbs,
           long long sbh, long long scb, long long scs, long long sch) {
  constexpr int PJ = (PB + kTx - 1) / kTx;  // y columns per thread
  constexpr int PI = (PB + kTy - 1) / kTy;  // state rows per thread
  constexpr int NJ = (NB + kTx - 1) / kTx;  // state columns per thread
  extern __shared__ float smem[];
  const int ldB = N + 1, ldS = N + 1;
  float* xs = smem;              // Q x P      chunk of x
  float* bs = xs + Q * P;        // Q x ldB    chunk of B (then B * w)
  float* ct = bs + Q * ldB;      // kR x N     tile of C rows
  float* gt = ct + kR * N;       // kR x Q     tile of decay-weighted scores
  float* st = gt + kR * Q;       // P x ldS    carried state
  float* cs = st + P * ldS;      // Q          inclusive prefix sum of dt*A
  float* dts = cs + kQmax;       // Q          dt
  float* ecs = dts + kQmax;      // Q          exp(cs)
  float* wk = ecs + kQmax;       // Q          exp(cs_last - cs) * dt

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const float a = A[h];
  const int nc = S / Q;

  for (int i = tid; i < P * ldS; i += kThreads) st[i] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;
    __syncthreads();  // the previous chunk is done with xs, bs, cs
    for (int i = tid; i < Q * P; i += kThreads) {
      const int k = i / P, p = i % P;
      xs[k * P + p] = to_f(x[(((size_t)b * S + s0 + k) * H + h) * P + p]);
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int k = i / N, n = i % N;
      bs[k * ldB + n] = to_f(Bm[b * sbb + (long long)(s0 + k) * sbs + h * sbh + n]);
    }
    if (tid < 32) {  // one warp: lane l scans steps 4l..4l+3, then the lanes
      float v[4], run = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = tid * 4 + j;
        const float d = k < Q ? dt[((size_t)b * S + s0 + k) * H + h] : 0.f;
        if (k < Q) dts[k] = d;
        run += d * a;
        v[j] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, tot, off);
        if (tid >= off) tot += t;
      }
      const float excl = tot - run;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = tid * 4 + j;
        if (k < Q) cs[k] = excl + v[j];
      }
    }
    __syncthreads();
    const float cl = cs[Q - 1];
    for (int k = tid; k < Q; k += kThreads) {
      ecs[k] = expf(cs[k]);
      wk[k] = expf(cl - cs[k]) * dts[k];
    }

    // y, by tiles of kR rows: it reads the state carried into this chunk
    for (int q0 = 0; q0 < Q; q0 += kR) {
      const int kend = min(Q, q0 + kR);  // columns >= kend lie above the diagonal
      __syncthreads();  // the previous tile is done with ct and gt
      for (int i = tid; i < kR * N; i += kThreads) {
        const int r = i / N, n = i % N, q = q0 + r;
        ct[r * N + n] = q < Q ? to_f(Cm[b * scb + (long long)(s0 + q) * scs + h * sch + n]) : 0.f;
      }
      __syncthreads();
      {  // gt[r][k] = (C_q . B_k) * exp(cs_q - cs_k) * dt_k for k <= q, else 0
        const int jmax = (kend + kTx - 1) / kTx;
        float acc[kRi][kKj];
#pragma unroll
        for (int i = 0; i < kRi; ++i)
#pragma unroll
          for (int j = 0; j < kKj; ++j) acc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[kRi], bv[kKj];
#pragma unroll
          for (int i = 0; i < kRi; ++i) cv[i] = ct[(ty + kTy * i) * N + n];
#pragma unroll
          for (int j = 0; j < kKj; ++j)
            bv[j] = j < jmax ? bs[min(tx + kTx * j, Q - 1) * ldB + n] : 0.f;
#pragma unroll
          for (int i = 0; i < kRi; ++i)
#pragma unroll
            for (int j = 0; j < kKj; ++j) acc[i][j] += cv[i] * bv[j];
        }
#pragma unroll
        for (int i = 0; i < kRi; ++i) {
          const int r = ty + kTy * i, q = q0 + r;
#pragma unroll
          for (int j = 0; j < kKj; ++j) {
            const int k = tx + kTx * j;
            if (k < Q)
              gt[r * Q + k] = (q < Q && k <= q) ? acc[i][j] * expf(cs[q] - cs[k]) * dts[k] : 0.f;
          }
        }
      }
      __syncthreads();
      {  // y[q][p] = sum_k gt[q][k] x[k][p] + exp(cs_q) * sum_n C[q][n] state[p][n]
        float intra[kRi][PJ], inter[kRi][PJ];
#pragma unroll
        for (int i = 0; i < kRi; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) intra[i][j] = inter[i][j] = 0.f;
        for (int k = 0; k < kend; ++k) {
          float gv[kRi], xv[PJ];
#pragma unroll
          for (int i = 0; i < kRi; ++i) gv[i] = gt[(ty + kTy * i) * Q + k];
#pragma unroll
          for (int j = 0; j < PJ; ++j) xv[j] = xs[k * P + min(tx + kTx * j, P - 1)];
#pragma unroll
          for (int i = 0; i < kRi; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j) intra[i][j] += gv[i] * xv[j];
        }
        for (int n = 0; n < N; ++n) {
          float cv[kRi], sv[PJ];
#pragma unroll
          for (int i = 0; i < kRi; ++i) cv[i] = ct[(ty + kTy * i) * N + n];
#pragma unroll
          for (int j = 0; j < PJ; ++j) sv[j] = st[min(tx + kTx * j, P - 1) * ldS + n];
#pragma unroll
          for (int i = 0; i < kRi; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j) inter[i][j] += cv[i] * sv[j];
        }
#pragma unroll
        for (int i = 0; i < kRi; ++i) {
          const int q = q0 + ty + kTy * i;
          if (q >= Q) continue;
          const float e = ecs[q];
#pragma unroll
          for (int j = 0; j < PJ; ++j) {
            const int p = tx + kTx * j;
            if (p < P)
              store(&y[(((size_t)b * S + s0 + q) * H + h) * P + p], intra[i][j] + e * inter[i][j]);
          }
        }
      }
    }

    // state = exp(cs_last) * state + x^T (B * w)
    __syncthreads();  // every tile is done reading the old state and B
    for (int i = tid; i < Q * N; i += kThreads) {
      const int k = i / N, n = i % N;
      bs[k * ldB + n] *= wk[k];
    }
    __syncthreads();
    {
      float acc[PI][NJ];
#pragma unroll
      for (int i = 0; i < PI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
      for (int k = 0; k < Q; ++k) {
        float xv[PI], bv[NJ];
#pragma unroll
        for (int i = 0; i < PI; ++i) xv[i] = xs[k * P + min(ty + kTy * i, P - 1)];
#pragma unroll
        for (int j = 0; j < NJ; ++j) bv[j] = bs[k * ldB + min(tx + kTx * j, N - 1)];
#pragma unroll
        for (int i = 0; i < PI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] += xv[i] * bv[j];
      }
      const float decay = expf(cl);
#pragma unroll
      for (int i = 0; i < PI; ++i) {
        const int p = ty + kTy * i;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = tx + kTx * j;
          if (p < P && n < N) st[p * ldS + n] = decay * st[p * ldS + n] + acc[i][j];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    fstate[(((size_t)b * H + h) * P + p) * N + n] = st[p * ldS + n];
  }
}

template <typename T, int PB, int NB>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, void* y, void* fs, int B, int S, int H, int P,
                   int N, int Q, long long sbb, long long sbs, long long sbh,
                   long long scb, long long scs, long long sch, cudaStream_t stream) {
  const size_t smem = smem_floats(Q, P, N) * sizeof(float);
  if (smem > kMaxSmem || B > 65535) return cudaErrorInvalidValue;
  auto kernel = ssd_kernel<T, PB, NB>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(fs), S, H, P, N, Q, sbb, sbs, sbh, scb, scs, sch);
  return cudaSuccess;
}

template <typename T, int PB>
cudaError_t by_n(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* fs, int B, int S, int H, int P, int N,
                 int Q, long long sbb, long long sbs, long long sbh, long long scb,
                 long long scs, long long sch, cudaStream_t s) {
  if (N <= 32)
    return launch<T, PB, 32>(x, dt, A, Bm, Cm, y, fs, B, S, H, P, N, Q, sbb, sbs, sbh, scb, scs, sch, s);
  if (N <= 64)
    return launch<T, PB, 64>(x, dt, A, Bm, Cm, y, fs, B, S, H, P, N, Q, sbb, sbs, sbh, scb, scs, sch, s);
  return launch<T, PB, 128>(x, dt, A, Bm, Cm, y, fs, B, S, H, P, N, Q, sbb, sbs, sbh, scb, scs, sch, s);
}

template <typename T>
cudaError_t by_p(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* fs, int B, int S, int H, int P, int N,
                 int Q, long long sbb, long long sbs, long long sbh, long long scb,
                 long long scs, long long sch, cudaStream_t s) {
  if (P <= 32)
    return by_n<T, 32>(x, dt, A, Bm, Cm, y, fs, B, S, H, P, N, Q, sbb, sbs, sbh, scb, scs, sch, s);
  if (P <= 64)
    return by_n<T, 64>(x, dt, A, Bm, Cm, y, fs, B, S, H, P, N, Q, sbb, sbs, sbh, scb, scs, sch, s);
  return by_n<T, 128>(x, dt, A, Bm, Cm, y, fs, B, S, H, P, N, Q, sbb, sbs, sbh, scb, scs, sch, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B_, C_, y). x/y (B,S,H,P) contiguous,
// dt (B,S,H) and A (H,) float32 contiguous, fstate (B,H,P,N) float32. B_ and C_
// are read at b*sb + s*ss + h*sh + n (element strides; the last dim is
// contiguous). Returns a cudaError_t: the launch's, else cudaGetLastError().
extern "C" int ssd_scan(int dtype, const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, void* y, void* fstate,
                        int B, int S, int H, int P, int N, int Q, long long sbb,
                        long long sbs, long long sbh, long long scb, long long scs,
                        long long sch, void* stream) {
  if (B <= 0 || H <= 0 || Q < 1 || Q > kQmax || S <= 0 || S % Q != 0 || P < 1 ||
      P > 128 || N < 1 || N > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = by_p<float>(x, dt, A, Bm, Cm, y, fstate, B, S, H, P, N, Q, sbb, sbs, sbh, scb, scs, sch, s);
  else if (dtype == 1)
    err = by_p<__nv_bfloat16>(x, dt, A, Bm, Cm, y, fstate, B, S, H, P, N, Q, sbb, sbs, sbh, scb, scs, sch, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
