// Mamba2 SSD chunked scan for Hopper, sm_90a: the chunk-parallel algorithm.
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
// H 80, P 64, N 128, float32) it does ~7.4 MFLOP per (head, chunk) against
// ~19 MB of device memory in all: ~26 us of float32 work against ~6 us of
// bytes.
//
// Design: the GPU algorithm of the SSD paper (arXiv 2405.21060, section 6),
// three kernels launched from one C call on one stream:
//  (a) chunk_state_kernel, one block per (chunk, head, batch): the chunk's
//      own state (x ⊙ exp(cs_last - cs) dt)ᵀ B, P x N, and cs_last, into a
//      float32 workspace;
//  (b) state_pass_kernel, one thread per (batch, head, p, n): walks the
//      chunks in order, state_c+1 = exp(cs_last_c) state_c + S_c, and writes
//      over each S_c the state that enters chunk c, then the final state.
//      It is a kernel of its own (not folded into (c)): its cost is one read
//      and one write of the workspace whatever the number of chunks;
//  (c) chunk_out_kernel, one block of 4 warps per (64-row tile, chunk, head,
//      batch), a warp 16 rows by all P columns: the intra-chunk product over
//      the rows' causal keys, in key tiles of 32, then (C ⊙ exp(cs)) times
//      the entering state. At the served shape that is 2 x 3 x 80 = 480
//      blocks (the old grid was 80 blocks walking the chunks in order).
// Each block recomputes its chunk's cs with the same warp scan, so (a) and
// (c) agree on every bit. No atomics and every sum in a fixed order: two
// runs give the same bits.
// At these sizes the blocks wait on memory latency more than on arithmetic
// (tiles loaded element by element cost one round trip after another
// between barriers), so every tile is kept in its natural row layout and
// filled by cp.async, 16 bytes a copy, all in flight at once (float32 rows on 16-byte boundaries; other inputs, bfloat16
// included, take a register path that converts them). In (c) the key tiles
// of B and x stream through a two-stage ring, the next one loading while
// the current one is used, and the decay-weighted scores G never leave the
// registers: the accumulator of C Bᵀ is the A operand of G x once the k
// index of each 8-step is permuted (column t is key 2t, t + 4 is 2t + 1,
// and x's rows are read in the same order), as FlashAttention-2 does.
// Tensor cores for all three products, for both input types, as split-TF32
// (3xTF32): every float32 operand is split into two tf32 halves, hi + lo,
// and a product is taken as lo*hi + hi*lo + hi*hi with mma.sync.m16n8k8 and
// float32 accumulators (csrc/tc_mma.cuh). Served mamba2 runs float32, which
// must stay at float32 accuracy (the checks hold it at 2e-4 against the plain
// versions): plain TF32 (10-bit mantissas) does not keep that; the split
// does, at three tensor-core products for one. bfloat16 inputs take the same
// path (they are exact in tf32): G and the states are float32 values, and
// bf16 operands (m16n8k16) would round them.
// Fragments read shared memory with leading dimensions of 8 mod 32 words
// for tiles read k-major and 4 mod 32 for tiles read along their rows, so
// that a fragment's 32 loads fall in 32 distinct banks.
// The decay exp(cs_q - cs_k) is computed only for q >= k: above the diagonal
// it may overflow to inf, and inf * 0 would be NaN.
// Not done here (later work): wgmma, TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tc_mma.cuh"

namespace {

constexpr int kQmax = 128;
constexpr int kStateThreads = 256;   // chunk states: 8 warps over the P x N output
constexpr int kOutThreads = 128;     // chunk outputs: 4 warps of 16 rows
constexpr int kR = 64;               // rows of a chunk an output block owns
constexpr int kKt = 32;              // keys a pipeline stage holds
constexpr int kBatch = 8;            // loads a thread issues before it stores (sync fill)
constexpr size_t kMaxSmem = 232448;  // bytes a block may have on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ int round8(int k) { return (k + 7) & ~7; }

// dst[r * ld + c] for r < RB, c < CB: src[r * ss + c] where r < rows and
// c < cols, else 0. With ``async`` (float32 rows, 16-byte aligned, cols % 4
// == 0) by cp.async, 16 bytes a copy, zero-filled outside, left in flight
// for the caller to commit and wait on; otherwise kBatch loads a thread
// before any store, converted to float32.
template <typename T>
__device__ __forceinline__ void fill_tile(float* dst, int ld, const T* src, long long ss,
                                          int rows, int cols, int RB, int CB, bool async,
                                          int tid, int nthr) {
  if constexpr (std::is_same<T, float>::value) {
    if (async) {
      const int cpr = CB / 4;
      for (int i = tid; i < RB * cpr; i += nthr) {
        const int r = i / cpr, c = (i % cpr) * 4;
        const bool ok = r < rows && c < cols;
        cp_async16(dst + r * ld + c, ok ? src + r * ss + c : src, ok);
      }
      return;
    }
  }
  const int total = RB * CB;
  for (int e0 = tid; e0 < total; e0 += kBatch * nthr) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * nthr, r = e / CB, c = e % CB;
      v[u] = (e < total && r < rows && c < cols) ? to_f(src[r * ss + c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * nthr;
      if (e < total) dst[(e / CB) * ld + e % CB] = v[u];
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// One warp: cs = the inclusive prefix sum of dt * a over the chunk's Q steps
// (lane l scans steps 4l..4l+3, then the lanes), dts = dt. Every kernel
// that needs cs calls this, so they agree on its bits.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dt, size_t base, int H,
                                             int Q, float a, float* cs, float* dts, int lane) {
  float v[4], run = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = lane * 4 + j;
    const float d = k < Q ? dt[base + (size_t)k * H] : 0.f;
    if (k < Q) dts[k] = d;
    run += d * a;
    v[j] = run;
  }
  float tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += u;
  }
  const float excl = tot - run;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = lane * 4 + j;
    if (k < Q) cs[k] = excl + v[j];
  }
}

// shared memory, in floats: leading dims of 8 mod 32 words for the tiles
// read k-major by the fragments ([k][m] and [k][n]), 4 mod 32 for those
// read along their rows ([m][k] and [n][k]): a fragment's 32 loads then
// fall in 32 distinct banks
size_t state_smem(int PB, int NB) {
  return ((size_t)kQmax * (PB + 8) + (size_t)kQmax * (NB + 8) + 3 * kQmax) * sizeof(float);
}

size_t out_smem(int PB, int NB) {
  const size_t stage = (size_t)kKt * (NB + 4) + (size_t)kKt * (PB + 4);
  return ((size_t)kR * (NB + 4) + 2 * stage + 2 * kQmax) * sizeof(float);
}

// (a) S_c = (x ⊙ w)ᵀ B, w = exp(cs_last - cs) dt, into work[(bh, c)] (P x N),
// and cs_last into cl[(bh, c)]. 2 x 4 warps over the P x N output.
template <typename T, int PB, int NB>
__global__ void __launch_bounds__(kStateThreads, 2)
chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   float* __restrict__ work, float* __restrict__ cl_out, int S, int H, int P,
                   int N, int Q, long long sbb, long long sbs, long long sbh, int async) {
  constexpr int MT = PB / 32, NT = NB / 32, ldx = PB + 8, ldb = NB + 8;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // Q x ldx   x of the chunk, [k][p]
  float* bs = xs + kQmax * ldx;                   // Q x ldb   B of the chunk, [k][n]
  float* cs = bs + kQmax * ldb;                   // Q
  float* dts = cs + kQmax;                        // Q
  float* wk = dts + kQmax;                        // Q         w

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x, s0 = c * Q, K8 = round8(Q);
  const size_t bh = (size_t)b * H + h;
  fill_tile<T>(xs, ldx, x + (((size_t)b * S + s0) * H + h) * P, (long long)H * P, Q, P, K8, PB,
               async, tid, kStateThreads);
  fill_tile<T>(bs, ldb, Bm + b * sbb + (long long)s0 * sbs + h * sbh, sbs, Q, N, K8, NB, async,
               tid, kStateThreads);
  cp_async_commit();
  if (tid < 32) chunk_cumsum(dt, ((size_t)b * S + s0) * H + h, H, Q, A[h], cs, dts, tid);
  __syncthreads();
  const float cl = cs[Q - 1];
  for (int k = tid; k < K8; k += kStateThreads) wk[k] = k < Q ? expf(cl - cs[k]) * dts[k] : 0.f;
  cp_async_wait<0>();
  __syncthreads();

  const int lane = tid % 32, warp = tid / 32, g = lane >> 2, t = lane & 3;
  const int m0 = (warp % 2) * (PB / 2), n0 = (warp / 2) * (NB / 4);
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) zero(acc[i]);
#pragma unroll 2
  for (int k0 = 0; k0 < K8; k0 += 8) {
    const float w0 = wk[k0 + t], w4 = wk[k0 + t + 4];
    const float* a = xs + (k0 + t) * ldx + m0 + g;
    const float* bb = bs + (k0 + t) * ldb + n0 + g;
    uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      split_tf32(a[16 * i] * w0, ah[i][0], al[i][0]);
      split_tf32(a[16 * i + 8] * w0, ah[i][1], al[i][1]);
      split_tf32(a[4 * ldx + 16 * i] * w4, ah[i][2], al[i][2]);
      split_tf32(a[4 * ldx + 16 * i + 8] * w4, ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      split_tf32(bb[8 * j], bh[j][0], bl[j][0]);
      split_tf32(bb[4 * ldb + 8 * j], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) mma3(acc[i], ah[i], al[i], bh, bl);
  }
  float* out = work + (bh * nc + c) * (size_t)P * N;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = m0 + 16 * i + g + (e >= 2 ? 8 : 0), n = n0 + 8 * j + 2 * t + (e & 1);
        if (p < P && n < N) out[p * N + n] = acc[i][j][e];
      }
  if (tid == 0) cl_out[bh * nc + c] = cl;
}

// (b) over the chunks in order: work[(bh, c)] becomes the state entering
// chunk c; the state after the last chunk goes to fstate
__global__ void __launch_bounds__(256)
state_pass_kernel(float* __restrict__ work, const float* __restrict__ cl,
                  float* __restrict__ fstate, int nc, int PN) {
  const int i = blockIdx.y * 256 + threadIdx.x;
  const size_t bh = blockIdx.x;
  if (i >= PN) return;
  float s = 0.f;
  float* w = work + bh * nc * PN + i;
  const float* clc = cl + bh * nc;
#pragma unroll 1
  for (int c0 = 0; c0 < nc; c0 += kBatch) {  // a batch of chunks' loads, then their stores
    float v[kBatch], d[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool ok = c0 + u < nc;
      v[u] = ok ? w[(size_t)(c0 + u) * PN] : 0.f;
      d[u] = ok ? expf(clc[c0 + u]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (c0 + u < nc) {
        w[(size_t)(c0 + u) * PN] = s;
        s = d[u] * s + v[u];
      }
    }
  }
  fstate[bh * PN + i] = s;
}

// (c) y of rows q0..q0+63 of chunk c, a warp 16 rows by all P columns: over
// key tiles of 32 through a two-stage cp.async ring, the scores C Bᵀ, their
// decay and causal mask, and y += G x with G kept in registers; then
// y += (C ⊙ exp(cs)) stateᵀ with the state that enters the chunk.
template <typename T, int PB, int NB>
__global__ void __launch_bounds__(kOutThreads)
chunk_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, const float* __restrict__ work, T* __restrict__ y,
                 int S, int H, int P, int N, int Q, long long sbb, long long sbs, long long sbh,
                 long long scb, long long scs, long long sch, int async, int async_state) {
  constexpr int NY = PB / 8, ldc = NB + 4, ldx = PB + 4;
  constexpr int kStage = kKt * ldc + kKt * ldx;
  extern __shared__ float4 smem4[];
  float* cts = reinterpret_cast<float*>(smem4);  // kR x ldc   C of the rows, [r][n]
  float* stage = cts + kR * ldc;  // 2 x (B [key][n], then x [key][p]); after the keys,
                                  // the entering state [p][n] (P x ldc fits in both)
  float* cs = stage + 2 * kStage;  // Q
  float* dts = cs + kQmax;         // Q

  const int bh = blockIdx.x, c = blockIdx.y;
  const int rt = gridDim.z - 1 - blockIdx.z;  // the row tiles with the most keys first
  const int b = bh / H, h = bh % H, nc = gridDim.y;
  const int s0 = c * Q, q0 = rt * kR, nq = min(kR, Q - q0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;                      // the warp's rows of the tile
  const int rlo = q0 + wr + g, rhi = rlo + 8;    // this thread's rows in the chunk
  const int nkt = (q0 + nq - 1) / kKt + 1;       // key tiles up to the last row
  const T* Bp = Bm + b * sbb + h * sbh + (long long)s0 * sbs;
  const T* Xp = x + (((size_t)b * S + s0) * H + h) * P;
  const long long xrow = (long long)H * P;

  auto issue = [&](int kt) {  // key tile kt into stage kt % 2
    float* st = stage + (kt & 1) * kStage;
    const int k0 = kt * kKt, nk = min(kKt, Q - k0);
    fill_tile<T>(st, ldc, Bp + (long long)k0 * sbs, sbs, nk, N, kKt, NB, async, tid, kOutThreads);
    fill_tile<T>(st + kKt * ldc, ldx, Xp + k0 * xrow, xrow, nk, P, kKt, PB, async, tid,
                 kOutThreads);
    cp_async_commit();
  };
  fill_tile<T>(cts, ldc, Cm + b * scb + h * sch + (long long)(s0 + q0) * scs, scs, nq, N, kR, NB,
               async, tid, kOutThreads);
  issue(0);  // one group: C and key tile 0
  if (tid < 32) chunk_cumsum(dt, ((size_t)b * S + s0) * H + h, H, Q, A[h], cs, dts, tid);

  float acc[NY][4];
  zero(acc);
  const int n8 = round8(N);
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      issue(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // key tile kt (the first time also C and cs) is in
    const int k0 = kt * kKt;
    if (k0 <= q0 + wr + 15) {  // some key of the tile is causal for the warp's rows
      const float* bt = stage + (kt & 1) * kStage;
      const float* xt = bt + kKt * ldc;
      float sc[kKt / 8][4];
      zero(sc);
#pragma unroll 2
      for (int n0 = 0; n0 < n8; n0 += 8) {
        uint32_t ah[4], al[4];
        const float* a = cts + (wr + g) * ldc + n0 + t;
        split_tf32(a[0], ah[0], al[0]);
        split_tf32(a[8 * ldc], ah[1], al[1]);
        split_tf32(a[4], ah[2], al[2]);
        split_tf32(a[8 * ldc + 4], ah[3], al[3]);
        uint32_t bh[kKt / 8][2], bl[kKt / 8][2];
#pragma unroll
        for (int j = 0; j < kKt / 8; ++j) {
          const float* bb = bt + (8 * j + g) * ldc + n0 + t;
          split_tf32(bb[0], bh[j][0], bl[j][0]);
          split_tf32(bb[4], bh[j][1], bl[j][1]);
        }
        mma3(sc, ah, al, bh, bl);
      }
      // G = scores ⊙ exp(cs_q - cs_k) dt_k for k <= q, as the A operand of
      // y += G x with the k index of a step permuted: fragment column t is
      // key 8j + 2t and t + 4 is 8j + 2t + 1, which is where the scores'
      // accumulator holds them
#pragma unroll
      for (int j = 0; j < kKt / 8; ++j) {
        const int ka = k0 + 8 * j + 2 * t, kb = ka + 1;
        const float g0 = (rlo < Q && ka <= rlo) ? sc[j][0] * expf(cs[rlo] - cs[ka]) * dts[ka] : 0.f;
        const float g1 = (rlo < Q && kb <= rlo) ? sc[j][1] * expf(cs[rlo] - cs[kb]) * dts[kb] : 0.f;
        const float g2 = (rhi < Q && ka <= rhi) ? sc[j][2] * expf(cs[rhi] - cs[ka]) * dts[ka] : 0.f;
        const float g3 = (rhi < Q && kb <= rhi) ? sc[j][3] * expf(cs[rhi] - cs[kb]) * dts[kb] : 0.f;
        uint32_t ah[4], al[4];
        split_tf32(g0, ah[0], al[0]);  // (row g, key ka)
        split_tf32(g2, ah[1], al[1]);  // (row g + 8, key ka)
        split_tf32(g1, ah[2], al[2]);  // (row g, key kb)
        split_tf32(g3, ah[3], al[3]);  // (row g + 8, key kb)
        const float* xa = xt + (8 * j + 2 * t) * ldx + g;
        uint32_t bh[NY][2], bl[NY][2];
#pragma unroll
        for (int jj = 0; jj < NY; ++jj) {
          split_tf32(xa[8 * jj], bh[jj][0], bl[jj][0]);
          split_tf32(xa[ldx + 8 * jj], bh[jj][1], bl[jj][1]);
        }
        mma3(acc, ah, al, bh, bl);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  if (c > 0) {  // the state entering chunk 0 is zero
    fill_tile<float>(stage, ldc, work + ((size_t)bh * nc + c) * (size_t)P * N, N, P, N, PB, NB,
                     async_state, tid, kOutThreads);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const float elo = rlo < Q ? expf(cs[rlo]) : 0.f, ehi = rhi < Q ? expf(cs[rhi]) : 0.f;
#pragma unroll 2
    for (int n0 = 0; n0 < n8; n0 += 8) {
      uint32_t ah[4], al[4];
      const float* a = cts + (wr + g) * ldc + n0 + t;
      split_tf32(a[0] * elo, ah[0], al[0]);
      split_tf32(a[8 * ldc] * ehi, ah[1], al[1]);
      split_tf32(a[4] * elo, ah[2], al[2]);
      split_tf32(a[8 * ldc + 4] * ehi, ah[3], al[3]);
      uint32_t bh[NY][2], bl[NY][2];
#pragma unroll
      for (int jj = 0; jj < NY; ++jj) {
        const float* bb = stage + (8 * jj + g) * ldc + n0 + t;
        split_tf32(bb[0], bh[jj][0], bl[jj][0]);
        split_tf32(bb[4], bh[jj][1], bl[jj][1]);
      }
      mma3(acc, ah, al, bh, bl);
    }
  }

#pragma unroll
  for (int jj = 0; jj < NY; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = e >= 2 ? rhi : rlo, p = 8 * jj + 2 * t + (e & 1);
      if (q < Q && p < P) store(y + (((size_t)b * S + s0 + q) * H + h) * P + p, acc[jj][e]);
    }
}

template <typename T, int PB, int NB>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, void* y, void* fs, void* work, int B, int S, int H, int P,
                   int N, int Q, long long sbb, long long sbs, long long sbh, long long scb,
                   long long scs, long long sch, cudaStream_t stream) {
  const int nc = S / Q;
  const size_t sa = state_smem(PB, NB), sc = out_smem(PB, NB);
  if (sa > kMaxSmem || sc > kMaxSmem || B > 65535 || H > 65535 || nc > 65535 ||
      (long long)B * H > 2147483647LL)
    return cudaErrorInvalidValue;
  // cp.async copies 16 bytes: float32 rows that start on 16-byte boundaries
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int async = std::is_same<T, float>::value && P % 4 == 0 && N % 4 == 0 &&
                    (sbb | sbs | sbh | scb | scs | sch) % 4 == 0 && a16(x) && a16(Bm) && a16(Cm);
  const int async_state = N % 4 == 0;  // the workspace comes from the allocator, aligned
  auto ka = chunk_state_kernel<T, PB, NB>;
  auto kc = chunk_out_kernel<T, PB, NB>;
  cudaError_t err = cudaFuncSetAttribute(ka, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sa);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sc);
  if (err != cudaSuccess) return err;
  float* ws = static_cast<float*>(work);
  float* cl = ws + (size_t)B * H * nc * P * N;
  const T* xt = static_cast<const T*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const T* Bt = static_cast<const T*>(Bm);
  ka<<<dim3(nc, H, B), kStateThreads, sa, stream>>>(xt, dtf, Af, Bt, ws, cl, S, H, P, N, Q, sbb,
                                                     sbs, sbh, async);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  state_pass_kernel<<<dim3(B * H, (P * N + 255) / 256), 256, 0, stream>>>(
      ws, cl, static_cast<float*>(fs), nc, P * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kc<<<dim3(B * H, nc, (Q + kR - 1) / kR), kOutThreads, sc, stream>>>(
      xt, dtf, Af, Bt, static_cast<const T*>(Cm), ws, static_cast<T*>(y), S, H, P, N, Q, sbb,
      sbs, sbh, scb, scs, sch, async, async_state);
  return cudaGetLastError();
}

template <typename T, int PB>
cudaError_t by_n(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* fs, void* w, int B, int S, int H, int P, int N,
                 int Q, long long sbb, long long sbs, long long sbh, long long scb,
                 long long scs, long long sch, cudaStream_t s) {
  if (N <= 32)
    return launch<T, PB, 32>(x, dt, A, Bm, Cm, y, fs, w, B, S, H, P, N, Q, sbb, sbs, sbh, scb, scs, sch, s);
  if (N <= 64)
    return launch<T, PB, 64>(x, dt, A, Bm, Cm, y, fs, w, B, S, H, P, N, Q, sbb, sbs, sbh, scb, scs, sch, s);
  return launch<T, PB, 128>(x, dt, A, Bm, Cm, y, fs, w, B, S, H, P, N, Q, sbb, sbs, sbh, scb, scs, sch, s);
}

template <typename T>
cudaError_t by_p(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* fs, void* w, int B, int S, int H, int P, int N,
                 int Q, long long sbb, long long sbs, long long sbh, long long scb,
                 long long scs, long long sch, cudaStream_t s) {
  if (P <= 32)
    return by_n<T, 32>(x, dt, A, Bm, Cm, y, fs, w, B, S, H, P, N, Q, sbb, sbs, sbh, scb, scs, sch, s);
  if (P <= 64)
    return by_n<T, 64>(x, dt, A, Bm, Cm, y, fs, w, B, S, H, P, N, Q, sbb, sbs, sbh, scb, scs, sch, s);
  return by_n<T, 128>(x, dt, A, Bm, Cm, y, fs, w, B, S, H, P, N, Q, sbb, sbs, sbh, scb, scs, sch, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B_, C_, y). x/y (B,S,H,P) contiguous,
// dt (B,S,H) and A (H,) float32 contiguous, fstate (B,H,P,N) float32. B_ and C_
// are read at b*sb + s*ss + h*sh + n (element strides; the last dim is
// contiguous). work: B*H*(S/Q)*(P*N + 1) float32 of scratch. Returns a
// cudaError_t: the first launch's that failed, else cudaSuccess.
extern "C" int ssd_scan(int dtype, const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, void* y, void* fstate, void* work,
                        int B, int S, int H, int P, int N, int Q, long long sbb,
                        long long sbs, long long sbh, long long scb, long long scs,
                        long long sch, void* stream) {
  if (B <= 0 || H <= 0 || Q < 1 || Q > kQmax || S <= 0 || S % Q != 0 || P < 1 ||
      P > 128 || N < 1 || N > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)by_p<float>(x, dt, A, Bm, Cm, y, fstate, work, B, S, H, P, N, Q, sbb, sbs, sbh, scb, scs, sch, s);
  if (dtype == 1)
    return (int)by_p<__nv_bfloat16>(x, dt, A, Bm, Cm, y, fstate, work, B, S, H, P, N, Q, sbb, sbs, sbh, scb, scs, sch, s);
  return (int)cudaErrorInvalidValue;
}
