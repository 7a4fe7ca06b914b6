// Decode attention for Hopper, sm_90a: one new token per sequence against a
// linear or ring KV cache, split over the KV axis (flash-decoding).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::decode_attention
// (body _decode_kernel). q (B,H,hd), k/v (B,Smax,K,hd), pos_ids (B,Smax) int32
// (slot -> absolute position, -1 = empty), lengths (B,) int32 (the new token's
// position). A slot is valid iff pos_id >= 0, pos_id <= length and, with a
// window, length - pos_id < window, so slot order does not matter and a ring
// cache mid-wrap works. Any Smax; hd 8, 16, 32, 64, 128 and 256; G = H/K query
// heads a KV head with G * hd <= 2048 (gemma2-2b: G <= 8 at hd 256).
//
// What bounds it on this card: bytes. A call must read the K/V rows of the
// valid slots, 2*K*hd*4 bytes a slot in float32, and does ~4*G FLOPs per
// 4 bytes it reads. So both products (the G x nv scores and p V) stay on
// the CUDA cores, in float32: a 16-row tensor-core tile would be mostly
// padding at G = 2 query rows a KV head, and would not move the bytes.
// Design: the TPU grid walks the KV blocks of a (batch, KV head) in order and
// carries (m, l, acc) across them. Here the slots are split across blocks:
//  (1) split_kernel, one block per (split, KV head, batch), serving the G
//      query heads of its KV head. A split is a run of whole tiles of kSplit
//      slots. For each tile the block reads the pos_ids first and compacts
//      the valid slots in slot order; a tile with none loads nothing. It
//      then reads each valid K and V row once, with 16-byte loads, all of a
//      thread's loads in flight before any store, into shared memory,
//      computes the G x nv scores, and carries (m, l, acc) over its tiles
//      with the online softmax. It writes the partial (m, l, acc[G][hd]) in
//      float32 (l = 0 for a split with no valid slot).
//  (2) the last split block of each (batch, KV head) to finish, found with
//      a counter that it resets to 0, merges the splits in split order:
//      M = max m, L = sum l exp(m - M), o = sum acc exp(m - M) /
//      max(L, 1e-30), and writes o in q's type. Where the caller asks for
//      it, it writes o in float32 instead, and each head's log-sum-exp of
//      the scaled (and capped) scores over the valid slots, lse = M + log L
//      (-inf for a row with no valid slot), so that partial results over
//      disjoint slot ranges (the ranks of a cache split on its sequence)
//      can be merged: o = sum_r exp(lse_r - M) o_r / sum_r exp(lse_r - M).
//      One launch a call; only the counter is atomic, and every sum runs
//      in a fixed order, so two runs give the same bits.
// kSplit is 64 slots (32 at hd 256, to bound shared memory at 83 KB), and
// the tiles a split takes are as few as give ~4 blocks an SM: at the served
// shape (4 sequences, 8 KV heads, a 640-slot cache) one tile, 10 x 8 x 4 =
// 320 blocks (one a (batch, KV head) would be 32); at a 4,224-slot
// cache four tiles, 17 splits, so that the merge walks 17 partials, not 66.
//
// Masking follows the reference: masked scores are the finite -1e30 and l is
// clamped at 1e-30. Skipping an invalid slot is exact whenever the row has a
// valid one: its weight exp(-1e30 - m) is 0 in float32. A row with no valid
// slot at all gives, as in the reference, weight 1 to every slot: the merge
// takes the mean of V over all Smax slots for it (under lse, from sums of V
// that each split without a valid slot leaves in its acc).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kTargetBlocks = 4 * 132;  // split blocks: four on each SM of an H100
constexpr size_t kMaxSmem = 232448;  // bytes a block may have on sm_90

template <int HD>
__host__ __device__ constexpr int split_of() { return HD >= 256 ? 32 : 64; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes of a row as floats: 4 float32 or 8 bfloat16
__device__ __forceinline__ void ld16(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void ld16(float* dst, const __nv_bfloat16* src) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

size_t split_smem(int G, int HD, int SP) {
  return ((size_t)2 * G * HD + 2 * (size_t)SP * (HD + 1) + (size_t)G * (SP + 1) + SP +
          3 * (size_t)G) * sizeof(float);
}

// The merge of the nsplit partials of (b, kvh), by one block. The partials
// were written by other blocks: read them through L2 (__ldcg), past L1.
template <typename T>
__device__ __forceinline__ void merge_row(const float* __restrict__ part_acc,
                                          const float* __restrict__ part_ml,
                                          const T* __restrict__ v, void* __restrict__ o,
                                          float* __restrict__ lse, int H, int K, int Smax,
                                          int HD, int nsplit, int b, int kvh) {
  __shared__ float sm_max[kThreads], sm_sum[kThreads];  // per head; G <= 256
  const int G = H / K;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t part0 = ((size_t)b * K + kvh) * nsplit;
  // each head's M = max m and L = sum l exp(m - M) over the splits that have
  // a valid slot (l > 0): one warp a head, lanes over the splits in a fixed
  // pattern, then a fixed shuffle tree
  for (int g = warp; g < G; g += kThreads / 32) {
    float m = kNegInf;
    bool any = false;
    for (int s = lane; s < nsplit; s += 32) {
      const float* ml = part_ml + ((part0 + s) * G + g) * 2;
      if (__ldcg(ml + 1) > 0.f) {
        m = fmaxf(m, __ldcg(ml));
        any = true;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    any = __any_sync(0xffffffffu, any);
    float l = 0.f;
    for (int s = lane; s < nsplit; s += 32) {
      const float* ml = part_ml + ((part0 + s) * G + g) * 2;
      const float ls = __ldcg(ml + 1);
      if (ls > 0.f) l += ls * expf(__ldcg(ml) - m);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      sm_max[g] = m;
      sm_sum[g] = any ? l : -1.f;  // -1: no valid slot in the row
    }
  }
  __syncthreads();
  if (lse != nullptr) {  // L > 0 wherever a split had a valid slot
    for (int g = tid; g < G; g += kThreads)
      lse[(size_t)b * H + (size_t)kvh * G + g] =
          sm_sum[g] >= 0.f ? sm_max[g] + logf(sm_sum[g]) : __int_as_float(0xff800000);  // -inf
  }
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    const float M = sm_max[g], L = sm_sum[g];
    float out;
    if (L >= 0.f) {
      float acc = 0.f;
#pragma unroll 8
      for (int s = 0; s < nsplit; ++s) {
        const size_t r = (part0 + s) * G + g;
        const float l = __ldcg(part_ml + r * 2 + 1);
        const float a = __ldcg(part_acc + r * HD + d);
        acc += l > 0.f ? a * expf(__ldcg(part_ml + r * 2) - M) : 0.f;
      }
      out = acc / fmaxf(L, 1e-30f);
    } else if (lse != nullptr) {  // no valid slot: the splits' sums of V
      float acc = 0.f;
      for (int s = 0; s < nsplit; ++s) acc += __ldcg(part_acc + ((part0 + s) * G + g) * HD + d);
      out = acc / (float)Smax;
    } else {  // no valid slot: every score -1e30, every weight 1
      float acc = 0.f;
      for (int j = 0; j < Smax; ++j) acc += to_f(v[(((size_t)b * Smax + j) * K + kvh) * HD + d]);
      out = acc / fmaxf((float)Smax, 1e-30f);
    }
    const size_t at = ((size_t)b * H + (size_t)kvh * G + g) * HD + d;
    if (lse != nullptr)  // a partial result for a merge: float32
      static_cast<float*>(o)[at] = out;
    else
      store(static_cast<T*>(o) + at, out);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 3)
split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ pos_ids, const int* __restrict__ lengths,
             float* __restrict__ part_acc, float* __restrict__ part_ml, void* __restrict__ o,
             float* __restrict__ lse, int* __restrict__ counters, int H, int K, int Smax,
             int tiles_per_split, int window, float cap, float scale, int vec) {
  constexpr int SP = split_of<HD>();
  constexpr int LD = HD + 1;  // odd: lanes on consecutive slots hit distinct banks
  constexpr int E = 16 / sizeof(T);
  constexpr int CPR = HD / E;                                // 16-byte pieces a row
  constexpr int PER = (SP * CPR + kThreads - 1) / kThreads;  // pieces a thread
  __shared__ int warp_count[SP / 32];
  extern __shared__ float smem[];
  const int G = H / K;
  float* qs = smem;                  // G x HD     q of the group's heads
  float* ks = qs + G * HD;           // SP x LD    K of a tile's valid slots
  float* vs = ks + SP * LD;          // SP x LD    V of a tile's valid slots
  float* ps = vs + SP * LD;          // G x SP+1   scores, then weights
  int* slot = reinterpret_cast<int*>(ps + G * (SP + 1));  // SP  valid slots, in order
  float* run_m = reinterpret_cast<float*>(slot + SP);    // G   running max
  float* run_l = run_m + G;                               // G   running sum
  float* alpha = run_l + G;                               // G   rescale of the running acc
  float* acc = alpha + G;                                 // G x HD  the running acc

  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int qpos = lengths[b];
  const int ntiles = (Smax + SP - 1) / SP;
  const int tile0 = sp * tiles_per_split, tile1 = min(ntiles, tile0 + tiles_per_split);
  const size_t part = ((size_t)b * K + kvh) * gridDim.x + sp;  // this block's partial

  const size_t qoff = ((size_t)b * H + (size_t)kvh * G) * HD;
  for (int i = tid; i < G * HD; i += kThreads) {
    qs[i] = to_f(q[qoff + i]);
    acc[i] = 0.f;  // each thread keeps the same elements i throughout
  }
  for (int g = tid; g < G; g += kThreads) {
    run_m[g] = kNegInf;
    run_l[g] = 0.f;
  }

  for (int tile = tile0; tile < tile1; ++tile) {
    const int j0 = tile * SP;
    // 1. which slots of the tile are valid, before any K/V is read
    bool valid = false;
    if (tid < SP && j0 + tid < Smax) {
      const int pid = pos_ids[(size_t)b * Smax + j0 + tid];
      valid = pid >= 0 && pid <= qpos && (window <= 0 || qpos - pid < window);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    if (tid < SP && lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();  // (also: the previous tile is done with every buffer)
    int nv = 0, before = 0;
#pragma unroll
    for (int w = 0; w < SP / 32; ++w) {
      before += w < warp ? warp_count[w] : 0;
      nv += warp_count[w];
    }
    __syncthreads();  // every thread has read warp_count
    if (nv == 0) continue;  // block-uniform: nothing to load
    if (valid) slot[before + __popc(ballot & ((1u << lane) - 1u))] = j0 + tid;
    __syncthreads();

    // 2. K and V of the valid slots, each row once, in 16-byte pieces: every
    // thread issues all of its loads before it stores any
    float kr[PER][E], vr[PER][E];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * kThreads, t = i / CPR, c = (i % CPR) * E;
      if (t < nv) {
        const size_t off = (((size_t)b * Smax + slot[t]) * K + kvh) * HD + c;
        if (vec) {
          ld16(kr[u], k + off);
          ld16(vr[u], v + off);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            kr[u][e] = to_f(k[off + e]);
            vr[u][e] = to_f(v[off + e]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * kThreads, t = i / CPR, c = (i % CPR) * E;
      if (t < nv) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          ks[t * LD + c + e] = kr[u][e];
          vs[t * LD + c + e] = vr[u][e];
        }
      }
    }
    __syncthreads();

    // 3. the scores, scaled and capped
    for (int i = tid; i < G * nv; i += kThreads) {
      const int g = i / nv, t = i % nv;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) s = fmaf(qs[g * HD + d], ks[t * LD + d], s);
      s *= scale;
      if (cap > 0.f) s = cap * tanhf(s / cap);
      ps[g * (SP + 1) + t] = s;
    }
    __syncthreads();

    // 4. each head's new max, weights and running sum: one warp a head
    for (int g = warp; g < G; g += kThreads / 32) {
      float* pg = ps + g * (SP + 1);
      float m = run_m[g];
      for (int t = lane; t < nv; t += 32) m = fmaxf(m, pg[t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float l = 0.f;
      for (int t = lane; t < nv; t += 32) {
        const float p = expf(pg[t] - m);
        pg[t] = p;
        l += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
      __syncwarp();
      if (lane == 0) {
        const float a = expf(run_m[g] - m);
        alpha[g] = a;
        run_l[g] = run_l[g] * a + l;
        run_m[g] = m;
      }
    }
    __syncthreads();

    // 5. acc = acc * alpha + p V
    for (int i = tid; i < G * HD; i += kThreads) {
      const int g = i / HD, d = i % HD;
      const float* pg = ps + g * (SP + 1);
      float a = 0.f;
      for (int t = 0; t < nv; ++t) a = fmaf(pg[t], vs[t * LD + d], a);
      acc[i] = acc[i] * alpha[g] + a;
    }
  }
  __syncthreads();
  // Under a merge (lse wanted), a split with no valid slot keeps in its acc
  // the sum of V over its slots, so that a row with no valid slot anywhere
  // gets its mean of V from the splits in parallel (on a rank whose slots
  // are all empty, every step). A row with a valid slot never reads these
  // sums, and without lse nothing changes.
  if (lse != nullptr && run_l[0] == 0.f) {  // block-uniform: validity is per row
    constexpr int R = kThreads / HD;  // slots summed side by side; R * HD fits in ks
    const int d = tid % HD, r = tid / HD;
    const int j1 = min(Smax, tile1 * SP);
    float s = 0.f;
#pragma unroll 4
    for (int j = tile0 * SP + r; j < j1; j += R)
      s += to_f(v[(((size_t)b * Smax + j) * K + kvh) * HD + d]);
    ks[r * HD + d] = s;
    __syncthreads();
    if (tid < HD) {
      float t = 0.f;
      for (int i = 0; i < R; ++i) t += ks[i * HD + tid];
      for (int g = 0; g < G; ++g) acc[g * HD + tid] = t;
    }
    __syncthreads();
  }
  for (int g = tid; g < G; g += kThreads) {  // l = 0: no valid slot in the split
    part_ml[(part * G + g) * 2] = run_m[g];
    part_ml[(part * G + g) * 2 + 1] = run_l[g];
  }
  for (int i = tid; i < G * HD; i += kThreads) part_acc[part * G * HD + i] = acc[i];

  // the last split block of (b, kvh) to finish merges them all, then resets
  // the counter for the next call
  __shared__ int last;
  __threadfence();  // this block's partial is visible before it is counted
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + b * K + kvh, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  merge_row<T>(part_acc, part_ml, v, o, lse, H, K, Smax, HD, gridDim.x, b, kvh);
  if (tid == 0) counters[b * K + kvh] = 0;
}


template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pos,
                   const void* len, void* o, void* lse, void* work, long long work_floats,
                   void* counters, int B, int H, int K, int Smax, int window, float cap,
                   float scale, cudaStream_t stream) {
  constexpr int SP = split_of<HD>();
  const int G = H / K;
  // as many splits of whole tiles as make about kTargetBlocks blocks, and
  // never fewer tiles a split than needed: one tile each at the served shape
  const int ntiles = (Smax + SP - 1) / SP;
  const int want = std::min(ntiles, std::max(1, (kTargetBlocks + B * K - 1) / (B * K)));
  const int per = (ntiles + want - 1) / want;
  const int nsplit = (ntiles + per - 1) / per;
  const size_t smem = split_smem(G, HD, SP);
  if (G * HD > 2048 || smem > kMaxSmem || B > 65535 || K > 65535 ||
      work_floats < (long long)B * H * nsplit * (HD + 2))
    return cudaErrorInvalidValue;
  auto kernel = split_kernel<T, HD>;
  // The limit is the kernel's, shared by every caller: set it once, to what
  // the largest group (G = 2048 / HD) asks. Set per call to this call's
  // smem, a thread at a smaller G could lower it between another thread's
  // set and launch, whose launch then failed (cudaErrorInvalidValue).
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)split_smem(2048 / HD, HD, SP));
  if (attr != cudaSuccess) return attr;
  const int vec = ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  float* part_acc = static_cast<float*>(work);
  float* part_ml = part_acc + (size_t)B * H * nsplit * HD;
  kernel<<<dim3(nsplit, K, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pos), static_cast<const int*>(len), part_acc, part_ml, o,
      static_cast<float*>(lse), static_cast<int*>(counters), H, K, Smax, per, window, cap, scale,
      vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, const void* pos,
                     const void* len, void* o, void* lse, void* w, long long wn, void* cnt,
                     int B, int H, int K, int Smax, int window, float cap, float scale,
                     cudaStream_t s) {
#define DECODE_CASE(D) \
  case D:              \
    return launch<T, D>(q, k, v, pos, len, o, lse, w, wn, cnt, B, H, K, Smax, window, cap, scale, s);
  switch (hd) {
    DECODE_CASE(8)
    DECODE_CASE(16)
    DECODE_CASE(32)
    DECODE_CASE(64)
    DECODE_CASE(128)
    DECODE_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef DECODE_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/o (B,H,hd), k/v (B,Smax,K,hd),
// pos_ids (B,Smax) int32, lengths (B,) int32, all contiguous. lse: null
// (o in q's type), or float32 (B,H) for each head's log-sum-exp over its
// valid slots, -inf where it has none (o in float32). work:
// float32 scratch of work_floats >= B*H*ceil(Smax/split)*(hd + 2), split 64
// slots (32 at hd 256). counters: B*K int32, zero before the call and zero
// again after it (the kernel resets what it counts). Returns a cudaError_t.
extern "C" int decode_attention(int dtype, const void* q, const void* k, const void* v,
                                const void* pos_ids, const void* lengths, void* o, void* lse,
                                void* work, long long work_floats, void* counters, int B, int H,
                                int K, int Smax, int hd, int window, float softcap, float scale,
                                void* stream) {
  if (B <= 0 || Smax <= 0 || K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(hd, q, k, v, pos_ids, lengths, o, lse, work, work_floats,
                                counters, B, H, K, Smax, window, softcap, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(hd, q, k, v, pos_ids, lengths, o, lse, work,
                                        work_floats, counters, B, H, K, Smax, window, softcap,
                                        scale, s);
  return (int)cudaErrorInvalidValue;
}
