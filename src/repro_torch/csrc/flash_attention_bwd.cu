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
//   dK = dS^T Q * scale   (pass 1: K/V tiles of one (b, kv head), over the rows)
//   dQ = dS K * scale     (pass 2: a block owns a tile of folded query rows)
// Masking, the GQA fold (row = q * G + g) and the causal / window tile
// skipping follow the forward. In pass 1 a key tile walks the folded G*Sq
// rows from its causal frontier up to its window edge, so dK and dV sum the G
// heads in registers. Sq and Sk are independent (seamless's cross-attention
// trains non-causal at Sq != Sk): rows stop at G*Sq and keys at Sk, and a key
// tile that no row sees (causal, keys past Sq - 1) walks no rows and writes
// dK = dV = 0.
//
// Deterministic: no atomics. dQ is not accumulated across the key blocks of
// pass 1 (FA2's float atomics, whose order changes from run to run) but
// computed by its own pass, which recomputes S, P and dP. That costs 7 tile
// products instead of 5: 1.4x the backward's counted operations (which are
// 2.5x the forward's). Exact resume of a crashed training run relies on
// gradients that repeat bit for bit.
//
// Tensor-core variant (bfloat16 at hd 64, 128 and 256; the training path): P and
// dS are rounded to bf16 as product operands, dK, dV and dQ accumulate in
// float32, and a double-buffered cp.async ring streams the tiles a block
// walks (Q/dO rows with their lse and D in pass 1, K/V in pass 2).
// - Pass 1 is balanced over the causal rows. Under the causal mask a key
//   tile's walk shrinks with its position (at qwen2-0.5b's training shape,
//   q (4,2048,14,64) k/v (4,2048,2,64), the first walks 224 stages of 64
//   rows and the last 7), so one block a tile left the card waiting on the
//   longest walks. kernels/flash_attention_bwd.py::dkdv_schedule cuts each
//   walk into segments of about equal length (about two waves of 3 blocks on
//   132 SMs: 904 blocks at that shape where there were 256) and orders them
//   longest first; a block takes one segment. A tile walked by one segment
//   writes dk and dv itself; the segments of a cut tile write their float32
//   sums to a workspace the wrapper allocates, and dkdv_merge_kernel adds
//   them in segment (= row) order and rounds once to bf16. The cuts and the
//   order of every sum depend on the shape alone: runs repeat bit for bit.
// - Both passes run on wgmma, Hopper's warpgroup products (dkdv_wg_kernel,
//   dq_wg_kernel): a block is one warpgroup; B comes straight from shared
//   tiles in the 128-byte swizzle, one tile read K-major (S^T = K Q^T,
//   dP^T = V dO^T, S = Q K^T, dP = dO V^T) and MN-major (dV += P^T dO,
//   dK += dS^T Q, dQ += dS K); A from registers at hd 64 (the warp's K/V or
//   Q/dO fragments, loaded once; P and dS as computed) and from shared
//   memory for K/V and Q/dO at hd 128. (With mma.sync every warp reads the
//   whole stage through ldmatrix; a warpgroup product reads it once for the
//   four warps.)
// - What bounds it on an H100 is not the products' operations (the
//   backward's take ~0.08 ms at 989 TFLOP/s at the training shape) but
//   latency: a block waits for each group of products before the
//   elementwise work that feeds the next, and 3 blocks (12 warps) an SM hide
//   what they can. So that work is kept short and free of branches: 2^x in
//   one MUFU.EX2 (ex2.approx.ftz), the scale folded into one multiply,
//   masking and the softcap in copies of the loop chosen by block-uniform
//   branches, the division of a folded row by G as a multiply-high; at hd
//   64 both passes are capped at 168 registers (3 blocks an SM; at hd 128,
//   2). D is a pre-pass of 16-byte loads.
// - hd 256 (gemma2-2b, softcap 50 and a 4096-key window on its local
//   layers): what bounds it is operations, 0.174 ms at 989 TFLOP/s at its
//   training shape q (4,2048,8,256) k/v (4,2048,4,256) causal against
//   0.06 ms of bytes, 11.1 ms at a global layer of prefill_32k's length.
//   One warpgroup cannot hold the accumulators: dK and dV of 64 keys x 256
//   columns are 256 float32 registers a thread (the limit is 255), dQ of
//   64 rows 128. So a block is two warpgroups, each owning half of the
//   columns of dK and dV (pass 1) or dQ (pass 2): 64 + 64 (or 64)
//   accumulator registers a thread. S and dP, which both need, are not
//   computed twice over the whole head dim (1.5x pass 1's products, 1.67x
//   pass 2's): warpgroup 0 computes S (S^T), warpgroup 1 dP (dP^T), each
//   over all 256 columns. Nor is the elementwise work (the softcap's tanh,
//   2^x, the masks) done twice: warpgroup w forms P and dS of its half of
//   the n-blocks (the A operands' k-steps), from its own product and the
//   half of the other's it needs, and the two then swap the bf16 P and dS
//   they formed; each exchange goes through shared memory in the
//   accumulators' own layout (thread i of one warpgroup holds what thread i
//   of the other needs), behind a __syncthreads. Each warpgroup then takes
//   its columns' dV, dK (or dQ) products. Every product and every
//   exponential is done once. The exchanges take 16 KiB in pass 1 and 24
//   KiB in pass 2, each buffer rewritten only after a barrier that follows
//   the other warpgroup's read; with the Q, dO, K and V tiles of 32 KiB
//   each, 215,040 and 222,208 bytes of the 232,448 a block may use, so one
//   block (8 warps) an SM. FA3's alternative, transposed products with P
//   and dS staged through shared memory in bf16, would not fit beside
//   these tiles. The schedule's target is two waves of 132 SMs at the
//   route's blocks an SM (kernels/flash_attention_bwd.py::target_blocks).
// CUDA-core variant (float32 at every head dim, bfloat16 at hd 8, 16, 32):
// hd/8 threads own a key (pass 1) or a query row (pass 2), 8 dims each,
// with shuffle reductions for the dot products, as the forward's CUDA-core
// variant; one block a key tile in pass 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

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

// ---- tensor-core variant (bf16, hd 64, 128, 256): warpgroup products -------
//
// A block is one warpgroup (4 warps; two at hd 256) issuing wgmma. Every tile a block
// streams lives in shared memory as HD/64 sub-tiles of 64 rows x 128 bytes
// (64 bf16 columns each) in the 128-byte swizzle: 16-byte chunk c of row r
// sits at chunk c ^ (r % 8) of its row, each sub-tile 1024-byte aligned. One
// such tile serves as a K-major B (reduced over its columns: S = Q K^T) and,
// transposed, as an MN-major B (reduced over its rows: dQ += dS K), and as a
// K-major A. A comes from registers where they hold it (hd 64: the warp's
// K/V or Q/dO fragments, loaded once; P and dS as computed) and from shared
// memory where they do not (hd 128: K/V and Q/dO). The accumulators have
// mma.sync's C fragment layout, 16 rows a warp.

constexpr int kKeys = 64;         // keys a dK/dV block

// 4 bytes global -> shared, asynchronously; zero-fills when !ok (src must
// still be a valid address)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// a warp's 16 rows of a tile as HD/16 A fragments (ldmatrix through the swizzle)
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[HD / 16][4], const unsigned char* tile,
                                       int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm_x4(a[kk], reinterpret_cast<const bf16*>(
                       tile + tile_off(warp * 16 + (lane & 15), 2 * kk + (lane >> 4))));
}

// D = rowsum(dO * O) on the tensor-core route: HD/8 threads a row, 16-byte loads
template <int HD>
__global__ void __launch_bounds__(kThreads)
delta_tc_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                float* __restrict__ delta, int Sq, int H, long long rows) {
  constexpr int TPR = HD / 8;
  const long long row = (long long)blockIdx.x * (kThreads / TPR) + threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  float acc = 0.f;
  if (row < rows) {  // the whole group; every lane stays for the shuffles
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * HD + lane * 8);
    const uint4 g = *reinterpret_cast<const uint4*>(dO + row * HD + lane * 8);
    const bf16* pa = reinterpret_cast<const bf16*>(&a);
    const bf16* pg = reinterpret_cast<const bf16*>(&g);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += to_f(pa[i]) * to_f(pg[i]);
  }
  acc = group_sum<TPR>(acc);
  if (row < rows && lane == 0) {  // row = (b * Sq + qi) * H + h -> delta (B,H,Sq)
    const long long b = row / ((long long)Sq * H), rem = row % ((long long)Sq * H);
    delta[(b * H + rem % H) * Sq + rem / H] = acc;
  }
}

template <int HD>
struct WgTiling {
  static constexpr int kNA = HD / 64;             // 64-column sub-tiles a row
  static constexpr int kBM = 64;                  // pass 1: folded rows a ring stage
  static constexpr int kBH = 32;                  // pass 1: folded rows a product
  static constexpr int kBQ = 64;                  // pass 2: folded rows a block
  static constexpr int kBK = 64;                  // pass 2: keys a ring stage and a product
  static constexpr int kTile = kNA * kSubTile;    // bytes of a 64-row tile
  static constexpr bool kRegA = HD == 64;         // A operands in registers (else shared)
  // warpgroups a block: 1, and 2 at hd 256 (HD / 256 is 1 there, else 0),
  // each owning half of the columns of dK and dV (pass 1) or dQ (pass 2)
  static constexpr int kNW = 1 + HD / 256;
  static constexpr int kThreads = 128 * kNW;
  static constexpr int kBlocks = 3 - HD / 128;    // blocks an SM: 3, 2, 1 at hd 64, 128, 256
  // the exchange between the two warpgroups at hd 256, each warpgroup's
  // half: of S and dP in float32, then of the bf16 P and dS it formed
  // (pass 1: 64 keys x kBH rows; pass 2: kBQ rows x kBK keys, dS only)
  static constexpr int kXch1 = (kNW - 1) * 2 * (64 * kBH / 2) * (4 + 2 * 2);
  static constexpr int kXch2 = (kNW - 1) * 2 * (kBQ * kBK / 2) * (4 + 2);
  // pass 1: Q and dO rings (2 tiles each), K, V, lse and D, the exchange;
  // pass 2: K and V rings, Q and dO, the exchange; 1024 bytes for the
  // alignment
  static constexpr int kSmem1 = 1024 + 6 * kTile + 4 * kBM * 4 + kXch1;
  static constexpr int kSmem2 = 1024 + 6 * kTile + kXch2;
};

// pass 1: dK, dV of kKeys keys of one (b, kv head) over one segment of
// their row walk. items[blockIdx.x / (K * B)] = {key tile, first folded row,
// end row, slot}; slot -1: the tile's only segment, which writes dk and dv;
// else the segment writes its float32 partial sums to part[slot][b * K +
// kvh] ([dK | dV], kKeys x HD each, unscaled) for dkdv_merge_kernel. With
// two warpgroups (hd 256) warpgroup w owns columns [w HD / 2, (w + 1) HD / 2)
// of dK and dV; warpgroup 0 computes S^T, warpgroup 1 dP^T, each over the
// whole head dim, and each reads the other's from shared memory.
template <int HD>
__global__ void __launch_bounds__(WgTiling<HD>::kThreads, WgTiling<HD>::kBlocks)
dkdv_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dO,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part,
               const int4* __restrict__ items, int Sq, int Sk, int H, int K, int B,
               int causal, int window, float cap, float scale, unsigned long long gm) {
  using W = WgTiling<HD>;
  constexpr int BN = kKeys, BM = W::kBM, BH = W::kBH, NA = W::kNA, TILE = W::kTile;
  constexpr int NW = W::kNW, NT = W::kThreads, NH = BH / 8, CH = HD / 8, NKK = HD / 16;
  constexpr int NAW = NA / NW;  // 64-column sub-tiles of dK and dV a warpgroup owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qsw = align1024(smem_raw);  // [2] Q tiles [BM][HD]
  unsigned char* dosw = qsw + 2 * TILE;      // [2] dO tiles [BM][HD]
  unsigned char* ksw = dosw + 2 * TILE;      // K tile [BN][HD]
  unsigned char* vsw = ksw + TILE;           // V tile [BN][HD]
  float* ls = reinterpret_cast<float*>(vsw + TILE);  // [2][BM]
  float* dl = ls + 2 * BM;                           // [2][BM]
  float* xch = dl + 2 * BM;  // NW 2: the warpgroups' exchange (kXch1 bytes)

  const int G = H / K, kb = blockIdx.x % (K * B);
  const int kvh = kb % K, b = kb / K;
  const int4 it = items[blockIdx.x / (K * B)];
  const int k0 = it.x * BN, r_lo = it.y, r_hi = it.z, slot = it.w;
  // the warpgroup (0 at one a block, where the compiler then knows it)
  const int tid = threadIdx.x, wg = NW == 1 ? 0 : tid / 128, wtid = tid % 128,
            warp = (NW == 1 ? tid : wtid) >> 5, lane = tid & 31;
  const int k_last = min(Sk, k0 + BN) - 1;
  const float scale_log2 = scale * kLog2e, inv_cap = cap > 0.f ? 1.f / cap : 0.f;

  for (int c = tid; c < BN * CH; c += NT) {
    const int j = c / CH, ch = c % CH, key = k0 + j;
    const bool ok = key < Sk;
    const size_t off = ok ? (((size_t)b * Sk + key) * K + kvh) * HD + ch * 8 : 0;
    cp_async16(ksw + tile_off(j, ch), k + off, ok);
    cp_async16(vsw + tile_off(j, ch), v + off, ok);
  }
  auto load_rows = [&](int r, int buf) {
    for (int c = tid; c < BM * CH; c += NT) {
      const int j = c / CH, ch = c % CH, rr = r + j, qi = div_g(rr, gm);
      const bool ok = rr < r_hi;
      const size_t off =
          ok ? (((size_t)b * Sq + qi) * H + (size_t)kvh * G + rr - qi * G) * HD + ch * 8 : 0;
      cp_async16(qsw + buf * TILE + tile_off(j, ch), q + off, ok);
      cp_async16(dosw + buf * TILE + tile_off(j, ch), dO + off, ok);
    }
    for (int j = tid; j < BM; j += NT) {
      const int rr = r + j, qi = div_g(rr, gm);
      const bool ok = rr < r_hi;
      const size_t li = ok ? ((size_t)b * H + (size_t)kvh * G + rr - qi * G) * Sq + qi : 0;
      cp_async4(ls + buf * BM + j, lse + li, ok);
      cp_async4(dl + buf * BM + j, delta + li, ok);
    }
  };
  load_rows(r_lo, 0);
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();
  uint32_t kf[NKK][4], vf[NKK][4];  // hd 64: this warp's 16 keys of K and V, as A fragments
  if constexpr (W::kRegA) {
    load_a<HD>(kf, ksw, warp, lane);
    load_a<HD>(vf, vsw, warp, lane);
  }

  // this thread's keys: warp*16 + lane/4 (acc[.][.][0..1]) and + 8 (acc[.][.][2..3])
  const int key_a = k0 + warp * 16 + (lane >> 2);
  // this warpgroup's columns of dK and dV: (wg * NAW + a) * 64 + n*8 + 2*(lane%4) (+1)
  float dka[NAW][8][4], dva[NAW][8][4];
#pragma unroll
  for (int a = 0; a < NAW; ++a)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[a][n][e] = dva[a][n][e] = 0.f;

  int buf = 0;
  for (int r = r_lo; r < r_hi; r += BM, buf ^= 1) {
    if (r + BM < r_hi) {
      load_rows(r + BM, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
#pragma unroll
    for (int h = 0; h < BM / BH; ++h) {
      const int rh = r + h * BH;
      if (rh >= r_hi) break;  // block-uniform
      const unsigned char* qt = qsw + buf * TILE + h * BH * 128;  // the half's rows
      const unsigned char* dot = dosw + buf * TILE + h * BH * 128;
      const float* lt = ls + buf * BM + h * BH;
      const float* dt = dl + buf * BM + h * BH;

      const int q_lo = div_g(rh, gm), q_hi = div_g(rh + BH - 1, gm);
      const bool edge = (causal && q_lo < k_last) || (window > 0 && q_hi - k0 >= window) ||
                        k0 + BN > Sk || rh + BH > r_hi;
      // P^T and dS^T = P^T * (dP^T - D) (* the softcap factor) of the
      // n-blocks n0 .. n0 + N - 1 (rows n*8 ..) from their S^T and dP^T (sa,
      // dpa: N blocks), in bf16 as the A operands of dV += P^T dO and dK +=
      // dS^T Q (pout, dout: N / 2 k-steps); one copy of the loop for each of
      // (softcap, masked tile), chosen by block-uniform branches
      auto p_ds = [&](auto capped, auto masked, int n0, const auto& sa, const auto& dpa,
                      auto& pout, auto& dout) {
        constexpr int N = std::extent<std::remove_reference_t<decltype(sa)>>::value;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          float p[4], d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = (n0 + j) * 8 + ((lane & 3) << 1) + (e & 1);
            float x, f = 1.f;  // the score (capped) times log2(e); the softcap factor
            if constexpr (decltype(capped)::value) {
              const float t = tanhf(sa[j][e] * scale * inv_cap);
              x = cap * t * kLog2e;
              f = 1.f - t * t;
            } else {
              x = sa[j][e] * scale_log2;
            }
            p[e] = fast_exp2(x - lt[col] * kLog2e);
            if constexpr (decltype(masked)::value) {
              const int rr = rh + col, key = key_a + ((e >> 1) << 3);
              const bool ok =
                  (rr < r_hi) & (key < Sk) & visible(div_g(rr, gm), key, causal, window);
              p[e] = ok ? p[e] : 0.f;
            }
            d[e] = p[e] * f * (dpa[j][e] - dt[col]);
          }
          pout[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
          pout[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
          dout[j >> 1][(j & 1) * 2] = pack_bf16(d[0], d[1]);
          dout[j >> 1][(j & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
        }
      };
      using T_ = std::true_type;
      using F_ = std::false_type;
      auto p_ds_any = [&](int n0, const auto& sa, const auto& dpa, auto& pout, auto& dout) {
        if (cap > 0.f) {
          if (edge) p_ds(T_{}, T_{}, n0, sa, dpa, pout, dout);
          else p_ds(T_{}, F_{}, n0, sa, dpa, pout, dout);
        } else {
          if (edge) p_ds(F_{}, T_{}, n0, sa, dpa, pout, dout);
          else p_ds(F_{}, F_{}, n0, sa, dpa, pout, dout);
        }
      };

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x BH rows, then P^T and dS^T
      uint32_t pa[NH / 2][4], da[NH / 2][4];
      if constexpr (NW == 1) {
        float st[NH][4], dp[NH][4];
        fence_regs(st);
        fence_regs(dp);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < NKK; ++kk) {
          if constexpr (W::kRegA)
            wg_n32(st, kf[kk], wg_desc_k(qt, kk), kk);
          else
            wg_n32(st, wg_desc_k(ksw, kk), wg_desc_k(qt, kk), kk);
        }
#pragma unroll
        for (int kk = 0; kk < NKK; ++kk) {
          if constexpr (W::kRegA)
            wg_n32(dp, vf[kk], wg_desc_k(dot, kk), kk);
          else
            wg_n32(dp, wg_desc_k(vsw, kk), wg_desc_k(dot, kk), kk);
        }
        wg_commit();
        wg_wait0();
        fence_regs(st);
        fence_regs(dp);
        p_ds_any(0, st, dp, pa, da);
      } else {
        // warpgroup 0 S^T, warpgroup 1 dP^T; warpgroup w then forms P^T and
        // dS^T of n-blocks 2w and 2w + 1 (k-step w of the A operands), so
        // each needs the other's product on those blocks only. Both
        // exchanges go through shared memory in the accumulators' layout
        // (the same (key, row) at the same thread of either warpgroup), each
        // behind a barrier; the next write of a buffer comes after the other
        // warpgroup's read of it (a barrier lies between)
        static_assert(NH == 4, "two n-blocks a warpgroup");
        float mine[NH][4];
        const unsigned char* a_t = wg == 0 ? ksw : vsw;
        const unsigned char* b_t = wg == 0 ? qt : dot;
        fence_regs(mine);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < NKK; ++kk) wg_n32(mine, wg_desc_k(a_t, kk), wg_desc_k(b_t, kk), kk);
        wg_commit();
        wg_wait0();
        fence_regs(mine);
        float* x1 = xch;                                           // [2 wg][8][128]
        uint32_t* x2 = reinterpret_cast<uint32_t*>(xch + 2 * 8 * 128);  // [2 wg][8][128]
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)  // the other's n-blocks: 2, 3 (to wg 1) or 0, 1
            x1[wg * 1024 + (j * 4 + e) * 128 + wtid] = wg == 0 ? mine[2 + j][e] : mine[j][e];
        __syncthreads();
        float sl[2][4], dpl[2][4];  // this warpgroup's n-blocks 2 wg, 2 wg + 1
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float other = x1[(1 - wg) * 1024 + (j * 4 + e) * 128 + wtid];
            sl[j][e] = wg == 0 ? mine[j][e] : other;
            dpl[j][e] = wg == 0 ? other : mine[2 + j][e];
          }
        uint32_t op[1][4], od[1][4];  // k-step wg of the A operands
        p_ds_any(2 * wg, sl, dpl, op, od);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x2[wg * 1024 + i * 128 + wtid] = op[0][i];
          x2[wg * 1024 + (4 + i) * 128 + wtid] = od[0][i];
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t xp = x2[(1 - wg) * 1024 + i * 128 + wtid];
          const uint32_t xd = x2[(1 - wg) * 1024 + (4 + i) * 128 + wtid];
          pa[0][i] = wg == 0 ? op[0][i] : xp;
          pa[1][i] = wg == 0 ? xp : op[0][i];
          da[0][i] = wg == 0 ? od[0][i] : xd;
          da[1][i] = wg == 0 ? xd : od[0][i];
        }
      }

      // dV += P^T dO and dK += dS^T Q over the BH rows, 16 a step, on this
      // warpgroup's columns
#pragma unroll
      for (int a = 0; a < NAW; ++a) {
        fence_regs(dva[a]);
        fence_regs(dka[a]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < NH / 2; ++kk)
#pragma unroll
        for (int a = 0; a < NAW; ++a) {
          const int sub = (wg * NAW + a) * kSubTile + kk * 16 * 128;
          wg_n64<1>(dva[a], pa[kk], wg_desc(dot + sub), 1);
          wg_n64<1>(dka[a], da[kk], wg_desc(qt + sub), 1);
        }
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int a = 0; a < NAW; ++a) {
        fence_regs(dva[a]);
        fence_regs(dka[a]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  if (slot < 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key_a + 8 * i;
      if (key >= Sk) continue;
      const size_t off = (((size_t)b * Sk + key) * K + kvh) * HD + ((lane & 3) << 1);
#pragma unroll
      for (int a = 0; a < NAW; ++a)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = (wg * NAW + a) * 64 + n * 8;
          *reinterpret_cast<uint32_t*>(dk + off + col) =
              pack_bf16(dka[a][n][2 * i] * scale, dka[a][n][2 * i + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + off + col) =
              pack_bf16(dva[a][n][2 * i], dva[a][n][2 * i + 1]);
        }
    }
    return;
  }
  float* pk = part + ((size_t)slot * K * B + kb) * (2 * BN * HD);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int off = (warp * 16 + (lane >> 2) + 8 * i) * HD + ((lane & 3) << 1);
#pragma unroll
    for (int a = 0; a < NAW; ++a)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = (wg * NAW + a) * 64 + n * 8;
        *reinterpret_cast<float2*>(pk + off + col) =
            make_float2(dka[a][n][2 * i], dka[a][n][2 * i + 1]);
        *reinterpret_cast<float2*>(pk + BN * HD + off + col) =
            make_float2(dva[a][n][2 * i], dva[a][n][2 * i + 1]);
      }
  }
}

// pass 1, the merge of a key tile cut into several segments: tiles[blockIdx.x
// / (K * B)] = {key tile, first slot, segments, 0}. Adds the segments' float32
// partials in slot (= row) order, scales dK, rounds once to bf16.
template <int HD>
__global__ void __launch_bounds__(256)
dkdv_merge_kernel(const float* __restrict__ part, const int4* __restrict__ tiles,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int Sk, int K, int B,
                  float scale) {
  constexpr int BN = kKeys, TILE = BN * HD;
  const int kb = blockIdx.x % (K * B), kvh = kb % K, b = kb / K;
  const int4 m = tiles[blockIdx.x / (K * B)];
  if (m.z < 2) return;  // an uncut tile: its block wrote dk and dv
  const size_t stride = (size_t)K * B * 2 * TILE;  // one slot
  const float* base = part + ((size_t)m.y * K * B + kb) * 2 * TILE;
  for (int i = threadIdx.x * 4; i < 2 * TILE; i += 256 * 4) {
    float4 acc = *reinterpret_cast<const float4*>(base + i);
    for (int s = 1; s < m.z; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(base + s * stride + i);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const int e = i % TILE, key = m.x * BN + e / HD;
    if (key >= Sk) continue;
    const float sc = i < TILE ? scale : 1.f;
    bf16* out = (i < TILE ? dk : dv) + (((size_t)b * Sk + key) * K + kvh) * HD + e % HD;
    *reinterpret_cast<uint2*>(out) =
        make_uint2(pack_bf16(acc.x * sc, acc.y * sc), pack_bf16(acc.z * sc, acc.w * sc));
  }
}

// pass 2: dQ for kBQ folded query rows of one (b, kv head). With two
// warpgroups (hd 256) warpgroup w owns columns [w HD / 2, (w + 1) HD / 2) of
// dQ; warpgroup 0 computes S, warpgroup 1 dP, and each reads the other's
// from shared memory.
template <int HD>
__global__ void __launch_bounds__(WgTiling<HD>::kThreads, WgTiling<HD>::kBlocks)
dq_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int Sq, int Sk, int H, int K, int causal, int window,
             float cap, float scale) {
  using W = WgTiling<HD>;
  constexpr int BQ = W::kBQ, BK = W::kBK, NA = W::kNA, TILE = W::kTile;
  constexpr int NW = W::kNW, NT = W::kThreads, NN = BK / 8, CH = HD / 8, NKK = HD / 16;
  constexpr int NAW = NA / NW;  // 64-column sub-tiles of dQ a warpgroup owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ksw = align1024(smem_raw);  // [2] K tiles [BK][HD]
  unsigned char* vsw = ksw + 2 * TILE;       // [2] V tiles [BK][HD]
  unsigned char* qsw = vsw + 2 * TILE;       // Q tile [BQ][HD]
  unsigned char* dosw = qsw + TILE;          // dO tile [BQ][HD]
  float* xch = reinterpret_cast<float*>(dosw + TILE);  // NW 2: the exchange (kXch2 bytes)

  const int G = H / K;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal rows first
  // the warpgroup (0 at one a block, where the compiler then knows it)
  const int tid = threadIdx.x, wg = NW == 1 ? 0 : tid / 128, wtid = tid % 128,
            warp = (NW == 1 ? tid : wtid) >> 5, lane = tid & 31;
  const int q_first = r0 / G;
  const int q_last = min(Sq - 1, (r0 + BQ - 1) / G);
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) / BK * BK : 0;

  for (int c = tid; c < BQ * CH; c += NT) {
    const int rr = c / CH, ch = c % CH;
    const int r = r0 + rr, qi = r / G;
    const bool ok = qi < Sq;
    const size_t off =
        ok ? (((size_t)b * Sq + qi) * H + (size_t)kvh * G + r % G) * HD + ch * 8 : 0;
    cp_async16(qsw + tile_off(rr, ch), q + off, ok);
    cp_async16(dosw + tile_off(rr, ch), dO + off, ok);
  }
  auto load_kv = [&](int kb, int buf) {
    for (int c = tid; c < BK * CH; c += NT) {
      const int j = c / CH, ch = c % CH, key = kb + j;
      const bool ok = key < Sk;
      const size_t off = ok ? (((size_t)b * Sk + key) * K + kvh) * HD + ch * 8 : 0;
      cp_async16(ksw + buf * TILE + tile_off(j, ch), k + off, ok);
      cp_async16(vsw + buf * TILE + tile_off(j, ch), v + off, ok);
    }
  };
  load_kv(k_begin, 0);
  cp_async_commit();

  // this thread's rows: warp*16 + lane/4 (acc[.][.][0..1]) and + 8 (acc[.][.][2..3])
  const int ra = r0 + warp * 16 + (lane >> 2);
  const float scale_log2 = scale * kLog2e, inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  float lr2[2], dr[2];  // the rows' log-sum-exp times log2(e), and D
  int qr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 8 * i;
    qr[i] = r / G;
    const bool ok = qr[i] < Sq;
    const size_t li = ((size_t)b * H + (size_t)kvh * G + r % G) * Sq + (ok ? qr[i] : 0);
    lr2[i] = ok ? lse[li] * kLog2e : 0.f;
    dr[i] = ok ? delta[li] : 0.f;
  }
  // this warpgroup's columns of dQ: (wg * NAW + a) * 64 + n*8 + 2*(lane%4) (+1)
  float dqa[NAW][8][4];
#pragma unroll
  for (int a = 0; a < NAW; ++a)
#pragma unroll
    for (int n = 0; n < 8; ++n) dqa[a][n][0] = dqa[a][n][1] = dqa[a][n][2] = dqa[a][n][3] = 0.f;
  uint32_t qf[NKK][4], df[NKK][4];  // hd 64: this warp's 16 rows of Q and dO, as A fragments

  int buf = 0;
  for (int kb = k_begin; kb < k_end; kb += BK, buf ^= 1) {
    if (kb + BK < k_end) {
      load_kv(kb + BK, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    if constexpr (W::kRegA) {
      if (kb == k_begin) {
        load_a<HD>(qf, qsw, warp, lane);
        load_a<HD>(df, dosw, warp, lane);
      }
    }
    const unsigned char* kt = ksw + buf * TILE;
    const unsigned char* vt = vsw + buf * TILE;

    const bool edge = (causal && kb + BK - 1 > q_first) ||
                      (window > 0 && q_last - kb >= window) || kb + BK > Sk;
    // dS = P * (dP - D) (* the softcap factor) of the n-blocks n0 .. n0 +
    // N - 1 (keys n*8 ..) from their S and dP (sa, dpa: N blocks), in bf16:
    // the A fragments of N / 2 k-steps of dQ += dS K (aout); one copy of
    // the loop for each of (softcap, masked tile), chosen by block-uniform
    // branches
    auto ds_k = [&](auto capped, auto masked, int n0, const auto& sa, const auto& dpa,
                    auto& aout) {
      constexpr int N = std::extent<std::remove_reference_t<decltype(sa)>>::value;
#pragma unroll
      for (int kk = 0; kk < N / 2; ++kk) {
        float ds[2][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = 2 * kk + hh, i = e >> 1;
            float x, f = 1.f;  // the score (capped) times log2(e); the softcap factor
            if constexpr (decltype(capped)::value) {
              const float t = tanhf(sa[n][e] * scale * inv_cap);
              x = cap * t * kLog2e;
              f = 1.f - t * t;
            } else {
              x = sa[n][e] * scale_log2;
            }
            float p = fast_exp2(x - lr2[i]);
            if constexpr (decltype(masked)::value) {
              const int key = kb + (n0 + n) * 8 + ((lane & 3) << 1) + (e & 1);
              p = (key < Sk) & visible(qr[i], key, causal, window) ? p : 0.f;
            }
            ds[hh][e] = p * f * (dpa[n][e] - dr[i]);
          }
        aout[kk][0] = pack_bf16(ds[0][0], ds[0][1]);
        aout[kk][1] = pack_bf16(ds[0][2], ds[0][3]);
        aout[kk][2] = pack_bf16(ds[1][0], ds[1][1]);
        aout[kk][3] = pack_bf16(ds[1][2], ds[1][3]);
      }
    };
    using T_ = std::true_type;
    using F_ = std::false_type;
    auto ds_any = [&](int n0, const auto& sa, const auto& dpa, auto& aout) {
      if (cap > 0.f) {
        if (edge) ds_k(T_{}, T_{}, n0, sa, dpa, aout); else ds_k(T_{}, F_{}, n0, sa, dpa, aout);
      } else {
        if (edge) ds_k(F_{}, T_{}, n0, sa, dpa, aout); else ds_k(F_{}, F_{}, n0, sa, dpa, aout);
      }
    };

    // S = Q K^T and dP = dO V^T: 64 rows x BK keys, then dS
    uint32_t da[BK / 16][4];
    if constexpr (NW == 1) {
      float s[NN][4], dp[NN][4];
      fence_regs(s);
      fence_regs(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < NKK; ++kk) {
        if constexpr (W::kRegA)
          wg_n64<0>(s, qf[kk], wg_desc_k(kt, kk), kk);
        else
          wg_n64(s, wg_desc_k(qsw, kk), wg_desc_k(kt, kk), kk);
      }
#pragma unroll
      for (int kk = 0; kk < NKK; ++kk) {
        if constexpr (W::kRegA)
          wg_n64<0>(dp, df[kk], wg_desc_k(vt, kk), kk);
        else
          wg_n64(dp, wg_desc_k(dosw, kk), wg_desc_k(vt, kk), kk);
      }
      wg_commit();
      wg_wait0();
      fence_regs(s);
      fence_regs(dp);
      ds_any(0, s, dp, da);
    } else {
      // warpgroup 0 S, warpgroup 1 dP; warpgroup w then forms dS of
      // n-blocks 4w .. 4w + 3 (k-steps 2w and 2w + 1 of the A operand), so
      // each needs the other's product on those blocks only; both exchanges
      // as in the dK/dV pass, the tile's last barrier before the next write
      static_assert(NN == 8, "four n-blocks a warpgroup");
      float mine[NN][4];
      const unsigned char* a_t = wg == 0 ? qsw : dosw;
      const unsigned char* b_t = wg == 0 ? kt : vt;
      fence_regs(mine);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < NKK; ++kk) wg_n64(mine, wg_desc_k(a_t, kk), wg_desc_k(b_t, kk), kk);
      wg_commit();
      wg_wait0();
      fence_regs(mine);
      float* x1 = xch;                                            // [2 wg][16][128]
      uint32_t* x2 = reinterpret_cast<uint32_t*>(xch + 2 * 16 * 128);  // [2 wg][8][128]
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)  // the other's n-blocks: 4..7 (to wg 1) or 0..3
          x1[wg * 2048 + (j * 4 + e) * 128 + wtid] = wg == 0 ? mine[4 + j][e] : mine[j][e];
      __syncthreads();
      float sl[4][4], dpl[4][4];  // this warpgroup's n-blocks 4 wg .. 4 wg + 3
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float other = x1[(1 - wg) * 2048 + (j * 4 + e) * 128 + wtid];
          sl[j][e] = wg == 0 ? mine[j][e] : other;
          dpl[j][e] = wg == 0 ? other : mine[4 + j][e];
        }
      uint32_t own[2][4];  // k-steps 2 wg, 2 wg + 1 of the A operand
      ds_any(4 * wg, sl, dpl, own);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) x2[wg * 1024 + (j * 4 + i) * 128 + wtid] = own[j][i];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t other = x2[(1 - wg) * 1024 + (j * 4 + i) * 128 + wtid];
          da[j][i] = wg == 0 ? own[j][i] : other;
          da[2 + j][i] = wg == 0 ? other : own[j][i];
        }
    }
    // dQ += dS K over the BK keys, 16 a step, on this warpgroup's columns
#pragma unroll
    for (int a = 0; a < NAW; ++a) fence_regs(dqa[a]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int a = 0; a < NAW; ++a)
        wg_n64<1>(dqa[a], da[kk],
                  wg_desc(kt + (wg * NAW + a) * kSubTile + kk * 16 * 128), 1);
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int a = 0; a < NAW; ++a) fence_regs(dqa[a]);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 8 * i;
    if (qr[i] >= Sq) continue;
    bf16* row = dq + (((size_t)b * Sq + qr[i]) * H + (size_t)kvh * G + r % G) * HD +
                ((lane & 3) << 1);
#pragma unroll
    for (int a = 0; a < NAW; ++a)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<uint32_t*>(row + (wg * NAW + a) * 64 + n * 8) =
            pack_bf16(dqa[a][n][2 * i] * scale, dqa[a][n][2 * i + 1] * scale);
  }
}

struct Args {
  const void *q, *k, *v, *o, *dO;
  const float* lse;
  void *dq, *dk, *dv;
  float* delta;
  float* part;
  const int4* sched;
  int n_items, n_tiles;
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

template <typename F>
cudaError_t smem_attr(F* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
cudaError_t launch_tc(const Args& a) {
  using W = WgTiling<HD>;
  static const cudaError_t attr1 = smem_attr(dkdv_wg_kernel<HD>, W::kSmem1);
  static const cudaError_t attr2 = smem_attr(dq_wg_kernel<HD>, W::kSmem2);
  if (attr1 != cudaSuccess) return attr1;
  if (attr2 != cudaSuccess) return attr2;
  const int G = a.H / a.K;
  const long long kb = (long long)a.K * a.B;
  const long long n1 = a.n_items * kb, nm = a.n_tiles * kb;
  const long long nq = ((long long)G * a.Sq + W::kBQ - 1) / W::kBQ;
  const long long rows = (long long)a.B * a.Sq * a.H;
  const long long nd = (rows + kThreads / (HD / 8) - 1) / (kThreads / (HD / 8));
  // the folded rows r < G * Sq are divided by G as a multiply-high
  if (a.n_items <= 0 || a.n_tiles <= 0 || a.sched == nullptr || n1 > 0x7fffffffLL ||
      nm > 0x7fffffffLL || nq > 0x7fffffffLL || nd > 0x7fffffffLL || a.K > 65535 ||
      a.B > 65535 || (long long)G * G * a.Sq >= (1LL << 32))
    return cudaErrorInvalidValue;
  const unsigned long long gm = ((1ULL << 32) + G - 1) / G;
  const bf16 *q = static_cast<const bf16*>(a.q), *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v), *dO = static_cast<const bf16*>(a.dO);
  bf16 *dk = static_cast<bf16*>(a.dk), *dv = static_cast<bf16*>(a.dv);
  delta_tc_kernel<HD><<<(unsigned)nd, kThreads, 0, a.s>>>(static_cast<const bf16*>(a.o), dO,
                                                          a.delta, a.Sq, a.H, rows);
  dkdv_wg_kernel<HD><<<(unsigned)n1, W::kThreads, W::kSmem1, a.s>>>(
      q, k, v, dO, a.lse, a.delta, dk, dv, a.part, a.sched, a.Sq, a.Sk, a.H, a.K, a.B,
      a.causal, a.window, a.cap, a.scale, gm);
  dkdv_merge_kernel<HD><<<(unsigned)nm, 256, 0, a.s>>>(a.part, a.sched + a.n_items, dk, dv,
                                                       a.Sk, a.K, a.B, a.scale);
  dq_wg_kernel<HD><<<dim3((unsigned)nq, a.K, a.B), W::kThreads, W::kSmem2, a.s>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<bf16*>(a.dq), a.Sq, a.Sk, a.H, a.K, a.causal,
      a.window, a.cap, a.scale);
  return cudaSuccess;
}

// the CUDA-core route: float32 at every head dim, bfloat16 at hd 8, 16, 32
template <typename T>
cudaError_t dispatch(int hd, const Args& a) {
  switch (hd) {
    case 8: return launch<T, 8>(a);
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
  }
  if constexpr (std::is_same<T, float>::value) {
    switch (hd) {
      case 64: return launch<T, 64>(a);
      case 128: return launch<T, 128>(a);
      case 256: return launch<T, 256>(a);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/o/dO/dq (B,Sq,H,hd), k/v/dk/dv
// (B,Sk,K,hd), lse and delta (scratch for D) (B,H,Sq) float32, all
// contiguous. The tensor-core route (bfloat16, hd 64, 128 and 256) also takes the
// dK/dV pass's schedule, n_items segment rows then n_tiles key-tile rows of 4
// int32 each (kernels/flash_attention_bwd.py::dkdv_schedule), and the float32
// workspace of its partials (slots x B x K x 2 x 64 x hd); the CUDA-core
// routes take null and 0 there. Launches the D pre-pass, the dK/dV pass (and on the
// tensor-core route the merge of its cut key tiles) and the dQ pass on
// ``stream``. Returns a cudaError_t: the launches', else cudaGetLastError().
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                   const void* o, const void* dO, const void* lse, void* dq,
                                   void* dk, void* dv, void* delta, void* work,
                                   const void* sched, int n_items, int n_tiles,
                                   int B, int Sq, int Sk, int H, int K, int hd, int causal,
                                   int window, float softcap, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || K <= 0 || H % K != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dO, static_cast<const float*>(lse), dq, dk, dv,
               static_cast<float*>(delta), static_cast<float*>(work),
               static_cast<const int4*>(sched), n_items, n_tiles,
               B, Sq, Sk, H, K, causal, window, softcap, scale,
               static_cast<cudaStream_t>(stream)};
  // the tensor-core variant copies 16-byte chunks
  const bool tc = dtype == 1 && (hd == 64 || hd == 128 || hd == 256);
  if (tc &&
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)dO |
        (uintptr_t)sched | (uintptr_t)work) & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(hd, a);
  else if (dtype == 1 && hd == 64)
    err = launch_tc<64>(a);
  else if (dtype == 1 && hd == 128)
    err = launch_tc<128>(a);
  else if (dtype == 1 && hd == 256)
    err = launch_tc<256>(a);
  else if (dtype == 1)
    err = dispatch<bf16>(hd, a);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
