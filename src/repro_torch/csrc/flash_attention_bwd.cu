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
// Tensor-core variant (bfloat16 at hd 64, 128 and 256; the bf16 training path): P and
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
// Split-TF32 tensor-core variant (float32 at every head dim: every float32
// gradient, train(dtype=float32) and the smoke's float32 training checks;
// and bfloat16 at hd 8, 16, 32, the reduced configs; dkdv_tf32_kernel,
// dq_tf32_kernel): every product is mma.sync.m16n8k8 tf32
// with each operand split into a tf32 hi and lo half, taken as lo*hi +
// hi*lo + hi*hi (tc_mma.cuh), P and dS split too, which keeps float32's
// 1e-4 where plain TF32 does not (a bf16 input has no lo half, so its
// products with one are skipped). What bounds it: operations, 3 x 2.5 x
// the forward's products at the tf32 rate (q (1,512,14,64) causal: 0.0071
// ms at 495 TFLOP/s, against 0.0025 ms of bytes); what holds it back is
// latency, each warp's products waiting on the elementwise work between
// them with 8 warps an SM. The CUDA-core kernels before it ran one block a
// key tile (32 blocks for 132 SMs at that shape; 4 at the reduced
// qwen2-0.5b's bf16 q (4,32,7,8)), each thread walking up to 3,584 rows one
// after another: 1.35 ms. This design:
//  - Pass 1 takes the bf16 route's schedule (dkdv_schedule: segments of
//    about equal length, the cut tiles' float32 partials added in slot
//    order by dkdv_merge_kernel<T>), its 64-row stages walked as two of
//    32 rows (four of 16 at hd 256), and shorter segments than bf16's (the
//    float32 blocks are slower a stage): 256 blocks at that shape. 4 warps
//    own 16 keys each.
//  - Operands that are a B of two products and are read by every warp (Q
//    and dO in pass 1, K and V in pass 2) are split once a stage, in place
//    in shared memory between two barriers (at hd 256 as they are read);
//    the A operands (a warp's own 16 keys or rows) are split as read, P and
//    dS from the accumulators
//    with the k index permuted as in the forward. K and V stay in shared
//    memory (their split fragments beside dK and dV, 128 registers a thread
//    at hd 128, would not fit).
//  - At hd 128 one block fits an SM (203 KB of shared memory), so a block
//    is two warp groups that take half of each stage's rows (pass 1) or
//    keys (pass 2) each, their dK, dV (dQ) added in a fixed order at the
//    end through the ring: 8 warps an SM, as at hd 64 with two blocks. At
//    hd 256 the two groups split the columns instead (see the variant's
//    section below).
//  - No atomics, every sum in an order fixed by the shape: two runs give
//    the same bits.
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

// a sum over groups of TPR neighbouring lanes
template <int TPR>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
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
// partials in slot (= row) order, scales dK, writes T (bf16: rounded once),
// for both tensor-core routes. A tile's 2 x kKeys x HD sums are shared by
// gridDim.y blocks (1 on the bf16 route; HD / 8 on the float32 route, whose
// short segments leave many partials to a few tiles), 1024 floats a block a
// pass.
template <typename T, int HD>
__global__ void __launch_bounds__(256)
dkdv_merge_kernel(const float* __restrict__ part, const int4* __restrict__ tiles,
                  T* __restrict__ dk, T* __restrict__ dv, int Sk, int K, int B,
                  float scale) {
  constexpr int BN = kKeys, TILE = BN * HD;
  const int kb = blockIdx.x % (K * B), kvh = kb % K, b = kb / K;
  const int4 m = tiles[blockIdx.x / (K * B)];
  if (m.z < 2) return;  // an uncut tile: its block wrote dk and dv
  const size_t stride = (size_t)K * B * 2 * TILE;  // one slot
  const float* base = part + ((size_t)m.y * K * B + kb) * 2 * TILE;
  for (int i = (blockIdx.y * 256 + threadIdx.x) * 4; i < 2 * TILE; i += 256 * 4 * gridDim.y) {
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
    T* out = (i < TILE ? dk : dv) + (((size_t)b * Sk + key) * K + kvh) * HD + e % HD;
    if constexpr (std::is_same<T, bf16>::value)
      *reinterpret_cast<uint2*>(out) =
          make_uint2(pack_bf16(acc.x * sc, acc.y * sc), pack_bf16(acc.z * sc, acc.w * sc));
    else
      *reinterpret_cast<float4*>(out) = make_float4(acc.x * sc, acc.y * sc, acc.z * sc, acc.w * sc);
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

// ---- split-TF32 tensor-core variant (float32 at every head dim; bf16 at hd 8,
// 16, 32) ---------------------------------------------------------------------
//
// A warp group is 4 warps; a block is kSplit x kCols groups. Pass 1
// (dkdv_tf32_kernel): kKeys keys of one (b, kv head), 16 a warp, over one
// segment of the dK/dV schedule, the segment's rows streamed in ring stages
// of kBR (each group takes kBR / kSplit of them). Pass 2 (dq_tf32_kernel):
// kBQ folded rows, 16 a warp, over key stages of kBK (each group takes kBK /
// kSplit). Every product is mma.sync.m16n8k8
// tf32 in split-TF32 (tc_mma.cuh: split_tf32; mma_split). Pass 1's products:
// S^T = K Q^T and dP^T = V dO^T (A: the warp's 16 keys of K or V; B: the
// stage's rows of Q or dO, k = dim), then dV += P^T dO and dK += dS^T Q (A:
// P^T or dS^T as it sits in the accumulator; B: dO or Q, k = row). Pass 2's:
// S = Q K^T, dP = dO V^T, dQ += dS K. An operand that is a B of two products
// (Q and dO in pass 1, K and V in pass 2) and is read by all four warps is
// split once a stage, in place in shared memory (hi over the copied floats,
// lo beside them, between two barriers); an operand read as A (K and V in
// pass 1, Q and dO in pass 2: a warp's own 16 rows, each fragment used for
// every n-block of a k-step) is split as it is read, and so is P (dS),
// from the accumulator. As in the forward, a C fragment holds (g, 2t),
// (g, 2t + 1) and an A fragment wants (g, t), (g, t + 4), so an
// accumulator-to-A k-step permutes its k index (column t is C's 2t, t + 4
// is 2t + 1) and its B's rows are read in that order. Shared rows of
// hd + 4 floats put every fragment's 32 loads in 32 distinct banks.
//
// hd 256 (gemma2-2b's float32 gradient: train(dtype=float32), softcap 50;
// dkdv_tf32_cols_kernel, dq_tf32_cols_kernel): a warp's dK and dV of 16
// keys x 256 columns are 256 float32 registers a thread, and the operands
// do not fit a block's shared memory as hi and lo halves (K and V of 64
// keys at ld 260 are 133,120 bytes; a split ring of Q and dO would add
// 133,120 at 16-row stages). So a block is two warp
// groups that split the *columns* (kCols): group c owns columns [128 c,
// 128 c + 128) of dK and dV (pass 1) or dQ (pass 2), 128 (64) accumulator
// registers a thread. Group 0 computes S^T (S), group 1 dP^T (dP), each
// over all 256 columns, and the two swap them through shared memory in the
// accumulators' layout (thread i of one group holds what thread i of the
// other needs), behind a barrier; both then form P and dS (the elementwise
// work twice, against every product once) and take their columns' dV, dK
// (dQ) products. The rings hold Q and dO (K and V) once, in float32, in
// 16-row (16-key) stages, and every warp splits its B fragments as it reads
// them (tc_mma.cuh's split_tf32: two integer operations and a subtraction a
// value): 208,128 and 207,872 bytes, one block (8 warps) an SM. The S
// (dP) chain of 3 x 32 dependent products is summed in 4 interleaved
// partial sums (chain_sum). The 64-key dK/dV tile stays, so
// dkdv_schedule, workspace_numel and dkdv_merge_kernel<float> are those of
// hd 8 to 128, and the float32 cuts stay independent of B x K.
//
// bf16 at hd 8, 16, 32 (the reduced configs' training): dkdv_tf32_kernel and
// dq_tf32_kernel with T = bf16. Every bf16 value is exact in tf32, so Q, K,
// V and dO have no lo halves: S^T = K Q^T and dP^T = V dO^T take one tf32
// product a k-step, not three, and dV += P^T dO, dK += dS^T Q (dQ += dS K)
// two (P and dS keep their split). The tiles are loaded 4 values at a time
// and widened to float32 into the float32 route's layout (copy4); the
// in-place split of a stage writes zero lo halves there, which no product
// reads. dQ, dK and dV are written in bf16, a cut tile's partials through
// dkdv_merge_kernel<bf16>, and the walks are cut into one-stage segments
// (kernels/flash_attention_bwd.py::min_segment). What the CUDA-core
// kernels before it lacked was parallelism, not arithmetic: at the reduced
// qwen2-0.5b's q (4,32,7,8), 4 blocks in all, each walking 224 rows one at
// a time. The float32 route at hd 8 to 128 keeps its kernels' code as it
// was: their ptxas register counts moved with any change to the body
// (even a discarded if constexpr), so hd 256 has kernels of its own
// (dkdv_tf32_cols_kernel, dq_tf32_cols_kernel).

// the operand halves a tile holds: hi and lo split in place (kSplitTile),
// float32 split as it is read (kRawTile), or values exact in tf32, whose lo
// halves are 0 and whose products with them are skipped (kExactTile)
enum BSrc { kSplitTile, kRawTile, kExactTile };

template <int HD>
struct Tf32BwdTiling {
  // warp groups that split the columns of dK and dV (pass 1) or dQ (pass
  // 2): two at hd 256, one computing S^T (S), the other dP^T (dP)
  static constexpr int kCols = HD == 256 ? 2 : 1;
  // warp groups that share a ring stage: at hd 128 (one block an SM) two,
  // each with half the stage's rows (pass 1) or keys (pass 2), their sums
  // added in a fixed order at the end: 8 warps an SM, not 4
  static constexpr int kSplit = HD == 128 ? 2 : 1;
  static constexpr int kThreads = 128 * kSplit * kCols;  // 4 warps a group: 16 keys or rows each
  static constexpr int kBR = HD == 256 ? 16 : 32;  // pass 1: folded rows a ring stage
  static constexpr int kBQ = 64;        // pass 2: folded rows a block
  static constexpr int kBK = HD == 256 ? 16 : 32;  // pass 2: keys a ring stage
  static constexpr int kLd = HD + 4;    // a shared row, floats: conflict-free fragments
  static constexpr int kBlocks = HD <= 64 ? 2 : 1;  // blocks an SM: shared memory at hd >= 128
  // the rings' B operands split once a stage in place (hi and lo), or at
  // two column groups stored once in float32 and split as read
  static constexpr bool kPreSplit = kCols == 1;
  static constexpr int kHalves = kPreSplit ? 2 : 1;
  // the column groups' exchange, floats: each group's 4 warps' 16 x kBR
  // (pass 1) or 16 x kBK (pass 2) product
  static constexpr int kXch1 = (kCols - 1) * 2 * 4 * 16 * kBR;
  static constexpr int kXch2 = (kCols - 1) * 2 * 4 * 16 * kBK;
  // pass 1: K and V of the block's keys; 2 ring stages of Q and dO; the
  // stages' lse and D; the exchange
  static constexpr int kSmem1 = (2 * kKeys * kLd + 2 * 2 * kHalves * kBR * kLd + 2 * 2 * kBR + kXch1) * 4;
  // pass 2: Q and dO of the block's rows; 2 ring stages of K and V; the exchange
  static constexpr int kSmem2 = (2 * kBQ * kLd + 2 * 2 * kHalves * kBK * kLd + kXch2) * 4;
  // the two facts the design answers: a thread's dK and dV (dQ) of 16 keys
  // (rows) at HD / kCols columns in at most 128 (64) registers, and each
  // pass in a block's 232,448 bytes of shared memory
  static_assert(2 * (HD / kCols) / 8 * 4 <= 128, "dK and dV: 128 accumulator registers");
  static_assert(kSmem1 <= 232448 && kSmem2 <= 232448, "a block's shared memory");
};

// a warp's A fragment of 16 rows, split as it is read (or, exact in tf32,
// taken as it is: h only): p = the row-major tile (stride LD) at row g,
// column 8 kk + t; a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
template <int LD, bool EXACT = false>
__device__ __forceinline__ void split_a(const float* p, uint32_t (&h)[4], uint32_t (&l)[4]) {
  if constexpr (EXACT) {
    h[0] = __float_as_uint(p[0]);
    h[1] = __float_as_uint(p[8 * LD]);
    h[2] = __float_as_uint(p[4]);
    h[3] = __float_as_uint(p[8 * LD + 4]);
    l[0] = l[1] = l[2] = l[3] = 0u;
  } else {
    split_tf32(p[0], h[0], l[0]);
    split_tf32(p[8 * LD], h[1], l[1]);
    split_tf32(p[4], h[2], l[2]);
    split_tf32(p[8 * LD + 4], h[3], l[3]);
  }
}

// a C fragment (16 x 8) as the A fragment of one k-step, k permuted
// (column t is C's column 2t, t + 4 is 2t + 1), split
__device__ __forceinline__ void split_c_as_a(const float (&c)[4], uint32_t (&h)[4],
                                             uint32_t (&l)[4]) {
  split_tf32(c[0], h[0], l[0]);  // (g, 2t)
  split_tf32(c[2], h[1], l[1]);  // (g + 8, 2t)
  split_tf32(c[1], h[2], l[2]);  // (g, 2t + 1)
  split_tf32(c[3], h[3], l[3]);  // (g + 8, 2t + 1)
}

// the hi and lo halves of two B values of a tile, at p and p + D: from a
// split tile (lo at + lo_off), split as read, or exact (lo unused)
template <BSrc S, int D>
__device__ __forceinline__ void b_pair(const float* p, int lo_off, uint32_t (&h)[2],
                                       uint32_t (&l)[2]) {
  if constexpr (S == kRawTile) {
    split_tf32(p[0], h[0], l[0]);
    split_tf32(p[D], h[1], l[1]);
  } else {
    h[0] = __float_as_uint(p[0]);
    h[1] = __float_as_uint(p[D]);
    if constexpr (S == kSplitTile) {
      l[0] = __float_as_uint(p[lo_off]);
      l[1] = __float_as_uint(p[lo_off + D]);
    }
  }
}

// d[j] += a b[j] in split-TF32, the terms whose halves are not 0: lo*hi
// where A has a lo half (AL), hi*lo where B has one (BL), then hi*hi, the
// small terms first (mma3's order), each a pass over the NT independent
// accumulators
template <bool AL, bool BL, int NT>
__device__ __forceinline__ void mma_split(float (&d)[NT][4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], const uint32_t (&bh)[NT][2],
                                          const uint32_t (&bl)[NT][2]) {
  if constexpr (AL) {
#pragma unroll
    for (int j = 0; j < NT; ++j) mma1688_tf32(d[j], al, bh[j]);
  }
  if constexpr (BL) {
#pragma unroll
    for (int j = 0; j < NT; ++j) mma1688_tf32(d[j], ah, bl[j]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) mma1688_tf32(d[j], ah, bh[j]);
}

// a ring stage's N tiles of R rows (each [R][LD], hi; its lo half at + R
// LD), split in place by the block's NT threads
template <int N, int R, int HD, int NT>
__device__ __forceinline__ void split_stage(float* st, int tid) {
  constexpr int LD = HD + 4, CH = HD / 4;
  for (int i = tid; i < N * R * CH; i += NT) {
    const int m = i / (R * CH), j = (i / CH) % R, c = (i % CH) * 4;
    float* p = st + (2 * m * R + j) * LD + c;
    const float4 x = *reinterpret_cast<const float4*>(p);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(p) = h;
    *reinterpret_cast<uint4*>(p + R * LD) = l;
  }
}

// acc[n0 + n] (n < NV) += A B for one k-step: A split (ah, al); B from a
// tile, b at this thread's (row 2t of the k-step, column g), its lo half at
// + lo_off on a split tile: b0 (row 2t, column 8 n + g), b1 (row 2t + 1,
// the same)
template <int KD, int NV, int LD, BSrc S = kSplitTile>
__device__ __forceinline__ void mma_rows(float (&acc)[KD][4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], const float* b, int lo_off) {
#pragma unroll
  for (int n0 = 0; n0 < KD; n0 += NV) {  // NV n-blocks at a time: fewer live registers
    uint32_t bh[NV][2], bl[NV][2];
#pragma unroll
    for (int n = 0; n < NV; ++n) b_pair<S, LD>(b + 8 * (n0 + n), lo_off, bh[n], bl[n]);
#pragma unroll
    for (int n = 0; n < NV; ++n) mma1688_tf32(acc[n0 + n], al, bh[n]);  // as mma_split
    if constexpr (S != kExactTile) {
#pragma unroll
      for (int n = 0; n < NV; ++n) mma1688_tf32(acc[n0 + n], ah, bl[n]);
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) mma1688_tf32(acc[n0 + n], ah, bh[n]);
  }
}

// the B fragments of NB n-blocks of 8 rows from a tile, k = column: b0 (row
// 8 j + g, column 8 kk + t), b1 (the same, column + 4); p at (row g, column
// 8 kk + t), a split tile's lo half at + lo_off
template <int NB, int LD, BSrc S = kSplitTile>
__device__ __forceinline__ void b_cols(uint32_t (&bh)[NB][2], uint32_t (&bl)[NB][2],
                                       const float* p, int lo_off) {
#pragma unroll
  for (int j = 0; j < NB; ++j) b_pair<S, 4>(p + 8 * j * LD, lo_off, bh[j], bl[j]);
}

// acc = A B^T over KD k-steps of 8 (a warp's 16 rows of A at a, row g,
// column t; NB n-blocks of B at b, row g, column t), every operand split as
// read: the hd-256 column groups' S^T, dP^T (S, dP). Its NB accumulators
// alone would make NB chains of 3 KD dependent products (96 at hd 256), each
// product waiting on the last; the k-steps are summed in kChains
// interleaved partial sums instead (k-step kk into sum kk % kChains), added
// in a fixed order at the end
constexpr int kChains = 4;
template <int KD, int NB, int LD, BSrc S>
__device__ __forceinline__ void chain_sum(float (&acc)[NB][4], const float* a, const float* b) {
  float part[kChains][NB][4];
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[c][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    uint32_t ah[4], al[4], bh[NB][2], bl[NB][2];
    split_a<LD>(a + 8 * kk, ah, al);
    b_cols<NB, LD, S>(bh, bl, b + 8 * kk, 0);
    mma_split<true, true>(part[kk % kChains], ah, al, bh, bl);
  }
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[j][e] = (part[0][j][e] + part[1][j][e]) + (part[2][j][e] + part[3][j][e]);
}

// 4 elements global -> 4 floats shared (16-byte aligned), zeros when !ok
// (src must still be a valid address): float32 by cp.async, bf16 loaded
// (8 bytes) and widened, which makes the caller wait for the load
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  cp_async16(dst, src, ok);
}
__device__ __forceinline__ void copy4(float* dst, const bf16* src, bool ok) {
  const uint2 x = ok ? __ldg(reinterpret_cast<const uint2*>(src)) : make_uint2(0u, 0u);
  const bf16* h = reinterpret_cast<const bf16*>(&x);
  *reinterpret_cast<float4*>(dst) = make_float4(to_f(h[0]), to_f(h[1]), to_f(h[2]), to_f(h[3]));
}

// two neighbouring outputs, in T
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// pass 1: dK, dV of kKeys keys of one (b, kv head) over one segment of their
// row walk, items[blockIdx.x / (K * B)] = {key tile, first folded row, end
// row, slot}, as dkdv_wg_kernel: slot -1 writes dk and dv, else the float32
// partials go to part[slot][b * K + kvh] for dkdv_merge_kernel<T>. T float
// (hd 8 to 128) or bf16 (hd 8, 16, 32); hd 256 is dkdv_tf32_cols_kernel.
template <typename T, int HD>
__global__ void __launch_bounds__(Tf32BwdTiling<HD>::kThreads, Tf32BwdTiling<HD>::kBlocks)
dkdv_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dO,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ part,
                 const int4* __restrict__ items, int Sq, int Sk, int H, int K, int B,
                 int causal, int window, float cap, float scale) {
  using C = Tf32BwdTiling<HD>;
  // bf16: exact in tf32, so no lo halves (split_stage writes zeros there,
  // which no product reads)
  constexpr bool EX = std::is_same<T, bf16>::value;
  constexpr BSrc BS = EX ? kExactTile : kSplitTile;
  constexpr int BN = kKeys, BR = C::kBR, LD = C::kLd, NT = C::kThreads;
  constexpr int RH = BR / C::kSplit;  // a warp's rows of a stage
  constexpr int KD = HD / 8;  // k-steps of S^T and dP^T; n-blocks of dK and dV
  constexpr int NR = RH / 8;  // n-blocks of S^T and dP^T; k-steps of dV and dK
  constexpr int CH = HD / 4;  // 16-byte copies a row
  constexpr int NV = KD < 4 ? KD : 4;
  constexpr int RS = 4 * BR * LD;  // a ring stage: Q hi, Q lo, dO hi, dO lo
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;           // K [BN][LD]
  float* vs = ks + BN * LD;  // V [BN][LD]
  float* rs = vs + BN * LD;  // [2] ring stages
  float* ls = rs + 2 * RS;   // [2][BR] lse
  float* dl = ls + 2 * BR;   // [2][BR] D

  const int G = H / K, kb = blockIdx.x % (K * B);
  const int kvh = kb % K, b = kb / K;
  const int4 it = items[blockIdx.x / (K * B)];
  const int k0 = it.x * BN, r_lo = it.y, r_hi = it.z, slot = it.w;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int warp = (tid >> 5) & 3, half = tid >> 7;  // the warp's keys; its rows of a stage
  const int wk = k0 + warp * 16;  // the warp's first key
  const int ro = half * RH;       // the warp's first row of a stage
  const float inv_cap = cap > 0.f ? 1.f / cap : 0.f;

  for (int c = tid; c < BN * CH; c += NT) {
    const int j = c / CH, cc = (c % CH) * 4, key = k0 + j;
    const bool ok = key < Sk;
    const size_t off = ok ? (((size_t)b * Sk + key) * K + kvh) * HD + cc : 0;
    copy4(ks + j * LD + cc, k + off, ok);
    copy4(vs + j * LD + cc, v + off, ok);
  }
  auto load_rows = [&](int r, int buf) {
    float* st = rs + buf * RS;
    for (int c = tid; c < BR * CH; c += NT) {
      const int j = c / CH, cc = (c % CH) * 4, rr = r + j, qi = rr / G;
      const bool ok = rr < r_hi;
      const size_t off =
          ok ? (((size_t)b * Sq + qi) * H + (size_t)kvh * G + rr - qi * G) * HD + cc : 0;
      copy4(st + j * LD + cc, q + off, ok);               // Q's hi half
      copy4(st + (2 * BR + j) * LD + cc, dO + off, ok);  // dO's hi half
    }
    for (int j = tid; j < BR; j += NT) {
      const int rr = r + j, qi = rr / G;
      const bool ok = rr < r_hi;
      const size_t li = ok ? ((size_t)b * H + (size_t)kvh * G + rr - qi * G) * Sq + qi : 0;
      cp_async4(ls + buf * BR + j, lse + li, ok);
      cp_async4(dl + buf * BR + j, delta + li, ok);
    }
    cp_async_commit();
  };
  load_rows(r_lo, 0);  // with K and V

  // this thread's keys: wk + g (acc[.][0..1]) and wk + g + 8 (acc[.][2..3])
  float dka[KD][4], dva[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  int buf = 0;
  for (int r = r_lo; r < r_hi; r += BR, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // this stage is in, and every warp is done with the other one
    if (r + BR < r_hi) load_rows(r + BR, buf ^ 1);  // in flight under this stage
    float* st = rs + buf * RS;
    split_stage<2, BR, HD, NT>(st, tid);
    __syncthreads();
    const float* lt = ls + buf * BR + ro;
    const float* dt = dl + buf * BR + ro;
    const int rh = r + ro;  // the warp's rows: rh .. rh + RH - 1
    const int q_lo = rh / G, q_hi = (min(rh + RH, r_hi) - 1) / G;
    const bool skip = rh >= r_hi || wk >= Sk || (causal && q_hi < wk) ||
                      (window > 0 && q_lo - (wk + 15) >= window);
    if (!skip) {
      const float* qt = st + ro * LD;                // Q hi; lo at + BR * LD
      const float* ot = st + (2 * BR + ro) * LD;     // dO hi; lo at + BR * LD
      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x RH rows
      float s[NR][4], dp[NR][4];
#pragma unroll
      for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ah[4], al[4], bh[NR][2], bl[NR][2];
        split_a<LD, EX>(ks + (warp * 16 + g) * LD + 8 * kk + t, ah, al);
        b_cols<NR, LD, BS>(bh, bl, qt + g * LD + 8 * kk + t, BR * LD);
        mma_split<!EX, !EX>(s, ah, al, bh, bl);
        split_a<LD, EX>(vs + (warp * 16 + g) * LD + 8 * kk + t, ah, al);
        b_cols<NR, LD, BS>(bh, bl, ot + g * LD + 8 * kk + t, BR * LD);
        mma_split<!EX, !EX>(dp, ah, al, bh, bl);
      }
      // P^T = exp(S^T scale (capped) - lse) and dS^T = P^T (dP^T - D) (times
      // the softcap's 1 - tanh^2); s[j][e]: key wk + g + 8 (e >> 1), row rh +
      // 8 j + 2 t + (e & 1). A tile inside every pair's range skips the mask.
      const bool edge = (causal && q_lo < wk + 15) || (window > 0 && q_hi - wk >= window) ||
                        wk + 16 > Sk || rh + RH > r_hi;
#pragma unroll
      for (int j = 0; j < NR; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          float x = s[j][e] * scale, f = 1.f;
          if (cap > 0.f) {
            const float th = tanhf(x * inv_cap);
            x = cap * th;
            f = 1.f - th * th;
          }
          float p = expf(x - lt[col]);
          if (edge) {
            const int rr = rh + col, key = wk + g + ((e >> 1) << 3);
            const bool ok = rr < r_hi && key < Sk && visible(rr / G, key, causal, window);
            p = ok ? p : 0.f;
          }
          s[j][e] = p;
          dp[j][e] = p * f * (dp[j][e] - dt[col]);
        }
      }
      // dV += P^T dO and dK += dS^T Q, a k-step of 8 rows at a time
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        uint32_t ah[4], al[4];
        const int row = (8 * j + 2 * t) * LD + g;
        split_c_as_a(s[j], ah, al);
        mma_rows<KD, NV, LD, BS>(dva, ah, al, ot + row, BR * LD);
        split_c_as_a(dp[j], ah, al);
        mma_rows<KD, NV, LD, BS>(dka, ah, al, qt + row, BR * LD);
      }
    }
  }
  cp_async_wait<0>();  // an empty walk issued its copies too
  if constexpr (C::kSplit == 2) {
    // the second half's warps leave their sums in the ring (free once every
    // warp is past its last stage), one float per thread and value; the
    // first half's add them, in that order
    float* xs = rs + (tid & 127);
    __syncthreads();
    if (half == 1) {
#pragma unroll
      for (int n = 0; n < KD; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xs[(8 * n + e) * 128] = dka[n][e];
          xs[(8 * n + 4 + e) * 128] = dva[n][e];
        }
    }
    __syncthreads();
    if (half == 1) return;
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dka[n][e] += xs[(8 * n + e) * 128];
        dva[n][e] += xs[(8 * n + 4 + e) * 128];
      }
  }

  if (slot < 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = wk + g + 8 * i;
      if (key >= Sk) continue;
      const size_t off = (((size_t)b * Sk + key) * K + kvh) * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        store2(dk + off + 8 * n, dka[n][2 * i] * scale, dka[n][2 * i + 1] * scale);
        store2(dv + off + 8 * n, dva[n][2 * i], dva[n][2 * i + 1]);
      }
    }
    return;
  }
  float* pk = part + ((size_t)slot * K * B + kb) * (2 * BN * HD);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int off = (warp * 16 + g + 8 * i) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      *reinterpret_cast<float2*>(pk + off + 8 * n) = make_float2(dka[n][2 * i], dka[n][2 * i + 1]);
      *reinterpret_cast<float2*>(pk + BN * HD + off + 8 * n) =
          make_float2(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

// pass 2: dQ for kBQ folded query rows of one (b, kv head), the longest
// causal rows first; T float (hd 8 to 128) or bf16 (hd 8, 16, 32), hd 256
// is dq_tf32_cols_kernel
template <typename T, int HD>
__global__ void __launch_bounds__(Tf32BwdTiling<HD>::kThreads, Tf32BwdTiling<HD>::kBlocks)
dq_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dO,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dq, int Sq, int Sk, int H, int K, int causal, int window,
               float cap, float scale) {
  using C = Tf32BwdTiling<HD>;
  // bf16: exact in tf32, so no lo halves (split_stage writes zeros there,
  // which no product reads)
  constexpr bool EX = std::is_same<T, bf16>::value;
  constexpr BSrc BS = EX ? kExactTile : kSplitTile;
  constexpr int BQ = C::kBQ, BK = C::kBK, LD = C::kLd, NT = C::kThreads;
  constexpr int KH = BK / C::kSplit;  // a warp's keys of a stage
  constexpr int KD = HD / 8;  // k-steps of S and dP; n-blocks of dQ
  constexpr int NN = KH / 8;  // n-blocks of S and dP; k-steps of dQ
  constexpr int CH = HD / 4;  // 16-byte copies a row
  constexpr int NV = KD < 4 ? KD : 4;
  constexpr int RS = 4 * BK * LD;  // a ring stage: K hi, K lo, V hi, V lo
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;            // Q [BQ][LD]
  float* dos = qs + BQ * LD;  // dO [BQ][LD]
  float* rs = dos + BQ * LD;  // [2] ring stages

  const int G = H / K, kvh = blockIdx.y, b = blockIdx.z;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal rows first
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int warp = (tid >> 5) & 3, half = tid >> 7;  // the warp's rows; its keys of a stage
  const int ko = half * KH;  // the warp's first key of a stage
  const int q_first = r0 / G;
  const int q_last = min(Sq - 1, (r0 + BQ - 1) / G);
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) / BK * BK : 0;
  const int wr = r0 + warp * 16;  // the warp's first folded row
  const int wq_first = wr / G, wq_last = min(Sq - 1, (wr + 15) / G);
  const float inv_cap = cap > 0.f ? 1.f / cap : 0.f;

  for (int c = tid; c < BQ * CH; c += NT) {
    const int rr = c / CH, cc = (c % CH) * 4, r = r0 + rr, qi = r / G;
    const bool ok = qi < Sq;
    const size_t off = ok ? (((size_t)b * Sq + qi) * H + (size_t)kvh * G + r - qi * G) * HD + cc : 0;
    copy4(qs + rr * LD + cc, q + off, ok);
    copy4(dos + rr * LD + cc, dO + off, ok);
  }
  auto load_kv = [&](int kb, int buf) {
    float* st = rs + buf * RS;
    for (int c = tid; c < BK * CH; c += NT) {
      const int j = c / CH, cc = (c % CH) * 4, key = kb + j;
      const bool ok = key < Sk;
      const size_t off = ok ? (((size_t)b * Sk + key) * K + kvh) * HD + cc : 0;
      copy4(st + j * LD + cc, k + off, ok);               // K's hi half
      copy4(st + (2 * BK + j) * LD + cc, v + off, ok);  // V's hi half
    }
    cp_async_commit();
  };
  load_kv(k_begin, 0);  // with Q and dO

  // this thread's rows: wr + g (acc[.][0..1]) and wr + g + 8 (acc[.][2..3])
  int qr[2];
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr + g + 8 * i, qi = r / G;
    const size_t li = ((size_t)b * H + (size_t)kvh * G + r - qi * G) * Sq + qi;
    qr[i] = qi;
    lr[i] = qi < Sq ? lse[li] : 0.f;
    dr[i] = qi < Sq ? delta[li] : 0.f;
  }
  float dqa[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  int buf = 0;
  for (int kb = k_begin; kb < k_end; kb += BK, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // this stage is in, and every warp is done with the other one
    if (kb + BK < k_end) load_kv(kb + BK, buf ^ 1);  // in flight under this stage
    float* st = rs + buf * RS;
    split_stage<2, BK, HD, NT>(st, tid);
    __syncthreads();
    const int kw = kb + ko;  // the warp's keys: kw .. kw + KH - 1
    const bool skip = wq_first >= Sq || kw >= k_end || (causal && kw > wq_last) ||
                      (window > 0 && wq_first - (kw + KH - 1) >= window);
    if (!skip) {
      const float* kt = st + ko * LD;             // K hi; lo at + BK * LD
      const float* vt = st + (2 * BK + ko) * LD;  // V hi; lo at + BK * LD
      // S = Q K^T and dP = dO V^T: the warp's 16 rows x KH keys
      float s[NN][4], dp[NN][4];
#pragma unroll
      for (int j = 0; j < NN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ah[4], al[4], bh[NN][2], bl[NN][2];
        split_a<LD, EX>(qs + (warp * 16 + g) * LD + 8 * kk + t, ah, al);
        b_cols<NN, LD, BS>(bh, bl, kt + g * LD + 8 * kk + t, BK * LD);
        mma_split<!EX, !EX>(s, ah, al, bh, bl);
        split_a<LD, EX>(dos + (warp * 16 + g) * LD + 8 * kk + t, ah, al);
        b_cols<NN, LD, BS>(bh, bl, vt + g * LD + 8 * kk + t, BK * LD);
        mma_split<!EX, !EX>(dp, ah, al, bh, bl);
      }
      // dS = P (dP - D) (times the softcap's factor); s[j][e]: row qr[e >>
      // 1], key kw + 8 j + 2 t + (e & 1)
      const bool edge = (causal && kw + KH - 1 > wq_first) ||
                        (window > 0 && wq_last - kw >= window) || kw + KH > Sk;
#pragma unroll
      for (int j = 0; j < NN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale, f = 1.f;
          if (cap > 0.f) {
            const float th = tanhf(x * inv_cap);
            x = cap * th;
            f = 1.f - th * th;
          }
          float p = expf(x - lr[e >> 1]);
          if (edge) {
            const int key = kw + 8 * j + 2 * t + (e & 1);
            p = key < Sk && visible(qr[e >> 1], key, causal, window) ? p : 0.f;
          }
          dp[j][e] = p * f * (dp[j][e] - dr[e >> 1]);
        }
      }
      // dQ += dS K, a k-step of 8 keys at a time
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        uint32_t ah[4], al[4];
        split_c_as_a(dp[j], ah, al);
        mma_rows<KD, NV, LD, BS>(dqa, ah, al, kt + (8 * j + 2 * t) * LD + g, BK * LD);
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (C::kSplit == 2) {  // the two halves' dQ added in a fixed order, as pass 1
    float* xs = rs + (tid & 127);
    __syncthreads();
    if (half == 1) {
#pragma unroll
      for (int n = 0; n < KD; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xs[(4 * n + e) * 128] = dqa[n][e];
    }
    __syncthreads();
    if (half == 1) return;
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[n][e] += xs[(4 * n + e) * 128];
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qr[i] >= Sq) continue;
    const int r = wr + g + 8 * i;
    T* row = dq + (((size_t)b * Sq + qr[i]) * H + (size_t)kvh * G + r - qr[i] * G) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < KD; ++n)
      store2(row + 8 * n, dqa[n][2 * i] * scale, dqa[n][2 * i + 1] * scale);
  }
}

// pass 1 at hd 256 (float32, kCols 2): dK, dV of kKeys keys over one
// segment of the schedule, as dkdv_tf32_kernel; thread block 2 x 4 warps,
// group c owning columns [c HD / 2, (c + 1) HD / 2) of dK and dV. Each
// stage of kBR rows: group 0 computes S^T = K Q^T, group 1 dP^T = V dO^T
// (the warp's 16 keys x kBR rows, over every column, in kChains partial
// sums), the two swap them through shared memory in the accumulators'
// layout (the next write of a group's buffer comes after the other group's
// read of it: the stage's first barrier lies between), both form P^T and
// dS^T, then dV += P^T dO and dK += dS^T Q on their columns. Q and dO are
// held once in float32 and split as read.
template <int HD>
__global__ void __launch_bounds__(Tf32BwdTiling<HD>::kThreads, Tf32BwdTiling<HD>::kBlocks)
dkdv_tf32_cols_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dO,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ part,
                      const int4* __restrict__ items, int Sq, int Sk, int H, int K, int B,
                      int causal, int window, float cap, float scale) {
  using C = Tf32BwdTiling<HD>;
  static_assert(C::kCols == 2 && C::kSplit == 1 && !C::kPreSplit, "the column-split tiling");
  constexpr int BN = kKeys, BR = C::kBR, LD = C::kLd, NT = C::kThreads;
  constexpr int KD = HD / 8;  // k-steps of S^T and dP^T
  constexpr int KC = KD / 2;  // n-blocks of dK and dV a thread holds (its group's columns)
  constexpr int NR = BR / 8;  // n-blocks of S^T and dP^T; k-steps of dV and dK
  constexpr int CH = HD / 4;  // 16-byte copies a row
  constexpr int RS = 2 * BR * LD;  // a ring stage: Q, dO
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;           // K [BN][LD]
  float* vs = ks + BN * LD;  // V [BN][LD]
  float* rs = vs + BN * LD;  // [2] ring stages
  float* ls = rs + 2 * RS;   // [2][BR] lse
  float* dl = ls + 2 * BR;   // [2][BR] D
  float* xch = dl + 2 * BR;  // the groups' exchange, [2][NR * 4][128]

  const int G = H / K, kb = blockIdx.x % (K * B);
  const int kvh = kb % K, b = kb / K;
  const int4 it = items[blockIdx.x / (K * B)];
  const int k0 = it.x * BN, r_lo = it.y, r_hi = it.z, slot = it.w;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int warp = (tid >> 5) & 3, cg = tid >> 7;  // the warp's keys; the group
  const int wk = k0 + warp * 16;  // the warp's first key
  const int co = cg * (HD / 2);   // the group's first column of dK and dV
  const float inv_cap = cap > 0.f ? 1.f / cap : 0.f;

  for (int c = tid; c < BN * CH; c += NT) {
    const int j = c / CH, cc = (c % CH) * 4, key = k0 + j;
    const bool ok = key < Sk;
    const size_t off = ok ? (((size_t)b * Sk + key) * K + kvh) * HD + cc : 0;
    cp_async16(ks + j * LD + cc, k + off, ok);
    cp_async16(vs + j * LD + cc, v + off, ok);
  }
  auto load_rows = [&](int r, int buf) {
    float* st = rs + buf * RS;
    for (int c = tid; c < BR * CH; c += NT) {
      const int j = c / CH, cc = (c % CH) * 4, rr = r + j, qi = rr / G;
      const bool ok = rr < r_hi;
      const size_t off =
          ok ? (((size_t)b * Sq + qi) * H + (size_t)kvh * G + rr - qi * G) * HD + cc : 0;
      cp_async16(st + j * LD + cc, q + off, ok);
      cp_async16(st + (BR + j) * LD + cc, dO + off, ok);
    }
    for (int j = tid; j < BR; j += NT) {
      const int rr = r + j, qi = rr / G;
      const bool ok = rr < r_hi;
      const size_t li = ok ? ((size_t)b * H + (size_t)kvh * G + rr - qi * G) * Sq + qi : 0;
      cp_async4(ls + buf * BR + j, lse + li, ok);
      cp_async4(dl + buf * BR + j, delta + li, ok);
    }
    cp_async_commit();
  };
  load_rows(r_lo, 0);  // with K and V

  // this thread's keys: wk + g (acc[.][0..1]) and wk + g + 8 (acc[.][2..3]);
  // its columns co + 8 n + 2 t (+ 1)
  float dka[KC][4], dva[KC][4];
#pragma unroll
  for (int n = 0; n < KC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  int buf = 0;
  for (int r = r_lo; r < r_hi; r += BR, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // this stage is in, and every warp is done with the other one
    if (r + BR < r_hi) load_rows(r + BR, buf ^ 1);  // in flight under this stage
    const float* qt = rs + buf * RS;  // Q [BR][LD]
    const float* ot = qt + BR * LD;   // dO [BR][LD]
    const float* lt = ls + buf * BR;
    const float* dt = dl + buf * BR;
    const int q_lo = r / G, q_hi = (min(r + BR, r_hi) - 1) / G;
    const bool skip = wk >= Sk || (causal && q_hi < wk) ||
                      (window > 0 && q_lo - (wk + 15) >= window);
    float mine[NR][4], s[NR][4], dp[NR][4];
    if (!skip) {
      chain_sum<KD, NR, LD, kRawTile>(mine, (cg == 0 ? ks : vs) + (warp * 16 + g) * LD + t,
                                      (cg == 0 ? qt : ot) + g * LD + t);
    } else {
#pragma unroll
      for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[j][e] = 0.f;
    }
    float* x = xch + cg * (NR * 4 * 128) + (tid & 127);
    const float* y = xch + (1 - cg) * (NR * 4 * 128) + (tid & 127);
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[(j * 4 + e) * 128] = mine[j][e];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float other = y[(j * 4 + e) * 128];
        s[j][e] = cg == 0 ? mine[j][e] : other;
        dp[j][e] = cg == 0 ? other : mine[j][e];
      }
    if (skip) continue;
    // P^T = exp(S^T scale (capped) - lse) and dS^T = P^T (dP^T - D) (times
    // the softcap's 1 - tanh^2), in both groups; s[j][e]: key wk + g + 8 (e
    // >> 1), row r + 8 j + 2 t + (e & 1)
    const bool edge = (causal && q_lo < wk + 15) || (window > 0 && q_hi - wk >= window) ||
                      wk + 16 > Sk || r + BR > r_hi;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        float xs = s[j][e] * scale, f = 1.f;
        if (cap > 0.f) {
          const float th = tanhf(xs * inv_cap);
          xs = cap * th;
          f = 1.f - th * th;
        }
        float p = expf(xs - lt[col]);
        if (edge) {
          const int rr = r + col, key = wk + g + ((e >> 1) << 3);
          const bool ok = rr < r_hi && key < Sk && visible(rr / G, key, causal, window);
          p = ok ? p : 0.f;
        }
        s[j][e] = p;
        dp[j][e] = p * f * (dp[j][e] - dt[col]);
      }
    }
    // dV += P^T dO and dK += dS^T Q on the group's columns, a k-step of 8 rows
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      uint32_t ah[4], al[4];
      const int row = (8 * j + 2 * t) * LD + g + co;
      split_c_as_a(s[j], ah, al);
      mma_rows<KC, 4, LD, kRawTile>(dva, ah, al, ot + row, 0);
      split_c_as_a(dp[j], ah, al);
      mma_rows<KC, 4, LD, kRawTile>(dka, ah, al, qt + row, 0);
    }
  }
  cp_async_wait<0>();  // an empty walk issued its copies too

  if (slot < 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = wk + g + 8 * i;
      if (key >= Sk) continue;
      const size_t off = (((size_t)b * Sk + key) * K + kvh) * HD + co + 2 * t;
#pragma unroll
      for (int n = 0; n < KC; ++n) {
        store2(dk + off + 8 * n, dka[n][2 * i] * scale, dka[n][2 * i + 1] * scale);
        store2(dv + off + 8 * n, dva[n][2 * i], dva[n][2 * i + 1]);
      }
    }
    return;
  }
  float* pk = part + ((size_t)slot * K * B + kb) * (2 * BN * HD);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int off = (warp * 16 + g + 8 * i) * HD + co + 2 * t;
#pragma unroll
    for (int n = 0; n < KC; ++n) {
      store2(pk + off + 8 * n, dka[n][2 * i], dka[n][2 * i + 1]);
      store2(pk + BN * HD + off + 8 * n, dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

// pass 2 at hd 256 (float32, kCols 2): dQ for kBQ folded rows, the longest
// causal rows first, as dq_tf32_kernel; group c owns columns [c HD / 2, (c +
// 1) HD / 2) of dQ. Each stage of kBK keys: group 0 computes S = Q K^T,
// group 1 dP = dO V^T (the warp's 16 rows x kBK keys, over every column),
// swapped as in pass 1, both form dS, then dQ += dS K on their columns. K
// and V are held once in float32 and split as read.
template <int HD>
__global__ void __launch_bounds__(Tf32BwdTiling<HD>::kThreads, Tf32BwdTiling<HD>::kBlocks)
dq_tf32_cols_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int Sq, int Sk, int H, int K, int causal, int window,
                    float cap, float scale) {
  using C = Tf32BwdTiling<HD>;
  static_assert(C::kCols == 2 && C::kSplit == 1 && !C::kPreSplit, "the column-split tiling");
  constexpr int BQ = C::kBQ, BK = C::kBK, LD = C::kLd, NT = C::kThreads;
  constexpr int KD = HD / 8;  // k-steps of S and dP
  constexpr int KC = KD / 2;  // n-blocks of dQ a thread holds (its group's columns)
  constexpr int NN = BK / 8;  // n-blocks of S and dP; k-steps of dQ
  constexpr int CH = HD / 4;  // 16-byte copies a row
  constexpr int RS = 2 * BK * LD;  // a ring stage: K, V
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;            // Q [BQ][LD]
  float* dos = qs + BQ * LD;  // dO [BQ][LD]
  float* rs = dos + BQ * LD;  // [2] ring stages
  float* xch = rs + 2 * RS;   // the groups' exchange, [2][NN * 4][128]

  const int G = H / K, kvh = blockIdx.y, b = blockIdx.z;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal rows first
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int warp = (tid >> 5) & 3, cg = tid >> 7;  // the warp's rows; the group
  const int co = cg * (HD / 2);  // the group's first column of dQ
  const int q_first = r0 / G;
  const int q_last = min(Sq - 1, (r0 + BQ - 1) / G);
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) / BK * BK : 0;
  const int wr = r0 + warp * 16;  // the warp's first folded row
  const int wq_first = wr / G, wq_last = min(Sq - 1, (wr + 15) / G);
  const float inv_cap = cap > 0.f ? 1.f / cap : 0.f;

  for (int c = tid; c < BQ * CH; c += NT) {
    const int rr = c / CH, cc = (c % CH) * 4, r = r0 + rr, qi = r / G;
    const bool ok = qi < Sq;
    const size_t off =
        ok ? (((size_t)b * Sq + qi) * H + (size_t)kvh * G + r - qi * G) * HD + cc : 0;
    cp_async16(qs + rr * LD + cc, q + off, ok);
    cp_async16(dos + rr * LD + cc, dO + off, ok);
  }
  auto load_kv = [&](int kb, int buf) {
    float* st = rs + buf * RS;
    for (int c = tid; c < BK * CH; c += NT) {
      const int j = c / CH, cc = (c % CH) * 4, key = kb + j;
      const bool ok = key < Sk;
      const size_t off = ok ? (((size_t)b * Sk + key) * K + kvh) * HD + cc : 0;
      cp_async16(st + j * LD + cc, k + off, ok);
      cp_async16(st + (BK + j) * LD + cc, v + off, ok);
    }
    cp_async_commit();
  };
  load_kv(k_begin, 0);  // with Q and dO

  // this thread's rows: wr + g (acc[.][0..1]) and wr + g + 8 (acc[.][2..3])
  int qr[2];
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr + g + 8 * i, qi = r / G;
    const size_t li = ((size_t)b * H + (size_t)kvh * G + r - qi * G) * Sq + qi;
    qr[i] = qi;
    lr[i] = qi < Sq ? lse[li] : 0.f;
    dr[i] = qi < Sq ? delta[li] : 0.f;
  }
  // its columns co + 8 n + 2 t (+ 1)
  float dqa[KC][4];
#pragma unroll
  for (int n = 0; n < KC; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  int buf = 0;
  for (int kb = k_begin; kb < k_end; kb += BK, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // this stage is in, and every warp is done with the other one
    if (kb + BK < k_end) load_kv(kb + BK, buf ^ 1);  // in flight under this stage
    const float* kt = rs + buf * RS;  // K [BK][LD]
    const float* vt = kt + BK * LD;   // V [BK][LD]
    const bool skip = wq_first >= Sq || (causal && kb > wq_last) ||
                      (window > 0 && wq_first - (kb + BK - 1) >= window);
    float mine[NN][4], s[NN][4], dp[NN][4];
    if (!skip) {
      chain_sum<KD, NN, LD, kRawTile>(mine, (cg == 0 ? qs : dos) + (warp * 16 + g) * LD + t,
                                      (cg == 0 ? kt : vt) + g * LD + t);
    } else {
#pragma unroll
      for (int j = 0; j < NN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[j][e] = 0.f;
    }
    float* x = xch + cg * (NN * 4 * 128) + (tid & 127);
    const float* y = xch + (1 - cg) * (NN * 4 * 128) + (tid & 127);
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[(j * 4 + e) * 128] = mine[j][e];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float other = y[(j * 4 + e) * 128];
        s[j][e] = cg == 0 ? mine[j][e] : other;
        dp[j][e] = cg == 0 ? other : mine[j][e];
      }
    if (skip) continue;
    // dS = P (dP - D) (times the softcap's factor), in both groups; s[j][e]:
    // row qr[e >> 1], key kb + 8 j + 2 t + (e & 1)
    const bool edge = (causal && kb + BK - 1 > wq_first) ||
                      (window > 0 && wq_last - kb >= window) || kb + BK > Sk;
#pragma unroll
    for (int j = 0; j < NN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float xs = s[j][e] * scale, f = 1.f;
        if (cap > 0.f) {
          const float th = tanhf(xs * inv_cap);
          xs = cap * th;
          f = 1.f - th * th;
        }
        float p = expf(xs - lr[e >> 1]);
        if (edge) {
          const int key = kb + 8 * j + 2 * t + (e & 1);
          p = key < Sk && visible(qr[e >> 1], key, causal, window) ? p : 0.f;
        }
        dp[j][e] = p * f * (dp[j][e] - dr[e >> 1]);
      }
    }
    // dQ += dS K on the group's columns, a k-step of 8 keys at a time
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      uint32_t ah[4], al[4];
      split_c_as_a(dp[j], ah, al);
      mma_rows<KC, 4, LD, kRawTile>(dqa, ah, al, kt + (8 * j + 2 * t) * LD + g + co, 0);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qr[i] >= Sq) continue;
    const int r = wr + g + 8 * i;
    float* row =
        dq + (((size_t)b * Sq + qr[i]) * H + (size_t)kvh * G + r - qr[i] * G) * HD + co + 2 * t;
#pragma unroll
    for (int n = 0; n < KC; ++n)
      store2(row + 8 * n, dqa[n][2 * i] * scale, dqa[n][2 * i + 1] * scale);
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

// D = rowsum(dO * O) of bf16 o and dO: HD / 8 threads a row, 16-byte loads
template <int HD>
cudaError_t launch_delta_tc(const Args& a) {
  const long long rows = (long long)a.B * a.Sq * a.H;
  const long long nd = (rows + kThreads / (HD / 8) - 1) / (kThreads / (HD / 8));
  if (nd > 0x7fffffffLL) return cudaErrorInvalidValue;
  delta_tc_kernel<HD><<<(unsigned)nd, kThreads, 0, a.s>>>(
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dO), a.delta, a.Sq, a.H, rows);
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
  // the folded rows r < G * Sq are divided by G as a multiply-high
  if (a.n_items <= 0 || a.n_tiles <= 0 || a.sched == nullptr || n1 > 0x7fffffffLL ||
      nm > 0x7fffffffLL || nq > 0x7fffffffLL || a.K > 65535 || a.B > 65535 ||
      (long long)G * G * a.Sq >= (1LL << 32))
    return cudaErrorInvalidValue;
  const unsigned long long gm = ((1ULL << 32) + G - 1) / G;
  cudaError_t err = launch_delta_tc<HD>(a);
  if (err != cudaSuccess) return err;
  const bf16 *q = static_cast<const bf16*>(a.q), *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v), *dO = static_cast<const bf16*>(a.dO);
  bf16 *dk = static_cast<bf16*>(a.dk), *dv = static_cast<bf16*>(a.dv);
  dkdv_wg_kernel<HD><<<(unsigned)n1, W::kThreads, W::kSmem1, a.s>>>(
      q, k, v, dO, a.lse, a.delta, dk, dv, a.part, a.sched, a.Sq, a.Sk, a.H, a.K, a.B,
      a.causal, a.window, a.cap, a.scale, gm);
  dkdv_merge_kernel<bf16, HD><<<(unsigned)nm, 256, 0, a.s>>>(a.part, a.sched + a.n_items, dk,
                                                             dv, a.Sk, a.K, a.B, a.scale);
  dq_wg_kernel<HD><<<dim3((unsigned)nq, a.K, a.B), W::kThreads, W::kSmem2, a.s>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<bf16*>(a.dq), a.Sq, a.Sk, a.H, a.K, a.causal,
      a.window, a.cap, a.scale);
  return cudaSuccess;
}

// the split-TF32 route: T float (every head dim; hd 256 on the column-split
// kernels) or bf16 (hd 8, 16, 32)
template <typename T, int HD>
cudaError_t launch_tf32(const Args& a) {
  using C = Tf32BwdTiling<HD>;
  constexpr bool cols = C::kCols == 2;
  auto* dkdv = [] {
    if constexpr (cols) return dkdv_tf32_cols_kernel<HD>;
    else return dkdv_tf32_kernel<T, HD>;
  }();
  auto* dqk = [] {
    if constexpr (cols) return dq_tf32_cols_kernel<HD>;
    else return dq_tf32_kernel<T, HD>;
  }();
  static const cudaError_t attr1 = smem_attr(dkdv, C::kSmem1);
  static const cudaError_t attr2 = smem_attr(dqk, C::kSmem2);
  if (attr1 != cudaSuccess) return attr1;
  if (attr2 != cudaSuccess) return attr2;
  const int G = a.H / a.K;
  const long long kb = (long long)a.K * a.B;
  const long long n1 = a.n_items * kb, nm = a.n_tiles * kb;
  const long long rows = (long long)G * a.Sq;  // folded rows, held in int by the kernels
  const long long nq = (rows + C::kBQ - 1) / C::kBQ;
  if (a.n_items <= 0 || a.n_tiles <= 0 || a.sched == nullptr || n1 > 0x7fffffffLL ||
      nm > 0x7fffffffLL || rows + C::kBQ > 0x7fffffffLL || a.K > 65535 || a.B > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value)
    err = launch_delta_tc<HD>(a);
  else
    err = launch_delta<float>(a, HD);
  if (err != cudaSuccess) return err;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *dO = static_cast<const T*>(a.dO);
  T *dk = static_cast<T*>(a.dk), *dv = static_cast<T*>(a.dv);
  dkdv<<<(unsigned)n1, C::kThreads, C::kSmem1, a.s>>>(q, k, v, dO, a.lse, a.delta, dk, dv,
                                                      a.part, a.sched, a.Sq, a.Sk, a.H, a.K,
                                                      a.B, a.causal, a.window, a.cap, a.scale);
  dkdv_merge_kernel<T, HD><<<dim3((unsigned)nm, HD / 8), 256, 0, a.s>>>(
      a.part, a.sched + a.n_items, dk, dv, a.Sk, a.K, a.B, a.scale);
  dqk<<<dim3((unsigned)nq, a.K, a.B), C::kThreads, C::kSmem2, a.s>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<T*>(a.dq), a.Sq, a.Sk, a.H, a.K, a.causal,
      a.window, a.cap, a.scale);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/o/dO/dq (B,Sq,H,hd), k/v/dk/dv
// (B,Sk,K,hd), lse and delta (scratch for D) (B,H,Sq) float32, all
// contiguous and on 16-byte boundaries (every route copies 16-byte chunks).
// Every route (bfloat16 at hd 64, 128 and 256 on wgmma; float32 at every
// head dim and bfloat16 at hd 8, 16, 32 in split-TF32) takes the dK/dV
// pass's schedule, n_items segment rows then n_tiles key-tile rows of 4
// int32 each (kernels/flash_attention_bwd.py::dkdv_schedule), and the
// float32 workspace of its partials (slots x B x K x 2 x 64 x hd). Launches
// the D pre-pass, the dK/dV pass, the merge of its cut key tiles and the dQ
// pass on ``stream``. Returns a cudaError_t: the launches', else
// cudaGetLastError().
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
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)dO |
       (uintptr_t)sched | (uintptr_t)work) & 15)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (hd) {
      case 8: err = launch_tf32<float, 8>(a); break;
      case 16: err = launch_tf32<float, 16>(a); break;
      case 32: err = launch_tf32<float, 32>(a); break;
      case 64: err = launch_tf32<float, 64>(a); break;
      case 128: err = launch_tf32<float, 128>(a); break;
      case 256: err = launch_tf32<float, 256>(a); break;
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 8: err = launch_tf32<bf16, 8>(a); break;
      case 16: err = launch_tf32<bf16, 16>(a); break;
      case 32: err = launch_tf32<bf16, 32>(a); break;
      case 64: err = launch_tc<64>(a); break;
      case 128: err = launch_tc<128>(a); break;
      case 256: err = launch_tc<256>(a); break;
    }
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
