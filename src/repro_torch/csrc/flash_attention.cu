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
// Every variant gives one thread block a tile of query rows of one (batch, kv
// head). The G query heads of the kv group are folded into the tile's rows
// (row = q * G + g), so the G heads share every K/V tile staged in shared
// memory. Positions are implicit, arange(Sq) for the queries and arange(Sk)
// for the keys, as in the TPU kernel: causal keeps key j for query i iff
// i >= j (aligned at the top left) and the window counts from the same
// positions. The block walks K/V tiles only up to the causal frontier of its
// last row, min(Sk, q_last + 1), and from the window edge of its first row;
// the ragged last tile is masked, so any Sq and Sk work: seamless's
// cross-attention runs non-causal with Sq != Sk, where every block walks all
// Sk keys (the longest-rows-first order then changes nothing). Masking follows the reference: masked
// scores are the finite -1e30, keys past Sk are -inf, and l is clamped at
// 1e-30. Three variants:
//
// Split-TF32 tensor-core variant: float32 at every head dim (8 to 256), the
// serving path (paper-default and qwen2-0.5b serve at hd 64, internlm2-1.8b
// and granite-8b at 128, gemma2-2b at 256). What bounds it: operations, 4*hd float32 FLOPs per
// causal (q, k) pair of each head (227.8 MFLOP at the served q (1,333,16,64),
// 3.4 us at 67 TFLOP/s) against ~1.4 MB of inputs. The CUDA-core design
// before it spent ~64 dependent steps a key tile per thread (8 FMAs, 3
// shuffles and the softmax per key, K/V staged element by element between
// two barriers, nothing in flight) on about one block an SM: 0.085 ms. This
// design cuts that chain:
//  - S = Q K^T and O += P V are mma.sync.m16n8k8 tf32 products, each operand
//    split into two tf32 halves and a product taken as lo*hi + hi*lo +
//    hi*hi (csrc/tc_mma.cuh: split_tf32, mma3), which keeps the 1e-4
//    float32 checks that plain TF32 (10-bit mantissas) does not; P is split
//    too (P rounded to tf32 alone costs ~1e-3 on P V). The halves are
//    rounded by bit masking, not cvt.rna (the same rounding, a quarter less
//    time here).
//  - Q is split once (into registers at hd <= 64, into shared memory at hd
//    128 and 256 to keep the registers for the accumulators). P never leaves the
//    registers: the accumulator of S holds (g, 2t), (g, 2t + 1), and the A
//    operand of P V wants (g, t), (g, t + 4), so the k index of each 8-key
//    step is permuted (column t is key 2t, t + 4 is key 2t + 1) and V's
//    rows are read in that order, as ssd_scan.cu does.
//  - K/V stream through a two-stage ring in dynamic shared memory by
//    cp.async, 16 bytes a copy, the next stage in flight while this one is
//    used; shared rows of hd + 4 floats put every fragment's 32 loads in 32
//    distinct banks.
//  - A block is 32 folded rows and 4 warps: two row warps of 16 rows, each
//    twice, once for each half of every ring stage's keys (32 keys a warp
//    at hd <= 64, 16 at hd 128; hd 256 below). The two halves' (m, l, acc) merge in a
//    fixed order at the end. The served shape is latency-bound: its longest
//    block walks the causal chain of 333 keys, and one warp alone on it took
//    0.0345 ms; two warps on its keys halve that chain. 32-row tiles give
//    666 rows x 8 kv heads = 168 blocks for the 132 SMs (a 64-row tile
//    gives 88), the longest causal row tiles first.
//  - A warp skips a key tile that lies wholly outside its own rows' causal
//    or window range; that is exact (the tile's weights are 0, or are wiped
//    by alpha = 0 later).
//  - hd 256 (gemma2-2b served in float32, q (1,333,8,256), softcap 50:
//    1.37 GFLOP as three tf32 products, 2.8 us at 495 TFLOP/s, against 8.2
//    MB, 2.4 us): the same kernel. O is 16 x 256 / 32 = 128 registers a
//    thread of a 16-row warp tile; Q's hi and lo halves stay in shared
//    memory (2 x 32 x 260 floats, 66,560 bytes) beside the 2-stage K/V ring
//    of 32 keys (133,120 bytes): 199,680 of a block's 232,448, one block an
//    SM. V is split 4 n-blocks at a time (NV), so a P V step holds 16 more
//    registers, not 128. With one block an SM, a stage's keys are split
//    over four warp groups of 8 keys each (kSplit 4: 8 warps an SM, so a
//    warp's dependent products wait beside another's), each computing S
//    over the whole head dim for its own keys, its even and odd k-steps in
//    two accumulators (two chains of 48 products, not one of 96); nothing
//    is exchanged but the final (m, l, acc) merge, in part order. The
//    served shape's 666 folded rows a kv head make 21 x 4 = 84 blocks for
//    the 132 SMs; the longest block's causal chain is 333 keys, 11 ring
//    stages (phase 2 prints ptxas's registers and spills).
// No atomics, every sum in a fixed order: two runs give the same bits.
//
// Hopper variant (flash_wg_kernel): bf16 at hd 64, 128 and 256, the training
// forward with its log-sum-exp and bf16 prefill (qwen2-0.5b, the 32k cells,
// mixtral, internlm2, granite and internvl2 at hd 128, gemma2-2b at hd 256).
// What bounds it:
// operations (qwen2-0.5b's training shape q (4,2048,14,64) k/v
// (4,2048,2,64): 30.1 GFLOP causal, 0.0304 ms at 989 TFLOP/s, against 34 MB
// moved, 0.010 ms at 3.35 TB/s). The design before it (mma.sync with ldmatrix,
// FlashAttention-2) ran at ~15 % of that: every warp re-read each K/V tile
// from shared memory, the warps that computed also issued the copies and
// waited at two barriers a tile, and mma.sync held the tensor cores through
// the softmax. This one follows FlashAttention-3 (arXiv 2407.08608):
//  - A block is 384 threads: warpgroup 0 produces, warpgroups 1 and 2
//    consume, each with 64 folded rows (128 a block). One producer thread
//    issues TMA loads of K and V tiles of 128 keys (64 at hd 256) into a K
//    ring and a V ring of 3 stages (2 at hd 256); each stage of each ring
//    has a "full" mbarrier, completed by the producer's expect_tx and the
//    boxes' bytes, and an "empty" one, at which the 8 consumer warps arrive
//    when done with it. K of a tile is released as soon as S = Q K^T is
//    done, V a tile later, after its O += P V: so the next K load starts a
//    whole tile before it is needed even with 2 stages. setmaxnreg moves
//    registers from the producer (24) to the consumers (240).
//  - S = Q K^T is wgmma.m64n128k16, Q (K-major A) and K (K-major B) both
//    from shared memory; O += P V is wgmma.m64n64k16 with P as a register A
//    fragment (the S accumulator packed to bf16: two of its n-blocks of 8
//    keys are one k-step of 16) and V the same swizzled tile read as an
//    MN-major B, one product per 64 columns. The two warpgroups share every
//    K/V tile of the ring.
//  - Within a warpgroup, tile t's S and tile t - 1's P V are issued
//    together; the softmax of tile t waits for S only and runs while P V is
//    on the tensor cores (FA3's intra-warpgroup overlap), so a V tile
//    stays in its ring until the next tile's turn (hence the separate K
//    ring, whose tile is free once S is done). The softmax writes its
//    exponentials into the S registers,
//    and P is packed to bf16 only once the last P V is done with the P
//    registers: a P written while a product still read the last one made
//    ptxas serialise every product (its warning C7513).
//  - The two consumers take turns at issuing their products (named
//    barriers), so that one's softmax runs under the other's products
//    (FA3's ping-pong).
//  - The softmax runs in log2 units (the scale times log2(e) folded into
//    the exponent's multiply-add, 2^x in one MUFU.EX2), with four partial
//    maxima and sums a row to keep the dependent chains short; masking and
//    the softcap in copies of the loop chosen by block-uniform branches; a
//    warpgroup skips a tile wholly outside its rows' causal or window range
//    (exact, as above).
//  - Block i takes row tile nx - 1 - i / (K * B) of (b, kv head) i % (K * B):
//    the longest causal row tiles of every (b, kv head) first.
//  - P is rounded to bf16 for P V, l is summed from the unrounded p;
//    masked scores are -1e30, keys past Sk -inf, l is clamped at 1e-30, as
//    the other variants. No atomics: two runs give the same bits.
// What it waits on: with the softmax left out it runs in about 60 % of its
// time at hd 64 (scripts/flash_variants.py builds and times such
// variants): the exponentials and maxima, not the loads or the products,
// are what a further pass has to hide.
// Trouble spots, and what was done about each:
//  - Tensor maps from a library loaded with ctypes: cuTensorMapEncodeTiled
//    is a driver function and the library is not linked to libcuda, so its
//    entry point comes from cudaGetDriverEntryPointByVersion; the maps hold
//    the base pointers, so they are encoded on every
//    call (host microseconds) and passed as __grid_constant__ parameters.
//  - K/V (B,Sk,K,hd) are 4-D maps (hd, K, Sk, B) with boxes (64, 1, 128, 1):
//    keys past Sk of a batch row are zero-filled, never the next row's; hd
//    128 loads two 64-column boxes a tile (the 128-byte swizzle spans 64
//    bf16 columns); expect_tx counts whole boxes, the zero-filled part too;
//    the ring is aligned to 1024 bytes by hand (the dynamic shared memory's
//    base is not).
//  - Q's folded rows (q * G + g) are not one TMA box when G does not divide
//    the tile (G = 7): each consumer loads its 64 rows once by cp.async into
//    the same swizzled layout (zeros past G * Sq), fences them for the async
//    proxy and syncs its warpgroup on a named barrier.
//  - The masks: each thread's two rows (lane/4 and + 8 of its warp's 16, the
//    wgmma accumulator's layout, which is mma.sync's) have their queries
//    q = r / G computed once; the row max and sum are quad shuffles.
//  - Registers at hd 128: S 64, O 64 and P 32 a thread fit the consumers'
//    240 (ptxas reports the launch's even share, 168, with no spills;
//    chip_smoke.py prints it).
//  - hd 256 (gemma2-2b): what bounds it is operations, as at hd 64. Its
//    training shape q (4,2048,8,256) k/v (4,2048,4,256) causal does 6.9e10
//    FLOP, 0.0695 ms at 989 TFLOP/s, against 0.030 ms of bytes; a global
//    layer of prefill_32k, q (1,32768,8,256), 4.45 ms against 0.04 ms. The
//    tiles of hd 128 do not fit: Q of two consumers takes 64 KiB, and 3
//    stages of 128-key K and V tiles 384 KiB more, of a block's 227. So the
//    tiles hold 64 keys and the rings 2 stages: 1 KiB of alignment + 64 KiB
//    of Q + 2 x 2 x 32 KiB of K and V = 193 KiB (WgTiling<256>::kSmem);
//    the separate K and V rings keep a K load in flight a tile ahead with
//    2 stages. Q is read from shared memory as four 64-column boxes a row.
//    Registers a consumer thread: O 128 (64 rows x 256 columns over 128
//    threads), S 32 (64 keys), P 16 as the bf16 A operand, under the
//    consumers' 240 (ptxas's report, chip_smoke.py phase 2).
//
// mma.sync variant (flash_mma_kernel): bfloat16 at hd 8, 16 and 32 (the
// reduced configs' heads; the wgmma tiles start at 64 columns). What bounds
// it: at the reduced configs' q (4,32,7,hd), 16 blocks of one key tile, the
// launch and one tile's latency (36-135 KB moved); at q (4,2048,7,32)
// causal, operations (7.5 GFLOP, 7.6 us at 989 TFLOP/s, against 8.6 MB) and,
// beside them, one exponential a kept score on the SFU. The CUDA-core design
// before it walked each 64-key tile in 64 dependent steps a thread (a dot
// product over hd/8 dims and shuffles, then one expf a score), K and V
// staged element by element, on no tensor core. This design:
//  - A block is 4 warps and 64 folded rows, 16 a warp. The key range is
//    uniform over the block, [k_begin, k_end) from its first row's window
//    edge to its last row's causal frontier, walked in tiles of 64 keys.
//  - K and V tiles stream through a 2-stage ring in static shared memory by
//    cp.async, 16 bytes a copy, keys past Sk zero-filled, the next tile in
//    flight while this one is used; shared rows of hd + 8 bf16 (hd 8: 8, one
//    16-byte row) put the 8 rows of every ldmatrix phase in 8 distinct
//    16-byte bank groups.
//  - Q's A fragments are read into registers once (hd/16 k-steps). S = Q K^T
//    is mma.sync m16n8k16 with K's B fragments by ldmatrix; at hd 8, half a
//    k-step, m16n8k8 (the bits of a k16 step padded with zeros, half the
//    products).
//  - The online softmax runs in float32 on the S accumulators, in log2 units
//    (the scale times log2(e) in one multiply, 2^x in one MUFU.EX2, and the
//    softcap's division by cap a multiply by scale / cap); a row's max and
//    sum over its quad take two shuffles each. P is rounded to bf16 and
//    kept in registers as the A operand of O += P V (two n-blocks of 8 keys
//    are one k-step of 16), V read transposed by ldmatrix.trans; l sums the
//    unrounded p; O accumulates in float32.
//  - Masks, softcap and the clamp of l as the other variants. No atomics,
//    every sum in a fixed order: two runs give the same bits.
// kernels/ref.py::flash_attention_mma_ref is this algorithm step by step;
// kernels/flash_attention.py::mma_plan its tiling.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tc_mma.cuh"
#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---- mma.sync variant (bf16, hd 8, 16, 32) ----------------------------------

template <int HD>
struct MmaTiling {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBM = 16 * kWarps;  // folded query rows a block, 16 a warp
  static constexpr int kBN = 64;           // keys a K/V tile
  static constexpr int kStages = 2;        // of the cp.async ring
  static constexpr int kLd = HD + 8 * (HD > 8);  // a shared row, bf16: conflict-free ldmatrix
  static constexpr int kSmem = 2 * kStages * kBN * kLd * 2;  // the K and V rings, bytes
};

static_assert(MmaTiling<32>::kSmem <= 48 * 1024, "the rings fit static shared memory");

// d += a (16x8, row) * b (8x8, col), bf16 in, float32 accumulators: a0 (g,
// 2t..2t+1), a1 (g + 8, 2t..2t+1); b0 (k 2t..2t+1, n g); d as m16n8k16
__device__ __forceinline__ void mma1688_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

template <int HD>
__global__ void __launch_bounds__(MmaTiling<HD>::kThreads)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Sk, int H, int K, int causal, int window, float cap,
                 float scale) {
  using C = MmaTiling<HD>;
  constexpr int BM = C::kBM, BN = C::kBN, LD = C::kLd, NT = C::kThreads;
  constexpr int NN = BN / 8;             // n-blocks of S
  constexpr int ND = HD / 8;             // n-blocks of O
  constexpr int KQ = HD < 16 ? 1 : HD / 16;  // k-steps of Q K^T (hd 8: one of k8)
  constexpr int CH = HD / 8;             // 16-byte copies a K/V row
  __shared__ __align__(16) bf16 ks[C::kStages][BN * LD];
  __shared__ __align__(16) bf16 vs[C::kStages][BN * LD];

  const int G = H / K;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;  // the longest causal rows first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int q_first = r0 / G;
  const int q_last = min(Sq - 1, (r0 + BM - 1) / G);
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;
  // this thread's rows: ra (d[0], d[1]) and ra + 8 (d[2], d[3])
  const int ra = r0 + warp * 16 + (lane >> 2);
  const int qa = ra / G, qb = (ra + 8) / G;
  const int wq_first = (r0 + warp * 16) / G;                 // the warp's first query
  const int wq_last = min(Sq - 1, (r0 + warp * 16 + 15) / G);  // and its last real one

  auto load_kv = [&](int k0, int st) {
    for (int c = tid; c < BN * CH; c += NT) {
      const int j = c / CH, cc = (c % CH) * 8;
      const int key = k0 + j;
      const bool ok = key < Sk;
      const size_t off = ok ? (((size_t)b * Sk + key) * K + kvh) * HD + cc : 0;
      cp_async16(&ks[st][j * LD + cc], k + off, ok);
      cp_async16(&vs[st][j * LD + cc], v + off, ok);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) load_kv(k_begin, 0);

  // Q's A fragments, k-step kk: a0 (row ra, dims 16kk + 2t..+1), a1 (ra + 8,
  // the same), a2 and a3 the same rows at dims + 8; rows past Sq are zeros
  uint32_t qf[KQ][4];
  {
    const bf16* q_a = q + (((size_t)b * Sq + min(qa, Sq - 1)) * H + (size_t)kvh * G + ra % G) * HD;
    const bf16* q_b =
        q + (((size_t)b * Sq + min(qb, Sq - 1)) * H + (size_t)kvh * G + (ra + 8) % G) * HD;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      const int d = 16 * kk + 2 * t;
      qf[kk][0] = qa < Sq ? __ldg(reinterpret_cast<const uint32_t*>(q_a + d)) : 0u;
      qf[kk][1] = qb < Sq ? __ldg(reinterpret_cast<const uint32_t*>(q_b + d)) : 0u;
      if constexpr (HD >= 16) {
        qf[kk][2] = qa < Sq ? __ldg(reinterpret_cast<const uint32_t*>(q_a + d + 8)) : 0u;
        qf[kk][3] = qb < Sq ? __ldg(reinterpret_cast<const uint32_t*>(q_b + d + 8)) : 0u;
      } else {
        qf[kk][2] = qf[kk][3] = 0u;
      }
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // the softmax in log2 units: the scale times log2(e) in one multiply, 2^x
  // in one MUFU.EX2, the softcap's division a multiply by scale / cap
  const float scale_log2 = scale * kLog2e, scale_cap = cap > 0.f ? scale / cap : 0.f;
  const float masked_log2 = kNegInf * kLog2e;  // the masked score -1e30, in log2 units
  float m[2] = {masked_log2, masked_log2}, l[2] = {0.f, 0.f};  // m in log2 units

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, k0 = k_begin + it * BN;
    if (it + 1 < n_tiles) {
      load_kv(k0 + BN, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks[st];
    const bf16* vt = vs[st];

    // S = Q K^T, 16 rows x 64 keys a warp
    float sc[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    if constexpr (HD == 8) {
      // matrix i of an x4 load: the 8 keys of n-block n + i, one 16-byte row each
#pragma unroll
      for (int n = 0; n < NN; n += 4) {
        uint32_t bb[4];
        ldsm_x4(bb, kt + (n * 8 + lane) * LD);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma1688_bf16(sc[n + i], qf[0], bb[i]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
        for (int n = 0; n < NN; n += 2) {
          uint32_t bb[4];
          ldsm_x4(bb, kt + (n * 8 + bn_row(lane)) * LD + kk * 16 + bn_col(lane));
          mma16816(sc[n], qf[kk], bb[0], bb[1]);
          mma16816(sc[n + 1], qf[kk], bb[2], bb[3]);
        }
    }

    // scale, cap and mask in log2 units (sc[n][e]: row e < 2 ? qa : qb, key
    // k0 + 8n + 2t + (e & 1)); a tile inside every row's range of the warp
    // skips the mask
    const bool edge = (causal && k0 + BN - 1 > wq_first) ||
                      (window > 0 && wq_last - k0 >= window) || k0 + BN > Sk;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x;
        if (cap > 0.f)
          x = cap * tanhf(sc[n][e] * scale_cap) * kLog2e;
        else
          x = sc[n][e] * scale_log2;
        if (edge) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          const int qi = e < 2 ? qa : qb;
          if (key >= Sk) x = -INFINITY;  // not a key: no weight even in a row with none valid
          else if ((causal && key > qi) || (window > 0 && qi - key >= window)) x = masked_log2;
        }
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float alpha = fast_exp2(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * i] *= alpha;
        acc[n][2 * i + 1] *= alpha;
      }
    }
    // p = 2^(x - m), summed unrounded into l (this thread's share; the quad
    // sums at the end), and rounded to bf16 as the A operand of O += P V: two
    // n-blocks of S are one k-step of 16 keys
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int n = 0; n < NN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = fast_exp2(sc[n][e] - m[e >> 1]);
        l[e >> 1] += sc[n][e];
      }
      pa[n >> 1][(n & 1) * 2] = pack_bf16(sc[n][0], sc[n][1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(sc[n][2], sc[n][3]);
    }

    // O += P V, V's B fragments read transposed
    if constexpr (HD == 8) {
      // one n-block: matrix i of an x4.trans load holds keys 8i..8i+7 of two
      // k-steps, {0, 1} for the first, {2, 3} for the second
#pragma unroll
      for (int s = 0; s < BN / 16; s += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, vt + (s * 16 + lane) * LD);
        mma16816(acc[0], pa[s], bb[0], bb[1]);
        mma16816(acc[0], pa[s + 1], bb[2], bb[3]);
      }
    } else {
#pragma unroll
      for (int s = 0; s < BN / 16; ++s)
#pragma unroll
        for (int n = 0; n < ND; n += 2) {
          uint32_t bb[4];
          ldsm_x4_t(bb, vt + (s * 16 + bt_row(lane)) * LD + n * 8 + bt_col(lane));
          mma16816(acc[n], pa[s], bb[0], bb[1]);
          mma16816(acc[n + 1], pa[s], bb[2], bb[3]);
        }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 8 * i, qi = i == 0 ? qa : qb;
    if (qi >= Sq) continue;
    const int h = kvh * G + r % G;
    const float lc = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lc;
    bf16* orow = o + (((size_t)b * Sq + qi) * H + h) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (lse != nullptr && t == 0) lse[((size_t)b * H + h) * Sq + qi] = m[i] * kLn2 + logf(lc);
  }
}

// ---- Hopper variant (bf16, hd 64, 128, 256): TMA, mbarrier rings, wgmma -----

template <int HD>
struct WgTiling {
  static constexpr int kNC = 2;         // consumer warpgroups
  static constexpr int kThreads = 128 * (1 + kNC);  // warpgroup 0 loads, 1 and 2 compute
  static constexpr int kBM = 64 * kNC;  // folded query rows a block, 64 a consumer
  // keys a K/V tile and stages of the K and V rings: 128 and 3 at hd 64 and
  // 128, 64 and 2 at hd 256, where Q and the rings must fit a block's 227
  // KiB (in integer arithmetic: HD / 256 is 1 at hd 256, else 0)
  static constexpr int kBN = 128 - HD / 256 * 64;
  static constexpr int kNA = HD / 64;   // 64-column sub-tiles (TMA boxes) of a row
  static constexpr int kStages = 3 - HD / 256;
  static constexpr int kBox = kBN * 128;         // bytes of a box: 64 columns of kBN keys
  static constexpr int kQTile = kNA * kSubTile;  // bytes of a consumer's 64 Q rows
  static constexpr int kKVTile = kNA * kBox;     // bytes of a K (or V) tile
  // 1024 bytes for the alignment; Q of the consumers; the K and V rings;
  // a full and an empty mbarrier a stage of each ring
  static constexpr int kSmem = 1024 + kNC * kQTile + 2 * kStages * kKVTile + 4 * kStages * 8;
  static constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // setmaxnreg
};

template <int HD>
__global__ void __launch_bounds__(WgTiling<HD>::kThreads, 1)
flash_wg_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                const bf16* __restrict__ q, bf16* __restrict__ o, float* __restrict__ lse,
                int Sq, int Sk, int H, int K, int B, int causal, int window, float cap,
                float scale) {
  using W = WgTiling<HD>;
  constexpr int BM = W::kBM, BN = W::kBN, NA = W::kNA, ST = W::kStages, CH = HD / 8, NC = W::kNC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qsw = align1024(smem_raw);     // [NC] Q tiles [64][HD]
  unsigned char* ksw = qsw + NC * W::kQTile;    // [ST] K tiles [BN][HD]
  unsigned char* vsw = ksw + ST * W::kKVTile;   // [ST] V tiles [BN][HD]
  // a full and an empty barrier a stage of the K ring, then of the V ring
  uint64_t* full_k = reinterpret_cast<uint64_t*>(vsw + ST * W::kKVTile);  // [ST]
  uint64_t* empty_k = full_k + ST;                                          // [ST]
  uint64_t* full_v = empty_k + ST;                                          // [ST]
  uint64_t* empty_v = full_v + ST;                                          // [ST]

  // block i: row tile nx - 1 - i / (K * B) of (b, kv head) i % (K * B), so
  // that the longest causal row tiles of every (b, kv head) come first
  const int G = H / K, kb = K * B;
  const int nx = (G * Sq + BM - 1) / BM;
  const int grp = blockIdx.x % kb, kvh = grp % K, b = grp / K;
  const int r0 = (nx - 1 - (int)(blockIdx.x / kb)) * BM;
  const int q_first = r0 / G;
  const int q_last = min(Sq - 1, (r0 + BM - 1) / G);
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) / BN * BN : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full_k[s], 1);  // the producer's arrival and the tile's bytes
      mbar_init(&empty_k[s], 4 * NC);  // one arrival from each consumer warp
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_v[s], 4 * NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {  // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W::kProducerRegs));
    if (tid == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST, k0 = k_begin + t * BN, parity = ((t / ST) & 1) ^ 1;
        // the first round passes at once; expect_tx counts whole boxes,
        // zeros past Sk too
        mbar_wait(&empty_k[s], parity);
        mbar_expect_tx(&full_k[s], W::kKVTile);
#pragma unroll
        for (int a = 0; a < NA; ++a)
          tma_load_4d(ksw + s * W::kKVTile + a * W::kBox, &tk, &full_k[s], a * 64, kvh, k0, b);
        mbar_wait(&empty_v[s], parity);
        mbar_expect_tx(&full_v[s], W::kKVTile);
#pragma unroll
        for (int a = 0; a < NA; ++a)
          tma_load_4d(vsw + s * W::kKVTile + a * W::kBox, &tv, &full_v[s], a * 64, kvh, k0, b);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 folded rows against every K/V tile of the ring
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W::kConsumerRegs));
  const int cw = tid / 128 - 1, wtid = tid % 128, warp = wtid >> 5, lane = tid & 31;
  const int rw = r0 + cw * 64;  // this warpgroup's first folded row
  unsigned char* qt = qsw + cw * W::kQTile;
  // Q once, by cp.async into the swizzled layout: its folded rows are G
  // heads of a token, then the next token's, which no TMA box describes
  for (int c = wtid; c < 64 * CH; c += 128) {
    const int rr = c / CH, ch = c % CH, r = rw + rr, qi = r / G;
    const bool ok = qi < Sq;
    const size_t off =
        ok ? (((size_t)b * Sq + qi) * H + (size_t)kvh * G + r % G) * HD + ch * 8 : 0;
    cp_async16(qt + tile_off(rr, ch), q + off, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_smem();
  wg_bar_sync(1 + cw);

  const int wq_first = rw / G;                          // the warpgroup's first query
  const int wq_last = min(Sq - 1, (rw + 63) / G);       // and its last real one
  const int ra = rw + warp * 16 + (lane >> 2);          // this thread's rows: ra, ra + 8
  const int qa = ra / G, qb = (ra + 8) / G;
  const float scale_log2 = scale * kLog2e, scale_cap = cap > 0.f ? scale / cap : 0.f;
  const float masked_log2 = kNegInf * kLog2e;  // the masked score -1e30, in log2 units
  float acc[NA][8][4];  // O: columns a*64 + n*8 + 2*(lane%4) (+1)
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[a][n][0] = acc[a][n][1] = acc[a][n][2] = acc[a][n][3] = 0.f;
  float m[2] = {masked_log2, masked_log2}, l[2] = {0.f, 0.f};  // m in log2 units

  // the tiles this warpgroup computes, [t_lo, t_hi): a tile wholly outside
  // its rows' causal or window range is skipped, which is exact (its
  // weights are 0, or are wiped by alpha = 0 when the rows' first visible
  // key comes); it still waits for every tile and releases it
  int t_lo = 0, t_hi = n_tiles;
  if (wq_first >= Sq) {
    t_hi = 0;
  } else {
    if (window > 0) t_lo = min(n_tiles, max(0, (wq_first - window + 1 - k_begin) / BN));
    if (causal) t_hi = max(t_lo, min(n_tiles, (wq_last - k_begin) / BN + 1));
  }
  // the two consumers take turns at issuing products (named barriers 3 and
  // 4): one's softmax runs under the other's products. Each takes n_tiles
  // + 1 turns, one a tile and one for the last O += P V.
  auto turn_begin = [&] {
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + NC + cw) : "memory");
  };
  auto turn_end = [&] {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + NC + (cw + 1) % NC) : "memory");
  };
  if (cw == NC - 1) turn_end();  // the last consumer lets the first go first
  // the K and V rings' stages of tile t: wait for one to be full, or
  // release it (one arrival a warp)
  auto wait_k = [&](int t) { mbar_wait(&full_k[t % ST], (t / ST) & 1); };
  auto wait_v = [&](int t) { mbar_wait(&full_v[t % ST], (t / ST) & 1); };
  auto free_k = [&](int t) {
    if (lane == 0) mbar_arrive(&empty_k[t % ST]);
  };
  auto free_v = [&](int t) {
    if (lane == 0) mbar_arrive(&empty_v[t % ST]);
  };
  auto pass = [&](int t) {  // wait for tile t and release it unread
    wait_k(t);
    wait_v(t);
    turn_begin();
    turn_end();
    free_k(t);
    free_v(t);
  };
  auto k_tile = [&](int t) { return ksw + (t % ST) * W::kKVTile; };
  auto v_tile = [&](int t) { return vsw + (t % ST) * W::kKVTile; };
  // S = Q K^T for tile t, 64 rows x BN keys, both operands from shared
  // memory; issued, not waited for
  float sc[BN / 8][4];
  auto issue_s = [&](int t) {
    const unsigned char* kt = k_tile(t);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint64_t db = wg_desc(kt + (kk >> 2) * W::kBox) + 2 * (kk & 3);
      if constexpr (BN == 128)
        wg_n128(sc, wg_desc_k(qt, kk), db, kk);
      else
        wg_n64(sc, wg_desc_k(qt, kk), db, kk);
    }
    wg_commit();
  };
  // O += P V for tile t over its BN keys, 16 a step: P the register A, V
  // the MN-major B, each 64 columns a product; issued, not waited for
  auto issue_pv = [&](int t, const uint32_t (&p)[BN / 16][4]) {
    const unsigned char* vt = v_tile(t);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int a = 0; a < NA; ++a)
        wg_n64<1>(acc[a], p[kk], wg_desc(vt + a * W::kBox + kk * 16 * 128), 1);
    wg_commit();
  };
  // the online softmax of tile t's scores, in place: scale, cap and mask
  // in log2 units, the rows' new maxima (alpha rescales what came before),
  // and sc := p = 2^(x - m), summed unrounded into l. Partial maxima and
  // sums, four a row, keep the chains short. One copy for each of
  // (softcap, masked tile), chosen by block-uniform branches; without
  // either, the scale is folded into the exponent's multiply-add.
  auto softmax = [&](int t, float (&alpha)[2]) {
    const int k0 = k_begin + t * BN;
    const bool edge = (causal && k0 + BN - 1 > wq_first) ||
                      (window > 0 && wq_last - k0 >= window) || k0 + BN > Sk;
    auto body = [&](auto capped, auto masked) {
      constexpr bool kCap = decltype(capped)::value, kMask = decltype(masked)::value;
      constexpr bool kRaw = !kCap && !kMask;
      if constexpr (!kRaw) {
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x;
            if constexpr (kCap)
              x = cap * tanhf(sc[n][e] * scale_cap) * kLog2e;
            else
              x = sc[n][e] * scale_log2;
            if constexpr (kMask) {
              const int key = k0 + n * 8 + ((lane & 3) << 1) + (e & 1);
              const int qi = e < 2 ? qa : qb;
              if (key >= Sk)
                x = -INFINITY;  // not a key: no weight even in a row with none valid
              else if ((causal && key > qi) || (window > 0 && qi - key >= window))
                x = masked_log2;
            }
            sc[n][e] = x;
          }
      }
      float mp[2][4];
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float x = fmaxf(sc[n][2 * i], sc[n][2 * i + 1]);
          mp[i][n & 3] = n < 4 ? x : fmaxf(mp[i][n & 3], x);
        }
      const float mul = kRaw ? scale_log2 : 1.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = fmaxf(fmaxf(mp[i][0], mp[i][1]), fmaxf(mp[i][2], mp[i][3])) * mul;
        mx = fmaxf(m[i], mx);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[i] = fast_exp2(m[i] - mx);
        m[i] = mx;
      }
      float ls[2][4];
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = fast_exp2(fmaf(sc[n][e], mul, -m[e >> 1]));
          ls[e >> 1][n & 3] = n < 4 && (e & 1) == 0 ? sc[n][e] : ls[e >> 1][n & 3] + sc[n][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        l[i] = l[i] * alpha[i] + ((ls[i][0] + ls[i][1]) + (ls[i][2] + ls[i][3]));
    };
    using T_ = std::true_type;
    using F_ = std::false_type;
    if (cap > 0.f) {
      if (edge) body(T_{}, T_{}); else body(T_{}, F_{});
    } else {
      if (edge) body(F_{}, T_{}); else body(F_{}, F_{});
    }
  };
  // P in bf16 as the A operand of O += P V: two n-blocks of 8 keys of the S
  // accumulator are one A k-step of 16
  auto to_p = [&](uint32_t (&p)[BN / 16][4]) {
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      p[n >> 1][(n & 1) * 2] = pack_bf16(sc[n][0], sc[n][1]);
      p[n >> 1][(n & 1) * 2 + 1] = pack_bf16(sc[n][2], sc[n][3]);
    }
  };

  // within the warpgroup, tile t's S = Q K^T and tile t - 1's O += P V run
  // on the tensor cores while the softmax of tile t waits only for S (P is
  // packed only once O += P V is done with the registers of the last P).
  // K of tile t is released once S is done, V of tile t - 1 once O += P V
  // is: the K ring's next load starts a tile before its use
  for (int t = 0; t < t_lo; ++t) pass(t);
  if (t_lo < t_hi) {
    uint32_t pa[BN / 16][4];
    float alpha[2];
    wait_k(t_lo);
    turn_begin();
    fence_regs(sc);
    wg_fence();
    issue_s(t_lo);
    turn_end();
    wg_wait0();
    fence_regs(sc);
    free_k(t_lo);
    softmax(t_lo, alpha);  // O is still 0: no rescale
    to_p(pa);
    for (int t = t_lo + 1; t < t_hi; ++t) {
      wait_k(t);
      wait_v(t - 1);
      turn_begin();
      fence_regs(sc);
#pragma unroll
      for (int a = 0; a < NA; ++a) fence_regs(acc[a]);
      wg_fence();
      issue_s(t);
      issue_pv(t - 1, pa);
      turn_end();
      wg_wait<1>();  // S of tile t
      fence_regs(sc);
      free_k(t);
      softmax(t, alpha);
      wg_wait0();  // O += P V of tile t - 1
#pragma unroll
      for (int a = 0; a < NA; ++a) fence_regs(acc[a]);
      free_v(t - 1);
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          acc[a][n][0] *= alpha[0];
          acc[a][n][1] *= alpha[0];
          acc[a][n][2] *= alpha[1];
          acc[a][n][3] *= alpha[1];
        }
      to_p(pa);
    }
    wait_v(t_hi - 1);
    turn_begin();
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(acc[a]);
    wg_fence();
    issue_pv(t_hi - 1, pa);
    turn_end();
    wg_wait0();
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(acc[a]);
    free_v(t_hi - 1);
  } else {
    turn_begin();
    turn_end();
  }
  for (int t = t_hi; t < n_tiles; ++t) pass(t);
  if (cw == 0) turn_begin();  // the last consumer's last turn_end

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 8 * i, qi = i == 0 ? qa : qb;
    if (qi >= Sq) continue;
    const int h = kvh * G + r % G;
    const float lc = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lc;
    bf16* orow = o + (((size_t)b * Sq + qi) * H + h) * HD + ((lane & 3) << 1);
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + a * 64 + n * 8) =
            pack_bf16(acc[a][n][2 * i] * inv, acc[a][n][2 * i + 1] * inv);
    if (lse != nullptr && (lane & 3) == 0)
      lse[((size_t)b * H + h) * Sq + qi] = m[i] * kLn2 + logf(lc);
  }
}

// ---- split-TF32 tensor-core variant (float32, hd 8 to 256) ------------------

template <int HD>
struct Tf32Tiling {
  static constexpr int kBM = 32;            // folded query rows per block, 16 a row warp
  static constexpr int kRowWarps = kBM / 16;
  // warp groups that share a block's keys: 2, and 4 at hd 256 (one block an
  // SM: 8 warps an SM, not 4)
  static constexpr int kSplit = HD == 256 ? 4 : 2;
  static constexpr int kThreads = 32 * kRowWarps * kSplit;  // 4 warps (8 at hd 256)
  // keys a warp takes from a stage: 32 at hd <= 64, 16 at 128, 8 at 256
  static constexpr int kBN = HD <= 64 ? 32 : (HD == 128 ? 16 : 8);
  static constexpr int kStage = kSplit * kBN;      // keys a ring stage holds
  static constexpr int kLd = HD + 4;        // shared row, floats: conflict-free fragments
  static constexpr bool kQRegs = HD <= 64;  // Q's split fragments in registers, else shared
  static constexpr int kQWords = (kQRegs ? 1 : 2) * kBM * kLd;  // Q (hi, then lo at hd >= 128)
  static constexpr int kSmem = (kQWords + 4 * kStage * kLd) * (int)sizeof(float);  // + 2 x (K, V)
};

static_assert(Tf32Tiling<256>::kSmem <= 232448, "hd 256 fits a block's shared memory");

template <int HD>
__global__ void __launch_bounds__(Tf32Tiling<HD>::kThreads)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int Sq, int Sk, int H, int K, int causal,
                  int window, float cap, float scale) {
  using C = Tf32Tiling<HD>;
  constexpr int BM = C::kBM, BN = C::kBN, SK = C::kStage, LD = C::kLd, NT = C::kThreads;
  constexpr int RW = C::kRowWarps;
  constexpr int KD = HD / 8;  // k-steps of Q K^T; n-blocks of O
  constexpr int NN = BN / 8;  // n-blocks of S; k-steps of P V
  constexpr int CH = HD / 4;  // 16-byte copies a row
  constexpr int NV = KD < 4 ? KD : 4;  // n-blocks of V split at a time
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                 // [BM][LD]; at hd 128 the hi halves, then lo [BM][LD]
  float* ks = fsm + C::kQWords;    // [2][SK][LD]
  float* vs = ks + 2 * SK * LD;    // [2][SK][LD]

  const int G = H / K;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;  // the longest causal rows first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp % RW, half = warp / RW;  // the warp's rows; its keys of a stage
  const int q_first = r0 / G;
  const int q_last = min(Sq - 1, (r0 + BM - 1) / G);
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) / SK * SK : 0;
  // this thread's rows of the tile: qr (d[0], d[1]) and qr + 8 (d[2], d[3])
  const int qr = rw * 16 + g;
  const int qa = (r0 + qr) / G, qb = (r0 + qr + 8) / G;
  const int wq_first = (r0 + rw * 16) / G;                // the warp's first query
  const int wq_last = min(Sq - 1, (r0 + rw * 16 + 15) / G);  // and its last real one

  for (int c = tid; c < BM * CH; c += NT) {
    const int rr = c / CH, cc = (c % CH) * 4;
    const int r = r0 + rr, qi = r / G;
    const bool ok = qi < Sq;
    const size_t off = ok ? (((size_t)b * Sq + qi) * H + (size_t)kvh * G + r % G) * HD + cc : 0;
    cp_async16(qs + rr * LD + cc, q + off, ok);
  }
  cp_async_commit();
  auto load_kv = [&](int k0, int buf) {
    for (int c = tid; c < SK * CH; c += NT) {
      const int j = c / CH, cc = (c % CH) * 4;
      const int key = k0 + j;
      const bool ok = key < Sk;
      const size_t off = ok ? (((size_t)b * Sk + key) * K + kvh) * HD + cc : 0;
      cp_async16(ks + (buf * SK + j) * LD + cc, k + off, ok);
      cp_async16(vs + (buf * SK + j) * LD + cc, v + off, ok);
    }
    cp_async_commit();
  };
  load_kv(k_begin, 0);
  cp_async_wait<1>();  // Q is in
  __syncthreads();

  // Q split once: fragment k-step kk holds dims 8kk + t (a0, a1) and + 4 (a2, a3)
  uint32_t qh[C::kQRegs ? KD : 1][4], ql[C::kQRegs ? KD : 1][4];
  if constexpr (C::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const float* a = qs + qr * LD + 8 * kk + t;
      split_tf32(a[0], qh[kk][0], ql[kk][0]);
      split_tf32(a[8 * LD], qh[kk][1], ql[kk][1]);
      split_tf32(a[4], qh[kk][2], ql[kk][2]);
      split_tf32(a[8 * LD + 4], qh[kk][3], ql[kk][3]);
    }
  } else {
    // in place, hi over the tile and lo after it; the loop's first barrier
    // orders these stores before any fragment read
    for (int i = tid; i < BM * HD; i += NT) {
      const int e = (i / HD) * LD + i % HD;
      uint32_t hi, lo;
      split_tf32(qs[e], hi, lo);
      qs[e] = __uint_as_float(hi);
      qs[BM * LD + e] = __uint_as_float(lo);
    }
  }

  float acc[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += SK, buf ^= 1) {
    if (k0 + SK < k_end) {
      load_kv(k0 + SK, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kw = k0 + half * BN;  // this warp's keys: kw .. kw + BN - 1
    const bool skip = wq_first >= Sq || kw >= k_end || (causal && kw > wq_last) ||
                      (window > 0 && wq_first - (kw + BN - 1) >= window);
    if (!skip) {
      const float* kt = ks + (buf * SK + half * BN) * LD;
      const float* vt = vs + (buf * SK + half * BN) * LD;

      // S = Q K^T, 16 rows x BN keys a warp; at hd 256 the odd k-steps sum
      // apart (s_odd) and are added at the end: two dependent chains of 48
      // products an n-block instead of one of 96
      float s[NN][4], s_odd[HD == 256 ? NN : 1][4];
#pragma unroll
      for (int j = 0; j < NN; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      if constexpr (HD == 256) {
#pragma unroll
        for (int j = 0; j < NN; ++j) s_odd[j][0] = s_odd[j][1] = s_odd[j][2] = s_odd[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ah[4], al[4];
        if constexpr (C::kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[e] = qh[kk][e];
            al[e] = ql[kk][e];
          }
        } else {
          const float* a = qs + qr * LD + 8 * kk + t;
          const int off[4] = {0, 8 * LD, 4, 8 * LD + 4};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[e] = __float_as_uint(a[off[e]]);
            al[e] = __float_as_uint(a[BM * LD + off[e]]);
          }
        }
        uint32_t bh[NN][2], bl[NN][2];
#pragma unroll
        for (int j = 0; j < NN; ++j) {
          const float* kb = kt + (8 * j + g) * LD + 8 * kk + t;
          split_tf32(kb[0], bh[j][0], bl[j][0]);
          split_tf32(kb[4], bh[j][1], bl[j][1]);
        }
        if constexpr (HD == 256) {
          if (kk & 1)
            mma3(s_odd, ah, al, bh, bl);
          else
            mma3(s, ah, al, bh, bl);
        } else {
          mma3(s, ah, al, bh, bl);
        }
      }
      if constexpr (HD == 256) {
#pragma unroll
        for (int j = 0; j < NN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += s_odd[j][e];
      }

      // scale, cap and mask (s[j][e]: row e < 2 ? qa : qb, key kw + 8j + 2t
      // + (e & 1)); a tile inside every row's range of the warp skips the mask
      const bool edge = (causal && kw + BN - 1 > wq_first) ||
                        (window > 0 && wq_last - kw >= window) || kw + BN > Sk;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (cap > 0.f) x = cap * tanhf(x / cap);
          if (edge) {
            const int key = kw + 8 * j + 2 * t + (e & 1);
            const int qi = e < 2 ? qa : qb;
            if (key >= Sk) x = -INFINITY;  // not a key: no weight even in a row with none valid
            else if ((causal && key > qi) || (window > 0 && qi - key >= window)) x = kNegInf;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float alpha = expf(m[i] - mx[i]);
        m[i] = mx[i];
        l[i] *= alpha;
#pragma unroll
        for (int n = 0; n < KD; ++n) {
          acc[n][2 * i] *= alpha;
          acc[n][2 * i + 1] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < NN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[j][e] - m[e >> 1]);
          s[j][e] = p;
          l[e >> 1] += p;  // this thread's share; the quad sums at the end
        }
      }

      // O += P V, P split as it sits in the accumulator: step j's column t
      // is key 8j + 2t and t + 4 is 8j + 2t + 1, V's rows read to match
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        uint32_t ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);  // (row g, key 2t)
        split_tf32(s[j][2], ph[1], pl[1]);  // (row g + 8, key 2t)
        split_tf32(s[j][1], ph[2], pl[2]);  // (row g, key 2t + 1)
        split_tf32(s[j][3], ph[3], pl[3]);  // (row g + 8, key 2t + 1)
        const float* vb = vt + (8 * j + 2 * t) * LD + g;
#pragma unroll
        for (int n0 = 0; n0 < KD; n0 += NV) {  // NV n-blocks of V at a time: fewer live registers
          uint32_t bh[NV][2], bl[NV][2];
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            split_tf32(vb[8 * (n0 + n)], bh[n][0], bl[n][0]);
            split_tf32(vb[LD + 8 * (n0 + n)], bh[n][1], bl[n][1]);
          }
#pragma unroll
          for (int n = 0; n < NV; ++n) mma1688_tf32(acc[n0 + n], pl, bh[n]);  // as mma3
#pragma unroll
          for (int n = 0; n < NV; ++n) mma1688_tf32(acc[n0 + n], ph, bl[n]);
#pragma unroll
          for (int n = 0; n < NV; ++n) mma1688_tf32(acc[n0 + n], ph, bh[n]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // merge the kSplit parts' (m, l, acc) of each row, in a fixed order: the
  // other parts' warps leave theirs in the K/V rings (free after the loop's
  // last barrier), one float per lane and value, and the first part's warps
  // combine them in part order
  constexpr int PV = 4 + 4 * KD;  // values a lane leaves
  float* part = ks + rw * 32 + lane;
  if (half > 0) {
    float* mine = part + (half - 1) * PV * RW * 32;
    mine[0] = m[0];
    mine[RW * 32] = m[1];
    mine[2 * RW * 32] = l[0];
    mine[3 * RW * 32] = l[1];
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(4 + 4 * n + e) * RW * 32] = acc[n][e];
  }
  static_assert((C::kSplit - 1) * PV * RW * 32 <= 4 * SK * LD,
                "the merge's values fit the K/V rings");
  __syncthreads();
  if (half > 0) return;
#pragma unroll
  for (int h = 1; h < C::kSplit; ++h) {
    const float* other = part + (h - 1) * PV * RW * 32;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m1 = other[i * RW * 32], l1 = other[(2 + i) * RW * 32];
      const float mm = fmaxf(m[i], m1);
      const float a0 = expf(m[i] - mm), a1 = expf(m1 - mm);
      m[i] = mm;
      l[i] = l[i] * a0 + l1 * a1;
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        acc[n][2 * i] = acc[n][2 * i] * a0 + other[(4 + 4 * n + 2 * i) * RW * 32] * a1;
        acc[n][2 * i + 1] = acc[n][2 * i + 1] * a0 + other[(5 + 4 * n + 2 * i) * RW * 32] * a1;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + qr + 8 * i, qi = r / G;
    if (qi >= Sq) continue;
    const int h = kvh * G + r % G;
    const float lc = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lc;
    float* orow = o + (((size_t)b * Sq + qi) * H + h) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < KD; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (lse != nullptr && t == 0) lse[((size_t)b * H + h) * Sq + qi] = m[i] + logf(lc);
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int Sq, int Sk, int H, int K, int causal, int window,
                       float cap, float scale, cudaStream_t stream) {
  using C = MmaTiling<HD>;
  const long long rows = (long long)(H / K) * Sq;  // folded rows, held in int by the kernel
  if (rows + C::kBM > 0x7fffffffLL || K > 65535 || B > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)((rows + C::kBM - 1) / C::kBM), K, B);
  flash_mma_kernel<HD><<<grid, C::kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, Sq, Sk, H, K, causal, window, cap, scale);
  return cudaSuccess;
}

// cuTensorMapEncodeTiled, a driver function: the library is linked to the
// runtime only, so it is fetched through the runtime's entry-point query
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// the tensor map of k or v (B,Sk,K,hd) bf16 as a 4-D tensor (hd, K, Sk, B),
// innermost first, read in boxes of 64 columns x bn keys of one kv head and
// batch row, 128-byte swizzled: keys past Sk read zeros, never the next
// batch row's
bool kv_map(CUtensorMap* map, const void* base, int B, int Sk, int K, int hd, int bn) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)K, (cuuint64_t)Sk, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)K * hd * 2,
                                 (cuuint64_t)Sk * K * hd * 2};  // bytes, dims 1..3
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)bn, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_wg(const void* q, const void* k, const void* v, void* o, float* lse,
                      int B, int Sq, int Sk, int H, int K, int causal, int window,
                      float cap, float scale, cudaStream_t stream) {
  using W = WgTiling<HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wg_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, W::kSmem);
  if (attr != cudaSuccess) return attr;
  const long long rows = (long long)(H / K) * Sq;  // folded rows, held in int by the kernel
  const long long blocks = (rows + W::kBM - 1) / W::kBM * K * B;
  if (rows + W::kBM > 0x7fffffffLL || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap tk, tv;
  if (!kv_map(&tk, k, B, Sk, K, HD, W::kBN) || !kv_map(&tv, v, B, Sk, K, HD, W::kBN))
    return cudaErrorInvalidValue;
  flash_wg_kernel<HD><<<(unsigned)blocks, W::kThreads, W::kSmem, stream>>>(
      tk, tv, static_cast<const bf16*>(q), static_cast<bf16*>(o), lse, Sq, Sk, H, K, B,
      causal, window, cap, scale);
  return cudaSuccess;
}

template <int HD>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int Sq, int Sk, int H, int K, int causal, int window,
                        float cap, float scale, cudaStream_t stream) {
  using C = Tf32Tiling<HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tf32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return attr;
  const long long rows = (long long)(H / K) * Sq;
  const long long nx = (rows + C::kBM - 1) / C::kBM;
  if (nx > 0x7fffffffLL || K > 65535 || B > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)nx, K, B);
  flash_tf32_kernel<HD><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk, H, K, causal,
      window, cap, scale);
  return cudaSuccess;
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
  // every variant copies 16-byte chunks
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) return (int)cudaErrorInvalidValue;
#define FLASH_ARGS q, k, v, o, l, B, Sq, Sk, H, K, causal, window, softcap, scale, s
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (hd) {
      case 8: err = launch_tf32<8>(FLASH_ARGS); break;
      case 16: err = launch_tf32<16>(FLASH_ARGS); break;
      case 32: err = launch_tf32<32>(FLASH_ARGS); break;
      case 64: err = launch_tf32<64>(FLASH_ARGS); break;
      case 128: err = launch_tf32<128>(FLASH_ARGS); break;
      case 256: err = launch_tf32<256>(FLASH_ARGS); break;
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 8: err = launch_mma<8>(FLASH_ARGS); break;
      case 16: err = launch_mma<16>(FLASH_ARGS); break;
      case 32: err = launch_mma<32>(FLASH_ARGS); break;
      case 64: err = launch_wg<64>(FLASH_ARGS); break;
      case 128: err = launch_wg<128>(FLASH_ARGS); break;
      case 256: err = launch_wg<256>(FLASH_ARGS); break;
    }
  }
#undef FLASH_ARGS
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
