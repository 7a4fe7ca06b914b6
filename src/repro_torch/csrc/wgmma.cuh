// Hopper's warpgroup products (wgmma) and what feeds them, shared by
// flash_attention.cu and flash_attention_bwd.cu: the 128-byte-swizzled
// shared tile layout and its descriptors, the m64n32 / m64n64 / m64n128 bf16
// products with float32 accumulators, the warpgroup fences, and the
// mbarrier and TMA (cp.async.bulk.tensor) primitives of a producer /
// consumer ring. Each including source is compiled on its own
// (kernels/_build.py hashes this header into every library's name).
//
// The tile layout: HD/64 sub-tiles of rows x 128 bytes (64 bf16 columns
// each); 16-byte chunk c of row r sits at chunk c ^ (r % 8) of its row, and
// each sub-tile is 1024-byte aligned. That is what TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes for a box of 64 columns, and what a
// wgmma descriptor of layout 1 (128-byte swizzle) reads. One such tile
// serves as a K-major B (reduced over its columns: S = Q K^T) and,
// transposed, as an MN-major B (reduced over its rows: O += P V), and as a
// K-major A. The accumulators have mma.sync's C fragment layout, 16 rows a
// warp: thread lane holds rows warp*16 + lane/4 (d[n][0..1]) and + 8
// (d[n][2..3]), columns n*8 + 2*(lane%4) (+1).
#pragma once
#include <stdint.h>

#include "tc_mma.cuh"

constexpr int kSubTile = 64 * 128;  // bytes of a 64-row, 64-column sub-tile

// 2^x in one MUFU.EX2 (flushes a result below 2^-126 to zero)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// n / G by a multiply-high with gm = ceil(2^32 / G): exact for n * G < 2^32,
// which the launch checks (n is a folded row, below G * Sq)
__device__ __forceinline__ int div_g(int n, unsigned long long gm) {
  return (int)(((unsigned long long)(unsigned)n * gm) >> 32);
}

// byte offset of 16-byte chunk c (of HD/8) of row r (of 64) in a tile
__device__ __forceinline__ int tile_off(int r, int c) {
  return (c >> 3) * kSubTile + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// the descriptor of a sub-tile (or of its rows from a multiple of 8 on) at
// p, either major: 1024 bytes between groups of 8 rows (the 64-column
// swizzle atom spans the sub-tile, so the other stride is unused)
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// the K-major descriptor of k-step kk (16 columns) of a tile's rows at p
__device__ __forceinline__ uint64_t wg_desc_k(const unsigned char* p, int kk) {
  return wg_desc(p + (kk >> 2) * kSubTile) + 2 * (kk & 3);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes of this thread (cp.async) made visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the compiler may not move reads or writes of d across this point
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

#define WG_D16                                                                         \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),           \
      "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),       \
      "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
#define WG_D32                                                                           \
  WG_D16, "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),     \
      "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]),         \
      "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define WG_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_R32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 32) (+)= A B^T, B the 32 x 16 K-major slice at db; A (64 x 16) in
// registers, or the K-major slice at da
__device__ __forceinline__ void wg_n32(float (&d)[4][4], const uint32_t (&a)[4], uint64_t db,
                                       int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_R16
               ", {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
               : WG_D16
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wg_n32(float (&d)[4][4], uint64_t da, uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_R16
               ", %16, %17, p, 1, 1, 0, 0;\n}\n"
               : WG_D16
               : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64) (+)= A B: B the 16 x 64 MN-major slice at db (kTrans 1), or
// B^T with B the 64 x 16 K-major slice (kTrans 0); A (64 x 16) in registers,
// or the K-major slice at da
template <int kTrans>
__device__ __forceinline__ void wg_n64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db,
                                       int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
               ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
               : WG_D32
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(kTrans));
}
__device__ __forceinline__ void wg_n64(float (&d)[8][4], uint64_t da, uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"
               : WG_D32
               : "l"(da), "l"(db), "r"(acc));
}

#define WG_D64                                                                             \
  WG_D32, "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]),       \
      "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]),         \
      "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]),      \
      "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),      \
      "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]),      \
      "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]),      \
      "+f"(d[15][2]), "+f"(d[15][3])
#define WG_R64                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "   \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "   \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128) (+)= A B^T, A the 64 x 16 K-major slice at da and B the
// 128 x 16 K-major slice at db (128 rows, 1024 bytes between groups of 8)
__device__ __forceinline__ void wg_n128(float (&d)[16][4], uint64_t da, uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
               ", %64, %65, p, 1, 1, 0, 0;\n}\n"
               : WG_D64
               : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ---- mbarriers and TMA ------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// the barriers' initialisation made visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// this thread's arrival, and bytes more for the phase to wait for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of the given parity has completed (a fresh barrier
// is in phase 0: parity 1 passes at once, parity 0 waits for the first phase)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done)
                 : "r"(smem_u32(bar)), "r"(parity)
                 : "memory");
  } while (!done);
}

// a 4-D box of the tensor map at tmap (a __grid_constant__ kernel parameter)
// at coordinates (c0, c1, c2, c3), innermost first, into shared memory at
// dst; its bytes complete the transaction of bar. Coordinates past the
// tensor's extent read zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* tmap, uint64_t* bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// a warpgroup's threads (128) at named barrier id (1..15; 0 is __syncthreads)
__device__ __forceinline__ void wg_bar_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
