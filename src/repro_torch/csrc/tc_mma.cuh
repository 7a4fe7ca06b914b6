// Tensor-core building blocks shared by flash_attention.cu,
// flash_attention_bwd.cu and ssd_scan.cu: cp.async copies into shared memory,
// ldmatrix fragment loads, the warp-level mma.sync.m16n8k16 bf16 product with
// float32 accumulators and two tile products built from it, and the
// mma.sync.m16n8k8 tf32 product with the split of a float32 into two tf32
// halves that keeps a product at float32 accuracy (3xTF32, mma3). Each including source
// is compiled on its own (kernels/_build.py hashes this header into every
// library's name, so an edit rebuilds them).
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-fills when !ok (src must
// still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Fragment addressing, for a tile stored row-major in shared memory with a
// row stride of ST elements (lane = this thread's lane):
//  A operand (16x16 at row r0, col c0):       ldsm_x4(at(r0 + (lane & 15), c0 + (lane >> 4) * 8))
//  B operand, stored [n][k] (two n-blocks of 8 at n0, k-step at k0):
//      ldsm_x4(at(n0 + (lane & 7) + (lane >> 4) * 8, k0 + ((lane >> 3) & 1) * 8))
//      -> {r0, r1} for n0, {r2, r3} for n0 + 8
//  B operand, stored [k][n] (the same, transposed on load):
//      ldsm_x4_t(at(k0 + (lane & 7) + ((lane >> 3) & 1) * 8, n0 + (lane >> 4) * 8))
//  C/D: thread holds rows lane/4 (d[0], d[1]) and lane/4 + 8 (d[2], d[3]),
//  cols 2*(lane%4) and +1; two n-blocks of C form one A k-step.
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int bn_row(int lane) { return (lane & 7) + (lane >> 4) * 8; }
__device__ __forceinline__ int bn_col(int lane) { return ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int bt_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int bt_col(int lane) { return (lane >> 4) * 8; }

// acc (16 x 8*NB, a warp's) += A B^T: A the 16 x HD rows at sa, B the
// 8*NB x HD rows at sb, both row-major with stride ST
template <int HD, int NB, int ST>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4], const __nv_bfloat16* sa,
                                        const __nv_bfloat16* sb, int lane) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, sa + a_row(lane) * ST + kk * 16 + a_col(lane));
#pragma unroll
    for (int n = 0; n < NB; n += 2) {
      uint32_t bb[4];
      ldsm_x4(bb, sb + (n * 8 + bn_row(lane)) * ST + kk * 16 + bn_col(lane));
      mma16816(acc[n], a, bb[0], bb[1]);
      mma16816(acc[n + 1], a, bb[2], bb[3]);
    }
  }
}

// acc (16 x HD, a warp's) += A B: A one 16 x 16 k-step in registers, B the
// 16 x HD rows at sb, row-major with stride ST
template <int HD, int ST>
__device__ __forceinline__ void mma_ab(float (&acc)[HD / 8][4], const uint32_t (&a)[4],
                                       const __nv_bfloat16* sb, int lane) {
#pragma unroll
  for (int n = 0; n < HD / 8; n += 2) {
    uint32_t bb[4];
    ldsm_x4_t(bb, sb + bt_row(lane) * ST + n * 8 + bt_col(lane));
    mma16816(acc[n], a, bb[0], bb[1]);
    mma16816(acc[n + 1], a, bb[2], bb[3]);
  }
}

// d += a (16x8, row) * b (8x8, col), tf32 in, float32 accumulators. Fragments
// (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g); d as for m16n8k16.
__device__ __forceinline__ void mma1688_tf32(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  // not volatile: no side effects, so the compiler may interleave products
  // of independent accumulators
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x rounded to tf32 as cvt.rna.tf32.f32 rounds a finite x (to nearest, ties
// away from zero), by bit masking: half of the 13 dropped bits' range added
// to the pattern, then the 13 bits cleared. Two integer operations; with
// cvt.rna in their place the float32 flash kernel took 0.0454 ms instead of
// 0.0345 ms on an H100, at q (1,333,16,64).
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to ~22 bits, both tf32 (round to nearest): a product of two
// such sums taken as lo*hi + hi*lo + hi*hi (the lo*lo term, ~2^-22 of it,
// dropped) keeps float32 accuracy on the tensor cores
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - __uint_as_float(hi));
}

// d[j] += a b[j] in split-TF32: lo*hi + hi*lo + hi*hi, the small terms
// first, each term a pass over the NT independent accumulators so that no
// product waits on the one before it
template <int NT>
__device__ __forceinline__ void mma3(float (&d)[NT][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[NT][2],
                                     const uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) mma1688_tf32(d[j], al, bh[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma1688_tf32(d[j], ah, bl[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma1688_tf32(d[j], ah, bh[j]);
}
