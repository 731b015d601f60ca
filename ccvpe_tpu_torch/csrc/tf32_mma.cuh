// Primitives shared by the port's kernels (lmu.cu, lmu_bf16.cu, corr.cu),
// for sm_90a: asynchronous copies into shared memory (cp.async), the 3xTF32
// tensor-core product on the warp-level mma.sync.m16n8k8 TF32 tile, and the
// bf16 product on mma.sync.m16n8k16 with its ldmatrix loads. csrc/build.py
// hashes every csrc/*.cuh with each source, so a change here rebuilds every
// library.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// --- asynchronous copies into shared memory (cp.async) -------------------

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, cached in L2 only (weights, read by every block)
__device__ inline void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// 16 bytes, or 16 zero bytes when !valid (src is then not read), cached in
// L2 only
__device__ inline void cp_async16_zfill(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// 4 bytes, or 4 zero bytes when !valid (src is then not read)
__device__ inline void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

// Closes this thread's copies issued since the last commit into one group.
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits until at most N of this thread's groups are still in flight; a
// barrier after it makes every thread's copies visible to the block.
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The same for N in {0, 1, 2} known only at run time.
__device__ inline void cp_async_wait_upto(int n) {
  if (n >= 2) cp_async_wait<2>(); else if (n == 1) cp_async_wait<1>(); else cp_async_wait<0>();
}

// --- the 3xTF32 tensor-core product -------------------------------------
//
// One warp, one mma.sync.m16n8k8 TF32 tile: D (16 x 8) += A (16 x 8) B (8 x 8).
// Lane l holds, with g = l / 4 and q = l % 4 (PTX ISA, "Matrix fragments
// for mma.m16n8k8" with .tf32): A (m, k) at a[0] (g, q), a[1] (g+8, q),
// a[2] (g, q+4), a[3] (g+8, q+4); B (k, n) at b[0] (q, g), b[1] (q+4, g);
// D (m, n) at d[0] (g, 2q), d[1] (g, 2q+1), d[2] (g+8, 2q), d[3] (g+8, 2q+1).
__device__ inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// v (finite) rounded to TF32 as cvt.rna.tf32.f32 rounds it, nearest with
// ties away from zero, on the bits: add half a unit of the 10-bit mantissa
// to the magnitude, clear the 13 bits below it. sm_90 has no instruction
// for cvt.rna; ptxas emulates it with this add and mask plus a guard for
// inf and NaN, twice the instructions of a split, and the weight gradients
// are bound by the instructions around their products.
__device__ inline uint32_t rna_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo + O(2^-22 |v|): hi = tf32(v), lo = tf32(v - hi), both rounded
// as rna_tf32 (ops/tf32.py::split_tf32 is the same). v - hi is exact.
__device__ inline void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(v);
  lo = rna_tf32(v - __uint_as_float(hi));
}

// One k-step of 8 of the 3xTF32 product, for MT tiles of 16 rows by NT
// tiles of 8 columns: acc[i][j] += A_i (16 x 8) B_j (8 x 8), where a[i][]
// is this lane's fragment of A_i as float32 values (a(g, q), a(g+8, q),
// a(g, q+4), a(g+8, q+4), zero where the step runs past K) and bv(j, h)
// returns B_j (q + 4h, g). Each A fragment is split once for all NT tiles
// and each B fragment once for all MT; each (i, j) runs three TF32
// products, lo*hi + hi*lo and then hi*hi, into float32 accumulators: the
// product dropped, lo*lo, is ~2^-22 of |a b|, so the result is
// float32-accurate, where one TF32 product alone keeps ~3 decimal digits.
// Each entry of acc gets the same sequence of products whatever its tile,
// row or column, so its sum is a function of its own row of A and column
// of B alone.
// kOne: every operand is a bf16 value (8 significant bits), which is its
// own TF32 hi with lo = 0, so the two lo products are exact zeros: one
// hi*hi product gives the same sums, with no split.
template <int MT, int NT, bool kOne = false, class BV>
__device__ inline void mma_3xtf32_step(const float (&a)[MT][4], BV bv, float (&acc)[MT][NT][4]) {
  uint32_t ah[MT][4], al[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kOne)
        ah[i][e] = __float_as_uint(a[i][e]);
      else
        split_tf32(a[i][e], ah[i][e], al[i][e]);
    }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t bh[2], bl[2];
    if (kOne) {
      bh[0] = __float_as_uint(bv(j, 0));
      bh[1] = __float_as_uint(bv(j, 1));
    } else {
      split_tf32(bv(j, 0), bh[0], bl[0]);
      split_tf32(bv(j, 1), bh[1], bl[1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (!kOne) {
        mma_tf32(acc[i][j], al[i], bh);
        mma_tf32(acc[i][j], ah[i], bl);
      }
      mma_tf32(acc[i][j], ah[i], bh);
    }
  }
}

// acc[j], this lane's part of the 16 x 8 tile of A B at (m0, n0 + 8j), for
// j < NT: += sum over k < K of a(m, k) * b(k, n), with A [M][K] and B [K][N]
// read through the functors a and b and zero outside those bounds (so M, N
// and K need not be multiples of 16, 8 and 8), in k-steps of 8 through
// mma_3xtf32_step. The order of the sums is fixed, so two calls give the
// same bits. No branch depends on the data or the shape inside, so the
// compiler can overlap one tile's loads with another's products. kOne as
// in mma_3xtf32_step.
template <int NT, bool kOne = false, class A, class B>
__device__ void mma_3xtf32(A a, B b, int m0, int n0, int M, int N, int K, float (&acc)[NT][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int m_lo = m0 + g, m_hi = m0 + g + 8;
  const bool in_lo = m_lo < M, in_hi = m_hi < M;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    const int k1 = k0 + q, k2 = k0 + q + 4;
    const bool in1 = k1 < K, in2 = k2 < K;
    const float av[1][4] = {{in_lo && in1 ? a(m_lo, k1) : 0.f, in_hi && in1 ? a(m_hi, k1) : 0.f,
                             in_lo && in2 ? a(m_lo, k2) : 0.f, in_hi && in2 ? a(m_hi, k2) : 0.f}};
    mma_3xtf32_step<1, NT, kOne>(av, [&](int j, int h) {
      const int n = n0 + 8 * j + g, k = h ? k2 : k1;
      return n < N && (h ? in2 : in1) ? b(k, n) : 0.f;
    }, reinterpret_cast<float (&)[1][NT][4]>(acc));
  }
}

// (m, n) of acc[j], this lane's j-th entry of the 16 x 8 tile at (m0, n0).
__device__ inline int2 mma_entry(int j, int m0, int n0) {
  const int lane = threadIdx.x % 32;
  return make_int2(m0 + lane / 4 + (j / 2) * 8, n0 + 2 * (lane % 4) + j % 2);
}

// --- the bf16 product (lmu_bf16.cu) ---------------------------------------
// One warp: D (16 x 8, float32) += A (16 x 16, bf16) B (16 x 8, bf16). Lane
// l holds, with g = l / 4 and q = l % 4 (PTX ISA, "Matrix fragments for
// mma.m16n8k16" with .bf16), two bf16 values a register, the lower one
// first: A (m, k) at a[0] (g, 2q..2q+1), a[1] (g+8, 2q..2q+1), a[2]
// (g, 2q+8..2q+9), a[3] (g+8, 2q+8..2q+9); B (k, n) at b[0] (2q..2q+1, g),
// b[1] (2q+8..2q+9, g); D as the m16n8k8 tile's: d[0] (g, 2q), d[1] (g, 2q+1),
// d[2] (g+8, 2q), d[3] (g+8, 2q+1). Each product of two bf16 values is
// exact in float32; the sixteen of a k-step and the accumulator are summed
// by the tensor core in an order of its own, the same for every call.
__device__ inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ldmatrix: four (x4) or two (x2) 8 x 8 matrices of 16-bit values from
// shared memory. Lane i gives the address of row i % 8 of matrix i / 8 (x2:
// lanes 0-15 only), 16 contiguous bytes, 16-byte aligned; register j of lane
// l receives matrix j's row l / 4, columns 2(l % 4) and 2(l % 4) + 1. With
// .trans the matrix arrives transposed: register j receives matrix j's
// rows 2(l % 4) and 2(l % 4) + 1 at column l / 4.
//
// So for A [16 x 16] stored row by row (a pixel's channels contiguous, M =
// pixels, K = channels), lane i points at row i % 16, column 8 (i / 16): x4
// gives a[0..3] above. For A stored column by column (M = channels, K =
// pixels: the weight gradients), lane i points at stored row (pixel)
// 8 (i / 16) + i % 8, column (channel) 8 ((i / 8) % 2): x4.trans gives
// a[0..3]. For B [16 x 8] stored row by row (a row of K holds N contiguous:
// the weights [tap][K][N], or dy's pixel rows in the weight gradients), lane
// i points at row i % 16, column 8 (i / 16): x4.trans gives b[0..1] of two
// neighbouring n-tiles (registers 0, 1 the first, 2, 3 the second), x2.trans
// b[0..1] of one.
__device__ inline void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ inline void ldsm_x4_trans(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ inline void ldsm_x2_trans(uint32_t (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// B fragments of nt <= MAXNT neighbouring n-tiles: b[j] from the rows this
// lane points at (row_addr: row i % 16 of the K step, column n0), n-tile j at
// row_addr + 16 j bytes (8 bf16 columns on). Pairs by x4.trans, an odd last
// tile by x2.trans (which reads lanes 0-15's addresses only); b[j] for j >=
// nt is left as it is. nt is the same for the whole warp.
template <int MAXNT>
__device__ __forceinline__ void load_b_frags(uint32_t (&b)[MAXNT][2], int nt, unsigned row_addr) {
  const unsigned half = (threadIdx.x % 32 / 16) * 16;   // lanes 16-31: the pair's second tile
#pragma unroll
  for (int j = 0; j < MAXNT; j += 2) {
    if (j + 1 < nt) {
      uint32_t r[4];
      ldsm_x4_trans(r, row_addr + 16 * j + half);
      b[j][0] = r[0];
      b[j][1] = r[1];
      b[j + 1][0] = r[2];
      b[j + 1][1] = r[3];
    } else if (j < nt) {
      ldsm_x2_trans(b[j], row_addr + 16 * j);
    }
  }
}

}  // namespace
