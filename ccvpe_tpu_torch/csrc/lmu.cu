// Fused LMU decoder stage for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernels ccvpe_tpu/ops/lmu_pallas.py::
// _fused_stage_kernel (:264, pallas_call at :385, launched by fused_stage
// :314) and ::_fused_stage_bwd_kernel (:404, pallas_call at :628, launched
// by fused_stage_bwd_pallas :515). One stage is
//
//   h = deconv2x2(x) + bd          (zero outside the fine image)
//   a = conv3x3([h | skip], w1) + b1,  g = relu(a)   (zero outside)
//   y = conv3x3(g, w2) + b2
//
// x [B,Hc,Wc,Cin], skip [B,2Hc,2Wc,Cs] or none, y [B,2Hc,2Wc,Cout], all
// NHWC, contiguous and float32, as are the backward's dy, dx and dskip
// (the stage on bf16 activations is csrc/lmu_bf16.cu; see "The activations'
// type" below). Weights in the kernel's layouts, made by the
// wrapper (ops/lmu_cuda.py) from torch's: wd [4][Cin][Cd] (phase di*2+dj),
// w1 [9][Cd+Cs][C1], w2 [9][C1][Cout] (tap ky*3+kx); the backward also
// takes the flipped-transposed w2T [9][Cout][C1], w1T [9][C1][Cd+Cs] and
// wdT [4][Cd][Cin]. Each operand's last dimension is padded with zeros to
// pad_co columns (16-byte aligned), so that the kernels copy it into
// shared memory as one flat run of 16-byte cp.async transfers.
//
// What bounds it on an H100: operations. In float32 with no tensor cores a
// VIGOR stage does ~75,600 flop per fine pixel forward (conv_a 9*56*40*2,
// conv_b 9*40*40*2, deconv 81*40*2 at loc stage 5) for ~450 bytes of input
// and output, ~170 flop per byte against the card's 20 (67 TFLOP/s over
// 3.35 TB/s); the backward does about 2.5 times the forward's work.
//
// What the design does about it: only x, skip and y (forward) or x, skip,
// dy, dx and dskip (backward) touch device memory; the fine intermediates h
// and g and their gradients live in shared memory as channel planes (see
// plane_stride for their spacing). One block owns a T x T fine output tile
// (T even) and recomputes h on (T+4)^2 and g on (T+2)^2 pixels around it, so
// borders are the convs' zero padding, not deconv(0)+bias: every value
// outside the image is stored as 0. Planes and weights reach shared memory
// by cp.async (no register round trip, every copy of a phase in flight at
// once). The backward's five weight operands stay resident where they fit
// beside the planes (the heads), else stream through two buffers (each
// copy issued as soon as its buffer's last reader has passed a barrier, so
// it overlaps the work before its first reader) or, where only one fits
// (VIGOR's loc stage 5), through one (the copies before dh and dx still
// overlap the weight gradients); see ccvpe_lmu_bwd_plan.
//
// Two kinds of product carry the arithmetic. The tensor cores take the
// convs: the deconv and conv_a (in B2 and in B3's recompute of h and g),
// B2's conv_b where Cout >= 5, and B3's da, dh|dskip and dx but the heads'
// da and dh|dskip, as implicit GEMMs (tile_conv_tc_nt: M = the box's
// pixels, N = output channels, K = tap by input channel; dx's taps are
// dh's four deconv phases, read at step 2),
// and B3's three weight gradients (tile_wgrad: dw2, dw1, dwd, products over
// a tile's pixels). Both go through mma_3xtf32_step (tf32_mma.cuh), one
// warp-level m16n8k8 TF32 mma.sync primitive: each float32 operand is split
// into two TF32 values and three products are summed in float32, so the
// results stay float32-accurate. On the CUDA cores (67 TFLOP/s) the convs
// were the kernels' largest cost; the tensor cores give that arithmetic
// several times the rate even at three products for each float32 one. A
// conv item splits its A fragments (activations) once for up to five
// n-tiles and its B fragments (weights) once for its m-tiles (kFwdMTiles,
// kBwdMTiles); each tap sums in fresh accumulators, because a tensor-core
// accumulate truncates and a chain of hundreds of products drifts by
// several float32 ulps. Weights are read as B straight from the operand's
// layout (B3's transposed operands w2T, w1T and wdT lie as [tap][K][N]
// too), activations as A from the planes, so no shared-memory layout
// changed with them. What bounds the convs is the instructions around the
// products (loads, four integer and float ops a split) and their latency
// with 4 warps or fewer on each of an SM's four sub-partitions, not
// mma.sync's own rate (ops/lmu_cuda.py::mma_rate measures it). A conv's K
// order is fixed (tile_conv_tc_nt), so B2 at T = 16 and B3 at T = 8 compute
// the same bits of g, and B3's recomputed ReLU mask is B2's. The other
// convs are CUDA-core FMAs (tile_conv): the heads' conv_b and da (Cout 1 or
// 2: an n-tile or a k-step of 8 would be mostly empty) and dh|dskip (two
// n-tiles, faster on the FMAs); fwd_conv and bwd_tensor_core state the
// rules. Each thread keeps a PT-pixel x CT-channel register tile, loads CT
// weights as float4 broadcasts and PT activations per tap. The weight
// gradients are bound by
// the instructions around their products (loads, splits, addresses), not
// by the tensor cores. The backward's tile loop keeps little else in
// registers (its layouts arrive as kernel parameters, its plane strides
// are compile-time constants), so the 128 a thread has go to their
// accumulators. Warps take items in a rotation that continues across calls
// with no barrier between (the deconv's four phases, the weight gradients
// and the conv after them). ops/lmu_cuda.py::bwd_phase_cycles times the
// backward by phase.
//
// Backward sums: the TPU kernel adds weight gradients into one accumulator
// across its in-order grid. Here a fixed grid of blocks walks the tiles in
// a fixed order (tile = block + k * grid); each block adds its tiles'
// sums into its own slice of a partial buffer, and a second kernel adds the
// slices in block order. No float atomics anywhere, so two runs give the
// same bits. dx and dskip are owned by one tile each (the deconv has no
// overlap), so no two blocks write the same element.
//
// The activations' type E: the kernels are templates on it, and their
// branches for bf16 (act_round, load_planes' widening, mma_3xtf32_step's
// kOne) remain, though only float is instantiated: B2 and B3 on bf16
// activations are csrc/lmu_bf16.cu, built on bf16 planes and products.
// Taking those branches out changed how ptxas allocates the float32
// lmu_bwd_kernel's registers at T = 8 (its spills grew from 132/244 to
// 136/252 bytes stored/loaded), so they stay and the float32 SASS stays.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "tf32_mma.cuh"   // cp.async copies; mma_3xtf32, the 3xTF32 product

// Every kernel's dynamic shared memory. Device functions index it by int
// offsets where that keeps their inner loops on 32-bit shared addresses.
extern __shared__ __align__(16) float smem[];

namespace {

// Threads per block: 512 where the shared memory of a block leaves room
// for only one block on an SM (VIGOR stage 5: 16 warps instead of 8 hide
// more latency), 256 elsewhere (the heads fit two or three blocks; the
// backward asks for two, which caps it at 128 registers a thread; the
// forward for kFwdSmallBlocks).
constexpr int kSmallBlock = 256;
constexpr int kLargeBlock = 512;
// Blocks of 256 threads the forward asks an SM to hold: the VIGOR heads'
// shared memory (57.6 KB a block) fits three, and the cap of 85 registers
// a thread keeps them resident (left to itself, ptxas took more, two
// blocks fit, and the heads ran slower on the card).
constexpr int kFwdSmallBlocks = 3;

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
// Floats between two channel planes of side^2 pixels: the least >= side^2
// that is 4 times an odd number, so 8 neighbouring channels start in 8
// banks 4 apart. A TF32 fragment load (8 channels x 4 neighbouring pixels,
// mma_3xtf32 in tile_wgrad) then touches 32 different banks; the FMA
// convs read one channel at a time and do not depend on it. The
// tensor-core convs' A fragment is the other way round (4 channels x 8
// neighbouring pixels) and takes a 2-way bank conflict with this stride.
__host__ __device__ constexpr int plane_stride(int side) { return (side * side + 3) / 8 * 8 + 4; }
__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }
// padded output-channel count of a weight operand in shared memory
__host__ __device__ inline int pad_co(int c) { return c <= 4 ? 4 : (c + 7) / 8 * 8; }

using bf16 = __nv_bfloat16;

// The activations' type E in device memory: float, or bf16 (see "bf16
// stages" above). act_round is where a bf16 stage rounds a float32 value
// to bf16 (nearest even) and keeps it as a float32; a float32 stage keeps v.
template <class E>
__host__ __device__ constexpr bool is_bf16() { return sizeof(E) == 2; }

template <class E>
__device__ inline float act_round(float v) {
  return is_bf16<E>() ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ inline void act_store(float* p, float v) { *p = v; }
__device__ inline void act_store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// dst[c*ps + r*side + col] = src[b, y0+r, x0+col, c] inside the image, else
// 0: float32 as 4-byte cp.async copies (zero-filled outside; the caller
// commits), bf16 widened by a load and a store (done when the call returns).
// Element i = (r*side + col)*nc + c of the box, so neighbouring threads read
// neighbouring channels of a pixel; each thread steps its (c, col, r) by
// blockDim.x elements with adds and compares, no division per element.
template <class E>
__device__ void load_planes(float* dst, int ps, int side, const E* __restrict__ src,
                            int b, int h, int w, int nc, int y0, int x0) {
  const int n = side * side * nc;
  const int step_p = blockDim.x / nc, step_c = blockDim.x % nc;
  const int step_r = step_p / side, step_col = step_p % side;
  int c = threadIdx.x % nc, col = threadIdx.x / nc % side, r = threadIdx.x / nc / side;
  const E* img = src + static_cast<size_t>(b) * h * w * nc;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int gy = y0 + r, gx = x0 + col;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    float* d = dst + c * ps + r * side + col;
    const E* g = img + (static_cast<size_t>(gy) * w + gx) * nc + c;
    if constexpr (is_bf16<E>())
      *d = in ? __bfloat162float(*g) : 0.f;
    else
      cp_async4(d, in ? g : src, in);
    c += step_c;
    col += step_col;
    r += step_r;
    if (c >= nc) { c -= nc; ++col; }
    if (col >= side) { col -= side; ++r; }
  }
}

// dst[0, n) = src[0, n): n floats (a multiple of 4, both ends 16-byte
// aligned: an operand in the kernel's padded layout) as 16-byte cp.async
// copies, committed as one group.
__device__ void copy_weights(float* dst, const float* __restrict__ src, int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) cp_async16(dst + i, src + i);
  cp_async_commit();
}

// Input channel k of a conv: plane j of group g (k = g * per + j), at
// in + goff(g) + j * ps. The deconv and the 3x3 convs read one group of
// planes; dx reads dh's four deconv phases as four groups of Cd planes.
// The convs walk k in order as (g, j), with no division per channel.
struct OneGroup {
  __device__ int operator()(int) const { return 0; }
};

// out(r, c)[co] = sum over k < ng*per, ky, kx of
//   in[goff(k / per) + (k % per)*ps + (r*step + ky)*in_side + c*step + kx]
//   * w[((ky*KS + kx)*cin + k)*coutp + co]
// for r, c < out_side, each one fmaf chain from 0 in that order (k
// ascending, then ky, kx); epi(r, c, co, value) stores it. One warp item
// takes CT output channels of 32*PT pixels (pixel lane + 32*k), so weight
// loads are warp-wide broadcasts and activation loads hit 32 neighbouring
// pixels. Item i goes to warp (first + i) % warps, so that calls with no
// barrier between continue the rotation; returns first + its item count.
template <int KS, int PT, int CT, class Goff, class Epi>
__device__ int tile_conv_impl(const float* in, Goff goff, int ng, int per, int ps, int in_side,
                              int step, const float* w, int coutp, int out_side, int first,
                              Epi epi) {
  const int cin = ng * per;
  const int npos = out_side * out_side;
  const int nchunk = (npos + 32 * PT - 1) / (32 * PT);
  const int ncg = coutp / CT;
  const int items = nchunk * ncg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int it = (warp - first % nwarps + nwarps) % nwarps; it < items; it += nwarps) {
    const int cg = it % ncg, ch = it / ncg;
    const int co0 = cg * CT;
    int off[PT];
#pragma unroll
    for (int k = 0; k < PT; ++k) {
      int q = ch * 32 * PT + k * 32 + lane;
      if (q >= npos) q = 0;
      off[k] = (q / out_side) * step * in_side + (q % out_side) * step;
    }
    float acc[PT][CT];
#pragma unroll
    for (int k = 0; k < PT; ++k)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[k][j] = 0.f;
    for (int g = 0; g < ng; ++g) {
      const float* ig = in + goff(g);
      const float* wg = w + g * per * coutp + co0;
      // 1x1 taps: unrolled, so that the next channels' loads run ahead of the FMAs
#pragma unroll (KS == 1 ? 4 : 1)
      for (int ci = 0; ci < per; ++ci) {
        const float* ip = ig + ci * ps;
        const float* wp = wg + ci * coutp;
#pragma unroll
        for (int ky = 0; ky < KS; ++ky) {
#pragma unroll
          for (int kx = 0; kx < KS; ++kx) {
            const float* wt = wp + (ky * KS + kx) * cin * coutp;
            float wv[CT];
#pragma unroll
            for (int j = 0; j < CT; j += 4) {
              const float4 f = *reinterpret_cast<const float4*>(wt + j);
              wv[j] = f.x; wv[j + 1] = f.y; wv[j + 2] = f.z; wv[j + 3] = f.w;
            }
#pragma unroll
            for (int k = 0; k < PT; ++k) {
              const float v = ip[off[k] + ky * in_side + kx];
#pragma unroll
              for (int j = 0; j < CT; ++j) acc[k][j] = fmaf(v, wv[j], acc[k][j]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < PT; ++k) {
      const int q = ch * 32 * PT + k * 32 + lane;
      if (q >= npos) continue;
#pragma unroll
      for (int j = 0; j < CT; ++j) epi(q / out_side, q % out_side, co0 + j, acc[k][j]);
    }
  }
  return first + items;
}

// Picks the register tile: CT = 8 when the padded channel count allows it,
// and the largest PT that still gives every warp a work item. (Choosing by
// an estimate of issue cycles, which took CT = 4 or a larger PT where this
// rule leaves warps idle, was slower on the card.) The choice changes which
// warp computes an output, never its sum. Returns first + the item count,
// as tile_conv_impl.
template <int KS, class Goff, class Epi>
__device__ int tile_conv(const float* in, Goff goff, int ng, int per, int ps, int in_side,
                         int step, const float* w, int cout, int out_side, int first, Epi epi) {
  const int coutp = pad_co(cout);
  const int npos = out_side * out_side;
  auto guarded = [&](int r, int c, int co, float v) {
    if (co < cout) epi(r, c, co, v);
  };
  const int nwarps = blockDim.x / 32;
#define CCVPE_CONV(PT, CT) \
  tile_conv_impl<KS, PT, CT>(in, goff, ng, per, ps, in_side, step, w, coutp, out_side, first, guarded)
  if (coutp % 8 == 0) {
    const int ncg = coutp / 8;
    if ((npos + 127) / 128 * ncg >= nwarps) return CCVPE_CONV(4, 8);
    if ((npos + 63) / 64 * ncg >= nwarps) return CCVPE_CONV(2, 8);
    return CCVPE_CONV(1, 8);
  }
  if ((npos + 127) / 128 >= nwarps) return CCVPE_CONV(4, 4);
  return CCVPE_CONV(2, 4);
#undef CCVPE_CONV
}

// Output tiles of 8 columns that one warp item covers for N columns: the
// A fragment (4 values a lane, split into 8 TF32 values) is loaded once for
// all of them. The largest of 5, 4, 2 and 1 that divides the tile count,
// so that no item holds a tile past N (5 takes the VIGOR stages' 40 output
// channels in one item). The tensor-core convs take the same count: per
// k-step an item loads and splits 4 A values per m-tile and 2 B values
// per n-tile for 3 products each, so wide items issue the fewest
// instructions per product (items of one n-tile ran much slower on the
// card).
__host__ __device__ inline int wgrad_tiles(int n) {
  const int tiles = (n + 7) / 8;
  return tiles % 5 == 0 ? 5 : tiles % 4 == 0 ? 4 : tiles % 2 == 0 ? 2 : 1;
}

// One k-step of 8 input channels from k0 of a tensor-core conv item:
// part += the products of this lane's pixels (plane offsets a_off, tap
// included) and weight rows from w_off (this lane's column, tap included).
// TAIL: the last, ragged step, zero past cin (the weight row is clamped
// there; its product with the zero is 0). ONE: bf16 operands, one TF32
// product (mma_3xtf32_step's kOne).
template <int MT, int NT, bool TAIL, bool ONE>
__device__ __forceinline__ void conv_tc_step(const int (&a_off)[MT][2], int w_off, int k0,
                                             int cin, int ps, int coutp,
                                             float (&part)[MT][NT][4]) {
  const int q = threadIdx.x % 4;
  const int k1 = k0 + q, k2 = k0 + q + 4;
  const bool in1 = !TAIL || k1 < cin, in2 = !TAIL || k2 < cin;
  float av[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    av[i][0] = in1 ? smem[a_off[i][0] + k1 * ps] : 0.f;
    av[i][1] = in1 ? smem[a_off[i][1] + k1 * ps] : 0.f;
    av[i][2] = in2 ? smem[a_off[i][0] + k2 * ps] : 0.f;
    av[i][3] = in2 ? smem[a_off[i][1] + k2 * ps] : 0.f;
  }
  const int b1 = w_off + (TAIL ? imin(k1, cin - 1) : k1) * coutp;
  const int b2 = w_off + (TAIL ? imin(k2, cin - 1) : k2) * coutp;
  mma_3xtf32_step<MT, NT, ONE>(av, [&](int j, int h) { return smem[(h ? b2 : b1) + 8 * j]; },
                               part);
}

// Tap offsets of a KS x KS conv over planes of side `side`, tap ky*KS + kx:
// the input pixel of tap (ky, kx) lies ky rows and kx columns from the
// output pixel's corner.
template <int KS>
struct SquareTaps {
  int side;
  __device__ int operator()(int tap) const { return tap / KS * side + tap % KS; }
};

// The function of tile_conv for one group of planes per tap,
//   out(r, c)[co] = sum over tap < NTAP, k < cin of
//     in[k*ps + (r*step)*in_side + c*step + taps(tap)] * w[(tap*cin + k)*coutp + co],
// on the tensor cores, as an implicit GEMM: M = the out_side^2 output
// pixels of the box (row r*out_side + c), N = cout, K = (tap, input
// channel). A 3x3 conv's taps are SquareTaps<3>; dx's are dh's four deconv
// phases, read at step 2. B is the weight operand as it lies in shared
// memory, A is read from the planes at each lane's two pixels (a pixel row
// past the box reads pixel 0 and is not stored). The K order is fixed: tap
// by tap, and within a tap k-steps of 8 channels (conv_tc_step) summed in
// fresh accumulators, which are added to the item's in tap order. So an
// output's sum depends on its own inputs alone, never on T, on the m-tile
// or fragment row it lands in, or on the warp: the forward (T = 16) and the
// backward's recompute (T = 8) give the same bits of h and g, and so the
// same ReLU mask. One warp item is MT m-tiles of 16 pixels by NT n-tiles of
// 8 channels (each A fragment split once for the NT n-tiles, each B
// fragment once for the MT m-tiles). Where NT does not divide the n-tiles
// (the backward's n-grouping, bwd_conv_tiles), the last group is ragged:
// it starts NT tiles before the end instead, computes the tiles it shares
// with the group before again and stores only its own, so every B read
// lies inside the operand (an output column depends on its own B column
// alone, so the repeated tiles cannot touch the kept ones). Item i goes to
// warp (first + i) % warps, as in tile_conv_impl; returns first + its item
// count. ONE as in conv_tc_step.
template <int NTAP, int MT, int NT, bool ONE, class Taps, class Epi>
__device__ int tile_conv_tc_nt(const float* in, int cin, int ps, int in_side, int step, Taps taps,
                               const float* w, int cout, int out_side, int first, Epi epi) {
  const int coutp = pad_co(cout);
  const int npos = out_side * out_side;
  const int ntiles = (cout + 7) / 8;
  const int nng = (ntiles + NT - 1) / NT;
  const int items = (npos + 16 * MT - 1) / (16 * MT) * nng;
  const int g = threadIdx.x % 32 / 4;
  const int nwarps = blockDim.x / 32;
  const int in0 = static_cast<int>(in - smem), w0 = static_cast<int>(w - smem);
  for (int it = (threadIdx.x / 32 - first % nwarps + nwarps) % nwarps; it < items; it += nwarps) {
    const int n_own = it % nng * 8 * NT, m0 = it / nng * 16 * MT;
    const int n0 = imin(n_own, (ntiles - NT) * 8);   // a ragged last group starts earlier
    int px[MT][2];   // this lane's two pixels (rows g, g + 8) of each m-tile, as plane offsets
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = m0 + 16 * i + g + 8 * r < npos ? m0 + 16 * i + g + 8 * r : 0;
        px[i][r] = in0 + p / out_side * step * in_side + p % out_side * step;
      }
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int tap = 0; tap < NTAP; ++tap) {
      const int toff = taps(tap);
      int a_off[MT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) a_off[i][r] = px[i][r] + toff;
      const int w_off = w0 + tap * cin * coutp + n0 + g;
      // each tap sums in fresh accumulators, added to acc in tap order: a
      // tensor-core accumulate truncates, so long chains drift
      float part[MT][NT][4] = {};
      int k0 = 0;
      for (; k0 + 8 <= cin; k0 += 8)
        conv_tc_step<MT, NT, false, ONE>(a_off, w_off, k0, cin, ps, coutp, part);
      if (k0 < cin) conv_tc_step<MT, NT, true, ONE>(a_off, w_off, k0, cin, ps, coutp, part);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int2 mn = mma_entry(e, m0 + 16 * i, n0 + 8 * j);
          if (mn.x < npos && mn.y >= n_own && mn.y < cout)
            epi(mn.x / out_side, mn.x % out_side, mn.y, acc[i][j][e]);
        }
  }
  return first + items;
}

// A KS x KS conv of the forward's on the tensor cores: tile_conv_tc_nt with
// NT = wgrad_tiles(cout) n-tiles an item, which divides the tile count.
template <int KS, int MT, bool ONE, class Epi>
__device__ int tile_conv_tc(const float* in, int cin, int ps, int in_side, const float* w,
                            int cout, int out_side, int first, Epi epi) {
#define CCVPE_CONV_TC(NT)                                                                \
  tile_conv_tc_nt<KS * KS, MT, NT, ONE>(in, cin, ps, in_side, 1, SquareTaps<KS>{in_side}, w, \
                                        cout, out_side, first, epi)
  switch (wgrad_tiles(cout)) {
    case 5: return CCVPE_CONV_TC(5);
    case 4: return CCVPE_CONV_TC(4);
    case 2: return CCVPE_CONV_TC(2);
    default: return CCVPE_CONV_TC(1);
  }
#undef CCVPE_CONV_TC
}

// m-tiles of 16 pixels in one warp item of a tensor-core conv: two in the
// forward, where each B fragment (weights) split once then serves 32
// pixels, one in the backward, whose T = 8 boxes hold 7 (conv_a, da), 4
// (dh|dskip), 3 (each deconv phase) or 1 (dx) m-tiles, too few items of two
// for 16 warps. A choice of who computes an output, never of its sum, so
// the recomputed g stays B2's. (Timed on the card: two made the forward
// faster at every VIGOR call and the backward slower at stage 5.)
constexpr int kFwdMTiles = 2;
constexpr int kBwdMTiles = 1;

// The forward's convs: the deconv and conv_a (B2's, and B3's recompute of
// h and g through deconv_tile and conv_a_tile) and B2's conv_b. The route
// is a rule of the shape alone, the same in both kernels (mirrored by
// ops/lmu_cuda.py::tensor_core_conv): the tensor cores where the padded
// output count is a multiple of 8 (cout >= 5: every VIGOR and KITTI conv
// but the heads' conv_b, Cout 1 or 2, where an n-tile of 8 would be mostly
// empty), else the FMA tile_conv. An item takes wgrad_tiles(cout) n-tiles,
// which divides the tile count. B3's own convs route by bwd_tensor_core.
// ONE as in conv_tc_step.
template <int KS, int MT, bool ONE, class Epi>
__device__ int fwd_conv(const float* in, int cin, int ps, int in_side, const float* w, int cout,
                        int out_side, int first, Epi epi) {
  if (pad_co(cout) % 8 == 0)
    return tile_conv_tc<KS, MT, ONE>(in, cin, ps, in_side, w, cout, out_side, first, epi);
  return tile_conv<KS>(in, OneGroup{}, 1, cin, ps, in_side, 1, w, cout, out_side, first, epi);
}

// B3's own convs, da, dh|dskip and dx: a conv with n output channels and
// k input channels a tap takes the tensor cores where n spans at least 3
// n-tiles and k pads to a multiple of 8 (k >= 5), else the FMA tile_conv.
// The heads' da (k = Cout, 1 or 2) would fill a k-step of 8 with zeros;
// their dh|dskip (n = 16, two n-tiles) ran slower on the tensor cores than
// on the FMAs when timed on the card, their dx (n = 41 or 32) faster. A
// rule of the shape alone, the same for every tile (mirrored by
// ops/lmu_cuda.py::bwd_tensor_core_conv).
__host__ __device__ inline bool bwd_tensor_core(int n, int k) {
  return pad_co(n) >= 24 && pad_co(k) % 8 == 0;
}

// n-tiles of 8 output channels in one warp item of a backward conv whose
// box holds `mtiles` m-tiles: 4, else 2, the wider that still gives the
// conv at least kBwdConvItems items (more than half of a 512-thread
// block's 16 warps), else 1. Where the group does not divide the tile count
// the last group is ragged (tile_conv_tc_nt), so no divisor is needed, and
// each call site compiles three tile_conv_tc_nt bodies, not four. The
// backward's boxes are small (at T = 8: 7 m-tiles for da, 4 for dh|dskip,
// 1 for dx), so a conv's time is that of a few items on a few warps: wide
// items leave warps idle, narrow ones split and load each A fragment for
// fewer products. A choice of who computes an output, never of its sum.
constexpr int kBwdConvItems = 9;

__host__ __device__ inline int bwd_conv_tiles(int n, int mtiles) {
  const int tiles = (n + 7) / 8;
  if (tiles >= 4 && mtiles * ((tiles + 3) / 4) >= kBwdConvItems) return 4;
  if (tiles >= 2 && mtiles * ((tiles + 1) / 2) >= kBwdConvItems) return 2;
  return 1;
}

// A backward conv on the tensor cores, NT = bwd_conv_tiles(cout, m-tiles
// of the box); the arguments are tile_conv_tc_nt's.
template <int NTAP, int MT, bool ONE, class Taps, class Epi>
__device__ int bwd_conv_tc(const float* in, int cin, int ps, int in_side, int step, Taps taps,
                           const float* w, int cout, int out_side, int first, Epi epi) {
#define CCVPE_CONV_TC(NT)                                                                    \
  tile_conv_tc_nt<NTAP, MT, NT, ONE>(in, cin, ps, in_side, step, taps, w, cout, out_side, first, \
                                     epi)
  switch (bwd_conv_tiles(cout, (out_side * out_side + 16 * MT - 1) / (16 * MT))) {
    case 4: return CCVPE_CONV_TC(4);
    case 2: return CCVPE_CONV_TC(2);
    default: return CCVPE_CONV_TC(1);
  }
#undef CCVPE_CONV_TC
}

template <int NTAP, int NB, int NT, bool ONE, class In, class G>
__device__ int tile_wgrad_nt(In in, G g, int cin, int cout, int first, float* __restrict__ part) {
  const int nmt = (cin + 15) / 16, nng = (cout + 8 * NT - 1) / (8 * NT);
  const int items = NTAP * nmt * nng;
  const int nwarps = blockDim.x / 32;
  for (int it = (threadIdx.x / 32 - first % nwarps + nwarps) % nwarps; it < items; it += nwarps) {
    const int n0 = it % nng * 8 * NT, rest = it / nng;
    const int m0 = rest % nmt * 16, tap = rest / nmt;
    float* dst = part + tap * cin * cout;
    float prev[NT][4], acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int2 mn = mma_entry(e, m0, n0 + 8 * j);
        prev[j][e] = mn.x < cin && mn.y < cout ? dst[mn.x * cout + mn.y] : 0.f;
        acc[j][e] = 0.f;
      }
    mma_3xtf32<NT, ONE>([=](int ci, int k) { return in(tap, ci, k); },
                   [=](int k, int co) { return g(tap, co, k); }, m0, n0, cin, cout, NB * NB, acc);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int2 mn = mma_entry(e, m0, n0 + 8 * j);
        if (mn.x < cin && mn.y < cout) dst[mn.x * cout + mn.y] = prev[j][e] + acc[j][e];
      }
  }
  return items;
}

// Weight gradients over an NB x NB pixel box for NTAP taps, as products
// with M = cin, N = cout and K = NB^2 pixels:
//   part[(tap*cin + ci)*cout + co] += sum_{k < NB^2} in(tap, ci, k) * g(tap, co, k)
// where in and g read the shared-memory planes (pixel k = row k / NB,
// column k % NB of the box). Each warp owns whole (tap, 16 input channels,
// wgrad_tiles(cout) x 8 output channels) items, sums their pixels in a
// fixed order on the tensor cores and adds the sums into its own entries of
// the block's partial slice with one float32 add each (no other thread
// writes them; a warp keeps the same items on every pixel box). It reads
// those entries before the product, so that their latency (the slice lives
// in L2 or device memory) hides behind it. (Accumulating onto the partial
// sums inside the product saves registers but adds each pixel's products
// to a large running sum in the tensor core's accumulator, and the weight
// gradients then lose more than an order of magnitude of accuracy.)
// Item i goes to warp (first + i) % warps, so that back-to-back calls
// continue where the last one stopped; returns first + its item count for
// the next call. ONE as in conv_tc_step.
template <int NTAP, int NB, bool ONE, class In, class G>
__device__ int tile_wgrad(In in, G g, int cin, int cout, int first, float* __restrict__ part) {
  switch (wgrad_tiles(cout)) {
    case 5: return first + tile_wgrad_nt<NTAP, NB, 5, ONE>(in, g, cin, cout, first, part);
    case 4: return first + tile_wgrad_nt<NTAP, NB, 4, ONE>(in, g, cin, cout, first, part);
    case 2: return first + tile_wgrad_nt<NTAP, NB, 2, ONE>(in, g, cin, cout, first, part);
    default: return first + tile_wgrad_nt<NTAP, NB, 1, ONE>(in, g, cin, cout, first, part);
  }
}

// part[co] += sum over the n x n box of g[co*g_ps + (r*g_step)*g_side + c*g_step + g_org]
__device__ void tile_bias_grad(const float* g, int g_ps, int g_side, int g_step, int g_org,
                               int cout, int n, float* __restrict__ part) {
  for (int co = threadIdx.x; co < cout; co += blockDim.x) {
    const float* gp = g + co * g_ps + g_org;
    float s = 0.f;
    for (int r = 0; r < n; ++r)
      for (int c = 0; c < n; ++c) s += gp[r * g_step * g_side + c * g_step];
    part[co] += s;
  }
}

// --- the per-phase timer (built only with -DCCVPE_LMU_PHASE_TIMER) --------
//
// The backward's tile loop in twelve phases, named in ops/lmu_cuda.py::
// BWD_PHASES. In the timed build each phase ends at a barrier, after which
// thread 0 reads clock64() and adds the cycles since the last mark to its
// phase's sum in shared memory (twelve 64-bit sums in registers pushed the
// timed kernel into spills that slowed every phase); the block's row of
// sums lands in g_phase_cycles[blockIdx.x] when its tiles are done. The
// build without the define holds no clock read and no extra barrier: mark()
// is empty there.
enum BwdPhase {
  kPhPlanes, kPhDeconv, kPhW1, kPhConvA, kPhW2t, kPhDa, kPhWgrad21, kPhW1t, kPhDh, kPhWdt,
  kPhDx, kPhWgradD, kBwdPhases
};

#ifdef CCVPE_LMU_PHASE_TIMER
__device__ unsigned long long* g_phase_cycles;   // [blocks][kBwdPhases], set by the host
__shared__ unsigned long long s_phase_cycles[kBwdPhases];   // the block's sums

struct PhaseTimer {
  long long last;
  __device__ PhaseTimer() : last(0) {
    if (threadIdx.x < kBwdPhases) s_phase_cycles[threadIdx.x] = 0;   // start()'s barrier follows
  }
  __device__ void start() {
    __syncthreads();
    if (threadIdx.x == 0) last = clock64();
  }
  __device__ void mark(int phase) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long now = clock64();
      s_phase_cycles[phase] += static_cast<unsigned long long>(now - last);
      last = now;
    }
  }
  __device__ void store() const {
    if (threadIdx.x != 0) return;
    for (int p = 0; p < kBwdPhases; ++p)
      g_phase_cycles[blockIdx.x * kBwdPhases + p] = s_phase_cycles[p];
  }
};
#else
struct PhaseTimer {
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void store() const {}
};
#endif

struct Dims {
  int b, hc, wc, cin, cs, cd, c1, cout;  // shapes; cs = 0 without skip
  int t;                                 // fine tile side, even
  int nty, ntx, ntiles;                  // tile grid
};

Dims make_dims(int b, int hc, int wc, int cin, int cs, int cd, int c1, int cout, int t) {
  Dims d{b, hc, wc, cin, cs, cd, c1, cout, t, 0, 0, 0};
  d.nty = (2 * hc + t - 1) / t;
  d.ntx = (2 * wc + t - 1) / t;
  d.ntiles = b * d.nty * d.ntx;
  return d;
}

// Shared memory of the forward, in floats: A holds h|skip planes on
// (T+4)^2, later w2; B the coarse x planes, later g on (T+2)^2; W wd, later w1.
struct FwdLayout { int a, b, w, total; };

__host__ __device__ FwdLayout fwd_layout(const Dims& d) {
  const int c = d.cd + d.cs, hs = d.t + 4, gs = d.t + 2, xs = hs / 2;
  const int a = imax(c * plane_stride(hs), 9 * d.c1 * pad_co(d.cout));
  const int b = imax(d.c1 * plane_stride(gs), d.cin * plane_stride(xs));
  const int w = imax(4 * d.cin * pad_co(d.cd), 9 * c * pad_co(d.c1));
  FwdLayout l;
  l.a = 0;
  l.b = round4(a);
  l.w = l.b + round4(b);
  l.total = l.w + round4(w);
  return l;
}

// The backward's weight operands in the order its tile loop reads them,
// and where they live: all five resident (copied once per block), two
// buffers in turn, or one buffer (ccvpe_lmu_bwd_plan picks).
enum WeightOp { kOpWd, kOpW1, kOpW2t, kOpW1t, kOpWdt, kWeightOps };
enum WeightMode { kStreamOne, kStreamTwo, kResident };

// Floats of a backward weight operand in the kernel's padded layout.
__host__ __device__ inline int bwd_weight_floats(const Dims& d, int op) {
  const int c = d.cd + d.cs;
  switch (op) {
    case kOpWd: return 4 * d.cin * pad_co(d.cd);
    case kOpW1: return 9 * c * pad_co(d.c1);
    case kOpW2t: return 9 * d.cout * pad_co(d.c1);
    case kOpW1t: return 9 * d.c1 * pad_co(c);
    default: return 4 * d.cd * pad_co(d.cin);
  }
}

// Shared memory of the backward, in floats: the planes hc = [h|skip] and
// dy on (T+4)^2, g and da on (T+2)^2, dh on T^2, the coarse x region, then
// the weights: w[op] for each operand when resident, else the buffers w[0]
// and w[1] (the same one in kStreamOne), each as large as the largest
// operand; then, `ahead`, second dy and x regions dy2 and x2, into which
// the next tile's planes are copied while this tile runs (else dy2 = dy,
// x2 = x).
struct BwdLayout { int hc, g, dy, da, x, dh, w[kWeightOps], dy2, x2, total; };

__host__ __device__ BwdLayout bwd_layout(const Dims& d, int mode, bool ahead) {
  const int c = d.cd + d.cs, hs = d.t + 4, gs = d.t + 2, xs = hs / 2;
  BwdLayout l;
  l.hc = 0;
  l.g = l.hc + round4(c * plane_stride(hs));
  l.dy = l.g + round4(d.c1 * plane_stride(gs));
  l.da = l.dy + round4(d.cout * plane_stride(hs));
  l.x = l.da + round4(d.c1 * plane_stride(gs));
  l.dh = l.x + round4(d.cin * plane_stride(xs));
  int end = l.dh + round4(d.cd * plane_stride(d.t));
  if (mode == kResident) {
    for (int op = 0; op < kWeightOps; ++op) {
      l.w[op] = end;
      end += round4(bwd_weight_floats(d, op));
    }
  } else {
    int wmax = 0;
    for (int op = 0; op < kWeightOps; ++op) wmax = imax(wmax, bwd_weight_floats(d, op));
    for (int op = 0; op < kWeightOps; ++op) l.w[op] = end;
    if (mode == kStreamTwo) l.w[1] = end + round4(wmax);
    end = l.w[1] + round4(wmax);
  }
  l.dy2 = l.dy;
  l.x2 = l.x;
  if (ahead) {
    l.dy2 = end;
    l.x2 = l.dy2 + round4(d.cout * plane_stride(hs));
    end = l.x2 + round4(d.cin * plane_stride(xs));
  }
  l.total = end;
  return l;
}

// One block's slice of the weight-gradient partials:
// dwd [4][Cin][Cd], dbd [Cd], dw1 [9][C][C1], db1 [C1], dw2 [9][C1][Cout], db2 [Cout].
struct PartLayout { int dwd, dbd, dw1, db1, dw2, db2, total; };

__host__ __device__ PartLayout part_layout(const Dims& d) {
  const int c = d.cd + d.cs;
  PartLayout p;
  p.dwd = 0;
  p.dbd = p.dwd + 4 * d.cin * d.cd;
  p.dw1 = p.dbd + d.cd;
  p.db1 = p.dw1 + 9 * c * d.c1;
  p.dw2 = p.db1 + d.c1;
  p.db2 = p.dw2 + 9 * d.c1 * d.cout;
  p.total = p.db2 + d.cout;
  return p;
}

__device__ void tile_origin(const Dims& d, int tile, int* b, int* ty0, int* tx0) {
  const int per = d.nty * d.ntx;
  *b = tile / per;
  const int rem = tile % per;
  *ty0 = (rem / d.ntx) * d.t;
  *tx0 = (rem % d.ntx) * d.t;
}

// h planes on the (T+4)^2 fine region at (fy0, fx0) = deconv of the coarse
// x planes (region side xs = hs/2 at (fy0/2, fx0/2)), one phase at a time
// so a warp's weights are one broadcast; 0 outside the image; a bf16 stage
// rounds h to bf16. The phases continue one warp rotation (no barrier
// between them); returns its end.
template <int MT, class E>
__device__ int deconv_tile(float* h, int hps, int hs, const float* xpl, int xps, int xs,
                           const float* wsm, const float* __restrict__ bd, int cin, int cd,
                           int img_h, int img_w, int fy0, int fx0) {
  const int cdp = pad_co(cd);
  int first = 0;
  for (int ph = 0; ph < 4; ++ph) {
    const int di = ph / 2, dj = ph % 2;
    first = fwd_conv<1, MT, is_bf16<E>()>(xpl, cin, xps, xs, wsm + ph * cin * cdp, cd, xs, first,
                                          [&](int r, int c, int co, float v) {
                                            const int rr = 2 * r + di, cc = 2 * c + dj;
                                            const int gy = fy0 + rr, gx = fx0 + cc;
                                            const bool in =
                                                gy >= 0 && gy < img_h && gx >= 0 && gx < img_w;
                                            h[co * hps + rr * hs + cc] =
                                                in ? act_round<E>(v + bd[co]) : 0.f;
                                          });
  }
  return first;
}

// g = relu(conv3x3(hc, w1) + b1) on the (T+2)^2 region at (gy0, gx0); 0
// outside; a bf16 stage rounds conv_a + b1 to bf16 before the ReLU.
template <int MT, class E>
__device__ void conv_a_tile(float* g, int gps, int gs, const float* hc, int hps, int hs,
                            const float* wsm, const float* __restrict__ b1, int c, int c1,
                            int img_h, int img_w, int gy0, int gx0) {
  fwd_conv<3, MT, is_bf16<E>()>(hc, c, hps, hs, wsm, c1, gs, 0,
                                [&](int r, int cc, int co, float v) {
                                  const int gy = gy0 + r, gx = gx0 + cc;
                                  const bool in = gy >= 0 && gy < img_h && gx >= 0 && gx < img_w;
                                  g[co * gps + r * gs + cc] =
                                      in ? fmaxf(act_round<E>(v + b1[co]), 0.f) : 0.f;
                                });
}

template <int kThreads, class E>
__global__ void __launch_bounds__(kThreads, kThreads == kSmallBlock ? kFwdSmallBlocks : 1)
lmu_fwd_kernel(Dims d, const E* __restrict__ x, const E* __restrict__ skip,
               const float* __restrict__ wd, const float* __restrict__ bd,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ w2, const float* __restrict__ b2,
               float* __restrict__ y) {
  const FwdLayout l = fwd_layout(d);
  float* sa = smem + l.a;
  float* sb = smem + l.b;
  float* sw = smem + l.w;
  const int c = d.cd + d.cs, hs = d.t + 4, gs = d.t + 2, xs = hs / 2;
  const int hps = plane_stride(hs), gps = plane_stride(gs), xps = plane_stride(xs);
  const int img_h = 2 * d.hc, img_w = 2 * d.wc;
  int b, ty0, tx0;
  tile_origin(d, blockIdx.x, &b, &ty0, &tx0);

  load_planes(sb, xps, xs, x, b, d.hc, d.wc, d.cin, ty0 / 2 - 1, tx0 / 2 - 1);
  if (d.cs) load_planes(sa + d.cd * hps, hps, hs, skip, b, img_h, img_w, d.cs, ty0 - 2, tx0 - 2);
  cp_async_commit();
  copy_weights(sw, wd, 4 * d.cin * pad_co(d.cd));
  cp_async_wait<0>();
  __syncthreads();
  deconv_tile<kFwdMTiles, E>(sa, hps, hs, sb, xps, xs, sw, bd, d.cin, d.cd, img_h, img_w,
                             ty0 - 2, tx0 - 2);
  __syncthreads();
  copy_weights(sw, w1, 9 * c * pad_co(d.c1));
  cp_async_wait<0>();
  __syncthreads();
  conv_a_tile<kFwdMTiles, E>(sb, gps, gs, sa, hps, hs, sw, b1, c, d.c1, img_h, img_w, ty0 - 1,
                             tx0 - 1);
  __syncthreads();
  copy_weights(sa, w2, 9 * d.c1 * pad_co(d.cout));
  cp_async_wait<0>();
  __syncthreads();
  const int cout = d.cout;
  fwd_conv<3, kFwdMTiles, is_bf16<E>()>(sb, d.c1, gps, gs, sa, cout, d.t, 0,
                                        [&](int r, int cc, int co, float v) {
                                          const int gy = ty0 + r, gx = tx0 + cc;
                                          if (gy < img_h && gx < img_w)
                                            y[((static_cast<size_t>(b) * img_h + gy) * img_w +
                                               gx) * cout + co] = v + b2[co];
                                        });
}

// T, the fine tile side, is d.t: a template argument, so that the weight
// gradients' pixel boxes (T x T, and T/2 x T/2 for the deconv) and the
// plane strides in their addresses are compile-time constants. `mode` is a
// WeightMode, the same for every block; l and pl are bwd_layout(d, mode,
// ahead) and part_layout(d), computed once on the host (as parameters they
// cost the tile loop no registers).
//
// One tile, phase by phase (BwdPhase names them; the timer's marks end
// each), and where the weight copies go in each mode:
//   planes + wd   the skip planes, and x and dy unless they were copied
//                 ahead (then the next tile's x and dy start copying into
//                 the other plane buffers); one buffer: wd's copy; two:
//                 w1's copy (its buffer's last reader was the previous dx)
//   deconv, conv_a, da, each after its operand's wait (w1, w2T load); two
//                 buffers: each wait first issues the copy after next
//   dw2..db1      one buffer: w1T's copy overlaps them; two: wdT's
//   w1T load, dh|dskip
//   dwd dbd       one buffer: wdT's copy overlaps them; two: the next
//                 tile's wd
//   wdT load, dx
// Resident, no tile waits for weights or marks a weight phase.
template <int kThreads, int T, class E>
__global__ void __launch_bounds__(kThreads, kLargeBlock / kThreads)
lmu_bwd_kernel(Dims d, int mode, BwdLayout l, PartLayout pl, const E* __restrict__ x,
               const E* __restrict__ skip,
               const E* __restrict__ dy, const float* __restrict__ wd,
               const float* __restrict__ bd, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2t,
               const float* __restrict__ w1t, const float* __restrict__ wdt,
               E* __restrict__ dx, E* __restrict__ dskip, float* __restrict__ part) {
  constexpr bool kOne = is_bf16<E>();
  float* s_hc = smem + l.hc;
  float* s_g = smem + l.g;
  float* s_da = smem + l.da;
  float* s_dh = smem + l.dh;
  constexpr int t = T, hs = t + 4, gs = t + 2, xs = hs / 2;
  constexpr int hps = plane_stride(hs), gps = plane_stride(gs), xps = plane_stride(xs);
  constexpr int dps = plane_stride(t);
  const int c = d.cd + d.cs;
  const int img_h = 2 * d.hc, img_w = 2 * d.wc;
  const int cd = d.cd, cs = d.cs, cin = d.cin;
  float* mine = part + static_cast<size_t>(blockIdx.x) * pl.total;
  const bool resident = mode == kResident, two = mode == kStreamTwo;
  // operand `op` on the block's it-th tile: its own region, or the buffer
  // its turn falls on (two buffers alternate over five operands a tile)
  auto wslot = [&](int op, int it) -> float* {
    if (resident) return smem + l.w[op];
    return smem + (((op + it) & 1) ? l.w[1] : l.w[0]);
  };
  auto fetch = [&](int op, const float* src, int it) {
    copy_weights(wslot(op, it), src, bwd_weight_floats(d, op));
  };
  if (resident) {
    fetch(kOpWd, wd, 0);
    fetch(kOpW1, w1, 0);
    fetch(kOpW2t, w2t, 0);
    fetch(kOpW1t, w1t, 0);
    fetch(kOpWdt, wdt, 0);
  } else if (two) {
    fetch(kOpWd, wd, 0);
  }
  // x and dy of tile `tl` into the buffers of the block's it-th tile
  auto load_x_dy = [&](int tl, int it) {
    int b_, y0, x0;
    tile_origin(d, tl, &b_, &y0, &x0);
    load_planes(smem + ((it & 1) ? l.x2 : l.x), xps, xs, x, b_, d.hc, d.wc, cin, y0 / 2 - 1,
                x0 / 2 - 1);
    load_planes(smem + ((it & 1) ? l.dy2 : l.dy), hps, hs, dy, b_, img_h, img_w, d.cout, y0 - 2,
                x0 - 2);
  };
  const bool ahead = l.x2 != l.x;
  if (ahead) {
    load_x_dy(blockIdx.x, 0);
    cp_async_commit();
  }
  PhaseTimer timer;
  timer.start();

  int it = 0;
  for (int tile = blockIdx.x; tile < d.ntiles; tile += gridDim.x, ++it) {
    int b, ty0, tx0;
    tile_origin(d, tile, &b, &ty0, &tx0);
    float* s_x = smem + ((it & 1) ? l.x2 : l.x);
    float* s_dy = smem + ((it & 1) ? l.dy2 : l.dy);
    const bool next = tile + gridDim.x < d.ntiles;
    const bool pre = ahead && next;   // the next tile's x and dy copy during this one
    __syncthreads();   // the previous tile's last readers are done
    if (!ahead) load_x_dy(tile, it);
    if (cs) load_planes(s_hc + cd * hps, hps, hs, skip, b, img_h, img_w, cs, ty0 - 2, tx0 - 2);
    cp_async_commit();
    if (two) {
      fetch(kOpW1, w1, it);
    } else if (!resident) {
      fetch(kOpWd, wd, it);
    }
    if (pre) {
      load_x_dy(tile + gridDim.x, it + 1);
      cp_async_commit();
    }
    // complete: this tile's planes and wd (two buffers: issued during the
    // last tile); in flight: w1 (two buffers) and the next tile's planes
    cp_async_wait_upto(two + pre);
    __syncthreads();
    timer.mark(kPhPlanes);
    // recompute h and g exactly as the forward does
    deconv_tile<kBwdMTiles, E>(s_hc, hps, hs, s_x, xps, xs, wslot(kOpWd, it), bd, cin, cd, img_h,
                               img_w, ty0 - 2, tx0 - 2);
    __syncthreads();
    timer.mark(kPhDeconv);
    if (!resident) {
      if (two) {
        fetch(kOpW2t, w2t, it);
        cp_async_wait_upto(1 + pre);   // w1; w2T and the next planes may fly
      } else {
        fetch(kOpW1, w1, it);
        cp_async_wait<0>();
      }
      __syncthreads();
      timer.mark(kPhW1);
    }
    conv_a_tile<kBwdMTiles, E>(s_g, gps, gs, s_hc, hps, hs, wslot(kOpW1, it), b1, c, d.c1, img_h,
                               img_w, ty0 - 1, tx0 - 1);
    __syncthreads();
    timer.mark(kPhConvA);
    if (!resident) {
      if (two) {
        fetch(kOpW1t, w1t, it);
        cp_async_wait<1>();
      } else {
        fetch(kOpW2t, w2t, it);
        cp_async_wait<0>();
      }
      __syncthreads();
      timer.mark(kPhW2t);
    }
    // da = relu'(a) * conv3x3(dy, flipT(w2)) on (T+2)^2 (bf16: rounded)
    auto da_out = [&](int r, int cc, int co, float v) {
      const int i = co * gps + r * gs + cc;
      s_da[i] = s_g[i] > 0.f ? act_round<E>(v) : 0.f;
    };
    if (bwd_tensor_core(d.c1, d.cout))
      bwd_conv_tc<9, kBwdMTiles, kOne>(s_dy, d.cout, hps, hs, 1, SquareTaps<3>{hs},
                                       wslot(kOpW2t, it), d.c1, gs, 0, da_out);
    else
      tile_conv<3>(s_dy, OneGroup{}, 1, d.cout, hps, hs, 1, wslot(kOpW2t, it), d.c1, gs, 0, da_out);
    __syncthreads();
    timer.mark(kPhDa);
    if (two) {
      fetch(kOpWdt, wdt, it);
    } else if (!resident) {
      fetch(kOpW1t, w1t, it);
    }
    // conv_b and conv_a weight and bias grads over the T x T owned pixels
    // (tap = ky*3 + kx: the input box shifted by (ky, kx); pixel k = (k / T, k % T))
    int first = tile_wgrad<9, T, kOne>(
        [=](int tap, int ci, int k) { return s_g[ci * gps + (k / T + tap / 3) * gs + k % T + tap % 3]; },
        [=](int, int co, int k) { return s_dy[co * hps + (k / T + 2) * hs + k % T + 2]; }, d.c1,
        d.cout, 0, mine + pl.dw2);
    tile_bias_grad(s_dy, hps, hs, 1, 2 * hs + 2, d.cout, t, mine + pl.db2);
    first = tile_wgrad<9, T, kOne>(
        [=](int tap, int ci, int k) {
          return s_hc[ci * hps + (k / T + tap / 3 + 1) * hs + k % T + tap % 3 + 1];
        },
        [=](int, int co, int k) { return s_da[co * gps + (k / T + 1) * gs + k % T + 1]; }, c,
        d.c1, first, mine + pl.dw1);
    tile_bias_grad(s_da, gps, gs, 1, gs + 1, d.c1, t, mine + pl.db1);
    timer.mark(kPhWgrad21);
    if (!resident) {
      if (two) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncthreads();
      timer.mark(kPhW1t);
    }
    // [dh | dskip] = conv3x3(da, flipT(w1)) on T^2 (reads s_da, which
    // nothing above writes after da's barrier); dh unrounded (bf16: rounded
    // below, after dbd's sums)
    auto dh_out = [&](int r, int cc, int co, float v) {
      const int gy = ty0 + r, gx = tx0 + cc;
      const bool in = gy < img_h && gx < img_w;
      if (co < cd) {
        s_dh[co * dps + r * t + cc] = in ? v : 0.f;
      } else if (in) {
        act_store(dskip + ((static_cast<size_t>(b) * img_h + gy) * img_w + gx) * cs + co - cd, v);
      }
    };
    first = bwd_tensor_core(c, d.c1)
                ? bwd_conv_tc<9, kBwdMTiles, kOne>(s_da, d.c1, gps, gs, 1, SquareTaps<3>{gs},
                                                   wslot(kOpW1t, it), c, t, first, dh_out)
                : tile_conv<3>(s_da, OneGroup{}, 1, d.c1, gps, gs, 1, wslot(kOpW1t, it), c, t,
                               first, dh_out);
    __syncthreads();
    timer.mark(kPhDh);
    if (two) {
      if (next) fetch(kOpWd, wd, it + 1);
    } else if (!resident) {
      fetch(kOpWdt, wdt, it);
    }
    if (kOne) {
      // dbd sums dh in float32 (lmu_pallas.py:488); dwd and dx take it
      // rounded to bf16 (:483-487), in place
      tile_bias_grad(s_dh, dps, t, 1, 0, cd, t, mine + pl.dbd);
      __syncthreads();
      for (int i = threadIdx.x; i < cd * dps; i += blockDim.x) s_dh[i] = act_round<E>(s_dh[i]);
      __syncthreads();
    }
    // deconv weight and bias grads: x (owned coarse) against dh, by phase
    // (tap = phase di*2 + dj: dh at fine pixel (2r + di, 2c + dj) of coarse pixel k = (r, c))
    constexpr int TC = T / 2;
    first = tile_wgrad<4, TC, kOne>(
        [=](int, int ci, int k) { return s_x[ci * xps + (k / TC + 1) * xs + k % TC + 1]; },
        [=](int ph, int co, int k) {
          return s_dh[co * dps + (2 * (k / TC) + ph / 2) * t + 2 * (k % TC) + ph % 2];
        },
        cin, cd, first, mine + pl.dwd);
    if (!kOne) tile_bias_grad(s_dh, dps, t, 1, 0, cd, t, mine + pl.dbd);
    timer.mark(kPhWgradD);
    if (!resident) {
      if (two && next) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncthreads();
      timer.mark(kPhWdt);
    }
    // dx on the T/2 x T/2 owned coarse pixels: sum over the four phases
    // (dh's planes at fine offset (di, dj), read at step 2: the taps of a
    // tensor-core conv, or groups of Cd planes for the FMAs) and Cd
    const int hc_out = ty0 / 2, wc_out = tx0 / 2;
    const auto phase = [=](int ph) { return (ph / 2) * t + ph % 2; };
    auto dx_out = [&](int r, int cc, int co, float v) {
      const int gy = hc_out + r, gx = wc_out + cc;
      if (gy < d.hc && gx < d.wc)
        act_store(dx + ((static_cast<size_t>(b) * d.hc + gy) * d.wc + gx) * cin + co, v);
    };
    if (bwd_tensor_core(cin, cd))
      bwd_conv_tc<4, kBwdMTiles, kOne>(s_dh, cd, dps, t, 2, phase, wslot(kOpWdt, it), cin,
                                       t / 2, first, dx_out);
    else
      tile_conv<1>(s_dh, phase, 4, cd, dps, t, 2, wslot(kOpWdt, it), cin, t / 2, first, dx_out);
    timer.mark(kPhDx);
  }
  timer.store();
}

template <class E>
using BwdKernel = decltype(&lmu_bwd_kernel<kSmallBlock, 8, E>);

template <class E>
BwdKernel<E> bwd_kernel(bool large, int t) {
  if (t == 8) return large ? lmu_bwd_kernel<kLargeBlock, 8, E> : lmu_bwd_kernel<kSmallBlock, 8, E>;
  return large ? lmu_bwd_kernel<kLargeBlock, 4, E> : lmu_bwd_kernel<kSmallBlock, 4, E>;
}

// out[e] = sum over blocks k = 0, 1, ... of part[k][e], in that order.
__global__ void lmu_reduce_kernel(const float* __restrict__ part, int nblk, int psize,
                                  float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= psize) return;
  float s = 0.f;
  for (int k = 0; k < nblk; ++k) s += part[static_cast<size_t>(k) * psize + e];
  out[e] = s;
}

template <int NT>
__device__ void probe_items(const float* sa, const float* sb, float* __restrict__ c, int m, int n,
                            int k) {
  const int nng = (n + 8 * NT - 1) / (8 * NT), items = (m + 15) / 16 * nng;
  for (int it = threadIdx.x / 32; it < items; it += blockDim.x / 32) {
    const int m0 = it / nng * 16, n0 = it % nng * 8 * NT;
    float acc[NT][4] = {};
    mma_3xtf32<NT>([=](int i, int kk) { return sa[i * k + kk]; },
                   [=](int kk, int j) { return sb[kk * n + j]; }, m0, n0, m, n, k, acc);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int2 mn = mma_entry(e, m0, n0 + 8 * j);
        if (mn.x < m && mn.y < n) c[mn.x * n + mn.y] = acc[j][e];
      }
  }
}

// The primitive alone: c [M][N] = a [M][K] b [K][N], both staged in shared
// memory, each warp taking whole items of 16 rows x wgrad_tiles(N) x 8
// columns through mma_3xtf32, as tile_wgrad does.
// One block; a check of the primitive, not a product for the model.
__global__ void __launch_bounds__(kSmallBlock)
mma_probe_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
                 int m, int n, int k) {
  float* sa = smem;
  float* sb = smem + m * k;
  for (int i = threadIdx.x; i < m * k; i += blockDim.x) sa[i] = a[i];
  for (int i = threadIdx.x; i < k * n; i += blockDim.x) sb[i] = b[i];
  __syncthreads();
  switch (wgrad_tiles(n)) {
    case 5: probe_items<5>(sa, sb, c, m, n, k); break;
    case 4: probe_items<4>(sa, sb, c, m, n, k); break;
    case 2: probe_items<2>(sa, sb, c, m, n, k); break;
    default: probe_items<1>(sa, sb, c, m, n, k);
  }
}

// The primitive's issue rate on the card, the ceiling of the products
// above: each warp runs `iters` rounds of 8 independent mma_tf32 products
// on register operands (no loads, no splits); thread 0 of each block
// writes the clock64 cycles of its loop to cycles[block]. A measurement of
// the card, not a product for the model.
__global__ void __launch_bounds__(kLargeBlock)
mma_rate_kernel(int iters, float* __restrict__ out, long long* __restrict__ cycles) {
  float acc[8][4] = {};
  uint32_t a[4], b[2] = {__float_as_uint(1.f), __float_as_uint(.5f)};
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(threadIdx.x * 1e-3f + i);
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_tf32(acc[j], a, b);
  const long long t1 = clock64();
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess) return 0;
  return v;
}

int max_smem_bytes() { return device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin); }

bool large_block(int bytes) {
  return 2 * bytes > device_attr(cudaDevAttrMaxSharedMemoryPerMultiprocessor);
}

// Sets the dynamic shared memory of `kernel` and launches it.
template <class... Params, class... Args>
cudaError_t launch(void (*kernel)(Params...), int grid, int threads, int bytes, cudaStream_t s,
                   Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, bytes, s>>>(args...);
  return cudaGetLastError();
}

bool dims_ok(int b, int hc, int wc, int cin, int cs, int cd, int c1, int cout) {
  return b >= 1 && hc >= 1 && wc >= 1 && cin >= 1 && cs >= 0 && cd >= 1 && c1 >= 1 && cout >= 1;
}

// Blocks of the backward an SM keeps resident with this layout, and its
// threads per block; both 0 where the layout exceeds `limit` bytes.
template <class E>
cudaError_t bwd_occupancy(const Dims& d, int mode, bool ahead, int limit, int* blocks,
                          int* threads) {
  *blocks = 0;
  *threads = 0;
  const int bytes = bwd_layout(d, mode, ahead).total * static_cast<int>(sizeof(float));
  if (bytes > limit) return cudaSuccess;
  const bool large = large_block(bytes);
  const BwdKernel<E> kernel = bwd_kernel<E>(large, d.t);
  *threads = large ? kLargeBlock : kSmallBlock;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, *threads, bytes);
}

}  // namespace

namespace {

template <class E>
int lmu_fwd(const void* x, const void* skip, const void* wd, const void* bd, const void* w1,
            const void* b1, const void* w2, const void* b2, void* y, int b, int hc, int wc,
            int cin, int cs, int cd, int c1, int cout, int t_force, void* stream) {
  if (!dims_ok(b, hc, wc, cin, cs, cd, c1, cout) || (cs > 0) != (skip != nullptr) ||
      (t_force != 0 && t_force != 16 && t_force != 8 && t_force != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int limit = max_smem_bytes();
  for (int t : {16, 8, 4}) {
    if (t_force != 0 && t != t_force) continue;
    const Dims d = make_dims(b, hc, wc, cin, cs, cd, c1, cout, t);
    const int bytes = fwd_layout(d).total * static_cast<int>(sizeof(float));
    if (bytes > limit) continue;
    const bool large = large_block(bytes);
    auto kernel = large ? lmu_fwd_kernel<kLargeBlock, E> : lmu_fwd_kernel<kSmallBlock, E>;
    return static_cast<int>(launch(
        kernel, d.ntiles, large ? kLargeBlock : kSmallBlock, bytes,
        static_cast<cudaStream_t>(stream), d, static_cast<const E*>(x),
        static_cast<const E*>(skip), static_cast<const float*>(wd),
        static_cast<const float*>(bd), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(y)));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class E>
int lmu_bwd_plan(int b, int hc, int wc, int cin, int cs, int cd, int c1, int cout, int* t_out,
                 int* mode_out, int* ahead_out, int* nblk, int* part_floats) {
  if (!dims_ok(b, hc, wc, cin, cs, cd, c1, cout))
    return static_cast<int>(cudaErrorInvalidValue);
  const int limit = max_smem_bytes();
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int t : {8, 4}) {
    const Dims d = make_dims(b, hc, wc, cin, cs, cd, c1, cout, t);
    int blocks = 0, threads = 0;
    e = bwd_occupancy<E>(d, kStreamOne, false, limit, &blocks, &threads);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (threads == 0) continue;
    const int floor = blocks * threads;
    int mode = kStreamOne;
    for (int m : {kResident, kStreamTwo}) {
      int mb = 0, mt = 0;
      e = bwd_occupancy<E>(d, m, false, limit, &mb, &mt);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (mt > 0 && mb * mt >= floor) {
        mode = m;
        blocks = mb;
        break;
      }
    }
    int ab = 0, at = 0;
    e = bwd_occupancy<E>(d, mode, true, limit, &ab, &at);
    if (e != cudaSuccess) return static_cast<int>(e);
    const bool ahead = at > 0 && ab * at >= floor;
    if (ahead) blocks = ab;
    *t_out = t;
    *mode_out = mode;
    *ahead_out = ahead;
    *nblk = imin(d.ntiles, imax(1, blocks) * sms);
    *part_floats = part_layout(d).total;
    return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class E>
int lmu_bwd(const void* x, const void* skip, const void* dy, const void* wd, const void* bd,
            const void* w1, const void* b1, const void* w2t, const void* w1t, const void* wdt,
            void* dx, void* dskip, void* part, void* sums, int b, int hc, int wc, int cin, int cs,
            int cd, int c1, int cout, int t, int mode, int ahead, int nblk, void* stream) {
  if (!dims_ok(b, hc, wc, cin, cs, cd, c1, cout) || (t != 8 && t != 4) || nblk < 1 ||
      mode < kStreamOne || mode > kResident || (cs > 0) != (skip != nullptr) ||
      (cs > 0) != (dskip != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = make_dims(b, hc, wc, cin, cs, cd, c1, cout, t);
  const BwdLayout l = bwd_layout(d, mode, ahead != 0);
  const int bytes = l.total * static_cast<int>(sizeof(float));
  const bool large = large_block(bytes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch(
      bwd_kernel<E>(large, t), nblk,
      large ? kLargeBlock : kSmallBlock, bytes, s, d, mode, l, part_layout(d),
      static_cast<const E*>(x), static_cast<const E*>(skip), static_cast<const E*>(dy),
      static_cast<const float*>(wd), static_cast<const float*>(bd),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2t), static_cast<const float*>(w1t),
      static_cast<const float*>(wdt), static_cast<E*>(dx), static_cast<E*>(dskip),
      static_cast<float*>(part));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int psize = part_layout(d).total;
  lmu_reduce_kernel<<<(psize + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part), nblk,
                                                         psize, static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward: y = the stage of x (and skip, null when cs = 0). With t = 0,
// picks the largest fine tile T in {16, 8, 4} whose shared memory fits
// (ops/lmu_cuda.py::fwd_tile mirrors the rule); t in {16, 8, 4} forces
// that T, for the checks that y's bits do not depend on it. Launches on
// `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for sizes it does not take. x and skip float32.
extern "C" int ccvpe_lmu_fwd(const void* x, const void* skip, const void* wd, const void* bd,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             void* y, int b, int hc, int wc, int cin, int cs, int cd, int c1,
                             int cout, int t_force, void* stream) {
  return lmu_fwd<float>(x, skip, wd, bd, w1, b1, w2, b2, y, b, hc, wc, cin, cs, cd, c1, cout,
                        t_force, stream);
}

// Plan of the backward: the tile T (8, else 4), the weight mode, whether
// the next tile's x and dy planes are copied ahead, the number of blocks
// (as many as the card keeps resident, at most one per tile) and the
// floats of one block's partial slice. The weights stay resident where all
// five fit beside the planes and an SM keeps at least as many of the
// kernel's threads as with one buffer; else two buffers on the same
// condition; else one. Then the planes go ahead on the same condition. The
// caller allocates nblk * part_floats zeroed floats of partials and
// part_floats floats of reduced sums. For float32 activations.
extern "C" int ccvpe_lmu_bwd_plan(int b, int hc, int wc, int cin, int cs, int cd, int c1,
                                  int cout, int* t_out, int* mode_out, int* ahead_out,
                                  int* nblk, int* part_floats) {
  return lmu_bwd_plan<float>(b, hc, wc, cin, cs, cd, c1, cout, t_out, mode_out, ahead_out, nblk,
                             part_floats);
}

// Backward with the plan above: dx [B,Hc,Wc,Cin], dskip [B,2Hc,2Wc,Cs] (null
// when cs = 0) and the weight/bias grads reduced into `sums` in
// part_layout's order. `part` must hold nblk * part_floats zeros. x, skip,
// dy, dx and dskip float32.
extern "C" int ccvpe_lmu_bwd(const void* x, const void* skip, const void* dy, const void* wd,
                             const void* bd, const void* w1, const void* b1, const void* w2t,
                             const void* w1t, const void* wdt, void* dx, void* dskip, void* part,
                             void* sums, int b, int hc, int wc, int cin, int cs, int cd, int c1,
                             int cout, int t, int mode, int ahead, int nblk, void* stream) {
  return lmu_bwd<float>(x, skip, dy, wd, bd, w1, b1, w2t, w1t, wdt, dx, dskip, part, sums, b, hc,
                        wc, cin, cs, cd, c1, cout, t, mode, ahead, nblk, stream);
}

#ifdef CCVPE_LMU_PHASE_TIMER
// The timed build only: where the backward's blocks write their phase
// cycles, int64 [nblk][kBwdPhases] (the caller zeroes it), for the
// launches that follow on `stream`.
extern "C" int ccvpe_lmu_bwd_phase_buffer(void* cycles, void* stream) {
  return static_cast<int>(cudaMemcpyToSymbolAsync(g_phase_cycles, &cycles, sizeof(cycles), 0,
                                                  cudaMemcpyHostToDevice,
                                                  static_cast<cudaStream_t>(stream)));
}

extern "C" int ccvpe_lmu_bwd_phases() { return kBwdPhases; }
#endif

// The 3xTF32 primitive alone (mma_probe_kernel): c [m][n] = a [m][k] b [k][n],
// all float32 and contiguous, one block on `stream`. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for sizes
// whose operands do not fit in a block's shared memory.
extern "C" int ccvpe_mma_probe(const void* a, const void* b, void* c, int m, int n, int k,
                               void* stream) {
  const long floats = static_cast<long>(m) * k + static_cast<long>(k) * n;
  if (m < 1 || n < 1 || k < 1 || floats * static_cast<long>(sizeof(float)) > max_smem_bytes())
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(mma_probe_kernel, 1, kSmallBlock,
                                 static_cast<int>(floats * sizeof(float)),
                                 static_cast<cudaStream_t>(stream), static_cast<const float*>(a),
                                 static_cast<const float*>(b), static_cast<float*>(c), m, n, k));
}

// mma_rate_kernel on `blocks` blocks of 512 threads: out holds blocks * 512
// floats, cycles blocks int64. Returns cudaGetLastError() after the launch.
extern "C" int ccvpe_mma_rate(int blocks, int iters, void* out, void* cycles, void* stream) {
  if (blocks < 1 || iters < 1) return static_cast<int>(cudaErrorInvalidValue);
  mma_rate_kernel<<<blocks, kLargeBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<float*>(out), static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}
