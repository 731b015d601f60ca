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
// float32 NHWC and contiguous. Weights in the kernel's layouts, made by the
// wrapper (ops/lmu_cuda.py) from torch's: wd [4][Cin][Cd] (phase di*2+dj),
// w1 [9][Cd+Cs][C1], w2 [9][C1][Cout] (tap ky*3+kx); the backward also
// takes the flipped-transposed w2T [9][Cout][C1], w1T [9][C1][Cd+Cs] and
// wdT [4][Cd][Cin].
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
// outside the image is stored as 0. Weights go through shared memory one
// operand at a time (they do not all fit beside the planes).
//
// Two products carry all the arithmetic. The convs (tile_conv: the deconv,
// conv_a and its recompute, da, dh|dskip and dx) are CUDA-core FMAs: each
// thread keeps a PT-pixel x CT-channel register tile, loads CT weights as
// float4 broadcasts and PT activations per tap. The backward's three weight
// gradients (tile_wgrad: dw2, dw1, dwd) are products over a tile's pixels;
// as FMAs they issued more shared-memory loads than FMAs (5 per 4) and took
// about a third of the backward's time at the VIGOR shapes. They run on the
// tensor cores through mma_3xtf32, one warp-level m16n8k8 TF32 mma.sync
// primitive: each float32 operand is split into two TF32 values and three
// products are summed in float32, so the results stay float32-accurate, and
// a fragment of 16 x 8 x 8 multiply-adds needs 6 loads per lane. That about
// halved their time; they are now bound by the instructions around the
// products (loads, splits, addresses) at 128 registers a thread, not by the
// tensor cores. What bounds the backward now is the FMA convs and the
// weight and plane loads between them. Tensor cores for the convs (shared
// with the forward, whose ReLU mask the backward recomputes), larger tiles,
// and cp.async/TMA for the loads are for a later change.
//
// Backward sums: the TPU kernel adds weight gradients into one accumulator
// across its in-order grid. Here a fixed grid of blocks walks the tiles in
// a fixed order (tile = block + k * grid); each block adds its tiles'
// sums into its own slice of a partial buffer, and a second kernel adds the
// slices in block order. No float atomics anywhere, so two runs give the
// same bits. dx and dskip are owned by one tile each (the deconv has no
// overlap), so no two blocks write the same element.

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

// Threads per block: 512 where the shared memory of a block leaves room
// for only one block on an SM (VIGOR stage 5: 16 warps instead of 8 hide
// more latency), 256 elsewhere (the heads fit two or three blocks; the
// backward asks for two, which caps it at 128 registers a thread).
constexpr int kSmallBlock = 256;
constexpr int kLargeBlock = 512;

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
// Floats between two channel planes of side^2 pixels: the least >= side^2
// that is 4 times an odd number, so 8 neighbouring channels start in 8
// banks 4 apart. A TF32 fragment load (8 channels x 4 neighbouring pixels,
// mma_3xtf32 in tile_wgrad) then touches 32 different banks; the FMA
// convs read one channel at a time and do not depend on it.
__host__ __device__ inline int plane_stride(int side) { return (side * side + 3) / 8 * 8 + 4; }
__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }
// padded output-channel count of a weight operand in shared memory
__host__ __device__ inline int pad_co(int c) { return c <= 4 ? 4 : (c + 7) / 8 * 8; }

// dst[c*ps + r*side + col] = src[b, y0+r, x0+col, c] inside the image, else 0
__device__ void load_planes(float* dst, int ps, int side, const float* __restrict__ src,
                            int b, int h, int w, int nc, int y0, int x0) {
  const int n = side * side * nc;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i % nc;
    const int p = i / nc;
    const int r = p / side, col = p % side;
    const int gy = y0 + r, gx = x0 + col;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w)
      v = src[((static_cast<size_t>(b) * h + gy) * w + gx) * nc + c];
    dst[c * ps + p] = v;
  }
}

// dst[r][c] (c < coutp) = src[r][c] for c < cout, 0 on the padding
__device__ void load_weights(float* dst, const float* __restrict__ src, int rows, int cout) {
  const int coutp = pad_co(cout);
  const int n = rows * coutp;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / coutp, c = i % coutp;
    dst[i] = c < cout ? src[r * cout + c] : 0.f;
  }
}

// out(r, c)[co] = sum_{ci, ky, kx} in[chan(ci) + (r*step + ky)*in_side + c*step + kx]
//                                  * w[((ky*KS + kx)*cin + ci)*coutp + co]
// for r, c < out_side; epi(r, c, co, value) stores it. One warp takes CT
// output channels of 32*PT pixels (pixel lane + 32*k), so weight loads are
// warp-wide broadcasts and activation loads hit 32 neighbouring pixels.
template <int KS, int PT, int CT, class Chan, class Epi>
__device__ void tile_conv_impl(const float* in, Chan chan, int in_side, int step, int cin,
                               const float* w, int coutp, int out_side, Epi epi) {
  const int npos = out_side * out_side;
  const int nchunk = (npos + 32 * PT - 1) / (32 * PT);
  const int ncg = coutp / CT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int it = warp; it < nchunk * ncg; it += nwarps) {
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
    for (int ci = 0; ci < cin; ++ci) {
      const float* ip = in + chan(ci);
      const float* wp = w + ci * coutp + co0;
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
#pragma unroll
    for (int k = 0; k < PT; ++k) {
      const int q = ch * 32 * PT + k * 32 + lane;
      if (q >= npos) continue;
#pragma unroll
      for (int j = 0; j < CT; ++j) epi(q / out_side, q % out_side, co0 + j, acc[k][j]);
    }
  }
}

// Picks the register tile: CT = 8 when the padded channel count allows it,
// and the largest PT that still gives every warp a work item.
template <int KS, class Chan, class Epi>
__device__ void tile_conv(const float* in, Chan chan, int in_side, int step, int cin,
                          const float* w, int cout, int out_side, Epi epi) {
  const int coutp = pad_co(cout);
  const int npos = out_side * out_side;
  auto guarded = [&](int r, int c, int co, float v) {
    if (co < cout) epi(r, c, co, v);
  };
  const int nwarps = blockDim.x / 32;
  if (coutp % 8 == 0) {
    const int ncg = coutp / 8;
    if (((npos + 127) / 128) * ncg >= nwarps)
      tile_conv_impl<KS, 4, 8>(in, chan, in_side, step, cin, w, coutp, out_side, guarded);
    else if (((npos + 63) / 64) * ncg >= nwarps)
      tile_conv_impl<KS, 2, 8>(in, chan, in_side, step, cin, w, coutp, out_side, guarded);
    else
      tile_conv_impl<KS, 1, 8>(in, chan, in_side, step, cin, w, coutp, out_side, guarded);
  } else {
    if ((npos + 127) / 128 >= nwarps)
      tile_conv_impl<KS, 4, 4>(in, chan, in_side, step, cin, w, coutp, out_side, guarded);
    else
      tile_conv_impl<KS, 2, 4>(in, chan, in_side, step, cin, w, coutp, out_side, guarded);
  }
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

// acc[j], this lane's part of the 16 x 8 tile of A B at (m0, n0 + 8j), for
// j < NT: += sum over k < K of a(m, k) * b(k, n), with A [M][K] and B [K][N]
// read through the functors a and b and zero outside those bounds (so M, N
// and K need not be multiples of 16, 8 and 8). Each k-step of 8 splits the
// A fragment once for all NT tiles and runs three TF32 products per tile,
// lo*hi + hi*lo and then hi*hi, into float32 accumulators: the product
// dropped, lo*lo, is ~2^-22 of |a b|, so the result is float32-accurate,
// where one TF32 product alone keeps ~3 decimal digits. The order of the
// sums is fixed, so two calls give the same bits. No branch depends on the
// data or the shape inside, so the compiler can overlap one tile's loads
// with another's products.
template <int NT, class A, class B>
__device__ void mma_3xtf32(A a, B b, int m0, int n0, int M, int N, int K, float (&acc)[NT][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int m_lo = m0 + g, m_hi = m0 + g + 8;
  const bool in_lo = m_lo < M, in_hi = m_hi < M;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    const int k1 = k0 + q, k2 = k0 + q + 4;
    const bool in1 = k1 < K, in2 = k2 < K;
    uint32_t ah[4], al[4];
    split_tf32(in_lo && in1 ? a(m_lo, k1) : 0.f, ah[0], al[0]);
    split_tf32(in_hi && in1 ? a(m_hi, k1) : 0.f, ah[1], al[1]);
    split_tf32(in_lo && in2 ? a(m_lo, k2) : 0.f, ah[2], al[2]);
    split_tf32(in_hi && in2 ? a(m_hi, k2) : 0.f, ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j + g;
      uint32_t bh[2], bl[2];
      split_tf32(n < N && in1 ? b(k1, n) : 0.f, bh[0], bl[0]);
      split_tf32(n < N && in2 ? b(k2, n) : 0.f, bh[1], bl[1]);
      mma_tf32(acc[j], al, bh);
      mma_tf32(acc[j], ah, bl);
      mma_tf32(acc[j], ah, bh);
    }
  }
}

// (m, n) of acc[j], this lane's j-th entry of the 16 x 8 tile at (m0, n0).
__device__ inline int2 mma_entry(int j, int m0, int n0) {
  const int lane = threadIdx.x % 32;
  return make_int2(m0 + lane / 4 + (j / 2) * 8, n0 + 2 * (lane % 4) + j % 2);
}

// Output tiles of 8 columns that one warp item covers for N columns: the
// A fragment (4 values a lane, split into 8 TF32 values) is loaded once for
// all of them. The largest of 5, 4, 2 and 1 that divides the tile count,
// so that no item holds a tile past N (5 takes the VIGOR stages' 40 output
// channels in one item).
__host__ __device__ inline int wgrad_tiles(int n) {
  const int tiles = (n + 7) / 8;
  return tiles % 5 == 0 ? 5 : tiles % 4 == 0 ? 4 : tiles % 2 == 0 ? 2 : 1;
}

template <int NTAP, int NB, int NT, class In, class G>
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
    mma_3xtf32<NT>([=](int ci, int k) { return in(tap, ci, k); },
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
// the next call.
template <int NTAP, int NB, class In, class G>
__device__ int tile_wgrad(In in, G g, int cin, int cout, int first, float* __restrict__ part) {
  switch (wgrad_tiles(cout)) {
    case 5: return first + tile_wgrad_nt<NTAP, NB, 5>(in, g, cin, cout, first, part);
    case 4: return first + tile_wgrad_nt<NTAP, NB, 4>(in, g, cin, cout, first, part);
    case 2: return first + tile_wgrad_nt<NTAP, NB, 2>(in, g, cin, cout, first, part);
    default: return first + tile_wgrad_nt<NTAP, NB, 1>(in, g, cin, cout, first, part);
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

// Shared memory of the backward, in floats: the planes hc = [h|skip] and
// dy on (T+4)^2, g and da on (T+2)^2, dh on T^2, the coarse x region, and
// one weight operand at a time.
struct BwdLayout { int hc, g, dy, da, x, dh, w, total; };

__host__ __device__ BwdLayout bwd_layout(const Dims& d) {
  const int c = d.cd + d.cs, hs = d.t + 4, gs = d.t + 2, xs = hs / 2;
  int w = imax(4 * d.cin * pad_co(d.cd), 9 * c * pad_co(d.c1));
  w = imax(w, 9 * d.cout * pad_co(d.c1));
  w = imax(w, 9 * d.c1 * pad_co(c));
  w = imax(w, 4 * d.cd * pad_co(d.cin));
  BwdLayout l;
  l.hc = 0;
  l.g = l.hc + round4(c * plane_stride(hs));
  l.dy = l.g + round4(d.c1 * plane_stride(gs));
  l.da = l.dy + round4(d.cout * plane_stride(hs));
  l.x = l.da + round4(d.c1 * plane_stride(gs));
  l.dh = l.x + round4(d.cin * plane_stride(xs));
  l.w = l.dh + round4(d.cd * plane_stride(d.t));
  l.total = l.w + round4(w);
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
// so a warp's weights are one broadcast; 0 outside the image.
__device__ void deconv_tile(float* h, int hps, int hs, const float* xpl, int xps, int xs,
                            const float* wsm, const float* __restrict__ bd, int cin, int cd,
                            int img_h, int img_w, int fy0, int fx0) {
  const int cdp = pad_co(cd);
  for (int ph = 0; ph < 4; ++ph) {
    const int di = ph / 2, dj = ph % 2;
    tile_conv<1>(xpl, [=](int ci) { return ci * xps; }, xs, 1, cin, wsm + ph * cin * cdp, cd, xs,
                 [&](int r, int c, int co, float v) {
                   const int rr = 2 * r + di, cc = 2 * c + dj;
                   const int gy = fy0 + rr, gx = fx0 + cc;
                   const bool in = gy >= 0 && gy < img_h && gx >= 0 && gx < img_w;
                   h[co * hps + rr * hs + cc] = in ? v + bd[co] : 0.f;
                 });
  }
}

// g = relu(conv3x3(hc, w1) + b1) on the (T+2)^2 region at (gy0, gx0); 0 outside.
__device__ void conv_a_tile(float* g, int gps, int gs, const float* hc, int hps, int hs,
                            const float* wsm, const float* __restrict__ b1, int c, int c1,
                            int img_h, int img_w, int gy0, int gx0) {
  tile_conv<3>(hc, [=](int ci) { return ci * hps; }, hs, 1, c, wsm, c1, gs,
               [&](int r, int cc, int co, float v) {
                 const int gy = gy0 + r, gx = gx0 + cc;
                 const bool in = gy >= 0 && gy < img_h && gx >= 0 && gx < img_w;
                 g[co * gps + r * gs + cc] = in ? fmaxf(v + b1[co], 0.f) : 0.f;
               });
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
lmu_fwd_kernel(Dims d, const float* __restrict__ x, const float* __restrict__ skip,
               const float* __restrict__ wd, const float* __restrict__ bd,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ w2, const float* __restrict__ b2,
               float* __restrict__ y) {
  extern __shared__ __align__(16) float smem[];
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
  load_weights(sw, wd, 4 * d.cin, d.cd);
  __syncthreads();
  deconv_tile(sa, hps, hs, sb, xps, xs, sw, bd, d.cin, d.cd, img_h, img_w, ty0 - 2, tx0 - 2);
  __syncthreads();
  load_weights(sw, w1, 9 * c, d.c1);
  __syncthreads();
  conv_a_tile(sb, gps, gs, sa, hps, hs, sw, b1, c, d.c1, img_h, img_w, ty0 - 1, tx0 - 1);
  __syncthreads();
  load_weights(sa, w2, 9 * d.c1, d.cout);
  __syncthreads();
  const int cout = d.cout;
  tile_conv<3>(sb, [=](int ci) { return ci * gps; }, gs, 1, d.c1, sa, cout, d.t,
               [&](int r, int cc, int co, float v) {
                 const int gy = ty0 + r, gx = tx0 + cc;
                 if (gy < img_h && gx < img_w)
                   y[((static_cast<size_t>(b) * img_h + gy) * img_w + gx) * cout + co] = v + b2[co];
               });
}

// T, the fine tile side, is d.t: a template argument, so that the weight
// gradients' pixel boxes (T x T, and T/2 x T/2 for the deconv) have a
// compile-time side.
template <int kThreads, int T>
__global__ void __launch_bounds__(kThreads, kLargeBlock / kThreads)
lmu_bwd_kernel(Dims d, const float* __restrict__ x, const float* __restrict__ skip,
               const float* __restrict__ dy, const float* __restrict__ wd,
               const float* __restrict__ bd, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2t,
               const float* __restrict__ w1t, const float* __restrict__ wdt,
               float* __restrict__ dx, float* __restrict__ dskip, float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const BwdLayout l = bwd_layout(d);
  float* s_hc = smem + l.hc;
  float* s_g = smem + l.g;
  float* s_dy = smem + l.dy;
  float* s_da = smem + l.da;
  float* s_x = smem + l.x;
  float* s_dh = smem + l.dh;
  float* s_w = smem + l.w;
  const int c = d.cd + d.cs, t = T, hs = t + 4, gs = t + 2, xs = hs / 2;
  const int hps = plane_stride(hs), gps = plane_stride(gs), xps = plane_stride(xs);
  const int dps = plane_stride(t);
  const int img_h = 2 * d.hc, img_w = 2 * d.wc;
  const int cd = d.cd, cs = d.cs, cin = d.cin;
  const PartLayout pl = part_layout(d);
  float* mine = part + static_cast<size_t>(blockIdx.x) * pl.total;

  for (int tile = blockIdx.x; tile < d.ntiles; tile += gridDim.x) {
    int b, ty0, tx0;
    tile_origin(d, tile, &b, &ty0, &tx0);
    __syncthreads();   // the previous tile's last readers are done
    load_planes(s_x, xps, xs, x, b, d.hc, d.wc, cin, ty0 / 2 - 1, tx0 / 2 - 1);
    if (cs) load_planes(s_hc + cd * hps, hps, hs, skip, b, img_h, img_w, cs, ty0 - 2, tx0 - 2);
    load_planes(s_dy, hps, hs, dy, b, img_h, img_w, d.cout, ty0 - 2, tx0 - 2);
    load_weights(s_w, wd, 4 * cin, cd);
    __syncthreads();
    // recompute h and g exactly as the forward does
    deconv_tile(s_hc, hps, hs, s_x, xps, xs, s_w, bd, cin, cd, img_h, img_w, ty0 - 2, tx0 - 2);
    __syncthreads();
    load_weights(s_w, w1, 9 * c, d.c1);
    __syncthreads();
    conv_a_tile(s_g, gps, gs, s_hc, hps, hs, s_w, b1, c, d.c1, img_h, img_w, ty0 - 1, tx0 - 1);
    __syncthreads();
    // da = relu'(a) * conv3x3(dy, flipT(w2)) on (T+2)^2
    load_weights(s_w, w2t, 9 * d.cout, d.c1);
    __syncthreads();
    tile_conv<3>(s_dy, [=](int ci) { return ci * hps; }, hs, 1, d.cout, s_w, d.c1, gs,
                 [&](int r, int cc, int co, float v) {
                   const int i = co * gps + r * gs + cc;
                   s_da[i] = s_g[i] > 0.f ? v : 0.f;
                 });
    __syncthreads();
    // conv_b and conv_a weight and bias grads over the T x T owned pixels
    // (tap = ky*3 + kx: the input box shifted by (ky, kx); pixel k = (k / T, k % T))
    int first = tile_wgrad<9, T>(
        [=](int tap, int ci, int k) { return s_g[ci * gps + (k / T + tap / 3) * gs + k % T + tap % 3]; },
        [=](int, int co, int k) { return s_dy[co * hps + (k / T + 2) * hs + k % T + 2]; }, d.c1,
        d.cout, 0, mine + pl.dw2);
    tile_bias_grad(s_dy, hps, hs, 1, 2 * hs + 2, d.cout, t, mine + pl.db2);
    tile_wgrad<9, T>(
        [=](int tap, int ci, int k) {
          return s_hc[ci * hps + (k / T + tap / 3 + 1) * hs + k % T + tap % 3 + 1];
        },
        [=](int, int co, int k) { return s_da[co * gps + (k / T + 1) * gs + k % T + 1]; }, c,
        d.c1, first, mine + pl.dw1);
    tile_bias_grad(s_da, gps, gs, 1, gs + 1, d.c1, t, mine + pl.db1);
    // [dh | dskip] = conv3x3(da, flipT(w1)) on T^2 (nothing above reads s_w)
    load_weights(s_w, w1t, 9 * d.c1, c);
    __syncthreads();
    tile_conv<3>(s_da, [=](int ci) { return ci * gps; }, gs, 1, d.c1, s_w, c, t,
                 [&](int r, int cc, int co, float v) {
                   const int gy = ty0 + r, gx = tx0 + cc;
                   const bool in = gy < img_h && gx < img_w;
                   if (co < cd) {
                     s_dh[co * dps + r * t + cc] = in ? v : 0.f;
                   } else if (in) {
                     dskip[((static_cast<size_t>(b) * img_h + gy) * img_w + gx) * cs + co - cd] = v;
                   }
                 });
    __syncthreads();
    // dx on the T/2 x T/2 owned coarse pixels: sum over phases and Cd
    load_weights(s_w, wdt, 4 * cd, cin);
    __syncthreads();
    const int hc_out = ty0 / 2, wc_out = tx0 / 2;
    tile_conv<1>(s_dh,
                 [=](int k) {
                   const int ph = k / cd;
                   return (k % cd) * dps + (ph / 2) * t + ph % 2;
                 },
                 t, 2, 4 * cd, s_w, cin, t / 2,
                 [&](int r, int cc, int co, float v) {
                   const int gy = hc_out + r, gx = wc_out + cc;
                   if (gy < d.hc && gx < d.wc)
                     dx[((static_cast<size_t>(b) * d.hc + gy) * d.wc + gx) * cin + co] = v;
                 });
    // deconv weight and bias grads: x (owned coarse) against dh, by phase
    // (tap = phase di*2 + dj: dh at fine pixel (2r + di, 2c + dj) of coarse pixel k = (r, c))
    constexpr int TC = T / 2;
    tile_wgrad<4, TC>(
        [=](int, int ci, int k) { return s_x[ci * xps + (k / TC + 1) * xs + k % TC + 1]; },
        [=](int ph, int co, int k) {
          return s_dh[co * dps + (2 * (k / TC) + ph / 2) * t + 2 * (k % TC) + ph % 2];
        },
        cin, cd, 0, mine + pl.dwd);
    tile_bias_grad(s_dh, dps, t, 1, 0, cd, t, mine + pl.dbd);
  }
}

using BwdKernel = decltype(&lmu_bwd_kernel<kSmallBlock, 8>);

BwdKernel bwd_kernel(bool large, int t) {
  if (t == 8) return large ? lmu_bwd_kernel<kLargeBlock, 8> : lmu_bwd_kernel<kSmallBlock, 8>;
  return large ? lmu_bwd_kernel<kLargeBlock, 4> : lmu_bwd_kernel<kSmallBlock, 4>;
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
  extern __shared__ __align__(16) float smem[];
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

}  // namespace

// Forward: y = the stage of x (and skip, null when cs = 0). Picks the
// largest fine tile T in {16, 8, 4} whose shared memory fits. Launches on
// `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for sizes it does not take.
extern "C" int ccvpe_lmu_fwd(const void* x, const void* skip, const void* wd, const void* bd,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             void* y, int b, int hc, int wc, int cin, int cs, int cd, int c1,
                             int cout, void* stream) {
  if (!dims_ok(b, hc, wc, cin, cs, cd, c1, cout) || (cs > 0) != (skip != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int limit = max_smem_bytes();
  for (int t : {16, 8, 4}) {
    const Dims d = make_dims(b, hc, wc, cin, cs, cd, c1, cout, t);
    const int bytes = fwd_layout(d).total * static_cast<int>(sizeof(float));
    if (bytes > limit) continue;
    const bool large = large_block(bytes);
    auto kernel = large ? lmu_fwd_kernel<kLargeBlock> : lmu_fwd_kernel<kSmallBlock>;
    return static_cast<int>(launch(
        kernel, d.ntiles, large ? kLargeBlock : kSmallBlock, bytes,
        static_cast<cudaStream_t>(stream), d, static_cast<const float*>(x),
        static_cast<const float*>(skip), static_cast<const float*>(wd),
        static_cast<const float*>(bd), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(y)));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Plan of the backward: the tile T (8, else 4), the number of blocks (as
// many as the card keeps resident, at most one per tile) and the floats of
// one block's partial slice. The caller allocates nblk * part_floats
// zeroed floats of partials and part_floats floats of reduced sums.
extern "C" int ccvpe_lmu_bwd_plan(int b, int hc, int wc, int cin, int cs, int cd, int c1,
                                  int cout, int* t_out, int* nblk, int* part_floats) {
  if (!dims_ok(b, hc, wc, cin, cs, cd, c1, cout))
    return static_cast<int>(cudaErrorInvalidValue);
  const int limit = max_smem_bytes();
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int t : {8, 4}) {
    const Dims d = make_dims(b, hc, wc, cin, cs, cd, c1, cout, t);
    const int bytes = bwd_layout(d).total * static_cast<int>(sizeof(float));
    if (bytes > limit) continue;
    const bool large = large_block(bytes);
    const BwdKernel kernel = bwd_kernel(large, t);
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      large ? kLargeBlock : kSmallBlock, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    *t_out = t;
    *nblk = imin(d.ntiles, imax(1, per_sm) * sms);
    *part_floats = part_layout(d).total;
    return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward with the plan above: dx [B,Hc,Wc,Cin], dskip [B,2Hc,2Wc,Cs] (null
// when cs = 0) and the weight/bias grads reduced into `sums` in
// part_layout's order. `part` must hold nblk * part_floats zeros.
extern "C" int ccvpe_lmu_bwd(const void* x, const void* skip, const void* dy, const void* wd,
                             const void* bd, const void* w1, const void* b1, const void* w2t,
                             const void* w1t, const void* wdt, void* dx, void* dskip, void* part,
                             void* sums, int b, int hc, int wc, int cin, int cs, int cd, int c1,
                             int cout, int t, int nblk, void* stream) {
  if (!dims_ok(b, hc, wc, cin, cs, cd, c1, cout) || (t != 8 && t != 4) || nblk < 1 ||
      (cs > 0) != (skip != nullptr) || (cs > 0) != (dskip != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = make_dims(b, hc, wc, cin, cs, cd, c1, cout, t);
  const int bytes = bwd_layout(d).total * static_cast<int>(sizeof(float));
  const bool large = large_block(bytes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch(
      bwd_kernel(large, t), nblk,
      large ? kLargeBlock : kSmallBlock, bytes, s, d, static_cast<const float*>(x),
      static_cast<const float*>(skip), static_cast<const float*>(dy),
      static_cast<const float*>(wd), static_cast<const float*>(bd),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2t), static_cast<const float*>(w1t),
      static_cast<const float*>(wdt), static_cast<float*>(dx), static_cast<float*>(dskip),
      static_cast<float*>(part));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int psize = part_layout(d).total;
  lmu_reduce_kernel<<<(psize + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part), nblk,
                                                         psize, static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
}

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
