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
// and g and their gradients live in shared memory as channel planes (plane
// stride odd, so neighbouring pixels sit in neighbouring banks). One block
// owns a T x T fine output tile (T even) and recomputes h on (T+4)^2 and g
// on (T+2)^2 pixels around it, so borders are the convs' zero padding, not
// deconv(0)+bias: every value outside the image is stored as 0. Weights go
// through shared memory one operand at a time (they do not all fit beside
// the planes). Each thread keeps a PT-pixel x CT-channel register tile,
// loads CT weights as float4 broadcasts and PT activations per tap.
// Tensor cores (TF32/bf16 wgmma), TMA and coalesced stores are for a later
// change.
//
// Backward sums: the TPU kernel adds weight gradients into one accumulator
// across its in-order grid. Here a fixed grid of blocks walks the tiles in
// a fixed order (tile = block + k * grid); each block adds its tiles'
// sums into its own slice of a partial buffer, and a second kernel adds the
// slices in block order. No float atomics anywhere, so two runs give the
// same bits. dx and dskip are owned by one tile each (the deconv has no
// overlap), so no two blocks write the same element.

#include <cuda_runtime.h>

#include <initializer_list>

namespace {

// Threads per block: 512 where the shared memory of a block leaves room
// for only one block on an SM (VIGOR stage 5: 16 warps instead of 8 hide
// more latency), 256 elsewhere (the heads fit two or three blocks).
constexpr int kSmallBlock = 256;
constexpr int kLargeBlock = 512;

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int plane_stride(int side) { return (side * side) | 1; }
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

// Weight gradient over an n x n pixel box:
//   part[(tap*cin + ci)*cout + co] += sum_{r,c < n}
//       in[ci*in_ps + (r*step + ky)*in_side + c*step + kx + in_org]
//     * g[co*g_ps + (r*g_step)*g_side + c*g_step + g_org]
// Each thread owns (tap, 4 input channels, co) entries, sums its pixels in a
// fixed order and adds the sum into its own entries of the block's partial
// slice (no other thread writes them).
template <int KS>
__device__ void tile_wgrad(const float* in, int in_ps, int in_side, int step, int in_org, int cin,
                           const float* g, int g_ps, int g_side, int g_step, int g_org, int cout,
                           int n, float* __restrict__ part) {
  const int ncig = (cin + 3) / 4;
  const int total = KS * KS * ncig * cout;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int co = e % cout;
    const int rest = e / cout;
    const int cig = rest % ncig;
    const int tap = rest / ncig;
    const int ky = tap / KS, kx = tap % KS;
    const float* ip[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = imin(cig * 4 + j, cin - 1);
      ip[j] = in + ci * in_ps + ky * in_side + kx + in_org;
    }
    const float* gp = g + co * g_ps + g_org;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < n; ++r) {
      for (int c = 0; c < n; ++c) {
        const float gv = gp[r * g_step * g_side + c * g_step];
        const int o = r * step * in_side + c * step;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(ip[j][o], gv, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = cig * 4 + j;
      if (ci < cin) part[(tap * cin + ci) * cout + co] += acc[j];
    }
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

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
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
  const int c = d.cd + d.cs, t = d.t, hs = t + 4, gs = t + 2, xs = hs / 2;
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
    tile_wgrad<3>(s_g, gps, gs, 1, 0, d.c1, s_dy, hps, hs, 1, 2 * hs + 2, d.cout, t, mine + pl.dw2);
    tile_bias_grad(s_dy, hps, hs, 1, 2 * hs + 2, d.cout, t, mine + pl.db2);
    tile_wgrad<3>(s_hc, hps, hs, 1, hs + 1, c, s_da, gps, gs, 1, gs + 1, d.c1, t, mine + pl.dw1);
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
    for (int ph = 0; ph < 4; ++ph)
      tile_wgrad<1>(s_x, xps, xs, 1, xs + 1, cin, s_dh, dps, t, 2, (ph / 2) * t + ph % 2, cd,
                    t / 2, mine + pl.dwd + ph * cin * cd);
    tile_bias_grad(s_dh, dps, t, 1, 0, cd, t, mine + pl.dbd);
  }
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
    auto kernel = large ? lmu_bwd_kernel<kLargeBlock> : lmu_bwd_kernel<kSmallBlock>;
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
      large ? lmu_bwd_kernel<kLargeBlock> : lmu_bwd_kernel<kSmallBlock>, nblk,
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
