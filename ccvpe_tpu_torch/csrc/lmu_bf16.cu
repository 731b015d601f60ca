// Fused LMU decoder stage on bf16 activations for Hopper (sm_90a): B2 and
// B3 under compute_dtype='bfloat16'.
//
// Replaces the Pallas TPU kernels ccvpe_tpu/ops/lmu_pallas.py::
// _fused_stage_kernel (:264, pallas_call at :385) and ::_fused_stage_bwd_kernel
// (:404, pallas_call at :628) where they run on bf16 activations (they take
// the activations' type, :332, :527). The stage, its shapes and the order
// of its outputs are csrc/lmu.cu's (the float32 kernels); so are the
// plans' rules and the backward's tile loop, phase by phase. What differs
// is how the data lies and how it is multiplied:
//
// - Planes in bf16, pixel-major: pixel p's channels are one row of
//   pix_stride(C) bf16 values (C rounded up to 8, and 8 more where that is
//   an even number of 16-byte units), so 8 neighbouring pixels start in 8
//   distinct 16-byte bank groups. One ldmatrix (8 rows of 16 bytes) reads
//   8 pixels x 8 channels with no bank conflict, in either orientation: as
//   A of a conv (M = pixels, K = channels; plain ldmatrix) and as A or B
//   of a weight gradient (K = pixels; ldmatrix.trans).
// - Weights in bf16 too, each operand [tap][K][pix_stride(N)] (K input
//   channels, N output channels, zero columns past N), as the wrapper
//   (ops/lmu_cuda.py::kernel_weights_bf16) lays them out in device memory:
//   a B fragment is one ldmatrix.trans. The wrapper rounds them to bf16,
//   as the TPU kernel casts them.
// - Every product is mma.sync.m16n8k16 bf16 with float32 accumulators
//   (tf32_mma.cuh): exact products, twice the K of TF32's m16n8k8 an
//   instruction. Every conv takes the tensor cores, the heads' included.
// - skip, dy and x reach shared memory by 16-byte cp.async copies where
//   their channel count is a multiple of 8. x has 81 or 41 channels at the
//   VIGOR calls (rows of 162 and 82 bytes, not 16-byte aligned), so the
//   wrapper pads its channels with zeros to a multiple of 8 first; the
//   heads' dy has 1 or 2, padded to 2 and copied by 4-byte cp.async.
// - Half the float32 planes' bytes: B3 runs T = 16 where it fits (every
//   VIGOR and KITTI call), recomputing h on 1.56x and g on 1.27x the owned
//   pixels (2.25x and 1.56x at T = 8), and copying weights once for four
//   times the pixels.
//
// A K step reads 16 channels of a row: past the last channel it reads the
// row's padding, the next pixel's first channels or the plane's 16-byte
// tail, all finite (shared memory is zeroed when a block starts, and every
// value stored after is a finite bf16), against B rows past K that are
// zero (each such lane points its ldmatrix at the zero region at offset 0),
// so their products are exact zeros. Where a ragged item's rows run past
// the box, they read pixel 0 and are not stored.
//
// What bounds it on an H100: operations, at 989 TFLOP/s bf16 on the tensor
// cores about 0.25 ms of a train step's 2.7 TFLOP in both kernels against
// ~0.1 ms of their bytes; what holds it above that is the instructions
// around the products and each tile's barriers (ops/lmu_cuda.py::
// bwd_phase_cycles times the backward by phase, this source built with
// -DCCVPE_LMU_PHASE_TIMER).
//
// Roundings sit where the TPU kernel's are (lmu_pallas.py): h = deconv + bd
// (:251) and conv_a + b1 before the ReLU (:192), da after the mask (:465),
// dh for dx and dwd (:483-487) after dbd's float32 sums of it (:488), dskip
// and dx as they are stored (:491-492), each to nearest even, as it is
// stored into a bf16 plane or into device memory. y and the weight and bias
// gradients stay float32. A conv's K order is fixed (conv_tc: tap by tap,
// k-steps of 16 summed in fresh accumulators, added in tap order), so B2
// at any T and B3's recompute give the same bits of h and g, and B3's ReLU
// mask is B2's. The weight gradients are summed per block into partial
// slices and reduced in block order (lmu_reduce_kernel), no float atomics:
// two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "tf32_mma.cuh"   // cp.async; mma.sync m16n8k16 bf16 and ldmatrix; mma_entry

using bf16 = __nv_bfloat16;

// Every kernel's dynamic shared memory, indexed in bf16 values through
// smem(); offset 0 holds the zero region (zero_size).
extern __shared__ __align__(16) unsigned char smem_raw[];

namespace {

__device__ __forceinline__ bf16* smem() { return reinterpret_cast<bf16*>(smem_raw); }

// Threads of B3's block (one block an SM at VIGOR's stage 5); B2 takes 512
// where one block fills an SM's shared memory, else 256 (two blocks an SM).
constexpr int kBwdThreads = 512;
constexpr int kSmallBlock = 256;
constexpr int kLargeBlock = 512;
// m-tiles of 16 pixels in one warp item of a conv: B2's two, so that each B
// fragment (16 weight rows by 8 channels) serves 32 pixels; B3's two where
// the item holds up to three n-tiles of 8 channels, else one (at four or
// five, two m-tiles' accumulators pushed B3, at its 128 registers a thread,
// into spills, and its stage-5 calls ran slower on the card). A choice of
// who computes an output, never of its sum.
constexpr int kFwdMTiles = 2;
__host__ __device__ constexpr int bwd_mtiles(int nt) { return nt <= 3 ? 2 : 1; }

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int round8(int n) { return (n + 7) / 8 * 8; }

// bf16 values from one pixel's row to the next in a plane of c channels,
// and from one K row to the next in a weight operand of c output channels.
__host__ __device__ constexpr int pix_stride(int c) {
  return (c + 7) / 8 % 2 ? (c + 7) / 8 * 8 : (c + 7) / 8 * 8 + 8;
}

// bf16 values of a plane of npix pixels of c channels, with its 16-byte tail.
__host__ __device__ constexpr int plane_size(int npix, int c) { return npix * pix_stride(c) + 8; }

// n-tiles of 8 output channels in one warp item: all of them up to 5, else
// the fewest groups of at most 5, evened out (7 -> 4 + 3, 11 -> 4 + 4 + 3).
// A ragged last group starts early and recomputes tiles of the group before
// (conv_tc), storing only its own.
__host__ __device__ inline int n_group(int n) {
  const int tiles = (n + 7) / 8, groups = (tiles + 4) / 5;
  return (tiles + groups - 1) / groups;
}

__device__ inline void cp_async16_bf16(bf16* dst, const bf16* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// 16 bytes, or 16 zero bytes when !valid (src is then not read)
__device__ inline void cp_async16z_bf16(bf16* dst, const bf16* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// 4 bytes (two bf16 values), or 4 zero bytes when !valid
__device__ inline void cp_async4z_bf16(bf16* dst, const bf16* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ inline bf16 to_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ inline float to_f32(bf16 v) { return __bfloat162float(v); }

// Zeroes the first n bf16 values of shared memory (n a multiple of 8).
__device__ void zero_smem(int n) {
  uint4* p = reinterpret_cast<uint4*>(smem());
  for (int i = threadIdx.x; i < n / 8; i += blockDim.x) p[i] = make_uint4(0, 0, 0, 0);
}

// This thread's elements threadIdx.x, + blockDim.x, ... of a box of side^2
// pixels by n items, as (row r, column col, item c), stepped with adds and
// compares: no division per element.
struct BoxWalk {
  int c, col, r, n, side, step_c, step_col, step_r;
  __device__ BoxWalk(int side_, int n_) : n(n_), side(side_) {
    const int step_p = blockDim.x / n;
    step_c = blockDim.x % n;
    step_col = step_p % side;
    step_r = step_p / side;
    c = threadIdx.x % n;
    col = threadIdx.x / n % side;
    r = threadIdx.x / n / side;
  }
  __device__ void next() {
    c += step_c;
    col += step_col;
    r += step_r;
    if (c >= n) { c -= n; ++col; }
    if (col >= side) { col -= side; ++r; }
  }
};

// Channels [c0, c0 + nc) of pixel p = r*side + col of the plane dst (row
// stride s) = src[b, y0 + r, x0 + col, 0:nc] inside the image, else zeros.
// Rows of whole 16-byte runs (nc and c0 multiples of 8: skip, dy and the
// padded x at every VIGOR and KITTI call) or of 4-byte runs (nc and c0
// even: the heads' dy) go by cp.async (the caller commits); others (skip
// after an odd Cd, off the VIGOR and KITTI widths) by loads and stores,
// kBatch a thread in flight, done when the call returns.
__device__ void load_plane(bf16* dst, int s, int c0, int side, const bf16* __restrict__ src,
                           int b, int h, int w, int nc, int y0, int x0) {
  const bf16* img = src + static_cast<size_t>(b) * h * w * nc;
  if (nc % 2 == 0 && c0 % 2 == 0) {
    const int run = nc % 8 == 0 && c0 % 8 == 0 ? 8 : 2;
    const int runs = nc / run, n = side * side * runs;
    BoxWalk k(side, runs);
    for (int i = threadIdx.x; i < n; i += blockDim.x, k.next()) {
      const int gy = y0 + k.r, gx = x0 + k.col;
      const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
      bf16* to = dst + (k.r * side + k.col) * s + c0 + run * k.c;
      const bf16* from = in ? img + (static_cast<size_t>(gy) * w + gx) * nc + run * k.c : src;
      if (run == 8)
        cp_async16z_bf16(to, from, in);
      else
        cp_async4z_bf16(to, from, in);
    }
    return;
  }
  constexpr int kBatch = 16;
  const int n = side * side * nc;
  BoxWalk k(side, nc);
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * blockDim.x) {
    bf16 v[kBatch];
    int at[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u, k.next()) {
      const int gy = y0 + k.r, gx = x0 + k.col;
      v[u] = to_bf16(0.f);
      at[u] = i0 + u * blockDim.x < n ? (k.r * side + k.col) * s + c0 + k.c : -1;
      if (at[u] >= 0 && gy >= 0 && gy < h && gx >= 0 && gx < w)
        v[u] = img[(static_cast<size_t>(gy) * w + gx) * nc + k.c];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (at[u] >= 0) dst[at[u]] = v[u];
  }
}

// dst[0, n) = src[0, n): n bf16 values (a multiple of 8, a weight operand)
// as 16-byte cp.async copies, committed as one group.
__device__ void copy_weights(bf16* dst, const bf16* __restrict__ src, int n) {
  for (int i = 8 * threadIdx.x; i < n; i += 8 * blockDim.x) cp_async16_bf16(dst + i, src + i);
  cp_async_commit();
}

// Tap offsets, in pixels of the input box: a KS x KS conv's tap ky*KS + kx
// lies ky rows and kx columns from the output pixel's corner; dx's taps are
// dh's four deconv phases (di, dj) of a T x T box.
template <int KS>
struct SquareTaps {
  int side;
  __device__ int operator()(int tap) const { return tap / KS * side + tap % KS; }
};

struct PhaseTaps {
  int side;
  __device__ int operator()(int ph) const { return ph / 2 * side + ph % 2; }
};

// A conv on the tensor cores, as an implicit GEMM:
//   out(r, c)[co] = sum over tap < NTAP, k < k_ch of
//     in[(r*step)*in_side + c*step + taps(tap)][k] * w[tap][k][co]
// for the out_side^2 pixels of the output box (M, row p = r*out_side + c),
// co < n (N), K = (tap, channel). in: a plane (row stride in_s); w: the
// operand [NTAP][k_ch][pix_stride(n)]. One warp item is MT m-tiles of 16
// pixels by NT n-tiles of 8 channels; a ragged last n-group starts early,
// recomputes tiles of the group before and stores only its own. The K order
// is fixed: tap by tap, and within a tap k-steps of 16 channels, into one
// float32 accumulator (bias[co] added after the last, where bias is given;
// its values are loaded when an item starts); so an output's sum depends on
// its own inputs alone, never on the tile, the item or the warp. epi(r, c,
// co, v) stores an output and returns what it adds to its column's sum:
// with colsum, the sums over each item's stored pixels of each column co <
// colsum_n land in colsum[m-group * colsum_n + co] (a shuffle tree over the
// item's rows, one writer each; no atomics). Item i goes to warp (first +
// i) % warps, so calls with no barrier between continue the rotation;
// returns first + its item count.
template <int NTAP, int MT, int NT, class Taps, class Epi>
__device__ int conv_tc_nt(const bf16* in, int in_s, int in_side, int step, Taps taps, int k_ch,
                          const bf16* w, int n, const float* __restrict__ bias, int out_side,
                          int first, Epi epi, float* colsum, int colsum_n) {
  const int np = pix_stride(n);
  const int npos = out_side * out_side;
  const int ntiles = (n + 7) / 8, nng = (ntiles + NT - 1) / NT;
  const int items = (npos + 16 * MT - 1) / (16 * MT) * nng;
  const int lane = threadIdx.x % 32, lrow = lane % 16, lcol = 8 * (lane / 16);
  const int nwarps = blockDim.x / 32;
  const unsigned in_a = smem_addr(in), w_a = smem_addr(w), zero_a = smem_addr(smem());
  for (int it = (threadIdx.x / 32 - first % nwarps + nwarps) % nwarps; it < items; it += nwarps) {
    const int mg = it / nng, n_own = it % nng * 8 * NT, m0 = mg * 16 * MT;
    const int n0 = imin(n_own, (ntiles - NT) * 8);   // a ragged last group starts earlier
    int px[MT];   // the input pixel of this lane's A row (row lrow of each m-tile)
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int p = m0 + 16 * i + lrow < npos ? m0 + 16 * i + lrow : 0;
      px[i] = p / out_side * step * in_side + p % out_side * step;
    }
    float bv[NT][2];   // the biases of this lane's columns n0 + 8j + 2(lane % 4) + h
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = n0 + 8 * j + 2 * (lane % 4) + h;
        bv[j][h] = bias && co < n ? bias[co] : 0.f;
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
      unsigned a_row[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) a_row[i] = in_a + 2 * ((px[i] + toff) * in_s + lcol);
      const unsigned w_tap = w_a + 2 * (tap * k_ch * np + n0);
      for (int k0 = 0; k0 < k_ch; k0 += 16) {
        uint32_t a[MT][4], b[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) ldsm_x4(a[i], a_row[i] + 2 * k0);
        const int k = k0 + lrow;
        load_b_frags(b, NT, k < k_ch ? w_tap + 2 * k * np : zero_a + 2 * n0);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], b[j]);
      }
    }
    float cs[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // this lane's output row m0 + 16i + lane/4 + 8h, as (r, c) once
        const int p = m0 + 16 * i + lane / 4 + 8 * h;
        if (p >= npos) continue;
        const int r = p / out_side, c = p % out_side;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = n0 + 8 * j + 2 * (lane % 4) + e;
            if (co >= n_own && co < n) cs[j][e] += epi(r, c, co, acc[i][j][2 * h + e] + bv[j][e]);
          }
      }
    if (colsum) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = cs[j][h];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          const int co = n0 + 8 * j + 2 * lane + h;
          if (lane < 4 && co >= n_own && co < colsum_n) colsum[mg * colsum_n + co] = v;
        }
    }
  }
  return first + items;
}

// conv_tc_nt with NT = n_group(n) and MT = kFwdMTiles (B2) or bwd_mtiles(NT)
// (B3, kBwd).
template <int NTAP, bool kBwd, class Taps, class Epi>
__device__ int conv_tc(const bf16* in, int in_s, int in_side, int step, Taps taps, int k_ch,
                       const bf16* w, int n, const float* bias, int out_side, int first, Epi epi,
                       float* colsum = nullptr, int colsum_n = 0) {
#define CCVPE_CONV(NT)                                                                          \
  conv_tc_nt<NTAP, kBwd ? bwd_mtiles(NT) : kFwdMTiles, NT>(in, in_s, in_side, step, taps, k_ch, \
                                                           w, n, bias, out_side, first, epi,    \
                                                           colsum, colsum_n)
  switch (n_group(n)) {
    case 5: return CCVPE_CONV(5);
    case 4: return CCVPE_CONV(4);
    case 3: return CCVPE_CONV(3);
    case 2: return CCVPE_CONV(2);
    default: return CCVPE_CONV(1);
  }
#undef CCVPE_CONV
}

// Weight gradients over npx pixels for NTAP taps, as products with M = m
// channels of the A plane, N = n channels of the B plane and K = pixels:
//   part[(tap*m + ci)*n + co] += sum over k < npx of A[apix(tap, k)][ci] * B[bpix(tap, k)][co]
// in k-steps of 16 pixels (A and B by ldmatrix.trans; pixels past npx read
// the zero region), one float32 sum an entry. Each warp owns whole (tap, 16
// channels, NT n-tiles) items and adds its sums into its own entries of the
// block's partial slice, read before the product so their latency hides
// behind it. Item i goes to warp (first + i) % warps; returns first + its
// item count.
template <int NTAP, int NT, class APix, class BPix>
__device__ int wgrad_tc_nt(const bf16* a_pl, int a_s, APix apix, int m, const bf16* b_pl, int b_s,
                           BPix bpix, int n, int npx, int first, float* __restrict__ part) {
  const int nmt = (m + 15) / 16, ntiles = (n + 7) / 8, nng = (ntiles + NT - 1) / NT;
  const int items = NTAP * nmt * nng;
  const int lane = threadIdx.x % 32;
  const int arow = lane % 8 + 8 * (lane / 16), acol = 8 * (lane / 8 % 2), brow = lane % 16;
  const int nwarps = blockDim.x / 32;
  const unsigned a_a = smem_addr(a_pl), b_a = smem_addr(b_pl), zero_a = smem_addr(smem());
  for (int it = (threadIdx.x / 32 - first % nwarps + nwarps) % nwarps; it < items; it += nwarps) {
    const int n_own = it % nng * 8 * NT, rest = it / nng;
    const int m0 = rest % nmt * 16, tap = rest / nmt;
    const int n0 = imin(n_own, (ntiles - NT) * 8);
    float* dst = part + tap * m * n;
    float prev[NT][4], acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int2 mn = mma_entry(e, m0, n0 + 8 * j);
        prev[j][e] = mn.x < m && mn.y >= n_own && mn.y < n ? dst[mn.x * n + mn.y] : 0.f;
        acc[j][e] = 0.f;
      }
#pragma unroll 2
    for (int k0 = 0; k0 < npx; k0 += 16) {
      uint32_t a[4], b[NT][2];
      const int ka = k0 + arow, kb = k0 + brow;
      ldsm_x4_trans(a, ka < npx ? a_a + 2 * (apix(tap, ka) * a_s + m0 + acol)
                                : zero_a + 2 * (m0 + acol));
      load_b_frags(b, NT, kb < npx ? b_a + 2 * (bpix(tap, kb) * b_s + n0) : zero_a + 2 * n0);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[j], a, b[j]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int2 mn = mma_entry(e, m0, n0 + 8 * j);
        if (mn.x < m && mn.y >= n_own && mn.y < n) dst[mn.x * n + mn.y] = prev[j][e] + acc[j][e];
      }
  }
  return first + items;
}

template <int NTAP, class APix, class BPix>
__device__ int wgrad_tc(const bf16* a_pl, int a_s, APix apix, int m, const bf16* b_pl, int b_s,
                        BPix bpix, int n, int npx, int first, float* __restrict__ part) {
#define CCVPE_WGRAD(NT) \
  wgrad_tc_nt<NTAP, NT>(a_pl, a_s, apix, m, b_pl, b_s, bpix, n, npx, first, part)
  switch (n_group(n)) {
    case 5: return CCVPE_WGRAD(5);
    case 4: return CCVPE_WGRAD(4);
    case 3: return CCVPE_WGRAD(3);
    case 2: return CCVPE_WGRAD(2);
    default: return CCVPE_WGRAD(1);
  }
#undef CCVPE_WGRAD
}

// part[co] += sum over the NB x NB box at pixel org of a plane (box rows
// `side` pixels apart, row stride s) of channel co, for co < cout: one warp
// a channel, lane l summing pixels l, l + 32, ... in order, then a shuffle
// tree, a fixed order. Channel co goes to warp (first + co) % warps;
// returns first + cout.
template <int NB>
__device__ int bias_grad(const bf16* pl, int s, int side, int org, int cout, int first,
                         float* __restrict__ part) {
  const int lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int co = (threadIdx.x / 32 - first % nwarps + nwarps) % nwarps; co < cout; co += nwarps) {
    float acc = 0.f;
    for (int k = lane; k < NB * NB; k += 32)
      acc += to_f32(pl[(org + k / NB * side + k % NB) * s + co]);
#pragma unroll
    for (int o = 16; o > 0; o /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) part[co] += acc;
  }
  return first + cout;
}

// --- the per-phase timer (built only with -DCCVPE_LMU_PHASE_TIMER), as in
// csrc/lmu.cu: BwdPhase names the phases of the tile loop
// (ops/lmu_cuda.py::BWD_PHASES); in the timed build each ends at a barrier
// after which thread 0 adds the clock64 cycles since the last mark to its
// sum in shared memory; the build without the define holds neither.
enum BwdPhase {
  kPhPlanes, kPhDeconv, kPhW1, kPhConvA, kPhW2t, kPhDa, kPhWgrad21, kPhW1t, kPhDh, kPhWdt,
  kPhDx, kPhWgradD, kBwdPhases
};

#ifdef CCVPE_LMU_PHASE_TIMER
__device__ unsigned long long* g_phase_cycles;   // [blocks][kBwdPhases], set by the host
__shared__ unsigned long long s_phase_cycles[kBwdPhases];

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

__device__ void tile_origin(const Dims& d, int tile, int* b, int* ty0, int* tx0) {
  const int per = d.nty * d.ntx;
  *b = tile / per;
  const int rem = tile % per;
  *ty0 = (rem / d.ntx) * d.t;
  *tx0 = (rem % d.ntx) * d.t;
}

// The zero region at offset 0: as wide as the widest row any ldmatrix may
// read there (a weight operand's padded columns, or 16 channels past an
// m-tile's start in a weight gradient).
__host__ __device__ inline int zero_size(const Dims& d) {
  int w = 0;
  for (int c : {d.cin, d.cd + d.cs, d.cd, d.c1, d.cout}) w = imax(w, pix_stride(c));
  return w + 16;
}

// Shared memory of the forward, in bf16 values: the zero region; A holds
// the h|skip planes on (T+4)^2, later w2; B the coarse x planes, later g on
// (T+2)^2; W wd, later w1.
struct FwdLayout { int a, b, w, total; };

__host__ __device__ FwdLayout fwd_layout(const Dims& d) {
  const int c = d.cd + d.cs, hs = d.t + 4, gs = d.t + 2, xs = hs / 2;
  FwdLayout l;
  l.a = zero_size(d);
  l.b = l.a + imax(plane_size(hs * hs, c), 9 * d.c1 * pix_stride(d.cout));
  l.w = l.b + imax(plane_size(xs * xs, d.cin), plane_size(gs * gs, d.c1));
  l.total = l.w + imax(4 * d.cin * pix_stride(d.cd), 9 * c * pix_stride(d.c1));
  return l;
}

// The backward's weight operands in the order its tile loop reads them,
// and where they live (csrc/lmu.cu's WeightOp and WeightMode).
enum WeightOp { kOpWd, kOpW1, kOpW2t, kOpW1t, kOpWdt, kWeightOps };
enum WeightMode { kStreamOne, kStreamTwo, kResident };

// bf16 values of a backward weight operand, [tap][K][pix_stride(N)].
__host__ __device__ inline int bwd_weight_size(const Dims& d, int op) {
  const int c = d.cd + d.cs;
  switch (op) {
    case kOpWd: return 4 * d.cin * pix_stride(d.cd);
    case kOpW1: return 9 * c * pix_stride(d.c1);
    case kOpW2t: return 9 * d.cout * pix_stride(d.c1);
    case kOpW1t: return 9 * d.c1 * pix_stride(c);
    default: return 4 * d.cd * pix_stride(d.cin);
  }
}

// m-groups of B3's dh|dskip conv (n = Cd + Cs output channels) over the T
// x T box: the rows of dbd's column sums; the layout holds the most, one a
// 16-pixel m-tile.
__host__ __device__ inline int dbd_groups(int t, int n) {
  const int mt = bwd_mtiles(n_group(n));
  return (t * t + 16 * mt - 1) / (16 * mt);
}

// Shared memory of the backward, in bf16 values: the zero region; the
// planes hc = [h|skip] and dy on (T+4)^2, g and da on (T+2)^2, the coarse x
// box, dh on T^2; dbd's column sums (float32); the weights: w[op] for each
// operand when resident, else the buffers w[0] and w[1] (the same one in
// kStreamOne), each as large as the largest operand; then, `ahead`, second
// dy and x planes dy2 and x2, into which the next tile's are copied while
// this tile runs (else dy2 = dy, x2 = x).
struct BwdLayout { int hc, g, dy, da, x, dh, dbd, w[kWeightOps], dy2, x2, total; };

__host__ __device__ BwdLayout bwd_layout(const Dims& d, int mode, bool ahead) {
  const int c = d.cd + d.cs, hs = d.t + 4, gs = d.t + 2, xs = hs / 2;
  BwdLayout l;
  l.hc = zero_size(d);
  l.g = l.hc + plane_size(hs * hs, c);
  l.dy = l.g + plane_size(gs * gs, d.c1);
  l.da = l.dy + plane_size(hs * hs, d.cout);
  l.x = l.da + plane_size(gs * gs, d.c1);
  l.dh = l.x + plane_size(xs * xs, d.cin);
  l.dbd = l.dh + plane_size(d.t * d.t, d.cd);
  int end = l.dbd + round8(2 * (d.t * d.t + 15) / 16 * d.cd);
  if (mode == kResident) {
    for (int op = 0; op < kWeightOps; ++op) {
      l.w[op] = end;
      end += bwd_weight_size(d, op);
    }
  } else {
    int wmax = 0;
    for (int op = 0; op < kWeightOps; ++op) wmax = imax(wmax, bwd_weight_size(d, op));
    for (int op = 0; op < kWeightOps; ++op) l.w[op] = end;
    if (mode == kStreamTwo) l.w[1] = end + wmax;
    end = l.w[1] + wmax;
  }
  l.dy2 = l.dy;
  l.x2 = l.x;
  if (ahead) {
    l.dy2 = end;
    l.x2 = l.dy2 + plane_size(hs * hs, d.cout);
    end = l.x2 + plane_size(xs * xs, d.cin);
  }
  l.total = end;
  return l;
}

// One block's slice of the weight-gradient partials (floats), csrc/lmu.cu's:
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

// h planes (channels [0, cd) of the hs^2 plane h, row stride h_s) on the
// fine region at (fy0, fx0) = deconv of the coarse x box (side xs = hs/2 at
// (fy0/2, fx0/2)) + bd, rounded to bf16; 0 outside the image. The four
// phases are four one-tap convs of the x box, one warp rotation. kBwd: B3's
// conv items (conv_tc), else B2's.
template <bool kBwd>
__device__ int deconv_tile(bf16* h, int h_s, const bf16* xp, int x_s, int xs, const bf16* w,
                           const float* __restrict__ bd, int cin, int cd, int img_h, int img_w,
                           int fy0, int fx0) {
  const int hs = 2 * xs, w_ph = cin * pix_stride(cd);
  int first = 0;
  for (int ph = 0; ph < 4; ++ph) {
    const int di = ph / 2, dj = ph % 2;
    first = conv_tc<1, kBwd>(xp, x_s, xs, 1, SquareTaps<1>{xs}, cin, w + ph * w_ph, cd, bd, xs,
                             first, [&](int r, int c, int co, float v) {
                               const int rr = 2 * r + di, cc = 2 * c + dj;
                               const int gy = fy0 + rr, gx = fx0 + cc;
                               const bool in = gy >= 0 && gy < img_h && gx >= 0 && gx < img_w;
                               h[(rr * hs + cc) * h_s + co] = to_bf16(in ? v : 0.f);
                               return 0.f;
                             });
  }
  return first;
}

// g = relu(bf16(conv3x3(hc, w1) + b1)) on the gs^2 region at (gy0, gx0),
// gs = hs - 2; 0 outside the image. kBwd as in deconv_tile.
template <bool kBwd>
__device__ void conv_a_tile(bf16* g, int g_s, const bf16* hc, int h_s, int hs, const bf16* w,
                            const float* __restrict__ b1, int c, int c1, int img_h, int img_w,
                            int gy0, int gx0) {
  const int gs = hs - 2;
  conv_tc<9, kBwd>(hc, h_s, hs, 1, SquareTaps<3>{hs}, c, w, c1, b1, gs, 0,
                   [&](int r, int cc, int co, float v) {
                     const int gy = gy0 + r, gx = gx0 + cc;
                     const bool in = gy >= 0 && gy < img_h && gx >= 0 && gx < img_w;
                     const bf16 a = to_bf16(v);
                     g[(r * gs + cc) * g_s + co] = in && to_f32(a) > 0.f ? a : to_bf16(0.f);
                     return 0.f;
                   });
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads, kThreads == kSmallBlock ? 2 : 1)
lmu_fwd_bf16_kernel(Dims d, const bf16* __restrict__ x, const bf16* __restrict__ skip,
                    const bf16* __restrict__ wd, const float* __restrict__ bd,
                    const bf16* __restrict__ w1, const float* __restrict__ b1,
                    const bf16* __restrict__ w2, const float* __restrict__ b2,
                    float* __restrict__ y) {
  const FwdLayout l = fwd_layout(d);
  bf16* sa = smem() + l.a;
  bf16* sb = smem() + l.b;
  bf16* sw = smem() + l.w;
  const int c = d.cd + d.cs, hs = d.t + 4, gs = d.t + 2, xs = hs / 2;
  const int h_s = pix_stride(c), x_s = pix_stride(d.cin), g_s = pix_stride(d.c1);
  const int img_h = 2 * d.hc, img_w = 2 * d.wc;
  int b, ty0, tx0;
  tile_origin(d, blockIdx.x, &b, &ty0, &tx0);

  zero_smem(l.total);
  __syncthreads();
  load_plane(sb, x_s, 0, xs, x, b, d.hc, d.wc, round8(d.cin), ty0 / 2 - 1, tx0 / 2 - 1);
  if (d.cs) load_plane(sa, h_s, d.cd, hs, skip, b, img_h, img_w, d.cs, ty0 - 2, tx0 - 2);
  cp_async_commit();
  copy_weights(sw, wd, 4 * d.cin * pix_stride(d.cd));
  cp_async_wait<0>();
  __syncthreads();
  deconv_tile<false>(sa, h_s, sb, x_s, xs, sw, bd, d.cin, d.cd, img_h, img_w, ty0 - 2, tx0 - 2);
  __syncthreads();
  copy_weights(sw, w1, 9 * c * pix_stride(d.c1));
  cp_async_wait<0>();
  __syncthreads();
  conv_a_tile<false>(sb, g_s, sa, h_s, hs, sw, b1, c, d.c1, img_h, img_w, ty0 - 1, tx0 - 1);
  __syncthreads();
  copy_weights(sa, w2, 9 * d.c1 * pix_stride(d.cout));
  cp_async_wait<0>();
  __syncthreads();
  const int cout = d.cout;
  conv_tc<9, false>(sb, g_s, gs, 1, SquareTaps<3>{gs}, d.c1, sa, cout, b2, d.t, 0,
                    [&](int r, int cc, int co, float v) {
                      const int gy = ty0 + r, gx = tx0 + cc;
                      if (gy < img_h && gx < img_w)
                        y[((static_cast<size_t>(b) * img_h + gy) * img_w + gx) * cout + co] = v;
                      return 0.f;
                    });
}

// B3 on bf16: csrc/lmu.cu::lmu_bwd_kernel's tile loop, phase by phase and
// with the same weight copies in each mode, on the planes and products
// above. T is a template argument, so that the weight gradients' pixel
// boxes (T x T, and T/2 x T/2 for the deconv) are compile-time constants.
// dh's conv stores dh rounded to bf16 and sums it unrounded by column
// (conv_tc's colsum), which gives dbd in a fixed order.
template <int T>
__global__ void __launch_bounds__(kBwdThreads, 1)
lmu_bwd_bf16_kernel(Dims d, int mode, BwdLayout l, PartLayout pl, const bf16* __restrict__ x,
                    const bf16* __restrict__ skip, const bf16* __restrict__ dy,
                    const bf16* __restrict__ wd, const float* __restrict__ bd,
                    const bf16* __restrict__ w1, const float* __restrict__ b1,
                    const bf16* __restrict__ w2t, const bf16* __restrict__ w1t,
                    const bf16* __restrict__ wdt, bf16* __restrict__ dx,
                    bf16* __restrict__ dskip, float* __restrict__ part) {
  constexpr int t = T, hs = t + 4, gs = t + 2, xs = hs / 2, tc = t / 2;
  bf16* s_hc = smem() + l.hc;
  bf16* s_g = smem() + l.g;
  bf16* s_da = smem() + l.da;
  bf16* s_dh = smem() + l.dh;
  float* s_dbd = reinterpret_cast<float*>(smem() + l.dbd);
  const int c = d.cd + d.cs;
  const int img_h = 2 * d.hc, img_w = 2 * d.wc;
  const int cd = d.cd, cs = d.cs, cin = d.cin, c1 = d.c1, cout = d.cout;
  const int h_s = pix_stride(c), g_s = pix_stride(c1), y_s = pix_stride(cout);
  const int x_s = pix_stride(cin), dh_s = pix_stride(cd);
  float* mine = part + static_cast<size_t>(blockIdx.x) * pl.total;
  const bool resident = mode == kResident, two = mode == kStreamTwo;
  auto wslot = [&](int op, int it) -> bf16* {
    if (resident) return smem() + l.w[op];
    return smem() + (((op + it) & 1) ? l.w[1] : l.w[0]);
  };
  auto fetch = [&](int op, const bf16* src, int it) {
    copy_weights(wslot(op, it), src, bwd_weight_size(d, op));
  };
  zero_smem(l.total);
  __syncthreads();
  if (resident) {
    fetch(kOpWd, wd, 0);
    fetch(kOpW1, w1, 0);
    fetch(kOpW2t, w2t, 0);
    fetch(kOpW1t, w1t, 0);
    fetch(kOpWdt, wdt, 0);
  } else if (two) {
    fetch(kOpWd, wd, 0);
  }
  // x and dy of tile `tl` into the planes of the block's it-th tile
  auto load_x_dy = [&](int tl, int it) {
    int b_, y0, x0;
    tile_origin(d, tl, &b_, &y0, &x0);
    load_plane(smem() + ((it & 1) ? l.x2 : l.x), x_s, 0, xs, x, b_, d.hc, d.wc, round8(cin),
               y0 / 2 - 1, x0 / 2 - 1);
    load_plane(smem() + ((it & 1) ? l.dy2 : l.dy), y_s, 0, hs, dy, b_, img_h, img_w,
               cout + cout % 2, y0 - 2,
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
    bf16* s_x = smem() + ((it & 1) ? l.x2 : l.x);
    bf16* s_dy = smem() + ((it & 1) ? l.dy2 : l.dy);
    const bool next = tile + gridDim.x < d.ntiles;
    const bool pre = ahead && next;
    __syncthreads();   // the previous tile's last readers are done
    if (!ahead) load_x_dy(tile, it);
    if (cs) load_plane(s_hc, h_s, cd, hs, skip, b, img_h, img_w, cs, ty0 - 2, tx0 - 2);
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
    cp_async_wait_upto(two + pre);
    __syncthreads();
    timer.mark(kPhPlanes);
    // recompute h and g exactly as the forward does
    deconv_tile<true>(s_hc, h_s, s_x, x_s, xs, wslot(kOpWd, it), bd, cin, cd, img_h, img_w,
                      ty0 - 2, tx0 - 2);
    __syncthreads();
    timer.mark(kPhDeconv);
    if (!resident) {
      if (two) {
        fetch(kOpW2t, w2t, it);
        cp_async_wait_upto(1 + pre);
      } else {
        fetch(kOpW1, w1, it);
        cp_async_wait<0>();
      }
      __syncthreads();
      timer.mark(kPhW1);
    }
    conv_a_tile<true>(s_g, g_s, s_hc, h_s, hs, wslot(kOpW1, it), b1, c, c1, img_h, img_w,
                      ty0 - 1, tx0 - 1);
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
    // da = relu'(a) * conv3x3(dy, flipT(w2)) on (T+2)^2, rounded
    conv_tc<9, true>(s_dy, y_s, hs, 1, SquareTaps<3>{hs}, cout, wslot(kOpW2t, it), c1, nullptr, gs,
                     0, [&](int r, int cc, int co, float v) {
                       const int i = (r * gs + cc) * g_s + co;
                       s_da[i] = to_f32(s_g[i]) > 0.f ? to_bf16(v) : to_bf16(0.f);
                       return 0.f;
                     });
    __syncthreads();
    timer.mark(kPhDa);
    if (two) {
      fetch(kOpWdt, wdt, it);
    } else if (!resident) {
      fetch(kOpW1t, w1t, it);
    }
    // conv_b and conv_a weight and bias grads over the T x T owned pixels
    // (tap = ky*3 + kx: the input box shifted by (ky, kx); pixel k = (k / T, k % T))
    int first = wgrad_tc<9>(
        s_g, g_s, [](int tap, int k) { return (k / t + tap / 3) * gs + k % t + tap % 3; }, c1,
        s_dy, y_s, [](int, int k) { return (k / t + 2) * hs + k % t + 2; }, cout, t * t, 0,
        mine + pl.dw2);
    first = bias_grad<t>(s_dy, y_s, hs, 2 * hs + 2, cout, first, mine + pl.db2);
    first = wgrad_tc<9>(
        s_hc, h_s, [](int tap, int k) { return (k / t + tap / 3 + 1) * hs + k % t + tap % 3 + 1; },
        c, s_da, g_s, [](int, int k) { return (k / t + 1) * gs + k % t + 1; }, c1, t * t, first,
        mine + pl.dw1);
    first = bias_grad<t>(s_da, g_s, gs, gs + 1, c1, first, mine + pl.db1);
    timer.mark(kPhWgrad21);
    if (!resident) {
      if (two) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncthreads();
      timer.mark(kPhW1t);
    }
    // [dh | dskip] = conv3x3(da, flipT(w1)) on T^2: dh rounded into its
    // plane (0 outside the image), its float32 column sums for dbd; dskip
    // rounded into device memory
    first = conv_tc<9, true>(
        s_da, g_s, gs, 1, SquareTaps<3>{gs}, c1, wslot(kOpW1t, it), c, nullptr, t, first,
        [&](int r, int cc, int co, float v) {
          const int gy = ty0 + r, gx = tx0 + cc;
          const bool in = gy < img_h && gx < img_w;
          if (co < cd) {
            s_dh[(r * t + cc) * dh_s + co] = to_bf16(in ? v : 0.f);
            return in ? v : 0.f;
          }
          if (in)
            dskip[((static_cast<size_t>(b) * img_h + gy) * img_w + gx) * cs + co - cd] = to_bf16(v);
          return 0.f;
        },
        s_dbd, cd);
    __syncthreads();
    timer.mark(kPhDh);
    if (two) {
      if (next) fetch(kOpWd, wd, it + 1);
    } else if (!resident) {
      fetch(kOpWdt, wdt, it);
    }
    // dbd: the column sums in m-group order; deconv weight grads: x (owned
    // coarse) against dh, by phase (tap = phase di*2 + dj: dh at fine pixel
    // (2r + di, 2c + dj) of coarse pixel k = (r, c))
    for (int co = threadIdx.x; co < cd; co += blockDim.x) {
      float s = 0.f;
      for (int mg = 0; mg < dbd_groups(t, c); ++mg) s += s_dbd[mg * cd + co];
      mine[pl.dbd + co] += s;
    }
    first = wgrad_tc<4>(
        s_x, x_s, [](int, int k) { return (k / tc + 1) * xs + k % tc + 1; }, cin, s_dh, dh_s,
        [](int ph, int k) { return (2 * (k / tc) + ph / 2) * t + 2 * (k % tc) + ph % 2; }, cd,
        tc * tc, first, mine + pl.dwd);
    timer.mark(kPhWgradD);
    if (!resident) {
      if (two && next) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncthreads();
      timer.mark(kPhWdt);
    }
    // dx on the T/2 x T/2 owned coarse pixels: dh's four phases at step 2,
    // the taps of a one-pixel conv against wdT
    const int hc0 = ty0 / 2, wc0 = tx0 / 2;
    conv_tc<4, true>(s_dh, dh_s, t, 2, PhaseTaps{t}, cd, wslot(kOpWdt, it), cin, nullptr, tc, first,
                     [&](int r, int cc, int co, float v) {
                       const int gy = hc0 + r, gx = wc0 + cc;
                       if (gy < d.hc && gx < d.wc)
                         dx[((static_cast<size_t>(b) * d.hc + gy) * d.wc + gx) * cin + co] =
                             to_bf16(v);
                       return 0.f;
                     });
    timer.mark(kPhDx);
  }
  timer.store();
}

using BwdKernel = decltype(&lmu_bwd_bf16_kernel<8>);

BwdKernel bwd_kernel(int t) {
  return t == 16 ? lmu_bwd_bf16_kernel<16>
                 : t == 8 ? lmu_bwd_bf16_kernel<8> : lmu_bwd_bf16_kernel<4>;
}

// out[e] = sum over blocks k = 0, 1, ... of part[k][e], in that order.
__global__ void lmu_reduce_bf16_kernel(const float* __restrict__ part, int nblk, int psize,
                                       float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= psize) return;
  float s = 0.f;
  for (int k = 0; k < nblk; ++k) s += part[static_cast<size_t>(k) * psize + e];
  out[e] = s;
}

// The primitive alone: c [m][n] = a [m][k] b [k][n], a staged row by row
// (row stride pix_stride(k)), b as a weight operand [k][pix_stride(n)], the
// zero region first; each warp takes items of 16 rows x n_group(n) n-tiles,
// k-steps of 16 through the fragment loads of conv_tc. One block; a check
// of the primitive, not a product for the model.
__device__ void probe_items(const bf16* sa, const bf16* sb, float* __restrict__ c, int m, int n,
                            int k) {
  const int nt = n_group(n);
  const int ntiles = (n + 7) / 8, nng = (ntiles + nt - 1) / nt, items = (m + 15) / 16 * nng;
  const int lane = threadIdx.x % 32, lrow = lane % 16, lcol = 8 * (lane / 16);
  const int as = pix_stride(k), np = pix_stride(n);
  const unsigned a_a = smem_addr(sa), b_a = smem_addr(sb), zero_a = smem_addr(smem());
  for (int it = threadIdx.x / 32; it < items; it += blockDim.x / 32) {
    const int m0 = it / nng * 16, n_own = it % nng * 8 * nt;
    const int n0 = imin(n_own, (ntiles - nt) * 8);
    const int row = m0 + lrow < m ? m0 + lrow : 0;
    float acc[5][4] = {};   // n_group(n) <= 5
    for (int k0 = 0; k0 < k; k0 += 16) {
      uint32_t a[4], b[5][2];
      ldsm_x4(a, a_a + 2 * (row * as + k0 + lcol));
      load_b_frags(b, nt, k0 + lrow < k ? b_a + 2 * ((k0 + lrow) * np + n0) : zero_a + 2 * n0);
#pragma unroll
      for (int j = 0; j < 5; ++j)
        if (j < nt) mma_bf16(acc[j], a, b[j]);
    }
#pragma unroll
    for (int j = 0; j < 5; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int2 mn = mma_entry(e, m0, n0 + 8 * j);
        if (j < nt && mn.x < m && mn.y >= n_own && mn.y < n) c[mn.x * n + mn.y] = acc[j][e];
      }
  }
}

__host__ __device__ inline int probe_zero(int m, int n, int k) {
  return imax(pix_stride(n), pix_stride(k)) + 16;
}

__global__ void __launch_bounds__(kSmallBlock)
mma_probe_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                      float* __restrict__ c, int m, int n, int k, int total) {
  const int as = pix_stride(k), np = pix_stride(n);
  bf16* sa = smem() + probe_zero(m, n, k);
  bf16* sb = sa + plane_size(m, k);
  zero_smem(total);
  __syncthreads();
  for (int i = threadIdx.x; i < m * k; i += blockDim.x) sa[i / k * as + i % k] = a[i];
  for (int i = threadIdx.x; i < k * n; i += blockDim.x) sb[i / n * np + i % n] = b[i];
  __syncthreads();
  probe_items(sa, sb, c, m, n, k);
}

// The bf16 mma.sync's issue rate on the card: each warp runs `iters`
// rounds of 8 independent products on register operands (no loads);
// thread 0 of each block writes its loop's clock64 cycles to cycles[block].
__global__ void __launch_bounds__(kLargeBlock)
mma_rate_bf16_kernel(int iters, float* __restrict__ out, long long* __restrict__ cycles) {
  float acc[8][4] = {};
  uint32_t a[4], b[2] = {0x3f803f80u, 0x3f003f00u};   // bf16 pairs (1, 1) and (.5, .5)
  for (int i = 0; i < 4; ++i) a[i] = 0x3c003c00u + threadIdx.x + i;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_bf16(acc[j], a, b);
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

// Blocks of the backward an SM keeps resident with this layout; 0 where the
// layout exceeds `limit` bytes.
cudaError_t bwd_occupancy(const Dims& d, int mode, bool ahead, int limit, int* blocks) {
  *blocks = 0;
  const int bytes = 2 * bwd_layout(d, mode, ahead).total;
  if (bytes > limit) return cudaSuccess;
  const BwdKernel kernel = bwd_kernel(d.t);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kBwdThreads, bytes);
}

}  // namespace

// Forward: y [B,2Hc,2Wc,Cout] float32 = the stage of x [B,Hc,Wc,round8(Cin)]
// (its channels past Cin zero) and skip [B,2Hc,2Wc,Cs] (null when cs = 0),
// both bf16 NHWC; wd [4][Cin][
// pix_stride(Cd)], w1 [9][Cd+Cs][pix_stride(C1)], w2 [9][C1][pix_stride(
// Cout)] bf16 (ops/lmu_cuda.py::kernel_weights_bf16), biases float32. With
// t = 0, the largest fine tile T in {16, 8, 4} whose shared memory fits
// (ops/lmu_cuda.py::bf16_fwd_tile mirrors the rule); t in {16, 8, 4} forces
// that T, for the checks that y's bits do not depend on it. Launches on
// `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for sizes it does not take.
extern "C" int ccvpe_lmu_fwd_bf16(const void* x, const void* skip, const void* wd,
                                  const void* bd, const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* y, int b, int hc, int wc, int cin, int cs,
                                  int cd, int c1, int cout, int t_force, void* stream) {
  if (!dims_ok(b, hc, wc, cin, cs, cd, c1, cout) || (cs > 0) != (skip != nullptr) ||
      (t_force != 0 && t_force != 16 && t_force != 8 && t_force != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int limit = max_smem_bytes();
  for (int t : {16, 8, 4}) {
    if (t_force != 0 && t != t_force) continue;
    const Dims d = make_dims(b, hc, wc, cin, cs, cd, c1, cout, t);
    const int bytes = 2 * fwd_layout(d).total;
    if (bytes > limit) continue;
    const bool large = large_block(bytes);
    auto kernel = large ? lmu_fwd_bf16_kernel<kLargeBlock> : lmu_fwd_bf16_kernel<kSmallBlock>;
    return static_cast<int>(launch(
        kernel, d.ntiles, large ? kLargeBlock : kSmallBlock, bytes,
        static_cast<cudaStream_t>(stream), d, static_cast<const bf16*>(x),
        static_cast<const bf16*>(skip), static_cast<const bf16*>(wd),
        static_cast<const float*>(bd), static_cast<const bf16*>(w1),
        static_cast<const float*>(b1), static_cast<const bf16*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(y)));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Plan of the backward, csrc/lmu.cu's rule over T in {16, 8, 4}: the
// largest T whose planes and one weight buffer fit; the weights resident
// where all five fit beside the planes and an SM keeps at least as many
// blocks as with one buffer, else two buffers on that condition, else one;
// then the planes copied a tile ahead on the same condition. The blocks: as
// many as the card keeps resident, at most one per tile; part_floats: the
// floats of one block's partial slice. The caller allocates nblk *
// part_floats zeroed floats of partials and part_floats floats of sums.
extern "C" int ccvpe_lmu_bwd_plan_bf16(int b, int hc, int wc, int cin, int cs, int cd, int c1,
                                       int cout, int* t_out, int* mode_out, int* ahead_out,
                                       int* nblk, int* part_floats) {
  if (!dims_ok(b, hc, wc, cin, cs, cd, c1, cout)) return static_cast<int>(cudaErrorInvalidValue);
  const int limit = max_smem_bytes();
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int t : {16, 8, 4}) {
    const Dims d = make_dims(b, hc, wc, cin, cs, cd, c1, cout, t);
    int blocks = 0;
    e = bwd_occupancy(d, kStreamOne, false, limit, &blocks);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (blocks == 0) continue;
    const int floor = blocks;
    int mode = kStreamOne;
    for (int m : {kResident, kStreamTwo}) {
      int mb = 0;
      e = bwd_occupancy(d, m, false, limit, &mb);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (mb >= floor) {
        mode = m;
        blocks = mb;
        break;
      }
    }
    int ab = 0;
    e = bwd_occupancy(d, mode, true, limit, &ab);
    if (e != cudaSuccess) return static_cast<int>(e);
    const bool ahead = ab >= floor;
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

// Backward with the plan above: dx [B,Hc,Wc,Cin] and dskip [B,2Hc,2Wc,Cs]
// (null when cs = 0) bf16, and the weight/bias grads reduced into `sums`
// (float32, part_layout's order). x (channels padded to round8(Cin) as the
// forward's), skip and dy [B,2Hc,2Wc,Cout + Cout % 2] (an odd Cout padded
// with a zero channel) bf16; wd, w1, w2t [9][Cout][
// pix_stride(C1)], w1t [9][C1][pix_stride(Cd+Cs)] and wdt [4][Cd][
// pix_stride(Cin)] bf16 (kernel_weights_bf16); biases float32. `part` must
// hold nblk * part_floats zeros.
extern "C" int ccvpe_lmu_bwd_bf16(const void* x, const void* skip, const void* dy, const void* wd,
                                  const void* bd, const void* w1, const void* b1, const void* w2t,
                                  const void* w1t, const void* wdt, void* dx, void* dskip,
                                  void* part, void* sums, int b, int hc, int wc, int cin, int cs,
                                  int cd, int c1, int cout, int t, int mode, int ahead, int nblk,
                                  void* stream) {
  if (!dims_ok(b, hc, wc, cin, cs, cd, c1, cout) || (t != 16 && t != 8 && t != 4) || nblk < 1 ||
      mode < kStreamOne || mode > kResident || (cs > 0) != (skip != nullptr) ||
      (cs > 0) != (dskip != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = make_dims(b, hc, wc, cin, cs, cd, c1, cout, t);
  const BwdLayout l = bwd_layout(d, mode, ahead != 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch(
      bwd_kernel(t), nblk, kBwdThreads, 2 * l.total, s, d, mode, l, part_layout(d),
      static_cast<const bf16*>(x), static_cast<const bf16*>(skip), static_cast<const bf16*>(dy),
      static_cast<const bf16*>(wd), static_cast<const float*>(bd), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2t),
      static_cast<const bf16*>(w1t), static_cast<const bf16*>(wdt), static_cast<bf16*>(dx),
      static_cast<bf16*>(dskip), static_cast<float*>(part));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int psize = part_layout(d).total;
  lmu_reduce_bf16_kernel<<<(psize + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), nblk, psize, static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
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

// The bf16 primitive alone (mma_probe_bf16_kernel): c [m][n] float32 = a
// [m][k] b [k][n], a and b bf16 and contiguous, one block on `stream`.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// sizes whose operands do not fit in a block's shared memory.
extern "C" int ccvpe_mma_probe_bf16(const void* a, const void* b, void* c, int m, int n, int k,
                                    void* stream) {
  if (m < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long total = probe_zero(m, n, k) + static_cast<long>(plane_size(m, k)) +
                     static_cast<long>(k) * pix_stride(n) + 8;
  if (2 * total > max_smem_bytes()) return static_cast<int>(cudaErrorInvalidValue);
  const int tot = static_cast<int>(round8(static_cast<int>(total)));
  return static_cast<int>(launch(mma_probe_bf16_kernel, 1, kSmallBlock, 2 * tot,
                                 static_cast<cudaStream_t>(stream), static_cast<const bf16*>(a),
                                 static_cast<const bf16*>(b), static_cast<float*>(c), m, n, k,
                                 tot));
}

// mma_rate_bf16_kernel on `blocks` blocks of 512 threads: out holds blocks *
// 512 floats, cycles blocks int64. Returns cudaGetLastError() after the launch.
extern "C" int ccvpe_mma_rate_bf16(int blocks, int iters, void* out, void* cycles, void* stream) {
  if (blocks < 1 || iters < 1) return static_cast<int>(cudaErrorInvalidValue);
  mma_rate_bf16_kernel<<<blocks, kLargeBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<float*>(out), static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}
