// Fused orientation-rolled correlation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ccvpe_tpu/ops/corr_pallas.py::_corr_kernel
// (launched by _corr_fwd_pallas, pallas_call at corr_pallas.py:86). Per
// batch b, sat pixel t and orientation bin k:
//
//   num[t,k]  = sum_d S[b,t,d] * G'[b,k,d]
//   den2[t,k] = sum_d S[b,t,d]^2 * M[k,d]
//   out[b,t,k] = num * rsqrtf(den2)          r[b,t,k] = rsqrtf(den2) (optional)
//
// S [B,N,D] float32 or bfloat16, G' [B,K,D] (already divided by the ground
// norm) and M [K,D] 0/1 window masks (any value exact in TF32) float32, all
// contiguous; out, r [B,N,K] float32. A bf16 S (the decoder's maps under
// compute_dtype='bfloat16') is read as it is and scored in float32: the
// same result as on S upcast. With the S^2-rounding type (corr_bf16 at
// D < 128), den2 takes S^2 rounded to bf16, as the JAX package's XLA path
// rounds jnp.square of a bf16 map.
//
// What bounds it on an H100: bytes. The work is one read of S and one write
// of out (and r): one VIGOR forward at batch 8 moves about 222 MB, 66 us at
// 3.35 TB/s, and 279 MB with r (the training call). Its products, 4K flops
// per element of S, are five TF32 products here (three for num, two for
// den2); at the finest scales (D = 40, 80) they take about as long on
// mma.sync as the bytes, so they must overlap the copies.
//
// What the design does about it (ops/corr_cuda.py::corr_plan picks the
// sizes; the wrapper passes them):
// - Fill the card. A block takes tiles of kRows = 64 sat rows of one batch
//   and one slice of D of `w` channels. Where the batch's row tiles alone
//   give fewer than one block per SM (the coarse VIGOR scales), D is split
//   into slices: each block writes its partial num and den2 to a scratch
//   buffer, and corr_reduce_kernel adds the slices in slice order and
//   applies rsqrtf. No atomics, so two runs give the same bits. Where the
//   tiles are many, the grid is one wave of resident blocks (kMinBlocks a
//   SM, its registers guaranteed), each walking its tiles (tile =
//   blockIdx.x + i * gridDim.x).
// - Feed S asynchronously. S reaches shared memory through a ring of
//   kStages stages of one tile x kChunk = 40 channels (40 divides every
//   VIGOR depth, 1280 to 40), as 16-byte cp.async copies (4-byte ones where
//   D or a pointer does not allow them), zero-filled past the rows and
//   channels of S. The ring runs on across tiles: the next stage's copies
//   fly while one stage is multiplied and while a tile's results are
//   stored. Two stages, so that more blocks fit an SM: the blocks, not the
//   stages, hide the latency.
// - Products on the tensor cores, f32-accurate, at the real K. K is padded
//   to KP = 8 * NT (a template parameter: 8, 16, 24 or 32) and each warp
//   takes 32 rows (two m16 tiles) by all KP bins on mma.sync.m16n8k8 TF32
//   (tf32_mma.cuh). num takes three products (S lo.G' hi + S hi.G' lo,
//   then S hi.G' hi); den2 takes two (S^2 lo.M, then S^2 hi.M): M is exact
//   in TF32, so its lo part is zero. S and S^2 are split once per A
//   fragment for all bins. The slice's G' and M arrive by cp.async with
//   the first stage, and G' is split into hi and lo once per block, in
//   shared memory. Each chunk sums in fresh accumulators, added to the
//   tile's float32 sums after the chunk, so no tensor-core accumulation
//   runs longer than 15 products.
// - A contiguous epilogue. A tile's out (and r) is a run of rows x K floats
//   in [B,N,K]: staged in shared memory and stored as 16-byte stores.
// - A bf16 S halves S's bytes, the bulk of the traffic at the decoder
//   scales. It lands in the ring as bf16 (16-byte cp.async copies of 8
//   values; plain loads and stores where D is not a multiple of 8) and is
//   widened at the fragment loads. A bf16 value is exact in TF32, so it is
//   its own hi and its lo is 0: num takes two products (S.G' lo, then
//   S.G' hi), the f32 path's two nonzero ones in its order, so bf16 S and
//   its f32 upcast give the same bits. S^2 rounded to bf16 is exact in TF32
//   too: den2 then takes one product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int kRows = 64;                  // T: sat rows per tile
constexpr int kWarps = 2;                  // 32 rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 40;                 // channels per ring stage
constexpr int kStages = 2;
constexpr int kMaxBins = 32;
constexpr int kMinBlocks = 5;             // resident blocks an SM's registers must hold
constexpr int kMaxSmem = 232448;           // a block's shared memory on sm_90

static_assert(kRows == 32 * kWarps, "each warp takes 32 rows");
static_assert(kChunk % 8 == 0, "a chunk is whole k-steps");

using bf16 = __nv_bfloat16;

// The ring's row of S elements. float: 44 (4 mod 32 words: the A-fragment
// loads of a warp hit 32 banks). bf16: 56 (112 bytes, a multiple of the
// 16-byte copy; 28 words a row, so rows g = 0..7 start 4 banks apart and
// lanes q, q + 1 share a word). Mirrored in ops/corr_cuda.py::RING_STRIDE.
template <class T> struct SRing;
template <> struct SRing<float> { static constexpr int kStride = kChunk + 4; };
template <> struct SRing<bf16> { static constexpr int kStride = kChunk + 16; };

template <class T>
__host__ __device__ constexpr int ring_bytes() {
  return kStages * kRows * SRing<T>::kStride * static_cast<int>(sizeof(T));
}

// S types of the C interface: float, bf16, bf16 with S^2 rounded to bf16
enum SType { kF32 = 0, kBf16 = 1, kBf16RoundSq = 2 };

__host__ __device__ inline int round8(int v) { return (v + 7) / 8 * 8; }

// Shared memory of one block: the ring of T; G' hi, G' lo and M of the
// slice, each KP rows of w + 4 floats (w + 4 is 4 mod 8: the 32 lanes of a
// B-fragment load hit 32 banks); the out and r staging of kRows x k floats.
// Mirrored in ops/corr_cuda.py::smem_bytes.
template <class T>
__host__ __device__ inline int smem_bytes(int w, int k, int kp) {
  return ring_bytes<T>() + 4 * 3 * kp * (w + 4) + 4 * 2 * kRows * k;
}

__host__ __device__ inline int smem_bytes_of(int s_type, int w, int k, int kp) {
  return s_type == kF32 ? smem_bytes<float>(w, k, kp) : smem_bytes<bf16>(w, k, kp);
}

__device__ inline float to_float(float v) { return v; }
__device__ inline float to_float(bf16 v) { return __bfloat162float(v); }

// One element, or a zero when !valid (src then not read): a float by a
// 4-byte cp.async, a bf16 by a plain load and store (cp.async copies 4
// bytes at least). Either is visible to the block after the barrier that
// follows the caller's cp_async_wait.
__device__ inline void copy_one(float* dst, const float* src, bool valid) {
  cp_async4(dst, src, valid);
}
__device__ inline void copy_one(bf16* dst, const bf16* src, bool valid) {
  *dst = valid ? *src : __float2bfloat16(0.f);
}

// dst[r * ds + c] = src[r * ss + c] for r < rows_ok and c < cols_ok, else 0,
// for r < rows, c < cols (a multiple of 16 bytes' elements), as cp.async
// copies of 16 bytes when vec (ss, ds and both pointers 16-byte aligned),
// else element by element. The caller commits. Neighbouring threads copy
// neighbouring units of a row; each thread steps its (row, unit) with
// adds, no division per unit.
template <class T>
__device__ void copy_tile(T* dst, int ds, const T* __restrict__ src, size_t ss, int rows,
                          int rows_ok, int cols, int cols_ok, bool vec) {
  const int per = vec ? 16 / static_cast<int>(sizeof(T)) : 1;   // elements per copy
  const int nu = cols / per;                   // copies per row
  const int total = rows * nu;
  const int step_r = kThreads / nu, step_u = kThreads % nu;
  int row = threadIdx.x / nu, u = threadIdx.x % nu;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const bool ok = row < rows_ok && per * u < cols_ok;
    const T* from = ok ? src + row * ss + per * u : src;
    T* to = dst + row * ds + per * u;
    if (vec)
      cp_async16_zfill(reinterpret_cast<float*>(to), reinterpret_cast<const float*>(from), ok);
    else
      copy_one(to, from, ok);
    u += step_u;
    row += step_r;
    if (u >= nu) { u -= nu; ++row; }
  }
}

// This warp's products over one ring stage: cn/cd[mt][j] += the 16 x 8
// tiles of num and den2 at rows 32 * warp + 16 * mt, bins 8 * j, over the
// stage's first 8 * nks channels. gh, gl and mm point at the stage's first
// channel of G' hi, G' lo and M; rs is their row stride. A bf16 S skips the
// product of its zero lo; kRoundSq rounds S^2 to bf16, which skips S^2 lo.
template <int NT, class TS, bool kRoundSq>
__device__ void stage_products(const TS* slot, const float* gh, const float* gl,
                               const float* mm, int rs, int nks, float (&cn)[2][NT][4],
                               float (&cd)[2][NT][4]) {
  constexpr int kStride = SRing<TS>::kStride;
  constexpr bool kSplitS = std::is_same<TS, float>::value;
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const TS* a0 = slot + (threadIdx.x / 32 * 32 + g) * kStride + q;
  const int b0 = g * rs + q;
#pragma unroll
  for (int ks = 0; ks < kChunk / 8; ++ks) {
    if (ks >= nks) break;
    uint32_t sh[2][4], sl[2][4], qh[2][4], ql[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const TS* a = a0 + mt * 16 * kStride + ks * 8;
      const float v[4] = {to_float(a[0]), to_float(a[8 * kStride]), to_float(a[4]),
                          to_float(a[8 * kStride + 4])};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kSplitS)
          split_tf32(v[e], sh[mt][e], sl[mt][e]);
        else
          sh[mt][e] = __float_as_uint(v[e]);            // a bf16 value is exact in TF32
        if constexpr (kRoundSq)
          qh[mt][e] = __float_as_uint(__bfloat162float(__float2bfloat16_rn(v[e] * v[e])));
        else
          split_tf32(v[e] * v[e], qh[mt][e], ql[mt][e]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int at = b0 + 8 * j * rs + ks * 8;           // B (k = q, n = g), then k = q + 4
      const uint32_t bh[2] = {__float_as_uint(gh[at]), __float_as_uint(gh[at + 4])};
      const uint32_t bl[2] = {__float_as_uint(gl[at]), __float_as_uint(gl[at + 4])};
      const uint32_t bm[2] = {__float_as_uint(mm[at]), __float_as_uint(mm[at + 4])};
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if constexpr (kSplitS) mma_tf32(cn[mt][j], sl[mt], bh);
        mma_tf32(cn[mt][j], sh[mt], bl);
        mma_tf32(cn[mt][j], sh[mt], bh);
        if constexpr (!kRoundSq) mma_tf32(cd[mt][j], ql[mt], bm);
        mma_tf32(cd[mt][j], qh[mt], bm);
      }
    }
  }
}

// dst[0, count) = src[0, count) (src 16-byte aligned in shared memory), as
// 16-byte stores where dst allows them.
__device__ void store_run(float* dst, const float* src, int count) {
  int i = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = count / 4;
    for (; i < n4; i += kThreads)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
    i = 4 * n4 + threadIdx.x;
  }
  for (; i < count; i += kThreads) dst[i] = src[i];
}

// grid (x, slices, B); blockIdx.x walks tiles blockIdx.x + i * gridDim.x of
// `tiles`. part is null with one slice, else [slices][B*N][2][KP] partial
// (num, den2) sums, bins < k written. TS: S's type.
template <int NT, class TS, bool kRoundSq>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
corr_fwd_kernel(const TS* __restrict__ s, const float* __restrict__ g,
                const float* __restrict__ m, float* __restrict__ out, float* __restrict__ r,
                float* __restrict__ part, int n, int d, int k, int w, int tiles, bool vec) {
  constexpr int kp = 8 * NT;
  constexpr int kStride = SRing<TS>::kStride;
  extern __shared__ float4 smem4[];
  TS* ring = reinterpret_cast<TS*>(smem4);
  const int rs = w + 4;
  float* gh = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + ring_bytes<TS>());
                                                        // G' hi, then G' lo, then M
  float* gl = gh + kp * rs;
  float* mm = gl + kp * rs;
  float* stage_out = mm + kp * rs;
  float* stage_r = stage_out + kRows * k;

  const int b = blockIdx.z, slice = blockIdx.y;
  const int d0 = slice * w;
  const int ws = min(w, d - d0);                         // this slice's channels
  const int nchunks = (ws + kChunk - 1) / kChunk;
  const int gx = gridDim.x, t0 = blockIdx.x;
  const int total = (tiles - t0 + gx - 1) / gx * nchunks;
  const TS* s_b = s + static_cast<size_t>(b) * n * d;

  // issue side of the ring: stage `issued` of (tile, chunk) pairs
  int issued = 0, is_t = t0, is_c = 0;
  auto issue = [&]() {
    if (issued < total) {
      const int c0 = is_c * kChunk, row0 = is_t * kRows, cw = min(kChunk, ws - c0);
      copy_tile(ring + issued % kStages * kRows * kStride, kStride,
                s_b + static_cast<size_t>(row0) * d + d0 + c0, d, kRows, n - row0, round8(cw),
                cw, vec);
      if (++is_c == nchunks) { is_c = 0; is_t += gx; }
      ++issued;
    }
    cp_async_commit();                                  // empty groups keep the count
  };
  // the slice's G' (into gh) and M, zero past K and past the slice, in the
  // first group with stage 0
  copy_tile(gh, rs, g + static_cast<size_t>(b) * k * d + d0, d, kp, k, w, ws, vec);
  copy_tile(mm, rs, m + d0, d, kp, k, w, ws, vec);
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) issue();
  cp_async_wait<kStages - 2>();
  __syncthreads();
  // G' split once into hi (in place) and lo; the padding columns are never read
  for (int i = threadIdx.x; i < kp * rs; i += kThreads) {
    uint32_t hi, lo;
    split_tf32(gh[i], hi, lo);
    gh[i] = __uint_as_float(hi);
    gl[i] = __uint_as_float(lo);
  }

  const int warp = threadIdx.x / 32;
  float sn[2][NT][4], sd[2][NT][4];                     // the tile's sums
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sn[mt][j][e] = sd[mt][j][e] = 0.f;

  int tile = t0, chunk = 0;
  for (int i = 0; i < total; ++i) {
    cp_async_wait<kStages - 2>();                       // stage i has landed
    __syncthreads();                                    // ... for all; stage i-1's slot is free
    issue();
    const int c0 = chunk * kChunk;
    float cn[2][NT][4], cd[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) cn[mt][j][e] = cd[mt][j][e] = 0.f;
    stage_products<NT, TS, kRoundSq>(ring + i % kStages * kRows * kStride, gh + c0, gl + c0,
                                     mm + c0, rs, (min(kChunk, ws - c0) + 7) / 8, cn, cd);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sn[mt][j][e] += cn[mt][j][e];
          sd[mt][j][e] += cd[mt][j][e];
        }
    if (++chunk < nchunks) continue;

    // the tile is done: its out and r, or its partial sums
    const int row0 = tile * kRows;
    if (part == nullptr) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int2 rc = mma_entry(e, warp * 32 + mt * 16, 8 * j);
            if (rc.y >= k) continue;
            const float rv = rsqrtf(sd[mt][j][e]);
            stage_out[rc.x * k + rc.y] = sn[mt][j][e] * rv;
            if (r != nullptr) stage_r[rc.x * k + rc.y] = rv;
          }
      __syncthreads();
      const int count = min(kRows, n - row0) * k;
      const size_t base = (static_cast<size_t>(b) * n + row0) * k;
      store_run(out + base, stage_out, count);
      if (r != nullptr) store_run(r + base, stage_r, count);
    } else {
      const size_t rows = static_cast<size_t>(gridDim.z) * n;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int2 rc = mma_entry(2 * h, warp * 32 + mt * 16, 8 * j);
            if (row0 + rc.x >= n || rc.y >= k) continue;
            float* p = part + ((slice * rows + static_cast<size_t>(b) * n + row0 + rc.x) * 2) * kp;
            *reinterpret_cast<float2*>(p + rc.y) = make_float2(sn[mt][j][2 * h], sn[mt][j][2 * h + 1]);
            *reinterpret_cast<float2*>(p + kp + rc.y) =
                make_float2(sd[mt][j][2 * h], sd[mt][j][2 * h + 1]);
          }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sn[mt][j][e] = sd[mt][j][e] = 0.f;
    chunk = 0;
    tile += gx;
  }
  cp_async_wait<0>();
}

// out[e], r[e] for e < rows * k (rows = B*N): the slices' partial sums of
// element e's row and bin, added in slice order from 0, then rsqrtf.
__global__ void __launch_bounds__(256)
corr_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, float* __restrict__ r,
                   int rows, int k, int kp, int slices) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<size_t>(rows) * k) return;
  const int row = static_cast<int>(e / k), kk = static_cast<int>(e - static_cast<size_t>(row) * k);
  float num = 0.f, den = 0.f;
  for (int sl = 0; sl < slices; ++sl) {
    const float* p = part + (static_cast<size_t>(sl) * rows + row) * 2 * kp;
    num += p[kk];
    den += p[kp + kk];
  }
  const float rv = rsqrtf(den);
  out[e] = num * rv;
  if (r != nullptr) r[e] = rv;
}

template <int NT, class TS, bool kRoundSq>
cudaError_t launch_fwd(dim3 grid, int smem, cudaStream_t stream, const TS* s, const float* g,
                       const float* m, float* out, float* r, float* part, int n, int d, int k,
                       int w, int tiles, bool vec) {
  const auto kernel = corr_fwd_kernel<NT, TS, kRoundSq>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(s, g, m, out, r, part, n, d, k, w, tiles, vec);
  return cudaGetLastError();
}

// launch_fwd at NT = kp / 8
template <class TS, bool kRoundSq>
cudaError_t launch_nt(int kp, dim3 grid, int smem, cudaStream_t stream, const void* s,
                      const float* g, const float* m, float* out, float* r, float* part, int n,
                      int d, int k, int w, int tiles, bool vec) {
  const auto* sp = static_cast<const TS*>(s);
  switch (kp / 8) {
    case 1: return launch_fwd<1, TS, kRoundSq>(grid, smem, stream, sp, g, m, out, r, part, n, d, k, w, tiles, vec);
    case 2: return launch_fwd<2, TS, kRoundSq>(grid, smem, stream, sp, g, m, out, r, part, n, d, k, w, tiles, vec);
    case 3: return launch_fwd<3, TS, kRoundSq>(grid, smem, stream, sp, g, m, out, r, part, n, d, k, w, tiles, vec);
    default: return launch_fwd<4, TS, kRoundSq>(grid, smem, stream, sp, g, m, out, r, part, n, d, k, w, tiles, vec);
  }
}

template <int NT, class TS, bool kRoundSq>
int occupancy(int smem) {
  const auto kernel = corr_fwd_kernel<NT, TS, kRoundSq>;
  int blocks = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem) != cudaSuccess)
    return -1;
  return blocks;
}

template <class TS, bool kRoundSq>
int occupancy_nt(int kp, int smem) {
  switch (kp / 8) {
    case 1: return occupancy<1, TS, kRoundSq>(smem);
    case 2: return occupancy<2, TS, kRoundSq>(smem);
    case 3: return occupancy<3, TS, kRoundSq>(smem);
    default: return occupancy<4, TS, kRoundSq>(smem);
  }
}

bool plan_ok(int k, int kp, int w, int s_type) {
  return k >= 1 && k <= kMaxBins && kp == round8(k) && w >= 8 && w % 8 == 0 &&
         s_type >= kF32 && s_type <= kBf16RoundSq && smem_bytes_of(s_type, w, k, kp) <= kMaxSmem;
}

}  // namespace

// Resident corr_fwd_kernel blocks per SM at that shared memory for an S of
// s_type (0 float, 1 bf16, 2 bf16 with S^2 rounded; the occupancy API), or
// -1 for a plan the kernel does not take.
extern "C" int ccvpe_corr_occupancy(int w, int k, int kp, int s_type) {
  if (!plan_ok(k, kp, w, s_type)) return -1;
  const int smem = smem_bytes_of(s_type, w, k, kp);
  switch (s_type) {
    case kF32: return occupancy_nt<float, false>(kp, smem);
    case kBf16: return occupancy_nt<bf16, false>(kp, smem);
    default: return occupancy_nt<bf16, true>(kp, smem);
  }
}

// Launch on `stream` (a cudaStream_t passed as a pointer) with the plan of
// ops/corr_cuda.py::corr_plan: K padded to kp, slices of w channels
// (slices = ceil(d / w)), grid_x blocks along the row tiles; s of s_type
// (0 float, 1 bf16, 2 bf16 with S^2 rounded to bf16 in den2). part: a
// scratch of slices * b * n * 2 * kp floats when slices > 1, else unused;
// r may be null. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for sizes or a plan the kernel does not take.
// Allocates nothing and does not synchronise.
extern "C" int ccvpe_corr_fwd(const void* s, const void* g, const void* m, void* out, void* r,
                              void* part, int b, int n, int d, int k, int kp, int w, int slices,
                              int grid_x, int s_type, void* stream) {
  const int tiles = (n + kRows - 1) / kRows;
  if (b < 1 || b > 65535 || n < 1 || d < 1 || !plan_ok(k, kp, w, s_type) ||
      slices != (d + w - 1) / w || slices > 65535 || (slices > 1 && part == nullptr) ||
      grid_x < 1 || grid_x > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto cs = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const float*>(g);
  const auto* mp = static_cast<const float*>(m);
  // 16-byte copies: rows of S, G' and M start 16-byte aligned
  const int per16 = s_type == kF32 ? 4 : 8;
  const bool vec = d % per16 == 0 && ((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(gp) |
                                       reinterpret_cast<uintptr_t>(mp)) & 15) == 0;
  float* pp = slices > 1 ? static_cast<float*>(part) : nullptr;
  float* rp = static_cast<float*>(r);
  const dim3 grid(grid_x, slices, b);
  const int smem = smem_bytes_of(s_type, w, k, kp);
  auto* op = static_cast<float*>(out);
  cudaError_t err;
  switch (s_type) {
    case kF32:
      err = launch_nt<float, false>(kp, grid, smem, cs, s, gp, mp, op, rp, pp, n, d, k, w, tiles, vec);
      break;
    case kBf16:
      err = launch_nt<bf16, false>(kp, grid, smem, cs, s, gp, mp, op, rp, pp, n, d, k, w, tiles, vec);
      break;
    default:
      err = launch_nt<bf16, true>(kp, grid, smem, cs, s, gp, mp, op, rp, pp, n, d, k, w, tiles, vec);
  }
  if (err != cudaSuccess || pp == nullptr) return static_cast<int>(err);
  const int rows = b * n;
  const long long elems = static_cast<long long>(rows) * k;
  corr_reduce_kernel<<<static_cast<unsigned>((elems + 255) / 256), 256, 0, cs>>>(pp, op, rp, rows,
                                                                                 k, kp, slices);
  return static_cast<int>(cudaGetLastError());
}
