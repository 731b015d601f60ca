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
// S [B,N,D], G' [B,K,D] (already divided by the ground norm), M [K,D] 0/1
// window masks, all float32 and contiguous; out, r [B,N,K].
//
// What bounds it on an H100: bytes, narrowly. The work is one read of S and
// one write of out; the arithmetic is 4K flops per 4-byte element of S, i.e.
// K flop/byte, 20 at K = 20, which is the card's own float32 ratio
// (67 TFLOP/s over 3.35 TB/s). With the output writes counted, one VIGOR
// forward at batch 8 moves ~222 MB (~66 us) for ~3.3 GFLOP (~49 us), so
// bytes bound it. This kernel computes all kMaxBins = 32 bin slots, so its
// own arithmetic is 32/K times the needed work.
//
// What the design does about it: S is read from device memory once (the
// plain two-product version reads it twice and writes num and den2 out).
// One block takes a tile of kTileRows sat rows of one batch; the tile of S
// and the matching D-chunk of G' and M are staged through shared memory,
// chunk by chunk, and every S value in shared memory is used for all K bins
// of both products. Each thread keeps a 2-row x 4-bin register tile of num
// and den2 accumulators in float32; the epilogue applies rsqrtf and stores.
// Ragged edges of N, D and K are zero-filled in shared memory and masked at
// the store. One code path covers every D; the TPU kernel's 'combine'
// branch, which exists for the MXU's 128-wide padding, has no counterpart.
// Tensor cores (wgmma), TMA and a windowed-sum den2 are for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 64;                              // T: sat rows per block
constexpr int kChunk = 32;                                 // D-chunk in shared memory
constexpr int kMaxBins = 32;                               // largest K taken
constexpr int kThreads = 256;
constexpr int kBinGroups = 8;                              // threads across K
constexpr int kRowGroups = kThreads / kBinGroups;          // threads across rows
constexpr int kRowsPerThread = kTileRows / kRowGroups;     // 2
constexpr int kBinsPerThread = kMaxBins / kBinGroups;      // 4
constexpr int kStride = kChunk + 1;                        // pad against bank conflicts

static_assert(kTileRows % kRowGroups == 0, "rows must split evenly");
static_assert(kMaxBins % kBinGroups == 0, "bins must split evenly");

__global__ void __launch_bounds__(kThreads)
corr_fwd_kernel(const float* __restrict__ s, const float* __restrict__ g,
                const float* __restrict__ m, float* __restrict__ out,
                float* __restrict__ r, int n, int d, int k) {
  __shared__ float s_sh[kTileRows * kStride];
  __shared__ float g_sh[kMaxBins * kStride];
  __shared__ float m_sh[kMaxBins * kStride];

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kTileRows;
  const int tid = threadIdx.x;
  const int bin_group = tid % kBinGroups;
  const int row_group = tid / kBinGroups;
  const float* s_b = s + static_cast<size_t>(b) * n * d;
  const float* g_b = g + static_cast<size_t>(b) * k * d;

  float num[kRowsPerThread][kBinsPerThread];
  float den[kRowsPerThread][kBinsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j) {
      num[i][j] = 0.f;
      den[i][j] = 0.f;
    }
  }

  for (int d0 = 0; d0 < d; d0 += kChunk) {
    // Stage the S tile: consecutive threads read consecutive columns.
    for (int idx = tid; idx < kTileRows * kChunk; idx += kThreads) {
      const int rr = idx / kChunk;
      const int c = idx % kChunk;
      const int row = row0 + rr;
      const int col = d0 + c;
      s_sh[rr * kStride + c] =
          (row < n && col < d) ? s_b[static_cast<size_t>(row) * d + col] : 0.f;
    }
    // Stage the G' and M chunks; bins >= K and columns >= D are zero.
    for (int idx = tid; idx < kMaxBins * kChunk; idx += kThreads) {
      const int kk = idx / kChunk;
      const int c = idx % kChunk;
      const int col = d0 + c;
      const bool ok = kk < k && col < d;
      const size_t off = static_cast<size_t>(kk) * d + col;
      g_sh[kk * kStride + c] = ok ? g_b[off] : 0.f;
      m_sh[kk * kStride + c] = ok ? m[off] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kChunk; ++c) {
      float sv[kRowsPerThread];
      float gv[kBinsPerThread];
      float mv[kBinsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        sv[i] = s_sh[(row_group + i * kRowGroups) * kStride + c];
#pragma unroll
      for (int j = 0; j < kBinsPerThread; ++j) {
        gv[j] = g_sh[(bin_group + j * kBinGroups) * kStride + c];
        mv[j] = m_sh[(bin_group + j * kBinGroups) * kStride + c];
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float sq = sv[i] * sv[i];
#pragma unroll
        for (int j = 0; j < kBinsPerThread; ++j) {
          num[i][j] = fmaf(sv[i], gv[j], num[i][j]);
          den[i][j] = fmaf(sq, mv[j], den[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = row0 + row_group + i * kRowGroups;
    if (row >= n) continue;
    const size_t base = (static_cast<size_t>(b) * n + row) * k;
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j) {
      const int kk = bin_group + j * kBinGroups;
      if (kk >= k) continue;
      const float rv = rsqrtf(den[i][j]);
      out[base + kk] = num[i][j] * rv;
      if (r != nullptr) r[base + kk] = rv;
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer); r may be null.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// sizes the kernel does not take. Allocates nothing and does not synchronise.
extern "C" int ccvpe_corr_fwd(const void* s, const void* g, const void* m,
                              void* out, void* r, int b, int n, int d, int k,
                              void* stream) {
  if (b < 1 || b > 65535 || n < 1 || d < 1 || k < 1 || k > kMaxBins)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kTileRows - 1) / kTileRows, b);
  corr_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(g),
      static_cast<const float*>(m), static_cast<float*>(out),
      static_cast<float*>(r), n, d, k);
  return static_cast<int>(cudaGetLastError());
}
