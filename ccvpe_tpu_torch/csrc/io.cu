// Image ingest on Hopper (sm_90a): JPEG decode by nvJPEG, then Pillow's
// triangle resize and the ImageNet normalize (or the uint8 round) in one
// hand-written kernel.
//
// The port of native/io.cc (the JAX package's host library: libjpeg and
// libpng decode, build_contribs :147, resize_normalize :179, resize_u8 :231,
// the C API :278-335). It replaces no TPU kernel: the JAX package decodes
// and resizes on the host. On the card the JPEG decode is nvJPEG's (the
// toolkit's decoder, not a kernel of this repository) and the resize is
// resize_kernel; a PNG is decoded by PIL on the host and uploaded, since the
// card's machine has no libpng (ops/resize_cuda.py::rgb_resize).
//
// The resize computes what io.cc computes: contributions from
// build_contribs in float64, cast to float; vertical sums from uint8 rows
// into float rows, then a horizontal gather into (v - 255 mean) * ((1/255) /
// std) or int(v + 0.5) clipped to uint8. Each sum runs tap by tap from the
// first in float, one rounded product and one rounded add a tap (__fmul_rn,
// __fadd_rn: no contraction into an FMA), so the plain version
// (ops/resize_cuda.py::resize_plain) gives the same bits on the same decoded
// pixels.
//
// What bounds it on an H100: the function, bytes. A 2048 x 1024 panorama
// resized to 640 x 320 reads 6.3 MB of pixels and writes 2.5 MB of
// normalized floats (0.6 MB of uint8): 2.6 us at 3.35 TB/s. The kernel, its
// instructions: a rounded product and a rounded add a byte a tap, where an
// FMA would change the bits, and each byte's conversion to float. What the
// design does about both: one block owns a tile of output rows and columns
// of one image and stages the tile's band of input (its rows' taps, its
// columns' taps, times 3 bytes) in shared memory with 16-byte cp.async
// copies, each row from the 16-byte-aligned byte at or below the band's
// first, in chunks of rows, double buffered; the vertical sums of a chunk go
// into a float tile in shared memory, where the next chunk continues them
// in tap order; after the last chunk the horizontal taps are gathered from
// that tile and a warp stores neighbouring output pixels. So the float rows
// never reach device memory: the input is read about once (the halo the
// neighbouring tiles share is read again, mostly from L2) and the output
// written once. A halo column two blocks both sum gets the same bits in
// each. The tile's weights ride in the first chunk's copies, so no tap waits
// on device memory; a byte becomes a float by a byte permute and an exact
// add; where every row starts at one offset from 16-byte alignment, a
// thread reads 8 aligned bytes a tap. The tile is planned from the largest
// bands that get_contribs computes once a size pair (make_plan): 8 rows x
// 64 columns, halved while the band does not fit the default shared memory,
// so a steep downscale takes a narrower tile and more chunks. One launch
// takes a batch of images of one size (grid z).
//
// Decoding. Per file, in plain code: nvJPEG's hardware backend (the H100's
// JPEG engines), where it was created and nvjpegDecodeBatchedSupported
// takes the file (baseline Huffman); else the GPU-hybrid decoder (Huffman
// on the GPU), where nvjpegDecoderJpegSupported takes it; else the hybrid
// one (Huffman on the host, progressive JPEGs). Output is interleaved RGB
// (NVJPEG_OUTPUT_RGBI) in device memory. Chroma is upsampled with
// interpolation, as libjpeg's default (fancy) upsampling does: a handle that
// nvJPEG will not make so is a fault, since the nearest-neighbour chroma it
// would fall back to is far from libjpeg's. Each backend's files are counted.
//
// Threads and CUDA graphs. One nvJPEG handle a backend family per process
// and card (the hardware one, and the default one the hybrid decoders come
// from). Each call leases a decoder state of its own from a pool kept for
// the process: a non-blocking stream (never the legacy default stream), the
// hardware and hybrid decoders' states with their pinned and device
// buffers, and the lease's device and pinned buffers for the decoded and
// resized images, grown to the largest image seen and never shrunk. So
// concurrent callers decode at once, and a loader's threads that come and
// go allocate nothing once the pool is warm. Each
// entry of the ingest path runs in CUDA's relaxed stream-capture mode
// (cudaThreadExchangeStreamCaptureMode): a CUDA graph that another thread
// captures in global mode meanwhile is not invalidated by this thread's
// allocations or synchronisations, which touch only its own stream.
//
// C API (0 on success; 1 a broken JPEG, as io.cc's 1; 2 a CUDA or nvJPEG
// fault, its message from ccvpe_io_last_error; 3 bad arguments; 4 a JPEG
// that nvJPEG does not decode, which the caller decodes on the host and
// hands to ccvpe_io_rgb_resize as backend kRefused):
//   ccvpe_io_init(device, backends)     (bit b: Backend b created)
//   ccvpe_io_image_info(data, len, device, h, w)
//   ccvpe_io_decode(data, len, out, capacity, device, backend)
//   ccvpe_io_decode_resize(data, len, out, out_h, out_w, mode, mean, std, device, backend)
//   ccvpe_io_rgb_resize(rgb, in_h, in_w, out, out_h, out_w, mode, mean, std, device, backend)
//   ccvpe_io_load_batch(datas, lens, n, out, out_h, out_w, mode, mean, std, threads, device,
//                       status, backend, groups)
//   ccvpe_io_resize(src, n, in_h, in_w, out, out_h, out_w, mode, mean, std, device, stream)
//   ccvpe_io_resize_plan(in_h, in_w, out_h, out_w, device, plan)
//   ccvpe_io_backend_counts(counts), ccvpe_io_last_error(buf, size)
// mode 0 writes uint8, 1 normalized float32 (mean and std, 3 floats each).

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <tuple>
#include <utility>
#include <vector>

#include "tf32_mma.cuh"   // cp.async

namespace {

enum Status { kOk = 0, kUndecodable = 1, kFault = 2, kBadArgs = 3, kUnsupported = 4 };
// per-file backends, in the order of ccvpe_io_backend_counts: nvJPEG's
// three; a PNG decoded on the host; a JPEG nvJPEG does not decode, decoded
// on the host
enum Backend { kHardware = 0, kGpuHybrid = 1, kHybrid = 2, kHost = 3, kRefused = 4, kBackends = 5 };

// Both handles' flags: chroma upsampled with interpolation, as libjpeg's
// default (fancy) upsampling does.
constexpr unsigned kHandleFlags = NVJPEG_FLAGS_UPSAMPLING_WITH_INTERPOLATION;

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;   // a block's without opt-in

// The resize's tiles: kTileSizes candidate sizes an axis, index i a tile of
// kTileMax >> i outputs; a block starts from kTileRows x kTileCols and the
// plan halves the columns, then the rows, until the staged band (kStages
// buffers of kChunkRows rows), the float tile and the tile's weights fit
// kDefaultSmem (five blocks an SM); failing that, the card's opt-in maximum
// with fewer rows a chunk (ccvpe_io_resize_plan reports the plan).
constexpr int kTileMax = 64, kTileSizes = 7;
constexpr int kTileRows = 8, kTileCols = 64;
constexpr int kChunkRows = 16, kStages = 2;
// a staged row's bytes past the band's: the 16-byte-aligned start (up to
// 15 bytes below it) and the reads past the band's last byte (the second
// word of its 4-byte group, or the rest of its 8 aligned bytes)
constexpr int kPitchSlack = 23;

thread_local std::string g_error;   // the calling thread's last fault
std::atomic<long long> g_counts[kBackends];

int fail(int status, const std::string& what) {
  g_error = what;
  return status;
}

int cuda_fail(const char* what, cudaError_t e) {
  return fail(kFault, std::string(what) + ": " + cudaGetErrorString(e));
}

int nvjpeg_fail(const char* what, nvjpegStatus_t s) {
  return fail(kFault, std::string(what) + ": nvJPEG status " + std::to_string(static_cast<int>(s)));
}

#define CUDA_TRY(x)                                  \
  do {                                               \
    const cudaError_t e_ = (x);                      \
    if (e_ != cudaSuccess) return cuda_fail(#x, e_); \
  } while (0)
#define NVJPEG_TRY(x)                                              \
  do {                                                             \
    const nvjpegStatus_t s_ = (x);                                 \
    if (s_ != NVJPEG_STATUS_SUCCESS) return nvjpeg_fail(#x, s_);   \
  } while (0)
#define STATUS_TRY(x)             \
  do {                            \
    const int st_ = (x);          \
    if (st_ != kOk) return st_;   \
  } while (0)

// A failed nvJPEG call on a file's bytes: 1 for a broken bitstream (libjpeg
// fails on it too), 4 for a JPEG that nvJPEG does not decode (libjpeg may),
// else a fault (INVALID_PARAMETER among them: an argument of this file's).
int bitstream_fail(const char* what, nvjpegStatus_t s) {
  if (s == NVJPEG_STATUS_BAD_JPEG || s == NVJPEG_STATUS_INCOMPLETE_BITSTREAM)
    return fail(kUndecodable, std::string(what) + ": a broken JPEG (nvJPEG status " +
                                  std::to_string(static_cast<int>(s)) + ")");
  if (s == NVJPEG_STATUS_JPEG_NOT_SUPPORTED)
    return fail(kUnsupported, std::string(what) + ": a JPEG nvJPEG does not decode");
  return nvjpeg_fail(what, s);
}

// This thread in relaxed stream-capture mode for the scope, its mode after.
struct RelaxedCapture {
  cudaStreamCaptureMode mode = cudaStreamCaptureModeRelaxed;
  RelaxedCapture() { cudaThreadExchangeStreamCaptureMode(&mode); }
  ~RelaxedCapture() { cudaThreadExchangeStreamCaptureMode(&mode); }
};

// The calling thread's current device set for the scope.
struct DeviceScope {
  int prev = -1;
  cudaError_t set(int device) {
    cudaError_t e = cudaGetDevice(&prev);
    return e != cudaSuccess ? e : cudaSetDevice(device);
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// ---------------- Pillow's triangle weights (io.cc::build_contribs) ----------------

struct HostContribs {
  int ksize = 0;
  std::vector<int> first, taps;
  std::vector<float> w;   // [out, ksize], zero past each row's taps
};

HostContribs build_contribs(int in_size, int out_size) {
  HostContribs c;
  const double scale = double(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;
  c.ksize = int(std::ceil(support)) * 2 + 1;
  c.first.resize(out_size);
  c.taps.resize(out_size);
  c.w.assign(size_t(out_size) * c.ksize, 0.0f);
  std::vector<double> wd(c.ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    double ww = 0.0;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    const int n = xmax - xmin;
    std::fill(wd.begin(), wd.end(), 0.0);
    for (int x = 0; x < n; ++x) {
      const double arg = (x + xmin - center + 0.5) / filterscale;
      double w = arg < 0 ? 1.0 + arg : 1.0 - arg;
      if (w < 0) w = 0;
      wd[x] = w;
      ww += w;
    }
    if (ww != 0.0)
      for (int x = 0; x < n; ++x) wd[x] /= ww;
    c.first[xx] = xmin;
    c.taps[xx] = n;
    for (int x = 0; x < n; ++x) c.w[size_t(xx) * c.ksize + x] = float(wd[x]);
  }
  return c;
}

// One axis's weights on the card: [first (out ints)][taps (out ints)][w (out * ksize floats)];
// and the largest band of inputs a tile of kTileMax >> i outputs reads
// (its last output's first + taps - its first output's first).
struct DevContribs {
  const int* first = nullptr;
  const int* taps = nullptr;
  const float* w = nullptr;
  int ksize = 0;
  int band[kTileSizes] = {};
};

std::mutex g_contribs_mu;
std::map<std::tuple<int, int, int>, DevContribs> g_contribs;   // (device, in, out)

// The weights of in_size -> out_size on `device`, uploaded once (on
// `stream`, waited for) and kept for the process.
int get_contribs(int device, int in_size, int out_size, cudaStream_t stream, DevContribs* out) {
  std::lock_guard<std::mutex> lock(g_contribs_mu);
  const auto key = std::make_tuple(device, in_size, out_size);
  const auto it = g_contribs.find(key);
  if (it != g_contribs.end()) {
    *out = it->second;
    return kOk;
  }
  const HostContribs h = build_contribs(in_size, out_size);
  for (int n : h.taps)
    if (n < 1) return fail(kBadArgs, "a resize row with no taps");
  // a tile's band runs from its first output's first tap to its last
  // output's last: first and first + taps never fall from one output to
  // the next (Pillow's window slides with the centre)
  for (int i = 1; i < out_size; ++i)
    if (h.first[i] < h.first[i - 1] || h.first[i] + h.taps[i] < h.first[i - 1] + h.taps[i - 1])
      return fail(kBadArgs, "a resize window that moves back");
  const size_t ints = size_t(out_size) * sizeof(int);
  std::vector<char> blob(2 * ints + h.w.size() * sizeof(float));
  std::memcpy(blob.data(), h.first.data(), ints);
  std::memcpy(blob.data() + ints, h.taps.data(), ints);
  std::memcpy(blob.data() + 2 * ints, h.w.data(), h.w.size() * sizeof(float));
  char* dev = nullptr;
  CUDA_TRY(cudaMalloc(&dev, blob.size()));
  CUDA_TRY(cudaMemcpyAsync(dev, blob.data(), blob.size(), cudaMemcpyHostToDevice, stream));
  CUDA_TRY(cudaStreamSynchronize(stream));
  DevContribs d;
  d.first = reinterpret_cast<const int*>(dev);
  d.taps = reinterpret_cast<const int*>(dev + ints);
  d.w = reinterpret_cast<const float*>(dev + 2 * ints);
  d.ksize = h.ksize;
  for (int i = 0; i < kTileSizes; ++i) {
    const int t = kTileMax >> i;
    for (int o0 = 0; o0 < out_size; o0 += t) {
      const int o1 = std::min(o0 + t, out_size) - 1;
      d.band[i] = std::max(d.band[i], h.first[o1] + h.taps[o1] - h.first[o0]);
    }
  }
  g_contribs.emplace(key, d);
  *out = d;
  return kOk;
}

// ---------------- the resize kernel ----------------

// A block's tile and staging for one size pair (make_plan).
struct Plan {
  int tr = 0, tc = 0;   // the tile's output rows and columns at most
  int chunk = 0;        // band rows a copy group, in each of kStages buffers
  int pitch = 0;        // a staged row's bytes: the band's, kPitchSlack, to 16
  int twp = 0;          // a float row of the tile: the band's bytes and 15 (staged columns), to 8
  size_t smem = 0;      // kStages * chunk * pitch bytes; floats and ints: smem_words
};

// The shared memory besides the staging buffers, in 4-byte words: the
// float tile, the tile's weights (tr x ky, tc x kx) and each output row's
// and column's first tap and tap count.
size_t smem_words(int tr, int tc, size_t twp, int ky, int kx) {
  return size_t(tr) * (twp + ky + 2) + size_t(tc) * (kx + 2);
}

int tile_index(int tile) {
  int i = 0;
  while ((kTileMax >> i) > tile) ++i;
  return i;
}

// From kTileRows x kTileCols, the columns halved first, then the rows,
// until the plan fits kDefaultSmem with a full chunk; else the opt-in
// maximum with the chunk that fits. Fails where one output's band does not
// fit at all.
int make_plan(const DevContribs& cy, const DevContribs& cx, int out_h, int out_w, int optin,
              Plan* p) {
  for (const size_t limit : {kDefaultSmem, std::max(kDefaultSmem, size_t(optin))}) {
    for (int ir = tile_index(kTileRows); ir < kTileSizes; ++ir) {
      for (int ic = tile_index(kTileCols); ic < kTileSizes; ++ic) {
        const size_t rows = size_t(cy.band[ir]), bytes = 3 * size_t(cx.band[ic]);
        const size_t pitch = (bytes + kPitchSlack + 15) & ~size_t(15);
        const size_t twp = (bytes + 15 + 7) & ~size_t(7);
        Plan q;
        q.tr = std::min(kTileMax >> ir, out_h);
        q.tc = std::min(kTileMax >> ic, out_w);
        const size_t tile = smem_words(q.tr, q.tc, twp, cy.ksize, cx.ksize) * sizeof(float);
        const size_t room = limit > tile ? (limit - tile) / (kStages * pitch) : 0;
        const size_t full = std::min(rows, size_t(kChunkRows));
        const size_t chunk = std::min(full, room);
        if (chunk < (limit == kDefaultSmem ? full : size_t(1))) continue;
        q.chunk = int(chunk);
        q.pitch = int(pitch);
        q.twp = int(twp);
        q.smem = tile + kStages * chunk * pitch;
        *p = q;
        return kOk;
      }
    }
  }
  return fail(kBadArgs, "resize: one output's band of input does not fit in shared memory");
}

__device__ __forceinline__ uint8_t clip8(float v) {
  const int i = __float2int_rz(__fadd_rn(v, 0.5f));   // io.cc: int(v + 0.5f)
  return uint8_t(i < 0 ? 0 : (i > 255 ? 255 : i));
}

// Position of a loop over `count` columns a row, advanced by kThreads:
// (row, column) kept without a division a step.
struct Walk {
  int row, col, step_rows, step_cols, count;
  __device__ Walk(int count_) : count(count_) {
    row = threadIdx.x / count;
    col = threadIdx.x - row * count;
    step_rows = kThreads / count;
    step_cols = kThreads - step_rows * count;
  }
  __device__ void next() {
    row += step_rows;
    col += step_cols;
    if (col >= count) {
      col -= count;
      ++row;
    }
  }
};

// Byte I of v as a float, exactly: the byte under the exponent of 2^23,
// less 2^23 (a byte permute and an add on the full-rate pipes).
template <int I>
__device__ __forceinline__ float byte_float(uint32_t v) {
  return __fsub_rn(__uint_as_float(__byte_perm(v, 0x4B000000u, 0x7540 + I)), 8388608.0f);
}

__device__ __forceinline__ float4 bytes_float(uint32_t v) {
  return make_float4(byte_float<0>(v), byte_float<1>(v), byte_float<2>(v), byte_float<3>(v));
}

// The 4 bytes of a staged row at band byte j (a multiple of 4), as the row
// starts at byte `off` (0-15) of its first 16-byte copy: the two aligned
// words that hold them.
__device__ __forceinline__ float4 quad(const uint8_t* row, int j, int off) {
  const uint32_t* word = reinterpret_cast<const uint32_t*>(row + j + (off & ~3));
  return bytes_float(__funnelshift_r(word[0], word[1], 8 * (off & 3)));
}

// a + w * x, each product and each add rounded (io.cc's float sums)
__device__ __forceinline__ void tap(float4& a, float w, const float4& x) {
  a.x = __fadd_rn(a.x, __fmul_rn(w, x.x));
  a.y = __fadd_rn(a.y, __fmul_rn(w, x.y));
  a.z = __fadd_rn(a.z, __fmul_rn(w, x.z));
  a.w = __fadd_rn(a.w, __fmul_rn(w, x.w));
}

// out[img, y, x, c] for the tile of blockIdx (x: columns, y: rows, z: the
// image). The band's rows are staged by cp.async in chunks of p.chunk rows
// through a ring of kStages buffers (the tile's weights and taps with the
// first chunk); as each chunk lands, its vertical taps are summed into the
// float tile [tr][twp] (a sum continued from chunk to chunk, in tap order);
// then each output pixel's horizontal taps are gathered from the tile and
// rounded (U8) or normalized, a warp on neighbouring pixels. Rows that all
// start at one offset from 16-byte alignment (in_w * 3 a multiple of 16,
// VIGOR's panoramas among them) are summed in staged columns, 8 aligned
// bytes a thread, a band byte's tile column off0 past its own; other rows
// 4 band bytes a thread, from the two words that hold them (the general
// loop alone takes a VIGOR panorama 2.6 us longer on an H100, batch 8
// 16.8 us: tools/resize_variants.py). src uint8
// [n, in_h, in_w * 3]; shared memory: the ring, the float tile, the
// weights, the taps.
template <bool U8>
__global__ void __launch_bounds__(kThreads)
resize_kernel(const uint8_t* __restrict__ src, void* __restrict__ out, DevContribs ay,
              DevContribs ax, int in_h, int in_w, int out_h, int out_w, Plan p, float3 bias,
              float3 inv) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int img = blockIdx.z;
  const int y0 = blockIdx.y * p.tr, x0 = blockIdx.x * p.tc;
  const int tr = min(p.tr, out_h - y0), tc = min(p.tc, out_w - x0);
  const int by0 = ay.first[y0], bx0 = ax.first[x0];
  const int rows = ay.first[y0 + tr - 1] + ay.taps[y0 + tr - 1] - by0;
  const int bytes = (ax.first[x0 + tc - 1] + ax.taps[x0 + tc - 1] - bx0) * 3;
  const int segs = p.pitch >> 4;
  const size_t row_bytes = size_t(in_w) * 3;
  // the band's first byte in its first row, and each row's offset from
  // 16-byte alignment: (off0 + r * step16) mod 16 in band row r
  const uint8_t* band = src + (size_t(img) * in_h + by0) * row_bytes + size_t(bx0) * 3;
  const int off0 = int(reinterpret_cast<uintptr_t>(band) & 15), step16 = int(row_bytes & 15);
  const bool aligned = step16 == 0;
  const int shift = aligned ? off0 : 0;   // a band byte's tile column less its own
  const int stage_bytes = p.chunk * p.pitch;
  const int ky = ay.ksize, kx = ax.ksize;
  float* tile = reinterpret_cast<float*>(smem + kStages * stage_bytes);
  float* wys = tile + p.tr * p.twp;   // [tr][ky]
  float* wxs = wys + p.tr * ky;       // [tc][kx]
  int* fys = reinterpret_cast<int*>(wxs + p.tc * kx);   // first taps and tap counts
  int* nys = fys + p.tr;
  int* fxs = nys + p.tr;
  int* nxs = fxs + p.tc;

  // chunk c of the band, rows [c * chunk, +chunk), into its ring slot, each
  // row from the 16-byte-aligned byte at or below its first: every 16-byte
  // copy holds a byte of the band; one copy group a chunk
  auto stage = [&](int c) {
    const int c0 = c * p.chunk, n = min(p.chunk, rows - c0);
    uint8_t* buf = smem + (c % kStages) * stage_bytes;
    for (Walk w(segs); w.row < n; w.next()) {
      const uint8_t* g = band + size_t(c0 + w.row) * row_bytes;
      const int off = (off0 + (c0 + w.row) * step16) & 15;
      if (w.col < (off + bytes + 15) >> 4)
        cp_async16(reinterpret_cast<float*>(buf + w.row * p.pitch + 16 * w.col),
                   reinterpret_cast<const float*>(g - off + 16 * w.col));
    }
    cp_async_commit();
  };

  // the tile's weights, first taps and tap counts, in the first chunk's
  // copy group (read from device memory a tap at a time, each would be a
  // cache round trip in the sums' chains)
  auto copy4 = [](void* dst, const void* from) {
    cp_async4(static_cast<float*>(dst), static_cast<const float*>(from), true);
  };
  for (int i = threadIdx.x; i < tr * ky; i += kThreads) copy4(wys + i, ay.w + size_t(y0) * ky + i);
  for (int i = threadIdx.x; i < tc * kx; i += kThreads) copy4(wxs + i, ax.w + size_t(x0) * kx + i);
  for (int i = threadIdx.x; i < tr; i += kThreads) {
    copy4(fys + i, ay.first + y0 + i);
    copy4(nys + i, ay.taps + y0 + i);
  }
  for (int i = threadIdx.x; i < tc; i += kThreads) {
    copy4(fxs + i, ax.first + x0 + i);
    copy4(nxs + i, ax.taps + x0 + i);
  }
  const int chunks = (rows + p.chunk - 1) / p.chunk;
  for (int c = 0; c < min(kStages, chunks); ++c) stage(c);

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait_upto(min(chunks, c + kStages) - c - 1);   // chunk c has landed
    __syncthreads();
    const int c0 = c * p.chunk, c1 = min(c0 + p.chunk, rows);
    const uint8_t* slot = smem + (c % kStages) * stage_bytes;   // band row r at (r - c0) * pitch
    if (aligned) {
      for (Walk w((off0 + bytes + 7) >> 3); w.row < tr; w.next()) {
        const int y = w.row, j = 8 * w.col;
        const int fy = fys[y] - by0, k0 = max(0, c0 - fy), k1 = min(nys[y], c1 - fy);
        if (k0 >= k1) continue;   // none of this output row's taps in the chunk
        float4* acc = reinterpret_cast<float4*>(tile + y * p.twp + j);
        // 0 + the first product is that product: the plain version's first term
        float4 a = k0 == 0 ? zero : acc[0], b = k0 == 0 ? zero : acc[1];
        const float* wk = wys + y * ky + k0;
        const uint8_t* row = slot + (fy + k0 - c0) * p.pitch + j;
#pragma unroll 2
        for (int k = k0; k < k1; ++k, row += p.pitch) {
          const uint2 v = *reinterpret_cast<const uint2*>(row);
          const float wt = *wk++;
          tap(a, wt, bytes_float(v.x));
          tap(b, wt, bytes_float(v.y));
        }
        acc[0] = a;
        acc[1] = b;
      }
    } else {
      for (Walk w((bytes + 3) >> 2); w.row < tr; w.next()) {
        const int y = w.row, j = 4 * w.col;
        const int fy = fys[y] - by0, k0 = max(0, c0 - fy), k1 = min(nys[y], c1 - fy);
        if (k0 >= k1) continue;
        float4* acc = reinterpret_cast<float4*>(tile + y * p.twp + j);
        float4 a = k0 == 0 ? zero : *acc;
        const float* wk = wys + y * ky + k0;
        const uint8_t* row = slot + (fy + k0 - c0) * p.pitch;
        int off = (off0 + (fy + k0) * step16) & 15;
#pragma unroll 2
        for (int k = k0; k < k1; ++k, row += p.pitch, off = (off + step16) & 15)
          tap(a, *wk++, quad(row, j, off));
        *acc = a;
      }
    }
    __syncthreads();   // the slot is free for chunk c + kStages
    if (c + kStages < chunks) stage(c + kStages);
  }

  // the horizontal taps: a thread an output pixel, a warp neighbouring ones
  for (Walk w(tc); w.row < tr; w.next()) {
    const int y = w.row, x = w.col;
    const int nx = nxs[x];
    const float* wx = wxs + x * kx;
    const float* t = tile + y * p.twp + (fxs[x] - bx0) * 3 + shift;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll 4
    for (int k = 0; k < nx; ++k, t += 3) {
      const float wk = wx[k];
      a0 = __fadd_rn(a0, __fmul_rn(wk, t[0]));
      a1 = __fadd_rn(a1, __fmul_rn(wk, t[1]));
      a2 = __fadd_rn(a2, __fmul_rn(wk, t[2]));
    }
    const size_t o = ((size_t(img) * out_h + y0 + y) * out_w + x0 + x) * 3;
    if constexpr (U8) {
      uint8_t* q = static_cast<uint8_t*>(out) + o;
      q[0] = clip8(a0);
      q[1] = clip8(a1);
      q[2] = clip8(a2);
    } else {
      float* q = static_cast<float*>(out) + o;
      q[0] = __fmul_rn(__fsub_rn(a0, bias.x), inv.x);
      q[1] = __fmul_rn(__fsub_rn(a1, bias.y), inv.y);
      q[2] = __fmul_rn(__fsub_rn(a2, bias.z), inv.z);
    }
  }
}

bool resize_args_ok(int n, int in_h, int in_w, int out_h, int out_w, int mode, const float* mean,
                    const float* stdv) {
  return n >= 1 && n <= 65535 && in_h >= 1 && in_w >= 1 && out_h >= 1 && out_h <= 65535 &&
         out_w >= 1 && (mode == 0 || (mode == 1 && mean != nullptr && stdv != nullptr)) &&
         size_t(in_w) * 3 <= size_t(INT32_MAX);
}

std::mutex g_optin_mu;
std::map<int, int> g_optin;   // device -> its opt-in shared memory a block

// The kernel's attributes on `device` (the current one), set once for the
// process: the full shared-memory carveout (as many blocks an SM as their
// shared memory takes, not the L1's default share) and the card's opt-in
// maximum as the dynamic shared memory any launch may ask for, so that no
// launch changes them while another thread launches. *optin: that maximum.
int kernel_setup(int device, int* optin) {
  std::lock_guard<std::mutex> lock(g_optin_mu);
  const auto it = g_optin.find(device);
  if (it != g_optin.end()) {
    *optin = it->second;
    return kOk;
  }
  int bytes = 0;
  CUDA_TRY(cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  for (const auto kernel : {&resize_kernel<true>, &resize_kernel<false>}) {
    CUDA_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  cudaSharedmemCarveoutMaxShared));
    CUDA_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  }
  g_optin.emplace(device, bytes);
  *optin = bytes;
  return kOk;
}

// The weights and the plan of in_h x in_w -> out_h x out_w on `device`
// (weights uploaded on `stream` the first time).
int plan_resize(int device, int in_h, int in_w, int out_h, int out_w, cudaStream_t stream,
                DevContribs* cy, DevContribs* cx, Plan* p) {
  STATUS_TRY(get_contribs(device, in_h, out_h, stream, cy));
  STATUS_TRY(get_contribs(device, in_w, out_w, stream, cx));
  int optin = 0;
  STATUS_TRY(kernel_setup(device, &optin));
  return make_plan(*cy, *cx, out_h, out_w, optin, p);
}

// The kernel on `stream`: src uint8 [n, in_h, in_w, 3], out [n, out_h,
// out_w, 3] uint8 (mode 0) or float.
int launch_resize(int device, const uint8_t* src, int n, int in_h, int in_w, void* out, int out_h,
                  int out_w, int mode, const float* mean, const float* stdv, cudaStream_t stream) {
  if (!resize_args_ok(n, in_h, in_w, out_h, out_w, mode, mean, stdv))
    return fail(kBadArgs, "resize: bad sizes or mode");
  DevContribs cy, cx;
  Plan p;
  STATUS_TRY(plan_resize(device, in_h, in_w, out_h, out_w, stream, &cy, &cx, &p));
  float3 bias = make_float3(0.f, 0.f, 0.f), inv = make_float3(0.f, 0.f, 0.f);
  if (mode == 1) {
    const float s = 1.0f / 255.0f;   // io.cc::resize_normalize's constants
    bias = make_float3(mean[0] * 255.0f, mean[1] * 255.0f, mean[2] * 255.0f);
    inv = make_float3(s / stdv[0], s / stdv[1], s / stdv[2]);
  }
  const auto kernel = mode == 0 ? &resize_kernel<true> : &resize_kernel<false>;
  const dim3 grid((out_w + p.tc - 1) / p.tc, (out_h + p.tr - 1) / p.tr, n);
  kernel<<<grid, kThreads, p.smem, stream>>>(src, out, cy, cx, in_h, in_w, out_h, out_w, p, bias,
                                             inv);
  CUDA_TRY(cudaGetLastError());
  return kOk;
}

// ---------------- nvJPEG handles and the pool of decoder states ----------------

struct Buffer {
  void* p = nullptr;
  size_t cap = 0;
};

// Grow a device (or pinned host) buffer to `bytes`; the old one is freed
// once `stream`'s work on it is done.
int grow(Buffer& b, size_t bytes, cudaStream_t stream, bool pinned) {
  if (b.cap >= bytes) return kOk;
  if (b.p) {
    CUDA_TRY(cudaStreamSynchronize(stream));
    CUDA_TRY(pinned ? cudaFreeHost(b.p) : cudaFree(b.p));
    b.p = nullptr;
    b.cap = 0;
  }
  const size_t cap = (bytes + (1u << 20) - 1) & ~size_t((1u << 20) - 1);
  CUDA_TRY(pinned ? cudaMallocHost(&b.p, cap) : cudaMalloc(&b.p, cap));
  b.cap = cap;
  return kOk;
}

constexpr int kDecoders = 2;   // GPU hybrid, hybrid
const nvjpegBackend_t kDecoderBackends[kDecoders] = {NVJPEG_BACKEND_GPU_HYBRID, NVJPEG_BACKEND_HYBRID};

struct Lease {
  cudaStream_t stream = nullptr;
  nvjpegJpegState_t hw_state = nullptr;      // the hardware backend's batched state (batch 1)
  nvjpegJpegStream_t hw_parsed = nullptr;
  nvjpegJpegDecoder_t dec[kDecoders] = {};
  nvjpegJpegState_t dec_state[kDecoders] = {};
  nvjpegBufferPinned_t pinned[kDecoders] = {};
  nvjpegBufferDevice_t devbuf[kDecoders] = {};
  nvjpegJpegStream_t parsed = nullptr;
  nvjpegDecodeParams_t params = nullptr;
  Buffer rgb, out, host;                     // decoded, resized; pinned copy
};

struct Codec {
  int device = 0;
  nvjpegHandle_t sw = nullptr;   // default backend: the hybrid decoders
  nvjpegHandle_t hw = nullptr;   // hardware backend, null where it was not created
  int backends = 0;              // bit b: backend b of enum Backend created
  std::mutex mu;
  std::vector<Lease*> idle;
};

std::mutex g_codecs_mu;
std::map<int, Codec*> g_codecs;

int codec_for(int device, Codec** out) {
  std::lock_guard<std::mutex> lock(g_codecs_mu);
  const auto it = g_codecs.find(device);
  if (it != g_codecs.end()) {
    *out = it->second;
    return kOk;
  }
  auto* c = new Codec;
  c->device = device;
  NVJPEG_TRY(nvjpegCreateEx(NVJPEG_BACKEND_DEFAULT, nullptr, nullptr, kHandleFlags, &c->sw));
  // the JPEG engines where the card and driver offer them; the hybrid
  // decoders take every file otherwise
  if (nvjpegCreateEx(NVJPEG_BACKEND_HARDWARE, nullptr, nullptr, kHandleFlags, &c->hw) !=
      NVJPEG_STATUS_SUCCESS)
    c->hw = nullptr;
  c->backends = c->hw ? 1 << kHardware : 0;
  for (int b = 0; b < kDecoders; ++b) {
    nvjpegJpegDecoder_t d = nullptr;
    if (nvjpegDecoderCreate(c->sw, kDecoderBackends[b], &d) == NVJPEG_STATUS_SUCCESS) {
      c->backends |= 1 << (kGpuHybrid + b);
      nvjpegDecoderDestroy(d);
    }
  }
  if (!(c->backends & (1 << kGpuHybrid | 1 << kHybrid)))
    return fail(kFault, "nvjpegDecoderCreate: neither hybrid decoder was created");
  g_codecs.emplace(device, c);
  *out = c;
  return kOk;
}

int new_lease(Codec* c, Lease** out) {
  auto* L = new Lease;
  CUDA_TRY(cudaStreamCreateWithFlags(&L->stream, cudaStreamNonBlocking));
  if (c->hw) {
    NVJPEG_TRY(nvjpegJpegStateCreate(c->hw, &L->hw_state));
    NVJPEG_TRY(nvjpegDecodeBatchedInitialize(c->hw, L->hw_state, 1, 1, NVJPEG_OUTPUT_RGBI));
    NVJPEG_TRY(nvjpegJpegStreamCreate(c->hw, &L->hw_parsed));
  }
  for (int b = 0; b < kDecoders; ++b) {
    if (!(c->backends & (1 << (kGpuHybrid + b)))) continue;
    NVJPEG_TRY(nvjpegDecoderCreate(c->sw, kDecoderBackends[b], &L->dec[b]));
    NVJPEG_TRY(nvjpegDecoderStateCreate(c->sw, L->dec[b], &L->dec_state[b]));
    NVJPEG_TRY(nvjpegBufferPinnedCreate(c->sw, nullptr, &L->pinned[b]));
    NVJPEG_TRY(nvjpegBufferDeviceCreate(c->sw, nullptr, &L->devbuf[b]));
    NVJPEG_TRY(nvjpegStateAttachPinnedBuffer(L->dec_state[b], L->pinned[b]));
    NVJPEG_TRY(nvjpegStateAttachDeviceBuffer(L->dec_state[b], L->devbuf[b]));
  }
  NVJPEG_TRY(nvjpegJpegStreamCreate(c->sw, &L->parsed));
  NVJPEG_TRY(nvjpegDecodeParamsCreate(c->sw, &L->params));
  NVJPEG_TRY(nvjpegDecodeParamsSetOutputFormat(L->params, NVJPEG_OUTPUT_RGBI));
  *out = L;
  return kOk;
}

// A decoder state of the pool for the scope, given back after.
struct LeaseScope {
  Codec* c;
  Lease* L = nullptr;
  explicit LeaseScope(Codec* codec) : c(codec) {}
  int acquire() {
    {
      std::lock_guard<std::mutex> lock(c->mu);
      if (!c->idle.empty()) {
        L = c->idle.back();
        c->idle.pop_back();
        return kOk;
      }
    }
    return new_lease(c, &L);
  }
  ~LeaseScope() {
    if (!L) return;
    std::lock_guard<std::mutex> lock(c->mu);
    c->idle.push_back(L);
  }
};

int image_info(Codec* c, const unsigned char* data, size_t len, int* h, int* w) {
  if (data == nullptr || len < 2 || data[0] != 0xFF || data[1] != 0xD8)
    return fail(kUndecodable, "not a JPEG");
  int comps = 0;
  nvjpegChromaSubsampling_t sub;
  int ws[NVJPEG_MAX_COMPONENT] = {}, hs[NVJPEG_MAX_COMPONENT] = {};
  const nvjpegStatus_t s = nvjpegGetImageInfo(c->sw, data, len, &comps, &sub, ws, hs);
  if (s != NVJPEG_STATUS_SUCCESS) return bitstream_fail("nvjpegGetImageInfo", s);
  if (ws[0] < 1 || hs[0] < 1) return fail(kUndecodable, "an empty JPEG");
  *h = hs[0];
  *w = ws[0];
  return kOk;
}

// Decode one JPEG of h x w into dst (interleaved RGB, pitch w * 3, device
// memory) on the lease's stream, by the first backend that takes it; 4
// where none does.
int decode_jpeg(Codec* c, Lease* L, const unsigned char* data, size_t len, int w, uint8_t* dst,
                int* backend) {
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof img);
  img.channel[0] = dst;
  img.pitch[0] = size_t(w) * 3;
  if (c->hw) {
    int unsupported = 1;
    if (nvjpegJpegStreamParse(c->hw, data, len, 0, 0, L->hw_parsed) == NVJPEG_STATUS_SUCCESS &&
        nvjpegDecodeBatchedSupported(c->hw, L->hw_parsed, &unsupported) == NVJPEG_STATUS_SUCCESS &&
        unsupported == 0) {
      const nvjpegStatus_t s = nvjpegDecodeBatched(c->hw, L->hw_state, &data, &len, &img, L->stream);
      if (s == NVJPEG_STATUS_SUCCESS) {
        *backend = kHardware;
        return kOk;
      }
      // a JPEG the engines do not take after all goes on to the hybrid decoders
      if (s != NVJPEG_STATUS_JPEG_NOT_SUPPORTED) return bitstream_fail("nvjpegDecodeBatched", s);
    }
  }
  nvjpegStatus_t s = nvjpegJpegStreamParse(c->sw, data, len, 0, 0, L->parsed);
  if (s != NVJPEG_STATUS_SUCCESS) return bitstream_fail("nvjpegJpegStreamParse", s);
  for (int b = 0; b < kDecoders; ++b) {
    if (!L->dec[b]) continue;
    int unsupported = 1;
    NVJPEG_TRY(nvjpegDecoderJpegSupported(L->dec[b], L->parsed, L->params, &unsupported));
    if (unsupported) continue;
    s = nvjpegDecodeJpegHost(c->sw, L->dec[b], L->dec_state[b], L->params, L->parsed);
    if (s != NVJPEG_STATUS_SUCCESS) return bitstream_fail("nvjpegDecodeJpegHost", s);
    NVJPEG_TRY(nvjpegDecodeJpegTransferToDevice(c->sw, L->dec[b], L->dec_state[b], L->parsed,
                                                L->stream));
    NVJPEG_TRY(nvjpegDecodeJpegDevice(c->sw, L->dec[b], L->dec_state[b], &img, L->stream));
    *backend = kGpuHybrid + b;
    return kOk;
  }
  return fail(kUnsupported, "no nvJPEG backend takes this JPEG");
}

size_t out_bytes(int n, int out_h, int out_w, int mode) {
  return size_t(n) * out_h * out_w * 3 * (mode == 0 ? 1 : sizeof(float));
}

// Resize n images of the lease's (or another) device buffer src into the
// lease's pinned buffer, waited for.
int resize_to_pinned(Codec* c, Lease* L, const uint8_t* src, int n, int in_h, int in_w, int out_h,
                     int out_w, int mode, const float* mean, const float* stdv) {
  if (!resize_args_ok(n, in_h, in_w, out_h, out_w, mode, mean, stdv))
    return fail(kBadArgs, "resize: bad sizes or mode");
  const size_t bytes = out_bytes(n, out_h, out_w, mode);
  STATUS_TRY(grow(L->out, bytes, L->stream, false));
  STATUS_TRY(grow(L->host, bytes, L->stream, true));
  STATUS_TRY(launch_resize(c->device, src, n, in_h, in_w, L->out.p, out_h, out_w, mode, mean,
                           stdv, L->stream));
  CUDA_TRY(cudaMemcpyAsync(L->host.p, L->out.p, bytes, cudaMemcpyDeviceToHost, L->stream));
  CUDA_TRY(cudaStreamSynchronize(L->stream));
  return kOk;
}

// The ingest entries' common start: relaxed capture mode, the device, its codec.
struct Entry {
  RelaxedCapture relaxed;
  DeviceScope scope;
  Codec* codec = nullptr;
  int start(int device) {
    g_error.clear();
    CUDA_TRY(scope.set(device));
    return codec_for(device, &codec);
  }
};

}  // namespace

extern "C" {

int ccvpe_io_init(int device, int* backends) {
  Entry e;
  STATUS_TRY(e.start(device));
  *backends = e.codec->backends;
  return kOk;
}

int ccvpe_io_last_error(char* buf, int size) {
  if (size < 1) return kBadArgs;
  std::strncpy(buf, g_error.c_str(), size_t(size) - 1);
  buf[size - 1] = '\0';
  return kOk;
}

void ccvpe_io_backend_counts(long long* counts) {
  for (int b = 0; b < kBackends; ++b) counts[b] = g_counts[b].load();
}

int ccvpe_io_image_info(const unsigned char* data, size_t len, int device, int* h, int* w) {
  Entry e;
  STATUS_TRY(e.start(device));
  return image_info(e.codec, data, len, h, w);
}

// Decode only, to uint8 RGB [h, w, 3] on the host (out holds `capacity` bytes).
int ccvpe_io_decode(const unsigned char* data, size_t len, unsigned char* out, size_t capacity,
                    int device, int* backend) {
  Entry e;
  STATUS_TRY(e.start(device));
  int h = 0, w = 0;
  STATUS_TRY(image_info(e.codec, data, len, &h, &w));
  const size_t bytes = size_t(h) * w * 3;
  if (capacity < bytes) return fail(kBadArgs, "decode: the output is too small");
  LeaseScope lease(e.codec);
  STATUS_TRY(lease.acquire());
  Lease* L = lease.L;
  STATUS_TRY(grow(L->rgb, bytes, L->stream, false));
  STATUS_TRY(grow(L->host, bytes, L->stream, true));
  STATUS_TRY(decode_jpeg(e.codec, L, data, len, w, static_cast<uint8_t*>(L->rgb.p), backend));
  CUDA_TRY(cudaMemcpyAsync(L->host.p, L->rgb.p, bytes, cudaMemcpyDeviceToHost, L->stream));
  CUDA_TRY(cudaStreamSynchronize(L->stream));
  std::memcpy(out, L->host.p, bytes);
  g_counts[*backend]++;
  return kOk;
}

int ccvpe_io_decode_resize(const unsigned char* data, size_t len, void* out, int out_h, int out_w,
                           int mode, const float* mean, const float* stdv, int device,
                           int* backend) {
  Entry e;
  STATUS_TRY(e.start(device));
  int h = 0, w = 0;
  STATUS_TRY(image_info(e.codec, data, len, &h, &w));
  if (!resize_args_ok(1, h, w, out_h, out_w, mode, mean, stdv))
    return fail(kBadArgs, "decode_resize: bad sizes or mode");
  LeaseScope lease(e.codec);
  STATUS_TRY(lease.acquire());
  Lease* L = lease.L;
  STATUS_TRY(grow(L->rgb, size_t(h) * w * 3, L->stream, false));
  STATUS_TRY(decode_jpeg(e.codec, L, data, len, w, static_cast<uint8_t*>(L->rgb.p), backend));
  STATUS_TRY(resize_to_pinned(e.codec, L, static_cast<uint8_t*>(L->rgb.p), 1, h, w, out_h, out_w,
                              mode, mean, stdv));
  std::memcpy(out, L->host.p, out_bytes(1, out_h, out_w, mode));
  g_counts[*backend]++;
  return kOk;
}

// Host uint8 RGB [in_h, in_w, 3] through the same kernel, counted under
// `backend`: kHost for a PNG that PIL decoded, kRefused for a JPEG that
// nvJPEG does not decode and PIL did.
int ccvpe_io_rgb_resize(const unsigned char* rgb, int in_h, int in_w, void* out, int out_h,
                        int out_w, int mode, const float* mean, const float* stdv, int device,
                        int backend) {
  Entry e;
  STATUS_TRY(e.start(device));
  if (backend != kHost && backend != kRefused) return fail(kBadArgs, "rgb_resize: bad backend");
  if (!resize_args_ok(1, in_h, in_w, out_h, out_w, mode, mean, stdv))
    return fail(kBadArgs, "rgb_resize: bad sizes or mode");
  LeaseScope lease(e.codec);
  STATUS_TRY(lease.acquire());
  Lease* L = lease.L;
  const size_t bytes = size_t(in_h) * in_w * 3;
  STATUS_TRY(grow(L->rgb, bytes, L->stream, false));
  CUDA_TRY(cudaMemcpyAsync(L->rgb.p, rgb, bytes, cudaMemcpyHostToDevice, L->stream));
  STATUS_TRY(resize_to_pinned(e.codec, L, static_cast<uint8_t*>(L->rgb.p), 1, in_h, in_w, out_h,
                              out_w, mode, mean, stdv));
  std::memcpy(out, L->host.p, out_bytes(1, out_h, out_w, mode));
  g_counts[backend]++;
  return kOk;
}

// n JPEGs decoded by up to `threads` threads, each on a lease of its own,
// into one device batch per size group; each group resized in one launch.
// status[i]: 0 decoded, 1 a broken JPEG, 4 one nvJPEG does not
// decode; backend[i] its backend; *groups the groups resized. Returns 0, or
// a fault (2) or bad arguments (3).
int ccvpe_io_load_batch(const unsigned char* const* datas, const size_t* lens, int n, void* out,
                        int out_h, int out_w, int mode, const float* mean, const float* stdv,
                        int threads, int device, int* status, int* backend, int* groups) {
  Entry e;
  STATUS_TRY(e.start(device));
  *groups = 0;
  if (n < 0 || threads < 1) return fail(kBadArgs, "load_batch: bad count");
  std::vector<int> hs(n), ws(n);
  std::vector<std::pair<int, int>> sizes;
  std::vector<std::vector<int>> members;
  for (int i = 0; i < n; ++i) {
    backend[i] = -1;
    status[i] = image_info(e.codec, datas[i], lens[i], &hs[i], &ws[i]);
    if (status[i] == kFault || status[i] == kBadArgs) return status[i];
    if (status[i] != kOk) continue;
    const auto key = std::make_pair(hs[i], ws[i]);
    const auto it = std::find(sizes.begin(), sizes.end(), key);
    if (it == sizes.end()) {
      sizes.push_back(key);
      members.emplace_back(1, i);
    } else {
      members[it - sizes.begin()].push_back(i);
    }
  }
  LeaseScope batch(e.codec);
  STATUS_TRY(batch.acquire());
  Lease* B = batch.L;
  const size_t per = out_bytes(1, out_h, out_w, mode);
  for (size_t g = 0; g < sizes.size(); ++g) {
    const int h = sizes[g].first, w = sizes[g].second;
    const std::vector<int>& m = members[g];
    const int count = int(m.size());
    if (!resize_args_ok(count, h, w, out_h, out_w, mode, mean, stdv))
      return fail(kBadArgs, "load_batch: bad sizes or mode");
    const size_t image = size_t(h) * w * 3;
    STATUS_TRY(grow(B->rgb, image * count, B->stream, false));
    uint8_t* rgb = static_cast<uint8_t*>(B->rgb.p);
    std::atomic<int> next(0);
    std::mutex err_mu;
    std::string err;
    auto work = [&]() {
      RelaxedCapture relaxed;
      DeviceScope scope;
      LeaseScope lease(e.codec);
      int st = scope.set(device) == cudaSuccess ? lease.acquire() : cuda_fail("cudaSetDevice", cudaErrorInvalidDevice);
      for (int j = next++; st == kOk && j < count; j = next++) {
        const int i = m[j];
        int s = decode_jpeg(e.codec, lease.L, datas[i], lens[i], w, rgb + image * j, &backend[i]);
        if (s == kOk) {
          const cudaError_t ce = cudaStreamSynchronize(lease.L->stream);
          if (ce != cudaSuccess) s = cuda_fail("cudaStreamSynchronize", ce);
        }
        status[i] = s;
        if (s == kFault || s == kBadArgs) st = s;
      }
      if (st != kOk) {
        std::lock_guard<std::mutex> lock(err_mu);
        if (err.empty()) err = g_error.empty() ? "load_batch: a decode thread failed" : g_error;
      }
    };
    std::vector<std::thread> pool;
    const int nt = std::min(threads, count);
    for (int t = 0; t < nt; ++t) pool.emplace_back(work);
    for (auto& t : pool) t.join();
    if (!err.empty()) return fail(kFault, err);
    STATUS_TRY(resize_to_pinned(e.codec, B, rgb, count, h, w, out_h, out_w, mode, mean, stdv));
    ++*groups;
    for (int j = 0; j < count; ++j) {
      const int i = m[j];
      if (status[i] != kOk) continue;
      std::memcpy(static_cast<char*>(out) + per * i, static_cast<char*>(B->host.p) + per * j, per);
      g_counts[backend[i]]++;
    }
  }
  return kOk;
}

// The kernel on device buffers, on `stream` (a cudaStream_t as a pointer):
// src uint8 [n, in_h, in_w, 3], out [n, out_h, out_w, 3] uint8 (mode 0) or
// float32 (mode 1). Allocates nothing but the weights of a size pair it
// has not seen.
int ccvpe_io_resize(const void* src, int n, int in_h, int in_w, void* out, int out_h, int out_w,
                    int mode, const float* mean, const float* stdv, int device, void* stream) {
  g_error.clear();
  DeviceScope scope;
  CUDA_TRY(scope.set(device));
  return launch_resize(device, static_cast<const uint8_t*>(src), n, in_h, in_w, out, out_h, out_w,
                       mode, mean, stdv, static_cast<cudaStream_t>(stream));
}

// The plan resize_kernel takes for in_h x in_w -> out_h x out_w on
// `device`: plan[0..4] = the tile's output rows and columns, band rows a
// chunk, a staged row's bytes, the block's dynamic shared memory in bytes.
// 3 where one output's band does not fit in shared memory.
int ccvpe_io_resize_plan(int in_h, int in_w, int out_h, int out_w, int device, int* plan) {
  g_error.clear();
  if (!resize_args_ok(1, in_h, in_w, out_h, out_w, 0, nullptr, nullptr))
    return fail(kBadArgs, "resize_plan: bad sizes");
  RelaxedCapture relaxed;
  DeviceScope scope;
  CUDA_TRY(scope.set(device));
  cudaStream_t stream = nullptr;
  CUDA_TRY(cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking));
  DevContribs cy, cx;
  Plan p;
  const int st = plan_resize(device, in_h, in_w, out_h, out_w, stream, &cy, &cx, &p);
  cudaStreamDestroy(stream);
  if (st != kOk) return st;
  const int values[5] = {p.tr, p.tc, p.chunk, p.pitch, int(p.smem)};
  std::copy(values, values + 5, plan);
  return kOk;
}

}  // extern "C"
