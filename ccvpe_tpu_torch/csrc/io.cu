// Image ingest on Hopper (sm_90a): JPEG decode by nvJPEG, then Pillow's
// triangle resize and the ImageNet normalize (or the uint8 round) in two
// hand-written kernels.
//
// The port of native/io.cc (the JAX package's host library: libjpeg and
// libpng decode, build_contribs :147, resize_normalize :179, resize_u8 :231,
// the C API :278-335). It replaces no TPU kernel: the JAX package decodes
// and resizes on the host. On the card the JPEG decode is nvJPEG's (the
// toolkit's decoder, not a kernel of this repository) and the resize is
// these kernels; a PNG is decoded by PIL on the host and uploaded, since the
// card's machine has no libpng (ops/resize_cuda.py::rgb_resize).
//
// The resize computes what io.cc computes: contributions from
// build_contribs in float64, cast to float; a vertical pass from uint8 rows
// into float rows [out_h, in_w * 3], then a horizontal gather into
// (v - 255 mean) * ((1/255) / std) or int(v + 0.5) clipped to uint8. Each
// sum runs tap by tap from the first in float, one rounded product and one
// rounded add a tap (__fmul_rn, __fadd_rn: no contraction into an FMA), so
// the plain version (ops/resize_cuda.py::resize_plain) gives the same bits
// on the same decoded pixels.
//
// What bounds it on an H100: bytes. A 2048 x 1024 panorama resized to
// 640 x 320 reads 6.3 MB of pixels and writes 7.9 MB of float rows in the
// vertical pass, then reads those rows and writes 0.6 MB (uint8) or 2.5 MB
// (float32): about 22 MB, 7 us at 3.35 TB/s. What the design does about it:
// - The vertical pass reads each input row as 4-byte vectors and writes
//   16-byte float vectors, one thread a 4-byte column of one output row,
//   neighbouring threads on neighbouring bytes; the input rows an output
//   row shares with the next stay in L2.
// - The horizontal pass stages one float row in shared memory with
//   coalesced loads (24 KB at 2048 columns; rows wider than the card's
//   shared memory read device memory), then one thread an output pixel
//   gathers its taps from there.
// - One launch a pass takes a batch of images of one size (grid z or y).
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
// buffers, and the lease's device and pinned buffers for the decoded,
// intermediate and resized images, grown to the largest image seen and
// never shrunk. So concurrent callers decode at once, and a loader's
// threads that come and go allocate nothing once the pool is warm. Each
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
//   ccvpe_io_resize(src, n, in_h, in_w, tmp, out, out_h, out_w, mode, mean, std, device, stream)
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
constexpr size_t kDefaultSmem = 48 * 1024;

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

// One axis's weights on the card: [first (out ints)][taps (out ints)][w (out * ksize floats)].
struct DevContribs {
  const int* first = nullptr;
  const int* taps = nullptr;
  const float* w = nullptr;
  int ksize = 0;
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
  g_contribs.emplace(key, d);
  *out = d;
  return kOk;
}

// ---------------- the two resize kernels ----------------

// Vertical pass: tmp[img, y, i] = sum_k w[y, k] * src[img, first[y] + k, i]
// over a row of `row` = in_w * 3 bytes; VEC bytes a thread (4: uchar4 in,
// float4 out). grid (columns / VEC / kThreads, out_h, n).
template <int VEC>
__global__ void __launch_bounds__(kThreads)
resize_v_kernel(const uint8_t* __restrict__ src, float* __restrict__ tmp,
                const int* __restrict__ first, const int* __restrict__ taps,
                const float* __restrict__ w, int ksize, int in_h, int row, int out_h) {
  const int y = blockIdx.y;
  const int img = blockIdx.z;
  const int i = (blockIdx.x * kThreads + threadIdx.x) * VEC;
  if (i >= row) return;
  const int n = taps[y];
  const float* wy = w + size_t(y) * ksize;
  const uint8_t* s = src + (size_t(img) * in_h + first[y]) * row + i;
  float* t = tmp + (size_t(img) * out_h + y) * row + i;
  if constexpr (VEC == 4) {
    uchar4 v = *reinterpret_cast<const uchar4*>(s);
    const float w0 = wy[0];
    float4 a = make_float4(__fmul_rn(w0, float(v.x)), __fmul_rn(w0, float(v.y)),
                           __fmul_rn(w0, float(v.z)), __fmul_rn(w0, float(v.w)));
    for (int k = 1; k < n; ++k) {
      v = *reinterpret_cast<const uchar4*>(s + size_t(k) * row);
      const float wk = wy[k];
      a.x = __fadd_rn(a.x, __fmul_rn(wk, float(v.x)));
      a.y = __fadd_rn(a.y, __fmul_rn(wk, float(v.y)));
      a.z = __fadd_rn(a.z, __fmul_rn(wk, float(v.z)));
      a.w = __fadd_rn(a.w, __fmul_rn(wk, float(v.w)));
    }
    *reinterpret_cast<float4*>(t) = a;
  } else {
    float a = __fmul_rn(wy[0], float(s[0]));
    for (int k = 1; k < n; ++k) a = __fadd_rn(a, __fmul_rn(wy[k], float(s[size_t(k) * row])));
    *t = a;
  }
}

__device__ __forceinline__ uint8_t clip8(float v) {
  const int i = __float2int_rz(__fadd_rn(v, 0.5f));   // io.cc: int(v + 0.5f)
  return uint8_t(i < 0 ? 0 : (i > 255 ? 255 : i));
}

// Horizontal pass: out[img, y, x, c] from tmp's row (img, y): the taps of
// column x summed from 0, then the round (U8) or the normalize. SMEM: the
// row staged in shared memory first. grid (out_h, n).
template <bool U8, bool SMEM>
__global__ void __launch_bounds__(kThreads)
resize_h_kernel(const float* __restrict__ tmp, void* __restrict__ out,
                const int* __restrict__ first, const int* __restrict__ taps,
                const float* __restrict__ w, int ksize, int in_w, int out_w, int out_h,
                float3 bias, float3 inv) {
  extern __shared__ float srow[];
  const size_t r = size_t(blockIdx.y) * out_h + blockIdx.x;
  const float* row = tmp + r * in_w * 3;
  if constexpr (SMEM) {
    for (int i = threadIdx.x; i < in_w * 3; i += kThreads) srow[i] = row[i];
    __syncthreads();
    row = srow;
  }
  for (int x = threadIdx.x; x < out_w; x += kThreads) {
    const int n = taps[x];
    const float* wx = w + size_t(x) * ksize;
    const float* p = row + first[x] * 3;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    for (int k = 0; k < n; ++k, p += 3) {
      const float wk = wx[k];
      a0 = __fadd_rn(a0, __fmul_rn(wk, p[0]));
      a1 = __fadd_rn(a1, __fmul_rn(wk, p[1]));
      a2 = __fadd_rn(a2, __fmul_rn(wk, p[2]));
    }
    const size_t o = (r * out_w + x) * 3;
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

template <bool U8>
cudaError_t launch_h(const float* tmp, void* out, const DevContribs& cx, int n, int in_w,
                     int out_w, int out_h, float3 bias, float3 inv, cudaStream_t stream) {
  const size_t smem = size_t(in_w) * 3 * sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const dim3 grid(out_h, n);
  if (smem <= size_t(optin)) {
    const auto kernel = resize_h_kernel<U8, true>;
    if (smem > kDefaultSmem) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
      if (e != cudaSuccess) return e;
    }
    kernel<<<grid, kThreads, smem, stream>>>(tmp, out, cx.first, cx.taps, cx.w, cx.ksize, in_w,
                                             out_w, out_h, bias, inv);
  } else {
    resize_h_kernel<U8, false><<<grid, kThreads, 0, stream>>>(
        tmp, out, cx.first, cx.taps, cx.w, cx.ksize, in_w, out_w, out_h, bias, inv);
  }
  return cudaGetLastError();
}

bool resize_args_ok(int n, int in_h, int in_w, int out_h, int out_w, int mode, const float* mean,
                    const float* stdv) {
  return n >= 1 && n <= 65535 && in_h >= 1 && in_w >= 1 && out_h >= 1 && out_h <= 65535 &&
         out_w >= 1 && (mode == 0 || (mode == 1 && mean != nullptr && stdv != nullptr)) &&
         size_t(in_w) * 3 <= size_t(INT32_MAX);
}

// Both passes on `stream`: src uint8 [n, in_h, in_w, 3], tmp float
// [n, out_h, in_w * 3], out [n, out_h, out_w, 3] uint8 (mode 0) or float.
int launch_resize(int device, const uint8_t* src, int n, int in_h, int in_w, float* tmp, void* out,
                  int out_h, int out_w, int mode, const float* mean, const float* stdv,
                  cudaStream_t stream) {
  if (!resize_args_ok(n, in_h, in_w, out_h, out_w, mode, mean, stdv))
    return fail(kBadArgs, "resize: bad sizes or mode");
  DevContribs cy, cx;
  STATUS_TRY(get_contribs(device, in_h, out_h, stream, &cy));
  STATUS_TRY(get_contribs(device, in_w, out_w, stream, &cx));
  const int row = in_w * 3;
  const bool vec = row % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(tmp) & 15) == 0;
  const int per = vec ? 4 : 1;
  const dim3 gv((row / per + kThreads - 1) / kThreads, out_h, n);
  if (vec)
    resize_v_kernel<4><<<gv, kThreads, 0, stream>>>(src, tmp, cy.first, cy.taps, cy.w, cy.ksize,
                                                    in_h, row, out_h);
  else
    resize_v_kernel<1><<<gv, kThreads, 0, stream>>>(src, tmp, cy.first, cy.taps, cy.w, cy.ksize,
                                                    in_h, row, out_h);
  CUDA_TRY(cudaGetLastError());
  float3 bias = make_float3(0.f, 0.f, 0.f), inv = make_float3(0.f, 0.f, 0.f);
  if (mode == 1) {
    const float s = 1.0f / 255.0f;   // io.cc::resize_normalize's constants
    bias = make_float3(mean[0] * 255.0f, mean[1] * 255.0f, mean[2] * 255.0f);
    inv = make_float3(s / stdv[0], s / stdv[1], s / stdv[2]);
  }
  CUDA_TRY(mode == 0 ? launch_h<true>(tmp, out, cx, n, in_w, out_w, out_h, bias, inv, stream)
                     : launch_h<false>(tmp, out, cx, n, in_w, out_w, out_h, bias, inv, stream));
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
  Buffer rgb, tmp, out, host;                // decoded, vertical pass, resized; pinned copy
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
  STATUS_TRY(grow(L->tmp, size_t(n) * out_h * in_w * 3 * sizeof(float), L->stream, false));
  STATUS_TRY(grow(L->out, bytes, L->stream, false));
  STATUS_TRY(grow(L->host, bytes, L->stream, true));
  STATUS_TRY(launch_resize(c->device, src, n, in_h, in_w, static_cast<float*>(L->tmp.p), L->out.p,
                           out_h, out_w, mode, mean, stdv, L->stream));
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

// Host uint8 RGB [in_h, in_w, 3] through the same kernels, counted under
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
// into one device batch per size group; each group resized in one launch a
// pass. status[i]: 0 decoded, 1 a broken JPEG, 4 one nvJPEG does not
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

// The two kernels on device buffers, on `stream` (a cudaStream_t as a
// pointer): src uint8 [n, in_h, in_w, 3], tmp float [n, out_h, in_w * 3],
// out [n, out_h, out_w, 3] uint8 (mode 0) or float32 (mode 1). Allocates
// nothing but the weights of a size pair it has not seen.
int ccvpe_io_resize(const void* src, int n, int in_h, int in_w, void* tmp, void* out, int out_h,
                    int out_w, int mode, const float* mean, const float* stdv, int device,
                    void* stream) {
  g_error.clear();
  DeviceScope scope;
  CUDA_TRY(scope.set(device));
  return launch_resize(device, static_cast<const uint8_t*>(src), n, in_h, in_w,
                       static_cast<float*>(tmp), out, out_h, out_w, mode, mean, stdv,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
