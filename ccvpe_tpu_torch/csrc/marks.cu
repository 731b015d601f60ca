// Device layer marks (core/profiling.py::mark), a library of their own so
// that marking a layer loads no kernel's library.
//
// One empty kernel a name, one block of one thread that touches no memory,
// launched on the caller's stream: a CUDA graph captures it with the step,
// every replay runs it, and the trace names the layer bound it marks.
// Names and ids are core/profiling.py's MARKS, in order (ccvpe_mark_name
// lets the loader check them); none holds the name of a kernel of the
// port.

#include <cuda_runtime.h>

#define CCVPE_MARKS(X)                                                         \
  X(0, encoders_begin) X(1, encoders_end) X(2, decode_begin) X(3, decode_end) \
  X(4, backward_begin) X(5, backward_end) X(6, optimizer_begin)               \
  X(7, optimizer_end)

#define CCVPE_MARK_KERNEL(i, name) extern "C" __global__ void ccvpe_mark_##name() {}
CCVPE_MARKS(CCVPE_MARK_KERNEL)

#define CCVPE_MARK_ONE(i, name) +1
extern "C" int ccvpe_mark_count() { return 0 CCVPE_MARKS(CCVPE_MARK_ONE); }

#define CCVPE_MARK_NAME(i, name) \
  case i:                        \
    return #name;
extern "C" const char* ccvpe_mark_name(int id) {
  switch (id) {
    CCVPE_MARKS(CCVPE_MARK_NAME)
    default:
      return "";
  }
}

// Launch mark `id` on `stream` (a cudaStream_t passed as a pointer); returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an id
// that names no mark.
#define CCVPE_MARK_LAUNCH(i, name)          \
  case i:                                   \
    ccvpe_mark_##name<<<1, 1, 0, cs>>>();   \
    break;
extern "C" int ccvpe_mark(int id, void* stream) {
  const auto cs = static_cast<cudaStream_t>(stream);
  switch (id) {
    CCVPE_MARKS(CCVPE_MARK_LAUNCH)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
