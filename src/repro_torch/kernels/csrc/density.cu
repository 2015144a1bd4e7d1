// Species histogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/density.py:
//   K4 density_kernel  <- density_counts (_kernel)
//
// What it computes. counts[v] = the number of cells of the (H, W) lattice
// whose label is v, for v in 0..S; labels outside 0..S are not counted, as
// the reference's one-hot over 0..S does not count them.
//
// What bounds it on this card. The lattice is read once (40.96 MB at
// 3200 x 3200 int32) and S + 1 words are written: it is bound by bytes.
// On a TPU the grid runs in order and one output block accumulates; here the
// blocks run in parallel, so the sum across blocks needs atomics.
//
// What the design does about it. Each block strides over the lattice and
// counts into S + 1 bins in shared memory; within a warp the lanes that hold
// the same label are grouped with __match_any_sync, so each group adds its
// size with one shared-memory atomic rather than one per lane. At the end
// each block adds its bins to the output with one global atomic per bin.
// Integer addition does not depend on order, so the result is exact. The
// output is zeroed on the stream before the launch. Wider loads (16 bytes a
// thread) are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace escg4 {

template <typename T>
__global__ void density_kernel(const T* __restrict__ g, int64_t n,
                               int n_labels, int* counts) {
  extern __shared__ int bins[];
  for (int b = threadIdx.x; b < n_labels; b += blockDim.x) bins[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // every lane of a warp runs the same number of iterations, so the full
  // mask is valid in __match_any_sync; past the end a lane holds label -1
  const int64_t warp0 =
      (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
  for (int64_t base = warp0; base < n; base += stride) {
    const int64_t i = base + lane;
    const int v = i < n ? (int)g[i] : -1;
    const unsigned same = __match_any_sync(0xffffffffu, v);
    if (v >= 0 && v < n_labels && lane == __ffs(same) - 1)
      atomicAdd(&bins[v], __popc(same));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_labels; b += blockDim.x)
    if (bins[b]) atomicAdd(&counts[b], bins[b]);
}

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

template <typename T>
int launch(const void* g, int64_t n, int n_labels, int* counts, int device,
           cudaStream_t stream) {
  cudaError_t err =
      cudaMemsetAsync(counts, 0, (size_t)n_labels * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t most = (int64_t)sms * kBlocksPerSm;
  const int blocks = (int)(want < most ? want : most);
  density_kernel<T><<<blocks, kThreads, (size_t)n_labels * sizeof(int),
                      stream>>>((const T*)g, n, n_labels, counts);
  return (int)cudaGetLastError();
}

}  // namespace escg4

extern "C" {

// cell_bytes selects the lattice type: 1 = int8, 2 = int16, 4 = int32.
// Returns a cudaError_t (0 = launched).
int density_counts(int cell_bytes, const void* grid, int64_t n, int n_labels,
                   int* counts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cell_bytes) {
    case 1:
      return escg4::launch<int8_t>(grid, n, n_labels, counts, device, s);
    case 2:
      return escg4::launch<int16_t>(grid, n, n_labels, counts, device, s);
    case 4:
      return escg4::launch<int32_t>(grid, n, n_labels, counts, device, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* escg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
