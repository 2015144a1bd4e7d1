// Where K4's time goes on the card, and the designs tried for it.
//
// Build and run from the repository root, on a machine with the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v \
//       -o src/repro_torch/kernels/_build/k4_probe \
//       src/repro_torch/kernels/probe/k4_probe.cu
//   src/repro_torch/kernels/_build/k4_probe
//
// On a 3200 x 3200 lattice of labels 0..3 (park3's species with 10 % empty
// cells) it times, by CUDA events over 100 back-to-back launches from C
// after a warm-up launch:
//
// * the previous K4 (scalar loads, labels grouped per warp with
//   __match_any_sync, shared-memory atomics, a zeroing cudaMemsetAsync
//   before every launch), on the int32 lattice;
// * the first version of the new design on the int32 lattice: the same
//   loads and register counts, but the rounds of loads past the last whole
//   round of kUnroll taken one load at a time, and each block's sums
//   written to a row of its own that the last block adds up (528 rows);
// * the kernel of csrc/density.cu on the int32, int16 and int8 lattice,
//   with S = 3 (4 bins in registers), S = 15 (16 bins) and S = 40 (shared
//   bins), and on a view of the int32 lattice that starts one cell in (not
//   16-byte aligned);
// * a coalesced read of the int32 lattice (16-byte loads, grid-stride),
//   the least a read of its 40.96 MB takes.
//
// Every count is held to a count on the host. The last line is the card's
// name and power limit.
#include "../csrc/density.cu"

#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>

namespace probe {

constexpr int64_t N = 3200LL * 3200;
constexpr int REPS = 100;

#define CHECK(x)                                                      \
  do {                                                                \
    cudaError_t e_ = (x);                                             \
    if (e_ != cudaSuccess) {                                          \
      std::fprintf(stderr, "%s:%d %s\n", __FILE__, __LINE__,          \
                   cudaGetErrorString(e_));                           \
      std::exit(1);                                                   \
    }                                                                 \
  } while (0)

// The previous K4.
__global__ void old_k4(const int32_t* g, int64_t n, int n_labels,
                       int* counts) {
  extern __shared__ int bins[];
  for (int b = threadIdx.x; b < n_labels; b += blockDim.x) bins[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
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

// The first version of the new design, int32 lattice, S < 4, 16-byte
// aligned: scratch[0] is the ticket, scratch[1 + 4 b ..] block b's sums.
__global__ void __launch_bounds__(escg::kThreads)
    rows_k4(const int32_t* g, int64_t n, int* counts, int* scratch) {
  __shared__ int sums[escg::kWarps * 4];
  __shared__ bool last;
  const int tid = threadIdx.x;
  escg::Counter<int32_t, 4> cnt(nullptr, 4);
  const int64_t n_vec = n / 4;
  const int64_t stride = (int64_t)gridDim.x * escg::kThreads;
  const uint4* v = reinterpret_cast<const uint4*>(g);
  int64_t i = (int64_t)blockIdx.x * escg::kThreads + tid;
  for (; i + (escg::kUnroll - 1) * stride < n_vec;
       i += escg::kUnroll * stride) {
    uint4 x[escg::kUnroll];
#pragma unroll
    for (int u = 0; u < escg::kUnroll; ++u) x[u] = __ldcs(v + i + u * stride);
#pragma unroll
    for (int u = 0; u < escg::kUnroll; ++u) cnt.vec(x[u]);
  }
  for (; i < n_vec; i += stride) cnt.vec(__ldcs(v + i));
  int* rows = scratch + 1;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const uint32_t s = __reduce_add_sync(escg::kFull, cnt.c[u]);
    if (tid % 32 == 0) sums[tid / 32 * 4 + u] = (int)s;
  }
  __syncthreads();
  if (tid < 4) {
    int s = 0;
    for (int w = 0; w < escg::kWarps; ++w) s += sums[w * 4 + tid];
    rows[blockIdx.x * 4 + tid] = s;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd((unsigned*)scratch, 1u) == gridDim.x - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  uint32_t c[4] = {0, 0, 0, 0};
  for (int b = tid; b < (int)gridDim.x; b += escg::kThreads)
    for (int u = 0; u < 4; ++u) c[u] += (uint32_t)__ldcg(&rows[b * 4 + u]);
  __syncthreads();
  for (int u = 0; u < 4; ++u) {
    const uint32_t s = __reduce_add_sync(escg::kFull, c[u]);
    if (tid % 32 == 0) sums[tid / 32 * 4 + u] = (int)s;
  }
  __syncthreads();
  if (tid < 4) {
    int s = 0;
    for (int w = 0; w < escg::kWarps; ++w) s += sums[w * 4 + tid];
    counts[tid] = s;
  }
  if (tid == 0) scratch[0] = 0;
}

__global__ void read_all(const uint4* p, size_t n, uint32_t* sink) {
  uint32_t acc = 0;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const uint4 x = __ldcs(p + i);
    acc ^= x.x ^ x.y ^ x.z ^ x.w;
  }
  if (acc == 0x9E3779B9u) sink[0] = acc;
}

struct Timer {
  cudaEvent_t a, b;
  Timer() {
    CHECK(cudaEventCreate(&a));
    CHECK(cudaEventCreate(&b));
  }
  template <typename F>
  float ms(F&& launch) {
    launch();
    CHECK(cudaGetLastError());
    CHECK(cudaDeviceSynchronize());
    CHECK(cudaEventRecord(a));
    for (int i = 0; i < REPS; ++i) launch();
    CHECK(cudaEventRecord(b));
    CHECK(cudaEventSynchronize(b));
    CHECK(cudaGetLastError());
    float t = 0.f;
    CHECK(cudaEventElapsedTime(&t, a, b));
    return t / REPS;
  }
};

int run() {
  std::mt19937 gen(0);
  std::vector<int32_t> g32(N);
  std::vector<int16_t> g16(N);
  std::vector<int8_t> g8(N);
  for (int64_t i = 0; i < N; ++i) {
    g32[i] = gen() % 10 == 0 ? 0 : 1 + (int)(gen() % 3);
    g16[i] = (int16_t)g32[i];
    g8[i] = (int8_t)g32[i];
  }
  int32_t* d32;
  int16_t* d16;
  int8_t* d8;
  int *counts, *scratch;
  uint32_t* sink;
  int sms = 0;
  CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0));
  const size_t scratch_words = 1 + (size_t)sms * escg::kBlocksPerSm * 4;
  CHECK(cudaMalloc(&d32, N * 4));
  CHECK(cudaMalloc(&d16, N * 2));
  CHECK(cudaMalloc(&d8, N));
  CHECK(cudaMalloc(&counts, 64 * sizeof(int)));
  CHECK(cudaMalloc(&scratch, scratch_words * sizeof(int)));
  CHECK(cudaMalloc(&sink, 4));
  CHECK(cudaMemset(scratch, 0, scratch_words * sizeof(int)));
  CHECK(cudaMemcpy(d32, g32.data(), N * 4, cudaMemcpyDefault));
  CHECK(cudaMemcpy(d16, g16.data(), N * 2, cudaMemcpyDefault));
  CHECK(cudaMemcpy(d8, g8.data(), N, cudaMemcpyDefault));

  auto bad = [&](int64_t from, int n_labels) {
    std::vector<int> want(n_labels, 0), got(n_labels);
    for (int64_t i = from; i < N; ++i)
      if (g32[i] < n_labels) ++want[g32[i]];
    CHECK(cudaMemcpy(got.data(), counts, n_labels * sizeof(int),
                     cudaMemcpyDefault));
    long b = 0;
    for (int v = 0; v < n_labels; ++v) b += got[v] != want[v];
    return b;
  };
  Timer timer;
  std::printf("[probe] K4 on %lld cells of labels 0..3\n", (long long)N);
  float t = timer.ms([&] {
    CHECK(cudaMemsetAsync(counts, 0, 4 * sizeof(int)));
    old_k4<<<sms * 8, 256, 4 * sizeof(int)>>>(d32, N, 4, counts);
  });
  std::printf("[probe] previous K4 int32 S=3 (with its zeroing memset): "
              "%.4f ms, counts differing %ld\n", t, bad(0, 4));
  t = timer.ms([&] {
    rows_k4<<<sms * escg::kBlocksPerSm, escg::kThreads>>>(d32, N, counts,
                                                          scratch);
  });
  std::printf("[probe] first version (a row per block, remainder one load "
              "at a time) int32 S=3: %.4f ms, counts differing %ld\n", t,
              bad(0, 4));
  CHECK(cudaMemset(scratch, 0, scratch_words * sizeof(int)));
  struct Case {
    const char* what;
    int bytes;
    const void* grid;
    int64_t from;
    int n_labels;
  };
  const Case cases[] = {
      {"int32 S=3", 4, d32, 0, 4},
      {"int16 S=3", 2, d16, 0, 4},
      {"int8 S=3", 1, d8, 0, 4},
      {"int32 S=15", 4, d32, 0, 16},
      {"int32 S=40", 4, d32, 0, 41},
      {"int32 S=3 from cell 1", 4, d32 + 1, 1, 4},
  };
  for (const Case& c : cases) {
    t = timer.ms([&] {
      CHECK((cudaError_t)density_counts(c.bytes, c.grid, N - c.from,
                                        c.n_labels, counts, scratch, 0,
                                        nullptr));
    });
    std::printf("[probe] K4 %s: %.4f ms, counts differing %ld\n", c.what, t,
                bad(c.from, c.n_labels));
  }
  t = timer.ms([&] { read_all<<<sms * 8, 256>>>((const uint4*)d32, N / 4,
                                                 sink); });
  std::printf("[probe] coalesced read of the int32 lattice (%.2f MB): "
              "%.4f ms, %.2f TB/s\n", 4.0 * N / 1e6, t, 4.0 * N / t / 1e9);
  return 0;
}

}  // namespace probe

int main() {
  const int rc = probe::run();
  std::fflush(stdout);
  return rc != 0 ? rc : std::system(
      "nvidia-smi --query-gpu=name,power.limit --format=csv,noheader");
}
