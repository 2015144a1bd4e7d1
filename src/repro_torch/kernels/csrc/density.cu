// Species histogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/density.py and its
// lifts over trials and over a device mesh, all one kernel:
//   K4  density_kernel  <- density_counts (_kernel), also vmapped over a
//                          batch of trials
//   K4s density_kernel  <- density_counts_sharded (K4 per shard, then
//                          psum), also vmapped over the trials of a pod
//                          group (the reference's sharded_pod)
//
// What it computes. counts[v] = the number of cells of the lattice (n cells
// of a contiguous run, which may start anywhere) whose label is v, for v in
// 0..S; labels outside 0..S are not counted, as the reference's one-hot
// over 0..S does not count them.
//
// What bounds it on this card. The lattice is read once (40.96 MB at
// 3200 x 3200 int32, 0.0122 ms at 3.35 TB/s) and S + 1 words are written:
// it is bound by bytes.
//
// What the design does about it. One launch and no zeroing pass. A grid of
// kBlocksPerSm blocks per SM strides over the lattice with 16-byte loads
// (4 int32, 8 int16 or 16 int8 labels a lane), kUnroll of them in flight per
// lane; a scalar head and tail take the cells before the first 16-byte
// boundary and after the last whole vector. Up to 16 labels each lane
// counts in registers (the bins rounded up to 4, 8 or 16 at compile time),
// comparing a word's packed labels with each label at once (__vcmpeq4 and
// __popc for int8, as K2 counts; Staging in tile_staging.cuh); the warp sums
// each count with __reduce_add_sync and the block sums its warps in shared
// memory. Above 16 labels (up to 4096) the block counts into shared-memory
// bins with atomics. Each block adds its sums into the accumulators of a
// scratch buffer that stays zero between launches; the last block to
// finish (a ticket taken with an atomic after a fence) moves the
// accumulators into counts, zeroing them, and re-arms the ticket for the
// next launch on the stream. Integer sums, so the result is exact in any
// order.
//
// One launch counts a table of runs (RunTable, up to kMaxGroup): run r is
// n_trials stacked lattices of n labels each (a lattice, a batch of
// trials, or one block of a decomposed lattice with its pod group's
// trials), and slice blockIdx.y of the grid is one (run, trial) pair,
// which sweeps its lattice as above. The runs that share a slot (the
// blocks of one pod group's lattices) add into one set of accumulators and
// one ticket per trial, so the last block of a (slot, trial) writes that
// trial's counts: K4 is one run of one trial, K4 per trial one run of n
// trials, K4s the blocks of one lattice in one slot, and K4s per trial the
// blocks of every pod group of a card, a slot per group. The runs'
// pointers travel by value in the launch's parameters, so a launch copies
// nothing to the card first.
#include "tile_staging.cuh"

namespace escg {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kBlocksPerSm = 4;
constexpr int kUnroll = 4;  // 16-byte loads in flight per lane
constexpr int kMaxDevices = 64;
constexpr int kMaxGroup = 32;  // runs in one K4s launch

// One lane's counts of labels 0..NB-1 (NB > 0), or the block's shared bins
// of labels 0..n_labels-1 (NB == 0).
template <typename T, int NB>
struct Counter {
  using St = Staging<T>;
  uint32_t c[NB > 0 ? NB : 1];
  int* bins;
  int n_labels;
  __device__ Counter(int* bins_, int n_labels_)
      : bins(bins_), n_labels(n_labels_) {
#pragma unroll
    for (int v = 0; v < NB; ++v) c[v] = 0;
  }
  __device__ __forceinline__ void cell(int x) {
    if constexpr (NB > 0) {
#pragma unroll
      for (int v = 0; v < NB; ++v) c[v] += x == v;
    } else if (x >= 0 && x < n_labels) {
      atomicAdd(&bins[x], 1);
    }
  }
  // the St::kPer labels packed in a word
  __device__ __forceinline__ void word(uint32_t w) {
    if constexpr (NB > 0) {
#pragma unroll
      for (int v = 0; v < NB; ++v) c[v] += St::equal(w, St::splat(v));
    } else {
#pragma unroll
      for (int b = 0; b < St::kPer; ++b)
        cell((int)(T)(w >> (b * St::kBits)));
    }
  }
  __device__ __forceinline__ void vec(const uint4& x) {
    word(x.x);
    word(x.y);
    word(x.z);
    word(x.w);
  }
};

// Add each lane's NB counts, summed over the block, to acc[0 .. n_labels).
template <int NB>
__device__ __forceinline__ void block_add(const uint32_t (&c)[NB],
                                          int n_labels, int* sums,
                                          int* acc) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int v = 0; v < NB; ++v) {
    const uint32_t s = __reduce_add_sync(kFull, c[v]);
    if ((tid & (kWarp - 1)) == 0) sums[(tid / kWarp) * NB + v] = (int)s;
  }
  __syncthreads();
  if (tid < n_labels) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sums[w * NB + tid];
    if (s) atomicAdd(&acc[tid], s);
  }
}

// Count the n labels of the run g as block `part` of the `parts` blocks
// that sweep it, add the block's sums into the accumulators `acc`, and let
// the last of the n_blocks blocks that share them (their ticket) move them
// into counts. The ticket and the accumulators are zero between launches.
template <typename T, int NB>
__device__ __forceinline__ void count_run(const T* g, int64_t n, int part,
                                          int parts, int n_labels,
                                          int* counts, int* ticket, int* acc,
                                          unsigned n_blocks) {
  extern __shared__ int bins[];  // NB == 0: n_labels bins
  __shared__ int sums[kWarps * (NB > 0 ? NB : 1)];
  __shared__ bool last;
  constexpr int kVec = 16 / (int)sizeof(T);  // labels in a 16-byte load
  const int tid = threadIdx.x;
  if constexpr (NB == 0) {
    for (int b = tid; b < n_labels; b += kThreads) bins[b] = 0;
    __syncthreads();
  }
  Counter<T, NB> cnt(bins, n_labels);
  // cells before the first 16-byte boundary
  int64_t head = (int64_t)((16 - ((uintptr_t)g & 15)) & 15) / sizeof(T);
  head = head < n ? head : n;
  const int64_t n_vec = (n - head) / kVec;
  const int64_t tail = head + n_vec * kVec;
  const int64_t i0 = (int64_t)part * kThreads + tid;
  const int64_t stride = (int64_t)parts * kThreads;
  if (i0 < head) cnt.cell((int)g[i0]);
  if (i0 < n - tail) cnt.cell((int)g[tail + i0]);
  // kUnroll loads in flight, the last round's past n_vec left out
  const uint4* v = reinterpret_cast<const uint4*>(g + head);
  for (int64_t i = i0; i < n_vec; i += kUnroll * stride) {
    uint4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * stride < n_vec) x[u] = __ldcs(v + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * stride < n_vec) cnt.vec(x[u]);
  }

  if constexpr (NB > 0) {
    block_add<NB>(cnt.c, n_labels, sums, acc);
  } else {
    __syncthreads();
    for (int b = tid; b < n_labels; b += kThreads)
      if (bins[b]) atomicAdd(&acc[b], bins[b]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd((unsigned*)ticket, 1u) == n_blocks - 1u;
  __syncthreads();
  if (!last) return;
  // the last block: every block's sums are in, move them out
  __threadfence();
  for (int b = tid; b < n_labels; b += kThreads)
    counts[b] = atomicExch(&acc[b], 0);
  if (tid == 0) *ticket = 0;
}

// The runs of one launch, by value: run r's n_trials lattices start at
// run[r], and it adds into slot slot[r], which `members[r]` runs of the
// launch share (both at most kMaxGroup, so a byte each keeps the launch's
// parameters small).
struct RunTable {
  const void* run[kMaxGroup];
  unsigned char slot[kMaxGroup];
  unsigned char members[kMaxGroup];
};

// K4, K4 per trial, K4s and K4s per trial: blockIdx.y is the (run, trial)
// pair; counts row slot * n_trials + trial has its own ticket
// scratch[row] and accumulators scratch[rows + row * n_labels ..] (rows =
// n_slots * n_trials), shared by the members of its slot.
template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
    density_kernel(RunTable t, int n_trials, int64_t n, int n_labels,
                   int n_slots, int* counts, int* scratch) {
  const int r = blockIdx.y / n_trials;
  const int trial = blockIdx.y - r * n_trials;
  const int row = t.slot[r] * n_trials + trial;
  const size_t rows = (size_t)n_slots * n_trials;
  count_run<T, NB>((const T*)t.run[r] + trial * n, n, blockIdx.x, gridDim.x,
                   n_labels, counts + (size_t)row * n_labels, scratch + row,
                   scratch + rows + (size_t)row * n_labels,
                   gridDim.x * (unsigned)t.members[r]);
}

// The card's SM count, asked once per device.
inline int sm_count(int device) {
  static int cache[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return 0;
  if (cache[device] == 0 &&
      cudaDeviceGetAttribute(&cache[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    cache[device] = 0;
  return cache[device];
}

// One launch over the n_runs runs of t, n_trials lattices of n labels
// each. Each (run, trial) slice gets as many blocks as it has rounds of
// kUnroll loads, and all slices together at most max_blocks.
template <typename T, int NB>
int launch(const RunTable& t, int n_runs, int n_trials, int64_t n,
           int n_labels, int n_slots, int* counts, int* scratch,
           int max_blocks, cudaStream_t stream) {
  const int64_t per_block = (int64_t)kThreads * kUnroll * (16 / sizeof(T));
  const int64_t want = (n + per_block - 1) / per_block;
  const int slices = n_runs * n_trials;
  const int cap = max_blocks / slices > 1 ? max_blocks / slices : 1;
  const int blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  const size_t smem = NB == 0 ? (size_t)n_labels * sizeof(int) : 0;
  density_kernel<T, NB><<<dim3(blocks, slices), kThreads, smem, stream>>>(
      t, n_trials, n, n_labels, n_slots, counts, scratch);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const RunTable& t, int n_runs, int n_trials, int64_t n,
             int n_labels, int n_slots, int* counts, int* scratch, int sms,
             cudaStream_t stream) {
  const int most = sms * kBlocksPerSm;
  if (n_labels <= 4)
    return launch<T, 4>(t, n_runs, n_trials, n, n_labels, n_slots, counts,
                        scratch, most, stream);
  if (n_labels <= 8)
    return launch<T, 8>(t, n_runs, n_trials, n, n_labels, n_slots, counts,
                        scratch, most, stream);
  if (n_labels <= 16)
    return launch<T, 16>(t, n_runs, n_trials, n, n_labels, n_slots, counts,
                         scratch, most, stream);
  return launch<T, 0>(t, n_runs, n_trials, n, n_labels, n_slots, counts,
                      scratch, most, stream);
}

}  // namespace escg

extern "C" {

// The counts (n_slots * n_trials, n_labels) of n_runs (1 .. 32) runs of
// n_trials lattices of n labels each, n_runs * n_trials <= 65535, in one
// launch; cell_bytes selects the lattice type (1 = int8, 2 = int16,
// 4 = int32). runs is a host array of the runs' pointers on the card and
// slots a host array of their slots (null: every run in slot 0), copied
// into the launch's parameters; row slot * n_trials + trial sums that
// trial's lattices of the slot's runs. scratch holds rows * (1 + n_labels)
// words, all zero before the first launch on a stream; each launch leaves
// them zero. Returns a cudaError_t (0 = launched).
int density_counts(int cell_bytes, const void* const* runs, const int* slots,
                   int n_runs, int n_trials, int64_t n, int n_labels,
                   int* counts, int* scratch, int device, void* stream) {
  if (n_runs < 1 || n_runs > escg::kMaxGroup || n_trials < 1 ||
      (int64_t)n_runs * n_trials > 65535)
    return (int)cudaErrorInvalidValue;
  escg::RunTable t{};
  int n_slots = 0;
  for (int r = 0; r < n_runs; ++r) {
    const int slot = slots == nullptr ? 0 : slots[r];
    if (slot < 0 || slot >= n_runs) return (int)cudaErrorInvalidValue;
    t.run[r] = runs[r];
    t.slot[r] = (unsigned char)slot;
    n_slots = slot + 1 > n_slots ? slot + 1 : n_slots;
  }
  for (int r = 0; r < n_runs; ++r)
    for (int q = 0; q < n_runs; ++q) t.members[r] += t.slot[q] == t.slot[r];
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int sms = escg::sm_count(device);
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cell_bytes) {
    case 1:
      return escg::dispatch<int8_t>(t, n_runs, n_trials, n, n_labels,
                                    n_slots, counts, scratch, sms, s);
    case 2:
      return escg::dispatch<int16_t>(t, n_runs, n_trials, n, n_labels,
                                     n_slots, counts, scratch, sms, s);
    case 4:
      return escg::dispatch<int32_t>(t, n_runs, n_trials, n, n_labels,
                                     n_slots, counts, scratch, sms, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* escg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
