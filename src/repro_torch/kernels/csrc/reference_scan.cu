// The strict sequential scan of the reference engine for Hopper (sm_90a).
//
// Stands in for the lax.scan of src/repro/core/reference.py (run_proposals),
// which XLA compiles into a device loop; the JAX package has no Pallas
// kernel for it:
//   S1 reference_scan_kernel  <- reference.run_proposals
//
// What it computes. Proposals b = 0 .. B-1, in order: proposal b pairs the
// flat cell i = cell[b] with its neighbour ni in direction dirn[b] (row
// i / W, column i % W, plus the direction's offsets; wrapped with flux,
// clamped to the edge without), applies the pair rule of
// src/repro/core/rules.py (pair_rule of tile_staging.cuh: float32
// thresholds, p1 + p2 summed in float32) to the cells as the earlier
// proposals left them, and stores the cell's new label at i and then the
// neighbour's at ni. With a touched map (drop_conflicts), a proposal that
// meets a cell an earlier proposal touched is dropped, and both its cells
// count as touched whether it was dropped or not. The number of applied
// proposals goes to *kept.
//
// What bounds it on this card. Step b depends on an earlier step only
// through a cell they share. On a large lattice a window of a thousand
// steps touches some two thousand of millions of cells, so such chains are
// rare, and the work is a gather and a scatter of 2 cells a step plus 16
// bytes of proposal: bound by bytes (and by the latency of one gather round
// trip per window). On a small lattice nearly every step shares a cell with
// an earlier one, and the chain through shared memory sets the time.
//
// What the design does about it. One block of kThreads threads walks the
// stream in windows of kSteps = kThreads * kPer proposals (1,024, or 256
// on a lattice of fewer than 65,536 cells). Per window:
//  1. the window's proposal fields have been copied into shared memory
//     with 4-byte cp.async while the previous window ran (double-buffered);
//  2. each thread takes its steps' cells i and ni, starts loading their
//     labels from the lattice, and inserts both cell ids into a shared
//     hash table (open addressing, 4 * kSteps slots), keeping with
//     atomicMin the smallest step that names each cell. A step is *first*
//     when both of its cells' entries hold its own step, which also holds
//     for a self-pair (ni == i at a clamped edge). The thread that claims a
//     slot stores the cell's label (and touched flag) in it;
//  3. every first step is applied in parallel to the table's labels (no
//     earlier step of the window touches its cells, and no other first
//     step shares them), the cell's label written before the neighbour's;
//  4. one thread applies the remaining steps in order, reading and writing
//     through the table (a warp ballot marks them, __ffs walks the marks),
//     so each cell's label is always the one after the latest earlier step
//     that touched it;
//  5. the claiming threads write changed labels back to the lattice (and,
//     with drop_conflicts, mark their cells touched) and empty their slots.
// With drop_conflicts a step is kept iff it is first and neither cell is
// touched as gathered: then no step needs step 4. The numpy model of this
// schedule in tests/test_torch_reference.py (_window_schedule) is held to
// the host loop on the CPU, for windows of 1 to 1024 steps.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "tile_staging.cuh"

namespace escg {

// The window's shape: kThreads threads, kPer steps each; both powers of 2.
template <int THREADS, int PER>
struct Window {
  static constexpr int kThreads = THREADS;
  static constexpr int kPer = PER;
  static constexpr int kSteps = THREADS * PER;
  static constexpr int kSlots = 4 * kSteps;  // hash slots, load <= 1/2
  static constexpr int kFields = 4;          // cell, dirn, u_act, u_dom
  // shared memory: keys, first steps and labels of the slots; the two
  // buffers of proposal fields; the steps' slots; the in-order marks; the
  // slots' touched flags
  static constexpr size_t kSmem =
      sizeof(int) * ((size_t)3 * kSlots + 2 * kFields * kSteps +
                     2 * kSteps + kSteps / kWarp) +
      kSlots;
  static_assert((THREADS & (THREADS - 1)) == 0 && THREADS % kWarp == 0,
                "threads must be a power of 2 of whole warps");
  static_assert((PER & (PER - 1)) == 0, "steps a thread must be 2^k");
};

// The windows: 1024 threads of one step each, or 256 on a lattice of
// fewer than kSmallLattice cells, where more steps of a window share a
// cell and go through step 4 (chosen with kernels/probe/s1_probe.cu).
using LargeWindow = Window<1024, 1>;
using SmallWindow = Window<256, 1>;
constexpr int64_t kSmallLattice = 1 << 16;

__host__ __device__ constexpr int log2_of(int x) {
  return x > 1 ? 1 + log2_of(x / 2) : 0;
}

// The slot of `key` (Fibonacci hashing, then linear probing), claimed if
// the key is new (*claimed set).
template <int SLOTS>
__device__ __forceinline__ int insert(int* keys, int key, bool* claimed) {
  unsigned s = ((unsigned)key * 0x9E3779B1u) >> (32 - log2_of(SLOTS));
  for (;;) {
    const int prev = atomicCAS(&keys[s], -1, key);
    if (prev == -1 || prev == key) {
      *claimed = prev == -1;
      return (int)s;
    }
    s = (s + 1) & (SLOTS - 1);
  }
}

// Start copying the fields of steps [b0, b0 + n) into buffer `buf`.
template <typename Wd>
__device__ __forceinline__ void stage_window(
    uint32_t* buf, int64_t b0, int n, const int* cell, const int* dirn,
    const float* u_act, const float* u_dom) {
  const uint32_t* src[Wd::kFields] = {
      (const uint32_t*)cell, (const uint32_t*)dirn, (const uint32_t*)u_act,
      (const uint32_t*)u_dom};
#pragma unroll
  for (int f = 0; f < Wd::kFields; ++f)
    for (int k = threadIdx.x; k < n; k += Wd::kThreads)
      cp_async4(buf + f * Wd::kSteps + k, src[f] + b0 + k);
}

template <typename T, typename Wd>
__global__ void __launch_bounds__(Wd::kThreads, 1) reference_scan_kernel(
    T* __restrict__ grid, int H, int W, int64_t n_props,
    const int* __restrict__ cell, const int* __restrict__ dirn,
    const float* __restrict__ u_act, const float* __restrict__ u_dom,
    const float* __restrict__ dom, const int* __restrict__ dirs, Rule rule,
    int flux, uint8_t* __restrict__ touched, int* __restrict__ kept) {
  constexpr int kSteps = Wd::kSteps, kSlots = Wd::kSlots;
  constexpr int kThreads = Wd::kThreads, kPer = Wd::kPer;
  extern __shared__ __align__(16) int smem[];
  int* keys = smem;                    // cell id, -1 when empty
  int* first = keys + kSlots;          // the smallest step naming the cell
  int* label = first + kSlots;         // the cell's label in the window
  uint32_t* fields = (uint32_t*)(label + kSlots);  // [2][kFields][kSteps]
  int* slot_i = (int*)(fields + 2 * Wd::kFields * kSteps);
  int* slot_n = slot_i + kSteps;
  unsigned* late = (unsigned*)(slot_n + kSteps);  // steps for step 4
  uint8_t* was_touched = (uint8_t*)(late + kSteps / kWarp);
  __shared__ int sdirs[16];
  __shared__ int any_late;
  __shared__ int n_kept;
  const int tid = threadIdx.x, lane = tid & (kWarp - 1);
  const bool drop = touched != nullptr;
  const Divisor by_w((uint32_t)W);

  for (int s = tid; s < kSlots; s += kThreads) {
    keys[s] = -1;
    first[s] = INT_MAX;
  }
  load_dirs(dirs, sdirs);
  if (tid == 0) n_kept = 0;
  const int64_t n_windows = (n_props + kSteps - 1) / kSteps;
  if (n_windows > 0)
    stage_window<Wd>(fields, 0, (int)min((int64_t)kSteps, n_props), cell,
                     dirn, u_act, u_dom);
  cp_async_commit();

  int my_kept = 0;
  for (int64_t w = 0; w < n_windows; ++w) {
    const int64_t b0 = w * kSteps;
    const int n = (int)min((int64_t)kSteps, n_props - b0);
    if (w + 1 < n_windows) {
      const int64_t b1 = b0 + kSteps;
      stage_window<Wd>(fields + ((w + 1) & 1) * Wd::kFields * kSteps, b1,
                       (int)min((int64_t)kSteps, n_props - b1), cell, dirn,
                       u_act, u_dom);
    }
    cp_async_commit();
    cp_async_wait_all_but_one();  // this window's fields, for this lane
    if (tid == 0) any_late = 0;
    __syncthreads();  // ... for every lane; the last window's slots empty
    const uint32_t* f = fields + (w & 1) * Wd::kFields * kSteps;
    const int* f_cell = (const int*)f;
    const int* f_dirn = (const int*)(f + kSteps);
    const float* f_ua = (const float*)(f + 2 * kSteps);
    const float* f_ud = (const float*)(f + 3 * kSteps);

    // 2. the steps' cells, their labels and their slots
    int own_cell[2 * kPer], own_slot[2 * kPer], own_label[2 * kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int b = p * kThreads + tid;
      own_slot[2 * p] = own_slot[2 * p + 1] = -1;
      if (b < n) {
        const int i = f_cell[b];
        const int d = f_dirn[b];
        const int r = (int)by_w.div((uint32_t)i);
        int nr = r + sdirs[2 * d];
        int nc = i - r * W + sdirs[2 * d + 1];
        if (flux) {  // the directions are unit steps
          nr = nr < 0 ? nr + H : (nr >= H ? nr - H : nr);
          nc = nc < 0 ? nc + W : (nc >= W ? nc - W : nc);
        } else {
          nr = min(max(nr, 0), H - 1);
          nc = min(max(nc, 0), W - 1);
        }
        const int ni = nr * W + nc;
        const int gi = (int)grid[i];
        const int gn = (int)grid[ni];
        const uint8_t ti = drop ? touched[i] : 0;
        const uint8_t tn = drop ? touched[ni] : 0;
        bool claimed_i, claimed_n;
        const int si = insert<kSlots>(keys, i, &claimed_i);
        atomicMin(&first[si], b);
        const int sn = insert<kSlots>(keys, ni, &claimed_n);
        atomicMin(&first[sn], b);
        slot_i[b] = si;
        slot_n[b] = sn;
        if (claimed_i) {
          label[si] = gi;
          was_touched[si] = ti;
          own_cell[2 * p] = i;
          own_slot[2 * p] = si;
          own_label[2 * p] = gi;
        }
        if (claimed_n) {
          label[sn] = gn;
          was_touched[sn] = tn;
          own_cell[2 * p + 1] = ni;
          own_slot[2 * p + 1] = sn;
          own_label[2 * p + 1] = gn;
        }
      }
    }
    __syncthreads();

    // 3. the first steps, in parallel
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int b = p * kThreads + tid;
      bool is_late = false;
      if (b < n) {
        const int si = slot_i[b], sn = slot_n[b];
        const bool is_first = first[si] == b && first[sn] == b;
        const bool apply =
            is_first && !(drop && (was_touched[si] | was_touched[sn]));
        if (apply) {
          const int2 out =
              pair_rule(label[si], label[sn], f_ua[b], f_ud[b], rule, dom);
          label[si] = out.x;
          label[sn] = out.y;
          ++my_kept;
        }
        is_late = !drop && !is_first;
      }
      const unsigned marks = __ballot_sync(kFull, is_late);
      if (lane == 0) {
        late[(p * kThreads + tid) / kWarp] = marks;
        if (marks) any_late = 1;
      }
    }
    __syncthreads();

    // 4. the other steps, in order, by one thread
    if (any_late) {
      if (tid == 0) {
        for (int word = 0; word < (n + kWarp - 1) / kWarp; ++word) {
          for (unsigned m = late[word]; m; m &= m - 1) {
            const int b = word * kWarp + __ffs(m) - 1;
            const int si = slot_i[b], sn = slot_n[b];
            const int2 out = pair_rule(label[si], label[sn], f_ua[b],
                                       f_ud[b], rule, dom);
            label[si] = out.x;
            label[sn] = out.y;
            ++my_kept;
          }
        }
      }
      __syncthreads();
    }

    // 5. write back and empty the claimed slots
#pragma unroll
    for (int c = 0; c < 2 * kPer; ++c) {
      const int s = own_slot[c];
      if (s >= 0) {
        const int v = label[s];
        if (v != own_label[c]) grid[own_cell[c]] = (T)v;
        if (drop && !was_touched[s]) touched[own_cell[c]] = 1;
        keys[s] = -1;
        first[s] = INT_MAX;
      }
    }
  }
  cp_async_wait_all();
  atomicAdd(&n_kept, my_kept);
  __syncthreads();
  if (tid == 0) *kept = n_kept;
}

template <typename T, typename Wd>
int launch_window(void* grid, int H, int W, int64_t n_props,
                  const int* cell, const int* dirn, const float* u_act,
                  const float* u_dom, const float* dom, const int* dirs,
                  const Rule& rule, int flux, void* touched, int* kept,
                  cudaStream_t stream) {
  const void* kernel = (const void*)reference_scan_kernel<T, Wd>;
  cudaError_t err = allow_smem(kernel, Wd::kSmem);
  if (err != cudaSuccess) return (int)err;
  reference_scan_kernel<T, Wd><<<1, Wd::kThreads, Wd::kSmem, stream>>>(
      (T*)grid, H, W, n_props, cell, dirn, u_act, u_dom, dom, dirs, rule,
      flux, (uint8_t*)touched, kept);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(void* grid, int H, int W, int64_t n_props, const int* cell,
           const int* dirn, const float* u_act, const float* u_dom,
           const float* dom, const int* dirs, const Rule& rule, int flux,
           void* touched, int* kept, cudaStream_t stream) {
  if ((int64_t)H * W < kSmallLattice)
    return launch_window<T, SmallWindow>(grid, H, W, n_props, cell, dirn,
                                         u_act, u_dom, dom, dirs, rule, flux,
                                         touched, kept, stream);
  return launch_window<T, LargeWindow>(grid, H, W, n_props, cell, dirn,
                                       u_act, u_dom, dom, dirs, rule, flux,
                                       touched, kept, stream);
}

}  // namespace escg

extern "C" {

// cell_bytes selects the lattice type (1 = int8, 2 = int16, 4 = int32).
// touched is null, or H * W zeroed bytes for drop_conflicts; kept is one
// int on the card. Returns a cudaError_t (0 = launched).
int reference_scan(int cell_bytes, void* grid, int H, int W, int64_t n_props,
                   const int* cell, const int* dirn, const float* u_act,
                   const float* u_dom, const float* dom, int n_dom,
                   const int* dirs, float t_eps, float t_eps_mu, int flux,
                   void* touched, int* kept, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const escg::Rule rule{t_eps, t_eps_mu, 0, n_dom};
  cudaStream_t s = (cudaStream_t)stream;
  switch (cell_bytes) {
    case 1:
      return escg::launch<int8_t>(grid, H, W, n_props, cell, dirn, u_act,
                                      u_dom, dom, dirs, rule, flux, touched,
                                      kept, s);
    case 2:
      return escg::launch<int16_t>(grid, H, W, n_props, cell, dirn,
                                       u_act, u_dom, dom, dirs, rule, flux,
                                       touched, kept, s);
    case 4:
      return escg::launch<int32_t>(grid, H, W, n_props, cell, dirn,
                                       u_act, u_dom, dom, dirs, rule, flux,
                                       touched, kept, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* escg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
