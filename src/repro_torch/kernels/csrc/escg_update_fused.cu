// Fused-Philox sublattice kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/escg_update_fused.py:
//   K1 tile_round_kernel   <- escg_tile_round_fused  (_kernel, _apply_proposal)
//   K2 tile_rounds_kernel  <- escg_tile_rounds_fused (_mega_kernel)
// each over one lattice or a batch of trials
//
// What they compute. The lattice, rolled by -shift (the torus shift of the
// sublattice scheme), is cut into (th, tw) tiles. Tile (i, j) has the global
// id (off0 + i) * gw + (off1 + j); its proposal j comes from Philox-4x32-10
// with counter (tile_id * K + j, round, 0, 0) and key (seed0, seed1):
// cell = x0 % interior, dirn = x1 % nbhd, u = (x >> 8) * 2^-24. The tile
// applies its K proposals in order to its interior with the pair rule of
// src/repro/core/rules.py, thresholds and p1 + p2 in float32. K1 is one such
// round. K2 runs K Monte-Carlo steps in one launch: step t rolls by
// -shifts[t], sweeps every tile with seeds[t] at round 0 and counts the
// species into counts[t]; the grid stays in the drifted frame.
//
// A batch of IID trials (the reference vmaps its engines over them) is n
// lattices stacked in one buffer, and one launch covers them all: K1
// takes the trial from blockIdx.y and its seed words and shift from
// (n, 2) arrays on the card, and K2's blocks walk (trial, tile group)
// pairs. The trial never enters a Philox counter or a tile id: as in the
// reference, where each trial has its own key, trials differ by their seeds.
// K1 also covers every block of every trial of a card in one launch, for
// a batch of trials decomposed over a ('pod', 'rows', 'cols') mesh (the
// reference's sharded_pod, which vmaps K1 over the trials inside a
// shard_map over the blocks): a launch takes a table of up to kMaxRuns
// runs, each one block of one pod group with its n trials (RoundRuns),
// and each slice of blockIdx.y is one (run, trial) pair. A run reads its
// block extended by a halo (tile_staging.cuh), writes its (n, H, W)
// output, keys its tiles by its block's offset in the global tile grid and
// takes its group's seeds and shifts. A trial batch is a table of one run,
// and one lattice a table of one run of one trial.
//
// What bounds them on this card. Every proposal costs some 80 integer and
// float instructions against 4 one-cell accesses, so the sweep is bound by
// the instructions it issues, not by the 2 x H x W bytes it must move.
// Philox alone is 10 rounds of two 32 x 32 -> 64-bit multiplies and two
// three-input xors, and the multiplies go through the integer multiply
// pipe, which runs at a fraction of the float rate: at 3200 x 3200 the
// rounds alone take 35 of K1's 128 microseconds, and the tile load and
// store another 37 (probe/k1_probe.cu, on an H100 at 700 W). The
// proposals of one tile depend on each other through the cells they touch,
// so a tile is one thread's sequential loop and the parallelism is the tile
// count (40,000 at 3200 x 3200 with 8 x 32 tiles): every tile's chain must
// be resident at once.
//
// What the design does about it. A block is one warp and holds up to 32
// tiles, one per lane. The warp loads its tiles coalesced from device memory
// into shared memory, with the roll fused into the load (row (r + sr) mod H
// and column (c + sc) mod W by one compare and subtract each). The staging
// puts lane t's cells in bank t, so the sweep's accesses never conflict.
// Cells are staged as int8 where the labels fit (S <= 127), so every tile of
// a 3200 x 3200 lattice is resident at once. Each lane then sweeps its own
// tile in shared memory: it draws kBatch proposals at a time (Philox inline,
// round keys in registers, one wide multiply per half) so that their rounds
// overlap, decodes them with the remainders by the interior and the row
// width as multiplies by a precomputed reciprocal (exact for 32-bit
// operands), and applies them in order with selects, reading the dominance
// rates only for an interaction. The swept tiles go back to device memory
// coalesced, a word's cells in one store. K2 is a cooperative launch of
// persistent one-warp blocks that walk over all groups of tiles; each step
// is one phase (load with the roll, sweep, count, store into the ping-pong
// buffer) and one grid barrier before the next step reads what this one
// wrote. The count is taken from the staged tiles: for each label the lanes
// count the matching cells of their words four at a time (__vcmpeq4) and
// the warp sums them, into the block's bins, which the block adds to
// counts[t] once per step with integer atomics, exact in any order.
// The staging, its roll-fused load and its store, and the pair rule live in
// tile_staging.cuh, which K3 (escg_update.cu) shares.
#include <cooperative_groups.h>

#include "tile_staging.cuh"

namespace cg = cooperative_groups;

namespace escg {

// proposals a lane draws ahead of applying them, so that their Philox
// rounds overlap one another
constexpr int kBatch = 8;

// What a sweep needs besides the tile.
struct Sweep {
  int k;                // proposals per tile
  uint32_t gw, off0, off1;
  Rule rule;
  const float* dom;     // (n_dom, n_dom) float32
  const int* dirs;      // (8, 2) int32
};

struct PhiloxKeys {
  uint32_t k0[10], k1[10];
};

__device__ __forceinline__ PhiloxKeys round_keys(uint32_t s0, uint32_t s1) {
  PhiloxKeys k;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    k.k0[r] = s0 + (uint32_t)r * 0x9E3779B9u;
    k.k1[r] = s1 + (uint32_t)r * 0xBB67AE85u;
  }
  return k;
}

// Philox-4x32-10 of the counter (c0, c1, 0, 0).
__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1,
                                        const PhiloxKeys& k) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint64_t p0 = (uint64_t)0xD2511F53u * c0;
    const uint64_t p1 = (uint64_t)0xCD9E8D57u * c2;
    c0 = (uint32_t)(p1 >> 32) ^ c1 ^ k.k0[r];
    c1 = (uint32_t)p1;
    c2 = (uint32_t)(p0 >> 32) ^ c3 ^ k.k1[r];
    c3 = (uint32_t)p0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// Lane t applies its tile's K proposals in order to the staged cells. It
// draws kBatch proposals at a time and decodes them into cell indices and
// uniforms before applying them; the dominance rates are read only when a
// proposal of the warp interacts.
template <typename S>
__device__ void sweep_tile(uint32_t* words, const Geometry& g,
                           const Sweep& sw, const int* dirs, int tile,
                           uint32_t round, uint32_t seed0, uint32_t seed1) {
  using St = Staging<S>;
  const int t = threadIdx.x;
  S* cells = reinterpret_cast<S*>(words);
  const int ti = (int)g.by_lgw.div((uint32_t)tile);
  const int tj = tile - ti * g.lgw;
  const uint32_t tile_id =
      (sw.off0 + (uint32_t)ti) * sw.gw + (sw.off1 + (uint32_t)tj);
  const uint32_t base = tile_id * (uint32_t)sw.k;
  const uint32_t iw = g.iw.d;
  const uint32_t dir_mask = (uint32_t)sw.rule.nbhd - 1u;  // nbhd is 4 or 8
  const Rule rule = sw.rule;
  const PhiloxKeys keys = round_keys(seed0, seed1);
  for (int j0 = 0; j0 < sw.k; j0 += kBatch) {
    int at_s[kBatch], at_n[kBatch];
    float ua[kBatch], ud[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const uint4 x = philox(base + (uint32_t)(j0 + u), round, keys);
      const uint32_t cell = g.interior.mod(x.x);
      const uint32_t ir = g.iw.div(cell);
      const int r = 1 + (int)ir;
      const int c = 1 + (int)(cell - ir * iw);
      const int dirn = (int)(x.y & dir_mask);
      at_s[u] = St::at(g, t, r, c);
      at_n[u] = St::at(g, t, r + dirs[2 * dirn], c + dirs[2 * dirn + 1]);
      ua[u] = (float)(x.z >> 8) * 0x1p-24f;
      ud[u] = (float)(x.w >> 8) * 0x1p-24f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (j0 + u >= sw.k) break;
      const int2 next = pair_rule((int)cells[at_s[u]], (int)cells[at_n[u]],
                                  ua[u], ud[u], rule, sw.dom);
      cells[at_s[u]] = (S)next.x;
      cells[at_n[u]] = (S)next.y;
    }
  }
}

// Add the labels of the group's staged tiles to `bins` (one warp's own):
// for each label, the lanes count the cells that hold it in their words and
// the warp sums the counts.
template <typename S>
__device__ void count_group(const uint32_t* words, const Geometry& g,
                            int group, int n_dom, int* bins) {
  using St = Staging<S>;
  const int lane = threadIdx.x;
  const int total = g.th * g.G * g.P;
  const bool full = (group + 1) * g.P <= g.n_tiles;
  for (int v = 0; v < n_dom; ++v) {
    const uint32_t pattern = St::splat(v);
    uint32_t n = 0;
    for (int w = lane; w < total; w += kWarp)
      if (full || group * g.P + (int)g.by_P.mod((uint32_t)w) < g.n_tiles)
        n += St::equal(words[w], pattern);
    n = __reduce_add_sync(kFull, n);
    if (lane == 0) bins[v] += (int)n;
  }
}

// The torus shift of a trial, (shift mod side) for a shift of any sign.
__device__ __forceinline__ int wrap(int64_t shift, int side) {
  return (int)(((shift % side) + side) % side);
}

// One round over the group's P tiles of one lattice, read from `in` rolled
// by (-sr, -sc) and written to `out`.
template <typename T, typename S>
__device__ __forceinline__ void round_group(const T* in, T* out,
                                            uint32_t* words,
                                            const Geometry& g,
                                            const Sweep& sw, const int* sdirs,
                                            int group, int sr, int sc,
                                            uint32_t seed0, uint32_t seed1,
                                            uint32_t round) {
  int r0, c0;
  const int tile = group_tile(g, group, threadIdx.x, &r0, &c0);
  load_group<T, S>(in, words, g, tile, r0, c0, sr, sc);
  __syncwarp();
  if (tile >= 0) sweep_tile<S>(words, g, sw, sdirs, tile, round, seed0, seed1);
  __syncwarp();
  store_group<T, S>(out, words, g, tile, r0, c0);
}

// The runs of one K1 launch, by value: run r reads its n lattices from
// in[r] (n stacked sources of sh x sw cells), writes them to out[r] (n
// stacked H x W lattices), offsets its tile ids by (off0[r], off1[r]) tiles
// and takes trial t's seed words and shift from seeds[r][t] and
// shifts[r][t] ((n, 2) int64 on the card), or with seeds[r] null (one
// lattice) from the launch's scalars.
constexpr int kMaxRuns = 32;
struct RoundRuns {
  const void* in[kMaxRuns];
  void* out[kMaxRuns];
  const int64_t* seeds[kMaxRuns];
  const int64_t* shifts[kMaxRuns];
  uint32_t off0[kMaxRuns], off1[kMaxRuns];
};

// K1: one round, one block per group of P tiles (blockIdx.x) of each
// (run, trial) pair (blockIdx.y = run * n + trial), the lattice read rolled
// by its shift and written to its slice of the run's output. The Philox
// counters are those of the run's tiles in the global tile grid: trials
// differ by their seeds.
template <typename T, typename S>
__global__ void __launch_bounds__(kWarp)
    tile_round_kernel(RoundRuns runs, int n, Geometry g, Sweep sw, int sr,
                      int sc, uint32_t seed0, uint32_t seed1,
                      uint32_t round) {
  extern __shared__ uint32_t words[];
  __shared__ int sdirs[16];
  load_dirs(sw.dirs, sdirs);
  const int r = blockIdx.y / n;
  const int t = blockIdx.y - r * n;
  const int64_t* seeds = runs.seeds[r];
  if (seeds != nullptr) {
    const int64_t* shifts = runs.shifts[r];
    sr = wrap(shifts[2 * t], g.H);
    sc = wrap(shifts[2 * t + 1], g.W);
    seed0 = (uint32_t)seeds[2 * t];
    seed1 = (uint32_t)seeds[2 * t + 1];
  }
  sw.off0 = runs.off0[r];
  sw.off1 = runs.off1[r];
  const T* in = (const T*)runs.in[r] + (size_t)t * g.sh * g.sw;
  T* out = (T*)runs.out[r] + (size_t)t * g.H * g.W;
  round_group<T, S>(in, out, words, g, sw, sdirs, blockIdx.x, sr, sc, seed0,
                    seed1, round);
}

// Add a warp's bins into `dst` and zero them.
__device__ __forceinline__ void flush_bins(int* bins, int n_dom, int* dst) {
  __syncwarp();
  for (int b = threadIdx.x; b < n_dom; b += kWarp) {
    if (bins[b]) atomicAdd(&dst[b], bins[b]);
    bins[b] = 0;
  }
  __syncwarp();
}

// K2: n_steps Monte-Carlo steps of n_trials lattices in one cooperative
// launch (one lattice: n_trials = 1). Trial t's lattice is the t-th H x W
// slice of each buffer; its step s takes seeds[t][s] and shifts[t][s]
// ((n_trials, n_steps, 2) int64) and counts into counts[t][s] ((n_trials,
// n_steps, n_dom), zeroed before the launch). Step s reads the previous
// step's lattice (`in` for s = 0) rolled by -shifts[t][s], sweeps it tile
// group by tile group and writes it to the ping-pong buffer that makes the
// last step land in `out`. The blocks walk the (trial, group) pairs, so a
// group never straddles two trials; a block's bins hold one trial's counts
// and go to counts[t][s] when its walk reaches another trial and at the end
// of the step, with integer atomics, exact in any order. One grid barrier
// separates a step's writes from the next step's reads; the buffer a step
// writes was last read two steps before.
template <typename T, typename S>
__global__ void __launch_bounds__(kWarp)
    tile_rounds_kernel(const T* in, T* out, T* scratch, Geometry g, Sweep sw,
                       const int64_t* seeds, const int64_t* shifts,
                       int n_trials, int n_steps, int* counts) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ uint32_t words[];
  int* bins = reinterpret_cast<int*>(words + g.th * g.G * g.P);
  __shared__ int sdirs[16];
  load_dirs(sw.dirs, sdirs);
  const int n_dom = sw.rule.n_dom;
  for (int b = threadIdx.x; b < n_dom; b += kWarp) bins[b] = 0;
  const int n_groups = (g.n_tiles + g.P - 1) / g.P;
  const int64_t n_items = (int64_t)n_trials * n_groups;
  const size_t cells = (size_t)g.H * g.W;
  __syncwarp();

  const T* src = in;
  for (int s = 0; s < n_steps; ++s) {
    T* dst = ((n_steps - 1 - s) % 2 == 0) ? out : scratch;
    int held = -1;  // the trial whose counts the bins hold
    for (int64_t item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int t = (int)(item / n_groups);
      const int group = (int)(item - (int64_t)t * n_groups);
      if (t != held) {
        if (held >= 0)
          flush_bins(bins, n_dom,
                     counts + ((size_t)held * n_steps + s) * n_dom);
        held = t;
      }
      const size_t at = ((size_t)t * n_steps + s) * 2;
      round_group<T, S>(src + t * cells, dst + t * cells, words, g, sw,
                        sdirs, group, wrap(shifts[at], g.H),
                        wrap(shifts[at + 1], g.W), (uint32_t)seeds[at],
                        (uint32_t)seeds[at + 1], 0u);
      count_group<S>(words, g, group, n_dom, bins);
      __syncwarp();
    }
    if (held >= 0)
      flush_bins(bins, n_dom, counts + ((size_t)held * n_steps + s) * n_dom);
    if (s + 1 < n_steps) grid.sync();
    src = dst;
  }
}

// Dynamic shared memory of a block: the staging, and K2's bins.
__host__ inline size_t block_smem(const Geometry& g, int n_dom) {
  return ((size_t)g.th * g.G * g.P + (size_t)n_dom) * sizeof(int);
}

template <typename T, typename S>
int launch_round(const RoundRuns& runs, int n_runs, int n, const Geometry& g,
                 const Sweep& sw, int sr, int sc, uint32_t seed0,
                 uint32_t seed1, uint32_t round, cudaStream_t stream) {
  const size_t smem = block_smem(g, sw.rule.n_dom);
  cudaError_t err = allow_smem((const void*)tile_round_kernel<T, S>, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_groups = (g.n_tiles + g.P - 1) / g.P;
  tile_round_kernel<T, S><<<dim3(n_groups, n_runs * n), kWarp, smem,
                            stream>>>(runs, n, g, sw, sr, sc, seed0, seed1,
                                      round);
  return (int)cudaGetLastError();
}

// The largest grid of one-warp blocks that can be resident at once, which
// a cooperative launch may not exceed; 0 if none fits.
template <typename T, typename S>
int cooperative_blocks(const Geometry& g, int n_dom, int device) {
  const size_t smem = block_smem(g, n_dom);
  const void* kernel = (const void*)tile_rounds_kernel<T, S>;
  if (allow_smem(kernel, smem) != cudaSuccess) return 0;
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, tile_rounds_kernel<T, S>, kWarp, smem) != cudaSuccess)
    return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 0;
  return per_sm * sms;
}

template <typename T, typename S>
int launch_rounds(void* out, void* scratch, const void* in,
                  const Geometry& g, const Sweep& sw, const int64_t* seeds,
                  const int64_t* shifts, int n_trials, int n_steps,
                  int* counts, int device, cudaStream_t stream) {
  int coop = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int max_blocks = cooperative_blocks<T, S>(g, sw.rule.n_dom, device);
  if (max_blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(
      counts, 0, (size_t)n_trials * n_steps * sw.rule.n_dom * sizeof(int),
      stream);
  if (err != cudaSuccess) return (int)err;
  // the blocks stride over the (trial, group) pairs, so the grid need not
  // grow with the trials beyond what can be resident at once
  const int64_t n_items = (int64_t)n_trials * ((g.n_tiles + g.P - 1) / g.P);
  const int blocks = (int)(n_items < max_blocks ? n_items : max_blocks);
  const T* in_t = (const T*)in;
  T* out_t = (T*)out;
  T* scratch_t = (T*)scratch;
  Geometry g_arg = g;
  Sweep sw_arg = sw;
  void* args[] = {&in_t,   &out_t,  &scratch_t, &g_arg,   &sw_arg,
                  &seeds,  &shifts, &n_trials,  &n_steps, &counts};
  err = cudaLaunchCooperativeKernel((const void*)tile_rounds_kernel<T, S>,
                                    dim3(blocks), dim3(kWarp), args,
                                    block_smem(g, sw.rule.n_dom), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace escg

extern "C" {

// cell_bytes selects the lattice type (1 = int8, 2 = int16, 4 = int32) and
// stage_bytes the type its cells are staged in (1, or cell_bytes);
// tiles_per_block is how many tiles a block stages (1..32). Every entry
// point returns a cudaError_t (0 = launched).
//
// K1 over n_runs (1 .. 32) runs of n lattices each, n_runs * n <= 65535:
// run r reads its n stacked sources of SH x SW cells from ins[r] and writes
// its n stacked H x W lattices to outs[r] (host arrays of pointers on the
// card), its tile ids offset by (offsets[2r], offsets[2r + 1]) tiles in a
// global tile grid gw tiles wide. SH is H, or H + th with a halo of th
// rows from the block below (then every shift's row is below th); SW the
// same for columns. With `seeds` null (one lattice: n_runs = n = 1) the seed
// words are seed0/seed1 and the shift shift0/shift1; else trial t of run r
// takes its own from seeds[r] and shifts[r], (n, 2) int64 on the card.
int escg_tile_round_fused(int cell_bytes, int stage_bytes,
                          int tiles_per_block, int n_runs, void* const* outs,
                          const void* const* ins,
                          const int64_t* const* seeds,
                          const int64_t* const* shifts,
                          const uint32_t* offsets, int n, int H, int W,
                          int SH, int SW, int th, int tw, int k, uint32_t gw,
                          uint32_t seed0, uint32_t seed1, uint32_t round,
                          int shift0, int shift1, const float* dom,
                          int n_dom, const int* dirs, int nbhd, float t_eps,
                          float t_eps_mu, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_runs < 1 || n_runs > escg::kMaxRuns || n < 1 ||
      (int64_t)n_runs * n > 65535 || (seeds == nullptr && n_runs * n > 1) ||
      (SH != H && SH != H + th) || (SW != W && SW != W + tw))
    return (int)cudaErrorInvalidValue;
  escg::RoundRuns runs{};
  for (int r = 0; r < n_runs; ++r) {
    runs.in[r] = ins[r];
    runs.out[r] = outs[r];
    runs.seeds[r] = seeds == nullptr ? nullptr : seeds[r];
    runs.shifts[r] = seeds == nullptr ? nullptr : shifts[r];
    runs.off0[r] = offsets[2 * r];
    runs.off1[r] = offsets[2 * r + 1];
  }
  const escg::Geometry g = escg::make_geometry(H, W, th, tw, stage_bytes,
                                               tiles_per_block, SH, SW);
  const escg::Sweep sw{k, gw, 0u, 0u,
                       escg::Rule{t_eps, t_eps_mu, nbhd, n_dom}, dom, dirs};
  const int sr = ((shift0 % H) + H) % H;
  const int sc = ((shift1 % W) + W) % W;
  cudaStream_t s = (cudaStream_t)stream;
  ESCG_DISPATCH(cell_bytes, stage_bytes,
                (escg::launch_round<T, S>(runs, n_runs, n, g, sw, sr, sc,
                                          seed0, seed1, round, s)));
  return (int)cudaErrorInvalidValue;
}

// K2 over n_trials lattices stacked in `in`, `out` and `scratch` (one
// lattice: n_trials = 1), with seeds and shifts (n_trials, n_steps, 2)
// int64 and counts (n_trials, n_steps, n_dom) int32 on the card.
int escg_tile_rounds_fused(int cell_bytes, int stage_bytes,
                           int tiles_per_block, void* out, void* scratch,
                           const void* in, int n_trials, int H, int W,
                           int th, int tw, int k, uint32_t gw, uint32_t off0,
                           uint32_t off1, const int64_t* seeds,
                           const int64_t* shifts, int n_steps,
                           const float* dom, int n_dom,
                           const int* dirs, int nbhd, float t_eps,
                           float t_eps_mu, int* counts, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const escg::Geometry g = escg::make_geometry(H, W, th, tw, stage_bytes,
                                               tiles_per_block, H, W);
  const escg::Sweep sw{k, gw, off0, off1,
                       escg::Rule{t_eps, t_eps_mu, nbhd, n_dom}, dom, dirs};
  cudaStream_t s = (cudaStream_t)stream;
  ESCG_DISPATCH(cell_bytes, stage_bytes,
                (escg::launch_rounds<T, S>(out, scratch, in, g, sw, seeds,
                                           shifts, n_trials, n_steps, counts,
                                           device, s)));
  return (int)cudaErrorInvalidValue;
}

// The most blocks a K2 launch may use on `device` for this lattice type,
// staging and tile, 0 if the cooperative launch cannot be made.
int escg_tile_rounds_fused_blocks(int cell_bytes, int stage_bytes,
                                  int tiles_per_block, int th, int tw,
                                  int n_dom, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return 0;
  const escg::Geometry g = escg::make_geometry(th, tw, th, tw, stage_bytes,
                                               tiles_per_block, th, tw);
  ESCG_DISPATCH(cell_bytes, stage_bytes,
                (escg::cooperative_blocks<T, S>(g, n_dom, device)));
  return 0;
}

const char* escg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
