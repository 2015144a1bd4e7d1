// Stream-fed sublattice round for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/escg_update.py:
//   K3 tile_round_kernel  <- escg_tile_round (_kernel), over one lattice, a
//      batch of trials, or every block of every trial of a card (a table of
//      runs, blockIdx.y the (run, trial) pair, one launch for all)
//
// What it computes. The lattice, rolled by -shift (the torus shift of the
// sublattice scheme), is cut into (th, tw) tiles in raster order. Tile t
// applies its K proposals in order: proposal j is (cell[t*K + j], dirn[...],
// u_act[...], u_dom[...]), read from the (T, K) buffers that the threefry
// streams of core/rng.py filled. The cell is an index into the tile's
// interior: row 1 + cell / (tw - 2), column 1 + cell % (tw - 2); the
// neighbour is that cell plus dirs[dirn]. The pair rule is the one of
// src/repro/core/rules.py and of K1 (pair_rule in tile_staging.cuh). This is
// core/sublattice.py::run_round without the roll back: the result stays in
// the rolled frame. A launch takes a table of up to kMaxRuns runs
// (StreamRuns): run r is one block of a lattice decomposed over a
// ('pod', 'rows', 'cols') mesh with the n trials of its pod group (the
// reference vmaps K3 over the trials inside a shard_map over the blocks),
// read from its block extended by a halo (tile_staging.cuh) at each trial's
// own shift, and fed with its own (n, T, K) proposals, drawn for its tiles'
// global ids. A trial batch is a table of one run, one lattice a table of
// one run of one trial.
//
// What bounds it on this card. Bytes: every update reads 16 bytes of
// proposals, and the lattice is read and written once, 245.7 MB at
// 3200 x 3200 int32 with 256 proposals per tile (0.073 ms at 3.35 TB/s),
// two thirds of it proposals. The proposals of one tile depend on each
// other through the cells they touch, so a tile is one lane's sequential
// loop and the parallelism is the tile count (40,000 at 3200 x 3200 with
// 8 x 32 tiles): the proposal stream has to arrive while the lanes sweep.
//
// What the design does about it. It is K1's design fed from the buffers: a
// one-warp block stages up to 32 tiles in shared memory (int8 where the
// labels fit; tile_staging.cuh), loaded coalesced with the torus roll fused
// into the load; lane t sweeps tile t there, and the block writes its tiles
// back coalesced. The proposals pass through shared memory in chunks of
// kChunk per tile. The kChunk words of one tile's row of a buffer are one
// contiguous run, which the warp copies with 16-byte cp.async (4-byte where
// K or a buffer is not 16-byte aligned), neighbouring lanes on neighbouring
// addresses. Two chunk buffers alternate, so chunk i + 1 streams in while
// the lanes sweep chunk i, and the first chunk streams in while the block
// loads its tiles. A chunk is laid out [field][tile][j], each tile's row
// padded by kPad words, so that the 16-byte reads with which lane t takes
// four proposals of its own tile fall on distinct banks in every quarter
// warp. The cell's row and column come from a multiply by a reciprocal
// (Divisor), not a hardware division.
#include "tile_staging.cuh"

namespace escg {

// Proposals per tile in a chunk (the kernel is a template on it; kChunk is
// the one the library launches), and the words of padding after each tile's
// row of a chunk: a row takes C + kPad words, and (C + kPad) / 4 is odd, so
// the 8 lanes of a quarter warp, each reading 16 bytes at the same j of its
// own row, hit 8 distinct groups of 4 banks. Of 8, 16 and 32, chunks of 32
// ran fastest (probe/k3_probe.cu): a tile's run of 128 bytes a buffer serves
// device memory better than shorter runs, though at 44 KB a block park3's
// 1,250 blocks then take two waves.
constexpr int kChunk = 32;
constexpr int kPad = 4;
constexpr int kFields = 4;  // cell, dirn, u_act, u_dom
constexpr int kStages = 2;  // chunk buffers

template <int C>
struct Chunk {
  static_assert(C % 8 == 0 && 32 % C == 0 && ((C + kPad) / 4) % 2 == 1,
                "a chunk is swept 8 proposals at a time from padded rows");
  static constexpr int kRow = C + kPad;
  // words of one chunk buffer for P tiles
  static __host__ __device__ int words(int P) { return kFields * P * kRow; }
};

// The (T, K) proposal buffers, as 32-bit words.
struct Stream {
  const uint32_t* field[kFields];
  int k;
};

// Start copying proposals [j0, j0 + n) of the group's `tiles` tiles (from
// tile `first` on) into the chunk buffer `buf`: word j - j0 of field f of
// tile t lands at buf[(f * P + t) * (C + kPad) + j - j0]. kQ lanes copy one
// tile's run, a piece of 16 bytes (VEC) or 4 bytes each.
template <int C, bool VEC>
__device__ __forceinline__ void stream_chunk(uint32_t* buf, const Stream& st,
                                             int P, int first, int tiles,
                                             int j0, int n) {
  constexpr int kPiece = VEC ? 4 : 1;  // words a lane copies at once
  constexpr int kQ = C / kPiece;       // lanes on one tile's run
  constexpr int kRow = Chunk<C>::kRow;
  const int lane = threadIdx.x;
  const int p = lane % kQ;
  if (p * kPiece >= n) return;  // past the end of a short last chunk
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    const uint32_t* src =
        st.field[f] + (size_t)first * st.k + j0 + p * kPiece;
    uint32_t* dst = buf + f * P * kRow + p * kPiece;
#pragma unroll 4
    for (int t = lane / kQ; t < tiles; t += kWarp / kQ) {
      if (VEC)
        cp_async16(dst + t * kRow, src + (size_t)t * st.k);
      else
        cp_async4(dst + t * kRow, src + (size_t)t * st.k);
    }
  }
}

// Lane t applies the first n (up to 8) of the proposals w[.][0..7] (the
// four fields' words) in order to its staged tile: their cells' places are
// decoded first, then the 8 are applied one after another.
template <typename S>
__device__ __forceinline__ void apply_batch(uint32_t* words,
                                            const uint32_t (&w)[kFields][8],
                                            int n, const Geometry& g,
                                            const Rule& rule,
                                            const float* dom,
                                            const int* dirs) {
  using St = Staging<S>;
  const int t = threadIdx.x;
  S* cells = reinterpret_cast<S*>(words);
  const uint32_t iw = g.iw.d;
  int at_s[8], at_n[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const uint32_t ir = g.iw.div(w[0][u]);
    const int r = 1 + (int)ir;
    const int c = 1 + (int)(w[0][u] - ir * iw);
    const int d = (int)(w[1][u] & 7u);  // a slot past n holds stale words
    at_s[u] = St::at(g, t, r, c);
    at_n[u] = St::at(g, t, r + dirs[2 * d], c + dirs[2 * d + 1]);
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    if (u >= n) break;
    const int2 next = pair_rule((int)cells[at_s[u]], (int)cells[at_n[u]],
                                __uint_as_float(w[2][u]),
                                __uint_as_float(w[3][u]), rule, dom);
    cells[at_s[u]] = (S)next.x;
    cells[at_n[u]] = (S)next.y;
  }
}

// Lane t applies the n proposals of its tile staged in the chunk buffer
// `buf` in order, reading each field 16 bytes at a time.
template <typename S, int C>
__device__ __forceinline__ void sweep_chunk(uint32_t* words,
                                            const uint32_t* buf,
                                            const Geometry& g, int n,
                                            const Rule& rule,
                                            const float* dom,
                                            const int* dirs) {
  const uint32_t* row = buf + threadIdx.x * Chunk<C>::kRow;
  const int field = g.P * Chunk<C>::kRow;
  for (int q = 0; q < n; q += 8) {
    uint32_t w[kFields][8];
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      const uint4* p = reinterpret_cast<const uint4*>(row + f * field + q);
      const uint4 a = p[0], b = p[1];
      w[f][0] = a.x, w[f][1] = a.y, w[f][2] = a.z, w[f][3] = a.w;
      w[f][4] = b.x, w[f][5] = b.y, w[f][6] = b.z, w[f][7] = b.w;
    }
    apply_batch<S>(words, w, n - q, g, rule, dom, dirs);
  }
}

// The runs of one K3 launch, by value: run r reads its n lattices from
// in[r] (n stacked sources of sh x sw cells), writes them to out[r] (n
// stacked H x W lattices) and plays trial t's (T, K) slice of its proposal
// fields field[r][f] ((n, T, K) each); trial t's shift is shifts[r][t]
// ((n, 2) int64 on the card), or with shifts[r] null (one lattice) the
// launch's (sr, sc).
constexpr int kMaxRuns = 32;
struct StreamRuns {
  const void* in[kMaxRuns];
  void* out[kMaxRuns];
  const int64_t* shifts[kMaxRuns];
  const uint32_t* field[kMaxRuns][kFields];
};

// K3: one round, one block per group of P tiles (blockIdx.x) of each (run,
// trial) pair (blockIdx.y = run * n + trial), read rolled by the trial's
// shift and written in the rolled frame. Shared memory holds the two chunk
// buffers, then the staged tiles.
template <typename T, typename S, int C, bool VEC>
__global__ void __launch_bounds__(kWarp)
    tile_round_kernel(StreamRuns runs, int n, Geometry g, int k, int sr,
                      int sc, Rule rule, const float* dom, const int* dirs) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int sdirs[16];
  const int r = blockIdx.y / n;
  const int trial = blockIdx.y - r * n;
  const int64_t* shifts = runs.shifts[r];
  if (shifts != nullptr) {
    const int64_t dy = shifts[2 * trial], dx = shifts[2 * trial + 1];
    sr = (int)(((dy % g.H) + g.H) % g.H);
    sc = (int)(((dx % g.W) + g.W) % g.W);
  }
  const T* in = (const T*)runs.in[r] + (size_t)trial * g.sh * g.sw;
  T* out = (T*)runs.out[r] + (size_t)trial * g.H * g.W;
  Stream st;
  st.k = k;
#pragma unroll
  for (int f = 0; f < kFields; ++f)
    st.field[f] = runs.field[r][f] + (size_t)trial * g.n_tiles * k;
  uint32_t* chunks = smem;
  const int chunk_words = Chunk<C>::words(g.P);
  uint32_t* words = smem + kStages * chunk_words;
  load_dirs(dirs, sdirs);
  int r0, c0;
  const int tile = group_tile(g, blockIdx.x, threadIdx.x, &r0, &c0);
  const int first = blockIdx.x * g.P;
  const int tiles = min(g.P, g.n_tiles - first);
  const int n_chunks = (st.k + C - 1) / C;
  if (n_chunks > 0)
    stream_chunk<C, VEC>(chunks, st, g.P, first, tiles, 0, min(C, st.k));
  cp_async_commit();
  load_group<T, S>(in, words, g, tile, r0, c0, sr, sc);
  for (int i = 0; i < n_chunks; ++i) {
    const int j1 = (i + 1) * C;
    if (j1 < st.k)
      stream_chunk<C, VEC>(chunks + ((i + 1) % kStages) * chunk_words, st,
                           g.P, first, tiles, j1, min(C, st.k - j1));
    cp_async_commit();
    cp_async_wait_all_but_one();  // chunk i has landed for this lane
    __syncwarp();                 // ... and for every lane
    if (tile >= 0)
      sweep_chunk<S, C>(words, chunks + (i % kStages) * chunk_words, g,
                        min(C, st.k - i * C), rule, dom, sdirs);
    __syncwarp();  // the buffer of chunk i is free for chunk i + 2
  }
  __syncwarp();
  store_group<T, S>(out, words, g, tile, r0, c0);
}

// Dynamic shared memory of a block: the chunk buffers and the staging.
template <int C>
__host__ inline size_t block_smem(const Geometry& g) {
  return ((size_t)kStages * Chunk<C>::words(g.P) +
          (size_t)g.th * g.G * g.P) *
         sizeof(uint32_t);
}

template <typename T, typename S, int C, bool VEC>
int launch(const StreamRuns& runs, int n_runs, int n, const Geometry& g,
           int k, int sr, int sc, const Rule& rule, const float* dom,
           const int* dirs, cudaStream_t stream) {
  const size_t smem = block_smem<C>(g);
  cudaError_t err =
      allow_smem((const void*)tile_round_kernel<T, S, C, VEC>, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_groups = (g.n_tiles + g.P - 1) / g.P;
  tile_round_kernel<T, S, C, VEC>
      <<<dim3(n_groups, n_runs * n), kWarp, smem, stream>>>(
          runs, n, g, k, sr, sc, rule, dom, dirs);
  return (int)cudaGetLastError();
}

}  // namespace escg

extern "C" {

// cell_bytes selects the lattice type (1 = int8, 2 = int16, 4 = int32) and
// stage_bytes the type its cells are staged in (1, or cell_bytes);
// tiles_per_block is how many tiles a block stages (1..32). Returns a
// cudaError_t (0 = launched).
//
// K3 over n_runs (1 .. 32) runs of n lattices each, n_runs * n <= 65535:
// run r reads its n stacked sources of SH x SW cells from ins[r], writes its
// n stacked H x W lattices to outs[r] and plays the (n, T, K) proposal
// fields fields[4r .. 4r + 3] (cell, dirn, u_act, u_dom; host arrays of
// pointers on the card). SH is H, or H + th with a halo of th rows from the
// block below (then every shift's row is below th); SW the same for
// columns. With `shifts` null (one lattice: n_runs = n = 1) the lattice is
// read rolled by (-shift0, -shift1); else trial t of run r by its row of
// shifts[r], (n, 2) int64 on the card.
int escg_tile_round(int cell_bytes, int stage_bytes, int tiles_per_block,
                    int n_runs, void* const* outs, const void* const* ins,
                    const void* const* fields, const int64_t* const* shifts,
                    int n, int H, int W, int SH, int SW, int th, int tw,
                    int k, const float* dom, int n_dom, const int* dirs,
                    float t_eps, float t_eps_mu, int shift0, int shift1,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_runs < 1 || n_runs > escg::kMaxRuns || n < 1 ||
      (int64_t)n_runs * n > 65535 || (shifts == nullptr && n_runs * n > 1) ||
      (SH != H && SH != H + th) || (SW != W && SW != W + tw))
    return (int)cudaErrorInvalidValue;
  escg::StreamRuns runs{};
  // 16-byte copies where every run of 4 proposal words is 16-byte aligned
  // (a trial's slice starts T * K words on, a multiple of 4 when K is)
  uintptr_t align = 0;
  for (int r = 0; r < n_runs; ++r) {
    runs.in[r] = ins[r];
    runs.out[r] = outs[r];
    runs.shifts[r] = shifts == nullptr ? nullptr : shifts[r];
    for (int f = 0; f < escg::kFields; ++f) {
      runs.field[r][f] = (const uint32_t*)fields[escg::kFields * r + f];
      align |= (uintptr_t)runs.field[r][f];
    }
  }
  const bool vec = k % 4 == 0 && align % 16 == 0;
  const escg::Geometry g = escg::make_geometry(H, W, th, tw, stage_bytes,
                                               tiles_per_block, SH, SW);
  const escg::Rule rule{t_eps, t_eps_mu, 0, n_dom};
  const int sr = ((shift0 % H) + H) % H;
  const int sc = ((shift1 % W) + W) % W;
  cudaStream_t s = (cudaStream_t)stream;
  constexpr int C = escg::kChunk;
  if (vec) {
    ESCG_DISPATCH(cell_bytes, stage_bytes,
                  (escg::launch<T, S, C, true>(runs, n_runs, n, g, k, sr, sc,
                                               rule, dom, dirs, s)));
  } else {
    ESCG_DISPATCH(cell_bytes, stage_bytes,
                  (escg::launch<T, S, C, false>(runs, n_runs, n, g, k, sr,
                                                sc, rule, dom, dirs, s)));
  }
  return (int)cudaErrorInvalidValue;
}

const char* escg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
