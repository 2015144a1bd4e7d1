// Stream-fed sublattice round for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/escg_update.py:
//   K3 tile_round_kernel  <- escg_tile_round (_kernel), over one lattice or a
//      batch of trials (blockIdx.y the trial, one launch for all)
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
// the rolled frame.
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

// K3: one round, one block per group of P tiles, read from `in` rolled by
// (-sr, -sc) and written to `out` in the rolled frame. Over a batch of
// trials blockIdx.y is the trial t: its lattice is the t-th H x W slice of
// `in` and `out`, its proposals the t-th (T, K) slice of each field, and
// its shift shifts[t] ((n, 2) int64 on the card; null for one lattice,
// which takes sr and sc). Shared memory holds the two chunk buffers, then
// the staged tiles.
template <typename T, typename S, int C, bool VEC>
__global__ void __launch_bounds__(kWarp)
    tile_round_kernel(const T* in, T* out, Geometry g, Stream st, int sr,
                      int sc, const int64_t* shifts, Rule rule,
                      const float* dom, const int* dirs) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int sdirs[16];
  const int trial = blockIdx.y;
  if (shifts != nullptr) {
    const int64_t dy = shifts[2 * trial], dx = shifts[2 * trial + 1];
    sr = (int)(((dy % g.H) + g.H) % g.H);
    sc = (int)(((dx % g.W) + g.W) % g.W);
  }
  const size_t cells = (size_t)g.H * g.W;
  in += trial * cells;
  out += trial * cells;
#pragma unroll
  for (int f = 0; f < kFields; ++f)
    st.field[f] += (size_t)trial * g.n_tiles * st.k;
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
int launch(void* out, const void* in, int n_trials, const Geometry& g,
           const Stream& st, int sr, int sc, const int64_t* shifts,
           const Rule& rule, const float* dom, const int* dirs,
           cudaStream_t stream) {
  const size_t smem = block_smem<C>(g);
  cudaError_t err =
      allow_smem((const void*)tile_round_kernel<T, S, C, VEC>, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_groups = (g.n_tiles + g.P - 1) / g.P;
  tile_round_kernel<T, S, C, VEC>
      <<<dim3(n_groups, n_trials), kWarp, smem, stream>>>(
          (const T*)in, (T*)out, g, st, sr, sc, shifts, rule, dom, dirs);
  return (int)cudaGetLastError();
}

// One K3 launch over n_trials lattices; shifts null for one lattice, which
// takes (shift0, shift1).
int round_launch(int cell_bytes, int stage_bytes, int tiles_per_block,
                 void* out, const void* in, int n_trials, int H, int W,
                 int th, int tw, int k, const int* cell, const int* dirn,
                 const float* u_act, const float* u_dom, const float* dom,
                 int n_dom, const int* dirs, float t_eps, float t_eps_mu,
                 int shift0, int shift1, const int64_t* shifts, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_trials < 1 || n_trials > 65535) return (int)cudaErrorInvalidValue;
  const Geometry g = make_geometry(H, W, th, tw, stage_bytes, tiles_per_block);
  const Stream st{{(const uint32_t*)cell, (const uint32_t*)dirn,
                   (const uint32_t*)u_act, (const uint32_t*)u_dom},
                  k};
  const Rule rule{t_eps, t_eps_mu, 0, n_dom};
  const int sr = ((shift0 % H) + H) % H;
  const int sc = ((shift1 % W) + W) % W;
  // 16-byte copies where every run of 4 proposal words is 16-byte aligned
  // (a trial's slice starts T * K words on, a multiple of 4 when K is)
  const bool vec = k % 4 == 0 &&
                   ((uintptr_t)cell | (uintptr_t)dirn | (uintptr_t)u_act |
                    (uintptr_t)u_dom) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  constexpr int C = kChunk;
  if (vec) {
    ESCG_DISPATCH(cell_bytes, stage_bytes,
                  (launch<T, S, C, true>(out, in, n_trials, g, st, sr, sc,
                                         shifts, rule, dom, dirs, s)));
  } else {
    ESCG_DISPATCH(cell_bytes, stage_bytes,
                  (launch<T, S, C, false>(out, in, n_trials, g, st, sr, sc,
                                          shifts, rule, dom, dirs, s)));
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace escg

extern "C" {

// cell_bytes selects the lattice type (1 = int8, 2 = int16, 4 = int32) and
// stage_bytes the type its cells are staged in (1, or cell_bytes);
// tiles_per_block is how many tiles a block stages (1..32). The lattice is
// read rolled by (-shift0, -shift1). Returns a cudaError_t (0 = launched).
int escg_tile_round(int cell_bytes, int stage_bytes, int tiles_per_block,
                    void* out, const void* in, int H, int W, int th, int tw,
                    int k, const int* cell, const int* dirn,
                    const float* u_act, const float* u_dom, const float* dom,
                    int n_dom, const int* dirs, float t_eps, float t_eps_mu,
                    int shift0, int shift1, int device, void* stream) {
  return escg::round_launch(cell_bytes, stage_bytes, tiles_per_block, out,
                            in, 1, H, W, th, tw, k, cell, dirn, u_act, u_dom,
                            dom, n_dom, dirs, t_eps, t_eps_mu, shift0, shift1,
                            nullptr, device, stream);
}

// K3 over n_trials lattices stacked in `in` and `out`, with (n_trials, T, K)
// proposal fields and the (n_trials, 2) int64 shifts on the card.
int escg_tile_round_trials(int cell_bytes, int stage_bytes,
                           int tiles_per_block, void* out, const void* in,
                           int n_trials, int H, int W, int th, int tw, int k,
                           const int* cell, const int* dirn,
                           const float* u_act, const float* u_dom,
                           const float* dom, int n_dom, const int* dirs,
                           float t_eps, float t_eps_mu, const int64_t* shifts,
                           int device, void* stream) {
  return escg::round_launch(cell_bytes, stage_bytes, tiles_per_block, out,
                            in, n_trials, H, W, th, tw, k, cell, dirn, u_act,
                            u_dom, dom, n_dom, dirs, t_eps, t_eps_mu, 0, 0,
                            shifts, device, stream);
}

const char* escg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
