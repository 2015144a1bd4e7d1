// Stream-fed sublattice round for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/escg_update.py:
//   K3 tile_round_kernel  <- escg_tile_round (_kernel)
//
// What it computes. The lattice, already rolled by the caller, is cut into
// (th, tw) tiles in raster order. Tile t applies its K proposals in order:
// proposal j is (cell[t*K + j], dirn[...], u_act[...], u_dom[...]), read from
// the (T, K) buffers that the threefry streams of core/rng.py filled. The cell
// is an index into the tile's interior: row 1 + cell / (tw - 2), column
// 1 + cell % (tw - 2); the neighbour is that cell plus dirs[dirn]. The pair
// rule is the one of src/repro/core/rules.py (and of K1): thresholds and the
// dominance rates are float32, p1 + p2 is a float32 sum, and a pair of equal
// labels is left as it is. This is core/sublattice.py::tile_update per tile.
//
// What bounds it on this card. Per proposal the thread reads 4 proposal
// words and 2 cells and writes 2 cells; the proposals (4 x 4 bytes for each
// of H x W updates) are the largest traffic, twice the int32 lattice's read
// and write. The loop is sequential within a tile (the proposals touch
// overlapping cells), so the parallelism is the tile count (40,000 at
// 3200 x 3200 with 8 x 32 tiles), and each step waits on dependent loads.
//
// What the design does about it. One thread per tile, as K1 in
// escg_update_fused.cu: the thread copies its tile from `in` to `out` and
// sweeps it in `out`, so no tile ever touches another's cells. Thread t reads
// proposal j of its own row; neighbouring threads read words K apart, which
// do not coalesce. Transposing the buffers to (K, T), or staging a tile's
// proposals through shared memory, is later work. The pair rule is copied
// from K1 rather than shared through a header, so that K1 and K2's source,
// and the binaries verified from it, do not change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace escg3 {

struct Rule {
  float t_eps;     // migration below this action draw
  float t_eps_mu;  // interaction below this one, reproduction above
  int n_dom;       // species + 1: side of the padded dominance matrix
};

template <typename T>
__global__ void tile_round_kernel(const T* __restrict__ in, T* out, int H,
                                  int W, int th, int tw, int k,
                                  const int* __restrict__ cell,
                                  const int* __restrict__ dirn,
                                  const float* __restrict__ u_act,
                                  const float* __restrict__ u_dom,
                                  const float* __restrict__ dom,
                                  const int* __restrict__ dirs, Rule rule) {
  const int lgw = W / tw;
  const int n_tiles = (H / th) * lgw;
  const int tile = blockIdx.x * blockDim.x + threadIdx.x;
  if (tile >= n_tiles) return;
  const int r0 = (tile / lgw) * th;
  const int c0 = (tile % lgw) * tw;
  for (int r = r0; r < r0 + th; ++r)
    for (int c = c0; c < c0 + tw; ++c)
      out[(size_t)r * W + c] = in[(size_t)r * W + c];
  const int iw = tw - 2;
  const size_t base = (size_t)tile * k;
  for (int j = 0; j < k; ++j) {
    const int cj = cell[base + j];
    const int dj = dirn[base + j];
    const float ua = u_act[base + j];
    const float ud = u_dom[base + j];
    const int r = r0 + 1 + cj / iw;
    const int c = c0 + 1 + cj % iw;
    const int nr = r + dirs[2 * dj];
    const int nc = c + dirs[2 * dj + 1];
    T* ps = out + (size_t)r * W + c;
    T* pn = out + (size_t)nr * W + nc;
    const int s = (int)*ps;
    const int n = (int)*pn;
    if (s == n) continue;  // same species: the pair is left as it is
    const bool migrate = ua < rule.t_eps;
    const bool interact = (ua >= rule.t_eps) && (ua < rule.t_eps_mu);
    const bool reproduce = ua >= rule.t_eps_mu;
    const float p1 = dom[s * rule.n_dom + n];
    const float p2 = dom[n * rule.n_dom + s];
    const bool kill_n = interact && (ud < p1);
    const bool kill_s = interact && !kill_n && (ud < p1 + p2);
    const bool rep_to_n = reproduce && (n == 0);
    const bool rep_to_s = reproduce && (s == 0);
    const int new_s = migrate ? n : (kill_s ? 0 : (rep_to_s ? n : s));
    const int new_n = migrate ? s : (kill_n ? 0 : (rep_to_n ? s : n));
    *ps = (T)new_s;
    *pn = (T)new_n;
  }
}

constexpr int kThreads = 128;

template <typename T>
int launch(void* out, const void* in, int H, int W, int th, int tw, int k,
           const int* cell, const int* dirn, const float* u_act,
           const float* u_dom, const float* dom, const int* dirs, Rule rule,
           cudaStream_t stream) {
  const int n_tiles = (H / th) * (W / tw);
  const int blocks = (n_tiles + kThreads - 1) / kThreads;
  tile_round_kernel<T><<<blocks, kThreads, 0, stream>>>(
      (const T*)in, (T*)out, H, W, th, tw, k, cell, dirn, u_act, u_dom, dom,
      dirs, rule);
  return (int)cudaGetLastError();
}

}  // namespace escg3

extern "C" {

// cell_bytes selects the lattice type: 1 = int8, 2 = int16, 4 = int32.
// Returns a cudaError_t (0 = launched).
int escg_tile_round(int cell_bytes, void* out, const void* in, int H, int W,
                    int th, int tw, int k, const int* cell, const int* dirn,
                    const float* u_act, const float* u_dom, const float* dom,
                    int n_dom, const int* dirs, float t_eps, float t_eps_mu,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const escg3::Rule rule{t_eps, t_eps_mu, n_dom};
  cudaStream_t s = (cudaStream_t)stream;
  switch (cell_bytes) {
    case 1:
      return escg3::launch<int8_t>(out, in, H, W, th, tw, k, cell, dirn,
                                   u_act, u_dom, dom, dirs, rule, s);
    case 2:
      return escg3::launch<int16_t>(out, in, H, W, th, tw, k, cell, dirn,
                                    u_act, u_dom, dom, dirs, rule, s);
    case 4:
      return escg3::launch<int32_t>(out, in, H, W, th, tw, k, cell, dirn,
                                    u_act, u_dom, dom, dirs, rule, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* escg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
