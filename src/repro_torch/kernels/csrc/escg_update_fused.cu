// Fused-Philox sublattice kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/escg_update_fused.py:
//   K1 tile_round_kernel   <- escg_tile_round_fused  (_kernel, _apply_proposal)
//   K2 tile_rounds_kernel  <- escg_tile_rounds_fused (_mega_kernel)
//
// What they compute. The lattice (already rolled by the caller for K1) is cut
// into (th, tw) tiles. Tile (i, j) has the global id
// (off0 + i) * gw + (off1 + j); its proposal j comes from Philox-4x32-10 with
// counter (tile_id * K + j, round, 0, 0) and key (seed0, seed1):
// cell = x0 % interior, dirn = x1 % nbhd, u = (x >> 8) * 2^-24. The tile
// applies its K proposals in order to its interior with the pair rule of
// src/repro/core/rules.py, thresholds and p1 + p2 in float32. K2 runs K
// Monte-Carlo steps in one launch: each step rolls the torus by -shifts[t],
// sweeps every tile with seeds[t] at round 0 and counts the species into
// counts[t]; the grid stays in the drifted frame.
//
// What bounds them on this card. Every proposal costs some 80 integer and
// float instructions (Philox alone is 10 rounds of two 32x32->64 multiplies
// and two three-way xors) against 4 one-cell loads and stores, so the sweep
// is bound by the instructions it executes, not by the 2 x H x W bytes it
// must move.
// The proposals of one tile depend on each other through the cells they
// touch, so a tile is one thread's sequential loop; the parallelism is the
// tile count (40,000 at 3200 x 3200 with 8 x 32 tiles).
//
// What the design does about it. One thread per tile, Philox inlined with
// __umulhi for the high word and a plain multiply for the low word, the
// round keys and the tile's counter base kept in registers, no proposal
// ever written to memory. The tile lives in device memory and is reached
// through L1/L2; keeping it in registers or shared memory is later work.
// K2 cannot end a step with a kernel boundary, so it is a cooperative
// launch sized from the occupancy calculator: the grid strides over cells
// for the roll (into a ping-pong buffer) and the count, over tiles for the
// sweep, with a grid-wide barrier between the phases. The count bins per
// block in shared memory and adds them to counts[t] with integer atomics,
// exact in any order.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace escg {

struct Rule {
  float t_eps;     // migration below this action draw
  float t_eps_mu;  // interaction below this one, reproduction above
  int nbhd;        // 4 (von Neumann) or 8 (Moore)
  int n_dom;       // species + 1: side of the padded dominance matrix
};

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The K proposals of one tile, in order, on the lattice g of row length W.
// (r0, c0) is the tile's top-left cell.
template <typename T>
__device__ void sweep_tile(T* g, int W, int r0, int c0, int th, int tw,
                           uint32_t tile_id, int k, uint32_t round,
                           uint32_t seed0, uint32_t seed1,
                           const float* __restrict__ dom,
                           const int* __restrict__ dirs, Rule rule) {
  const int iw = tw - 2;
  const uint32_t interior = (uint32_t)((th - 2) * iw);
  const uint32_t base = tile_id * (uint32_t)k;
  for (int j = 0; j < k; ++j) {
    const uint4 x = philox4x32_10(base + (uint32_t)j, round, 0u, 0u, seed0,
                                  seed1);
    const int cell = (int)(x.x % interior);
    const int dirn = (int)(x.y % (uint32_t)rule.nbhd);
    const float ua = (float)(x.z >> 8) * 0x1p-24f;
    const float ud = (float)(x.w >> 8) * 0x1p-24f;
    const int r = r0 + 1 + cell / iw;
    const int c = c0 + 1 + cell % iw;
    const int nr = r + dirs[2 * dirn];
    const int nc = c + dirs[2 * dirn + 1];
    T* ps = g + (size_t)r * W + c;
    T* pn = g + (size_t)nr * W + nc;
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

// K1: one round over an already rolled lattice, one thread per tile; each
// thread first copies its tile from `in` to `out`, then sweeps it in `out`.
template <typename T>
__global__ void tile_round_kernel(const T* __restrict__ in, T* out, int H,
                                  int W, int th, int tw, int k, uint32_t gw,
                                  uint32_t off0, uint32_t off1,
                                  uint32_t seed0, uint32_t seed1,
                                  uint32_t round,
                                  const float* __restrict__ dom,
                                  const int* __restrict__ dirs, Rule rule) {
  const int lgw = W / tw;
  const int n_tiles = (H / th) * lgw;
  const int tile = blockIdx.x * blockDim.x + threadIdx.x;
  if (tile >= n_tiles) return;
  const int ti = tile / lgw;
  const int tj = tile % lgw;
  const int r0 = ti * th;
  const int c0 = tj * tw;
  for (int r = r0; r < r0 + th; ++r)
    for (int c = c0; c < c0 + tw; ++c)
      out[(size_t)r * W + c] = in[(size_t)r * W + c];
  const uint32_t tile_id = (off0 + (uint32_t)ti) * gw + (off1 + (uint32_t)tj);
  sweep_tile(out, W, r0, c0, th, tw, tile_id, k, round, seed0, seed1, dom,
             dirs, rule);
}

// K2: n_steps Monte-Carlo steps in one cooperative launch. Step t reads the
// previous step's lattice (`in` for t = 0), writes its rolled copy into the
// ping-pong buffer that makes the last step land in `out`, sweeps it and
// counts it into counts[t].
template <typename T>
__global__ void tile_rounds_kernel(const T* in, T* out,
                                   T* scratch, int H, int W, int th, int tw,
                                   int k, uint32_t gw, uint32_t off0,
                                   uint32_t off1, const int64_t* seeds,
                                   const int64_t* shifts, int n_steps,
                                   const float* __restrict__ dom,
                                   const int* __restrict__ dirs, Rule rule,
                                   int* counts) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int bins[];
  const int64_t n_cells = (int64_t)H * W;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int lgw = W / tw;
  const int n_tiles = (H / th) * lgw;
  const int n_counts = rule.n_dom;

  for (int64_t i = tid; i < (int64_t)n_steps * n_counts; i += stride)
    counts[i] = 0;

  const T* src = in;
  for (int t = 0; t < n_steps; ++t) {
    T* dst = ((n_steps - 1 - t) % 2 == 0) ? out : scratch;
    const int sr = (int)(((shifts[2 * t] % H) + H) % H);
    const int sc = (int)(((shifts[2 * t + 1] % W) + W) % W);
    for (int64_t i = tid; i < n_cells; i += stride) {
      const int r = (int)(i / W);
      const int c = (int)(i % W);
      const int rr = (r + sr) < H ? r + sr : r + sr - H;
      const int cc = (c + sc) < W ? c + sc : c + sc - W;
      dst[i] = src[(size_t)rr * W + cc];
    }
    grid.sync();

    const uint32_t seed0 = (uint32_t)seeds[2 * t];
    const uint32_t seed1 = (uint32_t)seeds[2 * t + 1];
    for (int64_t tile = tid; tile < n_tiles; tile += stride) {
      const int ti = (int)(tile / lgw);
      const int tj = (int)(tile % lgw);
      const uint32_t tile_id =
          (off0 + (uint32_t)ti) * gw + (off1 + (uint32_t)tj);
      sweep_tile(dst, W, ti * th, tj * tw, th, tw, tile_id, k, 0u, seed0,
                 seed1, dom, dirs, rule);
    }
    grid.sync();

    for (int b = threadIdx.x; b < n_counts; b += blockDim.x) bins[b] = 0;
    __syncthreads();
    for (int64_t i = tid; i < n_cells; i += stride) {
      const int v = (int)dst[i];
      if (v >= 0 && v < n_counts) atomicAdd(&bins[v], 1);
    }
    __syncthreads();
    for (int b = threadIdx.x; b < n_counts; b += blockDim.x)
      if (bins[b]) atomicAdd(&counts[t * n_counts + b], bins[b]);
    __syncthreads();
    src = dst;
  }
}

constexpr int kRoundThreads = 128;
constexpr int kRoundsThreads = 256;

template <typename T>
int launch_round(void* out, const void* in, int H, int W, int th, int tw,
                 int k, uint32_t gw, uint32_t off0, uint32_t off1,
                 uint32_t seed0, uint32_t seed1, uint32_t round,
                 const float* dom, const int* dirs, Rule rule,
                 cudaStream_t stream) {
  const int n_tiles = (H / th) * (W / tw);
  const int blocks = (n_tiles + kRoundThreads - 1) / kRoundThreads;
  tile_round_kernel<T><<<blocks, kRoundThreads, 0, stream>>>(
      (const T*)in, (T*)out, H, W, th, tw, k, gw, off0, off1, seed0, seed1,
      round, dom, dirs, rule);
  return (int)cudaGetLastError();
}

// The largest grid of kRoundsThreads-thread blocks that can be resident at
// once, which a cooperative launch may not exceed; 0 if none fits.
template <typename T>
int cooperative_blocks(int n_counts, int device) {
  int per_sm = 0, sms = 0;
  const size_t smem = (size_t)n_counts * sizeof(int);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, tile_rounds_kernel<T>, kRoundsThreads, smem) != cudaSuccess)
    return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 0;
  return per_sm * sms;
}

template <typename T>
int launch_rounds(void* out, void* scratch, const void* in, int H, int W,
                  int th, int tw, int k, uint32_t gw, uint32_t off0,
                  uint32_t off1, const int64_t* seeds, const int64_t* shifts,
                  int n_steps, const float* dom, const int* dirs, Rule rule,
                  int* counts, int device, cudaStream_t stream) {
  int coop = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int max_blocks = cooperative_blocks<T>(rule.n_dom, device);
  if (max_blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int64_t work = (int64_t)H * W;
  int64_t want = (work + kRoundsThreads - 1) / kRoundsThreads;
  const int blocks = (int)(want < max_blocks ? want : max_blocks);
  const T* in_t = (const T*)in;
  T* out_t = (T*)out;
  T* scratch_t = (T*)scratch;
  void* args[] = {&in_t, &out_t, &scratch_t, &H,      &W,     &th,
                  &tw,   &k,     &gw,        &off0,   &off1,  &seeds,
                  &shifts, &n_steps, &dom,   &dirs,   &rule,  &counts};
  err = cudaLaunchCooperativeKernel((const void*)tile_rounds_kernel<T>,
                                    dim3(blocks), dim3(kRoundsThreads), args,
                                    (size_t)rule.n_dom * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace escg

extern "C" {

// cell_bytes selects the lattice type: 1 = int8, 2 = int16, 4 = int32.
// Every entry point returns a cudaError_t (0 = launched).
int escg_tile_round_fused(int cell_bytes, void* out, const void* in, int H,
                          int W, int th, int tw, int k, uint32_t gw,
                          uint32_t off0, uint32_t off1, uint32_t seed0,
                          uint32_t seed1, uint32_t round, const float* dom,
                          int n_dom, const int* dirs, int nbhd, float t_eps,
                          float t_eps_mu, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const escg::Rule rule{t_eps, t_eps_mu, nbhd, n_dom};
  cudaStream_t s = (cudaStream_t)stream;
  switch (cell_bytes) {
    case 1:
      return escg::launch_round<int8_t>(out, in, H, W, th, tw, k, gw, off0,
                                        off1, seed0, seed1, round, dom, dirs,
                                        rule, s);
    case 2:
      return escg::launch_round<int16_t>(out, in, H, W, th, tw, k, gw, off0,
                                         off1, seed0, seed1, round, dom, dirs,
                                         rule, s);
    case 4:
      return escg::launch_round<int32_t>(out, in, H, W, th, tw, k, gw, off0,
                                         off1, seed0, seed1, round, dom, dirs,
                                         rule, s);
  }
  return (int)cudaErrorInvalidValue;
}

int escg_tile_rounds_fused(int cell_bytes, void* out, void* scratch,
                           const void* in, int H, int W, int th, int tw,
                           int k, uint32_t gw, uint32_t off0, uint32_t off1,
                           const int64_t* seeds, const int64_t* shifts,
                           int n_steps, const float* dom, int n_dom,
                           const int* dirs, int nbhd, float t_eps,
                           float t_eps_mu, int* counts, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const escg::Rule rule{t_eps, t_eps_mu, nbhd, n_dom};
  cudaStream_t s = (cudaStream_t)stream;
  switch (cell_bytes) {
    case 1:
      return escg::launch_rounds<int8_t>(out, scratch, in, H, W, th, tw, k,
                                         gw, off0, off1, seeds, shifts,
                                         n_steps, dom, dirs, rule, counts,
                                         device, s);
    case 2:
      return escg::launch_rounds<int16_t>(out, scratch, in, H, W, th, tw, k,
                                          gw, off0, off1, seeds, shifts,
                                          n_steps, dom, dirs, rule, counts,
                                          device, s);
    case 4:
      return escg::launch_rounds<int32_t>(out, scratch, in, H, W, th, tw, k,
                                          gw, off0, off1, seeds, shifts,
                                          n_steps, dom, dirs, rule, counts,
                                          device, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The most blocks a K2 launch may use on `device`, 0 if the cooperative
// launch cannot be made.
int escg_tile_rounds_fused_blocks(int cell_bytes, int n_dom, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return 0;
  switch (cell_bytes) {
    case 1: return escg::cooperative_blocks<int8_t>(n_dom, device);
    case 2: return escg::cooperative_blocks<int16_t>(n_dom, device);
    case 4: return escg::cooperative_blocks<int32_t>(n_dom, device);
  }
  return 0;
}

const char* escg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
