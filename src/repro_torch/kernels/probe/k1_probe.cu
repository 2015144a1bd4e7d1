// Where K1's time goes on the card, and the designs tried for it.
//
// Build and run from the repository root, on a machine with the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v \
//       -o src/repro_torch/kernels/_build/k1_probe \
//       src/repro_torch/kernels/probe/k1_probe.cu
//   src/repro_torch/kernels/_build/k1_probe
//
// On park3's main-path shapes (3200 x 3200, tile (8, 32), 256 proposals per
// tile, park3's thresholds and dominance, a random lattice with 10 % empty
// cells) it times, by CUDA events over 20 launches after a warm-up launch:
//
// * the previous design (one thread per tile, copy then sweep in device
//   memory), in int32 and int8, with two variants that isolate its parts:
//   the copy alone (no sweep), and the sweep with fixed proposals (a cheap
//   hash in place of the Philox rounds);
// * a warp per tile: the 32 lanes draw the tile's proposals in parallel
//   into shared memory, then one lane applies them in order to the tile
//   staged in shared memory;
// * the kernel of csrc/escg_update_fused.cu (a lane per tile, 32 tiles
//   staged per warp), staged in int8 and in the lattice's own type, with no
//   proposals (its load and store alone), and with a torus shift; and its
//   Philox rounds alone (every lane draws its tile's proposals as the
//   sweep does, one warp a block);
// * K2 of the same source at K = 10.
//
// Every variant that computes K1's function is held to the previous design
// (cells that differ), K2 to ten shifted K1 rounds and a host count. The
// last line is the card's name and power limit.
#include "../csrc/escg_update_fused.cu"

#include <cstdio>
#include <cstdlib>
#include <random>
#include <type_traits>
#include <vector>

namespace probe {

using escg::Geometry;
using escg::Rule;
using escg::Sweep;

constexpr int H = 3200, W = 3200, TH = 8, TW = 32, K = 256, STEPS = 10;
constexpr int REPS = 20;

#define CHECK(x)                                                      \
  do {                                                                \
    cudaError_t e_ = (x);                                             \
    if (e_ != cudaSuccess) {                                          \
      std::fprintf(stderr, "%s:%d %s\n", __FILE__, __LINE__,          \
                   cudaGetErrorString(e_));                           \
      std::exit(1);                                                   \
    }                                                                 \
  } while (0)

__device__ __forceinline__ uint4 philox_old(uint32_t c0, uint32_t c1,
                                            uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0u, c3 = 0u;
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

// The pair rule: the new labels of the pair (s, n).
__device__ __forceinline__ void apply(int s, int n, float ua, float ud,
                                      const float* dom, Rule rule,
                                      int* new_s, int* new_n) {
  const bool migrate = ua < rule.t_eps;
  const bool interact = (ua >= rule.t_eps) && (ua < rule.t_eps_mu);
  const bool reproduce = ua >= rule.t_eps_mu;
  const float p1 = dom[s * rule.n_dom + n];
  const float p2 = dom[n * rule.n_dom + s];
  const bool kill_n = interact && (ud < p1);
  const bool kill_s = interact && !kill_n && (ud < p1 + p2);
  const bool rep_to_n = reproduce && (n == 0);
  const bool rep_to_s = reproduce && (s == 0);
  *new_s = migrate ? n : (kill_s ? 0 : (rep_to_s ? n : s));
  *new_n = migrate ? s : (kill_n ? 0 : (rep_to_n ? s : n));
}

// The previous K1: one thread per tile copies its tile cell by cell, then
// sweeps it in device memory. MODE 0 as it was; 1 the copy alone; 2 fixed
// proposals (a multiply-xor hash of the counter) in place of Philox.
template <typename T, int MODE>
__global__ void old_k1(const T* in, T* out, int th, int tw, int k,
                       uint32_t seed0, uint32_t seed1, const float* dom,
                       const int* dirs, Rule rule) {
  const int lgw = W / tw;
  const int tile = blockIdx.x * blockDim.x + threadIdx.x;
  if (tile >= (H / th) * lgw) return;
  const int r0 = tile / lgw * th, c0 = tile % lgw * tw;
  for (int r = r0; r < r0 + th; ++r)
    for (int c = c0; c < c0 + tw; ++c)
      out[(size_t)r * W + c] = in[(size_t)r * W + c];
  if (MODE == 1) return;
  const int iw = tw - 2;
  const uint32_t interior = (uint32_t)((th - 2) * iw);
  const uint32_t base = (uint32_t)tile * (uint32_t)k;
  for (int j = 0; j < k; ++j) {
    uint4 x;
    if (MODE == 0) {
      x = philox_old(base + (uint32_t)j, 0u, seed0, seed1);
    } else {
      const uint32_t h = (base + (uint32_t)j) * 0x9E3779B1u ^ seed0;
      x = make_uint4(h, h >> 7, h * 0x85EBCA6Bu, h * 0xC2B2AE35u);
    }
    const int cell = (int)(x.x % interior);
    const int dirn = (int)(x.y % (uint32_t)rule.nbhd);
    const float ua = (float)(x.z >> 8) * 0x1p-24f;
    const float ud = (float)(x.w >> 8) * 0x1p-24f;
    const int r = r0 + 1 + cell / iw, c = c0 + 1 + cell % iw;
    T* ps = out + (size_t)r * W + c;
    T* pn = out + (size_t)(r + dirs[2 * dirn]) * W + c + dirs[2 * dirn + 1];
    const int s = (int)*ps, n = (int)*pn;
    if (s == n) continue;
    int ns, nn;
    apply(s, n, ua, ud, dom, rule, &ns, &nn);
    *ps = (T)ns;
    *pn = (T)nn;
  }
}

// A warp per tile: the lanes draw a chunk of the tile's proposals into
// shared memory, then lane 0 applies them in order to the staged tile.
constexpr int kChunk = 256, kWarpsPerBlock = 4;
struct Prop {
  int at_s, at_n;
  float ua, ud;
};

template <typename T>
__global__ void warp_tile_k1(const T* in, T* out, int th, int tw, int k,
                             uint32_t seed0, uint32_t seed1,
                             const float* dom, const int* dirs, Rule rule) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cells = th * tw;
  const int words = (cells * (int)sizeof(T) + 3) / 4 + kChunk * 4;
  T* tile_cells = reinterpret_cast<T*>(smem + warp * words);
  Prop* props = reinterpret_cast<Prop*>(smem + warp * words + words -
                                        kChunk * 4);
  const int lgw = W / tw;
  const int tile = blockIdx.x * kWarpsPerBlock + warp;
  if (tile >= (H / th) * lgw) return;
  const int r0 = tile / lgw * th, c0 = tile % lgw * tw;
  for (int i = lane; i < cells; i += 32)
    tile_cells[i] = in[(size_t)(r0 + i / tw) * W + c0 + i % tw];
  const int iw = tw - 2;
  const uint32_t interior = (uint32_t)((th - 2) * iw);
  const uint32_t base = (uint32_t)tile * (uint32_t)k;
  for (int j0 = 0; j0 < k; j0 += kChunk) {
    const int n = k - j0 < kChunk ? k - j0 : kChunk;
    for (int jj = lane; jj < n; jj += 32) {
      const uint4 x = philox_old(base + (uint32_t)(j0 + jj), 0u, seed0,
                                 seed1);
      const int cell = (int)(x.x % interior);
      const int dirn = (int)(x.y % (uint32_t)rule.nbhd);
      const int r = 1 + cell / iw, c = 1 + cell % iw;
      props[jj] = Prop{r * tw + c,
                       (r + dirs[2 * dirn]) * tw + c + dirs[2 * dirn + 1],
                       (float)(x.z >> 8) * 0x1p-24f,
                       (float)(x.w >> 8) * 0x1p-24f};
    }
    __syncwarp();
    if (lane == 0) {
      for (int jj = 0; jj < n; ++jj) {
        const Prop p = props[jj];
        const int s = (int)tile_cells[p.at_s], nb = (int)tile_cells[p.at_n];
        int ns, nn;
        apply(s, nb, p.ua, p.ud, dom, rule, &ns, &nn);
        tile_cells[p.at_s] = (T)(s == nb ? s : ns);
        tile_cells[p.at_n] = (T)(s == nb ? nb : nn);
      }
    }
    __syncwarp();
  }
  for (int i = lane; i < cells; i += 32)
    out[(size_t)(r0 + i / tw) * W + c0 + i % tw] = tile_cells[i];
}

// The kernel's Philox rounds alone: lane t of block b draws the K
// proposals of tile 32 b + t and folds them into one word.
__global__ void __launch_bounds__(32)
    philox_only(int n_tiles, int k, uint32_t s0, uint32_t s1,
                uint32_t* sink) {
  const int tile = blockIdx.x * 32 + threadIdx.x;
  if (tile >= n_tiles) return;
  const escg::PhiloxKeys keys = escg::round_keys(s0, s1);
  uint32_t acc = 0;
#pragma unroll 8
  for (int j = 0; j < k; ++j) {
    const uint4 x = escg::philox((uint32_t)(tile * k + j), 0u, keys);
    acc ^= x.x ^ x.y ^ x.z ^ x.w;
  }
  sink[tile] = acc;
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

template <typename T>
long differ(const T* a, const T* b) {
  std::vector<T> x((size_t)H * W), y((size_t)H * W);
  CHECK(cudaMemcpy(x.data(), a, x.size() * sizeof(T), cudaMemcpyDefault));
  CHECK(cudaMemcpy(y.data(), b, y.size() * sizeof(T), cudaMemcpyDefault));
  long n = 0;
  for (size_t i = 0; i < x.size(); ++i) n += x[i] != y[i];
  return n;
}

template <typename T>
int new_k1(T* out, const T* in, int stage_bytes, int k, int sr, int sc,
           uint32_t s0, uint32_t s1, const float* dom, const int* dirs,
           Rule rule) {
  void* outs[] = {out};
  const void* ins[] = {in};
  const uint32_t offsets[] = {0u, 0u};
  return escg_tile_round_fused((int)sizeof(T), stage_bytes, 32, 1, outs, ins,
                               nullptr, nullptr, offsets, 1, H, W, H, W, TH,
                               TW, k, W / TW, s0, s1, 0, sr, sc, dom,
                               rule.n_dom, dirs, rule.nbhd, rule.t_eps,
                               rule.t_eps_mu, 0, nullptr);
}

int run() {
  const Rule rule{0.99675536f, 0.9983777f, 4, 4};
  const float dom_h[16] = {0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1, 0, 0};
  const int dirs_h[16] = {-1, 0, 1, 0, 0, -1, 0, 1,
                          -1, -1, -1, 1, 1, -1, 1, 1};
  const uint32_t s0 = 0x9E3779B9u, s1 = 7u;
  std::mt19937 gen(0);
  std::vector<int32_t> g32((size_t)H * W);
  std::vector<int8_t> g8((size_t)H * W);
  for (size_t i = 0; i < g32.size(); ++i) {
    g32[i] = gen() % 10 == 0 ? 0 : 1 + (int)(gen() % 3);
    g8[i] = (int8_t)g32[i];
  }
  const size_t n = g32.size();
  int32_t *in32, *a32, *b32, *c32;
  int8_t *in8, *a8, *b8;
  float* dom;
  int *dirs, *counts;
  int64_t *seeds, *shifts;
  CHECK(cudaMalloc(&in32, n * 4));
  CHECK(cudaMalloc(&a32, n * 4));
  CHECK(cudaMalloc(&b32, n * 4));
  CHECK(cudaMalloc(&c32, n * 4));
  CHECK(cudaMalloc(&in8, n));
  CHECK(cudaMalloc(&a8, n));
  CHECK(cudaMalloc(&b8, n));
  CHECK(cudaMalloc(&dom, sizeof dom_h));
  CHECK(cudaMalloc(&dirs, sizeof dirs_h));
  CHECK(cudaMalloc(&counts, STEPS * 4 * sizeof(int)));
  CHECK(cudaMalloc(&seeds, STEPS * 2 * sizeof(int64_t)));
  CHECK(cudaMalloc(&shifts, STEPS * 2 * sizeof(int64_t)));
  CHECK(cudaMemcpy(in32, g32.data(), n * 4, cudaMemcpyDefault));
  CHECK(cudaMemcpy(in8, g8.data(), n, cudaMemcpyDefault));
  CHECK(cudaMemcpy(dom, dom_h, sizeof dom_h, cudaMemcpyDefault));
  CHECK(cudaMemcpy(dirs, dirs_h, sizeof dirs_h, cudaMemcpyDefault));
  std::vector<int64_t> seeds_h(2 * STEPS), shifts_h(2 * STEPS);
  for (int t = 0; t < STEPS; ++t) {
    seeds_h[2 * t] = gen();
    seeds_h[2 * t + 1] = gen();
    shifts_h[2 * t] = gen() % TH;
    shifts_h[2 * t + 1] = gen() % TW;
  }
  CHECK(cudaMemcpy(seeds, seeds_h.data(), 16 * STEPS, cudaMemcpyDefault));
  CHECK(cudaMemcpy(shifts, shifts_h.data(), 16 * STEPS, cudaMemcpyDefault));

  Timer timer;
  const int n_tiles = (H / TH) * (W / TW);
  const int old_blocks = (n_tiles + 127) / 128;
  auto old = [&](auto* out, const auto* in, auto mode) {
    using T = std::remove_cv_t<std::remove_pointer_t<decltype(in)>>;
    old_k1<T, decltype(mode)::value><<<old_blocks, 128>>>(
        in, out, TH, TW, K, s0, s1, dom, dirs, rule);
  };
  using M0 = std::integral_constant<int, 0>;
  using M1 = std::integral_constant<int, 1>;
  using M2 = std::integral_constant<int, 2>;

  std::printf("[probe] %d x %d, tile (%d, %d), K = %d, %d tiles\n", H, W, TH,
              TW, K, n_tiles);
  float t = timer.ms([&] { old(a32, in32, M0{}); });
  std::printf("[probe] previous K1 int32: %.4f ms\n", t);
  t = timer.ms([&] { old(a8, in8, M0{}); });
  std::printf("[probe] previous K1 int8: %.4f ms\n", t);
  t = timer.ms([&] { old(b32, in32, M1{}); });
  std::printf("[probe] previous K1 int32, copy alone (no sweep): %.4f ms\n",
              t);
  t = timer.ms([&] { old(b32, in32, M2{}); });
  std::printf("[probe] previous K1 int32, fixed proposals (no Philox): "
              "%.4f ms\n", t);

  const size_t warp_smem =
      (size_t)kWarpsPerBlock * 4 * ((TH * TW * 4 + 3) / 4 + kChunk * 4);
  CHECK(cudaFuncSetAttribute(warp_tile_k1<int32_t>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)warp_smem));
  t = timer.ms([&] {
    warp_tile_k1<int32_t><<<(n_tiles + kWarpsPerBlock - 1) / kWarpsPerBlock,
                            32 * kWarpsPerBlock, warp_smem>>>(
        in32, b32, TH, TW, K, s0, s1, dom, dirs, rule);
  });
  std::printf("[probe] warp per tile int32: %.4f ms, cells differing from "
              "the previous K1 %ld\n", t, differ(b32, a32));

  for (int stage : {1, 4}) {
    t = timer.ms([&] {
      CHECK((cudaError_t)new_k1(b32, in32, stage, K, 0, 0, s0, s1, dom,
                                dirs, rule));
    });
    std::printf("[probe] lane per tile int32 staged in %d byte(s): %.4f ms, "
                "cells differing from the previous K1 %ld\n", stage, t,
                differ(b32, a32));
  }
  t = timer.ms([&] {
    CHECK((cudaError_t)new_k1(b8, in8, 1, K, 0, 0, s0, s1, dom, dirs, rule));
  });
  std::printf("[probe] lane per tile int8: %.4f ms, cells differing from "
              "the previous K1 %ld\n", t, differ(b8, a8));
  t = timer.ms([&] {
    CHECK((cudaError_t)new_k1(b32, in32, 1, 0, 0, 0, s0, s1, dom, dirs,
                              rule));
  });
  std::printf("[probe] lane per tile int32, load and store alone (K = 0): "
              "%.4f ms, cells differing from the input %ld\n", t,
              differ(b32, in32));
  t = timer.ms([&] {
    CHECK((cudaError_t)new_k1(b32, in32, 1, K, 1, 1, s0, s1, dom, dirs,
                              rule));
  });
  std::printf("[probe] lane per tile int32 with shift (1, 1): %.4f ms\n", t);
  t = timer.ms([&] {
    philox_only<<<(n_tiles + 31) / 32, 32>>>(n_tiles, K, s0, s1,
                                             (uint32_t*)c32);
  });
  std::printf("[probe] lane per tile, its Philox rounds alone: %.4f ms\n",
              t);

  // K2 against ten shifted K1 rounds and a host count
  CHECK(cudaMemcpy(a32, in32, n * 4, cudaMemcpyDefault));
  std::vector<int> want(STEPS * 4, 0);
  std::vector<int32_t> host(n);
  for (int s = 0; s < STEPS; ++s) {
    CHECK((cudaError_t)new_k1(b32, a32, 1, K, (int)shifts_h[2 * s],
                              (int)shifts_h[2 * s + 1],
                              (uint32_t)seeds_h[2 * s],
                              (uint32_t)seeds_h[2 * s + 1], dom, dirs, rule));
    CHECK(cudaMemcpy(a32, b32, n * 4, cudaMemcpyDefault));
    CHECK(cudaMemcpy(host.data(), a32, n * 4, cudaMemcpyDefault));
    for (int32_t v : host) want[4 * s + v] += 1;
  }
  t = timer.ms([&] {
    CHECK((cudaError_t)escg_tile_rounds_fused(
        4, 1, 32, b32, c32, in32, 1, H, W, TH, TW, K, W / TW, 0, 0, seeds,
        shifts, STEPS, dom, 4, dirs, 4, rule.t_eps, rule.t_eps_mu, counts,
        0, nullptr));
  });
  std::vector<int> got(STEPS * 4);
  CHECK(cudaMemcpy(got.data(), counts, got.size() * 4, cudaMemcpyDefault));
  long bad_counts = 0;
  for (int i = 0; i < STEPS * 4; ++i) bad_counts += got[i] != want[i];
  std::printf("[probe] K2 int32 staged in 1 byte, K = %d steps: %.4f ms, "
              "cells differing from %d shifted K1 rounds %ld, count entries "
              "differing %ld, cooperative blocks %d\n", STEPS, t, STEPS,
              differ(b32, a32), bad_counts,
              escg_tile_rounds_fused_blocks(4, 1, 32, TH, TW, 4, 0));
  return 0;
}

}  // namespace probe

int main() {
  const int rc = probe::run();
  std::fflush(stdout);
  return rc != 0 ? rc : std::system(
      "nvidia-smi --query-gpu=name,power.limit --format=csv,noheader");
}
