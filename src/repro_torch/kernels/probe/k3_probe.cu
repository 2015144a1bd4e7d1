// Where K3's time goes on the card, and the designs tried for it.
//
// Build and run from the repository root, on a machine with the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v \
//       -o src/repro_torch/kernels/_build/k3_probe \
//       src/repro_torch/kernels/probe/k3_probe.cu
//   src/repro_torch/kernels/_build/k3_probe
//
// On park3's stream-fed shapes (3200 x 3200 int32, tile (8, 32), 256
// proposals per tile, park3's thresholds and dominance, a random lattice
// with 10 % empty cells and uniform random proposals) it times, by CUDA
// events over 20 launches after a warm-up launch:
//
// * the previous K3 (one thread per tile, 128-thread blocks, copy then
//   sweep in device memory, proposal reads 1 KB apart between lanes);
// * the kernel of csrc/escg_update.cu (K1's staging, proposals through
//   shared memory in double-buffered chunks of C per tile) for C = 8, 16
//   and 32 with 16-byte cp.async, and for C = 8 and 32 with 4-byte
//   cp.async; staged in int8 and in int32; with a torus shift (1, 1);
// * a register variant: the same staging, but each lane reads its own
//   tile's next 8 proposals of each field straight into registers (two
//   16-byte loads a field, a whole 32-byte sector) one batch ahead;
// * the parts: the load and store alone (K = 0); the proposal stream alone
//   (the chunk loop without the tile or the sweep, at the kernel's shared
//   memory per block); and a coalesced read of the 163.8 MB of proposals
//   (16-byte loads, grid-stride), the most the stream can hope for.
//
// Every variant that computes K3's function is held to the previous K3
// (cells that differ; for the shift, the previous K3 on the lattice rolled
// on the host). The last line is the card's name and power limit.
#include "../csrc/escg_update.cu"

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <type_traits>
#include <vector>

namespace probe {

using escg::Geometry;
using escg::Rule;
using escg::Stream;

constexpr int H = 3200, W = 3200, TH = 8, TW = 32, K = 256;
constexpr int REPS = 20;
constexpr int N_TILES = (H / TH) * (W / TW);

#define CHECK(x)                                                      \
  do {                                                                \
    cudaError_t e_ = (x);                                             \
    if (e_ != cudaSuccess) {                                          \
      std::fprintf(stderr, "%s:%d %s\n", __FILE__, __LINE__,          \
                   cudaGetErrorString(e_));                           \
      std::exit(1);                                                   \
    }                                                                 \
  } while (0)

// The previous K3: one thread per tile copies its tile cell by cell from
// `in` to `out`, then plays its proposals on `out` in device memory.
__global__ void old_k3(const int32_t* in, int32_t* out, int k,
                       const int* cell, const int* dirn, const float* u_act,
                       const float* u_dom, const float* dom, const int* dirs,
                       Rule rule) {
  const int lgw = W / TW;
  const int tile = blockIdx.x * blockDim.x + threadIdx.x;
  if (tile >= N_TILES) return;
  const int r0 = (tile / lgw) * TH, c0 = (tile % lgw) * TW;
  for (int r = r0; r < r0 + TH; ++r)
    for (int c = c0; c < c0 + TW; ++c)
      out[(size_t)r * W + c] = in[(size_t)r * W + c];
  const int iw = TW - 2;
  const size_t base = (size_t)tile * k;
  for (int j = 0; j < k; ++j) {
    const int cj = cell[base + j], dj = dirn[base + j];
    const int r = r0 + 1 + cj / iw, c = c0 + 1 + cj % iw;
    int32_t* ps = out + (size_t)r * W + c;
    int32_t* pn = out + (size_t)(r + dirs[2 * dj]) * W + c + dirs[2 * dj + 1];
    const int2 next = escg::pair_rule(*ps, *pn, u_act[base + j],
                                      u_dom[base + j], rule, dom);
    *ps = next.x;
    *pn = next.y;
  }
}

// The register variant: K3's staging, with lane t reading its tile's next
// 8 proposals of each field into registers one batch ahead.
template <typename T, typename S>
__global__ void __launch_bounds__(escg::kWarp)
    register_k3(const T* in, T* out, Geometry g, Stream st, Rule rule,
                const float* dom, const int* dirs) {
  extern __shared__ __align__(16) uint32_t words[];
  __shared__ int sdirs[16];
  escg::load_dirs(dirs, sdirs);
  int r0, c0;
  const int tile = escg::group_tile(g, blockIdx.x, threadIdx.x, &r0, &c0);
  escg::load_group<T, S>(in, words, g, tile, r0, c0, 0, 0);
  __syncwarp();
  if (tile >= 0) {
    const uint4* src[escg::kFields];
    for (int f = 0; f < escg::kFields; ++f)
      src[f] = reinterpret_cast<const uint4*>(st.field[f] +
                                              (size_t)tile * st.k);
    uint4 next[escg::kFields][2];
    for (int f = 0; f < escg::kFields; ++f) {
      next[f][0] = __ldcs(src[f]);
      next[f][1] = __ldcs(src[f] + 1);
    }
    for (int q = 0; q < st.k; q += 8) {
      uint32_t w[escg::kFields][8];
#pragma unroll
      for (int f = 0; f < escg::kFields; ++f) {
        const uint4 a = next[f][0], b = next[f][1];
        w[f][0] = a.x, w[f][1] = a.y, w[f][2] = a.z, w[f][3] = a.w;
        w[f][4] = b.x, w[f][5] = b.y, w[f][6] = b.z, w[f][7] = b.w;
      }
      if (q + 8 < st.k) {
#pragma unroll
        for (int f = 0; f < escg::kFields; ++f) {
          next[f][0] = __ldcs(src[f] + (q + 8) / 4);
          next[f][1] = __ldcs(src[f] + (q + 8) / 4 + 1);
        }
      }
      escg::apply_batch<S>(words, w, st.k - q, g, rule, dom, sdirs);
    }
  }
  __syncwarp();
  escg::store_group<T, S>(out, words, g, tile, r0, c0);
}

// The proposal stream alone: the chunk loop of K3 with no tile and no
// sweep, launched with K3's shared memory per block.
template <int C>
__global__ void __launch_bounds__(escg::kWarp)
    stream_only(Geometry g, Stream st) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int words = escg::Chunk<C>::words(g.P);
  const int first = blockIdx.x * g.P;
  const int tiles = min(g.P, g.n_tiles - first);
  const int n_chunks = (st.k + C - 1) / C;
  escg::stream_chunk<C, true>(smem, st, g.P, first, tiles, 0, min(C, st.k));
  escg::cp_async_commit();
  for (int i = 0; i < n_chunks; ++i) {
    const int j1 = (i + 1) * C;
    if (j1 < st.k)
      escg::stream_chunk<C, true>(smem + ((i + 1) % 2) * words, st, g.P,
                                  first, tiles, j1, min(C, st.k - j1));
    escg::cp_async_commit();
    escg::cp_async_wait_all_but_one();
    __syncwarp();
  }
}

// A coalesced read of n 16-byte words, folded into one word per thread.
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

long differ(const int32_t* a, const int32_t* b) {
  std::vector<int32_t> x((size_t)H * W), y((size_t)H * W);
  CHECK(cudaMemcpy(x.data(), a, x.size() * 4, cudaMemcpyDefault));
  CHECK(cudaMemcpy(y.data(), b, y.size() * 4, cudaMemcpyDefault));
  long n = 0;
  for (size_t i = 0; i < x.size(); ++i) n += x[i] != y[i];
  return n;
}

int run() {
  const Rule rule{0.99675536f, 0.9983777f, 0, 4};
  const float dom_h[16] = {0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1, 0, 0};
  const int dirs_h[16] = {-1, 0, 1, 0, 0, -1, 0, 1,
                          -1, -1, -1, 1, 1, -1, 1, 1};
  const int interior = (TH - 2) * (TW - 2);
  std::mt19937 gen(0);
  const size_t n = (size_t)H * W, m = (size_t)N_TILES * K;
  std::vector<int32_t> g_h(n), rolled_h(n);
  for (size_t i = 0; i < n; ++i)
    g_h[i] = gen() % 10 == 0 ? 0 : 1 + (int)(gen() % 3);
  for (int r = 0; r < H; ++r)
    for (int c = 0; c < W; ++c)
      rolled_h[(size_t)r * W + c] =
          g_h[(size_t)((r + 1) % H) * W + (c + 1) % W];
  std::vector<uint32_t> f_h[4];
  for (auto& f : f_h) f.resize(m);
  std::uniform_real_distribution<float> uni(0.f, 1.f);
  for (size_t i = 0; i < m; ++i) {
    f_h[0][i] = gen() % interior;
    f_h[1][i] = gen() % 4;
    const float a = uni(gen), b = uni(gen);
    std::memcpy(&f_h[2][i], &a, 4);
    std::memcpy(&f_h[3][i], &b, 4);
  }
  int32_t *in, *rolled, *want, *want_rolled, *got;
  uint32_t* fields[4];
  float* dom;
  int* dirs;
  uint32_t* sink;
  CHECK(cudaMalloc(&in, n * 4));
  CHECK(cudaMalloc(&rolled, n * 4));
  CHECK(cudaMalloc(&want, n * 4));
  CHECK(cudaMalloc(&want_rolled, n * 4));
  CHECK(cudaMalloc(&got, n * 4));
  for (int f = 0; f < 4; ++f) {
    CHECK(cudaMalloc(&fields[f], m * 4));
    CHECK(cudaMemcpy(fields[f], f_h[f].data(), m * 4, cudaMemcpyDefault));
  }
  CHECK(cudaMalloc(&dom, sizeof dom_h));
  CHECK(cudaMalloc(&dirs, sizeof dirs_h));
  CHECK(cudaMalloc(&sink, 4));
  CHECK(cudaMemcpy(in, g_h.data(), n * 4, cudaMemcpyDefault));
  CHECK(cudaMemcpy(rolled, rolled_h.data(), n * 4, cudaMemcpyDefault));
  CHECK(cudaMemcpy(dom, dom_h, sizeof dom_h, cudaMemcpyDefault));
  CHECK(cudaMemcpy(dirs, dirs_h, sizeof dirs_h, cudaMemcpyDefault));
  const int* cell = (const int*)fields[0];
  const int* dirn = (const int*)fields[1];
  const float* ua = (const float*)fields[2];
  const float* ud = (const float*)fields[3];
  const Stream st{{fields[0], fields[1], fields[2], fields[3]}, K};

  Timer timer;
  std::printf("[probe] %d x %d int32, tile (%d, %d), K = %d, %d tiles\n", H,
              W, TH, TW, K, N_TILES);
  float t = timer.ms([&] {
    old_k3<<<(N_TILES + 127) / 128, 128>>>(in, want, K, cell, dirn, ua, ud,
                                           dom, dirs, rule);
  });
  std::printf("[probe] previous K3 (thread per tile, device memory): "
              "%.4f ms\n", t);
  old_k3<<<(N_TILES + 127) / 128, 128>>>(rolled, want_rolled, K, cell, dirn,
                                         ua, ud, dom, dirs, rule);
  CHECK(cudaDeviceSynchronize());

  auto geometry = [](int stage) {
    return escg::make_geometry(H, W, TH, TW, stage, 32, H, W);
  };
  // one lattice as the kernel's table of one run
  auto one_run = [&](const Stream& s) {
    escg::StreamRuns runs{};
    runs.in[0] = in;
    runs.out[0] = got;
    for (int f = 0; f < escg::kFields; ++f) runs.field[0][f] = s.field[f];
    return runs;
  };
  auto chunked = [&](auto c, auto vec, int stage, int sr, int sc) {
    constexpr int C = decltype(c)::value;
    constexpr bool VEC = decltype(vec)::value;
    const Geometry g = geometry(stage);
    if (stage == 1)
      return escg::launch<int32_t, int8_t, C, VEC>(one_run(st), 1, 1, g, K,
                                                   sr, sc, rule, dom, dirs,
                                                   nullptr);
    return escg::launch<int32_t, int32_t, C, VEC>(one_run(st), 1, 1, g, K,
                                                  sr, sc, rule, dom, dirs,
                                                  nullptr);
  };
  using C8 = std::integral_constant<int, 8>;
  using C16 = std::integral_constant<int, 16>;
  using C32 = std::integral_constant<int, 32>;
  using Vec = std::true_type;
  using Word = std::false_type;
  auto report = [&](const char* what, float ms, const int32_t* ref) {
    std::printf("[probe] %s: %.4f ms, cells differing from the previous K3 "
                "%ld\n", what, ms, differ(got, ref));
  };
  t = timer.ms([&] { CHECK((cudaError_t)chunked(C8{}, Vec{}, 1, 0, 0)); });
  report("chunks of 8, 16-byte cp.async, staged in int8", t, want);
  t = timer.ms([&] { CHECK((cudaError_t)chunked(C16{}, Vec{}, 1, 0, 0)); });
  report("chunks of 16, 16-byte cp.async, staged in int8", t, want);
  t = timer.ms([&] { CHECK((cudaError_t)chunked(C32{}, Vec{}, 1, 0, 0)); });
  report("chunks of 32, 16-byte cp.async, staged in int8", t, want);
  t = timer.ms([&] { CHECK((cudaError_t)chunked(C8{}, Word{}, 1, 0, 0)); });
  report("chunks of 8, 4-byte cp.async, staged in int8", t, want);
  t = timer.ms([&] { CHECK((cudaError_t)chunked(C8{}, Vec{}, 4, 0, 0)); });
  report("chunks of 8, 16-byte cp.async, staged in int32", t, want);
  t = timer.ms([&] { CHECK((cudaError_t)chunked(C32{}, Vec{}, 4, 0, 0)); });
  report("chunks of 32, 16-byte cp.async, staged in int32", t, want);
  t = timer.ms([&] { CHECK((cudaError_t)chunked(C32{}, Word{}, 1, 0, 0)); });
  report("chunks of 32, 4-byte cp.async, staged in int8", t, want);
  t = timer.ms([&] { CHECK((cudaError_t)chunked(C8{}, Vec{}, 1, 1, 1)); });
  std::printf("[probe] chunks of 8 with shift (1, 1): %.4f ms, cells "
              "differing from the previous K3 on the rolled lattice %ld\n",
              t, differ(got, want_rolled));
  t = timer.ms([&] { CHECK((cudaError_t)chunked(C32{}, Vec{}, 1, 1, 1)); });
  std::printf("[probe] chunks of 32 with shift (1, 1): %.4f ms, cells "
              "differing from the previous K3 on the rolled lattice %ld\n",
              t, differ(got, want_rolled));
  t = timer.ms([&] {
    void* outs[] = {got};
    const void* ins[] = {in};
    const void* fl[] = {cell, dirn, ua, ud};
    CHECK((cudaError_t)escg_tile_round(4, 1, 32, 1, outs, ins, fl, nullptr,
                                       1, H, W, H, W, TH, TW, K, dom, 4,
                                       dirs, rule.t_eps, rule.t_eps_mu, 0, 0,
                                       0, nullptr));
  });
  report("the library's entry point (kChunk)", t, want);

  const Geometry g1 = geometry(1);
  const size_t reg_smem = (size_t)TH * g1.G * 32 * 4;
  CHECK(cudaFuncSetAttribute(register_k3<int32_t, int8_t>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)reg_smem));
  t = timer.ms([&] {
    register_k3<int32_t, int8_t><<<N_TILES / 32, 32, reg_smem>>>(
        in, got, g1, st, rule, dom, dirs);
  });
  report("register variant (8 proposals a field one batch ahead)", t, want);

  const Stream none{{fields[0], fields[1], fields[2], fields[3]}, 0};
  t = timer.ms([&] {
    CHECK(((cudaError_t)escg::launch<int32_t, int8_t, escg::kChunk, true>(
        one_run(none), 1, 1, g1, 0, 0, 0, rule, dom, dirs, nullptr)));
  });
  std::printf("[probe] load and store alone (K = 0): %.4f ms, cells "
              "differing from the input %ld\n", t, differ(got, in));
  for (int c : {8, 16, 32}) {
    const size_t smem = c == 8    ? escg::block_smem<8>(g1)
                        : c == 16 ? escg::block_smem<16>(g1)
                                  : escg::block_smem<32>(g1);
    const void* kernel = c == 8    ? (const void*)stream_only<8>
                         : c == 16 ? (const void*)stream_only<16>
                                   : (const void*)stream_only<32>;
    CHECK(cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem));
    t = timer.ms([&] {
      if (c == 8)
        stream_only<8><<<N_TILES / 32, 32, smem>>>(g1, st);
      else if (c == 16)
        stream_only<16><<<N_TILES / 32, 32, smem>>>(g1, st);
      else
        stream_only<32><<<N_TILES / 32, 32, smem>>>(g1, st);
    });
    std::printf("[probe] proposal stream alone, chunks of %d (%zu bytes of "
                "shared memory a block): %.4f ms\n", c, smem, t);
  }
  float read_ms = 0.f;
  for (int f = 0; f < 4; ++f)
    read_ms += timer.ms([&] {
      read_all<<<132 * 8, 256>>>((const uint4*)fields[f], m / 4, sink);
    });
  std::printf("[probe] coalesced read of the four proposal buffers "
              "(%.1f MB): %.4f ms, %.2f TB/s\n", 16.0 * m / 1e6, read_ms,
              16.0 * m / read_ms / 1e9);
  return 0;
}

}  // namespace probe

int main() {
  const int rc = probe::run();
  std::fflush(stdout);
  return rc != 0 ? rc : std::system(
      "nvidia-smi --query-gpu=name,power.limit --format=csv,noheader");
}
