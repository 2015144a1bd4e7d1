// Where S1's time goes on the card, and the window shapes tried for it.
//
// Build and run from the repository root, on a machine with the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v \
//       -o src/repro_torch/kernels/_build/s1_probe \
//       src/repro_torch/kernels/probe/s1_probe.cu
//   src/repro_torch/kernels/_build/s1_probe
//
// On park3's rule (thresholds 0.10943289 and 0.55471644, rock-paper-
// scissors dominance, von Neumann neighbours, periodic boundary), a random
// int32 lattice of labels 0..3 and uniform random proposals made on the
// host, it times by CUDA events, one launch after a warm-up launch:
//
// * the previous S1 (one thread walks the stream in device memory);
// * the windowed kernel of csrc/reference_scan.cu for windows of 256 x 1,
//   512 x 1, 1024 x 1 and 1024 x 2 (threads x steps a thread);
//
// on a 12 x 12 and a 64 x 64 lattice (2^20 proposals), a 1600 x 1600 and
// a 3200 x 3200 lattice (one MCS: N proposals), and at 3200 x 3200 with
// drop_conflicts over one window of the batched engine (N / 8 proposals).
// At 3200 x 3200 it also times the floor of a window's memory traffic in one
// block: the steps' cells loaded (and stored back), a barrier per 1024
// steps, no table and no rule. Every run of the windowed kernel is held to
// the previous S1 on the same inputs (cells that differ, and the kept
// count). The last line is the card's name and power limit.
#include "../csrc/reference_scan.cu"

#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>

namespace probe {

#define CHECK(x)                                                      \
  do {                                                                \
    cudaError_t e_ = (x);                                             \
    if (e_ != cudaSuccess) {                                          \
      std::fprintf(stderr, "%s:%d %s\n", __FILE__, __LINE__,          \
                   cudaGetErrorString(e_));                           \
      std::exit(1);                                                   \
    }                                                                 \
  } while (0)

// The previous S1: one thread, every step after the last.
__global__ void __launch_bounds__(1) old_s1(
    int32_t* grid, int H, int W, int64_t n_props, const int* cell,
    const int* dirn, const float* u_act, const float* u_dom,
    const float* dom, const int* dirs, escg::Rule rule, int flux,
    uint8_t* touched, int* kept) {
  int n_kept = 0;
  for (int64_t b = 0; b < n_props; ++b) {
    const int i = __ldg(&cell[b]);
    const int d = __ldg(&dirn[b]);
    const int r = i / W;
    int nr = r + __ldg(&dirs[2 * d]);
    int nc = i - r * W + __ldg(&dirs[2 * d + 1]);
    if (flux) {
      nr = ((nr % H) + H) % H;
      nc = ((nc % W) + W) % W;
    } else {
      nr = min(max(nr, 0), H - 1);
      nc = min(max(nc, 0), W - 1);
    }
    const int ni = nr * W + nc;
    bool keep = true;
    if (touched != nullptr) {
      keep = !(touched[i] | touched[ni]);
      touched[i] = 1;
      touched[ni] = 1;
    }
    if (keep) {
      const int2 out = escg::pair_rule(grid[i], grid[ni], __ldg(&u_act[b]),
                                       __ldg(&u_dom[b]), rule, dom);
      grid[i] = out.x;
      grid[ni] = out.y;
      ++n_kept;
    }
  }
  *kept = n_kept;
}

// The floor of a window's memory traffic in one block: per window of 1024
// steps each thread loads its step's two cells (the neighbour one to the
// right, wrapped), waits at a barrier, and (with `store`) stores them back;
// no table, no rule.
__global__ void __launch_bounds__(1024, 1) gather_floor(
    int32_t* grid, int W, int64_t n_props, const int* cell, int store,
    int* sink) {
  int acc = 0;
  for (int64_t b0 = 0; b0 < n_props; b0 += 1024) {
    const int64_t b = b0 + threadIdx.x;
    int i = 0, ni = 0, gi = 0, gn = 0;
    if (b < n_props) {
      i = cell[b];
      ni = (i % W) == W - 1 ? i - (W - 1) : i + 1;
      gi = grid[i];
      gn = grid[ni];
    }
    __syncthreads();
    if (b < n_props) {
      acc += gi + gn;
      if (store) {
        grid[i] = gi;
        grid[ni] = gn;
      }
    }
    __syncthreads();
  }
  if (acc == 0x7fffffff) *sink = acc;
}

struct Inputs {
  int side;
  int64_t n;
  int *cell, *dirn, *dirs;
  float *ua, *ud, *dom;
  int32_t *grid0, *grid;
  uint8_t* touched;
  int* kept;
};

Inputs make(int side, int64_t n_props, unsigned seed) {
  std::mt19937_64 rng(seed);
  const int64_t cells = (int64_t)side * side;
  std::vector<int> cell(n_props), dirn(n_props), g(cells);
  std::vector<float> ua(n_props), ud(n_props);
  std::uniform_real_distribution<float> u01(0.f, 1.f);
  for (int64_t b = 0; b < n_props; ++b) {
    cell[b] = (int)(rng() % cells);
    dirn[b] = (int)(rng() % 4);
    ua[b] = u01(rng);
    ud[b] = u01(rng);
  }
  for (auto& x : g) x = u01(rng) < 0.1f ? 0 : 1 + (int)(rng() % 3);
  const int dirs[16] = {-1, 0,  1, 0,  0, -1, 0,  1,
                        -1, -1, -1, 1, 1, -1, 1, 1};
  const float dom[16] = {0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1, 0, 0};
  Inputs in{side, n_props};
  CHECK(cudaMalloc(&in.cell, 4 * n_props));
  CHECK(cudaMalloc(&in.dirn, 4 * n_props));
  CHECK(cudaMalloc(&in.ua, 4 * n_props));
  CHECK(cudaMalloc(&in.ud, 4 * n_props));
  CHECK(cudaMalloc(&in.dirs, sizeof(dirs)));
  CHECK(cudaMalloc(&in.dom, sizeof(dom)));
  CHECK(cudaMalloc(&in.grid0, 4 * cells));
  CHECK(cudaMalloc(&in.grid, 4 * cells));
  CHECK(cudaMalloc(&in.touched, cells));
  CHECK(cudaMalloc(&in.kept, sizeof(int)));
  CHECK(cudaMemcpy(in.cell, cell.data(), 4 * n_props, cudaMemcpyDefault));
  CHECK(cudaMemcpy(in.dirn, dirn.data(), 4 * n_props, cudaMemcpyDefault));
  CHECK(cudaMemcpy(in.ua, ua.data(), 4 * n_props, cudaMemcpyDefault));
  CHECK(cudaMemcpy(in.ud, ud.data(), 4 * n_props, cudaMemcpyDefault));
  CHECK(cudaMemcpy(in.dirs, dirs, sizeof(dirs), cudaMemcpyDefault));
  CHECK(cudaMemcpy(in.dom, dom, sizeof(dom), cudaMemcpyDefault));
  CHECK(cudaMemcpy(in.grid0, g.data(), 4 * cells, cudaMemcpyDefault));
  return in;
}

void release(Inputs& in) {
  for (void* p : {(void*)in.cell, (void*)in.dirn, (void*)in.ua,
                  (void*)in.ud, (void*)in.dirs, (void*)in.dom,
                  (void*)in.grid0, (void*)in.grid, (void*)in.touched,
                  (void*)in.kept})
    CHECK(cudaFree(p));
}

const escg::Rule kRule{0.10943289f, 0.55471644f, 4, 4};

// ms of one launch of `run` from the lattice grid0 (and a zeroed touched
// map), after a warm-up launch; the result stays in in.grid, in.kept.
template <typename F>
float time_one(Inputs& in, bool drop, F run) {
  cudaEvent_t a, b;
  CHECK(cudaEventCreate(&a));
  CHECK(cudaEventCreate(&b));
  const int64_t cells = (int64_t)in.side * in.side;
  float ms = 0.f;
  for (int rep = 0; rep < 2; ++rep) {
    CHECK(cudaMemcpy(in.grid, in.grid0, 4 * cells, cudaMemcpyDefault));
    CHECK(cudaMemset(in.touched, 0, cells));
    CHECK(cudaEventRecord(a));
    run(drop ? in.touched : nullptr);
    CHECK(cudaEventRecord(b));
    CHECK(cudaEventSynchronize(b));
    CHECK(cudaGetLastError());
    CHECK(cudaEventElapsedTime(&ms, a, b));
  }
  CHECK(cudaEventDestroy(a));
  CHECK(cudaEventDestroy(b));
  return ms;
}

template <int THREADS, int PER>
void windowed(Inputs& in, bool drop, const std::vector<int32_t>& want,
              int want_kept) {
  using Wd = escg::Window<THREADS, PER>;
  const float ms = time_one(in, drop, [&](uint8_t* touched) {
    const int err = escg::launch_window<int32_t, Wd>(
        in.grid, in.side, in.side, in.n, in.cell, in.dirn, in.ua, in.ud,
        in.dom, in.dirs, kRule, 1, touched, in.kept, 0);
    CHECK((cudaError_t)err);
  });
  const int64_t cells = (int64_t)in.side * in.side;
  std::vector<int32_t> got(cells);
  int kept = 0;
  CHECK(cudaMemcpy(got.data(), in.grid, 4 * cells, cudaMemcpyDefault));
  CHECK(cudaMemcpy(&kept, in.kept, sizeof(int), cudaMemcpyDefault));
  int64_t bad = 0;
  for (int64_t c = 0; c < cells; ++c) bad += got[c] != want[c];
  std::printf("[probe] S1 windowed %4d x %d (%4d steps, %6zu B shared) "
              "%dx%d%s: %.3f ms, %.2f ns per step; cells differing %ld, "
              "kept %d (previous %d)\n",
              THREADS, PER, Wd::kSteps, Wd::kSmem, in.side, in.side,
              drop ? " drop_conflicts" : "", ms, ms * 1e6 / in.n,
              (long)bad, kept, want_kept);
}

void size_case(int side, int64_t n_props, bool drop) {
  Inputs in = make(side, n_props, 1234 + side + drop);
  const float ms = time_one(in, drop, [&](uint8_t* touched) {
    old_s1<<<1, 1>>>(in.grid, side, side, n_props, in.cell, in.dirn, in.ua,
                     in.ud, in.dom, in.dirs, kRule, 1, touched, in.kept);
  });
  const int64_t cells = (int64_t)side * side;
  std::vector<int32_t> want(cells);
  int want_kept = 0;
  CHECK(cudaMemcpy(want.data(), in.grid, 4 * cells, cudaMemcpyDefault));
  CHECK(cudaMemcpy(&want_kept, in.kept, sizeof(int), cudaMemcpyDefault));
  std::printf("[probe] S1 previous (one thread) %dx%d%s, %ld proposals: "
              "%.3f ms, %.2f ns per step\n", side, side,
              drop ? " drop_conflicts" : "", (long)n_props, ms,
              ms * 1e6 / n_props);
  if (side == 3200 && !drop) {
    for (int store = 0; store < 2; ++store) {
      const float t = time_one(in, false, [&](uint8_t*) {
        gather_floor<<<1, 1024>>>(in.grid, side, n_props, in.cell, store,
                                  in.kept);
      });
      std::printf("[probe] S1's memory floor %dx%d: the two cells of each "
                  "step loaded%s, a barrier per 1024 steps: %.3f ms, %.2f "
                  "ns per step\n", side, side, store ? " and stored" : "",
                  t, t * 1e6 / n_props);
    }
  }
  windowed<256, 1>(in, drop, want, want_kept);
  windowed<512, 1>(in, drop, want, want_kept);
  windowed<1024, 1>(in, drop, want, want_kept);
  windowed<1024, 2>(in, drop, want, want_kept);
  release(in);
}

int run() {
  size_case(12, 1 << 20, false);
  size_case(64, 1 << 20, false);
  size_case(1600, 1600LL * 1600, false);
  size_case(3200, 3200LL * 3200, false);
  size_case(3200, 3200LL * 3200 / 8, true);
  return 0;
}

}  // namespace probe

int main() {
  const int rc = probe::run();
  std::fflush(stdout);
  return rc != 0 ? rc : std::system(
      "nvidia-smi --query-gpu=name,power.limit --format=csv,noheader");
}
