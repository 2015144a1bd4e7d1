// Building blocks of the kernels for Hopper (sm_90a), shared by
// escg_update_fused.cu (K1, K2), escg_update.cu (K3), density.cu (K4) and
// reference_scan.cu (S1).
//
// A one-warp block stages up to 32 tiles of the lattice in shared memory,
// one per lane (Geometry, Staging, group_tile): lane t's cells sit in bank
// t, so the lanes' sweeps never conflict. load_group reads the block's tiles
// coalesced from device memory with the torus roll fused into the load, and
// store_group writes them back coalesced. The tiles are read from a source
// that is the lattice itself or, for one block of a lattice decomposed over
// a mesh, the block extended by a halo: th more rows from the block below
// and tw more columns from the block to the right (Geometry's sh, sw). A
// read at a shift of less than a tile then stays inside the extended block,
// and an axis without a halo wraps as a torus. pair_rule is the update of one
// pair of cells (src/repro/core/rules.py), Divisor the exact division by a
// divisor fixed for the launch, and Staging's splat and equal count equal
// labels packed in a 32-bit word. The cp_async helpers copy from device to
// shared memory without holding registers (K3's proposal chunks, S1's
// proposal windows).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace escg {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// the dynamic shared memory a block may use: the card's 227 KB a block
// less the direction table
constexpr size_t kMaxSmem = 232448 - 16 * sizeof(int);

// Bits 64..95 of the product of a 64-bit a and a 32-bit b: two wide
// multiplies (the sum cannot carry past 64 bits).
__device__ __forceinline__ uint32_t mulhi_64x32(uint64_t a, uint32_t b) {
  const uint64_t lo = (uint64_t)(uint32_t)a * b;
  return (uint32_t)(((uint64_t)(uint32_t)(a >> 32) * b + (lo >> 32)) >> 32);
}

// n / d and n % d for a divisor fixed for the launch (Lemire, Kaser and
// Kurz, "Faster remainder by direct computation", 2019): with
// m = ceil(2^64 / d) both are exact for every 32-bit n and d.
struct Divisor {
  uint64_t m;  // 0 for d = 1
  uint32_t d;
  __host__ __device__ explicit Divisor(uint32_t d_ = 1)
      : m(d_ == 1 ? 0 : ~0ull / d_ + 1), d(d_) {}
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return d == 1 ? n : mulhi_64x32(m, n);
  }
  __device__ __forceinline__ uint32_t mod(uint32_t n) const {
    return mulhi_64x32(m * n, d);
  }
};

struct Rule {
  float t_eps;     // migration below this action draw
  float t_eps_mu;  // interaction below this one, reproduction above
  int nbhd;        // 4 (von Neumann) or 8 (Moore)
  int n_dom;       // species + 1: side of the padded dominance matrix
};

// Where the tiles lie and how a block stages them. The tiles cut the H x W
// lattice that is written; they are read from a source of sh x sw cells
// (rows sw apart), which is the lattice itself (sh = H, sw = W) or the
// lattice extended by a halo on an axis (sh = H + th, sw = W + tw).
struct Geometry {
  int H, W, th, tw;
  int sh, sw;     // the source's extent, where a read wraps
  int lgw;        // tiles per row of this lattice
  int n_tiles;
  int P;          // tiles per block (one per lane)
  int G;          // 32-bit staging words per tile row
  Divisor by_G, by_P, by_lgw, interior, iw;
};

// The staging of a block's P tiles in shared memory, cells of type S packed
// kPer to a 32-bit word: word (r * G + c / kPer) * P + t holds cells
// c / kPer * kPer .. + kPer - 1 of row r of tile t, so tile t lies in bank
// t % 32 whatever cell it touches. Cells past a row's end are padding (-1).
template <typename S>
struct Staging {
  static constexpr int kPer = 4 / (int)sizeof(S);
  static constexpr int kBits = 8 * (int)sizeof(S);
  static constexpr int kShift = kPer == 4 ? 2 : (kPer == 2 ? 1 : 0);
  // index of cell (r, c) of tile t among the block's S-typed cells
  static __device__ __forceinline__ int at(const Geometry& g, int t, int r,
                                           int c) {
    return ((r * g.G + (c >> kShift)) * g.P + t) * kPer + (c & (kPer - 1));
  }
  // label v in every cell of a word
  static __device__ __forceinline__ uint32_t splat(int v) {
    return (uint32_t)v * (kPer == 4 ? 0x01010101u
                                    : (kPer == 2 ? 0x00010001u : 1u));
  }
  // how many cells of `word` hold the label splatted in `pattern`
  static __device__ __forceinline__ uint32_t equal(uint32_t word,
                                                   uint32_t pattern) {
    if (kPer == 4) return __popc(__vcmpeq4(word, pattern)) >> 3;
    if (kPer == 2) return __popc(__vcmpeq2(word, pattern)) >> 4;
    return word == pattern ? 1u : 0u;
  }
};

// kPer cells of a lattice row, stored with one access where they are
// aligned to their size.
template <typename T, int N>
struct alignas(sizeof(T) * N) Cells {
  T v[N];
};

// Lane t's tile of group `group`: its index (or -1 past the last tile), and
// the row and column of its first cell in the lattice.
__device__ __forceinline__ int group_tile(const Geometry& g, int group,
                                          int lane, int* r0, int* c0) {
  const int tile = group * g.P + lane;
  if (lane >= g.P || tile >= g.n_tiles) {
    *r0 = *c0 = 0;
    return -1;
  }
  const int ti = (int)g.by_lgw.div((uint32_t)tile);
  *r0 = ti * g.th;
  *c0 = (tile - ti * g.lgw) * g.tw;
  return tile;
}

// Stage the group's tiles from `src` rolled by (-sr, -sc): cell (r, c) of a
// tile at (r0, c0) is src[(r0 + r + sr) mod sh][(c0 + c + sc) mod sw], with
// 0 <= sr < H and 0 <= sc < W. On an axis with a halo the shift is less than
// the tile, so the read never wraps there. Lanes walk each tile row kPer
// cells at a time, tile after tile, so a warp reads runs of consecutive
// cells.
template <typename T, typename S>
__device__ void load_group(const T* src, uint32_t* words, const Geometry& g,
                           int my_tile, int my_r0, int my_c0, int sr,
                           int sc) {
  using St = Staging<S>;
  const int lane = threadIdx.x;
  const int row_words = g.P * g.G;
  for (int u0 = 0; u0 < row_words; u0 += kWarp) {
    const int u = u0 + lane;
    const int t = (int)g.by_G.div((uint32_t)u);
    const int gi = u - t * g.G;
    const int src_lane = t < kWarp ? t : 0;
    const int tile = __shfl_sync(kFull, my_tile, src_lane);
    const int r0 = __shfl_sync(kFull, my_r0, src_lane);
    const int c0 = __shfl_sync(kFull, my_c0, src_lane);
    if (u >= row_words || tile < 0) continue;
    int cols[St::kPer];
#pragma unroll
    for (int b = 0; b < St::kPer; ++b) {
      const int c = c0 + gi * St::kPer + b + sc;
      cols[b] = c < g.sw ? c : c - g.sw;
    }
#pragma unroll 8
    for (int r = 0; r < g.th; ++r) {
      int row = r0 + r + sr;
      row = row < g.sh ? row : row - g.sh;
      const T* line = src + (size_t)row * g.sw;
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < St::kPer; ++b) {
        const int v = gi * St::kPer + b < g.tw ? (int)line[cols[b]] : -1;
        word |= ((uint32_t)v & (0xffffffffu >> (32 - St::kBits)))
                << (b * St::kBits);
      }
      words[(r * g.G + gi) * g.P + t] = word;
    }
  }
}

// Write the group's staged tiles to `dst` in place (no roll), a word's
// cells with one store where the tile width is a multiple of kPer.
template <typename T, typename S>
__device__ void store_group(T* dst, const uint32_t* words, const Geometry& g,
                            int my_tile, int my_r0, int my_c0) {
  using St = Staging<S>;
  using Run = Cells<T, St::kPer>;
  const int lane = threadIdx.x;
  const int row_words = g.P * g.G;
  const bool whole = g.tw % St::kPer == 0;
  for (int u0 = 0; u0 < row_words; u0 += kWarp) {
    const int u = u0 + lane;
    const int t = (int)g.by_G.div((uint32_t)u);
    const int gi = u - t * g.G;
    const int src_lane = t < kWarp ? t : 0;
    const int tile = __shfl_sync(kFull, my_tile, src_lane);
    const int r0 = __shfl_sync(kFull, my_r0, src_lane);
    const int c0 = __shfl_sync(kFull, my_c0, src_lane);
    if (u >= row_words || tile < 0) continue;
#pragma unroll 8
    for (int r = 0; r < g.th; ++r) {
      const uint32_t word = words[(r * g.G + gi) * g.P + t];
      T* line = dst + (size_t)(r0 + r) * g.W + c0 + gi * St::kPer;
      Run run;
#pragma unroll
      for (int b = 0; b < St::kPer; ++b)
        run.v[b] = (T)(S)(word >> (b * St::kBits));
      if (whole) {
        *reinterpret_cast<Run*>(line) = run;
      } else {
#pragma unroll
        for (int b = 0; b < St::kPer; ++b)
          if (gi * St::kPer + b < g.tw) line[b] = run.v[b];
      }
    }
  }
}

// The pair rule of src/repro/core/rules.py: the new labels of the pair of
// labels (s, n) for the action draw ua and the dominance draw ud. Thresholds
// and the dominance rates are float32 and p1 + p2 is a float32 sum; the
// rates are read only for an interaction; a pair of one species is left as
// it is.
__device__ __forceinline__ int2 pair_rule(int s, int n, float ua, float ud,
                                          const Rule& rule,
                                          const float* dom) {
  const bool migrate = ua < rule.t_eps;
  const bool interact = (ua >= rule.t_eps) && (ua < rule.t_eps_mu);
  const bool reproduce = ua >= rule.t_eps_mu;
  float p1 = 0.f, p2 = 0.f;
  if (interact) {
    p1 = __ldg(&dom[s * rule.n_dom + n]);
    p2 = __ldg(&dom[n * rule.n_dom + s]);
  }
  const bool kill_n = interact && (ud < p1);
  const bool kill_s = interact && !kill_n && (ud < p1 + p2);
  const bool rep_to_n = reproduce && (n == 0);
  const bool rep_to_s = reproduce && (s == 0);
  int new_s = migrate ? n : (kill_s ? 0 : (rep_to_s ? n : s));
  int new_n = migrate ? s : (kill_n ? 0 : (rep_to_n ? s : n));
  new_s = s == n ? s : new_s;
  new_n = s == n ? n : new_n;
  return make_int2(new_s, new_n);
}

// Asynchronous copies from device to shared memory (cp.async): 16 or 4
// bytes a lane, committed as a group; a lane waits for its own groups.
__device__ __forceinline__ void cp_async16(uint32_t* dst,
                                           const uint32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t* dst,
                                          const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until this lane's copies but those of the latest group have landed.
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Wait until all of this lane's copies have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void load_dirs(const int* dirs, int* sdirs) {
  if (threadIdx.x < 16) sdirs[threadIdx.x] = dirs[threadIdx.x];
}

// The geometry of an H x W lattice read from an sh x sw source (sh = H and
// sw = W: the lattice itself).
__host__ inline Geometry make_geometry(int H, int W, int th, int tw,
                                       int stage_bytes, int P, int sh,
                                       int sw) {
  Geometry g;
  g.H = H;
  g.W = W;
  g.th = th;
  g.tw = tw;
  g.sh = sh;
  g.sw = sw;
  g.lgw = W / tw;
  g.n_tiles = (H / th) * g.lgw;
  g.P = P;
  g.G = (tw * stage_bytes + 3) / 4;
  g.by_G = Divisor((uint32_t)g.G);
  g.by_P = Divisor((uint32_t)P);
  g.by_lgw = Divisor((uint32_t)g.lgw);
  g.interior = Divisor((uint32_t)((th - 2) * (tw - 2)));
  g.iw = Divisor((uint32_t)(tw - 2));
  return g;
}

// Check the staging fits and allow the kernel that much shared memory.
__host__ inline cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The (lattice, staging) type pairs: int8 staging for any lattice whose
// labels fit it, else the lattice's own type.
#define ESCG_DISPATCH(cell_bytes, stage_bytes, CALL)               \
  switch ((cell_bytes) * 10 + (stage_bytes)) {                     \
    case 11: { using T = int8_t; using S = int8_t; return CALL; }   \
    case 21: { using T = int16_t; using S = int8_t; return CALL; }  \
    case 41: { using T = int32_t; using S = int8_t; return CALL; }  \
    case 22: { using T = int16_t; using S = int16_t; return CALL; } \
    case 44: { using T = int32_t; using S = int32_t; return CALL; } \
  }

}  // namespace escg
