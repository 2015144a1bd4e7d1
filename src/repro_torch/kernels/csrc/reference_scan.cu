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
// What bounds it on this card. A step may read the cells the step before
// it stored, so the steps form one chain of dependent loads and stores: the
// latency of that chain, not the 16 bytes of proposal and the few bytes of
// lattice a step moves, sets the time.
//
// What the design does about it. Nothing yet: one thread walks the stream
// and the lattice in device memory (a 3200 x 3200 int32 lattice, 41 MB,
// fits the card's 50 MB L2). The proposal fields and the tables go through
// the read-only path. Overlapping the next proposals' loads with the
// current step is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_staging.cuh"

namespace escg {

template <typename T>
__global__ void __launch_bounds__(1) reference_scan_kernel(
    T* __restrict__ grid, int H, int W, int64_t n_props,
    const int* __restrict__ cell, const int* __restrict__ dirn,
    const float* __restrict__ u_act, const float* __restrict__ u_dom,
    const float* __restrict__ dom, const int* __restrict__ dirs, Rule rule,
    int flux, uint8_t* __restrict__ touched, int* __restrict__ kept) {
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
      const int2 out = pair_rule((int)grid[i], (int)grid[ni],
                                 __ldg(&u_act[b]), __ldg(&u_dom[b]), rule,
                                 dom);
      grid[i] = (T)out.x;
      grid[ni] = (T)out.y;
      ++n_kept;
    }
  }
  *kept = n_kept;
}

template <typename T>
int launch(void* grid, int H, int W, int64_t n_props, const int* cell,
           const int* dirn, const float* u_act, const float* u_dom,
           const float* dom, const int* dirs, const Rule& rule, int flux,
           void* touched, int* kept, cudaStream_t stream) {
  reference_scan_kernel<T><<<1, 1, 0, stream>>>(
      (T*)grid, H, W, n_props, cell, dirn, u_act, u_dom, dom, dirs, rule,
      flux, (uint8_t*)touched, kept);
  return (int)cudaGetLastError();
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
      return escg::launch<int16_t>(grid, H, W, n_props, cell, dirn, u_act,
                                   u_dom, dom, dirs, rule, flux, touched,
                                   kept, s);
    case 4:
      return escg::launch<int32_t>(grid, H, W, n_props, cell, dirn, u_act,
                                   u_dom, dom, dirs, rule, flux, touched,
                                   kept, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* escg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
