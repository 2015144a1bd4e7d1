// Bulk Philox-4x32-10 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/philox.py:
//   K5 philox_bits_kernel  <- philox_bits (_kernel), and philox_uniform
//
// What it computes. Counter idx (0 <= idx < n_ctr) is (idx, stream, 0, 0)
// with key (seed0, seed1); its four output words go to
// out[4 idx .. 4 idx + 3], the interleave that the reference's
// out.T.reshape(-1) makes of its (4, blocks x block) output. The counter is
// a uint32 and wraps as the reference's does. With `as_uniform` the kernel
// writes the float32 (word >> 8) * 2^-24 in [0, 1) instead of the word
// (philox_uniform).
//
// What bounds it on this card. Nothing is read; 16 bytes are written per
// counter (268 MB for n = 2^26 words: 80 us at 3.35 TB/s), against some 60
// instructions per counter (10 rounds of two wide multiplies, two three-input
// xors and two key additions), 30 us at the card's issue rate. So it is bound
// by bytes.
//
// What the design does about it. One thread per counter, the rounds inlined
// with __umulhi for the high word (as in escg_update_fused.cu), and the four
// words stored as one 16-byte vector store, so a warp writes 512 contiguous
// bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace escg5 {

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

__global__ void philox_bits_kernel(uint4* out, int64_t n_ctr,
                                   uint32_t stream, uint32_t seed0,
                                   uint32_t seed1, int as_uniform) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_ctr) return;
  const uint4 x = philox4x32_10((uint32_t)idx, stream, 0u, 0u, seed0, seed1);
  if (as_uniform) {
    out[idx] = make_uint4(
        __float_as_uint((float)(x.x >> 8) * 0x1p-24f),
        __float_as_uint((float)(x.y >> 8) * 0x1p-24f),
        __float_as_uint((float)(x.z >> 8) * 0x1p-24f),
        __float_as_uint((float)(x.w >> 8) * 0x1p-24f));
  } else {
    out[idx] = x;
  }
}

constexpr int kThreads = 256;

}  // namespace escg5

extern "C" {

// out holds 4 * n_ctr 32-bit words, 16-byte aligned. Returns a cudaError_t
// (0 = launched).
int philox_bits(void* out, int64_t n_ctr, uint32_t stream, uint32_t seed0,
                uint32_t seed1, int as_uniform, int device,
                void* cuda_stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_ctr == 0) return 0;
  const int64_t blocks = (n_ctr + escg5::kThreads - 1) / escg5::kThreads;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  escg5::philox_bits_kernel<<<(unsigned)blocks, escg5::kThreads, 0,
                              (cudaStream_t)cuda_stream>>>(
      (uint4*)out, n_ctr, stream, seed0, seed1, as_uniform);
  return (int)cudaGetLastError();
}

const char* escg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
