// TTL sweep over the whole bucket table, for Hopper (sm_90a).
//
// Replaces: distributedratelimiting/redis_tpu/ops/pallas_kernels.py,
//   sweep_expired_pallas (body _sweep_kernel) — the repo's one Pallas kernel.
//
// Computes, per slot i < n:
//   ttl     = clamp(ceil(max(cap - tokens, 0) / max(rate, 1e-30)),
//                   1024, min(1yr, 2^31 - 1))        (float32, then int32)
//   expired = exists && max(0, now - last_ts) >= ttl
//   exists[i] = exists && !expired   (IN PLACE: replaces the donated input)
//   mask[i]   = expired
//   tile_counts[i / tile] += expired (tile = 32768 slots, as the TPU kernel)
//
// Bound: memory. 11 bytes a slot move (tokens 4 + last_ts 4 + exists 1 read,
// exists 1 + mask 1 written) for ~10 flops, far below the card's
// operations-per-byte balance, so the least time is 11 N / 3.35 TB/s.
//
// Design: one thread per slot, grid-stride over the table, 256-thread blocks.
// Each pass of a block covers 256 consecutive slots, which lie in one tile
// (32768 % 256 == 0), so __syncthreads_count gives the block's expired
// count and one thread adds it to the tile's counter with atomicAdd. The
// Pallas kernel carried nothing between grid steps, so nothing is carried
// between blocks here either; tile_counts must be zeroed by the caller.
//
// The TTL is bucket.cuh's ttl_ticks (shared with fp_directory.cu's sweep).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bucket.cuh"

namespace {

constexpr int kThreads = 256;

using drl_bucket::ttl_ticks;

__global__ void sweep_kernel(const float* __restrict__ tokens,
                             const int32_t* __restrict__ last_ts,
                             uint8_t* __restrict__ exists,
                             int8_t* __restrict__ mask,
                             int32_t* __restrict__ tile_counts, int64_t n,
                             int32_t now, float cap, float rate, int64_t tile) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < n;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    int expired = 0;
    if (i < n) {
      const uint8_t ex = exists[i];
      // now - last_ts with int32 wraparound, as the reference computes it.
      const int32_t elapsed =
          max((int32_t)((uint32_t)now - (uint32_t)last_ts[i]), 0);
      expired = ex != 0 && elapsed >= ttl_ticks(tokens[i], cap, rate);
      if (expired) exists[i] = 0;
      mask[i] = (int8_t)expired;
    }
    const int count = __syncthreads_count(expired);
    if (threadIdx.x == 0 && count > 0) {
      atomicAdd(&tile_counts[base / tile], count);
    }
  }
}

}  // namespace

extern "C" int drl_sweep_expired(const float* tokens, const int32_t* last_ts,
                                 uint8_t* exists, int8_t* mask,
                                 int32_t* tile_counts, int64_t n, int32_t now,
                                 float cap, float rate, int64_t tile,
                                 cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  // Enough blocks to fill 132 SMs many times over; the loop covers the rest.
  if (blocks > 132 * 32) blocks = 132 * 32;
  sweep_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      tokens, last_ts, exists, mask, tile_counts, n, now, cap, rate, tile);
  return (int)cudaGetLastError();
}
