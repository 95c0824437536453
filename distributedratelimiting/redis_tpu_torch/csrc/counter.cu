// Decaying-counter sync and TTL sweep over the counter table, for Hopper
// (sm_90a): the approximate token bucket's global tier.
//
// Replaces (XLA programs of the JAX package, not Pallas kernels):
//   distributedratelimiting/redis_tpu/ops/kernels.py, sync_batch_packed
//     (core _sync_core, with bucket_math.decay_core) -> sync_kernel;
//   distributedratelimiting/redis_tpu/ops/kernels.py, sweep_counters
//     -> sweep_counters_kernel.
//
// sync_kernel, per row i < B of the operand packed i32[3, B] (row 0 slots,
// -1 = padding; row 1 the float32 local counts, bitcast; row 2 the tick):
//   g       = slot if 0 <= slot < N else 0   (the JAX gather's clamp)
//   delta   = f32(max(0, now - (exists[g] ? last_ts[g] : 0)))
//   decayed = exists[g] ? max(0, value[g] - delta * rate) : 0
//   period' = exists[g] ? 0.8 * period[g] + 0.2 * delta : delta
//   out[0][i] = decayed + count[i]          (the row's OWN count)
//   out[1][i] = period'
// and for every valid row, in this order across the whole grid:
//   1. value = decayed, period = period', last_ts = now, exists = 1
//   2. value += count                       (duplicates accumulate)
// Every read of the state must finish before any write, and every "set"
// before any "add", or one duplicate's set overwrites another's add. The
// kernel is one cooperative launch: a grid-stride loop per phase with
// cooperative_groups' grid.sync() between them, and the grid sized from the
// occupancy calculator so that every block is resident (else the launch is
// refused). Phase 1 reads the state and stages decayed and period' in out;
// phase 2 writes the state from out; phase 3 adds the counts into value
// with atomicAdd and finishes out[0]. With distinct slots every result is
// bit-exact against the plain version (-fmad=false, and the _rn intrinsics
// in the plain version's order); where slots repeat, the atomics add in an
// order that changes from run to run, so value may differ by rounding.
// No state pointer is const __restrict__ or read through __ldg: the kernel
// writes what it read, and the read-only path could serve stale lines.
//
// Bound: memory. A row moves its 12 B operand and 8 B reply; each distinct
// slot reads 13 B of state (value, period, last_ts 4 each, exists 1) and
// writes 13 B; ~12 floating-point operations a row.
//
// sweep_counters_kernel, per slot i < N:
//   expired = exists && max(0, now - last_ts) >= 86400 * 1024
//   exists[i] = exists && !expired   (IN PLACE)
//   mask[i] = expired; tile_counts[i / tile] += expired
// with the layout and contract of sweep.cu (256 consecutive slots a pass lie
// in one tile; the caller zeroes tile_counts). Bound: memory, 7 B a slot
// (last_ts 4 + exists 1 read, exists 1 + mask 1 written).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// bucket_math.GLOBAL_COUNTER_TTL_TICKS: 86400 s at 1024 ticks a second.
constexpr int32_t kCounterTtlTicks = 86400 * 1024;
// float32 of JAX's (1.0 - PERIOD_EWMA_ALPHA) and PERIOD_EWMA_ALPHA.
constexpr float kKeep = 0.8f;
constexpr float kAlpha = 0.2f;

// max(0, now - last) with int32 wraparound, as the reference computes it.
__device__ __forceinline__ int32_t elapsed(int32_t now, int32_t last) {
  return max((int32_t)((uint32_t)now - (uint32_t)last), 0);
}

__global__ void sync_kernel(float* value, float* period, int32_t* last_ts,
                            uint8_t* exists, int64_t n,
                            const int32_t* packed, int32_t b, float rate,
                            float* out) {
  cg::grid_group grid = cg::this_grid();
  const int32_t now = packed[2 * (int64_t)b];  // row 2, column 0
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;

  // Phase 1: read the state, stage decayed and period' in out.
  for (int64_t i = first; i < b; i += stride) {
    const int32_t slot = packed[i];
    const int64_t g = (slot >= 0 && slot < n) ? slot : 0;
    const bool ex = exists[g] != 0;
    const float delta = __int2float_rn(elapsed(now, ex ? last_ts[g] : 0));
    out[i] = ex ? fmaxf(__fsub_rn(value[g], __fmul_rn(delta, rate)), 0.0f)
                : 0.0f;
    out[b + i] = ex ? __fadd_rn(__fmul_rn(kKeep, period[g]),
                                __fmul_rn(kAlpha, delta))
                    : delta;
  }
  grid.sync();

  // Phase 2: every valid row sets its slot (duplicates write equal values).
  for (int64_t i = first; i < b; i += stride) {
    const int32_t slot = packed[i];
    if (slot >= 0 && slot < n) {
      value[slot] = out[i];
      period[slot] = out[b + i];
      last_ts[slot] = now;
      exists[slot] = 1;
    }
  }
  grid.sync();

  // Phase 3: every valid row adds its count; each reply adds its own.
  for (int64_t i = first; i < b; i += stride) {
    const int32_t slot = packed[i];
    const float count = __int_as_float(packed[b + i]);
    out[i] = __fadd_rn(out[i], count);
    if (slot >= 0 && slot < n) atomicAdd(&value[slot], count);
  }
}

__global__ void sweep_counters_kernel(const int32_t* last_ts,
                                      uint8_t* exists, int8_t* mask,
                                      int32_t* tile_counts, int64_t n,
                                      int32_t now, int64_t tile) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < n;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    int expired = 0;
    if (i < n) {
      expired = exists[i] != 0 && elapsed(now, last_ts[i]) >= kCounterTtlTicks;
      if (expired) exists[i] = 0;
      mask[i] = (int8_t)expired;
    }
    const int count = __syncthreads_count(expired);
    if (threadIdx.x == 0 && count > 0) {
      atomicAdd(&tile_counts[base / tile], count);
    }
  }
}

// Resident blocks of sync_kernel on the current device (a cooperative grid
// may hold no more), cached per device.
int sync_grid_limit(int* limit) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && cached[dev] > 0) {
    *limit = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sync_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *limit = sms * per_sm;
  if (dev < 64) cached[dev] = *limit;
  return 0;
}

}  // namespace

extern "C" int drl_sync_counters(float* value, float* period,
                                 int32_t* last_ts, uint8_t* exists, int64_t n,
                                 const int32_t* packed, int32_t b, float rate,
                                 float* out, cudaStream_t stream) {
  if (b <= 0) return (int)cudaSuccess;
  int limit = 0;
  const int rc = sync_grid_limit(&limit);
  if (rc != 0) return rc;
  if (limit <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  int64_t blocks = ((int64_t)b + kThreads - 1) / kThreads;
  if (blocks > limit) blocks = limit;
  void* args[] = {&value, &period, &last_ts, &exists, &n,
                  (void*)&packed, &b, &rate, &out};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)sync_kernel, dim3((unsigned)blocks), dim3(kThreads), args,
      0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int drl_sweep_counters(const int32_t* last_ts, uint8_t* exists,
                                  int8_t* mask, int32_t* tile_counts,
                                  int64_t n, int32_t now, int64_t tile,
                                  cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  sweep_counters_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      last_ts, exists, mask, tile_counts, n, now, tile);
  return (int)cudaGetLastError();
}
