// The mesh's two-level global tier for Hopper (sm_90a): the consumed total
// of every shard's decisions, folded into the replicated decaying counter.
//
// Replaces (XLA programs of the JAX package, not Pallas kernels), in
// distributedratelimiting/redis_tpu/parallel/sharded_store.py:
//   global_tier_update (:75) and the lax.psum of the per-shard consumed
//   counts before it, in make_two_level_step (:201),
//   make_two_level_scan_step (:243), make_two_level_scan_step_deferred
//   (:304) and, in fp_sharded.py, make_sharded_fp_scan_step (:180, :192)
//   -> global_tier_kernel.
//
// The port keeps every shard of a mesh on one card, shard-major in one
// table, and decides K batches of all shards' rows in one decision launch
// (acquire.cu's scan, or fp_directory.cu's resolve before it). JAX sums
// each shard's batch on its chip and psums the S sums; here the S shards'
// rows of batch k are one row range of the decision's result, so the psum
// is the sum of that range.
//
// Inputs: the decision's result out f32[K, 2, R] (row 0 the grant, 0/1,
// or an fp decision's code granted + 2 * resolved: the grant is bit 0),
// its counts i32[K, R] (0 on padding rows), nows i32[K]; the counter
// (value f32, period f32, last_ts i32, exists u8, each one element).
// Per batch k:
//   total_k = sum over r of counts[k, r] * grant[k, r]   (exact, in int64)
// then, with "batch" cadence, for k = 0 .. K-1 in order, and with "launch"
// cadence once, at nows[K-1] with the sum of the K totals:
//   ex      = exists
//   delta   = f32(max(0, now - (ex ? last_ts : 0)))       (int32 wrap)
//   decayed = ex ? max(0, value - delta * rate) : 0
//   period  = ex ? 0.8 * period + 0.2 * delta : delta
//   value   = decayed + f32(total);  last_ts = now;  exists = 1
// (bucket_math.decay_core, then the add), each product and sum rounded on
// its own (__fmul_rn, __fadd_rn, -fmad=false), as counter.cu's sync. A
// total is an integer sum rounded to float32 once: equal to JAX's float32
// sum and psum wherever those are exact (whole counts, totals below 2^24),
// and the same in every run whatever order the rows are added in.
//
// Design: ONE launch of K blocks, a block a batch. Each thread adds its
// strided rows in int64, the warp reduces with shuffles and the block
// through shared memory (a tree, fixed order); thread 0 stores the batch's
// total, fences, and takes a ticket from a done counter. The block that
// takes the last ticket (the last block done) fences, reads the K totals
// from L2 and folds them into the counter in batch order (one thread: the
// recurrence is serial), then puts the done counter back to 0 for the next
// launch, so no launch zeroes it. The wrapper keeps one done counter a
// stream, and launches on one stream follow each other.
//
// Bound: bytes. Each row reads its grant (4 B of the result's row 0) and
// its count (4 B); the counter moves 13 B each way and nows 4 B a batch.
// Two integer operations a row; no product: the tensor cores do not apply.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): the 8-shard bulk
// chunk, 16 x 8,192 rows, 0.0070 ms of device time against a bound of
// 0.00031 ms; 1 x 8 rows 0.0028 ms. The launch, one block a batch on few
// SMs and the serial fold set it, not the bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
// float32 of JAX's (1.0 - PERIOD_EWMA_ALPHA) and PERIOD_EWMA_ALPHA.
constexpr float kKeep = 0.8f;
constexpr float kAlpha = 0.2f;

// max(0, now - last) with int32 wraparound, as counter.cu's.
__device__ __forceinline__ int32_t elapsed(int32_t now, int32_t last) {
  return max((int32_t)((uint32_t)now - (uint32_t)last), 0);
}

struct Counter {
  float* value;
  float* period;
  int32_t* last_ts;
  uint8_t* exists;
};

// One recurrence of the tier: decay to now, add total.
__device__ void fold(const Counter& g, long long total, int32_t now,
                     float rate) {
  const bool ex = *g.exists != 0;
  const float delta = __int2float_rn(elapsed(now, ex ? *g.last_ts : 0));
  const float decayed =
      ex ? fmaxf(__fsub_rn(*g.value, __fmul_rn(delta, rate)), 0.0f) : 0.0f;
  *g.period = ex ? __fadd_rn(__fmul_rn(kKeep, *g.period),
                             __fmul_rn(kAlpha, delta))
                 : delta;
  *g.value = __fadd_rn(decayed, __ll2float_rn(total));
  *g.last_ts = now;
  *g.exists = 1;
}

__global__ void __launch_bounds__(kThreads)
    global_tier_kernel(const float* __restrict__ out,
                       const int32_t* __restrict__ counts,
                       const int32_t* __restrict__ nows, int32_t n_batches,
                       int32_t rows, Counter g, float rate, int32_t per_launch,
                       long long* totals, unsigned int* done) {
  __shared__ long long warp_sums[kThreads / 32];
  __shared__ bool last;
  const int32_t k = blockIdx.x;
  const float* grant = out + (int64_t)k * 2 * rows;
  const int32_t* cnt = counts + (int64_t)k * rows;
  long long s = 0;
  for (int32_t r = threadIdx.x; r < rows; r += kThreads) {
    if (((int32_t)grant[r]) & 1) s += cnt[r];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFullMask, s, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) t += warp_sums[w];
    totals[k] = t;
    __threadfence();
    last = atomicAdd(done, 1u) == (unsigned int)(n_batches - 1);
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  const volatile long long* tot = totals;
  if (per_launch) {
    long long t = 0;
    for (int32_t j = 0; j < n_batches; ++j) t += tot[j];
    fold(g, t, nows[n_batches - 1], rate);
  } else {
    for (int32_t j = 0; j < n_batches; ++j) fold(g, tot[j], nows[j], rate);
  }
  *done = 0u;
}

}  // namespace

// out f32[K, 2, R], counts i32[K, R], nows i32[K]; the counter's four
// one-element fields, updated in place; per_launch 0 ("batch") or 1
// ("launch"); totals int64[K] scratch; done a uint32 that is 0 between
// launches (the kernel leaves it 0).
extern "C" int drl_global_tier(const float* out, const int32_t* counts,
                               const int32_t* nows, int32_t n_batches,
                               int32_t rows, float* value, float* period,
                               int32_t* last_ts, uint8_t* exists, float rate,
                               int32_t per_launch, long long* totals,
                               unsigned int* done, cudaStream_t stream) {
  if (n_batches < 1 || rows < 0 || (per_launch != 0 && per_launch != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const Counter g{value, period, last_ts, exists};
  global_tier_kernel<<<n_batches, kThreads, 0, stream>>>(
      out, counts, nows, n_batches, rows, g, rate, per_launch, totals, done);
  return (int)cudaGetLastError();
}
