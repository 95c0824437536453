// Decaying-counter sync and TTL sweep over the counter table, for Hopper
// (sm_90a): the approximate token bucket's global tier.
//
// Replaces (XLA programs of the JAX package, not Pallas kernels):
//   distributedratelimiting/redis_tpu/ops/kernels.py, sync_batch_packed
//     (core _sync_core, with bucket_math.decay_core) -> tally.cuh's warp,
//     block and grid kernels with SyncPolicy;
//   distributedratelimiting/redis_tpu/ops/kernels.py, sweep_counters
//     -> sweep_counters_kernel.
//
// sync_counters, per row i < B of the operand packed i32[3, B] (row 0
// slots, -1 = padding; row 1 the float32 local counts, bitcast; row 2 the
// tick):
//   g       = slot if 0 <= slot < N else 0   (the JAX gather's clamp)
//   delta   = f32(max(0, now - (exists[g] ? last_ts[g] : 0)))
//   decayed = exists[g] ? max(0, value[g] - delta * rate) : 0
//   period' = exists[g] ? 0.8 * period[g] + 0.2 * delta : delta
//   out[0][i] = decayed + count[i]          (the row's OWN count)
//   out[1][i] = period'
// and each slot of the valid rows, once: value = decayed + the sum of its
// rows' counts, period = period', last_ts = now, exists = 1. The plain
// version sets every duplicate and then adds the counts row by row.
//
// Design (tally.cuh, with SyncPolicy below): a warp up to 32 rows, blocks
// sized by the rows up to 4096, every SM slot-major above (the fleet sync of
// 1M distinct counters: one grid barrier). Each slot has one writer, which
// stores decayed + its counts rounded once (in lane order in the warp path),
// so the value is deterministic and equals the plain version bit for bit
// wherever every partial sum is exact in float32; replies, period, last_ts
// and exists equal it always (-fmad=false, and the _rn intrinsics in the
// plain version's order). The sync's padding rows read slot 0 for their
// reply, so the block path puts them in slot 0's block.
// No state pointer is const __restrict__ or read through __ldg: the kernel
// writes what it read, and the read-only path could serve stale lines.
//
// Bound: memory. A row moves its 12 B operand and 8 B reply; each distinct
// slot reads 13 B of state (value, period, last_ts 4 each, exists 1) and
// writes 13 B; ~12 floating-point operations a row. Reached: a warp launch
// costs its launch; at 2^20 distinct rows the claims' scattered words and
// the state's 32 B sectors, not the 26 B of state a slot, set the floor
// (exists is stored only where it was clear).
//
// sweep_counters_kernel, per slot i < N:
//   expired = exists && max(0, now - last_ts) >= 86400 * 1024
//   exists[i] = exists && !expired   (IN PLACE)
//   mask[i] = expired; tile_counts[i / tile] += expired
// with the layout and contract of sweep.cu (256 consecutive slots a pass lie
// in one tile; the caller zeroes tile_counts). Bound: memory, 7 B a slot
// (last_ts 4 + exists 1 read, exists 1 + mask 1 written).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tally.cuh"

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

// The counter sync's rule for tally.cuh: base the decayed value, aux the
// new period, x the row's count.
struct SyncPolicy {
  struct Table {
    float* value;
    float* period;
    int32_t* last_ts;
    uint8_t* exists;
    int64_t n;
    float rate;
  };
  struct In {
    float value, period, count;
    int32_t last_ts;
    uint8_t exists;
  };
  struct Row {
    float base, aux, x;
    bool existed;
  };
  static constexpr bool kPadReadsSlot0 = true;
  static constexpr int64_t kSlotBytes = 13;  // its state's bytes

  static __device__ __forceinline__ In load(const Table& t,
                                            const int32_t* packed, int32_t b,
                                            int64_t i, int64_t g, bool) {
    return In{t.value[g], t.period[g],
              i >= 0 ? __int_as_float(packed[b + i]) : 0.0f, t.last_ts[g],
              t.exists[g]};
  }
  static __device__ __forceinline__ Row advance(const Table& t, const In& in,
                                                int32_t now) {
    const bool ex = in.exists != 0;
    const float delta = __int2float_rn(elapsed(now, ex ? in.last_ts : 0));
    return Row{ex ? fmaxf(__fsub_rn(in.value, __fmul_rn(delta, t.rate)),
                          0.0f)
                  : 0.0f,
               ex ? __fadd_rn(__fmul_rn(kKeep, in.period),
                              __fmul_rn(kAlpha, delta))
                  : delta,
               0.0f, ex};
  }
  static __device__ __forceinline__ Row decide(const Table& t, const In& in,
                                               int32_t b, int64_t i,
                                               bool valid, int32_t now,
                                               float* out) {
    Row r = advance(t, in, now);
    out[i] = __fadd_rn(r.base, in.count);
    out[b + i] = r.aux;
    r.x = valid ? in.count : 0.0f;
    return r;
  }
  static __device__ __forceinline__ void commit(const Table& t, int32_t s,
                                                float value, float aux,
                                                int32_t now, bool existed) {
    t.value[s] = value;
    t.period[s] = aux;
    t.last_ts[s] = now;
    if (!existed) t.exists[s] = 1;
  }
};

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

}  // namespace

// packed i32[3, B] (any int32 B), out f32[2, B]. Past 4096 rows: claim holds
// drl_tally_claim_words(N, B) zero int32 words, scratch
// drl_tally_scratch_bytes(N, B) bytes.
extern "C" int drl_sync_counters(float* value, float* period,
                                 int32_t* last_ts, uint8_t* exists, int64_t n,
                                 const int32_t* packed, int32_t b, float rate,
                                 float* out, void* claim, void* scratch,
                                 cudaStream_t stream) {
  const SyncPolicy::Table T{value, period, last_ts, exists, n, rate};
  return drl_tally::launch<SyncPolicy>(
      T, packed, b, out, static_cast<uint32_t*>(claim), scratch,
      stream);
}

extern "C" int64_t drl_tally_scratch_bytes(int64_t n, int32_t b) {
  return drl_tally::scratch_bytes<SyncPolicy>(n, b);
}

extern "C" int64_t drl_tally_claim_words(int64_t n, int32_t b) {
  return drl_tally::claim_words<SyncPolicy>(n, b);
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
