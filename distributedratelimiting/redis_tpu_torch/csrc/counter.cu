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
//   mask[i] = expired; tile_counts[t] = the expired slots of tile t
// with the contract of sweep.cu (tiles of 32,768 slots).
// Bound: memory, 7 B a slot (last_ts 4 + exists 1 read, exists 1 + mask 1
// written): 0.00219 ms at 2^20 counters on an H100's 3.35 TB/s.
//
// Design: ONE launch, no memset, no global atomics. A thread block cluster
// of 8 blocks owns one tile; each block 4,096 slots, each thread 16: its
// exists bytes in one 16-byte load, its last_ts in four, its mask bytes in
// one 16-byte store, and its exists word written back only where a slot
// expired. The warp sums its counts with __reduce_add_sync, the block
// through shared memory, and every block stores its sum into the cluster
// leader's shared memory (distributed shared memory); after the cluster's
// barrier the leader writes the tile's count with a plain store, so
// tile_counts needs no zeroing launch. The cluster's first barrier is split:
// every thread arrives (relaxed) before its loads and waits after them, so
// that the leader's shared memory is known to be live before it is written
// without stalling the loads. A thread whose 16 slots run past N (a tail
// of fewer than 16, a table smaller than a tile, a last partial tile), or
// pointers not 16-byte aligned, takes a scalar path over the same slots in
// the same kernel. A cluster of 8 blocks x 256 threads fits any GPC.
// Measured on an H100 (chip_smoke.py --sync-bench, 700 W), 2^20 counters,
// the whole function: 0.0032 ms of device time, 68% of the bound. A
// vectorised grid-stride kernel with one atomic a block takes 0.0023 alone
// but 0.0034 with the zeroing launch it needs, hence the cluster.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tally.cuh"

namespace {

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

// The sweep: a cluster of kSweepBlocks blocks a tile of kSweepTile slots,
// kSweepSlots slots a thread.
constexpr int kSweepThreads = 256;
constexpr int kSweepSlots = 16;
constexpr int kSweepBlocks = 8;
constexpr int64_t kSweepTile =
    (int64_t)kSweepBlocks * kSweepThreads * kSweepSlots;
static_assert(kSweepTile == 32768, "a cluster owns one TILE of slots");

__device__ __forceinline__ bool counter_expired(uint32_t ex, int32_t last,
                                                int32_t now) {
  return ex != 0 && elapsed(now, last) >= kCounterTtlTicks;
}

// The cluster barrier's two halves (PTX barrier.cluster): every thread of
// every block of the cluster arrives, then waits.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__global__ void __cluster_dims__(kSweepBlocks, 1, 1)
    __launch_bounds__(kSweepThreads)
    sweep_counters_kernel(const int32_t* __restrict__ last_ts,
                          uint8_t* exists, int8_t* __restrict__ mask,
                          int32_t* __restrict__ tile_counts, int64_t n,
                          int32_t now, int vec) {
  namespace cgr = cooperative_groups;
  __shared__ int32_t warp_sums[kSweepThreads / 32];
  __shared__ int32_t block_sums[kSweepBlocks];  // the leader's, a block each
  cluster_arrive_relaxed();  // this block runs (waited for below)
  cgr::cluster_group cluster = cgr::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int64_t tile = blockIdx.x / kSweepBlocks;
  const int64_t base = tile * kSweepTile +
                       ((int64_t)rank * kSweepThreads + threadIdx.x) *
                           kSweepSlots;
  int count = 0;
  if (vec && base + kSweepSlots <= n) {
    const uint4 ex = *reinterpret_cast<const uint4*>(exists + base);
    int4 ts[kSweepSlots / 4];
#pragma unroll
    for (int q = 0; q < kSweepSlots / 4; ++q) {
      ts[q] = reinterpret_cast<const int4*>(last_ts + base)[q];
    }
    const uint32_t exw[4] = {ex.x, ex.y, ex.z, ex.w};
    uint32_t mw[4], keep[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // Word q holds slots 4q..4q+3, a byte each (little-endian), as ts[q].
      const int32_t t[4] = {ts[q].x, ts[q].y, ts[q].z, ts[q].w};
      mw[q] = 0;
      keep[q] = exw[q];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (counter_expired((exw[q] >> (8 * j)) & 0xFFu, t[j], now)) {
          mw[q] |= 1u << (8 * j);
          keep[q] &= ~(0xFFu << (8 * j));
        }
      }
      count += __popc(mw[q]);
    }
    *reinterpret_cast<uint4*>(mask + base) =
        make_uint4(mw[0], mw[1], mw[2], mw[3]);
    if ((mw[0] | mw[1] | mw[2] | mw[3]) != 0) {
      *reinterpret_cast<uint4*>(exists + base) =
          make_uint4(keep[0], keep[1], keep[2], keep[3]);
    }
  } else {
    for (int j = 0; j < kSweepSlots; ++j) {
      const int64_t i = base + j;
      if (i >= n) break;
      const bool e = counter_expired(exists[i], last_ts[i], now);
      if (e) exists[i] = 0;
      mask[i] = (int8_t)e;
      count += e;
    }
  }
  count = __reduce_add_sync(0xFFFFFFFFu, count);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x / 32] = count;
  __syncthreads();
  cluster_wait();  // every block of the cluster runs: the leader's too
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kSweepThreads / 32; ++w) sum += warp_sums[w];
    cluster.map_shared_rank(block_sums, 0)[rank] = sum;
  }
  cluster.sync();  // the blocks' sums have landed in the leader's memory
  if (rank == 0 && threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int r = 0; r < kSweepBlocks; ++r) sum += block_sums[r];
    tile_counts[tile] = sum;
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

// tile_counts i32[ceil(N / tile)] is written whole (no zeroing needed);
// tile must be 32768.
extern "C" int drl_sweep_counters(const int32_t* last_ts, uint8_t* exists,
                                  int8_t* mask, int32_t* tile_counts,
                                  int64_t n, int32_t now, int64_t tile,
                                  cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (tile != kSweepTile) return (int)cudaErrorInvalidValue;
  const int64_t tiles = (n + kSweepTile - 1) / kSweepTile;
  const int vec = ((reinterpret_cast<uintptr_t>(last_ts) |
                    reinterpret_cast<uintptr_t>(exists) |
                    reinterpret_cast<uintptr_t>(mask)) &
                   15) == 0;
  sweep_counters_kernel<<<(unsigned)(tiles * kSweepBlocks), kSweepThreads, 0,
                          stream>>>(last_ts, exists, mask, tile_counts, n,
                                    now, vec);
  return (int)cudaGetLastError();
}
