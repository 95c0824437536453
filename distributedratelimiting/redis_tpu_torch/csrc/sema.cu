// Concurrency-semaphore batch and idle-slot sweep, for Hopper (sm_90a): one
// launch per call.
//
// Replaces (XLA programs of the JAX package, not Pallas kernels):
//   distributedratelimiting/redis_tpu/ops/kernels.py, sema_batch_packed
//     -> sema_warp_kernel (B <= 32) and sema_block_kernel;
//   distributedratelimiting/redis_tpu/ops/kernels.py, sweep_semas
//     -> sweep_semas_kernel.
//
// State: active i32 (held permits), last_ts i32, exists u8 (9 B a slot).
//
// sema_packed, per row i < B of packed i32[4, B] (row 0 slots, < 0 or >= N
// padding; row 1 signed deltas, +n acquire, -n release, 0 probe; row 2
// per-row limits; row 3 the tick, column 0 read):
//   old      = exists[s] ? active[s] : 0
//   acq      = max(delta, 0)
//   pre      = sum of acq over the earlier valid rows of the same slot
//   ok       = valid && (delta < 0 || (f32(old) + f32(pre)) + f32(acq)
//                                        <= f32(limit))
//   applied  = ok ? delta : 0
//   apre     = sum of applied over the earlier rows of the same slot
//   out[0][i] = ok; out[1][i] = valid ? max((f32(old) + f32(apre))
//                                           + f32(applied), 0) : 0
// and per valid slot: active = max(old + sum of applied, 0); where some row's
// delta != 0, last_ts = now and exists = 1 (a probe neither allocates nor
// refreshes). Untouched slots are not clamped: every write clamps, so no
// slot is ever negative (the JAX program clamps the whole table).
//
// The admission prefix counts every earlier acquire, granted or not (the
// conservative serialization of the bucket kernels); the reported count sums
// only the deltas that applied. Both depend on the rows' decisions, which
// depend on the table, so the host cannot compute them. Sums of whole
// counts are exact in int64 (the plain version's duplicate_prefix sums in
// int64, JAX's in float32: the two agree below 2^24 of demand on one slot).
// Each slot is written once, by one row, with the int64 sum of its applied
// deltas: no atomics, and the result is deterministic.
//
// Design (batch.cuh): a launch costs what its rows need.
//   - B <= 32 (the scalar lane, OP_SEMA, the hazard route): one warp.
//     __match_any_sync gives each row its same-slot peers; the two prefixes
//     are sums over the lower-lane peers, and the highest peer writes the
//     slot with the sum over all of them.
//   - 33 <= B <= 4096 (the bulk lane's chunks, padded to a power of two):
//     blocks sized by B; above 256 rows min(64, B / 64) of them, each
//     deciding the rows of its share of the slots (all rows of a slot meet
//     in one block, so no block waits for another). In a block a hash set
//     in shared memory finds the slots that repeat; without repeats (the
//     bulk lane's distinct keys) every row decides at once and writes its
//     slot. Otherwise the rows are sorted stably by the repeated slots'
//     compact ids (at most 12 bits, usually far fewer) and two int64
//     segmented scans run in that order, the second after the decision;
//     each segment's last row writes its slot.
// Bound: a few operations a row and 9 B of state read and written per
// distinct slot, so bytes; at B <= 4096 that is well under a microsecond,
// and a call costs its launch, its barriers and its scattered gathers and
// writes, which one SM issues at a few per cycle at best (hence the spread
// over blocks).
//
// sweep_semas_kernel, per slot i < N:
//   expired = exists && active <= 0 && max(0, now - last_ts) >= 86400 * 1024
//   exists[i] = exists && !expired   (IN PLACE)
//   mask[i] = expired; tile_counts[i / tile] += expired
// with the layout and contract of sweep.cu (256 consecutive slots a pass lie
// in one tile; the caller zeroes tile_counts). A slot that still holds
// permits is never swept. Bound: memory, 11 B a slot (active 4, last_ts 4,
// exists 1 read; exists 1, mask 1 written).

#include "batch.cuh"

namespace {

using drl::kEmptyKey;
using drl::kFullMask;

constexpr int kSweepThreads = 256;
// bucket_math.GLOBAL_COUNTER_TTL_TICKS: 86400 s at 1024 ticks a second.
constexpr int32_t kSemaTtlTicks = 86400 * 1024;

__device__ __forceinline__ int32_t elapsed(int32_t now, int32_t last) {
  return max((int32_t)((uint32_t)now - (uint32_t)last), 0);
}

// One row's decision from its slot's held count and its int64 prefix of
// earlier same-slot acquire demand.
__device__ __forceinline__ bool sema_ok(bool valid, int32_t delta,
                                        int32_t limit, int32_t old,
                                        long long pre) {
  const int32_t acq = max(delta, 0);
  const bool fits = __fadd_rn(__fadd_rn(__int2float_rn(old),
                                        __ll2float_rn(pre)),
                              __int2float_rn(acq)) <= __int2float_rn(limit);
  return valid && (delta < 0 || fits);
}

// The row's post-op count: old + the earlier applied deltas + its own.
__device__ __forceinline__ float sema_after(int32_t old, long long apre,
                                            int32_t applied) {
  return fmaxf(__fadd_rn(__fadd_rn(__int2float_rn(old), __ll2float_rn(apre)),
                         __int2float_rn(applied)),
               0.0f);
}

__device__ __forceinline__ int32_t clamp_held(long long v) {
  return (int32_t)(v > 0 ? v : 0);
}

// B <= 32: row = lane.
__global__ void __launch_bounds__(32, 1)
    sema_warp_kernel(int32_t* active, int32_t* last_ts, uint8_t* exists,
                     int32_t n_slots, const int32_t* __restrict__ packed,
                     int32_t b, float* __restrict__ out) {
  const int lane = threadIdx.x;
  const int32_t now = packed[3 * b];
  const int32_t s = lane < b ? packed[lane] : -1;
  const bool valid = s >= 0 && s < n_slots;
  const int32_t delta = valid ? packed[b + lane] : 0;
  const int32_t limit = valid ? packed[2 * b + lane] : 0;
  const int32_t old = valid && exists[s] != 0 ? active[s] : 0;
  const unsigned me = 1u << lane;
  const unsigned peers =
      __match_any_sync(kFullMask, valid ? (uint32_t)s : kEmptyKey);
  const bool alone = __all_sync(kFullMask, !valid || peers == me);
  long long pre = 0, unused = 0;
  if (!alone) {
    drl_batch::lane_sums(peers & (me - 1), 0, valid ? max(delta, 0) : 0, b,
                         pre, unused);
  }
  const bool ok = sema_ok(valid, delta, limit, old, pre);
  const int32_t applied = ok ? delta : 0;
  long long apre = 0, total = applied;
  if (!alone) {
    drl_batch::lane_sums(peers & (me - 1), peers, applied, b, apre, total);
  }
  if (lane < b) {
    out[lane] = ok ? 1.0f : 0.0f;
    out[b + lane] = valid ? sema_after(old, apre, applied) : 0.0f;
  }
  __syncwarp();  // every row has read its slot
  if (!valid) return;
  if (lane == 31 - __clz(peers)) {
    active[s] = clamp_held((long long)old + total);
  }
  if (delta != 0) {  // every such row writes the same values
    last_ts[s] = now;
    exists[s] = 1;
  }
}

// 33 <= B <= kT x kIpt, on G blocks: each decides the rows of its share of
// the slots (batch.cuh's own_rows), position i = threadIdx.x * kIpt + j of
// its m rows in request order.
template <int kT, int kIpt>
__global__ void __launch_bounds__(kT, 1)
    sema_block_kernel(int32_t* active, int32_t* last_ts, uint8_t* exists,
                      int32_t n_slots, const int32_t* __restrict__ packed,
                      int32_t b, float* __restrict__ out) {
  using Blk = drl_batch::Block<kT, kIpt>;
  extern __shared__ __align__(16) unsigned char smem[];
  typename Blk::Shared& sh = *reinterpret_cast<typename Blk::Shared*>(smem);
  const int tid = threadIdx.x;
  const bool all = gridDim.x == 1;
  const int32_t now = packed[3 * b];
  auto slot_key = [&](int r) {
    const int32_t s = r < b ? packed[r] : -1;
    return s >= 0 && s < n_slots ? (uint32_t)s : kEmptyKey;
  };
  uint32_t key[kIpt];
  if (!all) {
#pragma unroll
    for (int j = 0; j < kIpt; ++j) key[j] = slot_key(tid * kIpt + j);
  }
  const int m =
      drl_batch::own_rows<kT, kIpt>(sh.temp.count, sh.sub, b, all, key);
  if (m == 0) return;  // none of the batch's slots is this block's
  auto row_at = [&](int i) { return i >= m ? b : all ? i : (int)sh.sub[i]; };

  // 1. Each row's slot and state (the gathers in flight while the set
  //    fills), then the slots that repeat.
  int32_t delta[kIpt], limit[kIpt], old[kIpt];
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    const int r = row_at(tid * kIpt + j);
    key[j] = slot_key(r);
    const bool valid = key[j] != kEmptyKey;
    delta[j] = valid ? packed[b + r] : 0;
    limit[j] = valid ? packed[2 * b + r] : 0;
    old[j] = valid && exists[key[j]] != 0 ? active[key[j]] : 0;
  }
  int32_t rep[kIpt];
  const int n_rep = drl_batch::find_repeats<kT, kIpt>(sh, m, key, rep);

  if (n_rep == 0) {  // 2a. No slot repeats: every row alone, prefix 0.
#pragma unroll
    for (int j = 0; j < kIpt; ++j) {
      const int r = row_at(tid * kIpt + j);
      const bool valid = key[j] != kEmptyKey;
      const bool ok = sema_ok(valid, delta[j], limit[j], old[j], 0);
      const int32_t applied = ok ? delta[j] : 0;
      if (r < b) {
        out[r] = ok ? 1.0f : 0.0f;
        out[b + r] = valid ? sema_after(old[j], 0, applied) : 0.0f;
      }
      if (!valid) continue;
      active[key[j]] = clamp_held((long long)old[j] + applied);
      if (delta[j] != 0) {
        last_ts[key[j]] = now;
        exists[key[j]] = 1;
      }
    }
    return;
  }

  // 2b. Positions sorted by repeated slot; per segment two int64 scans,
  //     the acquire demand, then (after the decision) the applied deltas.
  using Scan = typename Blk::Scan;
  uint32_t k[kIpt];
  uint16_t pos[kIpt];
  bool head[kIpt];
  drl_batch::sort_repeats<kT, kIpt>(sh, rep, n_rep, k, pos, head);
  int32_t r[kIpt], s[kIpt];
  drl::Seg seg[kIpt];
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    const int p = tid * kIpt + j;
    r[j] = row_at(pos[j]);
    const uint32_t key_r = slot_key(r[j]);
    const bool valid = key_r != kEmptyKey;
    s[j] = valid ? (int32_t)key_r : -1;
    delta[j] = valid ? packed[b + r[j]] : 0;
    limit[j] = valid ? packed[2 * b + r[j]] : 0;
    old[j] = valid && exists[s[j]] != 0 ? active[s[j]] : 0;
    seg[j] = drl::Seg{max(delta[j], 0), head[j] ? p : -1};
  }
  Scan(sh.temp.scan).InclusiveScan(seg, seg, drl::SegSum());
  bool ok[kIpt];
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    const int p = tid * kIpt + j;
    ok[j] = sema_ok(s[j] >= 0, delta[j], limit[j], old[j],
                    seg[j].sum - max(delta[j], 0));
    seg[j] = drl::Seg{ok[j] ? delta[j] : 0, head[j] ? p : -1};
  }
  __syncthreads();  // the scan's storage is used again
  Scan(sh.temp.scan).InclusiveScan(seg, seg, drl::SegSum());

  // 3. Reply per row; each segment's last row writes its slot once.
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    const int p = tid * kIpt + j;
    const int32_t applied = ok[j] ? delta[j] : 0;
    if (r[j] < b) {
      out[r[j]] = ok[j] ? 1.0f : 0.0f;
      out[b + r[j]] =
          s[j] >= 0 ? sema_after(old[j], seg[j].sum - applied, applied) : 0.0f;
    }
    if (s[j] < 0) continue;
    if (drl_batch::segment_tail<kT, kIpt>(sh, sh.key, k[j], n_rep, p)) {
      active[s[j]] = clamp_held((long long)old[j] + seg[j].sum);
    }
    if (delta[j] != 0) {
      last_ts[s[j]] = now;
      exists[s[j]] = 1;
    }
  }
}

template <int kT, int kIpt>
int launch_sema(int32_t* active, int32_t* last_ts, uint8_t* exists,
                int32_t n_slots, const int32_t* packed, int32_t b,
                float* out, cudaStream_t stream) {
  constexpr size_t kSmem =
      sizeof(typename drl_batch::Block<kT, kIpt>::Shared);
  static_assert(kSmem <= 232448, "fits in an SM's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      sema_block_kernel<kT, kIpt>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int grid = drl_batch::launch_blocks(b);
  sema_block_kernel<kT, kIpt><<<grid, kT, kSmem, stream>>>(
      active, last_ts, exists, n_slots, packed, b, out);
  return (int)cudaGetLastError();
}

__global__ void sweep_semas_kernel(const int32_t* active,
                                   const int32_t* last_ts, uint8_t* exists,
                                   int8_t* mask, int32_t* tile_counts,
                                   int64_t n, int32_t now, int64_t tile) {
  const int64_t stride = (int64_t)gridDim.x * kSweepThreads;
  for (int64_t base = (int64_t)blockIdx.x * kSweepThreads; base < n;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    int expired = 0;
    if (i < n) {
      expired = exists[i] != 0 && active[i] <= 0 &&
                elapsed(now, last_ts[i]) >= kSemaTtlTicks;
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

// packed i32[4, B], B <= 4096; out f32[2, B].
extern "C" int drl_sema_packed(int32_t* active, int32_t* last_ts,
                               uint8_t* exists, int32_t n_slots,
                               const int32_t* packed, int32_t b, float* out,
                               cudaStream_t stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (b <= drl_batch::kWarpRows) {
    sema_warp_kernel<<<1, 32, 0, stream>>>(active, last_ts, exists, n_slots,
                                           packed, b, out);
    return (int)cudaGetLastError();
  }
  if (b <= 64)
    return launch_sema<64, 1>(active, last_ts, exists, n_slots, packed, b,
                              out, stream);
  if (b <= 256)
    return launch_sema<256, 1>(active, last_ts, exists, n_slots, packed, b,
                               out, stream);
  if (b <= 1024)
    return launch_sema<1024, 1>(active, last_ts, exists, n_slots, packed, b,
                                out, stream);
  if (b <= 2048)
    return launch_sema<1024, 2>(active, last_ts, exists, n_slots, packed, b,
                                out, stream);
  if (b <= 4096)
    return launch_sema<1024, 4>(active, last_ts, exists, n_slots, packed, b,
                                out, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int drl_sweep_semas(const int32_t* active, const int32_t* last_ts,
                               uint8_t* exists, int8_t* mask,
                               int32_t* tile_counts, int64_t n, int32_t now,
                               int64_t tile, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  int64_t blocks = (n + kSweepThreads - 1) / kSweepThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  sweep_semas_kernel<<<(unsigned)blocks, kSweepThreads, 0, stream>>>(
      active, last_ts, exists, mask, tile_counts, n, now, tile);
  return (int)cudaGetLastError();
}
