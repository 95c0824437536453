// Concurrency-semaphore batch and idle-slot sweep, for Hopper (sm_90a): one
// launch per call.
//
// Replaces (XLA programs of the JAX package, not Pallas kernels):
//   distributedratelimiting/redis_tpu/ops/kernels.py, sema_batch_packed
//     -> sema_kernel;
//   distributedratelimiting/redis_tpu/ops/kernels.py, sweep_semas
//     -> sweep_semas_kernel.
//
// State: active i32 (held permits), last_ts i32, exists u8 (9 B a slot).
//
// sema_kernel, per row i < B of packed i32[4, B] (row 0 slots, < 0 or >= N
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
// depend on the table, so the host cannot compute them: the kernel sorts
// the (slot, row) pairs once with a stable block radix sort and runs two
// int64 segmented scans over the sorted order (decide.cuh's Seg/SegSum), the
// second after the decision. Each slot's last row in sorted order (the
// segment tail) writes the slot once, with the segment's int64 sum: no
// atomics, and the result is deterministic. Sums of whole counts are exact
// (the plain version's duplicate_prefix sums in int64, JAX's in float32:
// the two agree below 2^24 of demand on one slot).
//
// Design: ONE block of 1024 threads holds the whole batch (B <= 4096, one to
// four rows a thread): the scalar lane's 8 rows and the bulk lane's chunks of
// 4096. All rows of a slot meet in the block, so no grid barrier is needed.
// Bound: a few operations a row and 9 B of state read and written per
// distinct slot, so bytes; at B <= 4096 that is well under a microsecond, and
// a call costs its launch, its sort and its barriers.
//
// sweep_semas_kernel, per slot i < N:
//   expired = exists && active <= 0 && max(0, now - last_ts) >= 86400 * 1024
//   exists[i] = exists && !expired   (IN PLACE)
//   mask[i] = expired; tile_counts[i / tile] += expired
// with the layout and contract of sweep.cu (256 consecutive slots a pass lie
// in one tile; the caller zeroes tile_counts). A slot that still holds
// permits is never swept. Bound: memory, 11 B a slot (active 4, last_ts 4,
// exists 1 read; exists 1, mask 1 written).

#include "decide.cuh"

namespace {

constexpr int kSweepThreads = 256;
// bucket_math.GLOBAL_COUNTER_TTL_TICKS: 86400 s at 1024 ticks a second.
constexpr int32_t kSemaTtlTicks = 86400 * 1024;

__device__ __forceinline__ int32_t elapsed(int32_t now, int32_t last) {
  return max((int32_t)((uint32_t)now - (uint32_t)last), 0);
}

template <int IPT>
struct SemaTypes {
  static constexpr int kRows = drl::kThreads * IPT;
  using Sort = cub::BlockRadixSort<uint32_t, drl::kThreads, IPT, uint16_t>;
  using Scan =
      cub::BlockScan<drl::Seg, drl::kThreads, cub::BLOCK_SCAN_WARP_SCANS>;
  union Temp {
    typename Sort::TempStorage sort;
    typename Scan::TempStorage scan;
  };
  static constexpr size_t kKeyOffset = drl::align16(sizeof(Temp));
  static constexpr size_t kSmem = kKeyOffset + 4 * (size_t)kRows;
};

template <int IPT>
__global__ void __launch_bounds__(drl::kThreads, 1)
    sema_kernel(int32_t* active, int32_t* last_ts, uint8_t* exists,
                int32_t n_slots, const int32_t* __restrict__ packed,
                int32_t b, int sort_bits, float* __restrict__ out) {
  using T = SemaTypes<IPT>;
  using Sort = typename T::Sort;
  using Scan = typename T::Scan;
  extern __shared__ __align__(16) unsigned char smem[];
  typename T::Temp& temp = *reinterpret_cast<typename T::Temp*>(smem);
  uint32_t* s_key = reinterpret_cast<uint32_t*>(smem + T::kKeyOffset);
  const int tid = threadIdx.x;
  const int32_t now = packed[3 * b];
  const uint32_t pad_key = (uint32_t)n_slots;  // sorts after every slot

  uint32_t key[IPT];
  uint16_t row[IPT];
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int r = tid * IPT + j;
    const int32_t s = r < b ? packed[r] : -1;
    key[j] = (s >= 0 && s < n_slots) ? (uint32_t)s : pad_key;
    row[j] = (uint16_t)r;
  }
  // Stable: rows of one slot keep request order within its segment.
  Sort(temp.sort).Sort(key, row, 0, sort_bits);
#pragma unroll
  for (int j = 0; j < IPT; ++j) s_key[tid * IPT + j] = key[j];
  __syncthreads();

  // 1. Gather each row's slot and scan the acquire demand.
  drl::Seg seg[IPT];
  bool valid[IPT], head[IPT];
  int32_t delta[IPT], old[IPT];
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int p = tid * IPT + j;
    const int r = row[j];
    valid[j] = key[j] != pad_key;
    head[j] = p == 0 || s_key[p - 1] != key[j];
    delta[j] = valid[j] ? packed[b + r] : 0;
    old[j] = 0;
    if (valid[j] && exists[key[j]] != 0) old[j] = active[key[j]];
    seg[j] = drl::Seg{valid[j] ? max(delta[j], 0) : 0, head[j] ? p : -1};
  }
  Scan(temp.scan).InclusiveScan(seg, seg, drl::SegSum());

  // 2. Decide; seg becomes the applied deltas for the second scan.
  bool ok[IPT];
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int p = tid * IPT + j;
    const int32_t acq = valid[j] ? max(delta[j], 0) : 0;
    const float pre = __ll2float_rn(seg[j].sum - acq);
    const float lim = __int2float_rn(valid[j] ? packed[2 * b + row[j]] : 0);
    const bool fits =
        __fadd_rn(__fadd_rn(__int2float_rn(old[j]), pre),
                  __int2float_rn(acq)) <= lim;
    ok[j] = valid[j] && (delta[j] < 0 || fits);
    seg[j] = drl::Seg{ok[j] ? delta[j] : 0, head[j] ? p : -1};
  }
  __syncthreads();  // the scan's temporary storage is used again
  Scan(temp.scan).InclusiveScan(seg, seg, drl::SegSum());

  // 3. Reply per row; each segment tail writes its slot once.
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int p = tid * IPT + j;
    const int r = row[j];
    const int32_t applied = ok[j] ? delta[j] : 0;
    if (r < b) {
      const float apre = __ll2float_rn(seg[j].sum - applied);
      out[r] = ok[j] ? 1.0f : 0.0f;
      out[b + r] =
          valid[j] ? fmaxf(__fadd_rn(__fadd_rn(__int2float_rn(old[j]), apre),
                                     __int2float_rn(applied)),
                           0.0f)
                   : 0.0f;
    }
    if (!valid[j]) continue;
    const bool tail = p == T::kRows - 1 || s_key[p + 1] != key[j];
    if (tail) {
      const long long v = (long long)old[j] + seg[j].sum;
      active[key[j]] = (int32_t)(v > 0 ? v : 0);
    }
    if (delta[j] != 0) {  // every such row writes the same values
      last_ts[key[j]] = now;
      exists[key[j]] = 1;
    }
  }
}

template <int IPT>
int launch_sema(int32_t* active, int32_t* last_ts, uint8_t* exists,
                int32_t n_slots, const int32_t* packed, int32_t b,
                int sort_bits, float* out, cudaStream_t stream) {
  using T = SemaTypes<IPT>;
  cudaError_t err = cudaFuncSetAttribute(
      sema_kernel<IPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::kSmem);
  if (err != cudaSuccess) return (int)err;
  sema_kernel<IPT><<<1, drl::kThreads, T::kSmem, stream>>>(
      active, last_ts, exists, n_slots, packed, b, sort_bits, out);
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
                               const int32_t* packed, int32_t b,
                               int32_t sort_bits, float* out,
                               cudaStream_t stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (b <= SemaTypes<1>::kRows)
    return launch_sema<1>(active, last_ts, exists, n_slots, packed, b,
                          sort_bits, out, stream);
  if (b <= SemaTypes<2>::kRows)
    return launch_sema<2>(active, last_ts, exists, n_slots, packed, b,
                          sort_bits, out, stream);
  if (b <= SemaTypes<4>::kRows)
    return launch_sema<4>(active, last_ts, exists, n_slots, packed, b,
                          sort_bits, out, stream);
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
