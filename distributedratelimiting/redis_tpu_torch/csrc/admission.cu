// Two-level (tenant -> key) admission and the saturating bulk debit, for
// Hopper (sm_90a): one launch per call.
//
// Replaces (XLA programs of the JAX package, not Pallas kernels):
//   distributedratelimiting/redis_tpu/ops/kernels.py,
//     acquire_hierarchical_packed -> hier_kernel;
//   distributedratelimiting/redis_tpu/ops/kernels.py, debit_batch_packed
//     -> debit_kernel.
//
// Both work on the token bucket's SoA table (tokens f32, last_ts i32, exists
// u8: 9 B a slot) and advance a slot with bucket.cuh's refill_or_init, the
// bucket kernels' own rounding.
//
// hier_kernel, per row i < B of packed i32[4, B] (row 0 child slots, row 1
// costs, row 2 the tick, column 0 read, row 3 parent slots; a row is valid
// only where BOTH slots lie in their tables, else it is padding):
//   c_ref, p_ref = the refilled child and parent buckets
//   c_pre = earlier valid rows' costs on the same child slot
//   child_ok = valid && c_ref >= c_pre + cost
//   p_pre = earlier valid rows' costs on the same parent slot, counting only
//           rows the child admitted
//   granted = child_ok && p_ref >= p_pre + cost
//   consumed = granted ? cost : 0
//   out[0][i] = granted
//   out[1][i] = valid ? min(max((c_ref - c_pre) - consumed, 0),
//                           max((p_ref - p_pre) - consumed, 0)) : 0
// and each valid row's child and parent slot: tokens = ref - the sum of the
// slot's granted consumption, last_ts = now, exists = 1 (both levels debit
// together or not at all; both timestamps advance either way).
// The parent prefix depends on the child decisions, which depend on the
// table, so the host cannot compute it: the kernel sorts the (child slot,
// row) pairs, scans the costs (int64, segmented: decide.cuh's Seg/SegSum),
// decides the child level, then sorts the (parent slot, row) pairs and
// scans the child-admitted costs. Each prefix lands in shared memory by row.
// The state is written as the flush writes it: every row sets its slots'
// refilled value (duplicates write the same), a barrier, then atomicAdd of
// the consumption, so tokens may differ from a serial sum by float rounding
// (grants never do). ONE block of 1024 threads holds the batch (B <= 4096:
// the store's max_batch on the card), so no grid barrier is needed. In the
// LLM workload 64 Zipf(1.2) tenants share a chunk of 4096 rows: the parent
// segments are long, and the segmented scan costs the same for any length.
// Bound: bytes (the 16 B operand row and 8 B reply, 18 B per distinct slot
// of either table); at B = 4096 well under a microsecond, so a call costs
// its launch, its two sorts and its barriers.
//
// debit_kernel, per row i < B of packed i32[4, B] (row 0 slots, row 1 the
// float32 amounts bitcast, row 2 the tick, row 3 the float32 same-slot
// prefix of earlier amounts bitcast, computed on the host):
//   ref = refill_or_init(slot); avail = max(ref - pre, 0)
//   applied = min(amount, avail)   (a negative amount credits)
//   out[0][i] = avail - applied; out[1][i] = amount - applied   (valid rows)
// and per valid row, in this order across the whole grid: 1. tokens = ref,
// last_ts = now, exists = 1; 2. tokens += -applied. The debit is one launch
// for all n rows (1M at full size), so a slot's rows may lie in different
// blocks: as counter.cu's sync, the kernel is one cooperative launch with
// grid.sync() between reading the state, setting it, and adding, and the
// grid sized so that every block is resident. With distinct slots every
// result equals the plain version bit for bit; where a slot repeats, the
// atomics add in no fixed order. Bound: memory; a row moves its 16 B operand
// and 8 B reply, and each distinct slot reads and writes its 9 B.
// No state pointer is const __restrict__ or read through __ldg: the kernels
// write what they read.

#include <cooperative_groups.h>

#include "bucket.cuh"
#include "decide.cuh"

namespace cg = cooperative_groups;

namespace {

using drl_bucket::refill_or_init;

template <int IPT>
struct HierTypes {
  static constexpr int kRows = drl::kThreads * IPT;
  using Sort = cub::BlockRadixSort<uint32_t, drl::kThreads, IPT, uint16_t>;
  using Scan =
      cub::BlockScan<drl::Seg, drl::kThreads, cub::BLOCK_SCAN_WARP_SCANS>;
  union Temp {
    typename Sort::TempStorage sort;
    typename Scan::TempStorage scan;
  };
  // Shared memory: the temporary storage, then by sorted position the keys,
  // and by row the child prefix, the parent prefix and the parent demand.
  static constexpr size_t kKey = drl::align16(sizeof(Temp));
  static constexpr size_t kCpre = kKey + 4 * (size_t)kRows;
  static constexpr size_t kPpre = kCpre + 4 * (size_t)kRows;
  static constexpr size_t kPdem = kPpre + 4 * (size_t)kRows;
  static constexpr size_t kSmem = kPdem + 4 * (size_t)kRows;
};

struct Table {
  float* tokens;
  int32_t* last_ts;
  uint8_t* exists;
  int32_t n;
  float cap;
  float rate;
};

// Sort the rows' (key, row) pairs and write each row's exclusive same-key
// prefix of `demand` (by row, in shared memory; int64 sums converted to
// float32). `demand(row)` is read only for valid rows.
template <int IPT, class Demand>
__device__ __forceinline__ void row_prefix(typename HierTypes<IPT>::Temp& temp,
                                           uint32_t* s_key, float* s_pre,
                                           uint32_t (&key)[IPT],
                                           uint32_t pad_key, int sort_bits,
                                           Demand demand) {
  using T = HierTypes<IPT>;
  using Sort = typename T::Sort;
  using Scan = typename T::Scan;
  const int tid = threadIdx.x;
  uint16_t row[IPT];
#pragma unroll
  for (int j = 0; j < IPT; ++j) row[j] = (uint16_t)(tid * IPT + j);
  __syncthreads();  // the temporary storage and s_key are free
  Sort(temp.sort).Sort(key, row, 0, sort_bits);
#pragma unroll
  for (int j = 0; j < IPT; ++j) s_key[tid * IPT + j] = key[j];
  __syncthreads();
  drl::Seg seg[IPT];
  int32_t d[IPT];
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int p = tid * IPT + j;
    const bool head = p == 0 || s_key[p - 1] != key[j];
    d[j] = key[j] != pad_key ? demand(row[j]) : 0;
    seg[j] = drl::Seg{d[j], head ? p : -1};
  }
  __syncthreads();  // the sort's temporary storage is used again
  Scan(temp.scan).InclusiveScan(seg, seg, drl::SegSum());
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    s_pre[row[j]] = __ll2float_rn(seg[j].sum - d[j]);
  }
  __syncthreads();
}

template <int IPT>
__global__ void __launch_bounds__(drl::kThreads, 1)
    hier_kernel(Table C, Table P, const int32_t* __restrict__ packed,
                int32_t b, int c_bits, int p_bits, float* __restrict__ out) {
  using T = HierTypes<IPT>;
  extern __shared__ __align__(16) unsigned char smem[];
  typename T::Temp& temp = *reinterpret_cast<typename T::Temp*>(smem);
  uint32_t* s_key = reinterpret_cast<uint32_t*>(smem + T::kKey);
  float* s_cpre = reinterpret_cast<float*>(smem + T::kCpre);
  float* s_ppre = reinterpret_cast<float*>(smem + T::kPpre);
  int32_t* s_pdem = reinterpret_cast<int32_t*>(smem + T::kPdem);
  const int tid = threadIdx.x;
  const int32_t now = packed[2 * b];

  // Rows tid * IPT + j, in request order.
  int32_t cs[IPT], ps[IPT], cnt[IPT];
  bool valid[IPT];
  uint32_t key[IPT];
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int r = tid * IPT + j;
    cs[j] = r < b ? packed[r] : -1;
    ps[j] = r < b ? packed[3 * b + r] : -1;
    cnt[j] = r < b ? packed[b + r] : 0;
    valid[j] = cs[j] >= 0 && cs[j] < C.n && ps[j] >= 0 && ps[j] < P.n;
    key[j] = valid[j] ? (uint32_t)cs[j] : (uint32_t)C.n;
  }
  // 1. Child prefix over every earlier same-key row.
  row_prefix<IPT>(temp, s_key, s_cpre, key, (uint32_t)C.n, c_bits,
                  [&](int r) { return packed[b + r]; });

  // 2. Refill both levels (every read of the state happens before the first
  //    write, which follows the parent scan's barriers) and decide the child.
  float c_ref[IPT], p_ref[IPT], c_pre[IPT];
  bool child_ok[IPT];
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    c_ref[j] = p_ref[j] = 0.0f;
    if (valid[j]) {
      c_ref[j] = refill_or_init(C.tokens[cs[j]], C.last_ts[cs[j]],
                                C.exists[cs[j]], now, C.cap, C.rate);
      p_ref[j] = refill_or_init(P.tokens[ps[j]], P.last_ts[ps[j]],
                                P.exists[ps[j]], now, P.cap, P.rate);
    }
    c_pre[j] = s_cpre[tid * IPT + j];
    const float c = __int2float_rn(cnt[j]);
    child_ok[j] = valid[j] && c_ref[j] >= __fadd_rn(c_pre[j], c);
    s_pdem[tid * IPT + j] = child_ok[j] ? cnt[j] : 0;
    key[j] = valid[j] ? (uint32_t)ps[j] : (uint32_t)P.n;
  }
  // 3. Parent prefix over the earlier same-tenant rows the child admitted.
  row_prefix<IPT>(temp, s_key, s_ppre, key, (uint32_t)P.n, p_bits,
                  [&](int r) { return s_pdem[r]; });

  // 4. Decide, reply, and set both slots' refilled state.
  float consumed[IPT];
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int r = tid * IPT + j;
    const float c = __int2float_rn(cnt[j]);
    const float p_pre = s_ppre[r];
    const bool granted = child_ok[j] && p_ref[j] >= __fadd_rn(p_pre, c);
    consumed[j] = granted ? c : 0.0f;
    if (r < b) {
      const float c_rem =
          fmaxf(__fsub_rn(__fsub_rn(c_ref[j], c_pre[j]), consumed[j]), 0.0f);
      const float p_rem =
          fmaxf(__fsub_rn(__fsub_rn(p_ref[j], p_pre), consumed[j]), 0.0f);
      out[r] = granted ? 1.0f : 0.0f;
      out[b + r] = valid[j] ? fminf(c_rem, p_rem) : 0.0f;
    }
    if (valid[j]) {
      C.tokens[cs[j]] = c_ref[j];
      C.last_ts[cs[j]] = now;
      C.exists[cs[j]] = 1;
      P.tokens[ps[j]] = p_ref[j];
      P.last_ts[ps[j]] = now;
      P.exists[ps[j]] = 1;
    }
  }
  __syncthreads();  // every duplicate has set the same refilled state
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    if (valid[j] && consumed[j] != 0.0f) {
      atomicAdd(&C.tokens[cs[j]], -consumed[j]);
      atomicAdd(&P.tokens[ps[j]], -consumed[j]);
    }
  }
}

template <int IPT>
int launch_hier(const Table& C, const Table& P, const int32_t* packed,
                int32_t b, int c_bits, int p_bits, float* out,
                cudaStream_t stream) {
  using T = HierTypes<IPT>;
  cudaError_t err = cudaFuncSetAttribute(
      hier_kernel<IPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::kSmem);
  if (err != cudaSuccess) return (int)err;
  hier_kernel<IPT><<<1, drl::kThreads, T::kSmem, stream>>>(
      C, P, packed, b, c_bits, p_bits, out);
  return (int)cudaGetLastError();
}

constexpr int kDebitThreads = 256;

__global__ void debit_kernel(float* tokens, int32_t* last_ts,
                             uint8_t* exists, int64_t n,
                             const int32_t* packed, int32_t b, float cap,
                             float rate, float* out) {
  cg::grid_group grid = cg::this_grid();
  const int32_t now = packed[2 * (int64_t)b];  // row 2, column 0
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;

  // Phase 1: read the state, stage the refilled balance in out[0].
  for (int64_t i = first; i < b; i += stride) {
    const int32_t s = packed[i];
    if (s >= 0 && s < n) {
      out[i] = refill_or_init(tokens[s], last_ts[s], exists[s], now, cap,
                              rate);
    }
  }
  grid.sync();

  // Phase 2: every valid row sets its slot (duplicates write equal values).
  for (int64_t i = first; i < b; i += stride) {
    const int32_t s = packed[i];
    if (s >= 0 && s < n) {
      tokens[s] = out[i];
      last_ts[s] = now;
      exists[s] = 1;
    }
  }
  grid.sync();

  // Phase 3: subtract what applied, and reply.
  for (int64_t i = first; i < b; i += stride) {
    const int32_t s = packed[i];
    if (s < 0 || s >= n) {
      out[i] = 0.0f;
      out[b + i] = 0.0f;
      continue;
    }
    const float amount = __int_as_float(packed[b + i]);
    const float pre = __int_as_float(packed[3 * (int64_t)b + i]);
    const float avail = fmaxf(__fsub_rn(out[i], pre), 0.0f);
    const float applied = fminf(amount, avail);
    out[i] = __fsub_rn(avail, applied);
    out[b + i] = __fsub_rn(amount, applied);
    if (applied != 0.0f) atomicAdd(&tokens[s], -applied);
  }
}

// Resident blocks of debit_kernel on the current device (a cooperative grid
// may hold no more), cached per device.
int debit_grid_limit(int* limit) {
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, debit_kernel,
                                                      kDebitThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *limit = sms * per_sm;
  if (dev < 64) cached[dev] = *limit;
  return 0;
}

}  // namespace

// packed i32[4, B], B <= 4096; out f32[2, B].
extern "C" int drl_acquire_hierarchical(
    float* c_tokens, int32_t* c_last_ts, uint8_t* c_exists, int32_t c_n,
    float c_cap, float c_rate, float* p_tokens, int32_t* p_last_ts,
    uint8_t* p_exists, int32_t p_n, float p_cap, float p_rate,
    const int32_t* packed, int32_t b, int32_t c_bits, int32_t p_bits,
    float* out, cudaStream_t stream) {
  if (b <= 0) return (int)cudaSuccess;
  const Table C{c_tokens, c_last_ts, c_exists, c_n, c_cap, c_rate};
  const Table P{p_tokens, p_last_ts, p_exists, p_n, p_cap, p_rate};
  if (b <= HierTypes<1>::kRows)
    return launch_hier<1>(C, P, packed, b, c_bits, p_bits, out, stream);
  if (b <= HierTypes<2>::kRows)
    return launch_hier<2>(C, P, packed, b, c_bits, p_bits, out, stream);
  if (b <= HierTypes<4>::kRows)
    return launch_hier<4>(C, P, packed, b, c_bits, p_bits, out, stream);
  return (int)cudaErrorInvalidValue;
}

// packed i32[4, B] (any B); out f32[2, B].
extern "C" int drl_debit_packed(float* tokens, int32_t* last_ts,
                                uint8_t* exists, int64_t n,
                                const int32_t* packed, int32_t b, float cap,
                                float rate, float* out, cudaStream_t stream) {
  if (b <= 0) return (int)cudaSuccess;
  int limit = 0;
  const int rc = debit_grid_limit(&limit);
  if (rc != 0) return rc;
  if (limit <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  int64_t blocks = ((int64_t)b + kDebitThreads - 1) / kDebitThreads;
  if (blocks > limit) blocks = limit;
  void* args[] = {&tokens, &last_ts, &exists, &n, (void*)&packed,
                  &b, &cap, &rate, &out};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)debit_kernel, dim3((unsigned)blocks), dim3(kDebitThreads),
      args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
