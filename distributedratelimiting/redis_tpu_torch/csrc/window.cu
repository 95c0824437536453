// Sliding- and fixed-window acquire decisions and the window TTL sweep, for
// Hopper (sm_90a): one launch per call.
//
// Replaces, in distributedratelimiting/redis_tpu/ops/kernels.py (XLA
// programs on the TPU, not Pallas):
//   drl_window_packed  <- window_acquire_batch_packed (one serving flush);
//   drl_window_grouped <- window_acquire_batch_packed_grouped (coalesced
//                         flush);
//   drl_window_scan    <- window_acquire_scan_fused_packed /
//                         window_acquire_scan_fused_bits (fused u8[K, B, 5]
//                         operand), window_acquire_scan (i32[2, K, B], for
//                         counts above 255) and window_acquire_scan_compact:
//                         the window bulk lane's K batches decided in order;
//   drl_sweep_windows  <- sweep_windows.
//
// The three decision kernels are decide.cuh's, shared with the token bucket
// (acquire.cu): this file holds the window's rule for one slot
// (WindowPolicy), the sweep and the entry points. `interpolate` is a runtime
// argument: 1 for the sliding window, 0 for the fixed window (the estimate is
// the current window's count alone).
//
// The rule, per slot (state prev f32, curr f32, idx i32, exists u8: 13 B),
// as the JAX package's bucket_math.sliding_window_* compute it:
//   idx_now = floor(now / W)                 (a floor, not C's truncation)
//   base    = exists ? idx : idx_now
//   idx'    = max(idx_now, base)             (the clock-regression clamp)
//   steps   = idx' - base                    (int32, wrapping)
//   prev'   = !exists ? 0 : steps == 0 ? prev : steps == 1 ? curr : 0
//   curr'   = !exists ? 0 : steps == 0 ? curr : 0
//   rem     = now - idx' * W                 (int32, wrapping)
//   frac    = clip(f32(rem) / f32(W), 0, 1)  (an IEEE division)
//   est     = interpolate ? curr' + prev' * (1 - frac) : curr'
// A request for c after an earlier same-slot demand pre is granted iff
// (est + pre) + c <= limit; remaining = max(((limit - est) - pre) - consumed,
// 0); the grouped rule's avail is (limit - est) - pre. A grant adds its count
// to curr'. XLA's int32 arithmetic wraps, and signed overflow in C++ is
// undefined, so the products and differences of indices go through uint32.
// Every product, sum and quotient rounds on its own (the _rn intrinsics, and
// -fmad=false), so the kernels equal the plain PyTorch version bit for bit;
// XLA on the CPU contracts curr' + prev' * (1 - frac) into one fused
// multiply-add, which the port does not.
//
// Bound: bytes. A flush row moves its 16 B operand and 8 B result, and each
// distinct slot reads its 13 B of state and writes 13 B (26 B); a scan row
// moves 5 B of operand and 8 B (or 1/8 B, verdict-only) of result, plus the
// 26 B per distinct slot; ~30 operations a row, far below the card's
// operations-per-byte balance. As for buckets, the flushes are latency-bound
// (the dependent chain gather -> decide -> write, in a warp up to 32 rows and
// in blocks sized by the rows above); the scan
// decides the chunk slot-major on every SM, gathers and commits each distinct
// slot once per chunk, and sorts only the rows of slots that repeat
// (decide.cuh).
//
// sweep_windows_kernel, per slot i < N:
//   expired = exists && (int32)(idx_now - idx[i]) >= 2   (wrapping)
//   exists[i] = exists && !expired   (IN PLACE)
//   mask[i] = expired; tile_counts[i / tile] += expired
// with idx_now = floor(now / W) from the host, and the layout and contract of
// sweep.cu (256 consecutive slots a pass lie in one tile; the caller zeroes
// tile_counts). Bound: memory, 7 B a slot (idx 4 + exists 1 read, exists 1 +
// mask 1 written), so the least time is 7 N / 3.35 TB/s; one thread a slot,
// a grid-stride loop, one atomicAdd a block pass.

#include "decide.cuh"

// A named namespace: the policy is a template argument of the kernels.
namespace drl_window {

// floor(a / b) for b > 0.
__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {
  const int32_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

struct WindowPolicy {
  struct Table {
    float* prev;
    float* curr;
    int32_t* idx;
    uint8_t* exists;
  };
  struct Params {
    float limit;
    int32_t window;       // window_ticks, >= 1
    int32_t interpolate;  // 1: sliding window, 0: fixed window
  };
  struct Old {
    float prev, curr;
    int32_t idx;
    uint8_t exists;
  };
  struct Slot {  // advanced to the batch tick
    float prev, curr;
    int32_t idx;
  };

  static __device__ __forceinline__ Old gather(const Table& t, int32_t s) {
    return Old{t.prev[s], t.curr[s], t.idx[s], t.exists[s]};
  }
  static __device__ __forceinline__ Slot advance(const Old& o, int32_t now,
                                                 const Params& p) {
    const int32_t idx_now = floor_div(now, p.window);
    const int32_t base = o.exists ? o.idx : idx_now;
    const int32_t idx = max(idx_now, base);
    const int32_t steps = (int32_t)((uint32_t)idx - (uint32_t)base);
    Slot s{0.0f, 0.0f, idx};
    if (o.exists && steps == 0) {
      s.prev = o.prev;
      s.curr = o.curr;
    } else if (o.exists && steps == 1) {
      s.prev = o.curr;
    }
    return s;
  }
  static __device__ __forceinline__ float estimate(const Slot& s, int32_t now,
                                                   const Params& p) {
    if (!p.interpolate) return s.curr;
    const int32_t rem =
        (int32_t)((uint32_t)now - (uint32_t)s.idx * (uint32_t)p.window);
    float frac = __fdiv_rn(__int2float_rn(rem), __int2float_rn(p.window));
    frac = fminf(fmaxf(frac, 0.0f), 1.0f);
    return __fadd_rn(s.curr, __fmul_rn(s.prev, __fsub_rn(1.0f, frac)));
  }
  static __device__ __forceinline__ float room(const Slot& s, int32_t now,
                                               const Params& p) {
    return __fsub_rn(p.limit, estimate(s, now, p));
  }
  static __device__ __forceinline__ bool fits(const Slot& s, int32_t now,
                                              const Params& p, float pre,
                                              float c) {
    return __fadd_rn(__fadd_rn(estimate(s, now, p), pre), c) <= p.limit;
  }
  static __device__ __forceinline__ void commit(const Table& t, int32_t i,
                                                const Slot& s, int32_t now,
                                                long long consumed) {
    const Old o = carry(s, now, consumed);
    t.prev[i] = o.prev;
    t.curr[i] = o.curr;
    t.idx[i] = o.idx;
    t.exists[i] = o.exists;
  }
  static __device__ __forceinline__ Old carry(const Slot& s, int32_t,
                                              long long consumed) {
    return Old{s.prev, __fadd_rn(s.curr, __ll2float_rn(consumed)), s.idx, 1};
  }
};

constexpr int kSweepThreads = 256;

__global__ void sweep_windows_kernel(const int32_t* idx, uint8_t* exists,
                                     int8_t* mask, int32_t* tile_counts,
                                     int64_t n, int32_t idx_now,
                                     int64_t tile) {
  const int64_t stride = (int64_t)gridDim.x * kSweepThreads;
  for (int64_t base = (int64_t)blockIdx.x * kSweepThreads; base < n;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    int expired = 0;
    if (i < n) {
      const int32_t behind = (int32_t)((uint32_t)idx_now - (uint32_t)idx[i]);
      expired = exists[i] != 0 && behind >= 2;
      if (expired) exists[i] = 0;
      mask[i] = (int8_t)expired;
    }
    const int count = __syncthreads_count(expired);
    if (threadIdx.x == 0 && count > 0) {
      atomicAdd(&tile_counts[base / tile], count);
    }
  }
}

}  // namespace drl_window

using drl_window::WindowPolicy;

// b <= 4096 rows; a wider flush returns cudaErrorInvalidValue.
extern "C" int drl_window_packed(float* prev, float* curr, int32_t* idx,
                                 uint8_t* exists, int32_t n_slots,
                                 const int32_t* packed, int32_t b, float limit,
                                 int32_t window, int32_t interpolate,
                                 float* out, cudaStream_t stream) {
  if (window < 1) return (int)cudaErrorInvalidValue;
  return drl::launch_flush<WindowPolicy, false>(
      {prev, curr, idx, exists}, n_slots, packed, b,
      {limit, window, interpolate}, out, stream);
}

extern "C" int drl_window_grouped(float* prev, float* curr, int32_t* idx,
                                  uint8_t* exists, int32_t n_slots,
                                  const int32_t* packed, int32_t b,
                                  float limit, int32_t window,
                                  int32_t interpolate, float* out,
                                  cudaStream_t stream) {
  if (window < 1) return (int)cudaErrorInvalidValue;
  return drl::launch_flush<WindowPolicy, true>(
      {prev, curr, idx, exists}, n_slots, packed, b,
      {limit, window, interpolate}, out, stream);
}

// Exactly one of out (f32[K, 2, B]) and bits (u8[K, B / 8], in a 4-byte
// aligned allocation rounded up to whole 4-byte words) is non-null; scratch
// holds drl_scan_scratch_bytes(n_batches, b) bytes.
extern "C" int drl_window_scan(float* prev, float* curr, int32_t* idx,
                               uint8_t* exists, int32_t n_slots,
                               const void* operand, int32_t fused,
                               const int32_t* nows_k, int32_t n_batches,
                               int32_t b, float limit, int32_t window,
                               int32_t interpolate, float* out, uint8_t* bits,
                               void* scratch, cudaStream_t stream) {
  if (window < 1) return (int)cudaErrorInvalidValue;
  return drl::launch_scan_any<WindowPolicy>(
      {prev, curr, idx, exists}, n_slots, operand, fused, nows_k, n_batches,
      b, {limit, window, interpolate}, out, bits, scratch, stream);
}

extern "C" int64_t drl_scan_scratch_bytes(int32_t n_batches, int32_t b) {
  return drl::scan_scratch_bytes(n_batches, b);
}

// The fingerprint decision against the fingerprint table cells (u64[n],
// probe window L, shard regions) and the window table of the same n slots,
// as drl_fp_acquire.
extern "C" int drl_fp_window(float* prev, float* curr, int32_t* idx,
                             uint8_t* exists, int32_t n_slots, void* cells,
                             int32_t L, int32_t shards, const uint32_t* keys,
                             const int32_t* nows_k, int32_t n_batches,
                             int32_t b, float limit, int32_t window,
                             int32_t interpolate, float* out, uint8_t* bits,
                             int32_t* counts, void* scratch,
                             cudaStream_t stream) {
  if (window < 1) return (int)cudaErrorInvalidValue;
  return drl::launch_fp_decide<WindowPolicy>(
      {prev, curr, idx, exists}, n_slots, cells, L, shards, keys, nows_k,
      n_batches, b, {limit, window, interpolate}, out, bits, counts, scratch,
      stream);
}

extern "C" int64_t drl_fp_scratch_bytes(int32_t n_batches, int32_t b) {
  return drl::fp_scratch_bytes(n_batches, b);
}

extern "C" int drl_sweep_windows(const int32_t* idx, uint8_t* exists,
                                 int8_t* mask, int32_t* tile_counts,
                                 int64_t n, int32_t idx_now, int64_t tile,
                                 cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  int64_t blocks = (n + drl_window::kSweepThreads - 1) /
                   drl_window::kSweepThreads;
  // Enough blocks to fill 132 SMs many times over; the loop covers the rest.
  if (blocks > 132 * 32) blocks = 132 * 32;
  drl_window::sweep_windows_kernel<<<(unsigned)blocks,
                                     drl_window::kSweepThreads, 0, stream>>>(
      idx, exists, mask, tile_counts, n, idx_now, tile);
  return (int)cudaGetLastError();
}
