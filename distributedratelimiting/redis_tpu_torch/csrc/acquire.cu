// Token-bucket acquire decisions for Hopper (sm_90a): one launch per call.
//
// Replaces, in distributedratelimiting/redis_tpu/ops/kernels.py (XLA
// programs on the TPU, not Pallas: Mosaic has no scatter):
//   drl_acquire_packed  <- acquire_batch_packed (one serving flush);
//   drl_acquire_grouped <- acquire_batch_packed_grouped (coalesced flush);
//   drl_acquire_scan    <- acquire_scan_fused_packed / acquire_scan_fused_bits
//                          and acquire_scan_compact_fused (fused u8[K, B, 5]
//                          operand), acquire_scan_compact_packed (i32
//                          counts) and acquire_scan_packed24 (u8[K, B, 3]
//                          unit requests, the bench's headline): the bulk
//                          lane's K batches decided in order, each with its
//                          in-batch duplicate prefix, as the JAX lax.scan of
//                          acquire_core does;
//   drl_acquire_batch   <- acquire_batch (core acquire_core): one batch from
//                          separate slots, counts and valid arrays and a
//                          by-value tick, with or without the in-batch
//                          duplicate prefix (handle_duplicates).
//
// acquire_batch's design. It takes B <= 8192 (the bench's single batch), and
// with handle_duplicates it needs the in-batch prefix, which the flush takes
// from the host: so it is the scan at K = 1 over the separate arrays (format
// kOpArrays), one cooperative launch, whose grid-wide hash set meets a slot's
// rows wherever they lie. The flush cannot take it: a slot's rows must meet
// in one block, and one block holds 4096 rows (1024 threads of 4; 8 rows a
// thread would need more than the 64 registers a thread of 1024 may have).
// Without handle_duplicates every row's prefix is 0 (the scan's dup flag):
// a slot's rows all decide from its refilled balance, and its one writer
// applies the int64 sum of every granted count once, so the balance may go
// below zero, as in JAX. The price is the scan's fixed phases at small B
// (PERF.md: a K = 1 scan of 8 rows ~0.006 ms against a flush's ~0.0016).
//
// The kernels, their operands and their design are decide.cuh's, shared with
// the window kernels (window.cu); this file holds the token bucket's rule for
// one slot (BucketPolicy) and the entry points.
//
// The rule: a slot's state is tokens f32, last_ts i32, exists u8 (9 B).
// Advanced to the batch tick it is the refilled balance
// min(cap, tokens + elapsed * rate), or a full bucket on a miss; a request
// for c after an earlier same-slot demand pre is granted iff
// refilled >= pre + c, and the slot keeps refilled minus what was granted.
//
// Bound: a few flops a row and random 4-byte gathers/scatters of the 9-byte
// slot state, so bytes: the operand read once, the result written once, and
// 18 B per distinct slot. At B = 4096 that is well under a microsecond; what
// a flush really costs is launch latency and its dependent chain gather ->
// decide -> write, so a flush is sized by its rows: a warp up to 32 rows,
// blocks by the rows above (decide.cuh). There is no matrix product, so
// wgmma and the tensor cores do not apply.
//
// Measured on the H100 (chip_smoke.py --flush-bench, --scan-bench): a flush
// of one valid row costs one warp's launch and its gather and write; a scan
// chunk in which
// no key repeats costs the scattered gathers and commits of its slots; with
// repeats, its longest slot's walk over the batches (a hot slot's batch
// groups run one after another).
//
// Exactness: tokens + elapsed * rate is a multiply then an add
// (__fmul_rn/__fadd_rn, and the build passes -fmad=false): a contracted FMA
// flips grants at the refilled >= prefix + count boundary. The refill is
// bucket.cuh's, shared with the admission and debit kernels (admission.cu).

#include "bucket.cuh"
#include "decide.cuh"

// A named namespace: the policy is a template argument of the kernels.
namespace drl_bucket {

struct BucketPolicy {
  struct Table {
    float* tokens;
    int32_t* last_ts;
    uint8_t* exists;
  };
  struct Params {
    float cap;
    float rate;
  };
  struct Old {
    float tokens;
    int32_t ts;
    uint8_t exists;
  };
  using Slot = float;  // the refilled balance

  static __device__ __forceinline__ Old gather(const Table& t, int32_t s) {
    return Old{t.tokens[s], t.last_ts[s], t.exists[s]};
  }
  static __device__ __forceinline__ Slot advance(const Old& o, int32_t now,
                                                 const Params& p) {
    return refill_or_init(o.tokens, o.ts, o.exists, now, p.cap, p.rate);
  }
  static __device__ __forceinline__ float room(const Slot& r, int32_t,
                                               const Params&) {
    return r;
  }
  static __device__ __forceinline__ bool fits(const Slot& r, int32_t,
                                              const Params&, float pre,
                                              float c) {
    return r >= __fadd_rn(pre, c);
  }
  static __device__ __forceinline__ void commit(const Table& t, int32_t s,
                                                const Slot& r, int32_t now,
                                                long long consumed) {
    const Old o = carry(r, now, consumed);
    t.tokens[s] = o.tokens;
    t.last_ts[s] = o.ts;
    t.exists[s] = o.exists;
  }
  static __device__ __forceinline__ Old carry(const Slot& r, int32_t now,
                                              long long consumed) {
    return Old{__fsub_rn(r, __ll2float_rn(consumed)), now, 1};
  }
};

}  // namespace drl_bucket

using drl_bucket::BucketPolicy;

// b <= 4096 rows; a wider flush returns cudaErrorInvalidValue.
extern "C" int drl_acquire_packed(float* tokens, int32_t* last_ts,
                                  uint8_t* exists, int32_t n_slots,
                                  const int32_t* packed, int32_t b, float cap,
                                  float rate, float* out,
                                  cudaStream_t stream) {
  return drl::launch_flush<BucketPolicy, false>(
      {tokens, last_ts, exists}, n_slots, packed, b, {cap, rate}, out,
      stream);
}

extern "C" int drl_acquire_grouped(float* tokens, int32_t* last_ts,
                                   uint8_t* exists, int32_t n_slots,
                                   const int32_t* packed, int32_t b, float cap,
                                   float rate, float* out,
                                   cudaStream_t stream) {
  return drl::launch_flush<BucketPolicy, true>(
      {tokens, last_ts, exists}, n_slots, packed, b, {cap, rate}, out,
      stream);
}

// Exactly one of out (f32[K, 2, B]) and bits (u8[K, B / 8], in a 4-byte
// aligned allocation rounded up to whole 4-byte words) is non-null; fmt is
// decide.cuh's kOpI32 (0), kOpFused5 (1) or kOpSlots24 (2); scratch holds
// drl_scan_scratch_bytes(n_batches, b) bytes.
extern "C" int drl_acquire_scan(float* tokens, int32_t* last_ts,
                                uint8_t* exists, int32_t n_slots,
                                const void* operand, int32_t fmt,
                                const int32_t* nows_k, int32_t n_batches,
                                int32_t b, float cap, float rate, float* out,
                                uint8_t* bits, void* scratch,
                                cudaStream_t stream) {
  if (fmt == drl::kOpSlots24) {  // the bench's operand: the wide kernel
    const drl::ScanOp op{static_cast<const unsigned char*>(operand), nullptr,
                         nullptr, fmt, 0};
    return drl::launch_scan<BucketPolicy, drl::kWideOps>(
        {tokens, last_ts, exists}, n_slots, op, true, nows_k, n_batches, b,
        {cap, rate}, out, bits, scratch, stream);
  }
  return drl::launch_scan_any<BucketPolicy>(
      {tokens, last_ts, exists}, n_slots, operand, fmt, nows_k, n_batches, b,
      {cap, rate}, out, bits, scratch, stream);
}

// One batch of b rows (slots i32[b], counts i32[b], valid bool[b]) at tick
// now; dup != 0 serializes a slot's rows by their in-batch prefix. out is
// f32[2, b] (grants, remaining); scratch holds drl_scan_scratch_bytes(1, b)
// bytes.
extern "C" int drl_acquire_batch(float* tokens, int32_t* last_ts,
                                 uint8_t* exists, int32_t n_slots,
                                 const int32_t* slots, const int32_t* counts,
                                 const uint8_t* valid, int32_t now, int32_t b,
                                 int32_t dup, float cap, float rate,
                                 float* out, void* scratch,
                                 cudaStream_t stream) {
  const drl::ScanOp op{reinterpret_cast<const unsigned char*>(slots), counts,
                       valid, drl::kOpArrays, now};
  return drl::launch_scan<BucketPolicy, drl::kWideOps>(
      {tokens, last_ts, exists}, n_slots, op, dup != 0, nullptr, 1, b,
      {cap, rate}, out, nullptr, scratch, stream);
}

extern "C" int64_t drl_scan_scratch_bytes(int32_t n_batches, int32_t b) {
  return drl::scan_scratch_bytes(n_batches, b);
}

// The fingerprint decision against the fingerprint table cells (u64[n],
// probe window L, shard regions) and the bucket table of the same n slots:
// keys u32[K, B, 3], nows_k i32[K]; see decide.cuh's launch_fp_decide for
// out, bits, counts and scratch (drl_fp_scratch_bytes(K, B) bytes). One
// launch.
extern "C" int drl_fp_acquire(float* tokens, int32_t* last_ts,
                              uint8_t* exists, int32_t n_slots, void* cells,
                              int32_t L, int32_t shards, const uint32_t* keys,
                              const int32_t* nows_k, int32_t n_batches,
                              int32_t b, float cap, float rate, float* out,
                              uint8_t* bits, int32_t* counts, void* scratch,
                              cudaStream_t stream) {
  return drl::launch_fp_decide<BucketPolicy>(
      {tokens, last_ts, exists}, n_slots, cells, L, shards, keys, nows_k,
      n_batches, b, {cap, rate}, out, bits, counts, scratch, stream);
}

extern "C" int64_t drl_fp_scratch_bytes(int32_t n_batches, int32_t b) {
  return drl::fp_scratch_bytes(n_batches, b);
}
