// Token-bucket acquire decisions for Hopper (sm_90a): one launch per call.
//
// Replaces, in distributedratelimiting/redis_tpu/ops/kernels.py (XLA
// programs on the TPU, not Pallas: Mosaic has no scatter):
//   drl_acquire_packed  <- acquire_batch_packed (one serving flush);
//   drl_acquire_grouped <- acquire_batch_packed_grouped (coalesced flush);
//   drl_acquire_scan    <- acquire_scan_fused_packed / acquire_scan_fused_bits
//                          (fused u8[K, B, 5] operand) and
//                          acquire_scan_compact_packed (i32 counts): the bulk
//                          lane's K batches decided in order, each with its
//                          in-batch duplicate prefix, as the JAX lax.scan of
//                          acquire_core does.
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
// aligned allocation rounded up to whole 4-byte words) is non-null; scratch
// holds drl_scan_scratch_bytes(n_batches, b) bytes.
extern "C" int drl_acquire_scan(float* tokens, int32_t* last_ts,
                                uint8_t* exists, int32_t n_slots,
                                const void* operand, int32_t fused,
                                const int32_t* nows_k, int32_t n_batches,
                                int32_t b, float cap, float rate, float* out,
                                uint8_t* bits, void* scratch,
                                cudaStream_t stream) {
  return drl::launch_scan_any<BucketPolicy>(
      {tokens, last_ts, exists}, n_slots, operand, fused, nows_k, n_batches, b,
      {cap, rate}, out, bits, scratch, stream);
}

extern "C" int64_t drl_scan_scratch_bytes(int32_t n_batches, int32_t b) {
  return drl::scan_scratch_bytes(n_batches, b);
}
