// The token bucket's refill for one slot, shared by the bucket decision
// kernels (acquire.cu), the two-level admission and debit kernels
// (admission.cu) and the fingerprint table's peek (fp_directory.cu), so that
// every kernel that advances a bucket rounds it the same way; and its TTL,
// shared by the sweeps (sweep.cu, fp_directory.cu).
//
// refill_or_init is the JAX package's bucket_math.refill_or_init: the lazy
// refill min(cap, tokens + elapsed * rate), or a full bucket on a miss, with
// elapsed = max(0, now - ts) in wrapping int32. The product and the sum each
// round on their own (__fmul_rn/__fadd_rn, and the build passes
// -fmad=false): a contracted FMA flips grants at the refilled >= prefix +
// count boundary.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace drl_bucket {

__device__ __forceinline__ float refill_or_init(float tokens, int32_t ts,
                                                uint8_t exists, int32_t now,
                                                float cap, float rate) {
  if (!exists) return cap;
  const int32_t elapsed = max((int32_t)((uint32_t)now - (uint32_t)ts), 0);
  return fminf(cap,
               __fadd_rn(tokens, __fmul_rn(__int2float_rn(elapsed), rate)));
}

// sweep_expired's TTL: clamp(ceil(max(cap - tokens, 0) / max(rate, 1e-30)),
// 1024, min(1yr, 2^31 - 1)), float32 then int32. The float32 upper clamp
// min(1yr, 2^31 - 1) is 2^31, one past int32's range: the conversion
// saturates it explicitly to 2^31 - 1 (as XLA's does), where a plain (int)
// cast of an out-of-range float is undefined.
__device__ __forceinline__ int ttl_ticks(float tokens, float cap, float rate) {
  const float deficit = fmaxf(__fsub_rn(cap, tokens), 0.0f);
  float ttl = ceilf(__fdiv_rn(deficit, fmaxf(rate, 1e-30f)));
  ttl = fminf(fmaxf(ttl, 1024.0f), 2147483648.0f);
  return ttl >= 2147483648.0f ? 2147483647 : __float2int_rz(ttl);
}

}  // namespace drl_bucket
