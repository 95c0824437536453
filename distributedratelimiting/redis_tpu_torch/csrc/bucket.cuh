// The token bucket's refill for one slot, shared by the bucket decision
// kernels (acquire.cu) and the two-level admission and debit kernels
// (admission.cu), so that every kernel that advances a bucket rounds it the
// same way.
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

}  // namespace drl_bucket
