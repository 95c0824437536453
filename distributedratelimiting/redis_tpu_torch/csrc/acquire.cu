// Token-bucket acquire decision over one packed flush, for Hopper (sm_90a).
//
// Replaces: distributedratelimiting/redis_tpu/ops/kernels.py,
//   acquire_core via acquire_batch_packed (per-row flush, and each scanned
//   batch of the bulk lane) and acquire_batch_packed_grouped (coalesced
//   flush). On the TPU these were XLA programs, not Pallas: Mosaic has no
//   scatter. Hopper has native scatter and atomics, so they are hand kernels.
//
// Operand, as in the JAX package: packed i32[4, B] (grouped: i32[5, B]) —
// row 0 slots (< 0 or >= N: padding, skipped as JAX's mode="drop"), row 1
// counts, row 2 the batch tick (column 0 is read), row 3 the same-slot demand
// prefix, row 4 (grouped) the group size n. The per-row path may take the
// prefix as a float32 array instead (the bulk lane computes it on the device).
// Result: out f32[2, B] — row 0 grant (0/1) or n_granted, row 1 remaining.
//
// Bound: the gathers and scatters are random 4-byte accesses to the table,
// a few flops a row: memory (and launch latency at B = 4096). Bytes a row:
// 20 (operand) + 9 gathered + 8 written back + 9 scattered, ~46 B.
//
// Design: duplicate slots in one batch mean no row may write the table while
// another row can still read it, so one flush is three launches on one stream:
//   1. decide: gather, refill, decide; writes out and per-row
//      refilled/consumed scratch;
//   2. set: tokens = refilled, last_ts = now, exists = 1 (every duplicate
//      writes the same values, gathered from the same old state);
//   3. add: atomicAdd(&tokens[s], -consumed).
// Step 3 adds duplicates' consumption in no fixed order, so a slot's tokens
// may differ from a serial sum by float rounding; grants never depend on it.
//
// Rounding follows the plain version exactly: tokens + elapsed * rate is a
// multiply then an add (__fmul_rn/__fadd_rn, and the build passes
// -fmad=false), never a fused multiply-add — one ulp of difference at the
// refilled >= prefix + count boundary would flip a grant.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool row_slot(const int32_t* packed, int i,
                                         int32_t n_slots, int32_t* slot) {
  *slot = packed[i];
  return *slot >= 0 && *slot < n_slots;
}

template <bool kGrouped>
__global__ void decide_kernel(const float* __restrict__ tokens,
                              const int32_t* __restrict__ last_ts,
                              const uint8_t* __restrict__ exists,
                              int32_t n_slots,
                              const int32_t* __restrict__ packed,
                              const float* __restrict__ prefix_f, int32_t b,
                              float cap, float rate, float* __restrict__ out,
                              float* __restrict__ refilled_out,
                              float* __restrict__ consumed_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= b) return;
  int32_t s;
  const bool valid = row_slot(packed, i, n_slots, &s);
  const int32_t now = packed[2 * b];
  const float c = __int2float_rn(packed[b + i]);
  const float pre =
      prefix_f != nullptr ? prefix_f[i] : __int2float_rn(packed[3 * b + i]);

  float refilled = cap;
  if (valid && exists[s]) {
    const int32_t elapsed =
        max((int32_t)((uint32_t)now - (uint32_t)last_ts[s]), 0);
    refilled = fminf(
        cap, __fadd_rn(tokens[s], __fmul_rn(__int2float_rn(elapsed), rate)));
  }

  float granted, consumed, remaining;
  if (kGrouped) {
    const float n = __int2float_rn(packed[4 * b + i]);
    const float avail = __fsub_rn(refilled, pre);
    float ng;
    if (c > 0.0f) {
      ng = fminf(fmaxf(floorf(__fdiv_rn(avail, fmaxf(c, 1.0f))), 0.0f), n);
    } else {
      ng = avail >= 0.0f ? n : 0.0f;
    }
    granted = valid ? ng : 0.0f;
    consumed = __fmul_rn(granted, c);
    remaining = valid ? fmaxf(__fsub_rn(avail, consumed), 0.0f) : 0.0f;
  } else {
    const bool ok = valid && refilled >= __fadd_rn(pre, c);
    granted = ok ? 1.0f : 0.0f;
    consumed = ok ? c : 0.0f;
    remaining = valid ? fmaxf(__fsub_rn(__fsub_rn(refilled, pre), consumed),
                              0.0f)
                      : 0.0f;
  }
  out[i] = granted;
  out[b + i] = remaining;
  refilled_out[i] = refilled;
  consumed_out[i] = consumed;
}

__global__ void set_kernel(float* __restrict__ tokens,
                           int32_t* __restrict__ last_ts,
                           uint8_t* __restrict__ exists, int32_t n_slots,
                           const int32_t* __restrict__ packed, int32_t b,
                           const float* __restrict__ refilled) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int32_t s;
  if (i >= b || !row_slot(packed, i, n_slots, &s)) return;
  tokens[s] = refilled[i];
  last_ts[s] = packed[2 * b];
  exists[s] = 1;
}

__global__ void add_kernel(float* __restrict__ tokens, int32_t n_slots,
                           const int32_t* __restrict__ packed, int32_t b,
                           const float* __restrict__ consumed) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int32_t s;
  if (i >= b || !row_slot(packed, i, n_slots, &s)) return;
  const float c = consumed[i];
  if (c != 0.0f) atomicAdd(&tokens[s], -c);
}

template <bool kGrouped>
int launch(float* tokens, int32_t* last_ts, uint8_t* exists, int32_t n_slots,
           const int32_t* packed, const float* prefix_f, int32_t b, float cap,
           float rate, float* out, float* refilled, float* consumed,
           cudaStream_t stream) {
  if (b <= 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((b + kThreads - 1) / kThreads);
  decide_kernel<kGrouped><<<blocks, kThreads, 0, stream>>>(
      tokens, last_ts, exists, n_slots, packed, prefix_f, b, cap, rate, out,
      refilled, consumed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  set_kernel<<<blocks, kThreads, 0, stream>>>(tokens, last_ts, exists,
                                              n_slots, packed, b, refilled);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  add_kernel<<<blocks, kThreads, 0, stream>>>(tokens, n_slots, packed, b,
                                              consumed);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int drl_acquire_packed(float* tokens, int32_t* last_ts,
                                  uint8_t* exists, int32_t n_slots,
                                  const int32_t* packed, const float* prefix_f,
                                  int32_t b, float cap, float rate, float* out,
                                  float* refilled, float* consumed,
                                  cudaStream_t stream) {
  return launch<false>(tokens, last_ts, exists, n_slots, packed, prefix_f, b,
                       cap, rate, out, refilled, consumed, stream);
}

extern "C" int drl_acquire_grouped(float* tokens, int32_t* last_ts,
                                   uint8_t* exists, int32_t n_slots,
                                   const int32_t* packed, int32_t b, float cap,
                                   float rate, float* out, float* refilled,
                                   float* consumed, cudaStream_t stream) {
  return launch<true>(tokens, last_ts, exists, n_slots, packed, nullptr, b,
                      cap, rate, out, refilled, consumed, stream);
}
