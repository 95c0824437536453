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
// Operands, as in the JAX package:
//   flush    i32[4, B]: row 0 slots (< 0 or >= N: padding, skipped as JAX's
//            mode="drop"), row 1 counts, row 2 the batch tick (column 0 is
//            read), row 3 the host's same-slot demand prefix;
//   grouped  i32[5, B]: rows 0-3 as above, row 4 the group size n;
//   scan     u8[K, B, 5] (bytes 0-3 the little-endian slot, byte 4 the
//            count) or i32[2, K, B] (slots, counts), and nows i32[K].
// Results: f32[2, B] (flush, grouped) or f32[K, 2, B] (scan): row 0 the grant
// (0/1) or n_granted, row 1 remaining; or, for a verdict-only scan, the
// grants bit-packed little-endian within each byte, u8[K, B / 8].
//
// Bound: a few flops a row and random 4-byte gathers/scatters of the 9-byte
// slot state, so bytes: the operand read once, the result written once, and
// 18 B per distinct slot. At B = 4096 that is well under a microsecond; what
// a call really costs is launch latency and the dependent chain gather ->
// decide -> write of every batch. There is no matrix product, so wgmma and the
// tensor cores do not apply.
//
// Design. Every call is ONE launch, and no launch needs a grid-wide barrier:
// all rows of a slot meet in one thread block, whose __syncthreads() makes
// its global writes visible to the whole block.
//   - Flush and grouped (host prefix, no sort): ONE block of 1024 threads,
//     each holding up to 4 rows' gathers in flight at once. Every row
//     gathers and decides, __syncthreads(), every row sets tokens =
//     refilled, last_ts, exists (all duplicates of a slot write the same
//     value), __syncthreads(), then duplicates' consumption is subtracted
//     with atomicAdd. Grants never depend on the atomics' order; a slot's
//     tokens may differ from a serial sum by float rounding (integer counts
//     below 2^24 make it exact). The flush is latency-bound, not
//     bandwidth-bound: split by slot over 16 blocks of 256 threads it took
//     longer on the H100 (fewer gathers in flight per thread, and every
//     block reads every row's slot).
//   - Scan (bulk lane): 16 blocks of 1024 threads; block p decides the rows
//     whose slot is p mod 16 (a padding row, by its row index), so every
//     slot has one block and the blocks never wait on each other. Each
//     block runs the K batches one after another (they depend on each
//     other through the table) over the whole batch operand, the other
//     blocks' rows standing as padding. Per batch:
//       1. one atomicCAS a row into a hash set in shared memory tells
//          whether any of the block's slots repeats in the batch;
//       2. if one does, the (slot, row) pairs are sorted with a stable block
//          radix sort (cub::BlockRadixSort) over the low bit_length(N) bits
//          (padding takes the key N, which sorts last), and an int64
//          segmented inclusive scan (cub::BlockScan) gives each row the
//          exact earlier same-slot demand, as the plain version's int64
//          duplicate_prefix, converted to f32 where it converts it
//          (__ll2float_rn); if none does, every row is its own segment with
//          prefix 0, and the sort and both scans are skipped;
//       3. one writer per distinct slot: the segment head gathers and
//          refills once, every row of the segment decides from that value,
//          and the segment tail writes tokens = refilled - the segment's
//          int64 consumption (a second segmented scan), last_ts and exists.
//          No atomics on the table, and the tokens are deterministic.
//     Measured on the H100 (chip_smoke.py): in one block, a chunk of Zipf
//     batches spent ~84% of its time in the sort, scans and barriers, and a
//     chunk of ~4,000 random distinct slots a batch was bound by the one
//     SM's scattered gathers and writes; the repeat check removes the first
//     where it can, the 16 blocks spread the second.
//   - While batch k decides, a 1-D TMA bulk copy (cp.async.bulk completing
//     on an mbarrier) brings batch k+1's operand into the other half of a
//     double buffer in shared memory. Where the operand is not 16-byte
//     aligned (B % 16 != 0), the block copies it itself.
//
// Traps, each with a test:
//   - Stale reads. The scan writes the table it reads, so no state pointer is
//     const __restrict__ and none is read with __ldg: ld.global.nc could serve
//     batch k+1 a value cached before batch k's write.
//   - Exactness. tokens + elapsed * rate is a multiply then an add
//     (__fmul_rn/__fadd_rn, and the build passes -fmad=false): a contracted
//     FMA flips grants at the refilled >= prefix + count boundary.
//   - Counts above 2^24 (i32 operand): the prefix is summed in int64.
//   - Tables that grew: N need not be a power of two and may pass 2^24; the
//     sort's bit range comes from N (the wrapper passes bit_length(N)).
//   - Bit order: grant of row 8q + i is bit i of byte q, as
//     np.unpackbits(..., bitorder="little") reads it.

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
// Blocks of the scan kernel: block p decides the rows of the slots = p mod
// kScanBlocks, so a batch's scattered gathers and writes spread over as many
// SMs.
constexpr int kScanBlocks = 16;
// Rows each flush thread stages per round, so that a thread has
// 3 x kFlushRows independent gathers in flight.
constexpr int kFlushRows = 4;

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Lazy refill min(cap, tokens + elapsed * rate), or a full bucket on a miss.
__device__ __forceinline__ float refill_or_init(float tokens, int32_t ts,
                                                uint8_t exists, int32_t now,
                                                float cap, float rate) {
  if (!exists) return cap;
  const int32_t elapsed = max((int32_t)((uint32_t)now - (uint32_t)ts), 0);
  return fminf(cap,
               __fadd_rn(tokens, __fmul_rn(__int2float_rn(elapsed), rate)));
}

// ---------------------------------------------------------------------------
// Flush and grouped flush: one block, rows strided over the threads.
// Dynamic shared memory: refilled and consumed per row, f32[2, B].

template <bool kGrouped>
__global__ void __launch_bounds__(kThreads, 1)
    flush_kernel(float* tokens, int32_t* last_ts, uint8_t* exists,
                 int32_t n_slots, const int32_t* __restrict__ packed,
                 int32_t b, float cap, float rate, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_refilled = reinterpret_cast<float*>(smem);
  float* s_consumed = s_refilled + b;
  const int32_t now = packed[2 * b];

  for (int base = 0; base < b; base += kThreads * kFlushRows) {
    int32_t slot[kFlushRows];
    float t_old[kFlushRows];
    int32_t ts_old[kFlushRows];
    uint8_t ex_old[kFlushRows];
#pragma unroll
    for (int q = 0; q < kFlushRows; ++q) {
      const int i = base + q * kThreads + threadIdx.x;
      slot[q] = i < b ? packed[i] : -1;
      ex_old[q] = 0;
      if (slot[q] >= 0 && slot[q] < n_slots) {
        t_old[q] = tokens[slot[q]];
        ts_old[q] = last_ts[slot[q]];
        ex_old[q] = exists[slot[q]];
      }
    }
#pragma unroll
    for (int q = 0; q < kFlushRows; ++q) {
      const int i = base + q * kThreads + threadIdx.x;
      if (i >= b) continue;
      const bool valid = slot[q] >= 0 && slot[q] < n_slots;
      const float refilled =
          valid ? refill_or_init(t_old[q], ts_old[q], ex_old[q], now, cap,
                                 rate)
                : cap;
      const float c = __int2float_rn(packed[b + i]);
      const float pre = __int2float_rn(packed[3 * b + i]);
      float granted, consumed, remaining;
      if (kGrouped) {
        const float n = __int2float_rn(packed[4 * b + i]);
        const float avail = __fsub_rn(refilled, pre);
        float ng;
        if (c > 0.0f) {
          ng = fminf(fmaxf(floorf(__fdiv_rn(avail, fmaxf(c, 1.0f))), 0.0f),
                     n);
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
        remaining = valid ? fmaxf(__fsub_rn(__fsub_rn(refilled, pre),
                                            consumed),
                                  0.0f)
                          : 0.0f;
      }
      out[i] = granted;
      out[b + i] = remaining;
      s_refilled[i] = refilled;
      s_consumed[i] = consumed;
    }
  }
  __syncthreads();  // every row has read the old state
  for (int i = threadIdx.x; i < b; i += kThreads) {
    const int32_t s = packed[i];
    if (s < 0 || s >= n_slots) continue;
    tokens[s] = s_refilled[i];
    last_ts[s] = now;
    exists[s] = 1;
  }
  __syncthreads();  // every duplicate has written the same refilled value
  for (int i = threadIdx.x; i < b; i += kThreads) {
    const int32_t s = packed[i];
    if (s < 0 || s >= n_slots) continue;
    const float c = s_consumed[i];
    if (c != 0.0f) atomicAdd(&tokens[s], -c);
  }
}

template <bool kGrouped>
int launch_flush(float* tokens, int32_t* last_ts, uint8_t* exists,
                 int32_t n_slots, const int32_t* packed, int32_t b, float cap,
                 float rate, float* out, cudaStream_t stream) {
  if (b <= 0) return (int)cudaSuccess;
  const size_t smem = 2 * sizeof(float) * (size_t)b;
  cudaError_t err = cudaFuncSetAttribute(
      flush_kernel<kGrouped>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  flush_kernel<kGrouped><<<1, kThreads, smem, stream>>>(
      tokens, last_ts, exists, n_slots, packed, b, cap, rate, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Scan: K batches in order, one block.

// One element of the segmented scans: a running int64 sum, and the sorted
// position of the segment's head (-1 on a non-head input element).
struct Seg {
  long long sum;
  int head;
};

struct SegSum {
  __device__ __forceinline__ Seg operator()(const Seg& a,
                                            const Seg& b) const {
    return b.head >= 0 ? b : Seg{a.sum + b.sum, a.head};
  }
};

template <int IPT>
struct ScanTypes {
  static constexpr int kRows = kThreads * IPT;  // rows a launch can hold
  // The repeat check's hash set: twice as many entries as rows.
  static constexpr int kHashBits = 11 + (IPT >= 2) + (IPT >= 4);
  static constexpr int kHashSize = 1 << kHashBits;
  static_assert(kHashSize == 2 * kRows, "hash set of 2 entries a row");
  using Sort = cub::BlockRadixSort<uint32_t, kThreads, IPT, uint16_t>;
  using Scan = cub::BlockScan<Seg, kThreads, cub::BLOCK_SCAN_WARP_SCANS>;
  union Temp {
    typename Sort::TempStorage sort;
    typename Scan::TempStorage scan;
  };
};

// Dynamic shared memory of the scan kernel, in bytes from its base.
struct ScanLayout {
  size_t bar, buf0, buf1, key, ref, grant, hash, total;
};

template <int IPT>
__host__ __device__ ScanLayout scan_layout(int32_t b, bool fused) {
  using T = ScanTypes<IPT>;
  const size_t op = align16((size_t)b * (fused ? 5 : 8));
  ScanLayout L;
  size_t o = align16(sizeof(typename T::Temp));
  L.bar = o;    o += 16;                       // two mbarriers
  L.buf0 = o;   o += op;                       // batch operand, even k
  L.buf1 = o;   o += op;                       // batch operand, odd k
  L.key = o;    o += align16(4 * (size_t)T::kRows);  // sorted keys
  L.ref = o;    o += align16(4 * (size_t)T::kRows);  // refilled per head
  L.grant = o;  o += align16((size_t)T::kRows);      // grant per row
  L.hash = o;   o += 4 * (size_t)T::kHashSize;       // repeat check
  L.total = o;
  return L;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase `parity` of the barrier to complete. A copy that never
// lands would hang the card, so after ~2^26 polls the kernel traps instead.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t spin = 0; !mbar_try_wait(bar, parity); ++spin) {
    if (spin == (1u << 26)) __trap();
  }
}

// One thread: arm the barrier for `bytes` and start the bulk copies.
__device__ __forceinline__ void tma_batch(unsigned char* dst,
                                          const unsigned char* src0,
                                          const unsigned char* src1,
                                          uint32_t half, uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  const uint32_t bytes = src1 != nullptr ? 2 * half : half;
  // Earlier generic-proxy reads of this buffer come before the async write.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src0), "r"(half), "r"(b)
      : "memory");
  if (src1 != nullptr) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst + half)),
        "l"(src1), "r"(half), "r"(b)
        : "memory");
  }
}

// Row r's slot and count from a staged batch operand.
__device__ __forceinline__ int32_t staged_slot(const unsigned char* buf,
                                               bool fused, int r) {
  if (fused) {
    const unsigned char* p = buf + 5 * r;
    return (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                     ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24));
  }
  return reinterpret_cast<const int32_t*>(buf)[r];
}

__device__ __forceinline__ int32_t staged_count(const unsigned char* buf,
                                                bool fused, int32_t b, int r) {
  if (fused) return buf[5 * r + 4];
  return reinterpret_cast<const int32_t*>(buf)[b + r];
}

template <int IPT>
__global__ void __launch_bounds__(kThreads, 1)
    scan_kernel(float* tokens, int32_t* last_ts, uint8_t* exists,
                int32_t n_slots, const unsigned char* __restrict__ operand,
                bool fused, bool use_tma, const int32_t* __restrict__ nows_k,
                int32_t n_batches, int32_t b, int sort_bits, float cap,
                float rate, float* __restrict__ out,
                uint8_t* __restrict__ bits) {
  using T = ScanTypes<IPT>;
  using Sort = typename T::Sort;
  using Scan = typename T::Scan;
  extern __shared__ __align__(16) unsigned char smem[];
  const ScanLayout L = scan_layout<IPT>(b, fused);
  typename T::Temp& temp = *reinterpret_cast<typename T::Temp*>(smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint32_t* s_key = reinterpret_cast<uint32_t*>(smem + L.key);
  float* s_ref = reinterpret_cast<float*>(smem + L.ref);
  uint8_t* s_grant = smem + L.grant;
  uint32_t* s_hash = reinterpret_cast<uint32_t*>(smem + L.hash);
  const int tid = threadIdx.x;
  const uint32_t pad_key = (uint32_t)n_slots;  // sorts after every slot
  constexpr uint32_t kEmpty = 0xFFFFFFFFu;     // no slot is >= 2^31
  // Whether this block decides row r (slot s): by slot, or for a padding
  // row by row index, so that every row has exactly one block.
  auto owns = [&](int32_t s, int r) {
    const bool valid = s >= 0 && s < n_slots;
    return (uint32_t)(valid ? s : r) % gridDim.x == blockIdx.x;
  };

  // Batch k's operand: fused u8[K, B, 5], or i32[2, K, B] (slots, counts).
  const uint32_t half = fused ? 5u * b : 4u * b;
  auto src = [&](int k, int part) -> const unsigned char* {
    return fused ? operand + (size_t)k * half
                 : operand + ((size_t)part * n_batches + k) * half;
  };
  auto stage = [&](int k) {  // start batch k's copy into buffer k % 2
    unsigned char* dst = smem + ((k & 1) ? L.buf1 : L.buf0);
    tma_batch(dst, src(k, 0), fused ? nullptr : src(k, 1), half, &bar[k & 1]);
  };

  for (int i = tid; i < T::kHashSize; i += kThreads) s_hash[i] = kEmpty;
  if (use_tma && tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    stage(0);
  }
  __syncthreads();

  for (int k = 0; k < n_batches; ++k) {
    unsigned char* buf = smem + ((k & 1) ? L.buf1 : L.buf0);
    if (use_tma) {
      mbar_wait(&bar[k & 1], (k >> 1) & 1);
      // Buffer (k+1) % 2 was last read in batch k-1, which every thread has
      // left (the __syncthreads() that ends each batch).
      if (tid == 0 && k + 1 < n_batches) stage(k + 1);
    } else {
      const int parts = fused ? 1 : 2;
      for (int part = 0; part < parts; ++part) {
        const unsigned char* s = src(k, part);
        for (uint32_t i = tid; i < half; i += kThreads) {
          buf[part * half + i] = s[i];
        }
      }
      __syncthreads();
    }
    const int32_t now = nows_k[k];

    // This block's rows keep their slot as the key; every other row (and
    // every padding row) takes the padding key.
    uint32_t key[IPT];
    uint16_t row[IPT];
#pragma unroll
    for (int j = 0; j < IPT; ++j) {
      const int r = tid * IPT + j;
      const int32_t s = r < b ? staged_slot(buf, fused, r) : -1;
      const bool valid = s >= 0 && s < n_slots;
      key[j] = valid && owns(s, r) ? (uint32_t)s : pad_key;
      row[j] = (uint16_t)r;
    }

    // 1. Does one of the block's slots repeat in the batch? One atomicCAS a
    //    row into a shared-memory hash set. Without repeats there is no sort
    //    and no scan: every row is its own segment and every prefix is 0.
    int claimed[IPT];
    bool repeat = false;
#pragma unroll
    for (int j = 0; j < IPT; ++j) {
      claimed[j] = -1;
      if (key[j] == pad_key) continue;
      uint32_t h = (key[j] * 2654435761u) >> (32 - T::kHashBits);
      for (;;) {
        const uint32_t prev = atomicCAS(&s_hash[h], kEmpty, key[j]);
        if (prev == kEmpty) {
          claimed[j] = (int)h;
          break;
        }
        if (prev == key[j]) {
          repeat = true;
          break;
        }
        h = (h + 1) & (T::kHashSize - 1);
      }
    }
    const bool sorted = __syncthreads_or(repeat);
#pragma unroll
    for (int j = 0; j < IPT; ++j) {  // empty again for the next batch
      if (claimed[j] >= 0) s_hash[claimed[j]] = kEmpty;
    }
    if (sorted) {
      // Sort (key, row) by key: a stable radix sort keeps request order
      // within each slot's segment.
      Sort(temp.sort).Sort(key, row, 0, sort_bits);
#pragma unroll
      for (int j = 0; j < IPT; ++j) s_key[tid * IPT + j] = key[j];
      __syncthreads();
    }

    // 2. Exact int64 prefix of earlier same-slot demand; each element also
    //    learns its segment head's (sorted) position.
    Seg seg[IPT];
    int32_t cnt[IPT];
    bool head[IPT], valid[IPT];
#pragma unroll
    for (int j = 0; j < IPT; ++j) {
      const int p = tid * IPT + j;
      valid[j] = key[j] != pad_key;
      head[j] = !sorted || p == 0 || s_key[p - 1] != key[j];
      cnt[j] = valid[j] ? staged_count(buf, fused, b, row[j]) : 0;
      seg[j] = Seg{cnt[j], head[j] ? p : -1};
    }
    if (sorted) Scan(temp.scan).InclusiveScan(seg, seg, SegSum());

    // 3. Each segment head gathers and refills its slot once.
    {
      float t_old[IPT];
      int32_t ts_old[IPT];
      uint8_t ex_old[IPT];
#pragma unroll
      for (int j = 0; j < IPT; ++j) {
        ex_old[j] = 0;
        if (head[j] && valid[j]) {
          t_old[j] = tokens[key[j]];
          ts_old[j] = last_ts[key[j]];
          ex_old[j] = exists[key[j]];
        }
      }
#pragma unroll
      for (int j = 0; j < IPT; ++j) {
        if (head[j] && valid[j]) {
          s_ref[tid * IPT + j] =
              refill_or_init(t_old[j], ts_old[j], ex_old[j], now, cap, rate);
        }
      }
    }
    __syncthreads();

    // 4. Decide every row from its head's refilled value; seg becomes the
    //    input of the consumption scan.
    float refilled[IPT];
#pragma unroll
    for (int j = 0; j < IPT; ++j) {
      const int p = tid * IPT + j;
      refilled[j] = valid[j] ? s_ref[seg[j].head] : cap;
      const float pre = __ll2float_rn(seg[j].sum - cnt[j]);
      const float c = __int2float_rn(cnt[j]);
      const bool ok = valid[j] && refilled[j] >= __fadd_rn(pre, c);
      const float remaining =
          valid[j] ? fmaxf(__fsub_rn(__fsub_rn(refilled[j], pre),
                                     ok ? c : 0.0f),
                           0.0f)
                   : 0.0f;
      const int r = row[j];
      if (r < b) {
        const bool own = valid[j] || owns(staged_slot(buf, fused, r), r);
        if (own && out != nullptr) {
          out[(size_t)k * 2 * b + r] = ok ? 1.0f : 0.0f;
          out[(size_t)k * 2 * b + b + r] = remaining;
        }
        s_grant[r] = ok;  // false for every row of another block
      }
      seg[j] = Seg{ok ? cnt[j] : 0, head[j] ? p : -1};
    }
    // (The __syncthreads() after step 3 separates the two uses of the
    // scan's temporary storage.)
    if (sorted) Scan(temp.scan).InclusiveScan(seg, seg, SegSum());

    // 5. Each segment tail writes its slot once: refilled minus the
    //    segment's consumption.
#pragma unroll
    for (int j = 0; j < IPT; ++j) {
      const int p = tid * IPT + j;
      const bool tail =
          !sorted || p == T::kRows - 1 || s_key[p + 1] != key[j];
      if (tail && valid[j]) {
        tokens[key[j]] = __fsub_rn(refilled[j], __ll2float_rn(seg[j].sum));
        last_ts[key[j]] = now;
        exists[key[j]] = 1;
      }
    }
    // Batch k's writes are visible to batch k+1's reads; shared memory is
    // free for reuse.
    __syncthreads();

    // A byte of grant bits holds rows of several blocks: each ORs its own
    // into the 32-bit word around the byte (the launcher zeroed them all).
    if (bits != nullptr) {
      for (int q = tid; q < b / 8; q += kThreads) {
        uint32_t byte = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) byte |= (uint32_t)s_grant[8 * q + i] << i;
        if (byte != 0) {
          const size_t o = (size_t)k * (b / 8) + q;
          atomicOr(reinterpret_cast<unsigned int*>(bits) + (o >> 2),
                   byte << (8 * (o & 3)));
        }
      }
    }
  }
}

template <int IPT>
int launch_scan(float* tokens, int32_t* last_ts, uint8_t* exists,
                int32_t n_slots, const unsigned char* operand, bool fused,
                const int32_t* nows_k, int32_t n_batches, int32_t b,
                int sort_bits, float cap, float rate, float* out,
                uint8_t* bits, cudaStream_t stream) {
  const ScanLayout L = scan_layout<IPT>(b, fused);
  // The bulk copy needs 16-byte aligned addresses and sizes.
  const bool use_tma = b % 16 == 0 && (uintptr_t)operand % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<IPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return (int)err;
  if (bits != nullptr) {  // the blocks OR their grants into whole words
    const size_t words = ((size_t)n_batches * (b / 8) + 3) / 4;
    err = cudaMemsetAsync(bits, 0, 4 * words, stream);
    if (err != cudaSuccess) return (int)err;
  }
  scan_kernel<IPT><<<kScanBlocks, kThreads, L.total, stream>>>(
      tokens, last_ts, exists, n_slots, operand, fused, use_tma, nows_k,
      n_batches, b, sort_bits, cap, rate, out, bits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int drl_acquire_packed(float* tokens, int32_t* last_ts,
                                  uint8_t* exists, int32_t n_slots,
                                  const int32_t* packed, int32_t b, float cap,
                                  float rate, float* out,
                                  cudaStream_t stream) {
  return launch_flush<false>(tokens, last_ts, exists, n_slots, packed, b, cap,
                             rate, out, stream);
}

extern "C" int drl_acquire_grouped(float* tokens, int32_t* last_ts,
                                   uint8_t* exists, int32_t n_slots,
                                   const int32_t* packed, int32_t b, float cap,
                                   float rate, float* out,
                                   cudaStream_t stream) {
  return launch_flush<true>(tokens, last_ts, exists, n_slots, packed, b, cap,
                            rate, out, stream);
}

// Exactly one of out (f32[K, 2, B]) and bits (u8[K, B / 8], in a 4-byte
// aligned allocation rounded up to whole 4-byte words) is non-null.
extern "C" int drl_acquire_scan(float* tokens, int32_t* last_ts,
                                uint8_t* exists, int32_t n_slots,
                                const void* operand, int32_t fused,
                                const int32_t* nows_k, int32_t n_batches,
                                int32_t b, int32_t sort_bits, float cap,
                                float rate, float* out, uint8_t* bits,
                                cudaStream_t stream) {
  if (b <= 0 || n_batches <= 0) return (int)cudaSuccess;
  const auto* op = static_cast<const unsigned char*>(operand);
  if (b <= ScanTypes<1>::kRows)
    return launch_scan<1>(tokens, last_ts, exists, n_slots, op, fused != 0,
                          nows_k, n_batches, b, sort_bits, cap, rate, out,
                          bits, stream);
  if (b <= ScanTypes<2>::kRows)
    return launch_scan<2>(tokens, last_ts, exists, n_slots, op, fused != 0,
                          nows_k, n_batches, b, sort_bits, cap, rate, out,
                          bits, stream);
  if (b <= ScanTypes<4>::kRows)
    return launch_scan<4>(tokens, last_ts, exists, n_slots, op, fused != 0,
                          nows_k, n_batches, b, sort_bits, cap, rate, out,
                          bits, stream);
  return (int)cudaErrorInvalidValue;
}
