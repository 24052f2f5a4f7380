// Variant-prep pileup on Hopper (sm_90a): a chunk's aligned bases and its
// deletion and insertion events counted into the (G, 7) int32 pileup.
//
// Replaces no TPU kernel. The JAX package piles up with
// jax.ops.segment_sum, which XLA lowers itself
// (mini_parallel_tpu/models/variant_prep.py:279 and :541-571); the port's
// plain route (models/variant_prep.py:_pileup_positions_plain) builds int64
// bins for every (read, column) slot, three sets of them, sends each masked
// slot to one trash slot and calls index_add_. On the card that route is
// bound by the trash slot, not by the counts: about two thirds of a gapped
// chunk's 4.56 M slots are masked, and atomics on one address run one
// after another in L2, so index_add_ alone takes 2.4 ms of a 10,000 x 152
// chunk on an H100 whatever the sample holds.
//
// Contract: codes (B, L) uint8 (0-3 A C G T, 4 N, above that pads),
// positions (B, L) int32 or int64 (a query base's reference coordinate, < 0
// for one that is not aligned), qual (B, L) uint8 0/1 or null (every base
// passes), all row-major and contiguous; acc (G * 7 + 1,) int32, added to
// in place. For each row and column l, with p, q its position and quality,
// p_prev, p_next its neighbours' positions (-1 past either end of the row)
// and q_next the next base's quality (0 past the end):
//   base       p >= 0, p < G, code <= 3, q            acc[7p + code]       += 1
//   deletion   p >= 0, p_next >= 0, p_next > p + 1,
//              q, q_next, p + 1 < G                    acc[7(p + 1) + 5]    += 1
//   insertion  p < 0, p_prev >= 0, a base at > l with
//              position >= 0, q, p_prev + 1 < G        acc[7(p_prev + 1) + 6] += 1
// the predicates of _pileup_positions_plain, term for term. acc[7G], the
// plain route's trash slot, is never written. Integer adds commute, so the
// counts equal the plain route's in any order of the atomics.
//
// What bounds it on this card: bytes. A full 10,000 x 152 chunk reads its
// codes and int32 positions once (7.6 MB, 2.3 us at 3.35 TB/s) and adds
// about 1.5 M counts into a 133 MB pileup (a 32-byte sector read and
// written each, about 96 MB, 29 us): about 31 us a chunk. The design:
//   * one warp a read; lane l holds column base + l of each 32-column step;
//   * the row's last aligned column comes first, by one ballot a step from
//     the right (a read's last base is nearly always aligned, so one step);
//     a row with none adds nothing and ends there;
//   * the neighbours' positions travel by __shfl_up_sync/__shfl_down_sync;
//     lane 0's left neighbour is carried from the step before, lane 31's
//     right neighbour is the next step's lane 0, loaded one step ahead;
//   * an atomicAdd whose result is unused (a RED) only where a predicate
//     holds: no masked slot costs an atomic, and the launch needs no host
//     sync and no compaction.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 7;  // A C G T N, deletion, insertion
constexpr int kDelCol = 5;
constexpr int kInsCol = 6;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename P>
__device__ __forceinline__ long long position_at(const P* row, int l, int L) {
  return l < L ? static_cast<long long>(row[l]) : -1ll;
}

__device__ __forceinline__ int quality_at(const uint8_t* row, int l, int L) {
  return l < L && (row == nullptr || row[l] != 0);
}

template <typename P>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
pileup_kernel(const uint8_t* __restrict__ codes,
              const P* __restrict__ positions,
              const uint8_t* __restrict__ qual, int32_t* __restrict__ acc,
              long long B, int L, long long G) {
  const long long b =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (b >= B) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const P* prow = positions + b * L;
  const uint8_t* crow = codes + b * L;
  const uint8_t* qrow = qual == nullptr ? nullptr : qual + b * L;

  int last = -1;  // the row's last column with a position >= 0
  for (int base = (L - 1) & ~31; base >= 0; base -= 32) {
    const unsigned m =
        __ballot_sync(kFull, position_at(prow, base + lane, L) >= 0);
    if (m != 0) {
      last = base + 31 - __clz(static_cast<int>(m));
      break;
    }
  }
  if (last < 0) return;  // the ballot is the warp's: it leaves together

  long long p = position_at(prow, lane, L);
  int q = quality_at(qrow, lane, L);
  long long left = -1;  // the position of the column before this step
  for (int base = 0; base <= last; base += 32) {
    const int l = base + lane;
    const long long p_ahead = position_at(prow, l + 32, L);
    const int q_ahead = quality_at(qrow, l + 32, L);
    long long p_prev = __shfl_up_sync(kFull, p, 1);
    long long p_next = __shfl_down_sync(kFull, p, 1);
    int q_next = __shfl_down_sync(kFull, q, 1);
    const long long p_ahead0 = __shfl_sync(kFull, p_ahead, 0);
    const int q_ahead0 = __shfl_sync(kFull, q_ahead, 0);
    const long long p_last = __shfl_sync(kFull, p, 31);
    if (lane == 0) p_prev = left;
    if (lane == 31) {
      p_next = p_ahead0;
      q_next = q_ahead0;
    }
    left = p_last;
    if (p >= 0) {  // so l < L
      const int c = crow[l];
      if (p < G && c <= 3 && q) atomicAdd(acc + p * kCols + c, 1);
      if (p_next >= 0 && p_next > p + 1 && q && q_next && p + 1 < G) {
        atomicAdd(acc + (p + 1) * kCols + kDelCol, 1);
      }
    } else if (p_prev >= 0 && l < last && q && p_prev + 1 < G) {
      atomicAdd(acc + (p_prev + 1) * kCols + kInsCol, 1);
    }
    p = p_ahead;
    q = q_ahead;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// pos_bytes is 4 (int32 positions) or 8 (int64); qual may be null.
int pileup_launch(const void* codes, const void* positions, int pos_bytes,
                  const void* qual, void* acc, long long B, int L, long long G,
                  void* stream) {
  if (B <= 0 || L <= 0 || G <= 0 || (pos_bytes != 4 && pos_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const uint8_t* pc = static_cast<const uint8_t*>(codes);
  const uint8_t* pq = static_cast<const uint8_t*>(qual);
  int32_t* pa = static_cast<int32_t*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pos_bytes == 4) {
    pileup_kernel<int32_t><<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, s>>>(
        pc, static_cast<const int32_t*>(positions), pq, pa, B, L, G);
  } else {
    pileup_kernel<int64_t><<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, s>>>(
        pc, static_cast<const int64_t*>(positions), pq, pa, B, L, G);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
