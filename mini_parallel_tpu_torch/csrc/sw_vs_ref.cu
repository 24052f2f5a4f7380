// Reads against one shared reference: exhaustive linear-gap Smith-Waterman
// on Hopper (sm_90a), the seed-free `--rescue` mapper of variant prep.
//
// Replaces the TPU kernel of the JAX package
//   mini_parallel_tpu/ops/sw_pallas.py:477  _sw_vs_ref_kernel
//                                           (sw_vs_ref_batch_pallas, :526)
//
// Contract: reads (B, M) uint8 padded with PAD_A, row-major and contiguous;
// ref (N,) uint8; rows (B,) int32, a permutation of the read indices whose
// first n_rows[0] entries are the reads to sweep (the wrapper puts every
// read that is not all pad there). For each swept read p:
//   score[p] = max(0, max_{i,j} H[i,j]),
//   H[i,j]   = max(0, H[i-1,j-1] + s(a_i, ref_j), H[i-1,j] - 2, H[i,j-1] - 2),
//   end[p]   = the smallest j of any cell with H[i,j] == score[p], or -1
//              when score[p] == 0.
// Reads that are not swept keep what the caller wrote (score 0, end -1): a
// read that is all pad scores 0 against anything, and skipping it is what
// makes rescue affordable (a 10,000-read chunk against a 4.7 Mbp reference
// is 7 x 10^12 cells, and all but the few seed-misses are blanked to pad).
//
// What bounds it on this card: integer operations. A read of 150 bases
// against 4.7 Mbp is 7 x 10^8 cells for 150 bytes of read. The design:
//   * one warp per read with the lane/row geometry of warp_pair.cuh: lane
//     l owns R rows and computes column t - l at step t; H crosses lanes
//     by __shfl_up_sync; state is G = H - 2 so a cell is one
//     __vimax3_s32_relu, as in sw_score.cu;
//   * the reference is streamed through shared-memory tiles of kTile bytes
//     that every warp of the block reads; lane 0 takes the new column's
//     byte and it travels down the lanes with the wavefront;
//   * each lane keeps its best score and the smallest column that reached
//     it; a lane's columns only increase, so a strict > is enough. A warp
//     reduction ends the read: the max score, then the min end among the
//     lanes at the max. Cells past the reference's end can hold H > 0 but
//     always less than the cell they came from, so they never reach the
//     max;
//   * int32 state is exact (|H| <= 2M); positions are int64 in the loop
//     and int32 out, so N may be any length up to 2^31 - 1;
//   * rows beyond 32 * R run in stripes whose bottom row goes through a
//     scratch row (N values per swept read) in device memory.
// Simple first: the reference is not split among warps, so a call with few
// reads to sweep runs on few SMs.

#include "warp_pair.cuh"

#include <limits.h>

namespace {

using namespace warp_pair;

constexpr int kGap = -2;
constexpr int kDiagMatch = 2 - kGap;
constexpr int kDiagMismatch = -1 - kGap;
constexpr int kGZero = 0 + kGap;
constexpr int kTile = 8192;  // reference bytes per shared-memory tile

template <int R>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sw_vs_ref_kernel(const uint8_t* __restrict__ reads,
                 const uint8_t* __restrict__ ref,
                 const int32_t* __restrict__ rows,
                 const int32_t* __restrict__ n_rows,
                 int32_t* __restrict__ score_out, int32_t* __restrict__ end_out,
                 int32_t* bound, int M, long long N) {
  __shared__ uint8_t tile[kTile];
  const int lane = threadIdx.x & 31;
  const long long n_active = n_rows[0];
  const long long first = (long long)blockIdx.x * kWarpsPerBlock;
  if (first >= n_active) return;  // the same for every thread of the block
  // a warp past the last swept read still joins the block's tile loads; it
  // sweeps a read of no rows and writes nothing
  const long long k = first + (threadIdx.x >> 5);
  const bool active = k < n_active;
  const long long read = active ? rows[k] : 0;
  const uint8_t* a_row = reads + read * M;
  int32_t* bound_row = (bound && active) ? bound + k * N : nullptr;
  const int stripe_rows = 32 * R;
  const int n_stripes = (M + stripe_rows - 1) / stripe_rows;
  const long long steps = N + 31;
  int best = 0;
  long long end = LLONG_MAX;

  for (int stripe = 0; stripe < n_stripes; ++stripe) {
    int ai[R];
    int g[R];
    const int row0 = stripe * stripe_rows + lane * R;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ai[r] = (active && row0 + r < M) ? (int)a_row[row0 + r] : kNoA;
      g[r] = kGZero;
    }
    const bool top = stripe == 0 || !active;
    const bool write_bound = active && stripe + 1 < n_stripes;
    int bj = kNoB;
    int b_chunk = kNoB;
    int g_up_prev = kGZero;
    int g_last = kGZero;
    int sbest = 0;  // this stripe's best and its smallest column
    long long send = LLONG_MAX;

    for (long long t0 = 0; t0 < steps; t0 += kTile) {
      __syncthreads();  // every warp is done with the previous tile
      for (int x = threadIdx.x; x < kTile; x += blockDim.x) {
        const long long c = t0 + x;
        tile[x] = c < N ? ref[c] : 0;
      }
      __syncthreads();
      const int span = (int)(steps - t0 < kTile ? steps - t0 : kTile);
      for (int u = 0; u < span; ++u) {
        const long long t = t0 + u;
        if ((u & 31) == 0) {
          b_chunk = t + lane < N ? (int)tile[u + lane] : kNoB;
        }
        const int b_new = __shfl_sync(kFullMask, b_chunk, u & 31);
        const int b_up = __shfl_up_sync(kFullMask, bj, 1);
        int g_up = __shfl_up_sync(kFullMask, g_last, 1);
        if (lane == 0) {
          bj = b_new;
          g_up = (top || t >= N) ? kGZero : bound_row[t];
        } else {
          bj = b_up;
        }
        int g_diag = g_up_prev;
        g_up_prev = g_up;
        int col_max = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int h = __vimax3_s32_relu(
              g_diag + (ai[r] == bj ? kDiagMatch : kDiagMismatch), g_up, g[r]);
          col_max = max(col_max, h);
          g_diag = g[r];
          g_up = h + kGap;
          g[r] = g_up;
        }
        g_last = g[R - 1];
        if (col_max > sbest) {
          sbest = col_max;
          send = t - lane;
        }
        if (write_bound && lane == 31 && t >= 31) {
          bound_row[t - 31] = g_last;  // column t - 31 < N
        }
      }
    }
    __syncwarp();  // the bottom row is visible to lane 0 in the next stripe
    // a later stripe revisits small columns: merge with the full tie-break
    if (sbest > best || (sbest == best && send < end)) {
      best = sbest;
      end = send;
    }
  }
  if (!active) return;
  const int gbest = __reduce_max_sync(kFullMask, best);
  // a lane at the max (> 0) reached it at a column inside [0, N)
  const int cand = (best == gbest && gbest > 0) ? (int)end : INT_MAX;
  const int gend = __reduce_min_sync(kFullMask, cand);
  if (lane == 0) {
    score_out[read] = gbest;
    end_out[read] = gbest > 0 ? gend : -1;
  }
}

}  // namespace

extern "C" {

// int32 values of scratch each swept read needs: N when M spans more than
// one stripe, else 0 (then `scratch` may be null).
long long sw_vs_ref_scratch_per_read(int M, long long N) {
  return striped(M) ? N : 0;
}

// Launches on `stream` for B reads (blocks past n_rows[0] exit at once)
// and returns cudaGetLastError() (0 on success). score and end must hold
// the values of the reads that are not swept (0 and -1).
int sw_vs_ref_launch(const void* reads, const void* ref, const void* rows,
                     const void* n_rows, void* score, void* end,
                     void* scratch, long long B, int M, long long N,
                     void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || N > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  if (sw_vs_ref_scratch_per_read(M, N) && scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const uint8_t* pa = static_cast<const uint8_t*>(reads);
  const uint8_t* pr = static_cast<const uint8_t*>(ref);
  const int32_t* prow = static_cast<const int32_t*>(rows);
  const int32_t* pn = static_cast<const int32_t*>(n_rows);
  int32_t* ps = static_cast<int32_t*>(score);
  int32_t* pe = static_cast<int32_t*>(end);
  int32_t* pb = static_cast<int32_t*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dispatch_rows(M, [&](auto r) {
    sw_vs_ref_kernel<decltype(r)::value>
        <<<blocks_for(B), 32 * kWarpsPerBlock, 0, s>>>(pa, pr, prow, pn, ps,
                                                       pe, pb, M, N);
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
