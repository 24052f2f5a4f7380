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
// read that is not all pad there). For each read p:
//   score[p] = max(0, max_{i,j} H[i,j]),
//   H[i,j]   = max(0, H[i-1,j-1] + s(a_i, ref_j), H[i-1,j] - 2, H[i,j-1] - 2),
//   end[p]   = the smallest j of any cell with H[i,j] == score[p], or -1
//              when score[p] == 0.
// Reads that are not swept get (0, -1): a read that is all pad scores 0
// against anything, and skipping it is what makes rescue affordable (a
// 10,000-read chunk against a 4.7 Mbp reference is 7 x 10^12 cells, and
// all but the few seed-misses are blanked to pad).
//
// What bounds it on this card: integer operations. A read of 150 bases
// against 4.7 Mbp is 7 x 10^8 cells for 150 bytes of read, and a --rescue
// chunk sweeps only a few hundred reads, so one warp per read would leave
// most of the card idle. The design splits the reference among warps:
//   * a work item is (swept read, segment of `seg` reference columns); the
//     grid is persistent, sized from the SM count, and each warp strides
//     over the n_rows[0] x n_seg items, so the launch needs no host sync;
//   * a segment that owns columns [s, e) starts its DP 2M columns early,
//     at c0 = max(0, s - 2M), with H = 0 on that left edge and on the top
//     row. That is exact on [s, e): a local path with d diagonal steps
//     (d <= M) spanning S columns scores at most 2d - 2(S - d) <= 4M - 2S,
//     so a path of positive score spans fewer than 2M columns and lies
//     wholly inside the window; the zero edge can only lower a value;
//   * inside an item, the warp geometry of warp_pair.cuh: lane l owns R
//     rows and computes window column t - l at step t; H crosses lanes by
//     __shfl_up_sync; state is G = H - 2 so a cell is one
//     __vimax3_s32_relu, as in sw_score.cu. Each lane loads the reference
//     bytes of the next 32 steps one chunk ahead (through L2: the
//     reference is a few MB), and they travel down the lanes with the
//     wavefront;
//   * each lane keeps the best score of its OWN columns (>= s) and the
//     smallest column that reached it (a lane's columns only increase, so
//     a strict > is enough); the warp reduces to (max score, then smallest
//     end). Cells right of e see no reference byte: they can hold H > 0
//     but always less than an own cell they came from, so they never reach
//     the max;
//   * segments of one read meet in one 64-bit atomicMax on the key
//     (score << 32) | (INT_MAX - end), which orders by score and then by
//     the smaller end; a second small kernel decodes the keys into score
//     and end (-1 at score 0);
//   * int32 state is exact (|H| <= 2M); N may be any length up to
//     2^31 - 1;
//   * rows beyond 32 * R run in stripes whose bottom row goes through a
//     scratch row of min(seg + 2M, N) values per warp of the grid; such a
//     grid is capped so that its rows stay within kScratchBytes.

#include "warp_pair.cuh"

#include <limits.h>

namespace {

using namespace warp_pair;

constexpr int kGap = -2;
constexpr int kDiagMatch = 2 - kGap;
constexpr int kDiagMismatch = -1 - kGap;
constexpr int kGZero = 0 + kGap;
// segments are a multiple of this many columns and at least 20 warm-ups
// wide, so the warm-up costs at most 5% more cells
constexpr int kSegmentUnit = 8192;
constexpr int kWarmUpsPerSegment = 20;
// the scratch rows of a striped launch (M > 256) stay within this
constexpr long long kScratchBytes = 1ll << 28;

__host__ __device__ int warm_up(int M) { return 2 * M; }

// int32 values of one warp's scratch row: its widest window
__host__ __device__ long long scratch_row(int M, long long N, int seg) {
  const long long w = (long long)seg + warm_up(M);
  return w < N ? w : N;
}

int default_segment(int M) {
  const long long want = (long long)kWarmUpsPerSegment * warm_up(M);
  const long long units = (want + kSegmentUnit - 1) / kSegmentUnit;
  return (int)(units < 1 ? kSegmentUnit : units * kSegmentUnit);
}

// One work item: the read `a_row` against the window `win` of `width`
// columns, of which columns >= `own` are the segment's own. Returns the
// segment's key in every lane: 0 when no own cell is > 0.
template <int R>
__device__ __forceinline__ unsigned long long sweep_segment(
    const uint8_t* __restrict__ a_row, const uint8_t* __restrict__ win,
    long long c0, int width, int own, int M, int32_t* bound_row) {
  const int lane = threadIdx.x & 31;
  const int stripe_rows = 32 * R;
  const int n_stripes = (M + stripe_rows - 1) / stripe_rows;
  const int steps = width + 31;
  int best = 0;
  int end = INT_MAX;

  for (int stripe = 0; stripe < n_stripes; ++stripe) {
    int ai[R];
    int g[R];
    const int row0 = stripe * stripe_rows + lane * R;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ai[r] = row0 + r < M ? (int)a_row[row0 + r] : kNoA;
      g[r] = kGZero;
    }
    const bool top = stripe == 0;
    const bool write_bound = stripe + 1 < n_stripes;
    int bj = kNoB;
    int b_chunk = kNoB;
    int b_next = lane < width ? (int)__ldg(win + lane) : kNoB;
    int g_up_prev = kGZero;
    int g_last = kGZero;
    int sbest = 0;  // this stripe's best own cell and its smallest column
    int send = INT_MAX;

    for (int t = 0; t < steps; ++t) {
      if ((t & 31) == 0) {  // the next 32 columns, loaded one chunk ahead
        b_chunk = b_next;
        const int c = t + 32 + lane;
        b_next = c < width ? (int)__ldg(win + c) : kNoB;
      }
      const int b_new = __shfl_sync(kFullMask, b_chunk, t & 31);
      const int b_up = __shfl_up_sync(kFullMask, bj, 1);
      int g_up = __shfl_up_sync(kFullMask, g_last, 1);
      if (lane == 0) {
        bj = b_new;
        g_up = (top || t >= width) ? kGZero : bound_row[t];
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
      const int col = t - lane;
      if (col_max > sbest && col >= own) {
        sbest = col_max;
        send = col;
      }
      if (write_bound && lane == 31 && t >= 31) {
        bound_row[t - 31] = g_last;  // window column t - 31 < width
      }
    }
    __syncwarp();  // the bottom row is visible to lane 0 in the next stripe
    // a later stripe revisits small columns: merge with the full tie-break
    if (sbest > best || (sbest == best && send < end)) {
      best = sbest;
      end = send;
    }
  }
  const int gbest = __reduce_max_sync(kFullMask, best);
  // a lane at the max (> 0) reached it at an own column inside the window
  const int cand = (best == gbest && gbest > 0) ? end : INT_MAX;
  const int gend = __reduce_min_sync(kFullMask, cand);
  if (gbest == 0) return 0ull;
  const long long at = c0 + gend;  // < N <= INT_MAX
  return ((unsigned long long)gbest << 32) |
         (unsigned long long)(unsigned)(INT_MAX - (int)at);
}

template <int R>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sw_vs_ref_kernel(const uint8_t* __restrict__ reads,
                 const uint8_t* __restrict__ ref,
                 const int32_t* __restrict__ rows,
                 const int32_t* __restrict__ n_rows,
                 unsigned long long* __restrict__ keys, int32_t* scratch,
                 int M, long long N, int seg, long long n_seg) {
  const int lane = threadIdx.x & 31;
  const long long n_active = n_rows[0];
  const long long n_items = n_active * n_seg;
  const long long warp = (long long)blockIdx.x * kWarpsPerBlock +
                         (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * kWarpsPerBlock;
  const int warm = warm_up(M);
  int32_t* bound_row =
      scratch ? scratch + warp * scratch_row(M, N, seg) : nullptr;
  // consecutive warps take the same segment of consecutive reads
  for (long long w = warp; w < n_items; w += n_warps) {
    const long long k = w % n_active;
    const long long s = (w / n_active) * seg;
    const long long e = s + seg < N ? s + seg : N;
    const long long c0 = s > warm ? s - warm : 0;
    const int read = rows[k];
    const unsigned long long key = sweep_segment<R>(
        reads + (long long)read * M, ref + c0, c0, (int)(e - c0),
        (int)(s - c0), M, bound_row);
    if (lane == 0 && key != 0ull) atomicMax(keys + read, key);
    __syncwarp();  // lane 0's scratch reads are done before the next item
  }
}

__global__ void decode_keys(const unsigned long long* __restrict__ keys,
                            int32_t* __restrict__ score_out,
                            int32_t* __restrict__ end_out, long long B) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  const unsigned long long key = keys[p];
  const int score = (int)(key >> 32);
  score_out[p] = score;
  end_out[p] = score > 0 ? INT_MAX - (int)(unsigned)(key & 0xffffffffull)
                         : -1;
}

long long segments(long long N, int seg) { return (N + seg - 1) / seg; }

// Blocks of the persistent grid: as many as the card holds at once, no
// more than the items B reads could give, and for a striped M no more than
// kScratchBytes of scratch rows allow.
template <int R>
int grid_blocks(int M, long long N, int seg, long long B, long long n_seg) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sw_vs_ref_kernel<R>, 32 * kWarpsPerBlock, 0) !=
          cudaSuccess) {
    return 0;
  }
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long wanted = (B * n_seg + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (wanted < blocks) blocks = wanted;
  if (striped(M)) {
    const long long fit =
        kScratchBytes / (4 * kWarpsPerBlock * scratch_row(M, N, seg));
    blocks = fit < 1 ? 1 : (fit < blocks ? fit : blocks);
  }
  return (int)blocks;
}

int blocks_for_launch(int M, long long N, int seg, long long B,
                      long long n_seg) {
  int blocks = 0;
  dispatch_rows(M, [&](auto r) {
    blocks = grid_blocks<decltype(r)::value>(M, N, seg, B, n_seg);
  });
  return blocks;
}

}  // namespace

extern "C" {

// The segment width the launch takes for `seg` = 0.
int sw_vs_ref_default_segment(int M) { return default_segment(M); }

// int32 values of scratch the launch needs for B reads: a row of
// min(seg + 2M, N) values per warp of the grid when M spans more than one
// stripe, else 0 (then `scratch` may be null); -1 on a bad shape or when
// the card cannot be queried. So it never holds more rows than B x the
// segments (rounded up to a block), nor more than kScratchBytes beyond
// one block's rows.
long long sw_vs_ref_scratch(long long B, int M, long long N, int seg) {
  if (B <= 0 || M <= 0 || N <= 0 || seg < 0) return -1;
  if (!striped(M)) return 0;
  if (seg == 0) seg = default_segment(M);
  const int blocks = blocks_for_launch(M, N, seg, B, segments(N, seg));
  if (blocks <= 0) return -1;
  return (long long)blocks * kWarpsPerBlock * scratch_row(M, N, seg);
}

// Launches on `stream` for B reads (seg = 0: the default segment width)
// and returns cudaGetLastError() (0 on success). `keys` (B,) uint64 must
// be zero; score and end (B,) int32 are written for every read.
int sw_vs_ref_launch(const void* reads, const void* ref, const void* rows,
                     const void* n_rows, void* keys, void* score, void* end,
                     void* scratch, long long B, int M, long long N, int seg,
                     void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || N > INT_MAX || seg < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (seg == 0) seg = default_segment(M);
  if ((long long)seg + warm_up(M) > INT_MAX) return (int)cudaErrorInvalidValue;
  if (striped(M) && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const long long n_seg = segments(N, seg);
  const int blocks = blocks_for_launch(M, N, seg, B, n_seg);
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  const uint8_t* pa = static_cast<const uint8_t*>(reads);
  const uint8_t* pr = static_cast<const uint8_t*>(ref);
  const int32_t* prow = static_cast<const int32_t*>(rows);
  const int32_t* pn = static_cast<const int32_t*>(n_rows);
  unsigned long long* pk = static_cast<unsigned long long*>(keys);
  int32_t* pb = static_cast<int32_t*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dispatch_rows(M, [&](auto r) {
    sw_vs_ref_kernel<decltype(r)::value>
        <<<blocks, 32 * kWarpsPerBlock, 0, s>>>(pa, pr, prow, pn, pk, pb, M,
                                                N, seg, n_seg);
  });
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  decode_keys<<<(unsigned)((B + 255) / 256), 256, 0, s>>>(
      pk, static_cast<int32_t*>(score), static_cast<int32_t*>(end), B);
  return (int)cudaGetLastError();
}

}  // extern "C"
