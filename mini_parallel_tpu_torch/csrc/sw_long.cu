// One full-height column strip of ONE long pair, Smith-Waterman with
// linear or affine (Gotoh) gaps, on Hopper (sm_90a).
//
// Replaces the two strip kernels of the JAX package's long-pair engine:
//   mini_parallel_tpu/ops/sw_long.py:71   _strip_kernel        (via _run_strip, :177)
//   mini_parallel_tpu/ops/sw_long.py:539  _strip_kernel_affine (via _run_strip_affine, :650)
// The host loop that walks the strips and carries the boundary column(s)
// from one strip to the next stays in Python (ops/sw_long.py), as it does
// in the JAX package; each strip is one launch on the current stream.
//
// Contract of one strip (j0 = the strip's first column of b):
//   a (M,) uint8: every row;  b (W,) uint8: the strip's W columns;
//   left_h (M,) int32 = H[i][j0-1]  (0 for the first strip);
//   left_f (M,) int32 = F[i][j0-1]  (affine only; NEG for the first strip)
//   -> right_h (M,) = H[i][j0+W-1], right_f (M,) = F[i][j0+W-1] (affine),
//      best (1,) = max(0, max of H over the strip's cells).
// Linear: H = max(0, H[i-1][j-1] + s, H[i-1][j] - 2, H[i][j-1] - 2).
// Affine, in the JAX long engine's names (gap of length L costs go + L*ge):
//   E[i][j] = max(E[i-1][j], H[i-1][j] + go) + ge   (gap along i: stays in
//                                                    its column)
//   F[i][j] = max(F[i][j-1], H[i][j-1] + go) + ge   (gap along j: crosses
//                                                    strips, so it is carried)
//   H[i][j] = max(0, H[i-1][j-1] + s, E[i][j], F[i][j]).
// s = +2 on equal bytes, -1 otherwise; the top row sees H = 0, E = NEG.
// W is a multiple of kCols (the host pads a ragged last strip with PAD_B
// columns, which never raise the max and whose right column is not used).
//
// What bounds it on this card: integer operations, not bytes. A strip
// reads M + W bytes and moves 8M (linear) or 16M (affine) bytes of
// boundary columns for M * W cells of 7-9 int32 ops each. So the design
// keeps every DP value in registers:
//   * one thread block sweeps the whole strip as a wavefront: thread t owns
//     kCols consecutive columns and computes row i = s - t at step s. Each
//     column's H above (and E, affine) stays in the thread's registers;
//   * the H (and F) of a thread's last column crosses to thread t+1 by
//     __shfl_up_sync inside a warp, and through a double-buffered shared
//     slot between warps, with one __syncthreads per step;
//   * thread 0 reads the carried-in column, one row ahead of its use, and
//     the owner of column W-1 writes the carried-out column;
//   * each cell is one __vimax3_s32_relu (plus two __viaddmax_s32 for the
//     affine gap states): Hopper's DPX instructions;
//   * int32 state is exact (|H| <= 2 min(M, N)); NEG = -2^24 only ever
//     meets H + go with H >= 0, so it never accumulates.
// Memory stays O(M + N). This uses ONE SM per strip and the strips run one
// after another: a multi-block pipelined wavefront (row-progress flags
// between the blocks of consecutive strips) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kCols = 16;          // columns per thread
constexpr int kMaxThreads = 512;   // W <= kCols * kMaxThreads = 8192
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMatch = 2;
constexpr int kMismatch = -1;
constexpr int kGap = -2;
constexpr int kNeg = -(1 << 24);
constexpr int kNoB = -2;           // column past W: equals no byte

template <bool kAffine>
__global__ void __launch_bounds__(kMaxThreads)
sw_strip_kernel(const uint8_t* __restrict__ a, int M,
                const uint8_t* __restrict__ b, int W,
                const int32_t* __restrict__ left_h,
                const int32_t* __restrict__ left_f,
                int32_t* __restrict__ right_h, int32_t* __restrict__ right_f,
                int32_t* __restrict__ best_out, int go, int ge) {
  // hand-off of the last column between warps, by step parity
  __shared__ int hand_h[2][kMaxWarps];
  __shared__ int hand_f[2][kMaxWarps];
  __shared__ int warp_best[kMaxWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int groups = W / kCols;          // threads that own columns
  const bool has_cols = t < groups;
  const bool owner = t == groups - 1;    // owns column W - 1
  int bc[kCols];  // b of this thread's columns
  int hu[kCols];  // H of each column at the row above
  int eu[kCols];  // E of each column at the row above (affine)
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    bc[c] = has_cols ? (int)b[t * kCols + c] : kNoB;
    hu[c] = 0;
    eu[c] = kNeg;
  }
  int best = 0;
  int diag_in = 0;               // H[i-1][first column - 1]
  int pub_h = 0;                 // H of this thread's last column, its row
  int pub_f = kNeg;              // F of the same cell (affine)
  int a_cur = (int)a[0];         // a of this thread's next row
  int lh_next = 0, lf_next = kNeg;  // thread 0: carried column, next row
  if (t == 0) {
    lh_next = left_h[0];
    if (kAffine) lf_next = left_f[0];
  }
  const int steps = M + groups - 1;
  for (int s = 0; s < steps; ++s) {
    const int i = s - t;
    int in_h = __shfl_up_sync(kFullMask, pub_h, 1);
    int in_f = kAffine ? __shfl_up_sync(kFullMask, pub_f, 1) : 0;
    if (lane == 0 && warp > 0) {  // written by lane 31 of warp-1 at step s-1
      in_h = hand_h[(s + 1) & 1][warp - 1];
      if (kAffine) in_f = hand_f[(s + 1) & 1][warp - 1];
    }
    if (t == 0) {
      in_h = lh_next;
      in_f = lf_next;
      if (i + 1 < M) {
        lh_next = left_h[i + 1];
        if (kAffine) lf_next = left_f[i + 1];
      }
    }
    if (has_cols && i >= 0 && i < M) {
      const int ai = a_cur;
      if (i + 1 < M) a_cur = (int)a[i + 1];
      int diag = diag_in;
      int left = in_h;
      int fl = in_f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int sc = ai == bc[c] ? kMatch : kMismatch;
        int h;
        if (kAffine) {
          const int e = __viaddmax_s32(hu[c], go, eu[c]) + ge;
          const int f = __viaddmax_s32(left, go, fl) + ge;
          h = __vimax3_s32_relu(diag + sc, e, f);
          eu[c] = e;
          fl = f;
        } else {
          h = __vimax3_s32_relu(diag + sc, hu[c] + kGap, left + kGap);
        }
        best = max(best, h);
        diag = hu[c];
        hu[c] = h;
        left = h;
      }
      pub_h = left;
      pub_f = fl;
      if (owner) {
        right_h[i] = left;
        if (kAffine) right_f[i] = fl;
      }
      diag_in = in_h;
    }
    if (lane == 31) {
      hand_h[s & 1][warp] = pub_h;
      if (kAffine) hand_f[s & 1][warp] = pub_f;
    }
    __syncthreads();
  }
  best = __reduce_max_sync(kFullMask, best);
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (t == 0) {
    int m = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m = max(m, warp_best[w]);
    best_out[0] = m;
  }
}

int check_shape(int M, int W) {
  if (M <= 0 || W <= 0 || W % kCols != 0 || W > kCols * kMaxThreads)
    return (int)cudaErrorInvalidValue;
  return 0;
}

unsigned threads_for(int W) {
  const int groups = W / kCols;
  return (unsigned)((groups + 31) / 32 * 32);
}

}  // namespace

extern "C" {

// A strip width must be a multiple of kCols = 16, at most 8192
// (ops/sw_long.py: WIDTH_MULTIPLE, MAX_STRIP_WIDTH). Each entry launches
// one block on `stream` and returns cudaGetLastError().
int sw_long_strip_launch(const void* a, int M, const void* b, int W,
                         const void* left_h, void* right_h, void* best,
                         void* stream) {
  if (int rc = check_shape(M, W)) return rc;
  sw_strip_kernel<false><<<1, threads_for(W), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), M, static_cast<const uint8_t*>(b), W,
      static_cast<const int32_t*>(left_h), nullptr,
      static_cast<int32_t*>(right_h), nullptr, static_cast<int32_t*>(best),
      0, 0);
  return (int)cudaGetLastError();
}

int sw_affine_long_strip_launch(const void* a, int M, const void* b, int W,
                                const void* left_h, const void* left_f,
                                void* right_h, void* right_f, void* best,
                                int gap_open, int gap_extend, void* stream) {
  if (int rc = check_shape(M, W)) return rc;
  if (gap_open > 0 || gap_extend > 0) return (int)cudaErrorInvalidValue;
  sw_strip_kernel<true><<<1, threads_for(W), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), M, static_cast<const uint8_t*>(b), W,
      static_cast<const int32_t*>(left_h),
      static_cast<const int32_t*>(left_f), static_cast<int32_t*>(right_h),
      static_cast<int32_t*>(right_f), static_cast<int32_t*>(best), gap_open,
      gap_extend);
  return (int)cudaGetLastError();
}

}  // extern "C"
