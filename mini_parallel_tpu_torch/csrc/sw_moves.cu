// Batched Smith-Waterman with traceback on Hopper (sm_90a): the move code
// of every cell, the argmax cell, and the walk from it to per-base
// reference positions, linear and affine (Gotoh) gaps in one source.
//
// Replaces the two traceback TPU kernels of the JAX package
//   mini_parallel_tpu/ops/sw_traceback.py:148  _moves_kernel_factory
//                                              (sw_moves_batch_pallas, :225)
//   mini_parallel_tpu/ops/sw_traceback.py:800  _affine_moves_kernel_factory
//                                              (sw_affine_moves_batch_pallas, :880)
// and fuses the walks that the JAX package runs after them as plain XLA
// (_positions_walk_packed :700, _affine_walk_packed :948): the kernel still
// computes the same function, (best, bd, bi, positions).
//
// Contract: a (B, M) uint8 padded with PAD_A, b (B, N) uint8 padded with
// PAD_B, row-major and contiguous; every cell (i, j) of the padded matrix:
//   linear: H = max(0, diag, up, left) with diag = H[i-1,j-1] + s,
//           up = H[i-1,j] - 2, left = H[i,j-1] - 2; s = +2 equal, -1 not.
//           move = STOP(0) if H == 0, else DIAG(1) if H == diag, else
//           UP(2) if H == up, else LEFT(3).
//   affine: E = max(E[i,j-1], H[i,j-1] + go) + ge, eext = E[i,j-1] >=
//           H[i,j-1] + go; F = max(F[i-1,j], H[i-1,j] + go) + ge, fext =
//           F[i-1,j] >= H[i-1,j] + go; H = max(0, diag, E, F); move =
//           src | eext << 2 | fext << 3 with src STOP if H == 0, DIAG if
//           H == diag, else E(2) if H == E, else F(3).
// Boundaries are those of the JAX scans (sw_traceback.py:292, :505): H = 0
// left of column 0 and above row 0, F = NEG above row 0, and E entering
// column 0 is NEG on row 0 and go + ge on every other row (the scans sweep
// those rows through columns j < 0 first, where E settles at go + ge).
// best is the max H over the cells with 0 <= j < N; (bd, bi) is the cell at
// the max with the smallest diagonal i + j, then the smallest row
// (0, 0 when best == 0). The walk starts at (bi, bd - bi) and follows the
// moves until a STOP or the matrix edge; positions[p, i] = j for every
// DIAG step, -1 elsewhere. The affine walk is the 3-state machine of the
// JAX walk: in state H a source E (F) emits the D (I) step at once and
// takes this cell's eext (fext) bit as the next state.
//
// What bounds it on this card: instruction issue, and with it the warps an
// SM holds. A warp's step is a chain of dependent instructions, so the SM
// issues near its peak only with 24 or more warps (on an H100, the kernel
// with its moves in device memory, held to 12 warps an SM by unused shared
// memory, ran 1.72x (linear) and 1.46x (affine) slower). The design keeps
// the score kernels' geometry (warp_pair.cuh) and each pair's moves on the
// SM:
//   * one warp per pair; lane l owns R rows and computes column t - l at
//     step t; H (and F) cross lanes by __shfl_up_sync; rows past 32 * R run
//     in stripes through a scratch row;
//   * a cell's move code comes from selects: a nested ?: compiles to a
//     branch and a reconvergence per cell, which cuts a warp's issue rate
//     (on an H100 the selects took the kernel from 0.99x to 0.80x of the
//     time of the device-memory design that wrote every move to a global
//     buffer, on a 10,000 x 152 vs 184 --gapped chunk);
//   * a lane gathers each row's move codes of kCodes consecutive steps
//     (16 linear, 8 affine) in a 32-bit word, one funnel shift a cell, and
//     stores its R words every kCodes steps, all lanes at once. Word w of
//     row i = l * R + r holds the codes of steps w * kCodes + k at bits
//     kBits * k and sits at [w][l * P + r], P = R | 1: an odd pitch puts the
//     32 lanes' stores of one row in 32 different banks;
//   * this (step, row) layout is skewed: a row's N columns span N + 31
//     steps, so a stripe takes ceil((N + 31) / kCodes) words a row, 8.75 KB
//     a pair linear and 16.9 KB affine at 152 x 184: 24 and 12 warps an SM.
//     A dense (row, column) layout (7.5 / 14.4 KB) needs each lane to store
//     at its own columns, a store branch every step, and measured 4% slower
//     (linear, before the selects, both beside the global-buffer design);
//   * the moves stay in shared memory when the pair is one stripe (M <=
//     256) and they fit in kMaxMovesBytes. Otherwise (rows past one
//     stripe, or very long windows) the same code writes them to a
//     device-memory buffer the caller gives, stripe by stripe. For affine
//     gaps the residency costs warps: with the moves in device memory the
//     kernel measured 0.6127 ms against 0.6836 ms on the SM (the global-
//     buffer design: 0.7480); the moves stay on the SM, so that no buffer
//     exists for the walk alone;
//   * each row keeps its best value and the first column reaching it over
//     the columns 0 <= j < N (a row's diagonal grows with j, so that is its
//     first diagonal); a reduction over the lane's rows and then the warp
//     gives (best, bd, bi) under the tie-break above;
//   * lane 0 then walks the pair's moves and writes the positions row the
//     warp set to -1. The walk is issue-bound too: a step is a few
//     instructions because the cell's lane, row and word offset follow the
//     walk instead of being divided out of (qi, ji) (46 SASS instructions a
//     step when divided);
//   * the moves leave the SM only when the caller asks for them (the
//     exactness checks): then the warp copies them out, coalesced, after
//     its sweep;
//   * one kernel template holds this scaffolding; a gap-model policy
//     (LinearGap, AffineGap) gives the cell update, the values carried
//     down a column and through the stripe scratch, and the walk's move.
// State is int32 and exact; the TPU kernels' f32 state and their 2^24 and
// 2^20 guards are gone.

#include "warp_pair.cuh"

#include <limits.h>

namespace {

using namespace warp_pair;

constexpr int kMatch = 2;
constexpr int kMismatch = -1;
constexpr int kGap = -2;
constexpr int kNeg = -(1 << 24);
constexpr int kStop = 0, kDiag = 1, kUp = 2, kLeft = 3;
constexpr int kESrc = 2;                      // affine H sources; F = 3
// moves of one warp kept in shared memory at most (4 warps a block fit in
// the 227 KB a block may use)
constexpr int kMaxMovesBytes = 48 * 1024;

// The moves layout of one stripe: words a row spans and the pitch of a
// lane's rows (see the header).
__host__ __device__ constexpr int row_pitch(int R) { return R | 1; }
__host__ __device__ constexpr int codes_per_word(int bits) { return 32 / bits; }
__host__ __device__ inline int stripe_words(int R, int bits, int N) {
  const int codes = codes_per_word(bits);
  return (N + 31 + codes - 1) / codes * 32 * row_pitch(R);
}

// The per-pair argmax candidate, compared as (value desc, diagonal asc,
// row asc).
struct Cand {
  int v, d, i;
  __device__ void offer(int v2, int d2, int i2) {
    if (v2 > v || (v2 == v && (d2 < d || (d2 == d && i2 < i)))) {
      v = v2;
      d = d2;
      i = i2;
    }
  }
};

// Folds a stripe's per-row bests (value, first column) into the lane's
// candidate; rows past M and rows that never left 0 do not compete.
template <int R>
__device__ void fold_rows(Cand& c, const int (&rb)[R], const int (&rj)[R],
                          int row0, int M) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (row0 + r < M && rb[r] > 0) c.offer(rb[r], row0 + r + rj[r], row0 + r);
  }
}

// Warp-wide (best, bd, bi) from each lane's candidate.
__device__ void reduce_cand(const Cand& c, int& best, int& bd, int& bi) {
  best = __reduce_max_sync(kFullMask, c.v);
  const int d = __reduce_min_sync(kFullMask, c.v == best ? c.d : INT_MAX);
  bi = __reduce_min_sync(kFullMask,
                         (c.v == best && c.d == d) ? c.i : INT_MAX);
  bd = d;
  if (best <= 0) {
    bd = 0;
    bi = 0;
  }
}

// Linear gaps. The value a row carries is G = H - 2, as in sw_score.cu:
// the G-form operands are the H candidates themselves (diag = G_diag - kGap
// + s = H_diag + s, up = G_up, left = G_left).
struct LinearGap {
  static constexpr int kBits = 2;
  static constexpr int kCarry = 1;  // G, down the column

  __device__ void top(int (&c)[kCarry]) const { c[0] = kGap; }
  __device__ void start_row(int& s, int& /*e*/, int /*row*/) const {
    s = kGap;
  }
  // One cell: `ul` is the carried value up-left, `s` this row's at the
  // previous column, `c` the carry from the row above (then this cell's).
  // Sets h to H and returns the move code.
  __device__ unsigned cell(int ul, int sub, int& s, int& /*e*/,
                           int (&c)[kCarry], int& h) const {
    const int diag = ul - kGap + sub;
    h = __vimax3_s32_relu(diag, c[0], s);
    // selects, not a chain of ?: that nvcc turns into a branch per cell
    int code = h == c[0] ? kUp : kLeft;
    code = h == diag ? kDiag : code;
    code = h == 0 ? kStop : code;
    s = h + kGap;
    c[0] = s;
    return (unsigned)code;
  }
  // The walk's move out of a cell with this code: the code itself.
  __device__ int move(int code, int& /*state*/) const { return code; }
};

// Affine (Gotoh) gaps with runtime costs go, ge <= 0. A row carries H; F
// goes down the column with it; E stays in the row.
struct AffineGap {
  static constexpr int kBits = 4;
  static constexpr int kCarry = 2;  // H, F
  int go, ge;

  __device__ void top(int (&c)[kCarry]) const {
    c[0] = 0;
    c[1] = kNeg;
  }
  // E entering a lane's first column, as the JAX scan has it (see the
  // contract): NEG on row 0, go + ge below.
  __device__ void start_row(int& s, int& e, int row) const {
    s = 0;
    e = row == 0 ? kNeg : go + ge;
  }
  __device__ unsigned cell(int ul, int sub, int& s, int& e, int (&c)[kCarry],
                           int& h) const {
    const int e_open = s + go;
    const int e_new = max(e, e_open) + ge;
    const int f_open = c[0] + go;
    const int f_new = max(c[1], f_open) + ge;
    const int diag = ul + sub;
    h = __vimax3_s32_relu(diag, e_new, f_new);
    int src = h == e_new ? kESrc : 3;  // selects, as in LinearGap::cell
    src = h == diag ? kDiag : src;
    src = h == 0 ? kStop : src;
    const unsigned code = (unsigned)src | ((unsigned)(e >= e_open) << 2) |
                          ((unsigned)(c[1] >= f_open) << 3);
    s = h;
    e = e_new;
    c[0] = h;
    c[1] = f_new;
    return code;
  }
  // The 3-state walk: state 0 = H, 1 = E (gap along j, D), 2 = F (gap
  // along i, I). Returns the move out of the cell (kStop, kDiag, kUp,
  // kLeft) and sets the next state: in H a source E (F) moves left (up)
  // at once and takes this cell's eext (fext) bit as the next state.
  __device__ int move(int code, int& state) const {
    const int eext = (code >> 2) & 1;
    const int fext = (code >> 3) & 1;
    if (state == 1) {
      state = eext;
      return kLeft;
    }
    if (state == 2) {
      state = 2 * fext;
      return kUp;
    }
    const int src = code & 3;
    if (src == kESrc) {
      state = eext;
      return kLeft;
    }
    if (src == 3) {
      state = 2 * fext;
      return kUp;
    }
    return src;  // kStop or kDiag
  }
};

// The walk from cell (qi, ji) through a pair's moves (stripe by stripe,
// `words` words each), setting positions[qi] = ji at every DIAG move. It
// runs on one lane while the warp's other lanes wait, so each step is a
// few instructions: the cell's lane l, row r and pitch offset l * P + r
// follow the walk instead of being divided out of qi.
template <typename Gap, int R>
__device__ void walk(const Gap& gap, const uint32_t* mv, int words, int qi,
                     int ji, int32_t* pos) {
  constexpr int kP = row_pitch(R);
  constexpr int kCodes = codes_per_word(Gap::kBits);
  constexpr int kLog = kCodes == 16 ? 4 : 3;
  static_assert(kCodes == 1 << kLog, "codes a word: 16 or 8");
  const int stripe = qi / (32 * R);
  const int rem = qi - stripe * 32 * R;
  int l = rem / R;
  int r = rem - l * R;
  int lr = l * kP + r;
  const uint32_t* base = mv + (long long)stripe * words;
  int state = 0;
  while (true) {
    const int t = ji + l;  // the step that computed the cell
    const uint32_t w = base[(t >> kLog) * 32 * kP + lr];
    const int code = (int)(w >> (Gap::kBits * (t & (kCodes - 1)))) &
                     ((1 << Gap::kBits) - 1);
    const int move = gap.move(code, state);
    if (move == kStop) return;
    if (move == kDiag) pos[qi] = ji;
    if (move != kUp && --ji < 0) return;  // DIAG or LEFT
    if (move != kLeft) {                  // DIAG or UP
      if (--qi < 0) return;
      if (r > 0) {
        --r;
        --lr;
      } else if (l > 0) {  // up into the lane above
        r = R - 1;
        --l;
        lr -= kP - R + 1;
      } else {  // up into the stripe above
        r = R - 1;
        l = 31;
        lr = 31 * kP + R - 1;
        base -= words;
      }
    }
  }
}

// on_chip: the pair's moves stay in this warp's slice of dynamic shared
// memory (one stripe only); else they go to `moves`, which then holds
// n_stripes * stripe_words words a pair. With on_chip, a non-null `moves`
// receives a copy of them.
template <typename Gap, int R>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sw_moves_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                int32_t* __restrict__ best_out, int32_t* __restrict__ bd_out,
                int32_t* __restrict__ bi_out, int32_t* __restrict__ pos_out,
                uint32_t* moves, int32_t* bound, long long B, int M, int N,
                bool on_chip, Gap gap) {
  extern __shared__ uint32_t warp_moves[];
  constexpr int kC = Gap::kCarry;
  constexpr int kP = row_pitch(R);
  constexpr int kCodes = codes_per_word(Gap::kBits);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long pair = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (pair >= B) return;  // the same for every lane of the warp
  const uint8_t* a_row = a + pair * M;
  const uint8_t* b_row = b + pair * N;
  int32_t* pos_row = pos_out + pair * M;
  for (int i = lane; i < M; i += 32) pos_row[i] = -1;
  const int stripe_rows = 32 * R;
  const int n_stripes = (M + stripe_rows - 1) / stripe_rows;
  const int words = stripe_words(R, Gap::kBits, N);
  uint32_t* mv_pair = moves ? moves + pair * n_stripes * words : nullptr;
  uint32_t* mv_smem = warp_moves + warp * words;
  // a stripe's bottom row: N values of each carry
  int32_t* bound_pair = bound ? bound + pair * kC * N : nullptr;
  Cand cand{0, INT_MAX, INT_MAX};

  for (int stripe = 0; stripe < n_stripes; ++stripe) {
    int ai[R], s[R], e[R], rb[R], rj[R];
    unsigned acc[R];
    const int row0 = stripe * stripe_rows + lane * R;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ai[r] = row0 + r < M ? (int)a_row[row0 + r] : kNoA;
      gap.start_row(s[r], e[r], row0 + r);
      rb[r] = 0;
      rj[r] = 0;
      acc[r] = 0;
    }
    const bool top = stripe == 0;
    const bool write_bound = stripe + 1 < n_stripes;
    uint32_t* mv = (on_chip ? mv_smem : mv_pair + stripe * words) + lane * kP;
    int bj = kNoB;
    int b_chunk = kNoB;
    int c_last[kC];
    gap.top(c_last);
    int up_prev = c_last[0];

    for (int t = 0; t < N + 31; ++t) {
      if ((t & 31) == 0) {
        const int j = t + lane;
        b_chunk = j < N ? (int)b_row[j] : kNoB;
      }
      const int b_new = __shfl_sync(kFullMask, b_chunk, t & 31);
      const int b_up = __shfl_up_sync(kFullMask, bj, 1);
      int c[kC];
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        c[k] = __shfl_up_sync(kFullMask, c_last[k], 1);
      }
      if (lane == 0) {
        bj = b_new;
        if (top || t >= N) {
          gap.top(c);
        } else {
#pragma unroll
          for (int k = 0; k < kC; ++k) c[k] = bound_pair[k * N + t];
        }
      } else {
        bj = b_up;
      }
      int ul = up_prev;
      up_prev = c[0];
      const int j = t - lane;
      const bool valid = (unsigned)j < (unsigned)N;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int s_prev = s[r];
        int h;
        const unsigned code =
            gap.cell(ul, ai[r] == bj ? kMatch : kMismatch, s[r], e[r], c, h);
        // this step's code enters at the top; after kCodes steps the word
        // holds step w * kCodes + k at bits kBits * k
        acc[r] = __funnelshift_r(acc[r], code, Gap::kBits);
        if (valid && h > rb[r]) {
          rb[r] = h;
          rj[r] = j;
        }
        ul = s_prev;
      }
      if ((t & (kCodes - 1)) == kCodes - 1) {  // the same step for every lane
#pragma unroll
        for (int r = 0; r < R; ++r) mv[t / kCodes * 32 * kP + r] = acc[r];
      }
#pragma unroll
      for (int k = 0; k < kC; ++k) c_last[k] = c[k];
      if (write_bound && lane == 31 && t >= 31) {
#pragma unroll
        for (int k = 0; k < kC; ++k) {
          bound_pair[k * N + t - 31] = c_last[k];  // column t - 31 < N
        }
      }
    }
    const int tail = (N + 31) % kCodes;  // steps in the last, partial word
    if (tail) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        mv[(N + 31) / kCodes * 32 * kP + r] =
            acc[r] >> (Gap::kBits * (kCodes - tail));
      }
    }
    __syncwarp();  // bottom row and moves visible to every lane
    fold_rows<R>(cand, rb, rj, row0, M);
  }
  if (on_chip && mv_pair) {  // the caller asked for the moves
    for (int k = lane; k < words; k += 32) mv_pair[k] = mv_smem[k];
  }
  int best, bd, bi;
  reduce_cand(cand, best, bd, bi);
  if (lane != 0) return;
  best_out[pair] = best;
  bd_out[pair] = bd;
  bi_out[pair] = bi;
  if (best <= 0) return;
  walk<Gap, R>(gap, on_chip ? mv_smem : mv_pair, words, bi, bd - bi,
               pos_row);
}

// Shared-memory bytes a block of kWarpsPerBlock warps needs to keep its
// pairs' moves, or 0 when they go to device memory.
template <typename Gap, int R>
int on_chip_bytes(int M, int N) {
  if (M > 32 * R) return 0;
  const long long bytes = 4LL * stripe_words(R, Gap::kBits, N);
  return bytes <= kMaxMovesBytes ? (int)bytes * kWarpsPerBlock : 0;
}

template <typename Gap, int R>
int launch(const uint8_t* a, const uint8_t* b, int32_t* best, int32_t* bd,
           int32_t* bi, int32_t* pos, uint32_t* moves, int32_t* bound,
           long long B, int M, int N, Gap gap, cudaStream_t s) {
  const int smem = on_chip_bytes<Gap, R>(M, N);
  if (smem == 0 && moves == nullptr) return (int)cudaErrorInvalidValue;
  auto kernel = sw_moves_kernel<Gap, R>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks_for(B), 32 * kWarpsPerBlock, smem, s>>>(
      a, b, best, bd, bi, pos, moves, bound, B, M, N, smem > 0, gap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Whether a pair's moves stay in shared memory (1) or need a device-memory
// buffer of moves words (0): rows past one stripe, or windows too long.
// The buffer, and the copy that return_moves asks for, hold for each pair
// n_stripes * ceil((N + 31) / (32 / bits)) * 32 * (R | 1) uint32 words in
// the layout of the header (bits = 2 linear, 4 affine), with
// R = rows_per_lane(M) and n_stripes = ceil(M / 32R).
int sw_moves_on_chip(int M, int N, int affine) {
  int bytes = 0;
  dispatch_rows(M, [&](auto r) {
    constexpr int kR = decltype(r)::value;
    bytes = affine ? on_chip_bytes<AffineGap, kR>(M, N)
                   : on_chip_bytes<LinearGap, kR>(M, N);
  });
  return bytes > 0;
}

// int32 values of bound scratch each pair needs when M spans more than one
// stripe (N linear, 2N affine), else 0 (then `bound` may be null).
int sw_moves_bound_per_pair(int M, int N, int affine) {
  return striped(M) ? (affine ? 2 * N : N) : 0;
}

// Launches on `stream` and returns the CUDA error (0 on success).
// positions (B, M) int32, set by the kernel. `moves` may be null when
// sw_moves_on_chip(M, N, affine); otherwise it holds the moves words above.
int sw_moves_launch(const void* a, const void* b, void* best, void* bd,
                    void* bi, void* positions, void* moves, void* bound,
                    long long B, int M, int N, int affine, int gap_open,
                    int gap_extend, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if (affine && (gap_open > 0 || gap_extend > 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (sw_moves_bound_per_pair(M, N, affine) && bound == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const uint8_t* pa = static_cast<const uint8_t*>(a);
  const uint8_t* pb = static_cast<const uint8_t*>(b);
  int32_t* o_best = static_cast<int32_t*>(best);
  int32_t* o_bd = static_cast<int32_t*>(bd);
  int32_t* o_bi = static_cast<int32_t*>(bi);
  int32_t* o_pos = static_cast<int32_t*>(positions);
  uint32_t* o_moves = static_cast<uint32_t*>(moves);
  int32_t* o_bound = static_cast<int32_t*>(bound);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = 0;
  dispatch_rows(M, [&](auto r) {
    constexpr int kR = decltype(r)::value;
    rc = affine ? launch<AffineGap, kR>(pa, pb, o_best, o_bd, o_bi, o_pos,
                                        o_moves, o_bound, B, M, N,
                                        AffineGap{gap_open, gap_extend}, s)
                : launch<LinearGap, kR>(pa, pb, o_best, o_bd, o_bi, o_pos,
                                        o_moves, o_bound, B, M, N,
                                        LinearGap{}, s);
  });
  return rc;
}

}  // extern "C"
