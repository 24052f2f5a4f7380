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
// What bounds it on this card: integer operations, plus the moves written
// to device memory (2 or 4 bits a cell, in 16- or 32-bit words). The
// design keeps the score kernels' geometry (warp_pair.cuh):
//   * one warp per pair; lane l owns R rows and computes column t - l at
//     step t; H (and F) cross lanes by __shfl_up_sync; rows past 32 * R run
//     in stripes through a scratch row;
//   * at step t a lane packs its R move codes into one word and the warp
//     stores 32 consecutive words (one coalesced store a step). The word of
//     cell (i, j) is moves[pair][stripe][j + l][l], code r = i mod R;
//   * each row keeps its best value and the first column reaching it over
//     the columns 0 <= j < N (a row's diagonal grows with j, so that is its
//     first diagonal); a reduction over the lane's rows and then the warp
//     gives (best, bd, bi) under the tie-break above;
//   * lane 0 then walks the pair's moves, read back from device memory
//     after __syncwarp, and writes the positions row the warp set to -1;
//   * one kernel template holds this scaffolding; a gap-model policy
//     (LinearGap, AffineGap) gives the cell update, the values carried
//     down a column and through the stripe scratch, and the walk step.
// State is int32 and exact; the TPU kernels' f32 state and their 2^24 and
// 2^20 guards are gone. Simple first: no 16-bit DP lanes, no shared-memory
// moves.

#include "warp_pair.cuh"

#include <limits.h>

namespace {

using namespace warp_pair;

constexpr int kMatch = 2;
constexpr int kMismatch = -1;
constexpr int kGap = -2;
constexpr int kNeg = -(1 << 24);
constexpr int kStop = 0, kDiag = 1, kUp = 2;  // LEFT = 3
constexpr int kESrc = 2;                      // affine H sources; F = 3

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
  using Word = uint16_t;
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
    const int code = h == 0 ? kStop : h == diag ? kDiag : h == c[0] ? kUp : 3;
    s = h + kGap;
    c[0] = s;
    return (unsigned)code;
  }
  // One step of the walk from cell (qi, ji); false at a STOP.
  __device__ bool step(int code, int& /*state*/, int& qi, int& ji,
                       int32_t* pos) const {
    if (code == kStop) return false;
    if (code == kDiag) {
      pos[qi] = ji;
      --qi;
      --ji;
    } else if (code == kUp) {
      --qi;
    } else {
      --ji;
    }
    return true;
  }
};

// Affine (Gotoh) gaps with runtime costs go, ge <= 0. A row carries H; F
// goes down the column with it; E stays in the row.
struct AffineGap {
  using Word = uint32_t;
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
    const int src = h == 0 ? kStop : h == diag ? kDiag : h == e_new ? kESrc : 3;
    const unsigned code = (unsigned)src | ((unsigned)(e >= e_open) << 2) |
                          ((unsigned)(c[1] >= f_open) << 3);
    s = h;
    e = e_new;
    c[0] = h;
    c[1] = f_new;
    return code;
  }
  // The 3-state walk: state 0 = H, 1 = E (gap along j, D), 2 = F (gap
  // along i, I).
  __device__ bool step(int code, int& state, int& qi, int& ji,
                       int32_t* pos) const {
    const bool eext = (code >> 2) & 1;
    const bool fext = (code >> 3) & 1;
    if (state == 0) {
      const int src = code & 3;
      if (src == kStop) return false;
      if (src == kDiag) {
        pos[qi] = ji;
        --qi;
        --ji;
      } else if (src == kESrc) {
        --ji;
        state = eext ? 1 : 0;
      } else {
        --qi;
        state = fext ? 2 : 0;
      }
    } else if (state == 1) {
      --ji;
      state = eext ? 1 : 0;
    } else {
      --qi;
      state = fext ? 2 : 0;
    }
    return true;
  }
};

template <typename Gap, int R>
__device__ int move_at(const typename Gap::Word* mv_pair, long long steps,
                       int qi, int ji) {
  const int stripe = qi / (32 * R);
  const int rem = qi - stripe * 32 * R;
  const int l = rem / R;
  const int r = rem - l * R;
  const unsigned w = mv_pair[((long long)stripe * steps + ji + l) * 32 + l];
  return (int)(w >> (Gap::kBits * r)) & ((1 << Gap::kBits) - 1);
}

template <typename Gap, int R>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sw_moves_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                int32_t* __restrict__ best_out, int32_t* __restrict__ bd_out,
                int32_t* __restrict__ bi_out, int32_t* __restrict__ pos_out,
                typename Gap::Word* moves, int32_t* bound, long long B, int M,
                int N, Gap gap) {
  using Word = typename Gap::Word;
  constexpr int kC = Gap::kCarry;
  const int lane = threadIdx.x & 31;
  const long long pair =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= B) return;  // the same for every lane of the warp
  const uint8_t* a_row = a + pair * M;
  const uint8_t* b_row = b + pair * N;
  int32_t* pos_row = pos_out + pair * M;
  for (int i = lane; i < M; i += 32) pos_row[i] = -1;
  const int stripe_rows = 32 * R;
  const int n_stripes = (M + stripe_rows - 1) / stripe_rows;
  const long long steps = (long long)N + 31;
  Word* mv_pair = moves + pair * n_stripes * steps * 32;
  // a stripe's bottom row: N values of each carry
  int32_t* bound_pair = bound ? bound + pair * kC * N : nullptr;
  Cand cand{0, INT_MAX, INT_MAX};

  for (int stripe = 0; stripe < n_stripes; ++stripe) {
    int ai[R], s[R], e[R], rb[R], rj[R];
    const int row0 = stripe * stripe_rows + lane * R;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ai[r] = row0 + r < M ? (int)a_row[row0 + r] : kNoA;
      gap.start_row(s[r], e[r], row0 + r);
      rb[r] = 0;
      rj[r] = 0;
    }
    const bool top = stripe == 0;
    const bool write_bound = stripe + 1 < n_stripes;
    Word* mv = mv_pair + stripe * steps * 32 + lane;
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
      unsigned word = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int s_prev = s[r];
        int h;
        word |= gap.cell(ul, ai[r] == bj ? kMatch : kMismatch, s[r], e[r], c,
                         h)
                << (Gap::kBits * r);
        if (valid && h > rb[r]) {
          rb[r] = h;
          rj[r] = j;
        }
        ul = s_prev;
      }
#pragma unroll
      for (int k = 0; k < kC; ++k) c_last[k] = c[k];
      mv[(long long)t * 32] = (Word)word;
      if (write_bound && lane == 31 && t >= 31) {
#pragma unroll
        for (int k = 0; k < kC; ++k) {
          bound_pair[k * N + t - 31] = c_last[k];  // column t - 31 < N
        }
      }
    }
    __syncwarp();  // bottom row and moves visible to every lane
    fold_rows<R>(cand, rb, rj, row0, M);
  }
  int best, bd, bi;
  reduce_cand(cand, best, bd, bi);
  if (lane != 0) return;
  best_out[pair] = best;
  bd_out[pair] = bd;
  bi_out[pair] = bi;
  if (best <= 0) return;
  int qi = bi, ji = bd - bi;
  int state = 0;
  while (qi >= 0 && ji >= 0 &&
         gap.step(move_at<Gap, R>(mv_pair, steps, qi, ji), state, qi, ji,
                  pos_row)) {
  }
}

}  // namespace

extern "C" {

// Rows each lane owns (R) and the stripe count for M rows: the moves
// buffer of one pair is n_stripes * (N + 31) * 32 words, 16-bit (linear)
// or 32-bit (affine), word [stripe][j + l][l] holding row r at bits
// 2r (linear) or 4r (affine) for cell (stripe * 32R + l * R + r, j).
int sw_moves_rows_per_lane(int M) { return rows_per_lane(M); }

long long sw_moves_words_per_pair(int M, int N) {
  const int rows = 32 * rows_per_lane(M);
  return (long long)((M + rows - 1) / rows) * ((long long)N + 31) * 32;
}

// int32 values of bound scratch each pair needs when M spans more than one
// stripe (N linear, 2N affine), else 0 (then `bound` may be null).
int sw_moves_bound_per_pair(int M, int N, int affine) {
  return striped(M) ? (affine ? 2 * N : N) : 0;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// positions (B, M) int32; moves holds B * sw_moves_words_per_pair words.
int sw_moves_launch(const void* a, const void* b, void* best, void* bd,
                    void* bi, void* positions, void* moves, void* bound,
                    long long B, int M, int N, int affine, int gap_open,
                    int gap_extend, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || moves == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
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
  int32_t* o_bound = static_cast<int32_t*>(bound);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dispatch_rows(M, [&](auto r) {
    constexpr int kR = decltype(r)::value;
    const unsigned grid = blocks_for(B);
    if (affine) {
      sw_moves_kernel<AffineGap, kR><<<grid, 32 * kWarpsPerBlock, 0, s>>>(
          pa, pb, o_best, o_bd, o_bi, o_pos, static_cast<uint32_t*>(moves),
          o_bound, B, M, N, AffineGap{gap_open, gap_extend});
    } else {
      sw_moves_kernel<LinearGap, kR><<<grid, 32 * kWarpsPerBlock, 0, s>>>(
          pa, pb, o_best, o_bd, o_bi, o_pos, static_cast<uint16_t*>(moves),
          o_bound, B, M, N, LinearGap{});
    }
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
