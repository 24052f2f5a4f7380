// A group of consecutive full-height column strips of ONE long pair,
// Smith-Waterman with linear or affine (Gotoh) gaps, on Hopper (sm_90a).
//
// Replaces the two strip kernels of the JAX package's long-pair engine:
//   mini_parallel_tpu/ops/sw_long.py:71   _strip_kernel        (via _run_strip, :177)
//   mini_parallel_tpu/ops/sw_long.py:539  _strip_kernel_affine (via _run_strip_affine, :650)
// The host loop that walks the groups and carries the boundary column(s)
// from one group to the next stays in Python (ops/sw_long.py); each group
// is one launch on the current stream.
//
// Contract of one group (j0 = the group's first column of b; S strips of
// W columns, the last one W_last <= W wide):
//   a (M,) uint8: every row;  b (Wtot,) uint8: the group's columns;
//   left_h (M,) int32 = H[i][j0-1]  (0 for the first group);
//   left_f (M,) int32 = F[i][j0-1]  (affine only; NEG for the first group)
//   -> right_h (M,) = H[i][j0+Wtot-1], right_f (M,) = F[i][j0+Wtot-1]
//      (affine), best (1,) raised by atomicMax to max(0, max of H over the
//      group's cells); the caller zeroes it.
// With one strip (W = Wtot) this is the one-strip contract.
//
// Row bands (ops/sw_long.py: the sharded host loop cuts the rows into
// bands, and a band below the first has a real top row). Optional:
//   top_h (Wtot + 1,) int32 = [H[r0-1][j0-1], H[r0-1][j0 .. j0+Wtot-1]]:
//         the row above the group's first row r0, led by the corner the
//         first column's diagonal needs;
//   top_e (Wtot,) int32 = E[r0-1][j0 ..] (affine);
//   -> bottom_h (Wtot + 1,) = [left_h[M-1], H[r0+M-1][j0 ..]] and
//      bottom_e (Wtot,) = E[r0+M-1][j0 ..] (affine): the group's last row,
//      laid out as the next band's top row.
// The rows come all together or not at all. Without them the true edge
// (H = 0, E = NEG) holds, and a variant compiled without the band code
// (kBand = false) runs: callers without bands see the contract above.
// Linear: H = max(0, H[i-1][j-1] + s, H[i-1][j] - 2, H[i][j-1] - 2).
// Affine, in the JAX long engine's names (gap of length L costs go + L*ge):
//   E[i][j] = max(E[i-1][j], H[i-1][j] + go) + ge   (gap along i: stays in
//                                                    its column)
//   F[i][j] = max(F[i][j-1], H[i][j-1] + go) + ge   (gap along j: crosses
//                                                    strips, so it is carried)
//   H[i][j] = max(0, H[i-1][j-1] + s, E[i][j], F[i][j]).
// s = +2 on equal bytes, -1 otherwise; without a top row the row above
// the first sees H = 0, E = NEG.
// W and Wtot are multiples of kCols (the host pads b with PAD_B columns,
// which never raise the max and whose right column is not used).
//
// What bounds it on this card: integer operations, not bytes. A strip
// reads M + W bytes and moves 8M (linear) or 16M (affine) bytes of
// boundary columns for M * W cells of 7-11 int32 ops each. The design:
//   * one block sweeps one strip as a wavefront: thread t owns kCols
//     consecutive columns and computes row i = s - t at step s, with every
//     DP value in registers (each column's H above, and E, affine). The H
//     (and F) of a thread's last column crosses to thread t+1 by
//     __shfl_up_sync inside a warp, and through a double-buffered shared
//     slot between warps (one __syncthreads per step; a one-warp strip,
//     the host's default, needs neither). Each cell is one
//     __vimax3_s32_relu (plus two __viaddmax_s32 for the affine gap
//     states): Hopper's DPX instructions;
//   * the strips of a group run at once on many SMs, pipelined down the
//     rows: the block of strip k writes its right column into a per-strip
//     column buffer and, after every kRowChunk rows, publishes its row
//     count with a release store; warp 0 of strip k+1 reads that column
//     32 rows a lane, one chunk ahead of use, after an acquire load has
//     seen the count cover the chunk;
//   * a block takes its strip from a ticket (atomicAdd on a counter that
//     the launch zeroes), not from blockIdx, and takes the next ticket when
//     it is done. So a strip only ever waits on a strip that a running
//     block holds, whatever the scheduling and however many blocks fit;
//     a wait that outlasts kSpinLimitNs traps (the launch fails) rather
//     than hanging;
//   * a band's row above only seeds those registers before the sweep, and
//     its last row is written from them after it: the step loop is the
//     same with or without bands (a template flag, kBand, compiles the
//     band variant apart);
//   * the best score meets in one int32 atomicMax per warp and strip;
//   * int32 state is exact (|H| <= 2 min(M, N)); NEG = -2^24 only ever
//     meets H + go with H >= 0, so it never accumulates.

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
constexpr int kNoB = -2;           // column past the strip: equals no byte
constexpr int kRowChunk = 32;      // rows per published count: one a lane
constexpr unsigned long long kSpinLimitNs = 10000000000ull;  // 10 s

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Returns once *count >= need (every lane that calls it has acquired the
// rows below it); traps after kSpinLimitNs: only a fault can wait so long.
__device__ __forceinline__ int wait_rows(const int* count, int need,
                                         int avail) {
  if (avail >= need) return avail;
  const unsigned long long t0 = global_ns();
  while ((avail = load_acquire(count)) < need) {
    if (global_ns() - t0 > kSpinLimitNs) __trap();
    __nanosleep(64);
  }
  return avail;
}

struct Group {
  const uint8_t* a;
  const uint8_t* b;
  const int32_t* left_h;
  const int32_t* left_f;
  int32_t* right_h;
  int32_t* right_f;
  const int32_t* top_h;  // (Wtot + 1): corner, then the row above; or null
  const int32_t* top_e;  // (Wtot): E of the row above (affine); or null
  int32_t* bottom_h;     // (Wtot + 1): left_h[M-1], then the last row
  int32_t* bottom_e;     // (Wtot): E of the last row (affine)
  int32_t* buf_h;   // (S - 1) x M: the right H column of strips 0..S-2
  int32_t* buf_f;   // the same for F (affine)
  int* flags;       // S - 1 published row counts, then the ticket counter
  int* best;
  int M, W, Wtot, S, go, ge;
};

template <bool kAffine, bool kOneWarp, bool kBand>
__device__ __forceinline__ void sweep_strip(const Group& g, int k,
                                            int (*hand_h)[kMaxWarps],
                                            int (*hand_f)[kMaxWarps]) {
  const int M = g.M;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int j0 = k * g.W;
  const int width = g.Wtot - j0 < g.W ? g.Wtot - j0 : g.W;
  const int groups = width / kCols;      // threads that own columns
  const bool has_cols = t < groups;
  const bool owner = t == groups - 1;    // owns the strip's last column
  const int32_t* lh = k == 0 ? g.left_h : g.buf_h + (long long)(k - 1) * M;
  const int32_t* lf = k == 0 ? g.left_f : g.buf_f + (long long)(k - 1) * M;
  const bool last = k == g.S - 1;
  int32_t* rh = last ? g.right_h : g.buf_h + (long long)k * M;
  int32_t* rf = last ? g.right_f : g.buf_f + (long long)k * M;
  const int* in_count = k == 0 ? nullptr : g.flags + (k - 1);
  int* out_count = last ? nullptr : g.flags + k;

  const int col0 = j0 + t * kCols;  // the group's index of column 0
  const bool top = kBand && has_cols;
  int bc[kCols];  // b of this thread's columns
  int hu[kCols];  // H of each column at the row above
  int eu[kCols];  // E of each column at the row above (affine)
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    bc[c] = has_cols ? (int)g.b[col0 + c] : kNoB;
    hu[c] = top ? g.top_h[1 + col0 + c] : 0;
    eu[c] = kAffine && top ? g.top_e[col0 + c] : kNeg;
  }
  if (kBand && k == 0 && t == 0) g.bottom_h[0] = lh[M - 1];
  int best = 0;
  int diag_in = top ? g.top_h[col0] : 0;  // H[i-1][first column - 1]
  int pub_h = 0;                 // H of this thread's last column, its row
  int pub_f = kNeg;              // F of the same cell (affine)
  int a_cur = (int)g.a[0];       // a of this thread's next row
  // warp 0: the carried-in column, lane l holding row 32c + l of chunk c
  // (cur) and of chunk c + 1 (nxt), loaded one chunk ahead of use
  int avail = in_count ? 0 : M;  // rows of the carried-in column published
  int cur_h = 0, cur_f = kNeg, nxt_h = 0, nxt_f = kNeg;
  if (warp == 0) {
    avail = wait_rows(in_count, M < kRowChunk ? M : kRowChunk, avail);
    if (lane < M) {
      nxt_h = lh[lane];
      if (kAffine) nxt_f = lf[lane];
    }
  }
  const int steps = M + groups - 1;
  for (int s = 0; s < steps; ++s) {
    const int i = s - t;
    int in_h = __shfl_up_sync(kFullMask, pub_h, 1);
    int in_f = kAffine ? __shfl_up_sync(kFullMask, pub_f, 1) : 0;
    if (!kOneWarp && lane == 0 && warp > 0) {
      in_h = hand_h[(s + 1) & 1][warp - 1];  // lane 31 of warp-1, step s-1
      if (kAffine) in_f = hand_f[(s + 1) & 1][warp - 1];
    }
    if (warp == 0 && s < M) {  // thread 0's row is s
      if ((s & (kRowChunk - 1)) == 0) {
        cur_h = nxt_h;
        cur_f = nxt_f;
        const int r = s + kRowChunk + lane;  // the chunk after this one
        if (s + kRowChunk < M) {
          const int need = s + 2 * kRowChunk < M ? s + 2 * kRowChunk : M;
          avail = wait_rows(in_count, need, avail);
          if (r < M) {
            nxt_h = lh[r];
            if (kAffine) nxt_f = lf[r];
          }
        }
      }
      const int lh_s = __shfl_sync(kFullMask, cur_h, s & (kRowChunk - 1));
      const int lf_s = kAffine ? __shfl_sync(kFullMask, cur_f,
                                             s & (kRowChunk - 1)) : 0;
      if (t == 0) {
        in_h = lh_s;
        in_f = lf_s;
      }
    }
    if (has_cols && i >= 0 && i < M) {
      const int ai = a_cur;
      if (i + 1 < M) a_cur = (int)g.a[i + 1];
      int diag = diag_in;
      int left = in_h;
      int fl = in_f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int sc = ai == bc[c] ? kMatch : kMismatch;
        int h;
        if (kAffine) {
          const int e = __viaddmax_s32(hu[c], g.go, eu[c]) + g.ge;
          const int f = __viaddmax_s32(left, g.go, fl) + g.ge;
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
        rh[i] = left;
        if (kAffine) rf[i] = fl;
        // the release orders this thread's column writes before the count
        if (out_count && (((i + 1) & (kRowChunk - 1)) == 0 || i + 1 == M)) {
          store_release(out_count, i + 1);
        }
      }
      diag_in = in_h;
    }
    if (!kOneWarp) {
      if (lane == 31) {
        hand_h[s & 1][warp] = pub_h;
        if (kAffine) hand_f[s & 1][warp] = pub_f;
      }
      __syncthreads();
    }
  }
  // a thread's last step was its row M - 1: its registers hold that row
  if (top) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      g.bottom_h[1 + col0 + c] = hu[c];
      if (kAffine) g.bottom_e[col0 + c] = eu[c];
    }
  }
  best = __reduce_max_sync(kFullMask, best);
  if (lane == 0 && best > 0) atomicMax(g.best, best);
}

template <bool kAffine, bool kOneWarp, bool kBand>
__global__ void __launch_bounds__(kOneWarp ? 32 : kMaxThreads)
sw_group_kernel(const Group g) {
  // hand-off of the last column between warps, by step parity
  __shared__ int hand_h[2][kMaxWarps];
  __shared__ int hand_f[2][kMaxWarps];
  __shared__ int ticket;
  int* const next_ticket = g.flags + (g.S - 1);
  for (;;) {
    if (threadIdx.x == 0) ticket = atomicAdd(next_ticket, 1);
    __syncthreads();
    const int k = ticket;
    __syncthreads();  // every thread has read the ticket
    if (k >= g.S) return;
    sweep_strip<kAffine, kOneWarp, kBand>(g, k, hand_h, hand_f);
  }
}

int check_shape(int M, int W, int Wtot) {
  if (M <= 0 || W <= 0 || W % kCols != 0 || W > kCols * kMaxThreads ||
      Wtot <= 0 || Wtot % kCols != 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

unsigned threads_for(int W) { return (unsigned)((W / kCols + 31) / 32 * 32); }

// Blocks of sw_group_kernel that the card holds at once, or -1.
template <bool kAffine, bool kOneWarp, bool kBand>
long long resident(unsigned threads) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sw_group_kernel<kAffine, kOneWarp, kBand>, (int)threads,
          0) !=
          cudaSuccess) {
    return -1;
  }
  return (long long)sms * (per_sm > 0 ? per_sm : 1);
}

template <bool kAffine>
long long resident_for(int W) {
  const unsigned threads = threads_for(W);
  return threads == 32 ? resident<kAffine, true, false>(threads)
                       : resident<kAffine, false, false>(threads);
}

template <bool kAffine, bool kOneWarp, bool kBand>
int launch(const Group& g, unsigned threads, cudaStream_t stream) {
  // every block that fits at once; tickets keep any count correct
  const long long fit = resident<kAffine, kOneWarp, kBand>(threads);
  if (fit <= 0) {
    const cudaError_t q = cudaGetLastError();
    return (int)(q ? q : cudaErrorInvalidValue);
  }
  const unsigned blocks = (unsigned)(g.S < fit ? g.S : fit);
  cudaError_t e = cudaMemsetAsync(g.flags, 0, sizeof(int) * (size_t)g.S,
                                  stream);
  if (e) return (int)e;
  sw_group_kernel<kAffine, kOneWarp, kBand><<<blocks, threads, 0, stream>>>(
      g);
  return (int)cudaGetLastError();
}

template <bool kAffine>
int launch_group(Group g, void* stream) {
  if (int rc = check_shape(g.M, g.W, g.Wtot)) return rc;
  g.S = (g.Wtot + g.W - 1) / g.W;
  if (g.S > 1 && (g.buf_h == nullptr || (kAffine && g.buf_f == nullptr)))
    return (int)cudaErrorInvalidValue;
  // a band gives every row pointer, a group without one none of them
  const bool band = g.top_h != nullptr;
  if (band != (g.bottom_h != nullptr) ||
      (kAffine && (band != (g.top_e != nullptr) ||
                   band != (g.bottom_e != nullptr))))
    return (int)cudaErrorInvalidValue;
  const unsigned threads = threads_for(g.W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (band)
    return threads == 32 ? launch<kAffine, true, true>(g, threads, s)
                         : launch<kAffine, false, true>(g, threads, s);
  return threads == 32 ? launch<kAffine, true, false>(g, threads, s)
                       : launch<kAffine, false, false>(g, threads, s);
}

}  // namespace

extern "C" {

// Blocks of strip width W that the card holds at once (the most strips of
// a group that run together), or -1 on a bad width or a failed query.
long long sw_long_resident_blocks(int W, int affine) {
  if (check_shape(1, W, W)) return -1;
  return affine ? resident_for<true>(W) : resident_for<false>(W);
}

// Strip widths W and group widths Wtot must be multiples of kCols = 16,
// W at most 8192 (ops/sw_long.py: WIDTH_MULTIPLE, MAX_STRIP_WIDTH). The
// group has S = ceil(Wtot / W) strips; buf_h (and buf_f) hold (S - 1) x M
// int32 (null when S = 1) and flags S int32, zeroed here. top_* and
// bottom_* are a band's rows (all given, or all null for the true edge).
// Each entry launches on `stream` and returns cudaGetLastError().
int sw_long_group_launch(const void* a, int M, const void* b, int W,
                         int Wtot, const void* left_h, void* right_h,
                         const void* top_h, void* bottom_h, void* buf_h,
                         void* flags, void* best, void* stream) {
  Group g{};
  g.a = static_cast<const uint8_t*>(a);
  g.b = static_cast<const uint8_t*>(b);
  g.left_h = static_cast<const int32_t*>(left_h);
  g.right_h = static_cast<int32_t*>(right_h);
  g.top_h = static_cast<const int32_t*>(top_h);
  g.bottom_h = static_cast<int32_t*>(bottom_h);
  g.buf_h = static_cast<int32_t*>(buf_h);
  g.flags = static_cast<int*>(flags);
  g.best = static_cast<int*>(best);
  g.M = M;
  g.W = W;
  g.Wtot = Wtot;
  return launch_group<false>(g, stream);
}

int sw_affine_long_group_launch(const void* a, int M, const void* b, int W,
                                int Wtot, const void* left_h,
                                const void* left_f, void* right_h,
                                void* right_f, const void* top_h,
                                const void* top_e, void* bottom_h,
                                void* bottom_e, void* buf_h, void* buf_f,
                                void* flags, void* best, int gap_open,
                                int gap_extend, void* stream) {
  if (gap_open > 0 || gap_extend > 0) return (int)cudaErrorInvalidValue;
  Group g{};
  g.a = static_cast<const uint8_t*>(a);
  g.b = static_cast<const uint8_t*>(b);
  g.left_h = static_cast<const int32_t*>(left_h);
  g.left_f = static_cast<const int32_t*>(left_f);
  g.right_h = static_cast<int32_t*>(right_h);
  g.right_f = static_cast<int32_t*>(right_f);
  g.top_h = static_cast<const int32_t*>(top_h);
  g.top_e = static_cast<const int32_t*>(top_e);
  g.bottom_h = static_cast<int32_t*>(bottom_h);
  g.bottom_e = static_cast<int32_t*>(bottom_e);
  g.buf_h = static_cast<int32_t*>(buf_h);
  g.buf_f = static_cast<int32_t*>(buf_f);
  g.flags = static_cast<int*>(flags);
  g.best = static_cast<int*>(best);
  g.M = M;
  g.W = W;
  g.Wtot = Wtot;
  g.go = gap_open;
  g.ge = gap_extend;
  return launch_group<true>(g, stream);
}

}  // extern "C"
