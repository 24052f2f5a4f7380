// Batched Pair-HMM forward on Hopper (sm_90a), in float32 and float64.
//
// Replaces the TPU kernel
//   mini_parallel_tpu/ops/pairhmm_pallas.py:49  _pairhmm_kernel_factory
//   (launched by pairhmm_batch_pallas, pairhmm_pallas.py:112)
// and, in float64, the JAX package's host recompute of the lanes that
// underflow float32 (pairhmm_forward_numpy, a Python double loop there).
//
// Contract: a (B, M) uint8 reads padded with PAD_A, err (B, M) T per-base
// error probabilities, b (B, N) uint8 haplotypes padded with PAD_B, la/lb
// (B,) int32 lengths (la <= M, lb <= N), row-major and contiguous ->
// out (B,) T = log10 P(read | hap) of the forward
//   M[i,j] = prior * ((tMM M[i-1,j-1] + tIM I[i-1,j-1]) + tDM D[i-1,j-1])
//   I[i,j] = tMI M[i-1,j] + tII I[i-1,j]
//   D[i,j] = tMD M[i,j-1] + tDD D[i,j-1]       (tMD = tMI, tDD = tII, tDM = tIM)
// prior = 1 - e on equal bytes, else e * (1/3); boundary D[0,j] = scale / lb;
// total = sum over j < lb of M[la,j] + I[la,j], in column order;
// out = log10(total) - offset, or -inf when la or lb is 0 or the total is
// below the smallest normal of T. float32 runs with scale 2^120 and offset
// 120 log10(2) (the TPU kernel's numbers); float64 with 1 and 0.
//
// Arithmetic is IEEE round-to-nearest by intrinsic (__fmul_rn, __dadd_rn...):
// nvcc would otherwise contract a*b + c into one FMA that rounds once where
// the plain version (one torch op at a time) rounds twice, so with them the
// DP totals equal the plain version's bit for bit. No -ftz: the TPU flushes
// denormals, but a lane's verdict comes from the FLT_MIN rule on its total,
// so a denormal total never reaches a log10; a denormal intermediate cell
// carries its true (if short) mass, as it does in the plain version on the
// card, which keeps denormals too.
//
// What bounds it on this card: instruction issue. The recurrence is 12
// roundings a cell (an FMA would fuse two), but a thread also spends
// instructions a step on what is not a cell: the hap byte and the row above
// crossing lanes (__shfl_up_sync), the boundary row, the column checks,
// register moves. One warp per (read, hap) lane, R = 5 rows a thread at
// M = 152, spends ~150 SASS instructions a step for 66 FP ones, and a
// 101-column lane takes 132 steps, 31 of them the wavefront's ramp
// (measured on an H100: 129-150 issue cycles a warp-step). So the design
// cuts what is not a cell:
//   * a group of 16 lanes sweeps one (read, hap) lane, two lanes a warp;
//     thread g of a group owns R = ceil(M / 16) <= 10 consecutive read rows
//     and keeps their bases, priors and the M, I, D values of its previous
//     column in registers (no shared memory). A step's fixed cost is paid
//     for 2R rows, and the ramp is 15 steps, not 31;
//   * at step t thread g computes column t - g of its rows; the row above
//     its band (M, I, D of thread g-1's bottom row, one column back) crosses
//     by __shfl_up_sync within the group, and the haplotype byte travels
//     down the group the same way after entering at thread 0 (16 bytes
//     loaded per 16 steps);
//   * the two lanes of a warp sweep as many steps and stripes as the longer
//     needs; the other's extra steps and stripes touch nothing it reports;
//   * float32 is capped at 102 registers (20 warps an SM, from 16 at its
//     natural 125): a warp-per-lane kernel at 19 warps still showed
//     latency, and on an H100 the cap measured 0.2566 against 0.2831 ms on
//     20,000 lanes of a genotype run; float64 keeps its registers (a cap
//     spills: 0.4971 against 0.3950 ms);
//   * the thread that owns the final read row adds M + I of each column < lb
//     as it passes, so the sum runs in column order as on the TPU;
//   * rows past 16 R (M > 160) run in stripes; a stripe's bottom row (M, I,
//     D per column) goes to a scratch row in device memory that the caller
//     allocates, and is the next stripe's top. Only the stripes up to the
//     final read row and the columns below lb feed the result.
// The float64 lanes are bound by the FP64 pipe's 0.5 warp instructions a
// cycle rather than by issue; the same split serves them (fewer steps,
// fewer instructions a cell). 32-lane groups in this code measured 0.3494
// (float32) and 0.5013 ms (float64) on the same sample. No tensor cores:
// nothing here is a product.

#include <cfloat>
#include <type_traits>

#include "warp_pair.cuh"

namespace {

using namespace warp_pair;

struct F32 {
  using T = float;
  static constexpr int kMinBlocks = 5;  // <= 102 registers: 20 warps an SM
  static __device__ __forceinline__ T mul(T a, T b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ T add(T a, T b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ T sub(T a, T b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ T div(T a, T b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ T log10(T x) { return log10f(x); }
  static __device__ __forceinline__ T tiny() { return FLT_MIN; }
  static __device__ __forceinline__ T neg_inf() {
    return __int_as_float(static_cast<int>(0xff800000u));
  }
};

struct F64 {
  using T = double;
  static constexpr int kMinBlocks = 1;  // a cap spills: the registers decide
  static __device__ __forceinline__ T mul(T a, T b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ T add(T a, T b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ T sub(T a, T b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ T div(T a, T b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ T log10(T x) { return ::log10(x); }
  static __device__ __forceinline__ T tiny() { return DBL_MIN; }
  static __device__ __forceinline__ T neg_inf() {
    return __longlong_as_double(static_cast<long long>(0xfff0000000000000ULL));
  }
};

template <typename T>
struct Params {
  T mm, mi, ii, im;  // transitions (tMD = mi, tDD = ii, tDM = im)
  T third;           // 1/3 rounded to T
  T scale;           // the boundary row's numerator
  T offset;          // log10 of the scale, taken off the result
};

constexpr int kGroup = 16;                   // lanes that sweep one lane
constexpr int kGroupsPerWarp = 32 / kGroup;  // (read, hap) lanes a warp
constexpr int kMaxRows = 10;                 // rows a thread owns at most

inline int group_rows(int M) {
  const int r = (M + kGroup - 1) / kGroup;
  return r < kMaxRows ? r : kMaxRows;
}

// Whether M spans more than one stripe of 16 R rows.
inline bool group_striped(int M) { return M > kGroup * group_rows(M); }

template <typename P, int R>
__global__ void __launch_bounds__(32 * kWarpsPerBlock, P::kMinBlocks)
pairhmm_kernel(const uint8_t* __restrict__ a,
               const typename P::T* __restrict__ err,
               const uint8_t* __restrict__ b,
               const int32_t* __restrict__ la_all,
               const int32_t* __restrict__ lb_all,
               typename P::T* __restrict__ out, typename P::T* bound,
               long long B, int M, int N, Params<typename P::T> p) {
  using T = typename P::T;
  const int lane = threadIdx.x & 31;
  const int g = lane & (kGroup - 1);  // this thread's place in its group
  const long long first =
      ((long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) *
      kGroupsPerWarp;
  if (first >= B) return;  // the same for every lane of the warp
  // a warp's second group past the batch sweeps the last lane's operands
  // and reports nothing
  const bool mine = first + lane / kGroup < B;
  const long long pair = mine ? first + lane / kGroup : B - 1;
  const int la = mine ? la_all[pair] : 0;
  const int lb = mine ? lb_all[pair] : 0;
  const bool empty = la <= 0 || lb <= 0;
  if (empty && mine && g == 0) out[pair] = P::neg_inf();
  const int stripe_rows = kGroup * R;
  const int last = la - 1;  // the final read row
  const int last_stripe = empty ? -1 : last / stripe_rows;
  const int owner = empty ? -1 : (last % stripe_rows) / R;
  const int owner_r = empty ? 0 : last % R;
  // the warp runs as long as the longer of its two lanes
  const int my_steps = empty ? 0 : lb + kGroup - 1;
  const int steps =
      max(my_steps, __shfl_xor_sync(kFullMask, my_steps, kGroup));
  const int stripes =
      max(last_stripe, __shfl_xor_sync(kFullMask, last_stripe, kGroup)) + 1;
  const uint8_t* a_row = a + pair * M;
  const T* e_row = err + pair * M;
  const uint8_t* b_row = b + pair * N;
  T* bound_row = bound ? bound + pair * 3LL * N : nullptr;
  const T zero = T(0);
  const T drow = P::div(p.scale, (T)(lb > 0 ? lb : 1));
  T acc = zero;

  for (int stripe = 0; stripe < stripes; ++stripe) {
    int ai[R];
    T match[R], mis[R];
    T m[R], ins[R], del[R];  // this thread's rows at its previous column
    const int row0 = stripe * stripe_rows + g * R;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool in_a = row0 + r < M;
      const T e = in_a ? e_row[row0 + r] : zero;
      ai[r] = in_a ? (int)a_row[row0 + r] : kNoA;
      match[r] = P::sub(T(1), e);
      mis[r] = P::mul(e, p.third);
      m[r] = ins[r] = del[r] = zero;
    }
    const bool top = stripe == 0;
    const bool write_bound = stripe < last_stripe;
    const bool sums = stripe == last_stripe && g == owner;
    int bj = kNoB;       // b at this thread's current column
    int b_chunk = kNoB;  // b[t0 + g] for the current 16-step chunk
    // the row above the band at this thread's previous column (the diagonal)
    T pm = zero, pi = zero, pd = (top && g == 0) ? drow : zero;
    T bm = zero, bi = zero, bd = zero;  // the band's bottom row, previous column

    for (int t = 0; t < steps; ++t) {
      if ((t & (kGroup - 1)) == 0) {
        const int j = t + g;
        b_chunk = j < N ? (int)b_row[j] : kNoB;
      }
      const int b_new = __shfl_sync(kFullMask, b_chunk, t, kGroup);
      const int b_up = __shfl_up_sync(kFullMask, bj, 1, kGroup);
      T um = __shfl_up_sync(kFullMask, bm, 1, kGroup);
      T ui = __shfl_up_sync(kFullMask, bi, 1, kGroup);
      T ud = __shfl_up_sync(kFullMask, bd, 1, kGroup);
      if (g == 0) {
        bj = b_new;
        if (top) {  // the boundary row: M = I = 0, D = scale / lb
          um = zero;
          ui = zero;
          ud = drow;
        } else if (t < lb) {
          um = bound_row[t];
          ui = bound_row[N + t];
          ud = bound_row[2 * N + t];
        } else {
          um = ui = ud = zero;
        }
      } else {
        bj = b_up;
      }
      T dm = pm, di = pi, dd = pd;
      pm = um;
      pi = ui;
      pd = ud;
      T cell = zero;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T prior = ai[r] == bj ? match[r] : mis[r];
        const T mn = P::mul(
            prior, P::add(P::add(P::mul(p.mm, dm), P::mul(p.im, di)),
                          P::mul(p.im, dd)));
        const T in = P::add(P::mul(p.mi, um), P::mul(p.ii, ui));
        const T dn = P::add(P::mul(p.mi, m[r]), P::mul(p.ii, del[r]));
        dm = m[r];
        di = ins[r];
        dd = del[r];
        m[r] = mn;
        ins[r] = in;
        del[r] = dn;
        um = mn;
        ui = in;
        if (r == owner_r) cell = P::add(mn, in);
      }
      bm = m[R - 1];
      bi = ins[R - 1];
      bd = del[R - 1];
      const int j = t - g;
      if (sums && j >= 0 && j < lb) acc = P::add(acc, cell);
      if (write_bound && g == kGroup - 1 && j >= 0 && j < lb) {
        bound_row[j] = bm;
        bound_row[N + j] = bi;
        bound_row[2 * N + j] = bd;
      }
    }
    __syncwarp();  // the bottom row is visible to thread 0 in the next stripe
  }
  if (g == owner) {
    out[pair] = acc >= P::tiny() ? P::sub(P::log10(acc), p.offset)
                                 : P::neg_inf();
  }
}

// Calls launch(std::integral_constant<int, R>()) with R = group_rows(M).
template <typename Launch>
void dispatch_group_rows(int M, Launch&& launch) {
  switch (group_rows(M)) {
    case 1: launch(std::integral_constant<int, 1>()); break;
    case 2: launch(std::integral_constant<int, 2>()); break;
    case 3: launch(std::integral_constant<int, 3>()); break;
    case 4: launch(std::integral_constant<int, 4>()); break;
    case 5: launch(std::integral_constant<int, 5>()); break;
    case 6: launch(std::integral_constant<int, 6>()); break;
    case 7: launch(std::integral_constant<int, 7>()); break;
    case 8: launch(std::integral_constant<int, 8>()); break;
    case 9: launch(std::integral_constant<int, 9>()); break;
    default: launch(std::integral_constant<int, 10>()); break;
  }
}

template <typename P>
int launch(const void* a, const void* err, const void* b, const void* la,
           const void* lb, void* out, void* scratch, long long B, int M,
           int N, double tMM, double tMI, double tII, double tIM,
           double scale, double offset, cudaStream_t s) {
  using T = typename P::T;
  const Params<T> p{(T)tMM, (T)tMI, (T)tII, (T)tIM, (T)(1.0 / 3.0),
                    (T)scale, (T)offset};
  const uint8_t* pa = static_cast<const uint8_t*>(a);
  const T* pe = static_cast<const T*>(err);
  const uint8_t* pb = static_cast<const uint8_t*>(b);
  const int32_t* pla = static_cast<const int32_t*>(la);
  const int32_t* plb = static_cast<const int32_t*>(lb);
  T* po = static_cast<T*>(out);
  T* ps = static_cast<T*>(scratch);
  const long long warps = (B + kGroupsPerWarp - 1) / kGroupsPerWarp;
  dispatch_group_rows(M, [&](auto rows) {
    pairhmm_kernel<P, decltype(rows)::value>
        <<<blocks_for(warps), 32 * kWarpsPerBlock, 0, s>>>(
            pa, pe, pb, pla, plb, po, ps, B, M, N, p);
  });
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Values of T in the scratch each lane needs: 3 N (the M, I and D of a
// stripe's bottom row) when M spans more than one stripe of 16 R rows, else
// 0 (then `scratch` may be null).
int pairhmm_scratch_per_pair(int M, int N) {
  return group_striped(M) ? 3 * N : 0;
}

// Launches the float32 (f64 == 0) or float64 kernel on `stream` and returns
// cudaGetLastError() (0 on success). err, out and scratch hold that type.
int pairhmm_launch(const void* a, const void* err, const void* b,
                   const void* la, const void* lb, void* out, void* scratch,
                   long long B, int M, int N, int f64, double tMM, double tMI,
                   double tII, double tIM, double scale, double offset,
                   void* stream) {
  if (B <= 0 || M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if (pairhmm_scratch_per_pair(M, N) && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<F64>(a, err, b, la, lb, out, scratch, B, M, N, tMM,
                           tMI, tII, tIM, scale, offset, s)
             : launch<F32>(a, err, b, la, lb, out, scratch, B, M, N, tMM,
                           tMI, tII, tIM, scale, offset, s);
}

}  // extern "C"
