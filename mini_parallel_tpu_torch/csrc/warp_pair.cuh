// Geometry shared by the warp-per-pair kernels (sw_score.cu,
// sw_affine_score.cu, sw_vs_ref.cu, sw_moves.cu): one warp sweeps one
// pair (or one read against the reference); lane l owns a band of
// R = rows_per_lane(M) consecutive rows; rows beyond 32 * R run in stripes
// whose bottom row goes through a scratch row in device memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace warp_pair {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxRowsPerLane = 8;
constexpr int kNoA = -1;  // row past M: equals no byte
constexpr int kNoB = -2;  // column outside [0, N): equals no byte

inline int rows_per_lane(int M) {
  const int r = (M + 31) / 32;
  return r < kMaxRowsPerLane ? r : kMaxRowsPerLane;
}

// Whether M spans more than one stripe, so that each pair needs a scratch
// row for the stripes' bottom rows.
inline bool striped(int M) { return M > 32 * rows_per_lane(M); }

inline unsigned blocks_for(long long B) {
  return (unsigned)((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// Calls launch(std::integral_constant<int, R>()) with R = rows_per_lane(M),
// so that each kernel is instantiated once per band height.
template <typename Launch>
void dispatch_rows(int M, Launch&& launch) {
  switch (rows_per_lane(M)) {
    case 1: launch(std::integral_constant<int, 1>()); break;
    case 2: launch(std::integral_constant<int, 2>()); break;
    case 3: launch(std::integral_constant<int, 3>()); break;
    case 4: launch(std::integral_constant<int, 4>()); break;
    case 5: launch(std::integral_constant<int, 5>()); break;
    case 6: launch(std::integral_constant<int, 6>()); break;
    case 7: launch(std::integral_constant<int, 7>()); break;
    default: launch(std::integral_constant<int, 8>()); break;
  }
}

}  // namespace warp_pair
