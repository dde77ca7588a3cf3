// The constants, the agents' state and the scalar cell helpers that every
// kernel body of fused_step.cu shares (step_warp.cuh, fsm_warp.cuh,
// env_warp.cuh; all of them one board per warp).
//
// The values are the JAX package's (pomcpp_tpu/core/constants.py) and the
// plain PyTorch version's (pomcpp_tpu_torch/core/constants.py).  Cell
// indices are x + 11 * y; a board's plane is padded to NT = 128 cells, four
// to a lane of its warp, and cells 121..127 hold zeros and are never read as
// a neighbour.  Cell-index arithmetic only ever divides non-negative
// on-board indices.
#pragma once

#include <cstdint>

namespace pomcpp {

constexpr int BS = 11;             // BOARD_SIZE
constexpr int NC = BS * BS;        // NUM_CELLS
constexpr int NT = 128;            // cells of a padded plane (32 lanes x 4)
constexpr int NA = 4;              // AGENT_COUNT

constexpr int C_PASSAGE = 0, C_RIGID = 1, C_WOOD = 2, C_BOMB = 3, C_FLAME = 4;
constexpr int C_EXTRABOMB = 6, C_INCRRANGE = 7, C_KICK = 8, C_AGENT0 = 10;
constexpr int BOMB_LIFETIME = 10, FLAME_LIFETIME = 4, M_BOMB = 5;
constexpr int MAX_CHAIN_ROUNDS = 4;

// The four agents, replicated in every lane of a board's warp.
struct Agents {
  int x[NA], y[NA], bc[NA], mb[NA], st[NA], kick[NA], dead[NA];
};

__device__ __forceinline__ bool is_powerup(int v) { return v >= C_EXTRABOMB && v <= C_KICK; }
__device__ __forceinline__ bool is_agent(int v) { return v >= C_AGENT0; }
__device__ __forceinline__ bool static_block(int v) {
  return v == C_RIGID || v == C_WOOD || is_powerup(v);
}
__device__ __forceinline__ int flag_item(int p) {
  return p == 1 ? C_EXTRABOMB : p == 2 ? C_INCRRANGE : p == 3 ? C_KICK : C_PASSAGE;
}
__device__ __forceinline__ int move_dx(int m) { return m == 3 ? -1 : m == 4 ? 1 : 0; }
__device__ __forceinline__ int move_dy(int m) { return m == 1 ? -1 : m == 2 ? 1 : 0; }
__device__ __forceinline__ int clamp_move(int m) { return m < 0 ? 0 : m > 5 ? 5 : m; }

// Cell one step from on-board cell c in direction d (1 UP, 2 DOWN, 3 LEFT,
// 4 RIGHT); d == 0 is c itself; -1 when the step leaves the board.
__device__ __forceinline__ int neighbor(int c, int d) {
  const int x = c % BS, y = c / BS;
  switch (d) {
    case 0: return c;
    case 1: return y > 0 ? c - BS : -1;
    case 2: return y < BS - 1 ? c + BS : -1;
    case 3: return x > 0 ? c - 1 : -1;
    case 4: return x < BS - 1 ? c + 1 : -1;
    default: return -1;
  }
}

// Select a[k] for k in [0, 4) without dynamic register indexing.
__device__ __forceinline__ int pick4(const int a[NA], int k) {
  return k == 0 ? a[0] : k == 1 ? a[1] : k == 2 ? a[2] : a[3];
}

}  // namespace pomcpp
