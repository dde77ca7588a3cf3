// The env step's epilogue for one board held by ONE WARP, as device code of
// fused_step_kernel<true> and env_merge_kernel (fused_step.cu).
//
// Replaces the done latch and auto-reset merge that follows `pallas_step` in
// the JAX package's fused env step, and that follows the one-step simple
// `pallas_rollout_chunk` in its mixed-control step (`_merge_done_and_reset` and
// `_detect_terminal`, pomcpp_tpu/env/environment.py:197-222, :115-150,
// `_fresh`); there XLA fuses it around the one Pallas launch.  The semantic
// spec is the plain PyTorch version, pomcpp_tpu_torch/env/environment.py
// `_merge_done_and_reset` (with its `_draw_fresh_game`), and the code below
// must agree with it bit for bit on every EnvState field.  Per board:
//   * done BEFORE the step: the board is replaced by a fresh game drawn from
//     its key row (seed, board id, resets drawn) -- Philox4x32-10 keyed by
//     the seed's two 32-bit halves at the counter (board id mod 2^32, resets
//     mod 2^32, stream, cell / 4), streams 3 (cell classes) and 4 (powerup
//     flags), and stream 5, word group 0, for the seat ranking of
//     randomize_positions -- or taken from the `fresh` arrays of the test
//     hook; done, winner and is_draw clear and the reset count advances.  The
//     stepped result is discarded (fused_step_kernel<true> does not step it);
//   * otherwise the stepped game is kept and the result latches: FFA, the
//     first alive agent wins when one is left; team mode, the surviving team;
//     nobody left is a draw, and so is `max_steps` reached without a winner.
// The branch between the two is warp-uniform (one __any_sync on the board's
// done byte), so a CTA of CHUNK_WARPS boards never waits on itself.
//
// Every EnvState field is read and written in its own dtype -- torch.bool as
// one byte, the key as int64, the counts as int32 -- so the wrapper converts
// nothing and reads nothing back to the host.
//
// What bounds it on the card: bytes.  In fused_step_kernel<true> a board's
// EnvState is 3,514 bytes in and as many out (3,484 of game, 30 of done,
// winner, is_draw and key); the reset draw is 2 Philox calls a lane (3 with
// randomize_positions) on the few boards that reset.  There the game goes
// through the lane layout (load_game / store_game) because the step needs
// it: lane l moves cells 4l..4l+3 with 4-byte accesses, so one warp
// instruction spans 512 bytes at a 16-byte stride, 16 sectors for 128 useful
// bytes.  env_merge_kernel does not step and writes the stepped batch in
// place, so a board that was not done moves no game at all: the latch reads
// its four dead bytes and two counts, and 72 bytes a board are all it
// needs.  Only the rare reset writes a game, in the lane layout, as the
// Philox draw gives lane l the words of cells 4l..4l+3.
#pragma once

#include <cstdint>

#include "step_warp.cuh"

namespace pomcpp {

constexpr uint32_t STREAM_ENV_CELLS = 3, STREAM_ENV_FLAGS = 4, STREAM_ENV_SEATS = 5;

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint32_t k0, uint32_t k1) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) { k0 += W0; k1 += W1; }
    const uint32_t hi0 = __umulhi(M0, ctr.x), lo0 = M0 * ctr.x;
    const uint32_t hi1 = __umulhi(M1, ctr.z), lo1 = M1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ k0, lo1, hi0 ^ ctr.w ^ k1, lo0);
  }
  return ctr;
}

// Non-negative 30-bit draw from a 32-bit word, as the TPU kernel takes it.
__device__ __forceinline__ int draw30(uint32_t w) { return (int)((w >> 1) & 0x3FFFFFFFu); }

__device__ __forceinline__ uint32_t word_of(uint4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// A CellState batch in its own dtypes, in CellState's field order: seven
// int32 planes [B, 121]; agent x, y, bomb count, max bombs, strength int32
// [B, 4]; can_kick, dead bool [B, 4]; alive_count, timestep int32 [B].
struct GameView {
  int32_t* plane[7];
  int32_t* agent[5];
  uint8_t* flag[2];
  int32_t* alive_count;
  int32_t* timestep;
};

// The rest of an EnvState: done, is_draw bool [B]; winner int32 [B]; key
// int64 [B, 3].
struct EnvView {
  uint8_t* done;
  int32_t* winner;
  uint8_t* is_draw;
  int64_t* key;
};

struct EnvConfig {
  int team_mode, max_steps, randomize_positions;
};

namespace wl {

// Lane l loads cells 4l..4l+3 of board b; every lane loads the agents.
__device__ __forceinline__ void load_game(const GameView& in, int b, const Geo& g, Cells& s,
                                          Agents& A) {
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = g.c0 + j, o = b * NC + c;
    const bool v = c < NC;
    s.board[j] = v ? in.plane[0][o] : 0;
    s.hidden[j] = v ? in.plane[1][o] : 0;
    s.ftimer[j] = v ? in.plane[2][o] : 0;
    s.btimer[j] = v ? in.plane[3][o] : 0;
    s.bstr[j] = v ? in.plane[4][o] : 0;
    s.bdir[j] = v ? in.plane[5][o] : 0;
    s.bown[j] = v ? in.plane[6][o] : 0;
  }
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int o = b * NA + i;
    A.x[i] = in.agent[0][o];
    A.y[i] = in.agent[1][o];
    A.bc[i] = in.agent[2][o];
    A.mb[i] = in.agent[3][o];
    A.st[i] = in.agent[4][o];
    A.kick[i] = in.flag[0][o] != 0;
    A.dead[i] = in.flag[1][o] != 0;
  }
}

// Lane l stores its cells, lanes 0-3 one agent each, lane 0 the counts.
__device__ __forceinline__ void store_game(const GameView& out, int b, const Geo& g,
                                           const Cells& s, const Agents& A, int alive,
                                           int timestep) {
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = g.c0 + j, o = b * NC + c;
    if (c < NC) {
      out.plane[0][o] = s.board[j];
      out.plane[1][o] = s.hidden[j];
      out.plane[2][o] = s.ftimer[j];
      out.plane[3][o] = s.btimer[j];
      out.plane[4][o] = s.bstr[j];
      out.plane[5][o] = s.bdir[j];
      out.plane[6][o] = s.bown[j];
    }
  }
  if (g.lane < NA) {
    const int i = g.lane, o = b * NA + i;
    out.agent[0][o] = pick4(A.x, i);
    out.agent[1][o] = pick4(A.y, i);
    out.agent[2][o] = pick4(A.bc, i);
    out.agent[3][o] = pick4(A.mb, i);
    out.agent[4][o] = pick4(A.st, i);
    out.flag[0][o] = pick4(A.kick, i) != 0;
    out.flag[1][o] = pick4(A.dead, i) != 0;
  }
  if (g.lane == 0) {
    out.alive_count[b] = alive;
    out.timestep[b] = timestep;
  }
}

__device__ __forceinline__ int alive_of(const Agents& A) {
  return NA - (A.dead[0] + A.dead[1] + A.dead[2] + A.dead[3]);
}

// _draw_fresh_game for one key row: terrain from streams 3 and 4 (lane l
// takes the four words of group l), agents in the corners -- in seat order,
// or ranked by the stream-5 words ((w & ~3) | seat, ascending) -- with the
// empty state's stats.
__device__ __forceinline__ void draw_game(const int64_t* key, bool randomize, const Geo& g,
                                          Cells& s, Agents& A) {
  const uint64_t seed = (uint64_t)key[0];
  const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  const uint32_t id = (uint32_t)key[1], count = (uint32_t)key[2];
  const uint4 cw = philox4x32_10(make_uint4(id, count, STREAM_ENV_CELLS, (uint32_t)g.lane), k0, k1);
  const uint4 fw = philox4x32_10(make_uint4(id, count, STREAM_ENV_FLAGS, (uint32_t)g.lane), k0, k1);
  int rank[NA] = {0, 1, 2, 3};  // agent i stands in corner rank[i]
  if (randomize) {
    const uint4 sw = philox4x32_10(make_uint4(id, count, STREAM_ENV_SEATS, 0u), k0, k1);
    uint32_t v[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) v[i] = (word_of(sw, i) & ~3u) | (uint32_t)i;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      rank[i] = 0;
#pragma unroll
      for (int j = 0; j < NA; ++j) rank[i] += v[j] < v[i];
    }
  }
  // Corners in put_agents_in_corners' order: (0,0), (10,0), (10,10), (0,10).
  constexpr int corner_cell[NA] = {0, BS - 1, NC - 1, NC - BS};
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = g.c0 + j;
    int board = 0, hidden = 0;
    if (c < NC) {
      const int tmp = draw30(word_of(cw, j)) % 7;
      const int flags = draw30(word_of(fw, j));
      board = tmp == 1 ? C_RIGID : tmp == 2 ? C_WOOD : C_PASSAGE;
      hidden = (board == C_WOOD && (flags & 1) == 0) ? ((flags >> 1) % 4) + 1 : 0;
#pragma unroll
      for (int i = 0; i < NA; ++i)
        if (c == pick4(corner_cell, rank[i])) board = C_AGENT0 + i;
    }
    s.board[j] = board;
    s.hidden[j] = hidden;
    s.ftimer[j] = s.btimer[j] = s.bstr[j] = s.bdir[j] = s.bown[j] = 0;
  }
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    A.x[i] = (rank[i] == 1 || rank[i] == 2) ? BS - 1 : 0;
    A.y[i] = (rank[i] == 2 || rank[i] == 3) ? BS - 1 : 0;
    A.bc[i] = 0;
    A.mb[i] = 1;
    A.st[i] = 1;
    A.kick[i] = 0;
    A.dead[i] = 0;
  }
}

// A board that was done before the step: its fresh game (the hook's arrays
// when `fresh` has them) and a cleared result, the key's reset count
// advanced.  Writes board b of `out` and `eout`.
__device__ __forceinline__ void env_reset_board(int b, const Geo& g, const GameView& fresh,
                                                const EnvView& ein, const GameView& out,
                                                const EnvView& eout, bool randomize, Cells& s,
                                                Agents& A) {
  const int64_t* key = ein.key + 3 * b;
  int alive = NA, timestep = 0;
  if (fresh.plane[0] != nullptr) {
    load_game(fresh, b, g, s, A);
    alive = fresh.alive_count[b];
    timestep = fresh.timestep[b];
  } else {
    draw_game(key, randomize, g, s, A);
  }
  store_game(out, b, g, s, A, alive, timestep);
  if (g.lane < 3) eout.key[3 * b + g.lane] = key[g.lane] + (g.lane == 2 ? 1 : 0);
  if (g.lane == 0) {
    eout.done[b] = 0;
    eout.winner[b] = -1;
    eout.is_draw[b] = 0;
  }
}

// _detect_terminal for a board that was not done before the step; `dead`,
// `alive` and `timestep` are the stepped game's.  Writes board b of `eout`.
__device__ __forceinline__ void env_latch(int b, int lane, const int dead[NA], int alive,
                                          int timestep, const EnvView& ein, const EnvView& eout,
                                          const EnvConfig& cfg) {
  if (lane < 3) eout.key[3 * b + lane] = ein.key[3 * b + lane];
  if (lane != 0) return;
  bool won, draw;
  int survivor;
  if (cfg.team_mode) {
    // Classic 2v2 teams: agents {0, 2} against {1, 3}.
    const bool t0 = !dead[0] || !dead[2], t1 = !dead[1] || !dead[3];
    won = t0 != t1;
    survivor = t0 ? 0 : 1;
    draw = !t0 && !t1;
  } else {
    won = alive == 1;
    // argmax(~dead): the lowest alive id, 0 when nobody is alive.
    survivor = !dead[0] ? 0 : !dead[1] ? 1 : !dead[2] ? 2 : !dead[3] ? 3 : 0;
    draw = alive == 0;
  }
  if (cfg.max_steps != 0) draw = draw || (!won && timestep >= cfg.max_steps);
  const bool was_done = ein.done[b] != 0;
  eout.done[b] = was_done || won || draw;
  eout.winner[b] = (won && !was_done) ? survivor : ein.winner[b];
  eout.is_draw[b] = ein.is_draw[b] != 0 || (draw && !was_done);
}

}  // namespace wl
}  // namespace pomcpp
