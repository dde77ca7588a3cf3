// One full Pommerman step for one board held by ONE WARP, as device code of
// rollout_chunk_kernel and fused_step_kernel (fused_step.cu).
//
// Replaces `_step_block` (pomcpp_tpu/engine/pallas_step.py:247) and the
// helpers it inlines (`_push`/`_pull`/`_dest_val`/`_dest_oob` :82-166,
// `_ray_reach` :189).  The semantic spec is the plain PyTorch version,
// pomcpp_tpu_torch/engine/cellular.py `cellular_step(..., max_chain_rounds=4)`;
// the code below follows it phase for phase and must agree with it bit for
// bit.  common.cuh supplies the constants, `Agents` and the scalar helpers.
//
// What bounded the CTA layout this replaced on this card (one board per
// 128-thread CTA, one cell per thread): latency, not bytes and not arithmetic -- 60-100
// CTA-wide barriers per step, and the per-agent scalar code executed by all
// four warps.  What this layout does about it:
//   * Lane l of the warp holds cells 4l..4l+3 of a 128-padded plane (cells
//     121..127, in lanes 30 and 31, are pads: every plane is zero there and
//     no on-board cell has them as a neighbour).  A CTA carries
//     CHUNK_WARPS independent boards and never synchronises them, so
//     the body contains no CTA-wide barrier and a warp without a board
//     returns at once.
//   * Static neighbour reads (offsets +-1 and +-11) are shuffles: `Nbr`
//     fetches the four neighbours of a lane's four cells with 10 shuffles
//     (the +-1 rolls stay inside the lane for three cells of four): the
//     moving bombs' directions for the arrival counts, and the hand-over of
//     a moving bomb, which travels as ONE packed word (pack_bomb).
//   * Boolean planes travel as ballots: four __ballot_sync give every lane
//     the whole 128-cell plane in four registers (`Plane`), after which a
//     read at ANY cell -- a static neighbour, an agent's cell, a ray's cell --
//     is two ALU operations and no exchange.  Sites: "blocks a bomb",
//     "static block", "two or more arrivals", "stopped bomb", "kick
//     stopped", "stops a ray", "explodes".
//   * Dynamic-index reads of integer planes: the eight agent-cell lookups of
//     phase 1 (board code and bomb bit of each agent's origin and
//     destination, warp-uniform indices) go through a 128-int slice of
//     shared memory owned by the warp, between two __syncwarp(); the
//     strength of an exploding cell (warp-uniform index) is one shuffle of a
//     pick4.  The explosion rays are not walked backwards from every cell
//     (<= 40 indexed reads a cell) but forwards from each exploding cell, as
//     warp-uniform ALU work on two `Plane`s.
//   * Reductions are __reduce_or_sync / __reduce_add_sync over the lane's
//     partial of its four cells; block-wide "any" is __any_sync.  Every
//     per-board early exit (no bomb on the board, no moving bomb, a block
//     round that changed nothing, no revert trigger, chain rounds) is a
//     warp-uniform branch that costs the other boards of the CTA nothing.
//   * The agents' state stays replicated in every lane, so agent-level
//     branches are warp-uniform and the per-agent code runs once per board
//     (it ran four times, once per warp of the CTA).  Even so, the same
//     integer instruction in 32 lanes is 32 times the work: the movement
//     logic of phase 1 is therefore spread over the lanes (one agent, or
//     one pair of agents, a lane) and gathered with ballots; positions
//     compare as one packed word and the movement chain's fixed point runs
//     on one bit per agent, one ballot a sweep.
// Every *_sync intrinsic is reached by all 32 lanes: they sit in
// warp-uniform control flow only, never under a per-cell or per-lane
// condition.
//
// What bounds it now: the integer pipe.  With the agent logic
// still repeated in every lane the time did not move between 12 and 16
// resident boards per SM nor when a tenth of the instructions went, and
// fell by a third when that logic was spread over the lanes.  The registers
// of four cells a thread (128 with __launch_bounds__(128, 4)) set the
// residency.  PERF.md holds the counts and times of the build that was
// kept.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace pomcpp {
namespace wl {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CPL = 4;  // cells per lane

// Where a chunk's time goes (pomcpp_tpu_torch/trace.py samples it): the
// bodies take the clock as a template parameter.  In the clocked chunk
// kernel (PhaseClock) every warp sums the cycles (clock64) it spends
// between marks, per phase, and a few event counts; with NoClock, which
// every other kernel takes, the marks compile to nothing.  The cycles of a
// phase include the time the warp waited for its turn on the SM.
enum Phase {
  PH_DRAW = 0,   // moves drawn, pipelined reset merged
  PH_DANGER,     // FSM: danger map
  PH_BFS,        // FSM: maps to shared memory, the agents' needs, four-agent BFS
  PH_FLEE,       // FSM: BFS fields to shared memory, flee targets
  PH_DECIDE,     // FSM: decision cascade on lanes 0-3
  PH_MOVE,       // step phases 0-1: flames, agent movement
  PH_BOMBS,      // step phase 2: bomb kinematics
  PH_BLAST,      // step phase 3: explosions
  PH_REST,       // record, loop tail
  N_BFS_ROUNDS,  // count: BFS rounds after an act's first
  N_BOMB_STEPS,  // count: steps that got past the "no bomb" gate
  N_MOVE_PASSES, // count: steps whose move pass ran
  N_BLASTS,      // count: explosion rounds
  N_STEPS,       // count: steps
  N_BFS_ACTS,    // count: acts that ran a BFS round
  PHASE_SLOTS
};

struct PhaseClock {
  unsigned last;
  unsigned acc[PHASE_SLOTS];  // a chunk's cycles per phase stay below 2^32
  __device__ __forceinline__ void start() {
    last = (unsigned)clock64();
#pragma unroll
    for (int k = 0; k < PHASE_SLOTS; ++k) acc[k] = 0;
  }
  __device__ __forceinline__ void mark(int phase) {
    const unsigned now = (unsigned)clock64();
    acc[phase] += now - last;
    last = now;
  }
  __device__ __forceinline__ void count(int slot, int n = 1) { acc[slot] += n; }
  // Lane 0 adds the warp's sums into the call's row (PHASE_SLOTS values).
  __device__ __forceinline__ void flush(unsigned long long* totals, int lane) const {
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < PHASE_SLOTS; ++k) atomicAdd(&totals[k], (unsigned long long)acc[k]);
    }
  }
};

struct NoClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void count(int, int = 1) {}
  __device__ __forceinline__ void flush(unsigned long long*, int) const {}
};

// A lane's four cells: the seven planes of CellState.
struct Cells {
  int board[CPL], hidden[CPL], ftimer[CPL], btimer[CPL], bstr[CPL], bdir[CPL], bown[CPL];
};

// The warp's slice of shared memory for dynamic-index reads.
struct WarpShared {
  alignas(16) int a[NT];
};

// A lane's place on the board.  `edge` bit 4j + d - 1 says that cell c0 + j
// has an on-board neighbour in direction d (1 UP, 2 DOWN, 3 LEFT, 4 RIGHT);
// pads have none.
struct Geo {
  int lane, c0;
  unsigned edge;
};

__device__ __forceinline__ Geo make_geo() {
  Geo g;
  g.lane = threadIdx.x & 31;
  g.c0 = CPL * g.lane;
  g.edge = 0;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = g.c0 + j;
    if (c < NC) {
#pragma unroll
      for (int d = 1; d <= 4; ++d)
        if (neighbor(c, d) >= 0) g.edge |= 1u << (4 * j + d - 1);
    }
  }
  return g;
}

// Cell j of this lane has an on-board neighbour in direction d (d in 1..4).
__device__ __forceinline__ bool on_board(const Geo& g, int j, int d) {
  return (g.edge >> (4 * j + d - 1)) & 1u;
}

// Index offset of one step in direction d.
__device__ __forceinline__ int dir_delta(int d) {
  return d == 1 ? -BS : d == 2 ? BS : d == 3 ? -1 : d == 4 ? 1 : 0;
}

// The four neighbours' values of a lane's four cells.  Off-board positions
// hold whatever the roll brought and must be masked with on_board().
struct Nbr {
  int up[CPL], down[CPL], left[CPL], right[CPL];
};

__device__ __forceinline__ Nbr neighbors(const int (&v)[CPL]) {
  Nbr n;
  // c - 11 = 4 (l - 3) + (j + 1) for j < 3, 4 (l - 2) for j == 3.
  n.up[0] = __shfl_up_sync(FULL, v[1], 3);
  n.up[1] = __shfl_up_sync(FULL, v[2], 3);
  n.up[2] = __shfl_up_sync(FULL, v[3], 3);
  n.up[3] = __shfl_up_sync(FULL, v[0], 2);
  // c + 11 = 4 (l + 2) + 3 for j == 0, 4 (l + 3) + (j - 1) otherwise.
  n.down[0] = __shfl_down_sync(FULL, v[3], 2);
  n.down[1] = __shfl_down_sync(FULL, v[0], 3);
  n.down[2] = __shfl_down_sync(FULL, v[1], 3);
  n.down[3] = __shfl_down_sync(FULL, v[2], 3);
  n.left[0] = __shfl_up_sync(FULL, v[3], 1);
  n.left[1] = v[0];
  n.left[2] = v[1];
  n.left[3] = v[2];
  n.right[0] = v[1];
  n.right[1] = v[2];
  n.right[2] = v[3];
  n.right[3] = __shfl_down_sync(FULL, v[0], 1);
  return n;
}

// A boolean plane of the whole board in every lane: bit l of w[j] is cell
// 4l + j.
struct Plane {
  unsigned w[CPL];
};

__device__ __forceinline__ Plane ballot_plane(const bool (&p)[CPL]) {
  Plane m;
#pragma unroll
  for (int j = 0; j < CPL; ++j) m.w[j] = __ballot_sync(FULL, p[j]);
  return m;
}

// The plane's bit at any on-board cell.
__device__ __forceinline__ bool plane_at(const Plane& m, int cell) {
  const int j = cell & 3;
  const unsigned w = j == 0 ? m.w[0] : j == 1 ? m.w[1] : j == 2 ? m.w[2] : m.w[3];
  return (w >> (cell >> 2)) & 1u;
}

// The plane's bit at cell j's neighbour in direction d; `self` for d == 0,
// `off` where the step leaves the board.
__device__ __forceinline__ bool plane_nbr(const Geo& g, const Plane& m, int j, int d, bool self,
                                          bool off) {
  if (d == 0) return self;
  if (!on_board(g, j, d)) return off;
  return plane_at(m, g.c0 + j + dir_delta(d));
}

// A bomb as one word for the hand-over of a moving bomb: direction 3 bits
// (0..4), timer 4 bits (at most BOMB_LIFETIME + 1 = 11), owner 2 bits,
// strength the remaining 23 bits.  A bomb's strength is its owner's at the
// plant, 1 plus the C_INCRRANGE items picked up, so it stays below 2^22 for
// every state the engine produces from a state whose strengths are below
// 2^22 - 121.
__device__ __forceinline__ int pack_bomb(int dir, int timer, int own, int str) {
  return dir | (timer << 3) | (own << 7) | (str << 9);
}

// _revert_chain (cellular.py): bounce triggered agents back to their
// origins, cascading into displaced occupants and into agents standing on a
// moving bomb stopped by the bounce.  `dir0` holds the cells' phase-start
// bomb directions, `mdx/mdy` the agents' move displacements.  The "stopped
// bomb" plane is read at the agents' UPDATED cells, as the spec does.
__device__ void revert_chain(Cells& s, Agents& A, const int trigger[NA], const int mdx[NA],
                             const int mdy[NA], const int (&dir0)[CPL], const Geo& g) {
  int cur[NA], done[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) { cur[i] = trigger[i]; done[i] = 0; }
  for (int link = 0; link < NA + 2; ++link) {
    if (!(cur[0] | cur[1] | cur[2] | cur[3])) break;  // warp-uniform
    int ox[NA], oy[NA], act[NA], occ[NA], oc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      ox[i] = A.x[i] - mdx[i];
      oy[i] = A.y[i] - mdy[i];
      const bool oinb = ox[i] >= 0 && oy[i] >= 0 && ox[i] < BS && oy[i] < BS;
      act[i] = cur[i] && oinb;
      done[i] |= act[i];
      oc[i] = act[i] ? ox[i] + BS * oy[i] : -1;
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      occ[i] = -1;
#pragma unroll
      for (int j = NA - 1; j >= 0; --j) {
        if (j != i && !A.dead[j] && A.x[j] == ox[i] && A.y[j] == oy[i]) occ[i] = j;
      }
    }
    // A moving bomb whose STALE destination is a wanted (vacated, no
    // occupant) origin cell is stopped in place.
    bool stopped[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = g.c0 + j, d = dir0[j];
      const int dcell = d == 0 ? c : on_board(g, j, d) ? c + dir_delta(d) : -1;
      bool dest_wanted = false;
#pragma unroll
      for (int i = 0; i < NA; ++i) dest_wanted |= (act[i] && occ[i] < 0 && dcell == oc[i]);
      stopped[j] = s.btimer[j] > 0 && dest_wanted && s.bdir[j] != 0;
      if (stopped[j]) {
        s.bdir[j] = 0;
        if (!is_agent(s.board[j])) s.board[j] = C_BOMB;
      }
#pragma unroll
      for (int i = 0; i < NA; ++i)
        if (act[i] && c == oc[i]) s.board[j] = C_AGENT0 + i;
    }
    const Plane stop = ballot_plane(stopped);
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if (act[i]) { A.x[i] = ox[i]; A.y[i] = oy[i]; }
    int nxt[NA];
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      nxt[j] = 0;
#pragma unroll
      for (int i = 0; i < NA; ++i) nxt[j] |= (act[i] && occ[i] == j);
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int on_stopped = plane_at(stop, A.x[i] + BS * A.y[i]) && !A.dead[i];
      cur[i] = (nxt[i] || on_stopped) && !done[i];
    }
  }
}

// _restore_bomb_items: show C_BOMB on bomb cells no live agent stands on.
__device__ __forceinline__ void restore_bomb_items(Cells& s, const Agents& A, const Geo& g) {
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    bool occupied = false;
#pragma unroll
    for (int i = 0; i < NA; ++i)
      occupied |= (!A.dead[i] && A.x[i] + BS * A.y[i] == g.c0 + j);
    if (s.btimer[j] > 0 && !occupied && is_agent(s.board[j])) s.board[j] = C_BOMB;
  }
}

// Every lane of the warp calls this with the same `moves` and `A`.
template <class Clock>
__device__ void step_board(Cells& s, Agents& A, const int moves[NA], WarpShared& ws,
                           const Geo& g, Clock& pc) {
  // ---- Phase 0: flames ----------------------------------------------------
  // (Pads hold zeros and every update below maps zeros to zeros.)
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    s.ftimer[j] = s.ftimer[j] > 1 ? s.ftimer[j] - 1 : 0;
    if (s.ftimer[j] == 0 && s.board[j] == C_FLAME) {
      s.board[j] = flag_item(s.hidden[j] & 3);
      s.hidden[j] = 0;
    }
  }

  // ---- Phase 1: agent movement -------------------------------------------
  // Board code and "has a bomb" of every cell, for the agent-cell lookups.
  __syncwarp();
  *reinterpret_cast<int4*>(&ws.a[g.c0]) =
      make_int4(s.board[0] | (s.btimer[0] > 0 ? 256 : 0), s.board[1] | (s.btimer[1] > 0 ? 256 : 0),
                s.board[2] | (s.btimer[2] > 0 ? 256 : 0), s.board[3] | (s.btimer[3] > 0 ? 256 : 0));
  __syncwarp();
  // Positions are compared as one word, (x + 1) | (y + 1) << 4, which also
  // tells apart the destinations one step off the board.
  int m[NA], mdx[NA], mdy[NA], alive[NA], dmove[NA], pp[NA], dp[NA];
  int org[NA], old_cell[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    m[i] = clamp_move(moves[i]);
    mdx[i] = move_dx(m[i]);
    mdy[i] = move_dy(m[i]);
    alive[i] = !A.dead[i];
    dmove[i] = m[i] >= 1 && m[i] <= 4;
    pp[i] = (A.x[i] + 1) | ((A.y[i] + 1) << 4);
    dp[i] = pp[i] + mdx[i] + 16 * mdy[i];
    org[i] = A.x[i] + BS * A.y[i];
    old_cell[i] = org[i];
  }
  // FixSwitchMove (step_utility.cpp:154-170), same pair order (a pair of an
  // agent with itself changes nothing).
#pragma unroll
  for (int i = 0; i < NA; ++i) {
#pragma unroll
    for (int j = i + 1; j < NA; ++j) {
      const bool swap = dp[i] == pp[j] && dp[j] == pp[i];
      dp[i] = swap ? pp[i] : dp[i];
      dp[j] = swap ? pp[j] : dp[j];
    }
  }
  // From here the per-agent logic is spread over the warp instead of being
  // repeated by every lane: lane l works for agent `me` = l & 3 and, where a
  // pair of agents is compared, against agent `ot` = (l >> 2) & 3 (lanes
  // 16-31 repeat lanes 0-15).  What every lane needs of it comes back as a
  // ballot (bit i of the low four: agent i), a packed __reduce_or_sync or a
  // shuffle from lane i.
  const int me = g.lane & 3, ot = (g.lane >> 2) & 3;
  const int my_dp = pick4(dp, me), my_pp = pick4(pp, me);
  const int ot_dp = pick4(dp, ot), ot_pp = pick4(pp, ot);
  const int my_dxs = (my_dp & 15) - 1, my_dys = (my_dp >> 4) - 1;
  const bool my_alive = !pick4(A.dead, me);
  const bool my_directional = pick4(dmove, me) && my_dp != my_pp;
  const bool my_inb = (unsigned)my_dxs < (unsigned)BS && (unsigned)my_dys < (unsigned)BS;
  const int my_dest = my_inb ? my_dxs + BS * my_dys : -1;
  const int my_dw = my_inb ? ws.a[my_dest] : 0;
  const int my_ditem = my_dw & 255;
  const bool my_bomb_dest = my_dw >> 8;
  const bool my_org_bomb = ws.a[pick4(org, me)] >> 8;
  const bool my_victim = my_alive && my_directional && my_inb && my_ditem == C_FLAME;
  const int alive_bits = __ballot_sync(FULL, my_alive) & 15;
  const int victim_bits = __ballot_sync(FULL, my_victim) & 15;
  // Ouroboros: nobody is a movement root (step_utility.cpp:172-205); and
  // the agents that collide at their destination.  One pair a lane: agent
  // i's four terms sit at bits i, i + 4, i + 8, i + 12 of the ballot.
  const bool ot_counts = ot != me && ((alive_bits >> ot) & 1);
  const unsigned targ_pairs = __ballot_sync(FULL, ot_counts && my_dp == ot_pp);
  const unsigned coll_pairs =
      __ballot_sync(FULL, ot_counts && !((victim_bits >> ot) & 1) && my_dp == ot_dp);
  const int targ_bits =
      (int)((targ_pairs | (targ_pairs >> 4) | (targ_pairs >> 8) | (targ_pairs >> 12)) & 15u);
  const int coll_bits =
      (int)((coll_pairs | (coll_pairs >> 4) | (coll_pairs >> 8) | (coll_pairs >> 12)) & 15u);
  const bool ouroboros = (alive_bits & targ_bits) == 15;  // no dead agent, all targeted
  // Chain fixed point (step.cpp:70-82), Jacobi iteration as in the spec, on
  // one bit per agent: agent i moves if its destination is free, or if it
  // holds an agent that moved in the sweep before or dies on the way.
  const bool my_base = my_alive && my_directional && my_inb && !my_victim &&
                       !((coll_bits >> me) & 1);
  const bool my_dagent = is_agent(my_ditem);
  const int my_aid = my_ditem - C_AGENT0;
  const int my_dep = my_base && my_dagent ? 1 << (my_aid > 3 ? 3 : my_aid) : 0;
  const bool my_free =
      my_base && (my_ditem == C_PASSAGE || is_powerup(my_ditem) || my_ditem == C_BOMB ||
                  (ouroboros && my_dagent));
  int mv_bits = 0;
#pragma unroll
  for (int it = 0; it < NA; ++it)
    mv_bits = __ballot_sync(FULL, my_free || ((mv_bits | victim_bits) & my_dep)) & 15;
  const bool my_mv = (mv_bits >> me) & 1;
  // The rest of what the cell and agent updates need, one packed word:
  // bits [4k, 4k + 4) hold flag k of agents 0-3.
  const bool my_take = my_mv && is_powerup(my_ditem);
  const bool my_plant = my_alive && pick4(moves, me) == M_BOMB &&
                        pick4(A.bc, me) < pick4(A.mb, me) && !my_org_bomb;
  const unsigned my_flags =
      (unsigned)(my_mv && pick4(A.kick, me) && my_bomb_dest) | (unsigned)my_plant << 4 |
      (unsigned)my_org_bomb << 8 | (unsigned)(my_take && my_ditem == C_EXTRABOMB) << 12 |
      (unsigned)(my_take && my_ditem == C_INCRRANGE) << 16 |
      (unsigned)(my_take && my_ditem == C_KICK) << 20;
  const unsigned flags = __reduce_or_sync(FULL, my_flags << me);
  int dest[NA], mv[NA], victim[NA], kick[NA], plant[NA], org_bomb[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    dest[i] = __shfl_sync(FULL, my_dest, i);
    mv[i] = (mv_bits >> i) & 1;
    victim[i] = (victim_bits >> i) & 1;
    kick[i] = (flags >> i) & 1u;
    plant[i] = (flags >> (4 + i)) & 1u;
    org_bomb[i] = (flags >> (8 + i)) & 1u;
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = g.c0 + j;
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if (kick[i] && c == dest[i]) s.bdir[j] = m[i];
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if ((mv[i] || victim[i]) && c == org[i]) s.board[j] = org_bomb[i] ? C_BOMB : C_PASSAGE;
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if (mv[i] && c == dest[i]) s.board[j] = C_AGENT0 + i;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      if (plant[i] && c == org[i]) {
        s.btimer[j] = BOMB_LIFETIME + 1;
        s.bstr[j] = A.st[i];  // the strength before this step's pick-up
        s.bown[j] = i;
        s.bdir[j] = 0;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    A.mb[i] += (flags >> (12 + i)) & 1u;
    A.st[i] += (flags >> (16 + i)) & 1u;
    A.kick[i] = A.kick[i] || ((flags >> (20 + i)) & 1u);
    A.dead[i] = A.dead[i] || victim[i];
    if (mv[i]) { A.x[i] = (dp[i] & 15) - 1; A.y[i] = (dp[i] >> 4) - 1; }
    A.bc[i] += plant[i];
  }

  // A board without a bomb: phases 2 and 3 change nothing (no bomb is
  // blocked, moves, collides or explodes, and the hand-over's max() with 0
  // keeps the non-negative planes).
  const bool any_bomb =
      __any_sync(FULL, (s.btimer[0] | s.btimer[1] | s.btimer[2] | s.btimer[3]) > 0);
  pc.mark(PH_MOVE);
  if (!any_bomb) return;
  pc.count(N_BOMB_STEPS);

  // ---- Phase 2: bomb kinematics ------------------------------------------
  int dir0[CPL];  // stale directions for reversion
#pragma unroll
  for (int j = 0; j < CPL; ++j) dir0[j] = s.bdir[j];
  // Block pass: two rounds.  A bomb only ever stops in phase 2, so a board
  // without a moving bomb here has none later: its bombs are blocked by
  // their own cells alone and its move pass is void.  A round that stopped
  // no bomb and triggered no agent changed nothing but restore_bomb_items,
  // which is idempotent and can only unblock a cell that nothing moves to,
  // so the second round would repeat it and is left out.
  bool moving[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) moving[j] = s.btimer[j] > 0 && s.bdir[j] != 0;
  const bool some_move = __any_sync(FULL, moving[0] || moving[1] || moving[2] || moving[3]);
  for (int round = 0; round < 2; ++round) {
    bool stops[CPL];  // the cell's item blocks a bomb that wants to enter
    bool blocked[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      stops[j] = static_block(s.board[j]) || is_agent(s.board[j]);
      blocked[j] = s.btimer[j] > 0 && stops[j];
    }
    bool stopped_one = false;
    if (some_move) {
      const Plane stop = ballot_plane(stops);
      bool hit = false;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        blocked[j] = s.btimer[j] > 0 && plane_nbr(g, stop, j, s.bdir[j], stops[j], true);
        hit |= blocked[j] && s.bdir[j] != 0;
      }
      stopped_one = __any_sync(FULL, hit);
    }
    const Plane blk = ballot_plane(blocked);
    int trigger[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int cell = A.x[i] + BS * A.y[i];
      trigger[i] = !A.dead[i] && plane_at(blk, cell) && dmove[i] && cell != old_cell[i];
    }
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (blocked[j]) s.bdir[j] = 0;
    revert_chain(s, A, trigger, mdx, mdy, dir0, g);
    restore_bomb_items(s, A, g);
    if (!stopped_one && !(trigger[0] | trigger[1] | trigger[2] | trigger[3])) break;
  }

  // Move pass.  Without a moving bomb it changes nothing: no arrival count
  // reaches 2, no kick is stopped, and restore_bomb_items has just run.
  bool slide[CPL] = {false, false, false, false};
#pragma unroll
  for (int j = 0; j < CPL; ++j) moving[j] = s.btimer[j] > 0 && s.bdir[j] != 0;
  if (some_move && __any_sync(FULL, moving[0] || moving[1] || moving[2] || moving[3])) {
    pc.count(N_MOVE_PASSES);
    bool sblock[CPL];
    int mdir[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      sblock[j] = static_block(s.board[j]);
      mdir[j] = moving[j] ? s.bdir[j] : 0;
    }
    const Plane sb = ballot_plane(sblock);
    const Nbr nd = neighbors(mdir);
    bool can_enter[CPL], two[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      // Only a moving bomb's can_enter is ever read.
      can_enter[j] = moving[j] && !plane_nbr(g, sb, j, s.bdir[j], sblock[j], true);
      // A direction-d mover arrives from the cell opposite to d.
      const int arrivals = (s.btimer[j] > 0 && !moving[j]) +
                           (on_board(g, j, 2) && nd.down[j] == 1) +
                           (on_board(g, j, 1) && nd.up[j] == 2) +
                           (on_board(g, j, 4) && nd.right[j] == 3) +
                           (on_board(g, j, 3) && nd.left[j] == 4);
      two[j] = arrivals >= 2;
    }
    const Plane crowd = ballot_plane(two);
    bool stopped_kick[CPL], collide[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      collide[j] = s.btimer[j] > 0 && plane_nbr(g, crowd, j, mdir[j], two[j], false);
      stopped_kick[j] = collide[j] && moving[j];
      if (collide[j] || (moving[j] && !can_enter[j])) s.bdir[j] = 0;
    }
    const Plane sk = ballot_plane(stopped_kick);
    {
      int trigger[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i)
        trigger[i] = !A.dead[i] && plane_at(sk, A.x[i] + BS * A.y[i]) && dmove[i];
      revert_chain(s, A, trigger, mdx, mdy, dir0, g);
      restore_bomb_items(s, A, g);
    }
    // Surviving movers advance one cell, each bomb as one packed word.
    bool do_move[CPL];
    int word[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      do_move[j] = s.btimer[j] > 0 && s.bdir[j] != 0 && can_enter[j] && !collide[j];
      word[j] = do_move[j] ? pack_bomb(s.bdir[j], s.btimer[j], s.bown[j], s.bstr[j]) : 0;
    }
    const Nbr nw = neighbors(word);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      // Source of a direction-d arrival, d = 1..4: DOWN, UP, RIGHT, LEFT.
      const int src[4] = {on_board(g, j, 2) ? nw.down[j] : 0, on_board(g, j, 1) ? nw.up[j] : 0,
                          on_board(g, j, 4) ? nw.right[j] : 0, on_board(g, j, 3) ? nw.left[j] : 0};
      int inc_t = 0, inc_s = 0, inc_d = 0, inc_o = 0;
      bool arrived = false;
#pragma unroll
      for (int d = 1; d <= 4; ++d) {
        const int w = src[d - 1];
        if ((w & 7) == d) {
          arrived = true;
          inc_d = max(inc_d, w & 7);
          inc_t = max(inc_t, (w >> 3) & 15);
          inc_o = max(inc_o, (w >> 7) & 3);
          inc_s = max(inc_s, w >> 9);
        }
      }
      s.btimer[j] = max(do_move[j] ? 0 : s.btimer[j], inc_t);
      s.bstr[j] = max(do_move[j] ? 0 : s.bstr[j], inc_s);
      s.bdir[j] = max(do_move[j] ? 0 : s.bdir[j], inc_d);
      s.bown[j] = max(do_move[j] ? 0 : s.bown[j], inc_o);
      if (do_move[j] && s.board[j] == C_BOMB && s.btimer[j] == 0) s.board[j] = C_PASSAGE;
      slide[j] = arrived && s.board[j] == C_FLAME;
      if (arrived && (s.board[j] == C_PASSAGE || is_powerup(s.board[j]))) s.board[j] = C_BOMB;
    }
  }

  pc.mark(PH_BOMBS);

  // ---- Phase 3: explosions (at most MAX_CHAIN_ROUNDS rounds) --------------
  bool explode[CPL], live[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const bool had_bomb = s.btimer[j] > 0;
    if (had_bomb && !slide[j]) s.btimer[j] -= 1;
    explode[j] = (had_bomb && s.btimer[j] == 0) || slide[j];
    live[j] = slide[j];
  }
  for (int round = 0; round < MAX_CHAIN_ROUNDS; ++round) {
    if (!__any_sync(FULL, explode[0] || explode[1] || explode[2] || explode[3])) break;
    pc.count(N_BLASTS);
    // Rays run forwards from every exploding cell: warp-uniform loops over
    // the set bits of the "explodes" plane, reading the "stops a ray" plane.
    bool wall[CPL];
    int s_cell[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      wall[j] = s.board[j] == C_RIGID || s.board[j] == C_WOOD;
      s_cell[j] = live[j] ? pick4(A.st, s.bown[j]) : s.bstr[j];
    }
    const Plane walls = ballot_plane(wall);
    const Plane ex = ballot_plane(explode);
    unsigned reach = 0;  // bit j: a ray reaches this lane's cell j
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      unsigned todo = ex.w[j];
      while (todo) {  // warp-uniform
        const int l = __ffs(todo) - 1;
        todo &= todo - 1;
        const int o = CPL * l + j;
        const int strength = min(__shfl_sync(FULL, s_cell[j], l), BS - 1);
        const int ox = o % BS, oy = o / BS;
#pragma unroll
        for (int d = 1; d <= 4; ++d) {
          const int room = d == 1 ? oy : d == 2 ? BS - 1 - oy : d == 3 ? ox : BS - 1 - ox;
          const int len = min(strength, room);
          int n = o;
          for (int k = 1; k <= len; ++k) {
            n += dir_delta(d);
            if ((n >> 2) == g.lane) reach |= 1u << (n & 3);
            if (plane_at(walls, n)) break;
          }
        }
      }
    }
    int kill = 0;
    unsigned refund = 0;
    bool burn[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      burn[j] = explode[j] || (((reach >> j) & 1u) && s.board[j] != C_RIGID);
      if (burn[j] && is_agent(s.board[j])) kill |= 1 << (s.board[j] - C_AGENT0);
      if (explode[j]) refund += 1u << (8 * s.bown[j]);
    }
    const int victims = (int)__reduce_or_sync(FULL, (unsigned)kill);
    // One 8-bit field per owner: at most 121 bombs explode at once.
    const unsigned refunds = __reduce_add_sync(FULL, refund);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const bool next_explode = burn[j] && s.btimer[j] > 0 && !explode[j];
      if (burn[j]) {
        if (s.board[j] != C_WOOD) s.hidden[j] = 0;
        s.board[j] = C_FLAME;
        s.ftimer[j] = FLAME_LIFETIME;
      }
      if (explode[j]) { s.btimer[j] = 0; s.bstr[j] = 0; s.bdir[j] = 0; s.bown[j] = 0; }
      explode[j] = live[j] = next_explode;
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      A.bc[i] -= (int)((refunds >> (8 * i)) & 255u);
      A.dead[i] = A.dead[i] || ((victims >> i) & 1);
    }
  }
  pc.mark(PH_BLAST);
}

}  // namespace wl
}  // namespace pomcpp
