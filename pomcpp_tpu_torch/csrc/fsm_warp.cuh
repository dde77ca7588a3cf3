// One SimpleAgent act for all four agents of one board held by ONE WARP, as
// device code of rollout_chunk_kernel<true> (every step of a chunk) and of
// fsm_act_kernel (one act for B boards), both in fused_step.cu.
//
// Replaces `fsm_block` (pomcpp_tpu/engine/pallas_fsm.py:357) and the helpers
// it inlines, `danger_map_tile` (:115) and the 4-agent BFS `swar_bfs` (:146).
// The semantic spec is the plain PyTorch version,
// pomcpp_tpu_torch/engine/fsm.py `fsm_act_plain` (the toolkit FSM of
// agents/simple_cellular.py with dead agents' BFS sources pruned); the code
// below must agree with it bit for bit.  This file also holds the FSM state
// (`FsmView` in device memory, the warp's `FsmSlice` in shared memory) and
// the per-agent decision `agent_decide`; common.cuh supplies the constants.
//
// What bounded the layout this replaced (one board per 128-thread CTA, one
// cell per thread) on this card: one CTA barrier per BFS round (20-50 rounds
// an act), five more around the maps, and a danger map that scanned 22 cells
// of shared memory per cell whether or not the board held a bomb.  What this
// layout does about it (lane l holds cells 4l..4l+3, see step_warp.cuh):
//   1. Danger map: not a scan from every cell but a warp-uniform loop over
//      the board's bombs (the set bits of a ballot plane); each bomb's timer
//      and strength arrive in one shuffle and every lane tests its four
//      cells against the bomb's cross.  A board without bombs costs four
//      ballots.
//   2. BFS: the 12-bit field of a cell (per agent i, bits [3i, 3i+3) =
//      visited | root rank << 1) stays in a register, two cells to a word, so
//      that a lane's four cells merge in two SWAR operations.  A round
//      fetches the four parents' round-start fields with 8 shuffles
//      (pair_neighbors) in the order DOWN, UP, RIGHT, LEFT, first writer
//      wins, and ends with one __any_sync; no double buffer in shared
//      memory.  A cell sends its field only if it is walkable (the
//      parent-side mask of the spec, applied at the sender); the receiver's
//      mask joins "enterable" and "has that neighbour", one word per
//      direction and cell pair.  The sources' seeds act in the first
//      round only -- afterwards every enterable neighbour of a source is
//      visited and `& ~cur` discards them -- so the first round sends the
//      source fields, scaled by the direction's rank, and later rounds carry
//      no seed.
//      The BFS runs only for acts whose decisions read it.  The cascade
//      reads an agent's field at two cells, and uses what it reads only in
//      one case each: at the flee cell (the first reached, safe cell of the
//      agent's window) when the agent is in danger, and at the enemy cell
//      when the move toward it can be taken (calm, can bomb, no live agent
//      within 1, one within 7, no loop in the ring: agent_decide's b3).
//      Every term is known before the BFS, so lanes 0-3 each work out their
//      agent's need (agent_need), and one vote skips the rest when no agent
//      has one: no sources, masks or rounds, the fields left empty.
//      Otherwise each lane marks, per agent, the cells of its four that the
//      agent needs (in the fields' own layout): the enterable safe cells of
//      its window, or its enemy cell; with no such cell in the warp (a second
//      vote) no round runs either.  An act that runs the BFS runs it to the
//      end, so every field any decision reads is the full BFS's, and every
//      move, ring and moveQueue slot too, bit for bit.  Stopping once every
//      needed cell is visited (or its agent's fields stop changing) is exact
//      as well, but on the card its test in every round cost more than the
//      rounds it saved: an act that needs the BFS mostly needs a cell that
//      is reached late or never, so its agent's whole area is explored.
//   3. Flee target: one __reduce_min_sync per agent in danger over each
//      lane's first needed cell that was reached; no per-warp table.
//   4. Dynamic-index reads: the decision cascade (agent_decide) runs on lanes
//      0-3, one agent each, and reads the BFS field, the board code and the
//      danger value at cells only that lane knows.  The three planes are
//      written to the warp's shared-memory slice and read by index there:
//      the board codes and the danger map before the BFS (the needs read
//      the danger at the agents' cells), the fields after it, a
//      __syncwarp() before the first write and after each.  The FSM state
//      lives in the same slice (for a whole chunk, in the chunk kernel),
//      touched only by its agent's lane.
// Every *_sync intrinsic sits in warp-uniform control flow; the cascade on
// lanes 0-3 contains none.
//
// What bounds it now: the instructions of the BFS rounds of the acts that need
// them (one dependent exchange a round), the serial cascade on four lanes,
// and the board's movement in step_warp.cuh.
#pragma once

#include <cstddef>
#include <cstdint>

#include "step_warp.cuh"

namespace pomcpp {

constexpr int RP_STALE = 14;          // ring code of (0, 0)
constexpr int NO_CELL = NT;           // above every cell index
constexpr int DANGER_NONE = 1 << 30;
constexpr int VIS3 = 0x249;           // bit 3i: visited by agent i
constexpr int M_IDLE = 0, M_UP = 1, M_DOWN = 2, M_LEFT = 3, M_RIGHT = 4;

struct FsmView {
  int32_t* f[10];  // ring slots x4, ring head, ring count, moveQueue slots x4: [B, 4]
};

namespace wl {

// A warp's FSM slice of shared memory, aligned for the 16-byte stores of
// the maps: 1,696 bytes.
struct alignas(16) FsmSlice {
  int dmap[NT];   // danger map, 0 where no bomb covers the cell
  int board[NT];  // board codes (pad cells: C_RIGID)
  int field[NT];  // BFS fields
  int first[NA];  // per agent: first flee cell, or NO_CELL
  int rp[NA][4];  // ring codes per agent, logical order (slot 0 oldest)
  int rpc[NA];    // ring count
  int mq[NA][4];  // moveQueue slots
};

__device__ __forceinline__ bool is_walkable(int v) { return v == C_PASSAGE || is_powerup(v); }
__device__ __forceinline__ bool safe_for(int danger, int min_time) {
  return danger == 0 || danger >= min_time;
}
__device__ __forceinline__ int enc_pos(int x, int y) { return (x + 1) + 13 * (y + 1); }
__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}
// BFS root rank -> move, in the priority order DOWN, UP, RIGHT, LEFT.
__device__ __forceinline__ int rank_move(int r) {
  return r == 0 ? M_DOWN : r == 1 ? M_UP : r == 2 ? M_RIGHT : M_LEFT;
}

// Lane i < NA loads, stores or resets agent i's FSM state.  The ring head
// (f[4]) is always 0 in this layout: the slice keeps the ring in logical
// order.
__device__ __forceinline__ void fsm_load(const FsmView& in, int b, int lane, FsmSlice& fs) {
  if (lane < NA) {
    const int o = b * NA + lane;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fs.rp[lane][j] = in.f[j][o];
      fs.mq[lane][j] = in.f[6 + j][o];
    }
    fs.rpc[lane] = in.f[5][o];
  }
}

__device__ __forceinline__ void fsm_store(const FsmView& out, int b, int lane, const FsmSlice& fs) {
  if (lane < NA) {
    const int o = b * NA + lane;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out.f[j][o] = fs.rp[lane][j];
      out.f[6 + j][o] = fs.mq[lane][j];
    }
    out.f[4][o] = 0;
    out.f[5][o] = fs.rpc[lane];
  }
}

// A board's reset: ring slots stale, count and moveQueue slots 0.
__device__ __forceinline__ void fsm_reset(int lane, FsmSlice& fs) {
  if (lane < NA) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fs.rp[lane][j] = RP_STALE;
      fs.mq[lane][j] = 0;
    }
    fs.rpc[lane] = 0;
  }
}

// Agent i's enemy target: the first live agent (id order) within manhattan 7
// not on its cell, or -1; and whether another live agent is within 1, and
// within 7, of it.
struct Enemy {
  int cell;
  bool adj1, adj7;
};

__device__ __forceinline__ Enemy enemy_of(int i, const Agents& A) {
  const int x = pick4(A.x, i), y = pick4(A.y, i);
  Enemy e = {-1, false, false};
#pragma unroll
  for (int j = NA - 1; j >= 0; --j) {
    const int mh = abs(A.x[j] - x) + abs(A.y[j] - y);
    if (!A.dead[j] && mh > 0 && mh <= 7) e.cell = A.x[j] + BS * A.y[j];
    if (j != i && !A.dead[j]) {
      e.adj1 |= mh <= 1;
      e.adj7 |= mh <= 7;
    }
  }
  return e;
}

// Whether agent i's recent positions loop: slots 0 and 1 equal slots 2 and
// 3 as far as the ring holds both of a pair (a ring of one or none loops).
__device__ __forceinline__ bool ring_loop(int i, const FsmSlice& fs) {
  const int rpc = fs.rpc[i];
  bool loop = true;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (j < rpc / 2) loop &= fs.rp[i][j] == fs.rp[i][j + 2];
  return loop;
}

// The decision of agent i (run by lane i): reads the maps in `fs`, updates
// the agent's FSM state there and returns its move.  `fc` is the agent's
// flee cell (the first safe cell of its window), or NO_CELL.
__device__ int agent_decide(int i, const Agents& A, int rnd, int fc, FsmSlice& fs) {
  const int x = pick4(A.x, i), y = pick4(A.y, i), me = x + BS * y, sh3 = 3 * i;
  const bool in_danger = fs.dmap[me] > 0;

  // Path A: flee toward the first safe window cell.
  int m_safe = M_IDLE;
  if (fc != NO_CELL) {
    const int fv = (fs.field[fc] >> sh3) & 7;
    if (fv & 1) m_safe = rank_move(fv >> 1);
  }
  const Enemy e = enemy_of(i, A);
  int m_enemy = M_IDLE;
  if (e.cell >= 0) {
    const int ev = (fs.field[e.cell] >> sh3) & 7;
    if (ev & 1) m_enemy = rank_move(ev >> 1);
  }

  // Neighbours in SafeDirections order RIGHT, LEFT, DOWN, UP.
  const int dirs[4] = {M_RIGHT, M_LEFT, M_DOWN, M_UP};
  bool a_ok = false, b3_ok = false, wood_adj = fs.board[me] == C_WOOD;
  int cnt = 0, newq = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int n = neighbor(me, dirs[s]);
    if (n < 0) continue;
    const int v = fs.board[n], d = fs.dmap[n];
    wood_adj |= v == C_WOOD;
    if (!is_walkable(v)) continue;
    const bool ok2 = safe_for(d, 2), ok5 = safe_for(d, 5);
    a_ok |= m_safe == dirs[s] && ok2;
    b3_ok |= m_enemy == dirs[s] && ok5;
    if (ok2) {
      newq |= dirs[s] << (4 * cnt);
      ++cnt;
    }
  }
  a_ok = in_danger && a_ok;
  const bool a_else = in_danger && !a_ok;

  // moveQueue: the safe moves over the persistent slots, each nibble
  // (value | visited << 3); visited = its desired position is in the ring.
  const int rpc = fs.rpc[i];
  int q = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int v = r < cnt ? (newq >> (4 * r)) & 15 : fs.mq[i][r];
    const int vv = v < 0 ? 0 : v > 5 ? 5 : v;
    const int enc = enc_pos(x + move_dx(vv), y + move_dy(vv));
    bool vis = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) vis |= j < rpc && fs.rp[i][j] == enc;
    q |= ((v & 7) | (vis << 3)) << (4 * r);
  }
  // SortDirections: the RemoveAt+AddElem aliasing walk, 8 applications.
  {
    const int cm1 = min(max(cnt - 1, 0), 4);
    const int up_mask = (1 << (4 * cm1)) - 1;  // nibbles below count-1
    const int sh_c = 4 * min(max(cnt - 1, 0), 3);
    const int app_clear = ~(15 << sh_c);
    int it = 0, removes = 0;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const bool active = it < cnt && removes < 4;
      const int sh_i = 4 * min(it, 7);
      const bool act = active && ((q >> sh_i) & 15) >= 8;
      const int win = up_mask & ~((1 << sh_i) - 1);  // nibbles [it, count-1)
      const int shifted = (q & ~win) | ((q >> 4) & win);
      const int val = (shifted >> sh_i) & 15;
      if (act) {
        q = (shifted & app_clear) | (val << sh_c);
        --it;
      }
      ++it;
      removes += act;
    }
  }
  const int m_queue = cnt == 0 ? M_IDLE : floor_mod(rnd, 2) == 1 ? (q >> 4) & 7 : q & 7;

  // Path B: aggression.
  const bool rp_loop = ring_loop(i, fs);
  const bool can_bomb = pick4(A.bc, i) < pick4(A.mb, i);
  const bool calm = !in_danger;
  const bool b1 = calm && can_bomb && e.adj1;
  const bool b2 = calm && can_bomb && !b1 && e.adj7 && rp_loop;
  const bool b3 = calm && can_bomb && !b1 && !b2 && e.adj7 && b3_ok;
  const bool b4 = calm && can_bomb && !b1 && !b2 && !b3 && wood_adj;
  const bool c_path = calm && !b1 && !b2 && !b3 && !b4;
  const int move = a_ok ? m_safe
                   : a_else ? m_queue
                   : b1 ? M_BOMB
                   : b2 ? floor_mod(rnd, 4)
                   : b3 ? m_enemy
                   : b4 ? M_BOMB
                        : m_queue;

  // The moveQueue persists only when the queue path ran.
  if (a_else || c_path) {
#pragma unroll
    for (int k = 0; k < 4; ++k) fs.mq[i][k] = (q >> (4 * k)) & 7;
  }
  // recentPositions: push the desired position of this move.
  const int enc = enc_pos(x + move_dx(move), y + move_dy(move));
  if (rpc == 4) {
    fs.rp[i][0] = fs.rp[i][1];
    fs.rp[i][1] = fs.rp[i][2];
    fs.rp[i][2] = fs.rp[i][3];
    fs.rp[i][3] = enc;
  } else {
    fs.rp[i][rpc & 3] = enc;
    fs.rpc[i] = rpc + 1;
  }
  return move;
}

// BFS fields travel and merge two cells to a word (SWAR): a lane's cells
// (0, 1) in one word, (2, 3) in another, a cell's 12-bit field in each
// 16-bit half.
struct Pairs {
  unsigned p[2];
};

// (a's high half, b's low half) as the (low, high) halves of one word.
__device__ __forceinline__ unsigned halves(unsigned a, unsigned b) {
  return __funnelshift_r(a, b, 16);
}

// The four neighbours' fields of a lane's four cells, packed as `Pairs`:
// 8 shuffles.  With cells c0..c3 here, the word q = (c1, c2) serves three
// directions: it is this lane's own LEFT of (c2, c3) and RIGHT of (c0, c1),
// the UP of (c0, c1) three lanes on and the DOWN of (c2, c3) three lanes
// back (c - 11 = 4 (l - 3) + j + 1, see wl::neighbors).
struct PairNbr {
  Pairs up, down, left, right;
};

__device__ __forceinline__ PairNbr pair_neighbors(const Pairs& v) {
  const unsigned q = halves(v.p[0], v.p[1]);
  PairNbr n;
  n.left.p[0] = halves(__shfl_up_sync(FULL, v.p[1], 1), v.p[0]);
  n.left.p[1] = q;
  n.right.p[0] = q;
  n.right.p[1] = halves(v.p[1], __shfl_down_sync(FULL, v.p[0], 1));
  n.up.p[0] = __shfl_up_sync(FULL, q, 3);
  n.up.p[1] = halves(__shfl_up_sync(FULL, v.p[1], 3), __shfl_up_sync(FULL, v.p[0], 2));
  n.down.p[0] = halves(__shfl_down_sync(FULL, v.p[1], 2), __shfl_down_sync(FULL, v.p[0], 3));
  n.down.p[1] = __shfl_down_sync(FULL, q, 3);
  return n;
}

// First-writer-wins merge of the candidate fields `cand` into `cur`; `m`
// holds the visited bits of the cells that may be entered from this side.
// `nw` has bits only at multiples of 3 within each half, so nw * 7 fills
// each first visit's 3-bit field and carries nothing across.
__device__ __forceinline__ unsigned bfs_merge(unsigned cur, unsigned cand, unsigned m) {
  const unsigned nw = cand & ~cur & m;
  return cur | (cand & ((nw << 3) - nw));
}

// The per-direction entry masks of a lane's two words: a cell takes a
// candidate from direction d if it is enterable and has that neighbour.
struct BfsMasks {
  unsigned m[4][2];  // [parent rank: UP, DOWN, LEFT, RIGHT neighbour][word]
};

// One BFS round; returns whether a field of this lane changed.  kFirst: the
// candidates are the sources' fields scaled by the direction's rank
// (1 | r << 1, each set bit being a visited bit).
template <bool kFirst>
__device__ __forceinline__ bool bfs_round(Pairs& cur, const Pairs& send, const BfsMasks& bm) {
  const PairNbr n = pair_neighbors(send);
  bool changed = false;
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    // Parents in the order of the moves DOWN, UP, RIGHT, LEFT: a DOWN move
    // arrives from the cell above, and so on.
    const unsigned par[4] = {n.up.p[w], n.down.p[w], n.left.p[w], n.right.p[w]};
    const unsigned start = cur.p[w];
    unsigned f = start;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      f = bfs_merge(f, kFirst ? par[r] * (unsigned)(1 | (r << 1)) : par[r], bm.m[r][w]);
    cur.p[w] = f;
    changed |= f != start;
  }
  return changed;
}

// What agent i's decision reads of its BFS field and may use (agent_decide),
// for lane i to work out: NEED_FLEE | radius << 2 when it is alive and in
// danger (its flee window), NEED_ENEMY | cell << 2 when the move toward its
// enemy can be taken (calm, can bomb, no live agent within 1, one within 7,
// no loop in its ring: b3), else 0.
constexpr int NEED_FLEE = 1, NEED_ENEMY = 2;

__device__ __forceinline__ int agent_need(int i, const Agents& A, const FsmSlice& fs) {
  if (pick4(A.dead, i)) return 0;
  const int rad = fs.dmap[pick4(A.x, i) + BS * pick4(A.y, i)];
  if (rad > 0) return NEED_FLEE | rad << 2;
  const Enemy e = enemy_of(i, A);
  const bool b3 = pick4(A.bc, i) < pick4(A.mb, i) && !e.adj1 && e.adj7 && !ring_loop(i, fs);
  return b3 ? NEED_ENEMY | e.cell << 2 : 0;
}

// One act.  Every lane calls it with the same `A` and `rnd` (each agent's
// rand); on return every lane holds the four FSM moves in `mv`.  `fs` is the
// warp's own slice.
template <class Clock>
__device__ void fsm_act(const Cells& s, const Agents& A, const int rnd[NA], FsmSlice& fs,
                        int mv[NA], const Geo& g, Clock& pc) {
  // ---- 1. Danger map ---------------------------------------------------------
  int danger[CPL];
  {
    bool bomb[CPL];
    int best[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      bomb[j] = s.btimer[j] > 0;
      best[j] = DANGER_NONE;
    }
    const Plane bombs = ballot_plane(bomb);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      unsigned todo = bombs.w[j];
      while (todo) {  // warp-uniform
        const int l = __ffs(todo) - 1;
        todo &= todo - 1;
        const int o = CPL * l + j, ox = o % BS, oy = o / BS;
        const int t = __shfl_sync(FULL, s.btimer[j], l);
        const int str = __shfl_sync(FULL, s.bstr[j], l);
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const int c = g.c0 + k, x = c % BS, y = c / BS;
          const bool covered = c == o || (y == oy && str >= abs(x - ox)) ||
                               (x == ox && str >= abs(y - oy));
          if (covered && c < NC) best[k] = min(best[k], t);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CPL; ++j) danger[j] = best[j] == DANGER_NONE ? 0 : best[j];
  }

  pc.mark(PH_DANGER);

  // The board codes and the danger map, for the reads by computed index
  // below (the needs, the cascade): one 16-byte store a plane (a slice is
  // 16-byte aligned and each plane is 512 bytes).  The BFS fields follow
  // after the BFS.
  static_assert(offsetof(FsmSlice, dmap) % 16 == 0 && offsetof(FsmSlice, board) % 16 == 0 &&
                    offsetof(FsmSlice, field) % 16 == 0,
                "the planes of an FSM slice must stay 16-byte aligned");
  __syncwarp();
  *reinterpret_cast<int4*>(&fs.board[g.c0]) =
      make_int4(s.board[0], g.c0 + 1 < NC ? s.board[1] : C_RIGID,
                g.c0 + 2 < NC ? s.board[2] : C_RIGID, g.c0 + 3 < NC ? s.board[3] : C_RIGID);
  *reinterpret_cast<int4*>(&fs.dmap[g.c0]) =
      make_int4(danger[0], danger[1], danger[2], danger[3]);
  __syncwarp();

  // ---- 2. Four-agent BFS, for the acts whose decisions read it --------------
  // Lanes 0-3 work out their agent's need; with none in the warp (one vote)
  // the fields stay empty and nothing below reads them into a move.
  const int ask = g.lane < NA ? agent_need(g.lane, A, fs) : 0;
  Pairs f = {{0u, 0u}}, need = {{0u, 0u}};
  unsigned fleeing = 0;  // bit i: agent i is alive and in danger
  if (__any_sync(FULL, ask != 0)) {
    int src[CPL], nd[CPL];
    bool walk[CPL], ent[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = g.c0 + j;
      src[j] = nd[j] = 0;
#pragma unroll
      for (int i = 0; i < NA; ++i)
        if (!A.dead[i] && A.x[i] + BS * A.y[i] == c) src[j] |= 1 << (3 * i);
      walk[j] = c < NC && is_walkable(s.board[j]);
      ent[j] = c < NC && (is_walkable(s.board[j]) || is_agent(s.board[j]));
    }
    // Each agent's needed cells among this lane's four, in the fields' own
    // layout: the enterable safe cells of its flee window (phase 3 takes the
    // first one reached), or its enemy's cell.  Warp-uniform branches.
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int a = __shfl_sync(FULL, ask, i), arg = a >> 2;
      if (a & NEED_FLEE) {
        fleeing |= 1u << i;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = g.c0 + j, lx = c % BS, ly = c / BS;
          // The reference's window (strategy.cpp:126-128): y in [oy-rad, rad),
          // x in [ox-rad, rad), manhattan <= rad; not the source.
          const int manh = abs(lx - A.x[i]) + abs(ly - A.y[i]);
          if (ly < arg && lx < arg && manh <= arg && manh > 0 && ent[j] &&
              safe_for(danger[j], 2))
            nd[j] |= 1 << (3 * i);
        }
      } else if (a & NEED_ENEMY) {
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          if (g.c0 + j == arg && ent[j]) nd[j] |= 1 << (3 * i);
      }
    }
    Pairs wmask;
    BfsMasks bm;
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      f.p[w] = (unsigned)src[2 * w] | ((unsigned)src[2 * w + 1] << 16);
      need.p[w] = (unsigned)nd[2 * w] | ((unsigned)nd[2 * w + 1] << 16);
      wmask.p[w] = (walk[2 * w] ? 0xFFFu : 0u) | (walk[2 * w + 1] ? 0xFFF0000u : 0u);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        bm.m[r][w] = (ent[2 * w] && on_board(g, 2 * w, r + 1) ? (unsigned)VIS3 : 0u) |
                     (ent[2 * w + 1] && on_board(g, 2 * w + 1, r + 1) ? (unsigned)VIS3 << 16 : 0u);
    }
    // No needed cell anywhere: no round.  Otherwise the first round seeds
    // the sources' neighbours; it also decides whether a second round is
    // needed, as every round does.  Later rounds send a cell's field only if
    // the cell is walkable.
    if (__any_sync(FULL, (need.p[0] | need.p[1]) != 0u)) {
      pc.count(N_BFS_ACTS);
      bool more = __any_sync(FULL, bfs_round<true>(f, f, bm));
      for (int round = 1; round < NC && more; ++round) {
        const Pairs send = {{f.p[0] & wmask.p[0], f.p[1] & wmask.p[1]}};
        more = __any_sync(FULL, bfs_round<false>(f, send, bm));
        pc.count(N_BFS_ROUNDS);
      }
    }
  }

  pc.mark(PH_BFS);

  *reinterpret_cast<int4*>(&fs.field[g.c0]) =
      make_int4((int)(f.p[0] & 0xFFFu), (int)((f.p[0] >> 16) & 0xFFFu), (int)(f.p[1] & 0xFFFu),
                (int)((f.p[1] >> 16) & 0xFFFu));

  // ---- 3. Flee target: first needed cell reached, per agent (row-major) -----
  // The branch is warp-uniform: every lane holds the same `fleeing`.
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    int first = NO_CELL;
    if ((fleeing >> i) & 1u) {
      int local_first = NO_CELL;
#pragma unroll
      for (int j = CPL - 1; j >= 0; --j)
        if ((((need.p[j >> 1] & f.p[j >> 1]) >> (16 * (j & 1) + 3 * i)) & 1u) != 0u)
          local_first = g.c0 + j;
      first = (int)__reduce_min_sync(FULL, (unsigned)local_first);
    }
    fs.first[i] = first;  // every lane stores the same value
  }

  // ---- 4. Decisions, one agent per lane ---------------------------------------
  __syncwarp();
  pc.mark(PH_FLEE);
  int move = 0;
  if (g.lane < NA) move = agent_decide(g.lane, A, pick4(rnd, g.lane), fs.first[g.lane], fs);
#pragma unroll
  for (int i = 0; i < NA; ++i) mv[i] = __shfl_sync(FULL, move, i);
  pc.mark(PH_DECIDE);
}

}  // namespace wl
}  // namespace pomcpp
