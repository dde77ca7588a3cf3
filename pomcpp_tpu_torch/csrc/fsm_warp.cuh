// One SimpleAgent act for all four agents of one board held by ONE WARP, as
// device code of rollout_chunk_kernel<true> (fused_step.cu).
//
// Replaces `fsm_block` (pomcpp_tpu/engine/pallas_fsm.py:357) and the helpers
// it inlines, `danger_map_tile` (:115) and the 4-agent BFS `swar_bfs` (:146),
// as fsm_block.cuh does for the one-act kernel.  The semantic spec is the
// plain PyTorch version, pomcpp_tpu_torch/engine/fsm.py `fsm_act_plain`; the
// code below must agree with it bit for bit.  fsm_block.cuh supplies the
// constants, `FsmView` and the per-agent decision `agent_decide`, which this
// file calls on a view of the warp's own shared-memory slice.
//
// What bounded the CTA layout on this card: one CTA barrier per BFS round
// (20-50 rounds an act), five more around the maps, and a danger map that
// scanned 22 cells of shared memory per cell whether or not the board held a
// bomb.  What this layout does about it (lane l holds cells 4l..4l+3, see
// step_warp.cuh):
//   1. Danger map: not a scan from every cell but a warp-uniform loop over
//      the board's bombs (the set bits of a ballot plane); each bomb's timer
//      and strength arrive in one shuffle and every lane tests its four
//      cells against the bomb's cross.  A board without bombs costs four
//      ballots.
//   2. BFS: the 12-bit field of a cell stays in a register, two cells to a
//      word, so that a lane's four cells merge in two SWAR operations.  A
//      round fetches the four parents' round-start fields with 8 shuffles
//      (pair_neighbors) in the order DOWN, UP, RIGHT, LEFT, first writer
//      wins, and ends with one __any_sync; the double buffer in shared
//      memory is gone.  A cell sends its field only if it is walkable (the
//      parent-side mask of the spec, applied at the sender); the receiver's
//      mask joins "enterable" and "has that neighbour", one word per
//      direction and cell pair.  The sources' seeds act in the first
//      round only -- afterwards every enterable neighbour of a source is
//      visited and `& ~cur` discards them -- so the first round sends the
//      source fields, scaled by the direction's rank, and later rounds carry
//      no seed.
//   3. Flee target: one __reduce_min_sync per agent in danger over each
//      lane's first window cell; no per-warp table.
//   4. Dynamic-index reads: the decision cascade runs on lanes 0-3, one
//      agent each, and reads the BFS field, the board code and the danger
//      value at cells only that lane knows.  The three planes are written to
//      the warp's shared-memory slice (a __syncwarp() after the writes and
//      one before the slice is overwritten) and read by index there.  The
//      FSM state lives in the same slice for the whole chunk, touched only
//      by its agent's lane.
// Every *_sync intrinsic sits in warp-uniform control flow; the cascade on
// lanes 0-3 contains none.
//
// What bounds it now: the BFS rounds' shuffle latency (one dependent
// exchange per round) and the serial cascade on four lanes.
#pragma once

#include <cstddef>
#include <cstdint>

#include "fsm_block.cuh"
#include "step_warp.cuh"

namespace pomcpp {
namespace wl {

// A warp's FSM slice, aligned for the 16-byte stores of the maps.  It is the
// CTA layout's FsmShared because `agent_decide` (fsm_block.cuh, shared with
// the one-act kernel) takes one.  This layout uses field[0] only, row 0 of
// `first` (fsm_slice_init pins rows 1-3 to NO_CELL for agent_decide's
// minimum over four rows) and not `mv`: 576 of a slice's 2,272 bytes are
// unused, which does not limit residency (the registers do).
// The slice gets a struct of its own when the one-act kernel moves to this
// body and fsm_block.cuh goes.
struct alignas(16) FsmSlice : FsmShared {};

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

// One act.  Every lane calls it with the same `A` and `rnd` (each agent's
// rand); on return every lane holds the four FSM moves in `mv`.  `fs` is the
// warp's own slice.
__device__ void fsm_act(const Cells& s, const Agents& A, const int rnd[NA], FsmSlice& fs,
                        int mv[NA], const Geo& g, PhaseClock& pc) {
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

  // ---- 2. Four-agent BFS ------------------------------------------------------
  int ac[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) ac[i] = A.x[i] + BS * A.y[i];
  int cur[CPL];
  {
    Pairs f, wmask;
    BfsMasks bm;
    int src[CPL];
    bool walk[CPL], ent[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = g.c0 + j;
      src[j] = 0;
#pragma unroll
      for (int i = 0; i < NA; ++i)
        if (!A.dead[i] && ac[i] == c) src[j] |= 1 << (3 * i);
      walk[j] = c < NC && is_walkable(s.board[j]);
      ent[j] = c < NC && (is_walkable(s.board[j]) || is_agent(s.board[j]));
    }
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      f.p[w] = (unsigned)src[2 * w] | ((unsigned)src[2 * w + 1] << 16);
      wmask.p[w] = (walk[2 * w] ? 0xFFFu : 0u) | (walk[2 * w + 1] ? 0xFFF0000u : 0u);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        bm.m[r][w] = (ent[2 * w] && on_board(g, 2 * w, r + 1) ? (unsigned)VIS3 : 0u) |
                     (ent[2 * w + 1] && on_board(g, 2 * w + 1, r + 1) ? (unsigned)VIS3 << 16 : 0u);
    }
    // The first round seeds the sources' neighbours; it also decides whether
    // a second round is needed, as every round does.  Later rounds send a
    // cell's field only if the cell is walkable.
    bool more = __any_sync(FULL, bfs_round<true>(f, f, bm));
    for (int round = 1; round < NC && more; ++round) {
      const Pairs send = {{f.p[0] & wmask.p[0], f.p[1] & wmask.p[1]}};
      more = __any_sync(FULL, bfs_round<false>(f, send, bm));
      pc.count(N_BFS_ROUNDS);
    }
#pragma unroll
    for (int j = 0; j < CPL; ++j) cur[j] = (int)((f.p[j >> 1] >> (16 * (j & 1))) & 0xFFFu);
  }

  pc.mark(PH_BFS);

  // The maps, for the reads by computed index below: one 16-byte store a
  // plane (a slice is 16-byte aligned and each plane is 512 bytes).
  static_assert(offsetof(FsmShared, dmap) % 16 == 0 && offsetof(FsmShared, board) % 16 == 0 &&
                    offsetof(FsmShared, field) % 16 == 0,
                "the planes of an FSM slice must stay 16-byte aligned");
  __syncwarp();
  *reinterpret_cast<int4*>(&fs.field[0][g.c0]) = make_int4(cur[0], cur[1], cur[2], cur[3]);
  *reinterpret_cast<int4*>(&fs.board[g.c0]) =
      make_int4(s.board[0], g.c0 + 1 < NC ? s.board[1] : C_RIGID,
                g.c0 + 2 < NC ? s.board[2] : C_RIGID, g.c0 + 3 < NC ? s.board[3] : C_RIGID);
  *reinterpret_cast<int4*>(&fs.dmap[g.c0]) =
      make_int4(danger[0], danger[1], danger[2], danger[3]);
  __syncwarp();

  // ---- 3. Flee target: first masked cell per agent (row-major) --------------
  // An agent whose own cell is safe has an empty window (rad == 0): the
  // branch is warp-uniform, every lane reads the same `rad`.
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int rad = fs.dmap[ac[i]];
    int first = NO_CELL;
    if (rad > 0) {
      int local_first = NO_CELL;
#pragma unroll
      for (int j = CPL - 1; j >= 0; --j) {
        const int c = g.c0 + j, lx = c % BS, ly = c / BS;
        // The reference's window (strategy.cpp:126-128): y in [oy-rad, rad),
        // x in [ox-rad, rad), manhattan <= rad; reached and not the source.
        const int manh = abs(lx - A.x[i]) + abs(ly - A.y[i]);
        if (ly < rad && lx < rad && manh <= rad && ((cur[j] >> (3 * i)) & 1) && c != ac[i] &&
            c < NC && safe_for(danger[j], 2))
          local_first = c;
      }
      first = (int)__reduce_min_sync(FULL, (unsigned)local_first);
    }
    fs.first[0][i] = first;
  }
  // (Every lane stores the same value; agent_decide takes the minimum over
  // the four rows of `first`, so the other three hold NO_CELL for good.)

  // ---- 4. Decisions, one agent per lane ---------------------------------------
  __syncwarp();
  pc.mark(PH_FLEE);
  int move = 0;
  if (g.lane < NA) move = agent_decide(g.lane, A, pick4(rnd, g.lane), fs.field[0], fs);
#pragma unroll
  for (int i = 0; i < NA; ++i) mv[i] = __shfl_sync(FULL, move, i);
  pc.mark(PH_DECIDE);
}

// A fresh slice: rows 1-3 of the flee-target table are never written again.
__device__ __forceinline__ void fsm_slice_init(FsmSlice& fs, const Geo& g) {
  if (g.lane < NA) {
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) fs.first[w][g.lane] = NO_CELL;
  }
}

}  // namespace wl
}  // namespace pomcpp
