// One SimpleAgent act for all four agents of one board, as device code
// shared by rollout_chunk_kernel<true> and fsm_act_kernel (fused_step.cu).
//
// Replaces `fsm_block` (pomcpp_tpu/engine/pallas_fsm.py:357) and the helpers
// it inlines: `danger_map_tile` (:115) and the 4-agent BFS `swar_bfs` (:146).
// The semantic spec is the plain PyTorch version,
// pomcpp_tpu_torch/engine/fsm.py `fsm_act_plain` (the toolkit FSM of
// agents/simple_cellular.py with dead agents' BFS sources pruned); the code
// below must agree with it bit for bit.
//
// Layout: as step_block.cuh, one board per CTA of 128 threads, thread c
// owns cell c.  The phases:
//   1. danger map -- each cell scans its row and column in shared memory
//      for bombs whose cross covers it (distance <= strength; blasts pass
//      through walls and items and never wrap rows) and keeps the minimum
//      timer;
//   2. BFS for the four agents at once -- one 12-bit field per cell (per
//      agent i, bits [3i, 3i+3) = visited | root rank << 1), double-buffered
//      in shared memory; every round reads the round-start fields of the
//      cell's four parents in the order DOWN, UP, RIGHT, LEFT, first writer
//      wins; sources expand though they are not walkable, dead agents'
//      sources are pruned; rounds run until __syncthreads_or says no field
//      changed (at most NUM_CELLS rounds);
//   3. flee target -- the first cell in row-major order of each agent's
//      (reference-buggy) window, by warp ballots and a per-warp table;
//   4. the decision cascade, SortDirections walk (8 applications), enemy
//      pick and ring push run on threads 0-3, one agent each, reading the
//      maps through indexed shared-memory loads.
// The FSM state (ring codes, ring count, moveQueue slots per agent) lives in
// shared memory for the whole chunk and is touched only by its agent's
// thread.
//
// What bounds it on the card: barriers, not bytes.  An act reads and writes
// no device memory beyond the 10 x 4 FSM words of a board per chunk; its
// time is the BFS rounds (one __syncthreads_or each, ~20-50 per act, the
// longest walkable path on the board) plus five other barriers and the
// serial cascade on four threads.  One CTA per board keeps every round's
// exchange in shared memory and lets each board stop at its own convergence
// instead of the slowest of a 128-board block (the TPU kernel's rule); the
// TPU's throughput devices (2 boards per word, unrolled prefix rounds) are
// not carried over.
#pragma once

#include <cstdint>

#include "step_block.cuh"

namespace pomcpp {

constexpr int RP_STALE = 14;          // ring code of (0, 0)
constexpr int NO_CELL = NT;           // above every cell index
constexpr int DANGER_NONE = 1 << 30;
constexpr int VIS3 = 0x249;           // bit 3i: visited by agent i
constexpr int M_IDLE = 0, M_UP = 1, M_DOWN = 2, M_LEFT = 3, M_RIGHT = 4;

struct FsmView {
  int32_t* f[10];  // ring slots x4, ring head, ring count, moveQueue slots x4: [B, 4]
};

struct FsmShared {
  int dmap[NT];             // danger map, 0 where no bomb covers the cell
  int board[NT];            // board codes (pad cells: C_RIGID)
  int field[2][NT];         // BFS fields, double-buffered
  int first[NT / 32][NA];   // per warp and agent: first flee cell, or NO_CELL
  int mv[NA];               // the FSM's moves
  int rp[NA][4];            // ring codes per agent, logical order (slot 0 oldest)
  int rpc[NA];              // ring count
  int mq[NA][4];            // moveQueue slots
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

__device__ __forceinline__ void fsm_load(const FsmView& in, int b, int c, FsmShared& fs) {
  if (c < NA) {
    const int o = b * NA + c;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fs.rp[c][j] = in.f[j][o];
      fs.mq[c][j] = in.f[6 + j][o];
    }
    fs.rpc[c] = in.f[5][o];  // the head (f[4]) is 0 in this layout
  }
}

__device__ __forceinline__ void fsm_store(const FsmView& out, int b, int c, const FsmShared& fs) {
  if (c < NA) {
    const int o = b * NA + c;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out.f[j][o] = fs.rp[c][j];
      out.f[6 + j][o] = fs.mq[c][j];
    }
    out.f[4][o] = 0;
    out.f[5][o] = fs.rpc[c];
  }
}

// A board's reset: ring slots stale, count and moveQueue slots 0.
__device__ __forceinline__ void fsm_reset(int c, FsmShared& fs) {
  if (c < NA) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fs.rp[c][j] = RP_STALE;
      fs.mq[c][j] = 0;
    }
    fs.rpc[c] = 0;
  }
}

// The decision of agent i (run by thread i): reads the maps in `fs`, updates
// the agent's FSM state there and returns its move.
__device__ int agent_decide(int i, const Agents& A, int rnd, const int* F, FsmShared& fs) {
  const int x = pick4(A.x, i), y = pick4(A.y, i), me = x + BS * y, sh3 = 3 * i;
  const bool in_danger = fs.dmap[me] > 0;

  // Path A: flee toward the first safe window cell.
  const int fc = min(min(fs.first[0][i], fs.first[1][i]), min(fs.first[2][i], fs.first[3][i]));
  int m_safe = M_IDLE;
  if (fc != NO_CELL) {
    const int fv = (F[fc] >> sh3) & 7;
    if (fv & 1) m_safe = rank_move(fv >> 1);
  }
  // Enemy target: first live agent (id order) within manhattan 7 not on my cell.
  int ecell = -1;
  bool adj1 = false, adj7 = false;
#pragma unroll
  for (int j = NA - 1; j >= 0; --j) {
    const int mh = abs(A.x[j] - x) + abs(A.y[j] - y);
    if (!A.dead[j] && mh > 0 && mh <= 7) ecell = A.x[j] + BS * A.y[j];
    if (j != i && !A.dead[j]) {
      adj1 |= mh <= 1;
      adj7 |= mh <= 7;
    }
  }
  int m_enemy = M_IDLE;
  if (ecell >= 0) {
    const int ev = (F[ecell] >> sh3) & 7;
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
  bool rp_loop = true;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (j < rpc / 2) rp_loop &= fs.rp[i][j] == fs.rp[i][j + 2];
  const bool can_bomb = pick4(A.bc, i) < pick4(A.mb, i);
  const bool calm = !in_danger;
  const bool b1 = calm && can_bomb && adj1;
  const bool b2 = calm && can_bomb && !b1 && adj7 && rp_loop;
  const bool b3 = calm && can_bomb && !b1 && !b2 && adj7 && b3_ok;
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

// One act.  Every thread calls it with the same `rnd` (each agent's rand);
// on return every thread holds the four FSM moves in `mv`.
__device__ void fsm_act(const Cell& s, const Agents& A, const int rnd[NA], FsmShared& fs,
                        int mv[NA]) {
  const int c = threadIdx.x;
  const bool valid = c < NC;

  // ---- 1. Danger map ---------------------------------------------------------
  fs.field[0][c] = valid ? s.btimer : 0;
  fs.field[1][c] = valid ? s.bstr : 0;
  fs.board[c] = valid ? s.board : C_RIGID;
  __syncthreads();
  int danger = 0;
  if (valid) {
    const int x = c % BS, y = c / BS;
    int best = DANGER_NONE;
    for (int k = 0; k < BS; ++k) {
      const int o = k + BS * y;  // same row
      const int t = fs.field[0][o];
      if (t > 0 && (o == c || fs.field[1][o] >= abs(k - x))) best = min(best, t);
      const int o2 = x + BS * k;  // same column
      const int t2 = fs.field[0][o2];
      if (o2 != c && t2 > 0 && fs.field[1][o2] >= abs(k - y)) best = min(best, t2);
    }
    danger = best == DANGER_NONE ? 0 : best;
  }
  __syncthreads();

  // ---- 2. Four-agent BFS ------------------------------------------------------
  int ac[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) ac[i] = A.x[i] + BS * A.y[i];
  {
    int src = 0;
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if (!A.dead[i] && ac[i] == c) src |= 1 << (3 * i);
    fs.dmap[c] = danger;
    fs.field[0][c] = src;
  }
  __syncthreads();
  // Round-invariant parts: each direction's parent cell (the cell a move in
  // that direction leaves to arrive here), its walkable mask and the source
  // fields it seeds with this direction's rank.
  const int prio[4] = {M_DOWN, M_UP, M_RIGHT, M_LEFT};
  int par[4], wmask[4], seed[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = valid ? push_source(c, prio[r]) : -1;
    par[r] = p;
    wmask[r] = 0;
    seed[r] = 0;
    if (p >= 0) {
      wmask[r] = is_walkable(fs.board[p]) ? 0xFFF : 0;
#pragma unroll
      for (int i = 0; i < NA; ++i)
        if (!A.dead[i] && ac[i] == p) seed[r] |= (1 | (r << 1)) << (3 * i);
    }
  }
  const int ent = valid && (is_walkable(s.board) || is_agent(s.board)) ? VIS3 : 0;
  int buf = 0;
  for (int round = 0; round < NC; ++round) {
    const int* rd = fs.field[buf];
    const int start = rd[c];
    int cur = start;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (par[r] < 0) continue;
      const int cand = (rd[par[r]] & wmask[r]) | seed[r];
      const int nw = cand & ~cur & ent;  // visited bits of first visits
      cur |= cand & ((nw << 3) - nw);    // their whole 3-bit fields
    }
    buf ^= 1;
    fs.field[buf][c] = cur;
    if (!__syncthreads_or(cur != start)) break;
  }
  const int* F = fs.field[buf];

  // ---- 3. Flee target: first masked cell per agent (row-major) --------------
  unsigned m4 = 0;
  if (valid) {
    const int lx = c % BS, ly = c / BS, f = F[c];
    const bool safe1 = safe_for(danger, 2);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      // The reference's window (strategy.cpp:126-128): y in [oy-rad, rad),
      // x in [ox-rad, rad), manhattan <= rad; reached and not the source.
      const int rad = fs.dmap[ac[i]];
      const int manh = abs(lx - A.x[i]) + abs(ly - A.y[i]);
      if (ly < rad && lx < rad && manh <= rad && ((f >> (3 * i)) & 1) && c != ac[i] && safe1)
        m4 |= 1u << i;
    }
  }
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const unsigned bal = __ballot_sync(0xffffffffu, (m4 >> i) & 1u);
    if ((c & 31) == 0) fs.first[c >> 5][i] = bal ? (c & ~31) + __ffs(bal) - 1 : NO_CELL;
  }
  __syncthreads();

  // ---- 4. Decisions, one agent per thread -------------------------------------
  if (c < NA) fs.mv[c] = agent_decide(c, A, pick4(rnd, c), F, fs);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NA; ++i) mv[i] = fs.mv[i];
}

}  // namespace pomcpp
