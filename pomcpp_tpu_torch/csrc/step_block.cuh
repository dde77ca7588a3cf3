// One full Pommerman step for one board, as device code shared by the two
// kernels in fused_step.cu.
//
// Replaces `_step_block` (pomcpp_tpu/engine/pallas_step.py:247) and the
// helpers it inlines (`_push`/`_pull`/`_dest_val`/`_dest_oob` :82-166,
// `_ray_reach` :189).  The semantic spec is the plain PyTorch version,
// pomcpp_tpu_torch/engine/cellular.py `cellular_step(..., max_chain_rounds=4)`;
// the code below follows it phase for phase and must agree with it bit for
// bit.
//
// Layout: one board per CTA of 128 threads, thread c owns cell c (cells
// 121..127 are padding: they hold zeros, take part in every barrier and are
// never read as a neighbour).  Each thread keeps its cell's seven plane
// values in registers.  The four agents' state is replicated in every
// thread's registers and every thread runs the same per-agent arithmetic,
// so agent-level branches are uniform across the CTA.  Cross-cell reads go
// through small shared-memory exchange buffers between barriers; block-wide
// "any" is __syncthreads_or, block sums are warp reductions.  Because a CTA
// holds exactly one board, every data-dependent gate of the TPU kernel (its
// block-wide jnp.any + lax.cond) is a per-board branch here, and the loop
// bounds are the spec's: revert cascade <= AGENT_COUNT + 2 links, explosion
// chain <= MAX_CHAIN_ROUNDS rounds, rays <= BOARD_SIZE - 1 cells.
//
// What bounds it on the card: neither bytes nor arithmetic.  A step moves
// about 7.5 KB of state per board (in the chunk kernel only once per chunk)
// and does a few thousand integer operations per board; the time goes to
// the ~60-100 barriers per step and to the redundant per-agent scalar code.
// Cell-index arithmetic only ever divides non-negative on-board indices.
#pragma once

#include <cstdint>

namespace pomcpp {

constexpr int BS = 11;             // BOARD_SIZE
constexpr int NC = BS * BS;        // NUM_CELLS
constexpr int NT = 128;            // threads per board (cells padded to 128)
constexpr int NA = 4;              // AGENT_COUNT

constexpr int C_PASSAGE = 0, C_RIGID = 1, C_WOOD = 2, C_BOMB = 3, C_FLAME = 4;
constexpr int C_EXTRABOMB = 6, C_INCRRANGE = 7, C_KICK = 8, C_AGENT0 = 10;
constexpr int BOMB_LIFETIME = 10, FLAME_LIFETIME = 4, M_BOMB = 5;
constexpr int MAX_CHAIN_ROUNDS = 4;
constexpr int NEG = -1000;

// One thread's cell: the seven planes of CellState.
struct Cell {
  int board, hidden, ftimer, btimer, bstr, bdir, bown;
};

// The four agents, replicated in every thread.
struct Agents {
  int x[NA], y[NA], bc[NA], mb[NA], st[NA], kick[NA], dead[NA];
};

struct Shared {
  int a[NT], b[NT], c[NT], d[NT], e[NT];
  unsigned red[NT / 32];
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

// The cell whose direction-d move arrives at c (the source of a push).
__device__ __forceinline__ int push_source(int c, int d) {
  const int opp[5] = {0, 2, 1, 4, 3};
  return neighbor(c, opp[d]);
}

// Select a[k] for k in [0, 4) without dynamic register indexing.
__device__ __forceinline__ int pick4(const int a[NA], int k) {
  return k == 0 ? a[0] : k == 1 ? a[1] : k == 2 ? a[2] : a[3];
}

__device__ __forceinline__ unsigned block_sum(unsigned v, Shared& sh) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) sh.red[threadIdx.x >> 5] = v;
  __syncthreads();
  const unsigned r = sh.red[0] + sh.red[1] + sh.red[2] + sh.red[3];
  __syncthreads();
  return r;
}

__device__ __forceinline__ int block_or(int v, Shared& sh) {
  const unsigned w = __reduce_or_sync(0xffffffffu, (unsigned)v);
  if ((threadIdx.x & 31) == 0) sh.red[threadIdx.x >> 5] = w;
  __syncthreads();
  const int r = (int)(sh.red[0] | sh.red[1] | sh.red[2] | sh.red[3]);
  __syncthreads();
  return r;
}

// _revert_chain (cellular.py): bounce triggered agents back to their
// origins, cascading into displaced occupants and into agents standing on a
// moving bomb stopped by the bounce.  `dir0` is this cell's phase-start
// bomb direction, `mdx/mdy` the agents' move displacements.
__device__ void revert_chain(Cell& s, Agents& A, const int trigger[NA],
                             const int mdx[NA], const int mdy[NA], int dir0,
                             Shared& sh, int c, bool valid) {
  const bool has_bomb = valid && s.btimer > 0;
  int cur[NA], done[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) { cur[i] = trigger[i]; done[i] = 0; }
  for (int link = 0; link < NA + 2; ++link) {
    if (!(cur[0] | cur[1] | cur[2] | cur[3])) break;  // uniform
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
    bool moving_bomb = false;
    if (valid) {
      const int dcell = neighbor(c, dir0);
      bool dest_wanted = false;
#pragma unroll
      for (int i = 0; i < NA; ++i) dest_wanted |= (act[i] && occ[i] < 0 && dcell == oc[i]);
      moving_bomb = has_bomb && dest_wanted && s.bdir != 0;
      if (moving_bomb) {
        s.bdir = 0;
        if (!is_agent(s.board)) s.board = C_BOMB;
      }
#pragma unroll
      for (int i = 0; i < NA; ++i)
        if (act[i] && c == oc[i]) s.board = C_AGENT0 + i;
    }
    sh.a[c] = moving_bomb;
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if (act[i]) { A.x[i] = ox[i]; A.y[i] = oy[i]; }
    __syncthreads();
    int nxt[NA];
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      nxt[j] = 0;
#pragma unroll
      for (int i = 0; i < NA; ++i) nxt[j] |= (act[i] && occ[i] == j);
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int on_stopped = sh.a[A.x[i] + BS * A.y[i]] && !A.dead[i];
      cur[i] = (nxt[i] || on_stopped) && !done[i];
    }
    __syncthreads();
  }
}

// _restore_bomb_items: show C_BOMB on bomb cells no live agent stands on.
__device__ __forceinline__ void restore_bomb_items(Cell& s, const Agents& A, int c, bool valid) {
  if (!valid) return;
  bool occupied = false;
#pragma unroll
  for (int i = 0; i < NA; ++i) occupied |= (!A.dead[i] && A.x[i] + BS * A.y[i] == c);
  if (s.btimer > 0 && !occupied && is_agent(s.board)) s.board = C_BOMB;
}

// Board item at this cell's bomb destination (dir 0: the cell itself;
// off-board: RIGID).  Reads the board from sh.a.
__device__ __forceinline__ int dest_item(const Shared& sh, int c, int dir) {
  const int n = neighbor(c, dir);
  return n < 0 ? C_RIGID : sh.a[n];
}

// Every thread calls this with the same `moves`; c = threadIdx.x.
__device__ void step_board(Cell& s, Agents& A, const int moves[NA], Shared& sh) {
  const int c = threadIdx.x;
  const bool valid = c < NC;

  // ---- Phase 0: flames ----------------------------------------------------
  if (valid) {
    s.ftimer = s.ftimer > 1 ? s.ftimer - 1 : 0;
    if (s.ftimer == 0 && s.board == C_FLAME) {
      s.board = flag_item(s.hidden & 3);
      s.hidden = 0;
    }
  }

  // ---- Phase 1: agent movement -------------------------------------------
  sh.a[c] = s.board;
  sh.b[c] = s.btimer;
  __syncthreads();
  int m[NA], mdx[NA], mdy[NA], alive[NA], dmove[NA], dxs[NA], dys[NA];
  int org[NA], old_cell[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    m[i] = clamp_move(moves[i]);
    mdx[i] = move_dx(m[i]);
    mdy[i] = move_dy(m[i]);
    alive[i] = !A.dead[i];
    dmove[i] = m[i] >= 1 && m[i] <= 4;
    dxs[i] = A.x[i] + mdx[i];
    dys[i] = A.y[i] + mdy[i];
    org[i] = A.x[i] + BS * A.y[i];
    old_cell[i] = org[i];
  }
  // FixSwitchMove (step_utility.cpp:154-170), same pair order.
#pragma unroll
  for (int i = 0; i < NA; ++i) {
#pragma unroll
    for (int j = i; j < NA; ++j) {
      const bool swap = dxs[i] == A.x[j] && dys[i] == A.y[j] &&
                        dxs[j] == A.x[i] && dys[j] == A.y[i];
      if (swap) {
        dxs[i] = A.x[i]; dys[i] = A.y[i];
        dxs[j] = A.x[j]; dys[j] = A.y[j];
      }
    }
  }
  int directional[NA], inb[NA], dest[NA], ditem[NA], bomb_dest[NA], org_bomb[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    directional[i] = dmove[i] && (dxs[i] != A.x[i] || dys[i] != A.y[i]);
    inb[i] = dxs[i] >= 0 && dys[i] >= 0 && dxs[i] < BS && dys[i] < BS;
    dest[i] = inb[i] ? dxs[i] + BS * dys[i] : -1;
    ditem[i] = inb[i] ? sh.a[dest[i]] : 0;
    bomb_dest[i] = inb[i] && sh.b[dest[i]] > 0;
    org_bomb[i] = sh.b[org[i]] > 0;
  }
  __syncthreads();
  // Ouroboros: nobody is a movement root (step_utility.cpp:172-205).
  bool any_root = false;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    bool targ = false;
#pragma unroll
    for (int j = 0; j < NA; ++j)
      targ |= (j != i && alive[j] && dxs[i] == A.x[j] && dys[i] == A.y[j]);
    any_root |= (A.dead[i] || !targ);
  }
  const bool ouroboros = !any_root;
  int victim[NA], base[NA], enterable[NA], dagent[NA], daid[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i)
    victim[i] = alive[i] && directional[i] && inb[i] && ditem[i] == C_FLAME;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    bool coll = false;
#pragma unroll
    for (int j = 0; j < NA; ++j)
      coll |= (j != i && alive[j] && !victim[j] && dxs[i] == dxs[j] && dys[i] == dys[j]);
    base[i] = alive[i] && directional[i] && inb[i] && !victim[i] && !coll;
    enterable[i] = ditem[i] == C_PASSAGE || is_powerup(ditem[i]) || ditem[i] == C_BOMB;
    dagent[i] = is_agent(ditem[i]);
    const int aid = ditem[i] - C_AGENT0;
    daid[i] = aid < 0 ? 0 : aid > 3 ? 3 : aid;
  }
  // Chain fixed point (step.cpp:70-82), Jacobi iteration as in the spec.
  int mv[NA] = {0, 0, 0, 0};
  for (int it = 0; it < NA; ++it) {
    int nmv[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const bool vacating = dagent[i] && (pick4(mv, daid[i]) || pick4(victim, daid[i]));
      nmv[i] = base[i] && (enterable[i] || vacating || (ouroboros && dagent[i]));
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) mv[i] = nmv[i];
  }
  int kick[NA], plant[NA], st_old[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    kick[i] = mv[i] && A.kick[i] && bomb_dest[i];
    st_old[i] = A.st[i];
    plant[i] = alive[i] && moves[i] == M_BOMB && A.bc[i] < A.mb[i] && !org_bomb[i];
  }
  if (valid) {
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if (kick[i] && c == dest[i]) s.bdir = m[i];
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if ((mv[i] || victim[i]) && c == org[i]) s.board = org_bomb[i] ? C_BOMB : C_PASSAGE;
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if (mv[i] && c == dest[i]) s.board = C_AGENT0 + i;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      if (plant[i] && c == org[i]) {
        s.btimer = BOMB_LIFETIME + 1;
        s.bstr = st_old[i];
        s.bown = i;
        s.bdir = 0;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const bool take = mv[i] && is_powerup(ditem[i]);
    A.mb[i] += take && ditem[i] == C_EXTRABOMB;
    A.st[i] += take && ditem[i] == C_INCRRANGE;
    A.kick[i] = A.kick[i] || (take && ditem[i] == C_KICK);
    A.dead[i] = A.dead[i] || victim[i];
    if (mv[i]) { A.x[i] = dxs[i]; A.y[i] = dys[i]; }
    A.bc[i] += plant[i];
  }

  // ---- Phase 2: bomb kinematics ------------------------------------------
  const int dir0 = s.bdir;  // stale directions for reversion
  // Block pass: two rounds.
  for (int round = 0; round < 2; ++round) {
    sh.a[c] = s.board;
    __syncthreads();
    bool blocked = false;
    if (valid && s.btimer > 0) {
      const int di = dest_item(sh, c, s.bdir);
      blocked = neighbor(c, s.bdir) < 0 || static_block(di) || is_agent(di);
    }
    sh.b[c] = blocked;
    __syncthreads();
    int trigger[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int cell = A.x[i] + BS * A.y[i];
      trigger[i] = !A.dead[i] && sh.b[cell] && dmove[i] && cell != old_cell[i];
    }
    __syncthreads();
    if (blocked) s.bdir = 0;
    revert_chain(s, A, trigger, mdx, mdy, dir0, sh, c, valid);
    restore_bomb_items(s, A, c, valid);
  }

  // Move pass.
  const bool has_bomb = valid && s.btimer > 0;
  const bool moving = has_bomb && s.bdir != 0;
  sh.a[c] = s.board;
  sh.b[c] = moving ? s.bdir : 0;
  __syncthreads();
  bool can_enter = false;
  int arrivals = 0;
  if (valid) {
    can_enter = neighbor(c, s.bdir) >= 0 && !static_block(dest_item(sh, c, s.bdir));
    arrivals = has_bomb && !moving;
#pragma unroll
    for (int d = 1; d <= 4; ++d) {
      const int src = push_source(c, d);
      arrivals += (src >= 0 && sh.b[src] == d);
    }
  }
  sh.c[c] = arrivals;
  __syncthreads();
  bool collide = false;
  if (valid) {
    int dest_count = arrivals;
    if (moving) {
      const int n = neighbor(c, s.bdir);
      dest_count = n < 0 ? 0 : sh.c[n];
    }
    collide = has_bomb && dest_count >= 2;
  }
  const bool stopped_kick = collide && moving;
  if (collide || (moving && !can_enter)) s.bdir = 0;
  sh.d[c] = stopped_kick;
  __syncthreads();
  {
    int trigger[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i)
      trigger[i] = !A.dead[i] && sh.d[A.x[i] + BS * A.y[i]] && dmove[i];
    __syncthreads();
    revert_chain(s, A, trigger, mdx, mdy, dir0, sh, c, valid);
    restore_bomb_items(s, A, c, valid);
  }
  // Surviving movers advance one cell.
  const bool do_move = valid && s.btimer > 0 && s.bdir != 0 && can_enter && !collide;
  sh.a[c] = do_move ? s.bdir : 0;
  sh.b[c] = s.btimer;
  sh.c[c] = s.bstr;
  sh.d[c] = s.bdir;
  sh.e[c] = s.bown;
  __syncthreads();
  bool slide = false;
  if (valid) {
    int inc_t = 0, inc_s = 0, inc_d = 0, inc_o = 0;
    bool arrived = false;
#pragma unroll
    for (int d = 1; d <= 4; ++d) {
      const int src = push_source(c, d);
      if (src >= 0 && sh.a[src] == d) {
        arrived = true;
        inc_t = max(inc_t, sh.b[src]);
        inc_s = max(inc_s, sh.c[src]);
        inc_d = max(inc_d, sh.d[src]);
        inc_o = max(inc_o, sh.e[src]);
      }
    }
    s.btimer = max(do_move ? 0 : s.btimer, inc_t);
    s.bstr = max(do_move ? 0 : s.bstr, inc_s);
    s.bdir = max(do_move ? 0 : s.bdir, inc_d);
    s.bown = max(do_move ? 0 : s.bown, inc_o);
    if (do_move && s.board == C_BOMB && s.btimer == 0) s.board = C_PASSAGE;
    slide = arrived && s.board == C_FLAME;
    if (arrived && (s.board == C_PASSAGE || is_powerup(s.board))) s.board = C_BOMB;
  }
  __syncthreads();

  // ---- Phase 3: explosions (at most MAX_CHAIN_ROUNDS rounds) --------------
  const bool had_bomb = valid && s.btimer > 0;
  if (had_bomb && !slide) s.btimer -= 1;
  bool explode = (had_bomb && s.btimer == 0) || slide;
  bool live = slide;
  for (int round = 0; round < MAX_CHAIN_ROUNDS; ++round) {
    if (!__syncthreads_or(explode)) break;
    const int s_cell = live ? pick4(A.st, s.bown) : s.bstr;
    sh.a[c] = explode ? s_cell : NEG;
    sh.b[c] = s.board;
    __syncthreads();
    bool reach = false;
    if (valid) {
      const int opp[5] = {0, 2, 1, 4, 3};
#pragma unroll
      for (int d = 1; d <= 4; ++d) {
        // Walk back along the ray that travels in direction d towards c.
        int o = c;
        for (int k = 1; k < BS && !reach; ++k) {
          o = neighbor(o, opp[d]);
          if (o < 0) break;
          if (sh.a[o] - k >= 0) reach = true;
          const int item = sh.b[o];
          if (item == C_RIGID || item == C_WOOD) break;
        }
      }
    }
    const bool burn = valid && (explode || (reach && s.board != C_RIGID));
    const int kill = (burn && is_agent(s.board)) ? 1 << (s.board - C_AGENT0) : 0;
    const unsigned refund = explode ? 1u << (8 * s.bown) : 0u;
    const int victims = block_or(kill, sh);
    const unsigned refunds = block_sum(refund, sh);
    const bool next_explode = burn && s.btimer > 0 && !explode;
    if (burn) {
      if (s.board != C_WOOD) s.hidden = 0;
      s.board = C_FLAME;
      s.ftimer = FLAME_LIFETIME;
    }
    if (explode) { s.btimer = 0; s.bstr = 0; s.bdir = 0; s.bown = 0; }
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      A.bc[i] -= (int)((refunds >> (8 * i)) & 255u);
      A.dead[i] = A.dead[i] || ((victims >> i) & 1);
    }
    explode = live = next_explode;
  }
}

}  // namespace pomcpp
