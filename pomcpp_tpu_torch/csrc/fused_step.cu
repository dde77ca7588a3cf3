// The engine kernels of the port and their plain C launchers (bound to
// PyTorch with ctypes by pomcpp_tpu_torch/_ext.py).
//
// fused_step_kernel<false> replaces `_kernel` / `pallas_step`
// (pomcpp_tpu/engine/pallas_step.py:1261, :1283): one step for B boards.
// fused_step_kernel<true> is the fused env step of the PPO rollout
// (pomcpp_tpu/env/environment.py:168-222): the same step and the env
// epilogue (env_warp.cuh: done latch, terminal detection, the Philox reset
// of finished boards) in one launch, on the EnvState in its own dtypes.
// env_merge_kernel is that epilogue alone, after the mixed-control step's
// one-step chunk (see its note below).  fsm_act_kernel replaces one
// `fsm_block` act (pomcpp_tpu/engine/pallas_fsm.py:357) for B boards: the
// chunk kernel's SimpleAgent act (fsm_warp.cuh) without the loop.
//
// rollout_chunk_kernel replaces `_chunk_kernel` / `pallas_rollout_chunk`
// (:840, :1069): a board's state is loaded once, `steps` steps run with
// in-kernel Philox draws and the pipelined auto-reset, and the state is
// written back once -- the counterpart of the TPU kernel keeping its block in
// VMEM for a chunk.  rollout_chunk_kernel<false> serves the harmless and
// random policies; rollout_chunk_kernel<true> is policy="simple": the draws
// are the SimpleAgent's rands, the FSM picks the moves (with the
// `inject_slots` override of mixed control), and the ten FSM arrays ride
// along in shared memory.
//
// Every kernel here holds ONE BOARD PER WARP (step_warp.cuh, fsm_warp.cuh,
// env_warp.cuh): lane l keeps cells 4l..4l+3 of every plane in registers,
// neighbours are read by shuffle, boolean planes by ballot, sums by
// __reduce_*_sync, and nothing in them synchronises a CTA; a CTA is
// CHUNK_WARPS independent boards and the grid is ceil(batch / CHUNK_WARPS).
// The layout they replaced, one board per 128-thread CTA and one cell per
// thread, spent its time at 60-100 CTA barriers a step (one more per BFS
// round) with the per-agent code run by all four warps; see the notes at the
// top of the headers for what each phase does instead.
//
// Bound on the card: a chunk moves 2 x 3,500 bytes per board through HBM
// (plus the optional test-hook arrays), so at 16384 boards the byte bound
// is tens of microseconds, far below the time the step body takes.  The
// kernel is bound by the integer pipe (compares, selects and
// logic, 64 lanes a cycle per SM) and, for the simple policy, by the chain
// of dependent BFS exchanges.  rollout_chunk_clocked_kernel is the same body
// with the phase clocks (step_warp.cuh): while tracing is on, the port
// launches it for one chunk call in 8 and it sums where that call's cycles
// go into a row of its own (pomcpp_tpu_torch/trace.py); the plain instance
// compiles as if the clocks did not exist.  A single step
// (fused_step_kernel) moves the same bytes for one step of work, so it sits
// nearer its byte bound.
//
// The PRNG is Philox4x32-10 (Salmon et al., SC'11), counter
// (board, chunk-local step, stream, word), key (seed lo, seed hi); the
// plain PyTorch version in engine/fused_step.py computes the same words.
// The env resets use streams 3-5 of the same generator (env_warp.cuh).
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "env_warp.cuh"
#include "fsm_warp.cuh"
#include "step_warp.cuh"

// A kernel launch.  The tests' host build (csrc/host_emu/cuda_runtime.h)
// defines it as a loop over the grid's warps on the CPU.
#ifndef POMCPP_LAUNCH
#define POMCPP_LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<(grid), (block), 0, (cudaStream_t)(stream)>>>(__VA_ARGS__)
#endif

namespace pomcpp {

// Boards (warps) per CTA of the warp-layout kernels and the CTAs per SM
// their registers are capped for (128 registers a thread, 16 boards per SM);
// the launchers' grid is ceil(batch / CHUNK_WARPS).
constexpr int CHUNK_WARPS = 4;
constexpr int CHUNK_MIN_CTAS = 4;
constexpr int chunk_grid(int batch) { return (batch + CHUNK_WARPS - 1) / CHUNK_WARPS; }

struct StateView {
  int32_t* f[14];  // board, hidden, ftimer, btimer, bstr, bdir, bown: [B, 121]
                   // ax, ay, abc, amb, ast, akick, adead: [B, 4]
};

constexpr uint32_t STREAM_MOVES = 0, STREAM_CELLS = 1, STREAM_FLAGS = 2;

// v % n; the policies' move counts divide by a constant.
__device__ __forceinline__ int draw_mod(int v, int n) {
  return n == 5 ? v % 5 : n == 6 ? v % 6 : v % n;
}

// Board finished: at most one agent alive.
__device__ __forceinline__ bool finished(const Agents& A) {
  return A.dead[0] + A.dead[1] + A.dead[2] + A.dead[3] >= 3;
}

// One step for board k * CHUNK_WARPS + w in warp w of CTA k, on the chunk
// kernel's body without its loop.  kEnv: the fused env step -- a board that
// was done before the step is reset instead of stepped (a warp-uniform
// branch), the others step, advance their timestep and latch their result
// (env_warp.cuh).  Without kEnv the EnvState views are unused and timestep
// is kept, as in `pallas_step`; alive_count is recounted either way.
template <bool kEnv>
__global__ void __launch_bounds__(CHUNK_WARPS * 32, CHUNK_MIN_CTAS) fused_step_kernel(
    GameView in, GameView out, EnvView ein, EnvView eout, GameView fresh, EnvConfig cfg,
    const int32_t* __restrict__ moves, int batch) {
  __shared__ wl::WarpShared ws_all[CHUNK_WARPS];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * CHUNK_WARPS + warp;
  if (b >= batch) return;  // the whole warp, and nothing below waits for it
  const wl::Geo g = wl::make_geo();
  wl::Cells s;
  Agents A;
  if constexpr (kEnv) {
    if (__any_sync(wl::FULL, ein.done[b] != 0)) {  // the same byte in every lane
      wl::env_reset_board(b, g, fresh, ein, out, eout, cfg.randomize_positions != 0, s, A);
      return;
    }
  }
  wl::load_game(in, b, g, s, A);
  int mv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) mv[i] = moves[b * NA + i];
  wl::NoClock pc;
  wl::step_board(s, A, mv, ws_all[warp], g, pc);
  const int alive = wl::alive_of(A), timestep = in.timestep[b] + (kEnv ? 1 : 0);
  wl::store_game(out, b, g, s, A, alive, timestep);
  if constexpr (kEnv) wl::env_latch(b, g.lane, A.dead, alive, timestep, ein, eout, cfg);
}

// The env epilogue alone, on a batch that another launch stepped (the
// mixed-control env step's one-step chunk; its timestep is already
// advanced), written IN PLACE into that batch: a done board gets its fresh
// game, the others keep their stepped game untouched and latch.  Replaces
// `_merge_done_and_reset` after the one-step simple chunk of the JAX
// package's mixed-control step (pomcpp_tpu/env/environment.py:197-222,
// :115-150).  Bound by bytes, and only by those the data needs: a running
// board reads its EnvState, four dead bytes, alive_count and timestep and
// writes its EnvState (72 bytes); a done board (rare; a warp-uniform branch)
// reads its key and writes a whole game and EnvState (3,539 bytes) in the
// lane layout of the Philox reset.  The dead flags the latch needs come
// from one ballot of lanes 0-3.  Measured on an H100 80GB HBM3 at 700 W,
// 16384 boards of which 616 done: 0.0094 ms, where a copy of every board's
// game as rows took 0.0459 ms and the lane layout's loads and stores (a
// 16-byte stride, 16 sectors for 128 useful bytes) 0.0955 ms (PERF.md row
// 2e).
__global__ void __launch_bounds__(CHUNK_WARPS * 32) env_merge_kernel(
    GameView game, EnvView ein, EnvView eout, GameView fresh, EnvConfig cfg, int batch) {
  const int b = blockIdx.x * CHUNK_WARPS + (threadIdx.x >> 5);
  if (b >= batch) return;
  const wl::Geo g = wl::make_geo();
  if (__any_sync(wl::FULL, ein.done[b] != 0)) {
    wl::Cells s;
    Agents A;
    wl::env_reset_board(b, g, fresh, ein, game, eout, cfg.randomize_positions != 0, s, A);
    return;
  }
  const unsigned dead_bits =
      __ballot_sync(wl::FULL, g.lane < NA && game.flag[1][b * NA + g.lane] != 0);
  const int dead[NA] = {(int)(dead_bits & 1u), (int)((dead_bits >> 1) & 1u),
                        (int)((dead_bits >> 2) & 1u), (int)((dead_bits >> 3) & 1u)};
  wl::env_latch(b, g.lane, dead, game.alive_count[b], game.timestep[b], ein, eout, cfg);
}

// Warp-layout loads and stores: lane l moves cells 4l..4l+3 of its warp's
// board; the agents' state is loaded into every lane and stored by lanes 0-3.
__device__ __forceinline__ void load_board(const StateView& in, int b, const wl::Geo& g,
                                           wl::Cells& s, Agents& A) {
#pragma unroll
  for (int j = 0; j < wl::CPL; ++j) {
    const int c = g.c0 + j, o = b * NC + c;
    const bool v = c < NC;
    s.board[j] = v ? in.f[0][o] : 0;
    s.hidden[j] = v ? in.f[1][o] : 0;
    s.ftimer[j] = v ? in.f[2][o] : 0;
    s.btimer[j] = v ? in.f[3][o] : 0;
    s.bstr[j] = v ? in.f[4][o] : 0;
    s.bdir[j] = v ? in.f[5][o] : 0;
    s.bown[j] = v ? in.f[6][o] : 0;
  }
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int o = b * NA + i;
    A.x[i] = in.f[7][o];
    A.y[i] = in.f[8][o];
    A.bc[i] = in.f[9][o];
    A.mb[i] = in.f[10][o];
    A.st[i] = in.f[11][o];
    A.kick[i] = in.f[12][o];
    A.dead[i] = in.f[13][o];
  }
}

__device__ __forceinline__ void store_board(const StateView& out, int b, const wl::Geo& g,
                                            const wl::Cells& s, const Agents& A) {
#pragma unroll
  for (int j = 0; j < wl::CPL; ++j) {
    const int c = g.c0 + j, o = b * NC + c;
    if (c < NC) {
      out.f[0][o] = s.board[j];
      out.f[1][o] = s.hidden[j];
      out.f[2][o] = s.ftimer[j];
      out.f[3][o] = s.btimer[j];
      out.f[4][o] = s.bstr[j];
      out.f[5][o] = s.bdir[j];
      out.f[6][o] = s.bown[j];
    }
  }
  if (g.lane < NA) {
    const int i = g.lane, o = b * NA + i;
    out.f[7][o] = pick4(A.x, i);
    out.f[8][o] = pick4(A.y, i);
    out.f[9][o] = pick4(A.bc, i);
    out.f[10][o] = pick4(A.mb, i);
    out.f[11][o] = pick4(A.st, i);
    out.f[12][o] = pick4(A.kick, i);
    out.f[13][o] = pick4(A.dead, i);
  }
}

// The chunk kernels' body in the warp layout (step_warp.cuh, fsm_warp.cuh):
// warp w of CTA k owns board k * CHUNK_WARPS + w for the whole chunk, and no
// warp ever waits for another, so a warp past the end of the batch just
// returns.
//
// kSimple: `n_moves` is 5, the draws (or moves[t] unless prng_rand) are the
// FSM's rands, and lanes set in inject_mask take their move from moves[t].
// Clock: wl::NoClock, or wl::PhaseClock, whose sums go to `totals`.
template <bool kSimple, class Clock>
__device__ __forceinline__ void rollout_chunk_board(
    StateView in, StateView out, FsmView fin, FsmView fout, int batch, int steps, int n_moves,
    uint32_t k0, uint32_t k1, const int32_t* __restrict__ moves, int inject_mask, int prng_rand,
    const int32_t* __restrict__ reset_board, const int32_t* __restrict__ reset_hidden,
    int auto_reset, int32_t* __restrict__ rec_moves, int32_t* __restrict__ rec_done,
    unsigned long long* __restrict__ totals) {
  __shared__ wl::WarpShared ws_all[CHUNK_WARPS];
  __shared__ std::conditional_t<kSimple, wl::FsmSlice, char> fs_all[CHUNK_WARPS];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * CHUNK_WARPS + warp;
  if (b >= batch) return;  // the whole warp, and nothing below waits for it
  wl::WarpShared& ws = ws_all[warp];
  auto& fs = fs_all[warp];
  const wl::Geo g = wl::make_geo();
  Clock pc;
  pc.start();
  wl::Cells s;
  Agents A;
  load_board(in, b, g, s, A);
  if constexpr (kSimple) {
    wl::fsm_load(fin, b, g.lane, fs);
  }

  // This board's replacement terrain, drawn once per chunk (_fresh_boards):
  // one Philox call gives the words of a lane's four cells.  Packed 8 bits
  // a cell: board code (at most 13) | hidden power-up (at most 4) << 4.
  uint32_t fresh = 0;
  if (auto_reset) {
    uint4 cw = make_uint4(0u, 0u, 0u, 0u), fw = cw;
    if (reset_board == nullptr) {
      cw = philox4x32_10(make_uint4((uint32_t)b, 0u, STREAM_CELLS, (uint32_t)g.lane), k0, k1);
      fw = philox4x32_10(make_uint4((uint32_t)b, 0u, STREAM_FLAGS, (uint32_t)g.lane), k0, k1);
    }
#pragma unroll
    for (int j = 0; j < wl::CPL; ++j) {
      const int c = g.c0 + j;
      int fboard = 0, fhidden = 0;
      if (c < NC) {
        if (reset_board != nullptr) {
          fboard = reset_board[b * NC + c];
          fhidden = reset_hidden[b * NC + c];
        } else {
          const int tmp = draw30(word_of(cw, j)) % 7;
          const int flags = draw30(word_of(fw, j));
          fboard = tmp == 1 ? C_RIGID : tmp == 2 ? C_WOOD : C_PASSAGE;
          fhidden = (fboard == C_WOOD && (flags & 1) == 0) ? ((flags >> 1) % 4) + 1 : 0;
        }
        if (c == 0) fboard = C_AGENT0 + 0;
        if (c == BS - 1) fboard = C_AGENT0 + 1;
        if (c == NC - 1) fboard = C_AGENT0 + 2;
        if (c == NC - BS) fboard = C_AGENT0 + 3;
      }
      fresh |= (uint32_t)((fboard & 15) | ((fhidden & 15) << 4)) << (8 * j);
    }
  }
  auto merge_fresh = [&]() {
#pragma unroll
    for (int j = 0; j < wl::CPL; ++j) {
      s.board[j] = (int)((fresh >> (8 * j)) & 15u);
      s.hidden[j] = (int)((fresh >> (8 * j + 4)) & 15u);
      s.ftimer[j] = s.btimer[j] = s.bstr[j] = s.bdir[j] = s.bown[j] = 0;
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      A.x[i] = (i == 1 || i == 2) ? BS - 1 : 0;
      A.y[i] = (i == 2 || i == 3) ? BS - 1 : 0;
      A.bc[i] = 0;
      A.mb[i] = 1;
      A.st[i] = 1;
      A.kick[i] = 0;
      A.dead[i] = 0;
    }
  };

  // Pipelined reset: the mask merged at the head of step t was computed at
  // the head of step t-1 (the first one from the input state).
  bool done = auto_reset && finished(A);
  // The draws of 32 steps at a time: lane l holds the Philox words of step
  // (t & ~31) + l, and each step fetches its four with shuffles, so that the
  // warp does not compute one Philox call 32 times over.
  uint4 bank = make_uint4(0u, 0u, 0u, 0u);
  const bool drawn = moves == nullptr || (kSimple && prng_rand);
  for (int t = 0; t < steps; ++t) {
    int mv[NA];
    if (!drawn) {
#pragma unroll
      for (int i = 0; i < NA; ++i) mv[i] = moves[((size_t)t * batch + b) * NA + i];
    } else {
      if ((t & 31) == 0)
        bank = philox4x32_10(
            make_uint4((uint32_t)b, (uint32_t)(t + g.lane), STREAM_MOVES, 0u), k0, k1);
      const uint32_t w[NA] = {
          (uint32_t)__shfl_sync(wl::FULL, (int)bank.x, t & 31),
          (uint32_t)__shfl_sync(wl::FULL, (int)bank.y, t & 31),
          (uint32_t)__shfl_sync(wl::FULL, (int)bank.z, t & 31),
          (uint32_t)__shfl_sync(wl::FULL, (int)bank.w, t & 31)};
#pragma unroll
      for (int i = 0; i < NA; ++i) mv[i] = draw_mod(draw30(w[i]), n_moves);
    }
    bool done_next = done;
    if (auto_reset) {
      // `done` is the same in every lane; the vote says so to the compiler,
      // which otherwise turns the rare merge into 56 selects a step.
      if (__any_sync(wl::FULL, done)) {
        merge_fresh();
        if constexpr (kSimple) wl::fsm_reset(g.lane, fs);
      }
      done_next = finished(A);
    }
    pc.mark(wl::PH_DRAW);
    if constexpr (kSimple) {
      const int rnd[NA] = {mv[0], mv[1], mv[2], mv[3]};
      wl::fsm_act(s, A, rnd, fs, mv, g, pc);
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        if ((inject_mask >> i) & 1) mv[i] = moves[((size_t)t * batch + b) * NA + i];
        if (A.dead[i]) mv[i] = 0;
      }
    }
    wl::step_board(s, A, mv, ws, g, pc);
    if (rec_moves != nullptr && g.lane < NA) {
      rec_moves[((size_t)t * batch + b) * NA + g.lane] = pick4(mv, g.lane);
      if (g.lane == 0) rec_done[(size_t)t * batch + b] = finished(A);
    }
    done = done_next;
    pc.count(wl::N_STEPS);
    pc.mark(wl::PH_REST);
  }
  // Catch-up merge: boards that finished in the last two steps.
  if (auto_reset && finished(A)) {
    merge_fresh();
    if constexpr (kSimple) wl::fsm_reset(g.lane, fs);
  }
  store_board(out, b, g, s, A);
  if constexpr (kSimple) wl::fsm_store(fout, b, g.lane, fs);
  pc.flush(totals, g.lane);
}

// The chunk kernel: the body without clocks.
template <bool kSimple>
__global__ void __launch_bounds__(CHUNK_WARPS * 32, CHUNK_MIN_CTAS) rollout_chunk_kernel(
    StateView in, StateView out, FsmView fin, FsmView fout, int batch, int steps, int n_moves,
    uint32_t k0, uint32_t k1, const int32_t* __restrict__ moves, int inject_mask, int prng_rand,
    const int32_t* __restrict__ reset_board, const int32_t* __restrict__ reset_hidden,
    int auto_reset, int32_t* __restrict__ rec_moves, int32_t* __restrict__ rec_done) {
  rollout_chunk_board<kSimple, wl::NoClock>(in, out, fin, fout, batch, steps, n_moves, k0, k1,
                                            moves, inject_mask, prng_rand, reset_board,
                                            reset_hidden, auto_reset, rec_moves, rec_done,
                                            nullptr);
}

// The same chunk with the phase clocks, for a sampled call: the call's
// warps add their sums into its row `totals` (PHASE_SLOTS values, zeroed
// by the caller).  Its own name keeps it apart from rollout_chunk_kernel in
// a device trace.
template <bool kSimple>
__global__ void __launch_bounds__(CHUNK_WARPS * 32, CHUNK_MIN_CTAS) rollout_chunk_clocked_kernel(
    StateView in, StateView out, FsmView fin, FsmView fout, int batch, int steps, int n_moves,
    uint32_t k0, uint32_t k1, const int32_t* __restrict__ moves, int inject_mask, int prng_rand,
    const int32_t* __restrict__ reset_board, const int32_t* __restrict__ reset_hidden,
    int auto_reset, int32_t* __restrict__ rec_moves, int32_t* __restrict__ rec_done,
    unsigned long long* __restrict__ totals) {
  rollout_chunk_board<kSimple, wl::PhaseClock>(in, out, fin, fout, batch, steps, n_moves, k0,
                                               k1, moves, inject_mask, prng_rand, reset_board,
                                               reset_hidden, auto_reset, rec_moves, rec_done,
                                               totals);
}

// A chunk launch: the clocked instance when `totals` names a row.
template <bool kSimple>
int launch_chunk(StateView in, StateView out, FsmView fin, FsmView fout, int batch, int steps,
                 int n_moves, uint32_t k0, uint32_t k1, const int32_t* moves, int inject_mask,
                 int prng_rand, const int32_t* reset_board, const int32_t* reset_hidden,
                 int auto_reset, int32_t* rec_moves, int32_t* rec_done,
                 unsigned long long* totals, void* stream) {
  if (totals == nullptr) {
    POMCPP_LAUNCH(rollout_chunk_kernel<kSimple>, chunk_grid(batch), CHUNK_WARPS * 32, stream, in,
                  out, fin, fout, batch, steps, n_moves, k0, k1, moves, inject_mask, prng_rand,
                  reset_board, reset_hidden, auto_reset, rec_moves, rec_done);
  } else {
    POMCPP_LAUNCH(rollout_chunk_clocked_kernel<kSimple>, chunk_grid(batch), CHUNK_WARPS * 32,
                  stream, in, out, fin, fout, batch, steps, n_moves, k0, k1, moves, inject_mask,
                  prng_rand, reset_board, reset_hidden, auto_reset, rec_moves, rec_done, totals);
  }
  return (int)cudaGetLastError();
}

// One SimpleAgent act for board k * CHUNK_WARPS + w in warp w of CTA k: the
// simple chunk kernel's act (wl::fsm_act on the warp's own FSM slice)
// without its loop, on the CellState in its own dtypes.  Bound by latency
// (the BFS rounds' exchanges and the cascade on four lanes), not by its
// 3,836 bytes a board: see fsm_warp.cuh.
__global__ void __launch_bounds__(CHUNK_WARPS * 32, CHUNK_MIN_CTAS) fsm_act_kernel(
    GameView in, FsmView fin, FsmView fout, const int32_t* __restrict__ rands,
    int32_t* __restrict__ moves, int batch) {
  __shared__ wl::FsmSlice fs_all[CHUNK_WARPS];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * CHUNK_WARPS + warp;
  if (b >= batch) return;  // the whole warp, and nothing below waits for it
  wl::FsmSlice& fs = fs_all[warp];
  const wl::Geo g = wl::make_geo();
  wl::Cells s;
  Agents A;
  wl::load_game(in, b, g, s, A);
  wl::fsm_load(fin, b, g.lane, fs);
  int rnd[NA], mv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) rnd[i] = rands[b * NA + i];
  wl::NoClock pc;
  wl::fsm_act(s, A, rnd, fs, mv, g, pc);
  if (g.lane < NA) moves[b * NA + g.lane] = pick4(mv, g.lane);
  wl::fsm_store(fout, b, g.lane, fs);
}

}  // namespace pomcpp

extern "C" {

int pomcpp_fused_step(pomcpp::GameView in, pomcpp::GameView out, const int32_t* moves, int batch,
                      void* stream) {
  if (batch <= 0) return (int)cudaErrorInvalidValue;
  const pomcpp::EnvView no_env{};
  const pomcpp::GameView no_game{};
  POMCPP_LAUNCH(pomcpp::fused_step_kernel<false>, pomcpp::chunk_grid(batch),
                pomcpp::CHUNK_WARPS * 32, stream, in, out, no_env, no_env, no_game,
                pomcpp::EnvConfig{}, moves, batch);
  return (int)cudaGetLastError();
}

// `fresh` holds null pointers unless the test hook supplies the reset games.
int pomcpp_env_step(pomcpp::GameView in, pomcpp::EnvView ein, pomcpp::GameView out,
                    pomcpp::EnvView eout, pomcpp::GameView fresh, const int32_t* moves, int batch,
                    int team_mode, int max_steps, int randomize_positions, void* stream) {
  if (batch <= 0) return (int)cudaErrorInvalidValue;
  const pomcpp::EnvConfig cfg{team_mode, max_steps, randomize_positions};
  POMCPP_LAUNCH(pomcpp::fused_step_kernel<true>, pomcpp::chunk_grid(batch),
                pomcpp::CHUNK_WARPS * 32, stream, in, out, ein, eout, fresh, cfg, moves, batch);
  return (int)cudaGetLastError();
}

// `game` is the stepped batch, written in place.
int pomcpp_env_merge(pomcpp::GameView game, pomcpp::EnvView ein, pomcpp::EnvView eout,
                     pomcpp::GameView fresh, int batch, int team_mode, int max_steps,
                     int randomize_positions, void* stream) {
  if (batch <= 0) return (int)cudaErrorInvalidValue;
  const pomcpp::EnvConfig cfg{team_mode, max_steps, randomize_positions};
  POMCPP_LAUNCH(pomcpp::env_merge_kernel, pomcpp::chunk_grid(batch), pomcpp::CHUNK_WARPS * 32,
                stream, game, ein, eout, fresh, cfg, batch);
  return (int)cudaGetLastError();
}

// `phase_totals`: null, or the zeroed row of this call's phase sums, which
// launches the clocked instance.
int pomcpp_rollout_chunk(pomcpp::StateView in, pomcpp::StateView out, int batch, int steps,
                         int n_moves, uint32_t k0, uint32_t k1, const int32_t* moves,
                         const int32_t* reset_board, const int32_t* reset_hidden, int auto_reset,
                         int32_t* rec_moves, int32_t* rec_done, unsigned long long* phase_totals,
                         void* stream) {
  if (batch <= 0 || steps < 0 || n_moves <= 0) return (int)cudaErrorInvalidValue;
  const pomcpp::FsmView none{};
  return pomcpp::launch_chunk<false>(in, out, none, none, batch, steps, n_moves, k0, k1, moves, 0,
                                     0, reset_board, reset_hidden, auto_reset, rec_moves,
                                     rec_done, phase_totals, stream);
}

int pomcpp_rollout_chunk_simple(pomcpp::StateView in, pomcpp::StateView out, pomcpp::FsmView fin,
                                pomcpp::FsmView fout, int batch, int steps, uint32_t k0,
                                uint32_t k1, const int32_t* moves, int inject_mask,
                                int prng_rand, const int32_t* reset_board,
                                const int32_t* reset_hidden, int auto_reset, int32_t* rec_moves,
                                int32_t* rec_done, unsigned long long* phase_totals,
                                void* stream) {
  if (batch <= 0 || steps < 0 || (inject_mask != 0 && moves == nullptr))
    return (int)cudaErrorInvalidValue;
  return pomcpp::launch_chunk<true>(in, out, fin, fout, batch, steps, 5, k0, k1, moves,
                                    inject_mask, prng_rand, reset_board, reset_hidden, auto_reset,
                                    rec_moves, rec_done, phase_totals, stream);
}

int pomcpp_fsm_act(pomcpp::GameView in, pomcpp::FsmView fin, pomcpp::FsmView fout,
                   const int32_t* rands, int32_t* moves, int batch, void* stream) {
  if (batch <= 0) return (int)cudaErrorInvalidValue;
  POMCPP_LAUNCH(pomcpp::fsm_act_kernel, pomcpp::chunk_grid(batch), pomcpp::CHUNK_WARPS * 32,
                stream, in, fin, fout, rands, moves, batch);
  return (int)cudaGetLastError();
}

// Boards per CTA of the kernels, the CTAs the launchers start for a batch,
// and the CTAs of one kernel that the runtime keeps resident on one SM (0 or
// less: none fits, or the query failed).  `kernel`: 0
// rollout_chunk_kernel<false>, 1 <true>, 2 fused_step_kernel<false>, 3
// <true>, 4 env_merge_kernel, 5 fsm_act_kernel, 6
// rollout_chunk_clocked_kernel<false>, 7 <true>.
int pomcpp_chunk_warps() { return pomcpp::CHUNK_WARPS; }

int pomcpp_chunk_grid(int batch) { return pomcpp::chunk_grid(batch); }

int pomcpp_ctas_per_sm(int kernel) {
  using namespace pomcpp;
  constexpr int nt = CHUNK_WARPS * 32;
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (kernel) {
    case 0: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, rollout_chunk_kernel<false>, nt, 0); break;
    case 1: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, rollout_chunk_kernel<true>, nt, 0); break;
    case 2: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fused_step_kernel<false>, nt, 0); break;
    case 3: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fused_step_kernel<true>, nt, 0); break;
    case 4: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, env_merge_kernel, nt, 0); break;
    case 5: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fsm_act_kernel, nt, 0); break;
    case 6: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, rollout_chunk_clocked_kernel<false>, nt, 0); break;
    case 7: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, rollout_chunk_clocked_kernel<true>, nt, 0); break;
  }
  return err == cudaSuccess ? n : -(int)err;
}

const char* pomcpp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
