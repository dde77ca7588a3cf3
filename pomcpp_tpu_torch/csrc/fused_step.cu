// The two fused kernels of the port and their plain C launchers (bound to
// PyTorch with ctypes by pomcpp_tpu_torch/_ext.py).
//
// fused_step_kernel replaces `_kernel` / `pallas_step`
// (pomcpp_tpu/engine/pallas_step.py:1261, :1283): one step for B boards.
// rollout_chunk_kernel replaces `_chunk_kernel` / `pallas_rollout_chunk`
// (:840, :1069): each CTA loads one board's state once, runs `steps` steps
// with in-kernel Philox draws and the pipelined auto-reset, and writes the
// state back once -- the counterpart of the TPU kernel keeping its block in
// VMEM for a chunk.  rollout_chunk_kernel<false> serves the harmless and
// random policies; rollout_chunk_kernel<true> is policy="simple": the draws
// are the SimpleAgent's rands, the FSM of fsm_block.cuh picks the moves
// (with the `inject_slots` override of mixed control), and the ten FSM
// arrays ride along in shared memory.  fsm_act_kernel replaces one
// `fsm_block` act (pomcpp_tpu/engine/pallas_fsm.py:357) for B boards.
//
// Bound on the card: a chunk moves 2 x 3,500 bytes per board through HBM
// (plus the optional test-hook arrays), so at 16384 boards the byte bound
// is tens of microseconds, far below the time the step body takes; the
// kernel is bound by barrier latency and scalar issue (see step_block.cuh).
//
// The PRNG is Philox4x32-10 (Salmon et al., SC'11), counter
// (board, chunk-local step, stream, word), key (seed lo, seed hi); the
// plain PyTorch version in engine/fused_step.py computes the same words.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "fsm_block.cuh"
#include "step_block.cuh"

namespace pomcpp {

struct StateView {
  int32_t* f[14];  // board, hidden, ftimer, btimer, bstr, bdir, bown: [B, 121]
                   // ax, ay, abc, amb, ast, akick, adead: [B, 4]
};

constexpr uint32_t STREAM_MOVES = 0, STREAM_CELLS = 1, STREAM_FLAGS = 2;

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

__device__ __forceinline__ void load_board(const StateView& in, int b, int c, Cell& s, Agents& A) {
  if (c < NC) {
    const int o = b * NC + c;
    s = Cell{in.f[0][o], in.f[1][o], in.f[2][o], in.f[3][o], in.f[4][o], in.f[5][o], in.f[6][o]};
  } else {
    s = Cell{0, 0, 0, 0, 0, 0, 0};
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

__device__ __forceinline__ void store_board(const StateView& out, int b, int c, const Cell& s,
                                            const Agents& A) {
  if (c < NC) {
    const int o = b * NC + c;
    out.f[0][o] = s.board;
    out.f[1][o] = s.hidden;
    out.f[2][o] = s.ftimer;
    out.f[3][o] = s.btimer;
    out.f[4][o] = s.bstr;
    out.f[5][o] = s.bdir;
    out.f[6][o] = s.bown;
  }
  if (c < NA) {
    const int o = b * NA + c;
    out.f[7][o] = A.x[c];
    out.f[8][o] = A.y[c];
    out.f[9][o] = A.bc[c];
    out.f[10][o] = A.mb[c];
    out.f[11][o] = A.st[c];
    out.f[12][o] = A.kick[c];
    out.f[13][o] = A.dead[c];
  }
}

// Board finished: at most one agent alive.
__device__ __forceinline__ bool finished(const Agents& A) {
  return A.dead[0] + A.dead[1] + A.dead[2] + A.dead[3] >= 3;
}

__global__ void __launch_bounds__(NT) fused_step_kernel(StateView in, StateView out,
                                                        const int32_t* __restrict__ moves) {
  __shared__ Shared sh;
  const int b = blockIdx.x, c = threadIdx.x;
  Cell s;
  Agents A;
  load_board(in, b, c, s, A);
  int mv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) mv[i] = moves[b * NA + i];
  step_board(s, A, mv, sh);
  store_board(out, b, c, s, A);
}

// kSimple: `n_moves` is 5, the draws (or moves[t] unless prng_rand) are the
// FSM's rands, and lanes set in inject_mask take their move from moves[t].
template <bool kSimple>
__global__ void __launch_bounds__(NT) rollout_chunk_kernel(
    StateView in, StateView out, FsmView fin, FsmView fout, int batch, int steps, int n_moves,
    uint32_t k0, uint32_t k1, const int32_t* __restrict__ moves, int inject_mask, int prng_rand,
    const int32_t* __restrict__ reset_board, const int32_t* __restrict__ reset_hidden,
    int auto_reset, int32_t* __restrict__ rec_moves, int32_t* __restrict__ rec_done) {
  __shared__ Shared sh;
  __shared__ std::conditional_t<kSimple, FsmShared, char> fs;
  const int b = blockIdx.x, c = threadIdx.x;
  Cell s;
  Agents A;
  load_board(in, b, c, s, A);
  if constexpr (kSimple) fsm_load(fin, b, c, fs);

  // This board's replacement terrain, drawn once per chunk (_fresh_boards).
  int fboard = 0, fhidden = 0;
  if (auto_reset && c < NC) {
    if (reset_board != nullptr) {
      fboard = reset_board[b * NC + c];
      fhidden = reset_hidden[b * NC + c];
    } else {
      const uint4 cw = philox4x32_10(make_uint4((uint32_t)b, 0u, STREAM_CELLS, (uint32_t)(c >> 2)), k0, k1);
      const uint4 fw = philox4x32_10(make_uint4((uint32_t)b, 0u, STREAM_FLAGS, (uint32_t)(c >> 2)), k0, k1);
      const int tmp = draw30(word_of(cw, c & 3)) % 7;
      const int flags = draw30(word_of(fw, c & 3));
      fboard = tmp == 1 ? C_RIGID : tmp == 2 ? C_WOOD : C_PASSAGE;
      fhidden = (fboard == C_WOOD && (flags & 1) == 0) ? ((flags >> 1) % 4) + 1 : 0;
    }
    if (c == 0) fboard = C_AGENT0 + 0;
    if (c == BS - 1) fboard = C_AGENT0 + 1;
    if (c == NC - 1) fboard = C_AGENT0 + 2;
    if (c == NC - BS) fboard = C_AGENT0 + 3;
  }
  auto merge_fresh = [&]() {
    s = Cell{fboard, fhidden, 0, 0, 0, 0, 0};
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
  for (int t = 0; t < steps; ++t) {
    int mv[NA];
    if (moves != nullptr && !(kSimple && prng_rand)) {
#pragma unroll
      for (int i = 0; i < NA; ++i) mv[i] = moves[((size_t)t * batch + b) * NA + i];
    } else {
      const uint4 w = philox4x32_10(make_uint4((uint32_t)b, (uint32_t)t, STREAM_MOVES, 0u), k0, k1);
#pragma unroll
      for (int i = 0; i < NA; ++i) mv[i] = draw30(word_of(w, i)) % n_moves;
    }
    bool done_next = done;
    if (auto_reset) {
      if (done) {
        merge_fresh();
        if constexpr (kSimple) fsm_reset(c, fs);
      }
      done_next = finished(A);
    }
    if constexpr (kSimple) {
      const int rnd[NA] = {mv[0], mv[1], mv[2], mv[3]};
      fsm_act(s, A, rnd, fs, mv);
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        if ((inject_mask >> i) & 1) mv[i] = moves[((size_t)t * batch + b) * NA + i];
        if (A.dead[i]) mv[i] = 0;
      }
    }
    step_board(s, A, mv, sh);
    if (rec_moves != nullptr && c < NA) {
      rec_moves[((size_t)t * batch + b) * NA + c] = mv[c];
      if (c == 0) rec_done[(size_t)t * batch + b] = finished(A);
    }
    done = done_next;
  }
  // Catch-up merge: boards that finished in the last two steps.
  if (auto_reset && finished(A)) {
    merge_fresh();
    if constexpr (kSimple) fsm_reset(c, fs);
  }
  store_board(out, b, c, s, A);
  if constexpr (kSimple) fsm_store(fout, b, c, fs);
}

__global__ void __launch_bounds__(NT) fsm_act_kernel(StateView in, FsmView fin, FsmView fout,
                                                     const int32_t* __restrict__ rands,
                                                     int32_t* __restrict__ moves) {
  __shared__ FsmShared fs;
  const int b = blockIdx.x, c = threadIdx.x;
  Cell s;
  Agents A;
  load_board(in, b, c, s, A);
  fsm_load(fin, b, c, fs);
  int rnd[NA], mv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) rnd[i] = rands[b * NA + i];
  fsm_act(s, A, rnd, fs, mv);
  if (c < NA) moves[b * NA + c] = pick4(mv, c);
  fsm_store(fout, b, c, fs);
}

}  // namespace pomcpp

extern "C" {

int pomcpp_fused_step(pomcpp::StateView in, pomcpp::StateView out, const int32_t* moves,
                      int batch, void* stream) {
  if (batch <= 0) return (int)cudaErrorInvalidValue;
  pomcpp::fused_step_kernel<<<batch, pomcpp::NT, 0, (cudaStream_t)stream>>>(in, out, moves);
  return (int)cudaGetLastError();
}

int pomcpp_rollout_chunk(pomcpp::StateView in, pomcpp::StateView out, int batch, int steps,
                         int n_moves, uint32_t k0, uint32_t k1, const int32_t* moves,
                         const int32_t* reset_board, const int32_t* reset_hidden, int auto_reset,
                         int32_t* rec_moves, int32_t* rec_done, void* stream) {
  if (batch <= 0 || steps < 0 || n_moves <= 0) return (int)cudaErrorInvalidValue;
  pomcpp::rollout_chunk_kernel<false><<<batch, pomcpp::NT, 0, (cudaStream_t)stream>>>(
      in, out, pomcpp::FsmView{}, pomcpp::FsmView{}, batch, steps, n_moves, k0, k1, moves, 0, 0,
      reset_board, reset_hidden, auto_reset, rec_moves, rec_done);
  return (int)cudaGetLastError();
}

int pomcpp_rollout_chunk_simple(pomcpp::StateView in, pomcpp::StateView out, pomcpp::FsmView fin,
                                pomcpp::FsmView fout, int batch, int steps, uint32_t k0,
                                uint32_t k1, const int32_t* moves, int inject_mask,
                                int prng_rand, const int32_t* reset_board,
                                const int32_t* reset_hidden, int auto_reset, int32_t* rec_moves,
                                int32_t* rec_done, void* stream) {
  if (batch <= 0 || steps < 0 || (inject_mask != 0 && moves == nullptr))
    return (int)cudaErrorInvalidValue;
  pomcpp::rollout_chunk_kernel<true><<<batch, pomcpp::NT, 0, (cudaStream_t)stream>>>(
      in, out, fin, fout, batch, steps, 5, k0, k1, moves, inject_mask, prng_rand, reset_board,
      reset_hidden, auto_reset, rec_moves, rec_done);
  return (int)cudaGetLastError();
}

int pomcpp_fsm_act(pomcpp::StateView in, pomcpp::FsmView fin, pomcpp::FsmView fout,
                   const int32_t* rands, int32_t* moves, int batch, void* stream) {
  if (batch <= 0) return (int)cudaErrorInvalidValue;
  pomcpp::fsm_act_kernel<<<batch, pomcpp::NT, 0, (cudaStream_t)stream>>>(in, fin, fout, rands,
                                                                        moves);
  return (int)cudaGetLastError();
}

const char* pomcpp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
