// ego_features_kernel: the actor-critic's egocentric input features
// (pomcpp_tpu_torch/models/features.py `ego_features`) for the agents
// `slots` of B boards, in one launch, written as bf16 straight into the
// caller's buffer (the PPO rollout's trajectory row).
//
// It replaces no TPU kernel: the JAX package builds these features with XLA
// ops (pomcpp_tpu/env/observation.py `observe_ego`, one-hot products for
// the crop, and pomcpp_tpu/models/actor_critic.py `obs_to_features`), and
// the port's plain version is the same arrangement of PyTorch operators,
// about 40 launches a call.  The output is flat [B, L, (2R+1)^2, 23] (JAX's
// [..., H, W, C] order, H along y); each of its cells holds
//
//   channels 0-12   the one-hot board class: an agent (10-13) is class 9-12,
//                   the class clamped to 0-12; off-board cells read C_RIGID;
//   channels 13-16  bomb timer / 10, bomb strength / 10, bomb direction / 4,
//                   flame timer / 4 (0 off the board);
//   channels 17-22  the agent's max bombs / 5, bomb count / 5, strength / 10,
//                   can kick, x / 10, y / 10, the same over the window.
//
// Bit exactness.  Each scalar is computed in float32 as the card's plain
// path computes `int32 / 10.0` (a multiply by the float32 reciprocal) and
// rounded once to bf16, to nearest even, by the bit helper below; for the
// integers the game holds the exact quotient rounds to the same bf16
// (tests/test_torch_csrc.py checks 0-1023 for each divisor), so the output
// equals the plain version on the CPU as on the card.
//
// Bound on the card: bytes.  At 2,048 rows of a 9x9 window the kernel
// writes 7.6 MB and reads the five planes and six agent fields of each
// board (5.1 MB), 3.8 us at 3.35 TB/s; the work is a few dozen integer
// operations a cell.  So the design keeps the instructions per value low
// and the writes whole: a lane builds one cell (its board, agent and window
// position found once, 11 reads, 23 values) into its warp's slice of shared
// memory, and the warp then writes its 32 cells -- a contiguous run of
// 1,472 bytes that starts on 16 bytes whenever the output does -- as
// 16-byte stores of consecutive lanes, fully coalesced.  A row is 1,863
// values, an odd count, so a lane's cell lies anywhere in a vector; the
// staging is what lets the stores ignore that.  An output that does not
// start on 16 bytes (a trajectory row of an odd board count) is written
// value by value from the same staging.  The lanes of a warp read
// neighbouring cells of one board, so the planes go through the read-only
// path, nearly all from L1; the warp needs no CTA barrier.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

// A kernel launch.  The tests' host build (csrc/host_emu/cuda_runtime.h)
// defines it as a loop over the grid's warps on the CPU.
#ifndef POMCPP_LAUNCH
#define POMCPP_LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<(grid), (block), 0, (cudaStream_t)(stream)>>>(__VA_ARGS__)
#endif

namespace pomcpp {
namespace feat {

constexpr int N_CLASSES = 13;                // passage .. kick, 4 agents
constexpr int N_FEATURES = N_CLASSES + 4 + 6;
constexpr int PER_VECTOR = 8;                // bf16 values in a 16-byte store
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_SLOTS = 16;                // 2 bits an agent id in `slot_code`
constexpr int MAX_VIEW_RANGE = 64;

// The arrays the features read, as the env step leaves them.
struct FeatureView {
  const int32_t* plane[5];  // board, bomb_timer, bomb_strength, bomb_dir, flame_timer: [B, 121]
  const int32_t* agent[5];  // agent_x, agent_y, max_bombs, bomb_count, strength: [B, 4]
  const uint8_t* can_kick;  // bool [B, 4], one byte each
};

__device__ __forceinline__ int ld(const int32_t* p) {
#ifdef POMCPP_HOST_EMU
  return *p;
#else
  return __ldg(p);
#endif
}

__device__ __forceinline__ int ld(const uint8_t* p) {
#ifdef POMCPP_HOST_EMU
  return *p;
#else
  return __ldg(p);
#endif
}

// float32 -> bf16 bits, to nearest even (the values are finite).
__device__ __forceinline__ uint32_t bf16_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}

// `v / d` as the card's plain path computes it: times the float32 reciprocal.
__device__ __forceinline__ float over10(int v) { return (float)v * (1.0f / 10.0f); }
__device__ __forceinline__ float over5(int v) { return (float)v * (1.0f / 5.0f); }
__device__ __forceinline__ float over4(int v) { return (float)v * (1.0f / 4.0f); }

// Lane l of warp w builds cell 32 w + l of the block (the rows' cells in
// order, 23 values each) into the warp's slice of shared memory; after a
// __syncwarp the warp stores its 32 x 23 values, a contiguous run of the
// output that starts on a multiple of 736 values, as 16-byte vectors (92 of
// them, fewer in the last warp), or value by value when the output does
// not start on 16 bytes.
__global__ void __launch_bounds__(THREADS)
    ego_features_kernel(FeatureView v, uint16_t* out, int n_cells, int n_slots, int slot_code,
                        int r) {
  // Read back as halves and packed into vectors: no access through a type
  // other than the one written.
  __shared__ uint16_t stage[WARPS][32 * N_FEATURES];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int first = (blockIdx.x * WARPS + warp) * 32;  // the warp's first cell
  uint16_t* const vals = stage[warp];
  const int g = first + lane;
  if (g < n_cells) {
    const int w = 2 * r + 1;
    const int row = g / (w * w), cell = g - row * (w * w);
    const int b = row / n_slots;
    const int a = (slot_code >> (2 * (row - b * n_slots))) & 3;
    const int ai = b * NA + a;
    const int x = ld(v.agent[0] + ai), y = ld(v.agent[1] + ai);
    const int i = cell / w;
    const int cx = x + (cell - i * w) - r, cy = y + i - r;
    const bool on = cx >= 0 && cx < BS && cy >= 0 && cy < BS;
    const int ci = b * NC + (on ? cy * BS + cx : 0);
    const int board = on ? ld(v.plane[0] + ci) : C_RIGID;
    const int raw = board >= C_AGENT0 ? board - C_AGENT0 + 9 : board;
    // The class as a bit: written as `cls == c` after a min/max clamp,
    // ptxas (CUDA 12.8, sm_90a) folded the clamp into VIMNMX.RELU and read
    // `cls == 12` off that instruction's predicate output, which set
    // channel 12 on almost every cell (the PTX was right).
    const uint32_t hot = 1u << min(max(raw, 0), N_CLASSES - 1);
    uint16_t* const mine = vals + N_FEATURES * lane;
#pragma unroll
    for (int c = 0; c < N_CLASSES; ++c) mine[c] = (hot >> c & 1u) * 0x3F80u;  // 1.0 or 0.0
    mine[13] = bf16_bits(over10(on ? ld(v.plane[1] + ci) : 0));
    mine[14] = bf16_bits(over10(on ? ld(v.plane[2] + ci) : 0));
    mine[15] = bf16_bits(over4(on ? ld(v.plane[3] + ci) : 0));
    mine[16] = bf16_bits(over4(on ? ld(v.plane[4] + ci) : 0));
    mine[17] = bf16_bits(over5(ld(v.agent[2] + ai)));
    mine[18] = bf16_bits(over5(ld(v.agent[3] + ai)));
    mine[19] = bf16_bits(over10(ld(v.agent[4] + ai)));
    mine[20] = ld(v.can_kick + ai) != 0 ? 0x3F80 : 0;
    mine[21] = bf16_bits(over10(x));
    mine[22] = bf16_bits(over10(y));
  }
  __syncwarp();
  if (first >= n_cells) return;
  const int cells = min(32, n_cells - first);
  const int count = cells * N_FEATURES;
  uint16_t* const dst = out + (size_t)first * N_FEATURES;
  if (((uintptr_t)out & 15u) == 0) {
    const int full = count / PER_VECTOR;
    for (int q = lane; q < full; q += 32) {
      const uint16_t* h = vals + PER_VECTOR * q;
      uint4 vec;
      vec.x = h[0] | (uint32_t)h[1] << 16;
      vec.y = h[2] | (uint32_t)h[3] << 16;
      vec.z = h[4] | (uint32_t)h[5] << 16;
      vec.w = h[6] | (uint32_t)h[7] << 16;
      reinterpret_cast<uint4*>(dst)[q] = vec;
    }
    const int k = full * PER_VECTOR + lane;
    if (k < count) dst[k] = vals[k];
  } else {
    for (int k = lane; k < count; k += 32) dst[k] = vals[k];
  }
}

}  // namespace feat
}  // namespace pomcpp

extern "C" {

// Features of the `n_slots` agents `slot_code` names (2 bits each, slot l
// at bits 2l) of `batch` boards into the bf16 block `out`
// [batch, n_slots, (2R+1)^2 * 23]; `out` must be 2-byte aligned.
int pomcpp_ego_features(pomcpp::feat::FeatureView v, void* out, int batch, int n_slots,
                        int slot_code, int view_range, void* stream) {
  using namespace pomcpp::feat;
  if (batch <= 0 || n_slots <= 0 || n_slots > MAX_SLOTS || view_range < 0 ||
      view_range > MAX_VIEW_RANGE || ((uintptr_t)out & 1u) != 0)
    return (int)cudaErrorInvalidValue;
  const int w = 2 * view_range + 1;
  const int64_t cells = (int64_t)batch * n_slots * w * w;
  if (cells * N_FEATURES >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const int n_cells = (int)cells;
  POMCPP_LAUNCH(ego_features_kernel, (n_cells + THREADS - 1) / THREADS, THREADS, stream, v,
                (uint16_t*)out, n_cells, n_slots, slot_code, view_range);
  return (int)cudaGetLastError();
}

const char* pomcpp_features_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
