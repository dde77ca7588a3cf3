// Micro-probes of the op patterns the step and FSM kernels are built from,
// for Hopper (sm_90a).  Counterparts of the Pallas bodies in
// scripts/microbench_{sublane,i16,layout,patterns,reductions}.py: each
// probe computes the same function of its input arrays as its Pallas body,
// bit for bit, K loop iterations deep.
//
// A "row" is 128 lanes wide (one board's 121-cell plane plus 7 pad lanes);
// agent arrays are 4 wide.  Every probe exists in two layouts:
//
//   L_CTA   one row per 128-thread CTA, one cell per thread; neighbour
//           exchange and reductions go through shared memory and
//           __syncthreads (what step_block.cuh and fsm_block.cuh do);
//   L_WARP  one row per warp, four consecutive cells per thread, four rows
//           per 128-thread CTA; exchange and reductions go through
//           __shfl_sync and never touch shared memory or a barrier.
//
// Four kernel families: probe_elem_kernel (elementwise chains),
// probe_shift_kernel (lane rolls and agent-array rotations),
// probe_reduce_kernel (row reductions; probe_reduce_tile_kernel for the
// reductions over a whole 128-row tile) and probe_dot_kernel (the f32
// products, computed here with an FMA loop over a shared-memory copy of
// the matrix).  `rows` / `tile` restrict the work to the first `rows` rows
// of every `tile` rows (the other rows are copied), as the sublane script
// does.  Plain C interface at the bottom; pomcpp_tpu_torch/probes.py binds it.

#include <cuda_runtime.h>

#include <cstdint>

namespace pomcpp_probes {

constexpr int LANES = 128;
constexpr int NT = 128;          // threads per CTA in both row layouts
constexpr int AGENTS = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE_ROWS = 128;   // rows of a tile reduction
constexpr int TILE_NT = 1024;    // threads of the tile kernel
constexpr int TILE_NPT = TILE_ROWS * LANES / TILE_NT;

enum Layout { L_CTA = 0, L_WARP = 1 };

enum ElemOp { E_ELEM = 0, E_CHAIN, E_BASELINE, E_COND_FALSE, E_COND_TRUE, E_WHILE2 };
enum ShiftOp { S_ROLL = 0, S_ROLL2, S_PUSH, S_PUSH_HOIST, S_PREFIX_OR, S_WHOLE4, S_ROT4,
               S_COLSLICE };
enum ReduceOp { R_SUMRED = 0, R_AXIS1_ANY, R_PACKED_SUM, R_MIN_RED4, R_ONEHOT_RD, R_ANY_PLANE,
                R_ANY4 };
enum DotOp { D_DOT = 0, D_DOTRED };

// --- Layouts -------------------------------------------------------------------

template <int L>
struct Lay;

template <>
struct Lay<L_CTA> {
  static constexpr int NPT = 1;            // cells per thread
  static constexpr int ROWS_PER_CTA = 1;
  __device__ static int row() { return blockIdx.x; }
  __device__ static int cell(int) { return threadIdx.x; }
  __device__ static int lane() { return threadIdx.x; }   // index among a row's threads
};

template <>
struct Lay<L_WARP> {
  static constexpr int NPT = 4;
  static constexpr int ROWS_PER_CTA = NT / 32;
  __device__ static int row() { return blockIdx.x * ROWS_PER_CTA + (threadIdx.x >> 5); }
  __device__ static int cell(int j) { return 4 * (threadIdx.x & 31) + j; }
  __device__ static int lane() { return threadIdx.x & 31; }
};

// Shared memory of the L_CTA layout: two exchange buffers used in turn, so
// that one barrier per exchange is enough (a thread can be at most one
// exchange ahead of another).  L_WARP never touches it.
template <int L>
struct Ctx {
  int* sm;       // 2 * LANES ints
  int phase;
  __device__ explicit Ctx(int* shared) : sm(shared), phase(0) {}
  __device__ int* next() {
    int* b = sm + phase * LANES;
    phase ^= 1;
    return b;
  }
};

// Circular roll along the row: out[c] = in[(c - S) mod 128].
template <int S, typename T>
__device__ __forceinline__ void roll(Ctx<L_CTA>& cx, T (&v)[1]) {
  int* b = cx.next();
  b[threadIdx.x] = (int)v[0];
  __syncthreads();
  v[0] = (T)b[(threadIdx.x - S) & (LANES - 1)];
}

template <int S, typename T>
__device__ __forceinline__ void roll(Ctx<L_WARP>&, T (&v)[4]) {
  constexpr int q = S / 4, r = S % 4;
  const int t = threadIdx.x & 31;
  T o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int src = (t - q - (j < r ? 1 : 0)) & 31;
    o[j] = (T)__shfl_sync(FULL, (int)v[(j - r) & 3], src);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = o[j];
}

struct OpAdd {
  template <typename V>
  __device__ static V f(V a, V b) { return a + b; }
};
struct OpMin {
  __device__ static int f(int a, int b) { return a < b ? a : b; }
};
struct OpMax {
  __device__ static int f(int a, int b) { return a > b ? a : b; }
};

// Reduction over the 128 cells of a row; every thread of the row gets the
// result.  `part` is the thread's own partial over its NPT cells.
template <typename Op, typename V>
__device__ __forceinline__ V row_reduce(Ctx<L_CTA>& cx, V part) {
  V* b = reinterpret_cast<V*>(cx.next());
  const int l = threadIdx.x;
  b[l] = part;
  __syncthreads();
#pragma unroll
  for (int stride = LANES / 2; stride > 0; stride >>= 1) {
    if (l < stride) b[l] = Op::f(b[l], b[l + stride]);
    __syncthreads();
  }
  return b[0];
}

template <typename Op, typename V>
__device__ __forceinline__ V row_reduce(Ctx<L_WARP>&, V part) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) part = Op::f(part, __shfl_xor_sync(FULL, part, m));
  return part;
}

// Agent arrays: every thread of a row holds agent (lane & 3)'s value, so the
// four values are replicated; `ag_get` reads agent `src`'s value (src may
// differ from thread to thread).
__device__ __forceinline__ int ag_get(Ctx<L_CTA>& cx, int ag, int src) {
  int* b = cx.next();
  if (threadIdx.x < AGENTS) b[threadIdx.x] = ag;
  __syncthreads();
  return b[src];
}

__device__ __forceinline__ int ag_get(Ctx<L_WARP>&, int ag, int src) {
  return __shfl_sync(FULL, ag, src);
}

__device__ __forceinline__ bool row_any(Ctx<L_CTA>&, bool pred) {
  return __syncthreads_or(pred) != 0;
}

__device__ __forceinline__ bool row_any(Ctx<L_WARP>&, bool pred) {
  return __any_sync(FULL, pred) != 0;
}

// --- Elementwise chains ------------------------------------------------------------

template <typename T>
struct ChainMask;
template <>
struct ChainMask<int32_t> {
  static constexpr int32_t keep = 0x7E7E, carry = 0x0101;
};
template <>
struct ChainMask<int16_t> {
  static constexpr int16_t keep = 0x7E7E, carry = 0x0101;
};
template <>
struct ChainMask<int8_t> {   // the constants wrap to the type's width
  static constexpr int8_t keep = 0x7E, carry = 0x01;
};

template <int OP, typename T>
__device__ __forceinline__ T elem_body(T x, int i) {
  if constexpr (OP == E_ELEM) {
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      x = x > 3 ? x - 3 : x + 1;
      x = x ^ 5;
      x = x + i;
    }
  } else if constexpr (OP == E_CHAIN) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      x = (T)((x & ChainMask<T>::keep) | ((T)((unsigned)x + 1u) & ChainMask<T>::carry));
      x = (T)(x ^ (T)(x >> 7));
    }
  } else if constexpr (OP == E_BASELINE) {
#pragma unroll
    for (int n = 0; n < 8; ++n) x = (x > 3 ? x - 3 : x + 1) ^ i;
  } else if constexpr (OP == E_COND_FALSE) {
    if (i < 0) x = x + 1;
  } else if constexpr (OP == E_COND_TRUE) {
    if (i >= 0) x = x + 1;
  } else if constexpr (OP == E_WHILE2) {
    for (int c = 0; c < 2; ++c) x = x + 1;
  }
  return x;
}

// Replaces the elementwise bodies of scripts/microbench_sublane.py
// (_kernel_elem), microbench_layout.py (_kernel), microbench_i16.py (chain)
// and the baseline / cond_* / while_2it patterns of microbench_patterns.py
// and microbench_reductions.py.  Bound by 32-bit integer operations (the
// arrays are read and written once, the chain is K x 64 ops deep); the
// chain lives in registers, so both layouts only differ in how many
// independent chains a thread carries (1 or 4).
// x: [n_rows, width], width <= 128.
template <int OP, int L, typename T>
__global__ void __launch_bounds__(NT)
probe_elem_kernel(const T* __restrict__ in, T* __restrict__ out, int n_rows, int width, int k,
                  int rows, int tile) {
  using Y = Lay<L>;
  const int row = Y::row();
  if (row >= n_rows) return;
  const bool live = (row % tile) < rows;
  T v[Y::NPT];
#pragma unroll
  for (int j = 0; j < Y::NPT; ++j) {
    const int c = Y::cell(j);
    v[j] = c < width ? in[(size_t)row * width + c] : (T)0;
  }
  if (live) {
    for (int i = 0; i < k; ++i) {
#pragma unroll
      for (int j = 0; j < Y::NPT; ++j) v[j] = elem_body<OP, T>(v[j], i);
    }
  }
#pragma unroll
  for (int j = 0; j < Y::NPT; ++j) {
    const int c = Y::cell(j);
    if (c < width) out[(size_t)row * width + c] = v[j];
  }
}

// --- Shifts and rotations ------------------------------------------------------------

__device__ __forceinline__ bool push_ok_down(int c) {   // _push(plane, 1)
  return (c / 11 + 1 < 11) && c < 121;
}
__device__ __forceinline__ bool push_ok_right(int c) {  // _push(plane, 3)
  return (c % 11 - 1 >= 0) && c < 121;
}

template <int SH, int L>
__device__ __forceinline__ void prefix_round(Ctx<L>& cx, int (&p)[Lay<L>::NPT]) {
  int r[Lay<L>::NPT];
#pragma unroll
  for (int j = 0; j < Lay<L>::NPT; ++j) r[j] = p[j];
  roll<SH>(cx, r);
#pragma unroll
  for (int j = 0; j < Lay<L>::NPT; ++j) p[j] |= (Lay<L>::cell(j) >= SH ? r[j] : 0);
}

// Replaces _kernel_roll (sublane), the i16 script's roll, and push,
// push_hoist, prefix_or, whole4, rot4_all and colslice of the patterns and
// reductions scripts.  Bound by the exchange, not by bytes or arithmetic:
// L_CTA pays a shared-memory store, a barrier and a load per roll, L_WARP
// four shuffles.
// plane: [n_rows, 128] of T; agents: [n_rows, 4] int32 (may be null).
template <int OP, int L, typename T>
__global__ void __launch_bounds__(NT)
probe_shift_kernel(const T* __restrict__ p_in, T* __restrict__ p_out,
                   const int32_t* __restrict__ a_in, int32_t* __restrict__ a_out, int n_rows,
                   int k, int rows, int tile) {
  using Y = Lay<L>;
  constexpr int NPT = Y::NPT;
  __shared__ int sm[2 * LANES];
  Ctx<L> cx(sm);
  const int row = Y::row();
  if (row >= n_rows) return;   // uniform per CTA (L_CTA) or per warp (L_WARP)
  const bool live = (row % tile) < rows;
  const int aj = Y::lane() & 3;
  T v[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) v[j] = p_in[(size_t)row * LANES + Y::cell(j)];
  int ag = a_in ? a_in[(size_t)row * AGENTS + aj] : 0;

  bool ok1[NPT], ok3[NPT];
  if constexpr (OP == S_PUSH_HOIST) {
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      ok1[j] = push_ok_down(Y::cell(j));
      ok3[j] = push_ok_right(Y::cell(j));
    }
  }

  if (live) {
    for (int i = 0; i < k; ++i) {
      if constexpr (OP == S_ROLL) {
#pragma unroll
        for (int n = 0; n < 32; ++n) {
          roll<1>(cx, v);
#pragma unroll
          for (int j = 0; j < NPT; ++j) v[j] = (T)(v[j] + i);
        }
      } else if constexpr (OP == S_ROLL2) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          T r[NPT];
#pragma unroll
          for (int j = 0; j < NPT; ++j) r[j] = v[j];
          roll<1>(cx, r);
#pragma unroll
          for (int j = 0; j < NPT; ++j) r[j] = v[j] = (T)((unsigned)v[j] + (unsigned)r[j]);
          roll<117>(cx, r);
#pragma unroll
          for (int j = 0; j < NPT; ++j) v[j] = (T)(v[j] ^ r[j]);
        }
      } else if constexpr (OP == S_PUSH || OP == S_PUSH_HOIST) {
        T r1[NPT], r3[NPT];
#pragma unroll
        for (int j = 0; j < NPT; ++j) r1[j] = r3[j] = v[j];
        roll<117>(cx, r1);   // (-11) mod 128: the cell below
        roll<1>(cx, r3);     // the cell to the left
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          const int c = Y::cell(j);
          const bool o1 = OP == S_PUSH ? push_ok_down(c) : ok1[j];
          const bool o3 = OP == S_PUSH ? push_ok_right(c) : ok3[j];
          v[j] = (T)((unsigned)(o1 ? r1[j] : (T)0) + (unsigned)(o3 ? r3[j] : (T)0) + (unsigned)i);
        }
      } else if constexpr (OP == S_PREFIX_OR) {
        int p[NPT];
#pragma unroll
        for (int j = 0; j < NPT; ++j) p[j] = (int)v[j];
        prefix_round<1, L>(cx, p);
        prefix_round<2, L>(cx, p);
        prefix_round<4, L>(cx, p);
        prefix_round<8, L>(cx, p);
        prefix_round<16, L>(cx, p);
        prefix_round<32, L>(cx, p);
        prefix_round<64, L>(cx, p);
#pragma unroll
        for (int j = 0; j < NPT; ++j) v[j] = (T)(v[j] ^ p[j]);
      } else if constexpr (OP == S_WHOLE4) {
        const int r1 = ag_get(cx, ag, (aj + 1) & 3);
        ag = (ag == r1 ? ag + 1 : ag - 1) ^ i;
        const int r2 = ag_get(cx, ag, (aj + 2) & 3);
        ag = (ag > r2 ? ag : r2) + i;
      } else if constexpr (OP == S_ROT4) {
        const int t = (ag & 7) != 7;
        const int r1 = ag_get(cx, t, (aj + 1) & 3);
        const int r2 = ag_get(cx, t, (aj + 2) & 3);
        const int r3 = ag_get(cx, t, (aj + 3) & 3);
        ag += (t & r1 & r2 & r3) ? 1 : 2;
      } else if constexpr (OP == S_COLSLICE) {
#pragma unroll
        for (int col = 0; col < AGENTS; ++col) {
          const int c = ag_get(cx, ag, col);
          const int nv = (c > 2 ? c - 2 : c + 1) ^ i;
          if (aj == col) ag = nv;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NPT; ++j) p_out[(size_t)row * LANES + Y::cell(j)] = v[j];
  if (a_out && Y::lane() < AGENTS) a_out[(size_t)row * AGENTS + aj] = ag;
}

// --- Row reductions --------------------------------------------------------------------

// Replaces _kernel_sumred (sublane), onehot_rd (patterns) and axis1_any,
// packed_sum and min_red4 (reductions).  Bound by the reduction's exchange:
// L_CTA runs a shared-memory tree with a barrier per level (eight barriers a
// reduction), L_WARP five shuffle rounds after a local combine of four cells.
template <int OP, int L>
__global__ void __launch_bounds__(NT)
probe_reduce_kernel(const int32_t* __restrict__ p_in, int32_t* __restrict__ p_out,
                    const int32_t* __restrict__ a_in, int32_t* __restrict__ a_out, int n_rows,
                    int k, int rows, int tile) {
  using Y = Lay<L>;
  constexpr int NPT = Y::NPT;
  __shared__ int sm[2 * LANES];
  Ctx<L> cx(sm);
  const int row = Y::row();
  if (row >= n_rows) return;
  const bool live = (row % tile) < rows;
  const int aj = Y::lane() & 3;
  int v[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) v[j] = p_in[(size_t)row * LANES + Y::cell(j)];
  int ag = a_in ? a_in[(size_t)row * AGENTS + aj] : 0;

  if (live) {
    for (int i = 0; i < k; ++i) {
      if constexpr (OP == R_SUMRED) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          unsigned part = 0;
#pragma unroll
          for (int j = 0; j < NPT; ++j) part += (unsigned)v[j];
          const unsigned r = row_reduce<OpAdd>(cx, part);
#pragma unroll
          for (int j = 0; j < NPT; ++j) v[j] = (int)((unsigned)v[j] + r);
        }
      } else if constexpr (OP == R_AXIS1_ANY) {
        ag += row_any(cx, (ag & 7) == 7) ? 1 : 2;
      } else if constexpr (OP == R_PACKED_SUM) {
        int pos[AGENTS];
#pragma unroll
        for (int a = 0; a < AGENTS; ++a) pos[a] = ag_get(cx, ag, a) & 127;
        int part = 0;
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          const int c = Y::cell(j);
          int w = 0;
#pragma unroll
          for (int a = 0; a < AGENTS; ++a) w += (c == pos[a] ? 1 : 0) << (5 * a);
          part += (v[j] & 15) * w;
        }
        const int red = row_reduce<OpAdd>(cx, part);
        ag += (red >> (5 * aj)) & 31;
      } else if constexpr (OP == R_MIN_RED4) {
#pragma unroll
        for (int a = 0; a < AGENTS; ++a) {
          int part = 999;
#pragma unroll
          for (int j = 0; j < NPT; ++j) {
            const int cand = (v[j] & (1 << a)) != 0 ? Y::cell(j) : 999;
            part = cand < part ? cand : part;
          }
          const int m = row_reduce<OpMin>(cx, part);
          ag += m & (1 << a);
        }
      } else if constexpr (OP == R_ONEHOT_RD) {
#pragma unroll
        for (int a = 0; a < AGENTS; ++a) {
          const int pos = ag_get(cx, ag, a);
          int part = 0;
#pragma unroll
          for (int j = 0; j < NPT; ++j) {
            const int cand = Y::cell(j) == pos ? v[j] : 0;
            part = cand > part ? cand : part;
          }
          const int m = row_reduce<OpMax>(cx, part);
          if (aj == a) ag = m & 0xFF;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NPT; ++j) p_out[(size_t)row * LANES + Y::cell(j)] = v[j];
  if (a_out && Y::lane() < AGENTS) a_out[(size_t)row * AGENTS + aj] = ag;
}

// Reductions over a whole tile of 128 rows (jnp.any over the block): one
// tile per 1024-thread CTA, 16 cells per thread.  L_CTA reduces with the
// barrier's own OR; L_WARP votes within each warp and combines the 32 warp
// flags through shared memory.
template <int L>
__device__ __forceinline__ bool tile_any(bool pred, int* flags) {
  if constexpr (L == L_CTA) return __syncthreads_or(pred) != 0;
  const bool w = __any_sync(FULL, pred) != 0;
  if ((threadIdx.x & 31) == 0) flags[threadIdx.x >> 5] = w;
  __syncthreads();
  const bool hit = __any_sync(FULL, flags[threadIdx.x & 31] != 0) != 0;
  __syncthreads();
  return hit;
}

template <int OP, int L>
__global__ void __launch_bounds__(TILE_NT)
probe_reduce_tile_kernel(const int32_t* __restrict__ p_in, int32_t* __restrict__ p_out,
                         const int32_t* __restrict__ a_in, int32_t* __restrict__ a_out, int k) {
  __shared__ int flags[32];
  const size_t pbase = (size_t)blockIdx.x * TILE_ROWS * LANES;
  const size_t abase = (size_t)blockIdx.x * TILE_ROWS * AGENTS;
  const int th = threadIdx.x;
  const bool has_ag = th < TILE_ROWS * AGENTS;
  int v[TILE_NPT];
#pragma unroll
  for (int e = 0; e < TILE_NPT; ++e) v[e] = p_in[pbase + th + TILE_NT * e];
  int ag = has_ag ? a_in[abase + th] : 0;
  for (int i = 0; i < k; ++i) {
    if constexpr (OP == R_ANY_PLANE) {
      bool local = false;
#pragma unroll
      for (int e = 0; e < TILE_NPT; ++e) local |= (v[e] & 7) == 7;
      const int inc = tile_any<L>(local, flags) ? 1 : 2;
#pragma unroll
      for (int e = 0; e < TILE_NPT; ++e) v[e] += inc;
    } else {
      ag += tile_any<L>(has_ag && (ag & 7) == 7, flags) ? 1 : 2;
    }
  }
#pragma unroll
  for (int e = 0; e < TILE_NPT; ++e) p_out[pbase + th + TILE_NT * e] = v[e];
  if (has_ag) a_out[abase + th] = ag;
}

// --- Products ------------------------------------------------------------------------------

// D_DOT:    x f32[n_rows, 128]; 32 x { x = x @ W; x += 1 } per iteration.
// D_DOTRED: x i32[n_rows, 128]; 8 x { r = dot(x & 0xFFFF, W[:, 0]) +
//           (dot(x >> 16, W[:, 0]) << 16); x += r } per iteration, the two
//           dots in f32 (exact below 2^24).
// W f32[128, 128] is copied to shared memory once per CTA.
// Replaces _kernel_dot and _kernel_dotred (sublane).  Bound by f32
// operations (K x 32 products of 128 x 128 per row against 16 MB moved);
// the FMA loop reads W from shared memory, one value per FMA in L_CTA and
// one float4 per four FMAs in L_WARP, with the row's values broadcast from
// shared memory (L_CTA) or by shuffle (L_WARP).  No tensor cores yet.
template <int OP, int L>
__global__ void __launch_bounds__(NT)
probe_dot_kernel(const void* __restrict__ x_in, const float* __restrict__ w,
                 void* __restrict__ x_out, int n_rows, int k, int rows, int tile) {
  using Y = Lay<L>;
  constexpr int NPT = Y::NPT;
  extern __shared__ __align__(16) float ws[];     // D_DOT: W; D_DOTRED: W[:, 0]
  __shared__ int sm[2 * LANES];
  Ctx<L> cx(sm);
  if constexpr (OP == D_DOT) {
    for (int e = threadIdx.x; e < LANES * LANES; e += NT) ws[e] = w[e];
  } else {
    ws[threadIdx.x] = w[threadIdx.x * LANES];
  }
  __syncthreads();
  const int row = Y::row();
  if (row >= n_rows) return;
  const bool live = (row % tile) < rows;

  if constexpr (OP == D_DOT) {
    const float* xin = static_cast<const float*>(x_in);
    float* xout = static_cast<float*>(x_out);
    float v[NPT];
#pragma unroll
    for (int j = 0; j < NPT; ++j) v[j] = xin[(size_t)row * LANES + Y::cell(j)];
    if (live) {
      for (int i = 0; i < k; ++i) {
        for (int n = 0; n < 32; ++n) {
          float acc[NPT];
#pragma unroll
          for (int j = 0; j < NPT; ++j) acc[j] = 0.f;
          if constexpr (L == L_CTA) {
            float* xs = reinterpret_cast<float*>(cx.next());
            xs[threadIdx.x] = v[0];
            __syncthreads();
#pragma unroll 8
            for (int kk = 0; kk < LANES; ++kk)
              acc[0] = fmaf(xs[kk], ws[kk * LANES + threadIdx.x], acc[0]);
          } else {
            const float4* w4 = reinterpret_cast<const float4*>(ws);
            const int t = threadIdx.x & 31;
            for (int src = 0; src < 32; ++src) {
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const float xk = __shfl_sync(FULL, v[c], src);
                const float4 wv = w4[(4 * src + c) * (LANES / 4) + t];
                acc[0] = fmaf(xk, wv.x, acc[0]);
                acc[1] = fmaf(xk, wv.y, acc[1]);
                acc[2] = fmaf(xk, wv.z, acc[2]);
                acc[3] = fmaf(xk, wv.w, acc[3]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < NPT; ++j) v[j] = acc[j] + 1.0f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NPT; ++j) xout[(size_t)row * LANES + Y::cell(j)] = v[j];
  } else {
    const int32_t* xin = static_cast<const int32_t*>(x_in);
    int32_t* xout = static_cast<int32_t*>(x_out);
    int v[NPT];
    float wc[NPT];
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      v[j] = xin[(size_t)row * LANES + Y::cell(j)];
      wc[j] = ws[Y::cell(j)];
    }
    if (live) {
      for (int i = 0; i < k; ++i) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          float lo = 0.f, hi = 0.f;
#pragma unroll
          for (int j = 0; j < NPT; ++j) {
            lo = fmaf((float)(v[j] & 0xFFFF), wc[j], lo);
            hi = fmaf((float)(v[j] >> 16), wc[j], hi);
          }
          lo = row_reduce<OpAdd>(cx, lo);
          hi = row_reduce<OpAdd>(cx, hi);
          const unsigned r = (unsigned)(int)lo + ((unsigned)(int)hi << 16);
#pragma unroll
          for (int j = 0; j < NPT; ++j) v[j] = (int)((unsigned)v[j] + r);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NPT; ++j) xout[(size_t)row * LANES + Y::cell(j)] = v[j];
  }
}

// --- Launchers -----------------------------------------------------------------------------

template <int L>
static int row_grid(int n_rows) {
  return (n_rows + Lay<L>::ROWS_PER_CTA - 1) / Lay<L>::ROWS_PER_CTA;
}

constexpr int ERR_BAD_ARGUMENT = 1;   // cudaErrorInvalidValue

template <int OP, typename T>
static int launch_elem(int layout, const void* in, void* out, int n_rows, int width, int k,
                       int rows, int tile, cudaStream_t s) {
  if (layout == L_CTA)
    probe_elem_kernel<OP, L_CTA, T><<<row_grid<L_CTA>(n_rows), NT, 0, s>>>(
        (const T*)in, (T*)out, n_rows, width, k, rows, tile);
  else
    probe_elem_kernel<OP, L_WARP, T><<<row_grid<L_WARP>(n_rows), NT, 0, s>>>(
        (const T*)in, (T*)out, n_rows, width, k, rows, tile);
  return (int)cudaGetLastError();
}

template <int OP, typename T>
static int launch_shift(int layout, const void* p_in, void* p_out, const int32_t* a_in,
                        int32_t* a_out, int n_rows, int k, int rows, int tile, cudaStream_t s) {
  if (layout == L_CTA)
    probe_shift_kernel<OP, L_CTA, T><<<row_grid<L_CTA>(n_rows), NT, 0, s>>>(
        (const T*)p_in, (T*)p_out, a_in, a_out, n_rows, k, rows, tile);
  else
    probe_shift_kernel<OP, L_WARP, T><<<row_grid<L_WARP>(n_rows), NT, 0, s>>>(
        (const T*)p_in, (T*)p_out, a_in, a_out, n_rows, k, rows, tile);
  return (int)cudaGetLastError();
}

template <int OP>
static int launch_reduce(int layout, const int32_t* p_in, int32_t* p_out, const int32_t* a_in,
                         int32_t* a_out, int n_rows, int k, int rows, int tile, cudaStream_t s) {
  if (layout == L_CTA)
    probe_reduce_kernel<OP, L_CTA><<<row_grid<L_CTA>(n_rows), NT, 0, s>>>(
        p_in, p_out, a_in, a_out, n_rows, k, rows, tile);
  else
    probe_reduce_kernel<OP, L_WARP><<<row_grid<L_WARP>(n_rows), NT, 0, s>>>(
        p_in, p_out, a_in, a_out, n_rows, k, rows, tile);
  return (int)cudaGetLastError();
}

template <int OP>
static int launch_tile(int layout, const int32_t* p_in, int32_t* p_out, const int32_t* a_in,
                       int32_t* a_out, int n_rows, int k, cudaStream_t s) {
  if (n_rows % TILE_ROWS != 0 || !a_in || !a_out) return ERR_BAD_ARGUMENT;
  const int grid = n_rows / TILE_ROWS;
  if (layout == L_CTA)
    probe_reduce_tile_kernel<OP, L_CTA><<<grid, TILE_NT, 0, s>>>(p_in, p_out, a_in, a_out, k);
  else
    probe_reduce_tile_kernel<OP, L_WARP><<<grid, TILE_NT, 0, s>>>(p_in, p_out, a_in, a_out, k);
  return (int)cudaGetLastError();
}

template <int OP, int L>
static int launch_dot_l(const void* x_in, const float* w, void* x_out, int n_rows, int k,
                        int rows, int tile, cudaStream_t s) {
  const int smem = (OP == D_DOT ? LANES * LANES : LANES) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(probe_dot_kernel<OP, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  probe_dot_kernel<OP, L><<<row_grid<L>(n_rows), NT, smem, s>>>(x_in, w, x_out, n_rows, k, rows,
                                                                  tile);
  return (int)cudaGetLastError();
}

template <int OP>
static int launch_dot(int layout, const void* x_in, const float* w, void* x_out, int n_rows,
                      int k, int rows, int tile, cudaStream_t s) {
  return layout == L_CTA ? launch_dot_l<OP, L_CTA>(x_in, w, x_out, n_rows, k, rows, tile, s)
                         : launch_dot_l<OP, L_WARP>(x_in, w, x_out, n_rows, k, rows, tile, s);
}

}  // namespace pomcpp_probes

extern "C" {

using namespace pomcpp_probes;

// elem_size: bytes per element (4, 2 or 1); narrow types exist for E_CHAIN only.
int pomcpp_probe_elem(int op, int layout, int elem_size, const void* in, void* out, int n_rows,
                      int width, int k, int rows, int tile, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (layout != L_CTA && layout != L_WARP) return ERR_BAD_ARGUMENT;
  if (width < 1 || width > LANES || tile < 1) return ERR_BAD_ARGUMENT;
  if (elem_size != 4 && op != E_CHAIN) return ERR_BAD_ARGUMENT;
#define ELEM(OP, T) return launch_elem<OP, T>(layout, in, out, n_rows, width, k, rows, tile, s)
  switch (op) {
    case E_ELEM: ELEM(E_ELEM, int32_t);
    case E_CHAIN:
      if (elem_size == 4) ELEM(E_CHAIN, int32_t);
      if (elem_size == 2) ELEM(E_CHAIN, int16_t);
      if (elem_size == 1) ELEM(E_CHAIN, int8_t);
      return ERR_BAD_ARGUMENT;
    case E_BASELINE: ELEM(E_BASELINE, int32_t);
    case E_COND_FALSE: ELEM(E_COND_FALSE, int32_t);
    case E_COND_TRUE: ELEM(E_COND_TRUE, int32_t);
    case E_WHILE2: ELEM(E_WHILE2, int32_t);
  }
#undef ELEM
  return ERR_BAD_ARGUMENT;
}

// Narrow planes exist for S_ROLL2 only; a_in / a_out may be null for the
// plane-only probes (S_ROLL, S_ROLL2).
int pomcpp_probe_shift(int op, int layout, int elem_size, const void* p_in, void* p_out,
                       const int32_t* a_in, int32_t* a_out, int n_rows, int k, int rows,
                       int tile, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (layout != L_CTA && layout != L_WARP) return ERR_BAD_ARGUMENT;
  if (tile < 1 || (elem_size != 4 && op != S_ROLL2)) return ERR_BAD_ARGUMENT;
#define SHIFT(OP, T) \
  return launch_shift<OP, T>(layout, p_in, p_out, a_in, a_out, n_rows, k, rows, tile, s)
  switch (op) {
    case S_ROLL: SHIFT(S_ROLL, int32_t);
    case S_ROLL2:
      if (elem_size == 4) SHIFT(S_ROLL2, int32_t);
      if (elem_size == 2) SHIFT(S_ROLL2, int16_t);
      if (elem_size == 1) SHIFT(S_ROLL2, int8_t);
      return ERR_BAD_ARGUMENT;
    case S_PUSH: SHIFT(S_PUSH, int32_t);
    case S_PUSH_HOIST: SHIFT(S_PUSH_HOIST, int32_t);
    case S_PREFIX_OR: SHIFT(S_PREFIX_OR, int32_t);
    case S_WHOLE4: SHIFT(S_WHOLE4, int32_t);
    case S_ROT4: SHIFT(S_ROT4, int32_t);
    case S_COLSLICE: SHIFT(S_COLSLICE, int32_t);
  }
#undef SHIFT
  return ERR_BAD_ARGUMENT;
}

int pomcpp_probe_reduce(int op, int layout, const int32_t* p_in, int32_t* p_out,
                        const int32_t* a_in, int32_t* a_out, int n_rows, int k, int rows,
                        int tile, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (layout != L_CTA && layout != L_WARP) return ERR_BAD_ARGUMENT;
  if (tile < 1) return ERR_BAD_ARGUMENT;
#define REDUCE(OP) \
  return launch_reduce<OP>(layout, p_in, p_out, a_in, a_out, n_rows, k, rows, tile, s)
  switch (op) {
    case R_SUMRED: REDUCE(R_SUMRED);
    case R_AXIS1_ANY: REDUCE(R_AXIS1_ANY);
    case R_PACKED_SUM: REDUCE(R_PACKED_SUM);
    case R_MIN_RED4: REDUCE(R_MIN_RED4);
    case R_ONEHOT_RD: REDUCE(R_ONEHOT_RD);
    case R_ANY_PLANE: return launch_tile<R_ANY_PLANE>(layout, p_in, p_out, a_in, a_out, n_rows, k, s);
    case R_ANY4: return launch_tile<R_ANY4>(layout, p_in, p_out, a_in, a_out, n_rows, k, s);
  }
#undef REDUCE
  return ERR_BAD_ARGUMENT;
}

int pomcpp_probe_dot(int op, int layout, const void* x_in, const float* w, void* x_out,
                     int n_rows, int k, int rows, int tile, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (layout != L_CTA && layout != L_WARP) return ERR_BAD_ARGUMENT;
  if (tile < 1) return ERR_BAD_ARGUMENT;
  switch (op) {
    case D_DOT: return launch_dot<D_DOT>(layout, x_in, w, x_out, n_rows, k, rows, tile, s);
    case D_DOTRED: return launch_dot<D_DOTRED>(layout, x_in, w, x_out, n_rows, k, rows, tile, s);
  }
  return ERR_BAD_ARGUMENT;
}

const char* pomcpp_probes_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
