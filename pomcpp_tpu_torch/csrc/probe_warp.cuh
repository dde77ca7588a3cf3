// The probes' op patterns and their designs for the card (layout="warp";
// any_plane's is probes.cu's tile kernel, dot's the tensor cores), included
// by probes.cu.  Nothing here synchronises a CTA: the tests' host build
// (csrc/host_emu) runs these kernels' own source on the CPU through a small
// C binding, and counts each lane's shuffles and warp reductions.  The
// reduce family and dotred are described where their kernels begin.
//
// probe_elem_dense_kernel replaces the elementwise bodies of
// scripts/microbench_sublane.py (_kernel_elem :37), microbench_layout.py
// (_kernel), microbench_i16.py (chain) and the baseline / cond_* / while_2it
// patterns of microbench_patterns.py and microbench_reductions.py.  A chain
// has no exchange, so the row structure only decides which elements are
// live: the array is flattened and each thread takes EPT consecutive
// elements (one 16-byte access for int32), whatever the row width.  The
// grid covers rows x width elements, so the cost follows the element count
// (the TPU pads a row to 128 lanes; the card need not).  Bound by integer
// issue: a thread's EPT chains are independent, which keeps the issue slots
// of a scheduler busy with few warps.
//
// probe_shift_warp_kernel replaces _kernel_roll (sublane :51), the i16
// script's roll, and push, push_hoist and prefix_or of the patterns and
// reductions scripts: one 128-lane row per warp, lane t holding cells
// 4t..4t+3 (the engine's layout, step_warp.cuh).  A roll shuffles only the
// cells whose source lies in another lane's four: roll<1> is one shuffle
// and three register moves, roll<117> (the cell 11 below) four.  prefix_or
// is a warp scan: a lane's own four cells, five __shfl_up_sync rounds of
// the lane totals, then the carry from the lanes below -- the same function
// as the Pallas body's seven doubling rounds over 128 lanes, bit for bit,
// since OR is associative and idempotent.  Bound by the shuffles (32 lanes
// a clock per SM) or by integer issue.
//
// probe_shift_agents_kernel serves whole4, rot4_all and colslice, which
// work on the [R, 4] agent array: a row's four agents sit in one lane's
// registers as an int4, so a rotation is a register permutation and no
// value crosses a lane.  32 rows a warp, lane t owning row t; the warp
// copies its 32 rows' planes through with 16-byte accesses.  Bound by the
// bytes of the plane copy.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

// A kernel launch.  The tests' host build (csrc/host_emu/cuda_runtime.h)
// defines it as a loop over the grid's warps on the CPU.
#ifndef POMCPP_LAUNCH
#define POMCPP_LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<(grid), (block), 0, (cudaStream_t)(stream)>>>(__VA_ARGS__)
#endif

namespace pomcpp_probes {

constexpr int LANES = 128;
constexpr int NT = 128;          // threads per CTA of the row kernels
constexpr int AGENTS = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ERR_BAD_ARGUMENT = 1;   // cudaErrorInvalidValue

enum Layout { L_CTA = 0, L_WARP = 1 };

enum ElemOp { E_ELEM = 0, E_CHAIN, E_BASELINE, E_COND_FALSE, E_COND_TRUE, E_WHILE2 };
enum ShiftOp { S_ROLL = 0, S_ROLL2, S_PUSH, S_PUSH_HOIST, S_PREFIX_OR, S_WHOLE4, S_ROT4,
               S_COLSLICE };
enum ReduceOp { R_SUMRED = 0, R_AXIS1_ANY, R_PACKED_SUM, R_MIN_RED4, R_ONEHOT_RD, R_ANY_PLANE,
                R_ANY4 };
enum DotOp { D_DOT = 0, D_DOTRED };

constexpr int TILE_ROWS = 128;   // rows of a tile reduction (any_plane, any4)

// --- The op patterns, shared by both layouts --------------------------------------

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

// One loop iteration of an elementwise pattern on one element.
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

__device__ __forceinline__ bool push_ok_down(int c) {   // _push(plane, 1)
  return (c / 11 + 1 < 11) && c < 121;
}
__device__ __forceinline__ bool push_ok_right(int c) {  // _push(plane, 3)
  return (c % 11 - 1 >= 0) && c < 121;
}

// Calls f(op, T{}) with op a std::integral_constant for each (op, element
// size) that exists; narrow types exist for E_CHAIN only.
template <typename F>
int elem_case(int op, int elem_size, int width, int tile, F&& f) {
  using std::integral_constant;
  if (width < 1 || width > LANES || tile < 1) return ERR_BAD_ARGUMENT;
  if (elem_size != 4 && op != E_CHAIN) return ERR_BAD_ARGUMENT;
  switch (op) {
    case E_ELEM: return f(integral_constant<int, E_ELEM>{}, int32_t{});
    case E_CHAIN:
      if (elem_size == 4) return f(integral_constant<int, E_CHAIN>{}, int32_t{});
      if (elem_size == 2) return f(integral_constant<int, E_CHAIN>{}, int16_t{});
      if (elem_size == 1) return f(integral_constant<int, E_CHAIN>{}, int8_t{});
      return ERR_BAD_ARGUMENT;
    case E_BASELINE: return f(integral_constant<int, E_BASELINE>{}, int32_t{});
    case E_COND_FALSE: return f(integral_constant<int, E_COND_FALSE>{}, int32_t{});
    case E_COND_TRUE: return f(integral_constant<int, E_COND_TRUE>{}, int32_t{});
    case E_WHILE2: return f(integral_constant<int, E_WHILE2>{}, int32_t{});
  }
  return ERR_BAD_ARGUMENT;
}

// The same for the shift ops; narrow planes exist for S_ROLL2 only.
template <typename F>
int shift_case(int op, int elem_size, int tile, F&& f) {
  using std::integral_constant;
  if (tile < 1 || (elem_size != 4 && op != S_ROLL2)) return ERR_BAD_ARGUMENT;
  switch (op) {
    case S_ROLL: return f(integral_constant<int, S_ROLL>{}, int32_t{});
    case S_ROLL2:
      if (elem_size == 4) return f(integral_constant<int, S_ROLL2>{}, int32_t{});
      if (elem_size == 2) return f(integral_constant<int, S_ROLL2>{}, int16_t{});
      if (elem_size == 1) return f(integral_constant<int, S_ROLL2>{}, int8_t{});
      return ERR_BAD_ARGUMENT;
    case S_PUSH: return f(integral_constant<int, S_PUSH>{}, int32_t{});
    case S_PUSH_HOIST: return f(integral_constant<int, S_PUSH_HOIST>{}, int32_t{});
    case S_PREFIX_OR: return f(integral_constant<int, S_PREFIX_OR>{}, int32_t{});
    case S_WHOLE4: return f(integral_constant<int, S_WHOLE4>{}, int32_t{});
    case S_ROT4: return f(integral_constant<int, S_ROT4>{}, int32_t{});
    case S_COLSLICE: return f(integral_constant<int, S_COLSLICE>{}, int32_t{});
  }
  return ERR_BAD_ARGUMENT;
}

namespace pw {

constexpr int EPT = 4;                 // elements per thread of the elem kernel
constexpr int ROWS_PER_CTA = NT / 32;  // plane rows of the shift kernel's CTA
constexpr int AGENT_ROWS = 32;         // agent rows a warp
constexpr int COPY_BATCH = 16;         // 16-byte plane loads in flight a lane

// EPT consecutive elements, one access of 4 x sizeof(T) bytes.
template <typename T>
struct alignas(EPT * sizeof(T)) Quad {
  T v[EPT];
};

// --- Elementwise chains: a dense element mapping -----------------------------------

// x: [n_rows, width] flattened to n elements; element e is live when its row
// e / width is among the first `rows` of its `tile`.  `vec`: both pointers
// are aligned to a Quad.
template <int OP, typename T>
__global__ void __launch_bounds__(NT)
probe_elem_dense_kernel(const T* __restrict__ in, T* __restrict__ out, long long n, int width,
                        int k, int rows, int tile, int vec) {
  const long long base = ((long long)blockIdx.x * NT + threadIdx.x) * EPT;
  if (base >= n) return;
  const bool whole = vec && base + EPT <= n;
  T y[EPT];
  if (whole) {
    const Quad<T> q = *reinterpret_cast<const Quad<T>*>(in + base);
#pragma unroll
    for (int j = 0; j < EPT; ++j) y[j] = q.v[j];
  } else {
#pragma unroll
    for (int j = 0; j < EPT; ++j) y[j] = base + j < n ? in[base + j] : (T)0;
  }
  bool live[EPT], any = false;
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const long long e = base + j;
    live[j] = e < n && (rows >= tile || (int)((e / width) % tile) < rows);
    any |= live[j];
  }
  if (any) {
    if constexpr (OP == E_ELEM) {
      // Two iterations of the EPT chains in one loop body: without it nvcc
      // schedules the four chains with an add more a round (6.05
      // instructions a round against 5; 1.34 against 1.09 ms on the H100).
#pragma unroll 2
      for (int i = 0; i < k; ++i) {
#pragma unroll
        for (int j = 0; j < EPT; ++j) y[j] = elem_body<OP, T>(y[j], i);
      }
    } else {
      // nvcc folds the cond_*, while_2it and i8 chain loops to their closed
      // forms (x, x + k, x + 2k, x & 0x7F), which it does not once unrolled.
      for (int i = 0; i < k; ++i) {
#pragma unroll
        for (int j = 0; j < EPT; ++j) y[j] = elem_body<OP, T>(y[j], i);
      }
    }
#pragma unroll
    for (int j = 0; j < EPT; ++j)   // a row that is not live is copied
      if (!live[j] && base + j < n) y[j] = in[base + j];
  }
  if (whole) {
    Quad<T> q;
#pragma unroll
    for (int j = 0; j < EPT; ++j) q.v[j] = y[j];
    *reinterpret_cast<Quad<T>*>(out + base) = q;
  } else {
#pragma unroll
    for (int j = 0; j < EPT; ++j)
      if (base + j < n) out[base + j] = y[j];
  }
}

// --- Plane rows: one row per warp, shuffles only across lane groups -----------------

// Circular roll along the row, out[c] = in[(c - S) mod 128], pad lanes
// included: cell 4t + j reads cell 4(t - q) + j - r, in the lane's own
// registers when q == 0 and j >= r, else from lane t - q (or t - q - 1)
// mod 32 by one shuffle.
template <int S>
__device__ __forceinline__ void roll(int (&v)[4]) {
  constexpr int q = S / 4, r = S % 4;
  const int t = threadIdx.x & 31;
  int o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (q == 0 && j >= r)
      o[j] = v[(j - r) & 3];
    else
      o[j] = __shfl_sync(FULL, v[(j - r) & 3], (t - q - (j < r ? 1 : 0)) & 31);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = o[j];
}

// Inclusive prefix OR over the row's 128 cells, in place.
__device__ __forceinline__ void prefix_or(int (&p)[4]) {
  const int t = threadIdx.x & 31;
  int incl = p[0] | p[1] | p[2] | p[3], excl = 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int s = __shfl_up_sync(FULL, incl, d);
    if (t >= d) {
      excl |= s;
      incl |= s;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) p[j] = excl = excl | p[j];
}

// A value of a narrow plane type, held in an int register, wrapped to the
// type after an op that can leave its range (an add); a shuffle or a logic
// op of wrapped values needs no wrap.
template <typename T>
__device__ __forceinline__ int wrap(int x) {
  return (int)(T)x;
}

template <int OP, typename T>
__device__ __forceinline__ void plane_body(int (&v)[4], int i, const bool (&ok1)[4],
                                           const bool (&ok3)[4]) {
  if constexpr (OP == S_ROLL) {
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      roll<1>(v);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = wrap<T>((int)((unsigned)v[j] + (unsigned)i));
    }
  } else if constexpr (OP == S_ROLL2) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      int r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = v[j];
      roll<1>(r);
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = v[j] = wrap<T>((int)((unsigned)v[j] + (unsigned)r[j]));
      roll<117>(r);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] ^= r[j];
    }
  } else if constexpr (OP == S_PUSH || OP == S_PUSH_HOIST) {
    int r1[4], r3[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) r1[j] = r3[j] = v[j];
    roll<117>(r1);   // (-11) mod 128: the cell below
    roll<1>(r3);     // the cell to the left
    const int t = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool o1 = OP == S_PUSH ? push_ok_down(4 * t + j) : ok1[j];
      const bool o3 = OP == S_PUSH ? push_ok_right(4 * t + j) : ok3[j];
      v[j] = wrap<T>((int)((unsigned)(o1 ? r1[j] : 0) + (unsigned)(o3 ? r3[j] : 0) + (unsigned)i));
    }
  } else if constexpr (OP == S_PREFIX_OR) {
    int p[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = v[j];
    prefix_or(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] ^= p[j];
  }
}

// plane: [n_rows, 128] of T; agents: [n_rows, 4] int32 or null, copied.
// `vec`: the plane pointers are aligned to a Quad.
template <int OP, typename T>
__global__ void __launch_bounds__(NT)
probe_shift_warp_kernel(const T* __restrict__ p_in, T* __restrict__ p_out,
                        const int32_t* __restrict__ a_in, int32_t* __restrict__ a_out,
                        int n_rows, int k, int rows, int tile, int vec) {
  const int row = blockIdx.x * ROWS_PER_CTA + (threadIdx.x >> 5);
  if (row >= n_rows) return;   // uniform per warp
  const int t = threadIdx.x & 31;
  const size_t at = (size_t)row * LANES + 4 * t;
  int v[4];
  if (vec) {
    const Quad<T> q = *reinterpret_cast<const Quad<T>*>(p_in + at);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = q.v[j];
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = p_in[at + j];
  }
  if (a_in && t < AGENTS) a_out[(size_t)row * AGENTS + t] = a_in[(size_t)row * AGENTS + t];
  bool ok1[4], ok3[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ok1[j] = push_ok_down(4 * t + j);
    ok3[j] = push_ok_right(4 * t + j);
  }
  if ((row % tile) < rows) {
    for (int i = 0; i < k; ++i) plane_body<OP, T>(v, i, ok1, ok3);
  }
  if (vec) {
    Quad<T> q;
#pragma unroll
    for (int j = 0; j < 4; ++j) q.v[j] = (T)v[j];
    *reinterpret_cast<Quad<T>*>(p_out + at) = q;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) p_out[at + j] = (T)v[j];
  }
}

// --- Agent rows: a row's four agents in one lane ------------------------------------

template <int OP>
__device__ __forceinline__ void agent_body(int (&a)[4], int i) {
  if constexpr (OP == S_WHOLE4) {
    int b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = (a[j] == a[(j + 1) & 3] ? a[j] + 1 : a[j] - 1) ^ i;
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = (b[j] > b[(j + 2) & 3] ? b[j] : b[(j + 2) & 3]) + i;
  } else if constexpr (OP == S_ROT4) {
    bool all = true;
#pragma unroll
    for (int j = 0; j < 4; ++j) all = all && (a[j] & 7) != 7;
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] += all ? 1 : 2;
  } else if constexpr (OP == S_COLSLICE) {
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = (a[j] > 2 ? a[j] - 2 : a[j] + 1) ^ i;
  }
}

// Four consecutive int32 values at p: one 16-byte access when `vec`.
__device__ __forceinline__ void load4(const int32_t* p, int vec, int (&v)[4]) {
  if (vec) {
    const int4 q = *reinterpret_cast<const int4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = p[j];
  }
}

__device__ __forceinline__ void store4(int32_t* p, int vec, const int (&v)[4]) {
  if (vec) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = v[j];
  }
}

// A warp copies the planes of its nr <= 32 rows from src to dst: row m's
// 16-byte piece t by lane t, 512 bytes an access, or element by element
// where `vec` is 0.  `keep`, if given, receives a copy too, row m at
// m * KEEP_STRIDE.
constexpr int KEEP_STRIDE = LANES + 1;   // a row's shared copy starts one bank on

__device__ __forceinline__ void copy_planes(const int32_t* src, int32_t* dst, int nr, int vec,
                                            int* keep) {
  const int t = threadIdx.x & 31;
  if (vec) {
    constexpr int PIECES = LANES / 4;
    const int4* src4 = reinterpret_cast<const int4*>(src);
    int4* dst4 = reinterpret_cast<int4*>(dst);
    for (int m0 = 0; m0 < nr; m0 += COPY_BATCH) {
      int4 q[COPY_BATCH];
#pragma unroll
      for (int m = 0; m < COPY_BATCH; ++m)
        if (m0 + m < nr) q[m] = src4[(m0 + m) * PIECES + t];
#pragma unroll
      for (int m = 0; m < COPY_BATCH; ++m) {
        if (m0 + m >= nr) continue;
        dst4[(m0 + m) * PIECES + t] = q[m];
        if (keep) {
          int* k = keep + (m0 + m) * KEEP_STRIDE + 4 * t;
          k[0] = q[m].x, k[1] = q[m].y, k[2] = q[m].z, k[3] = q[m].w;
        }
      }
    }
  } else {
    for (int e = t; e < nr * LANES; e += 32) {
      dst[e] = src[e];
      if (keep) keep[(e / LANES) * KEEP_STRIDE + e % LANES] = src[e];
    }
  }
}

// plane, agents: [n_rows, 128] and [n_rows, 4] int32.  The plane is copied
// through unchanged; lane t of a warp runs `body(a, i)` on row t's agents.
// `vec`: all four pointers are 16-byte aligned, else every access is one
// element.
template <typename Body>
__device__ __forceinline__ void agent_rows(const int32_t* __restrict__ p_in,
                                           int32_t* __restrict__ p_out,
                                           const int32_t* __restrict__ a_in,
                                           int32_t* __restrict__ a_out, int n_rows, int k,
                                           int rows, int tile, int vec, Body body) {
  const int first = (blockIdx.x * (NT / 32) + (threadIdx.x >> 5)) * AGENT_ROWS;
  if (first >= n_rows) return;
  const int nr = n_rows - first < AGENT_ROWS ? n_rows - first : AGENT_ROWS;
  copy_planes(p_in + (size_t)first * LANES, p_out + (size_t)first * LANES, nr, vec, nullptr);
  const int row = first + (threadIdx.x & 31);
  if (row >= n_rows) return;
  int a[4];
  load4(a_in + (size_t)row * AGENTS, vec, a);
  if ((row % tile) < rows) {
    for (int i = 0; i < k; ++i) body(a, i);
  }
  store4(a_out + (size_t)row * AGENTS, vec, a);
}

template <int OP>
__global__ void __launch_bounds__(NT)
probe_shift_agents_kernel(const int32_t* __restrict__ p_in, int32_t* __restrict__ p_out,
                          const int32_t* __restrict__ a_in, int32_t* __restrict__ a_out,
                          int n_rows, int k, int rows, int tile, int vec) {
  agent_rows(p_in, p_out, a_in, a_out, n_rows, k, rows, tile, vec,
             [](int (&a)[4], int i) { agent_body<OP>(a, i); });
}

// --- The reduce family ----------------------------------------------------------------
//
// Replaces _kernel_sumred (sublane :163), onehot_rd (patterns) and
// axis1_any, packed_sum, min_red4 and any4 (reductions); any_plane keeps
// probes.cu's tile kernel, whose 16,384 cells a tile need a CTA.
//
// probe_reduce_warp_kernel (sumred, min_red4): one row a warp, cells
// 4t..4t+3 in lane t, a reduction's exchange one redux.sync
// (__reduce_add_sync, __reduce_min_sync) of the lanes' partials and no
// shuffle; the row's four agents in every lane's registers (one 16-byte
// load; their updates are warp-uniform).  Bound by integer issue.
template <int OP>
__global__ void __launch_bounds__(NT)
probe_reduce_warp_kernel(const int32_t* __restrict__ p_in, int32_t* __restrict__ p_out,
                         const int32_t* __restrict__ a_in, int32_t* __restrict__ a_out,
                         int n_rows, int k, int rows, int tile, int vec) {
  const int row = blockIdx.x * ROWS_PER_CTA + (threadIdx.x >> 5);
  if (row >= n_rows) return;   // uniform per warp
  const int t = threadIdx.x & 31;
  const size_t at = (size_t)row * LANES + 4 * t;
  int v[4], a[4] = {0, 0, 0, 0};
  load4(p_in + at, vec, v);
  if (a_in) load4(a_in + (size_t)row * AGENTS, vec, a);
  if ((row % tile) < rows) {
    if constexpr (OP == R_SUMRED) {
      for (int i = 0; i < k; ++i) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          // unsigned: the row sum wraps as the plain version's int32 does.
          const unsigned r = __reduce_add_sync(
              FULL, (unsigned)v[0] + (unsigned)v[1] + (unsigned)v[2] + (unsigned)v[3]);
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = (int)((unsigned)v[j] + r);
        }
      }
    } else if constexpr (OP == R_MIN_RED4) {
      // The plane does not change, so nvcc would hoist the lanes' partials
      // out of the loop; `z`, zero since every minimum lies in [0, 999],
      // comes from the last iteration's minima and keeps the whole
      // reduction in each iteration, as the Pallas body runs it.  A lane's
      // partial is the first of its cells with the bit set: a select chain
      // in cell order, the row's minimum one __reduce_min_sync.
      int z = 0;
      for (int i = 0; i < k; ++i) {
        int inc = 0, m = 0;
#pragma unroll
        for (int b = 0; b < AGENTS; ++b) {
          int part = 999;
#pragma unroll
          for (int j = 3; j >= 0; --j) part = ((v[j] & (1 << b)) | z) != 0 ? 4 * t + j : part;
          m = __reduce_min_sync(FULL, part);
          inc |= m & (1 << b);   // the four terms' bits are disjoint: | is +
        }
        z = m >> 31;
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] += inc;
      }
    }
  }
  store4(p_out + at, vec, v);
  if (a_out && t == 0) store4(a_out + (size_t)row * AGENTS, vec, a);
}

// probe_reduce_agents_kernel (axis1_any): a row's reduction over its four
// agents inside one lane, 32 rows a warp (agent_rows), no exchange.  Bound
// by the bytes of the plane copy.
template <int OP>
__global__ void __launch_bounds__(NT)
probe_reduce_agents_kernel(const int32_t* __restrict__ p_in, int32_t* __restrict__ p_out,
                           const int32_t* __restrict__ a_in, int32_t* __restrict__ a_out,
                           int n_rows, int k, int rows, int tile, int vec) {
  static_assert(OP == R_AXIS1_ANY, "the agent-row reduction is axis1_any's");
  agent_rows(p_in, p_out, a_in, a_out, n_rows, k, rows, tile, vec, [](int (&a)[4], int) {
    const bool hit = ((a[0] & 7) == 7) | ((a[1] & 7) == 7) | ((a[2] & 7) == 7) |
                     ((a[3] & 7) == 7);
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] += hit ? 1 : 2;
  });
}

// probe_any4_warp_kernel (any4): one tile of 128 rows a CTA.  Warp 0 holds
// the tile's 512 agent values, 16 a lane as four int4 (pieces t, t + 32, t +
// 64, t + 96), and an iteration is one __any_sync; warps 1-4 copy 32 rows of
// the plane each.  No CTA barrier: the plane is not read by the agents.
// Bound by the bytes of the plane copy.
constexpr int ANY4_NT = 32 * (1 + TILE_ROWS / AGENT_ROWS);

__global__ void __launch_bounds__(ANY4_NT)
probe_any4_warp_kernel(const int32_t* __restrict__ p_in, int32_t* __restrict__ p_out,
                       const int32_t* __restrict__ a_in, int32_t* __restrict__ a_out, int k,
                       int vec) {
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const size_t first = (size_t)blockIdx.x * TILE_ROWS;
  if (w > 0) {
    const size_t at = (first + (size_t)(w - 1) * AGENT_ROWS) * LANES;
    copy_planes(p_in + at, p_out + at, AGENT_ROWS, vec, nullptr);
    return;
  }
  constexpr int Q = TILE_ROWS * AGENTS / (32 * 4);   // int4 pieces a lane
  const int32_t* src = a_in + first * AGENTS;
  int32_t* dst = a_out + first * AGENTS;
  int a[Q][4];
#pragma unroll
  for (int q = 0; q < Q; ++q) load4(src + 4 * (t + 32 * q), vec, a[q]);
  for (int i = 0; i < k; ++i) {
    bool hit = false;
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) hit |= (a[q][j] & 7) == 7;
    const int inc = __any_sync(FULL, hit) ? 1 : 2;
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[q][j] += inc;
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) store4(dst + 4 * (t + 32 * q), vec, a[q]);
}

// probe_lookup_warp_kernel (onehot_rd, packed_sum): the one-hot reductions
// are lookups of one cell each, which the TPU writes as reductions because
// it cannot gather.  onehot_rd's max over the row of where(lane == a_j, p, 0)
// is max(p[a_j], 0) for 0 <= a_j < 128, else 0; packed_sum's field j of
// sum((p & 15) * w) is p[a_j & 127] & 15, each term below 32 in its own
// 5-bit field.  32 rows a warp, lane t owning row t's agents; the warp
// copies its rows' planes to the output and to 16.5 KB of shared memory of
// its own (one warp a CTA; a row's copy one bank after the last, so that
// lanes reading the same cell of their rows hit 32 banks), then a lookup is
// one shared-memory load.  Bound by the bytes of the plane copy and a
// row's chain of dependent lookups.
template <int OP>
__global__ void __launch_bounds__(32)
probe_lookup_warp_kernel(const int32_t* __restrict__ p_in, int32_t* __restrict__ p_out,
                         const int32_t* __restrict__ a_in, int32_t* __restrict__ a_out,
                         int n_rows, int k, int rows, int tile, int vec) {
  __shared__ int keep[AGENT_ROWS * KEEP_STRIDE];
  const int first = blockIdx.x * AGENT_ROWS;
  const int nr = n_rows - first < AGENT_ROWS ? n_rows - first : AGENT_ROWS;
  copy_planes(p_in + (size_t)first * LANES, p_out + (size_t)first * LANES, nr, vec, keep);
  __syncwarp();
  const int t = threadIdx.x & 31, row = first + t;
  if (row >= n_rows) return;
  int a[4];
  load4(a_in + (size_t)row * AGENTS, vec, a);
  if ((row % tile) < rows) {
    const int* p = keep + t * KEEP_STRIDE;
    for (int i = 0; i < k; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (OP == R_ONEHOT_RD) {
          const int x = p[a[j] & (LANES - 1)];
          a[j] = ((unsigned)a[j] < (unsigned)LANES ? (x > 0 ? x : 0) : 0) & 0xFF;
        } else {
          a[j] += p[a[j] & (LANES - 1)] & 15;
        }
      }
    }
  }
  store4(a_out + (size_t)row * AGENTS, vec, a);
}

// --- dotred ----------------------------------------------------------------------------
//
// probe_dotred_warp_kernel replaces _kernel_dotred (sublane :175): x i32
// [n_rows, 128]; 8 x { r = dot(x & 0xFFFF, W[:, 0]) + (dot(x >> 16, W[:, 0])
// << 16); x += r } per iteration, the dots in f32.  A row over 8 lanes, 16
// consecutive cells a lane (four int4), 4 rows a warp.  The 16-bit halves
// become floats exactly without a conversion instruction (nvcc's is an
// I2FP a half): the bits 0x4B000000 + m are the float 2^23 + m for 0 <= m <
// 2^23, so the low half is one byte permute (x's low bytes under 0x4B00)
// and one FADD of -2^23, and the signed high half one shift-and-add of
// (x >> 16) + 0x4B400000 and one FADD of -(2^23 + 2^22).  Each half is 16
// FFMAs with W[:, 0] inside the lane and three __shfl_xor_sync rounds
// across the row's 8 lanes; the sums go back to integers by the same
// truncating cast as the plain version's.  Exact wherever every partial
// sum is an integer below 2^24, as with the scripts' W of ones.  Bound by
// issue: 7 instructions an element a round.
constexpr int DOT_ROW_LANES = 8;
constexpr int DOT_CELLS = LANES / DOT_ROW_LANES;   // 16 a lane
constexpr int DOT_ROWS_PER_WARP = 32 / DOT_ROW_LANES;

__global__ void __launch_bounds__(NT)
probe_dotred_warp_kernel(const int32_t* __restrict__ xin, const float* __restrict__ w,
                         int32_t* __restrict__ xout, int n_rows, int k, int rows, int tile,
                         int vec) {
  const int first = (blockIdx.x * (NT / 32) + (threadIdx.x >> 5)) * DOT_ROWS_PER_WARP;
  if (first >= n_rows) return;   // uniform per warp
  const int t = threadIdx.x & 31, g = t % DOT_ROW_LANES;
  const int row = first + t / DOT_ROW_LANES;
  const bool valid = row < n_rows;
  const size_t at = (size_t)row * LANES + DOT_CELLS * g;
  int v[DOT_CELLS];
  float wc[DOT_CELLS];
#pragma unroll
  for (int q = 0; q < DOT_CELLS / 4; ++q) {
    int x[4] = {0, 0, 0, 0};
    if (valid) load4(xin + at + 4 * q, vec, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[4 * q + j] = x[j];
  }
#pragma unroll
  for (int c = 0; c < DOT_CELLS; ++c) wc[c] = w[(size_t)(DOT_CELLS * g + c) * LANES];
  const bool live = valid && (row % tile) < rows;
  // The shuffles need every lane: the warp runs the chain if one of its rows
  // is live, and a row that is not is read back from the input below.
  if (__any_sync(FULL, live)) {
    for (int i = 0; i < k; ++i) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float lo = 0.f, hi = 0.f;
#pragma unroll
        for (int c = 0; c < DOT_CELLS; ++c) {
          const float l = __int_as_float(__byte_perm(v[c], 0x4B00, 0x5410)) - 8388608.f;
          const float h = __int_as_float((v[c] >> 16) + 0x4B400000) - 12582912.f;
          lo = fmaf(l, wc[c], lo);
          hi = fmaf(h, wc[c], hi);
        }
#pragma unroll
        for (int m = 1; m < DOT_ROW_LANES; m <<= 1) {
          lo += __shfl_xor_sync(FULL, lo, m);
          hi += __shfl_xor_sync(FULL, hi, m);
        }
        const unsigned r = (unsigned)(int)lo + ((unsigned)(int)hi << 16);
#pragma unroll
        for (int c = 0; c < DOT_CELLS; ++c) v[c] = (int)((unsigned)v[c] + r);
      }
    }
  }
  if (!valid) return;
#pragma unroll
  for (int q = 0; q < DOT_CELLS / 4; ++q) {
    int x[4];
    if (live) {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = v[4 * q + j];
    } else {
      load4(xin + at + 4 * q, vec, x);
    }
    store4(xout + at + 4 * q, vec, x);
  }
}

// --- Launchers ------------------------------------------------------------------------

inline bool aligned(const void* p, size_t bytes) { return ((uintptr_t)p % bytes) == 0; }

// probes.cu's pomcpp_probe_elem for layout="warp".
inline int probe_elem(int op, int elem_size, const void* in, void* out, int n_rows, int width,
                      int k, int rows, int tile, cudaStream_t s) {
  return elem_case(op, elem_size, width, tile, [&](auto o, auto ty) {
    using T = decltype(ty);
    const long long n = (long long)n_rows * width;
    if (n == 0) return (int)cudaSuccess;
    const int vec = aligned(in, sizeof(Quad<T>)) && aligned(out, sizeof(Quad<T>));
    const long long grid = (n + (long long)NT * EPT - 1) / ((long long)NT * EPT);
    const auto kernel = probe_elem_dense_kernel<decltype(o)::value, T>;
    POMCPP_LAUNCH(kernel, (int)grid, NT, s, (const T*)in, (T*)out, n, width, k, rows, tile, vec);
    return (int)cudaGetLastError();
  });
}

// probes.cu's pomcpp_probe_shift for layout="warp"; the agent patterns
// need both arrays.
inline int probe_shift(int op, int elem_size, const void* p_in, void* p_out, const int32_t* a_in,
                       int32_t* a_out, int n_rows, int k, int rows, int tile, cudaStream_t s) {
  return shift_case(op, elem_size, tile, [&](auto o, auto ty) {
    using T = decltype(ty);
    constexpr int OP = decltype(o)::value;
    if (n_rows <= 0) return (int)cudaSuccess;
    if constexpr (OP == S_WHOLE4 || OP == S_ROT4 || OP == S_COLSLICE) {
      if (!a_in || !a_out) return ERR_BAD_ARGUMENT;
      const int vec = aligned(p_in, 16) && aligned(p_out, 16) && aligned(a_in, 16) &&
                      aligned(a_out, 16);
      const int per_cta = AGENT_ROWS * (NT / 32);
      POMCPP_LAUNCH(probe_shift_agents_kernel<OP>, (n_rows + per_cta - 1) / per_cta, NT, s,
                    (const int32_t*)p_in, (int32_t*)p_out, a_in, a_out, n_rows, k, rows, tile,
                    vec);
    } else {
      const int vec = aligned(p_in, sizeof(Quad<T>)) && aligned(p_out, sizeof(Quad<T>));
      const auto kernel = probe_shift_warp_kernel<OP, T>;
      POMCPP_LAUNCH(kernel, (n_rows + ROWS_PER_CTA - 1) / ROWS_PER_CTA, NT, s, (const T*)p_in,
                    (T*)p_out, a_in, a_out, n_rows, k, rows, tile, vec);
    }
    return (int)cudaGetLastError();
  });
}

// probes.cu's pomcpp_probe_reduce for layout="warp", but any_plane (which
// has no warp design of its own: ERR_BAD_ARGUMENT here).  Every op but
// sumred needs both agent arrays; any4 takes whole tiles.
inline int probe_reduce(int op, const int32_t* p_in, int32_t* p_out, const int32_t* a_in,
                        int32_t* a_out, int n_rows, int k, int rows, int tile, cudaStream_t s) {
  if (tile < 1 || op < R_SUMRED || op > R_ANY4 || op == R_ANY_PLANE) return ERR_BAD_ARGUMENT;
  if (op != R_SUMRED && (!a_in || !a_out)) return ERR_BAD_ARGUMENT;
  if (op == R_ANY4 && n_rows % TILE_ROWS != 0) return ERR_BAD_ARGUMENT;
  if (n_rows <= 0) return cudaSuccess;
  const int vec = aligned(p_in, 16) && aligned(p_out, 16) && (!a_in || aligned(a_in, 16)) &&
                  (!a_out || aligned(a_out, 16));
  const int agent_ctas = (n_rows + AGENT_ROWS * (NT / 32) - 1) / (AGENT_ROWS * (NT / 32));
  const int lookup_ctas = (n_rows + AGENT_ROWS - 1) / AGENT_ROWS;
  const int row_ctas = (n_rows + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  switch (op) {
    case R_SUMRED:
      POMCPP_LAUNCH(probe_reduce_warp_kernel<R_SUMRED>, row_ctas, NT, s, p_in, p_out, a_in,
                    a_out, n_rows, k, rows, tile, vec);
      break;
    case R_MIN_RED4:
      POMCPP_LAUNCH(probe_reduce_warp_kernel<R_MIN_RED4>, row_ctas, NT, s, p_in, p_out, a_in,
                    a_out, n_rows, k, rows, tile, vec);
      break;
    case R_AXIS1_ANY:
      POMCPP_LAUNCH(probe_reduce_agents_kernel<R_AXIS1_ANY>, agent_ctas, NT, s, p_in, p_out,
                    a_in, a_out, n_rows, k, rows, tile, vec);
      break;
    case R_ONEHOT_RD:
      POMCPP_LAUNCH(probe_lookup_warp_kernel<R_ONEHOT_RD>, lookup_ctas, 32, s, p_in, p_out,
                    a_in, a_out, n_rows, k, rows, tile, vec);
      break;
    case R_PACKED_SUM:
      POMCPP_LAUNCH(probe_lookup_warp_kernel<R_PACKED_SUM>, lookup_ctas, 32, s, p_in, p_out,
                    a_in, a_out, n_rows, k, rows, tile, vec);
      break;
    case R_ANY4:
      POMCPP_LAUNCH(probe_any4_warp_kernel, n_rows / TILE_ROWS, ANY4_NT, s, p_in, p_out, a_in,
                    a_out, k, vec);
      break;
  }
  return (int)cudaGetLastError();
}

// probes.cu's pomcpp_probe_dot for D_DOTRED and layout="warp".
inline int probe_dotred(const int32_t* x_in, const float* w, int32_t* x_out, int n_rows, int k,
                        int rows, int tile, cudaStream_t s) {
  if (tile < 1 || n_rows < 1) return ERR_BAD_ARGUMENT;
  const int vec = aligned(x_in, 16) && aligned(x_out, 16);
  const int per_cta = DOT_ROWS_PER_WARP * (NT / 32);
  POMCPP_LAUNCH(probe_dotred_warp_kernel, (n_rows + per_cta - 1) / per_cta, NT, s, x_in, w,
                x_out, n_rows, k, rows, tile, vec);
  return (int)cudaGetLastError();
}

}  // namespace pw
}  // namespace pomcpp_probes
