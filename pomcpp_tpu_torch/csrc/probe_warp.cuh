// The probes' op patterns and the elem and shift families' designs for the
// card (layout="warp"), included by probes.cu.  Nothing here synchronises a
// CTA: the tests' host build (csrc/host_emu) runs these kernels' own source
// on the CPU through a small C binding, and counts each lane's shuffles.
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

// plane, agents: [n_rows, 128] and [n_rows, 4] int32.  The plane is copied
// through unchanged.  `vec`: all four pointers are 16-byte aligned, else
// every access is one element.
template <int OP>
__global__ void __launch_bounds__(NT)
probe_shift_agents_kernel(const int32_t* __restrict__ p_in, int32_t* __restrict__ p_out,
                          const int32_t* __restrict__ a_in, int32_t* __restrict__ a_out,
                          int n_rows, int k, int rows, int tile, int vec) {
  const int first = (blockIdx.x * (NT / 32) + (threadIdx.x >> 5)) * AGENT_ROWS;
  if (first >= n_rows) return;
  const int t = threadIdx.x & 31;
  const int nr = n_rows - first < AGENT_ROWS ? n_rows - first : AGENT_ROWS;
  const int32_t* src = p_in + (size_t)first * LANES;
  int32_t* dst = p_out + (size_t)first * LANES;
  if (vec) {
    // The warp's rows' planes: row m's 16-byte piece t, 512 bytes an access.
    constexpr int PIECES = LANES / 4;
    const int4* src4 = reinterpret_cast<const int4*>(src);
    int4* dst4 = reinterpret_cast<int4*>(dst);
    for (int m0 = 0; m0 < nr; m0 += COPY_BATCH) {
      int4 q[COPY_BATCH];
#pragma unroll
      for (int m = 0; m < COPY_BATCH; ++m)
        if (m0 + m < nr) q[m] = src4[(m0 + m) * PIECES + t];
#pragma unroll
      for (int m = 0; m < COPY_BATCH; ++m)
        if (m0 + m < nr) dst4[(m0 + m) * PIECES + t] = q[m];
    }
  } else {
    for (int e = t; e < nr * LANES; e += 32) dst[e] = src[e];
  }
  const int row = first + t;
  if (row >= n_rows) return;
  int a[4];
  if (vec) {
    const int4 in = reinterpret_cast<const int4*>(a_in)[row];
    a[0] = in.x, a[1] = in.y, a[2] = in.z, a[3] = in.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = a_in[(size_t)row * 4 + j];
  }
  if ((row % tile) < rows) {
    for (int i = 0; i < k; ++i) agent_body<OP>(a, i);
  }
  if (vec) {
    reinterpret_cast<int4*>(a_out)[row] = make_int4(a[0], a[1], a[2], a[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) a_out[(size_t)row * 4 + j] = a[j];
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

}  // namespace pw
}  // namespace pomcpp_probes
