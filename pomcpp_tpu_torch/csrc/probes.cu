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
//           __syncthreads (the engine kernels' first layout, since retired,
//           kept as an instrument);
//   L_WARP  the design for the card, the kernels of probe_warp.cuh:
//           elementwise chains over a dense element mapping (the row width
//           does not matter), plane rolls one row per warp with a shuffle
//           only for a value that crosses a lane's four cells, prefix_or as
//           a warp scan, the agent patterns one row per lane; row sums and
//           minima one row per warp on redux.sync, the one-hot reads as
//           shared-memory lookups, any4 one warp a tile, dotred a row over
//           8 lanes.  any_plane keeps the tile kernel below, with a warp
//           vote before its CTA combine.
//
// Four kernel families: probe_elem_kernel (elementwise chains),
// probe_shift_kernel (lane rolls and agent-array rotations),
// probe_reduce_kernel (row reductions; probe_reduce_tile_kernel for the
// reductions over a whole 128-row tile), probe_dot_kernel (`dotred`, the
// one-column f32 products of a row reduction) and probe_dot_tc_kernel
// (`dot`, the chain of f32 matrix products, on the tensor cores).  `rows` /
// `tile` restrict the work to the first `rows` rows of every `tile` rows
// (the other rows are copied), as the sublane script does.  Plain C
// interface at the bottom; pomcpp_tpu_torch/probes.py binds it.

#include <cuda_runtime.h>

#include <cstdint>

#include "probe_warp.cuh"

namespace pomcpp_probes {

constexpr int TILE_NT = 1024;    // threads of the tile kernel
constexpr int TILE_NPT = TILE_ROWS * LANES / TILE_NT;

// --- The CTA layout --------------------------------------------------------------

// One row per CTA, one cell per thread.
struct Cta {
  static constexpr int NPT = 1;            // cells per thread
  __device__ static int row() { return blockIdx.x; }
  __device__ static int cell(int) { return threadIdx.x; }
  __device__ static int lane() { return threadIdx.x; }   // index among a row's threads
};

// Shared memory of the CTA layout: two exchange buffers used in turn, so
// that one barrier per exchange is enough (a thread can be at most one
// exchange ahead of another).
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

// Circular roll along the row: out[c] = in[(c - S) mod 128] (L_CTA).
template <int S, typename T>
__device__ __forceinline__ void roll(Ctx& cx, T (&v)[1]) {
  int* b = cx.next();
  b[threadIdx.x] = (int)v[0];
  __syncthreads();
  v[0] = (T)b[(threadIdx.x - S) & (LANES - 1)];
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
__device__ __forceinline__ V row_reduce(Ctx& cx, V part) {
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

// Agent arrays: every thread of a row holds agent (lane & 3)'s value, so the
// four values are replicated; `ag_get` reads agent `src`'s value (src may
// differ from thread to thread).
__device__ __forceinline__ int ag_get(Ctx& cx, int ag, int src) {
  int* b = cx.next();
  if (threadIdx.x < AGENTS) b[threadIdx.x] = ag;
  __syncthreads();
  return b[src];
}

__device__ __forceinline__ bool row_any(Ctx&, bool pred) {
  return __syncthreads_or(pred) != 0;
}

// --- Elementwise chains ------------------------------------------------------------

// The elem family in the CTA layout: one row per CTA, one cell per thread,
// the threads past the row's width idle (pw::probe_elem_dense_kernel is the
// layout="warp" design).  x: [n_rows, width], width <= 128.
template <int OP, typename T>
__global__ void __launch_bounds__(NT)
probe_elem_kernel(const T* __restrict__ in, T* __restrict__ out, int n_rows, int width, int k,
                  int rows, int tile) {
  using Y = Cta;
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

template <int SH>
__device__ __forceinline__ void prefix_round(Ctx& cx, int (&p)[1]) {
  int r[1] = {p[0]};
  roll<SH>(cx, r);
  p[0] |= (Cta::cell(0) >= SH ? r[0] : 0);
}

// The shift family in the CTA layout (pw::probe_shift_warp_kernel and
// pw::probe_shift_agents_kernel are the layout="warp" designs).  Bound by
// the exchange: a shared-memory store, a barrier and a load per roll; the
// agent patterns read the four values back through shared memory too.
// plane: [n_rows, 128] of T; agents: [n_rows, 4] int32 (may be null).
template <int OP, typename T>
__global__ void __launch_bounds__(NT)
probe_shift_kernel(const T* __restrict__ p_in, T* __restrict__ p_out,
                   const int32_t* __restrict__ a_in, int32_t* __restrict__ a_out, int n_rows,
                   int k, int rows, int tile) {
  using Y = Cta;
  constexpr int NPT = Y::NPT;
  __shared__ int sm[2 * LANES];
  Ctx cx(sm);
  const int row = Y::row();
  if (row >= n_rows) return;   // uniform per CTA
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
        prefix_round<1>(cx, p);
        prefix_round<2>(cx, p);
        prefix_round<4>(cx, p);
        prefix_round<8>(cx, p);
        prefix_round<16>(cx, p);
        prefix_round<32>(cx, p);
        prefix_round<64>(cx, p);
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

// The reduce family in the CTA layout: sumred (sublane), onehot_rd
// (patterns), axis1_any, packed_sum and min_red4 (reductions), each
// reduction a shared-memory tree with a barrier per level (eight barriers a
// reduction), the one-hot reads as the Pallas bodies write them
// (pw::probe_reduce_warp_kernel, probe_reduce_agents_kernel and
// probe_lookup_warp_kernel are the layout="warp" designs).
template <int OP>
__global__ void __launch_bounds__(NT)
probe_reduce_kernel(const int32_t* __restrict__ p_in, int32_t* __restrict__ p_out,
                    const int32_t* __restrict__ a_in, int32_t* __restrict__ a_out, int n_rows,
                    int k, int rows, int tile) {
  using Y = Cta;
  constexpr int NPT = Y::NPT;
  __shared__ int sm[2 * LANES];
  Ctx cx(sm);
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
// barrier's own OR; L_WARP (any_plane's warp design; any4's is
// pw::probe_any4_warp_kernel) votes within each warp and combines the 32
// warp flags through shared memory.
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

// D_DOTRED: x i32[n_rows, 128]; 8 x { r = dot(x & 0xFFFF, W[:, 0]) +
// (dot(x >> 16, W[:, 0]) << 16); x += r } per iteration, the two dots in f32
// (exact below 2^24).  Replaces _kernel_dotred (sublane :175) in the CTA
// layout (pw::probe_dotred_warp_kernel is the layout="warp" design).
// W[:, 0] is copied to shared memory once per CTA; a row's two dots are row
// reductions through shared memory and barriers.
__global__ void __launch_bounds__(NT)
probe_dot_kernel(const int32_t* __restrict__ xin, const float* __restrict__ w,
                 int32_t* __restrict__ xout, int n_rows, int k, int rows, int tile) {
  using Y = Cta;
  constexpr int NPT = Y::NPT;
  __shared__ float wc_all[LANES];
  __shared__ int sm[2 * LANES];
  Ctx cx(sm);
  wc_all[threadIdx.x] = w[threadIdx.x * LANES];
  __syncthreads();
  const int row = Y::row();
  if (row >= n_rows) return;
  const bool live = (row % tile) < rows;
  int v[NPT];
  float wc[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    v[j] = xin[(size_t)row * LANES + Y::cell(j)];
    wc[j] = wc_all[Y::cell(j)];
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

// D_DOT: x f32[n_rows, 128]; 32 x { x = x @ W; x += 1 } per iteration.
// Replaces _kernel_dot / bench_dot (sublane :116, :130); `layout` does not
// apply (the rows are not laid out over threads one by one).
//
// On the tensor cores (wgmma, sm_90a).  A CTA takes a 128-row tile as two
// warpgroups, and each warpgroup owns a 64-row slab of x for the whole
// chain: x lives in the 64 accumulator registers a thread holds of an
// m64n128 f32 product, the `+ 1.0` is applied there, and the accumulator of
// one product is the A operand, in registers, of the next -- x never goes
// back to shared or device memory inside the chain.  W is the B operand,
// resident in shared memory for the whole kernel.
//
// f32 from TF32 pieces (3xTF32): v = hi + lo with hi = tf32(v) and lo =
// tf32(v - hi) (cvt.rna); a product is lo(x) hi(W) + hi(x) lo(W) + hi(x)
// hi(W), accumulated in f32; lo(x) lo(W), 2^-22 of |x||W|, is dropped.
// Exactness on the held inputs (probes.pattern_inputs: x ones or seeded
// integers 0..3, W a 0/1 shift matrix or ones): every value of the chain is
// an integer below 2^13 (a product moves x one lane over and adds 1, so a
// value is at most its start plus 128); TF32 keeps 11 significant bits, so
// hi and lo hold such an integer exactly (lo is 0 below 2^11), every
// product of pieces is exact and every f32 sum of integers below 2^24 is
// exact: the kernel equals probe_dot_plain bit for bit there.  On random
// f32 inputs the dropped term, lo's rounding and the accumulation order
// keep a product within 2^-15 of |x| @ |W| of the exact one.
//
// Fragments (per warp of the warpgroup, lane 4g + t, rows g and g + 8 of
// its 16): the tf32 A operand of m64nNk8 is a0 (g, t), a1 (g + 8, t), a2
// (g, t + 4), a3 (g + 8, t + 4); the accumulator holds (g, 8c + 2t), (g, 8c
// + 2t + 1), (g + 8, 8c + 2t), (g + 8, 8c + 2t + 1) as d[4c .. 4c + 3].  The
// accumulator's block c of 8 columns is therefore handed over as the A
// operand of k-block c with no exchange, its columns 2t and 2t + 1 taking
// the k-slots t and t + 4; W's rows are permuted the same way within each
// block of 8 when they are written to shared memory (row 8c + q goes to
// k-slot q / 2 for even q, 4 + q / 2 for odd q), which leaves the product
// unchanged.  B is K-major without swizzle, in core matrices of 8 n x 4 k:
// core matrix (k-quad kq, n-octet no) at byte (16 kq + no) * 128, so the
// leading (K) byte offset is 2048 and the stride (N) byte offset 128.
//
// Bound: the tensor cores -- 3 passes of 32 K products of [16384, 128] x
// [128, 128] at the TF32 dense rate (495 TFLOP/s): 20.8 ms at K = 200.  A
// CTA's 128 KB of W take an SM's shared memory, so an SM holds two slabs,
// and one warpgroup's conversions run beside the other's products.
constexpr int DOT_SLAB = 64;      // rows of x a warpgroup owns
constexpr int DOT_WGS = 2;        // warpgroups of a CTA
constexpr int DOT_NT = 128 * DOT_WGS;
constexpr int DOT_SMEM = 2 * LANES * LANES * (int)sizeof(float);  // W's hi and lo pieces

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// The shared-memory matrix descriptor of B at `p`: no swizzle, leading (K)
// byte offset 2048, stride (N) byte offset 128, both in 16-byte units.
__device__ __forceinline__ uint64_t dot_desc(const float* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFFu) >> 4) | ((uint64_t)(2048 >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// d (+)= A B for one k-block: A from registers, B from shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// Keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous products.
__device__ __forceinline__ void fence_accumulator(float (&d)[64]) {
#pragma unroll
  for (int j = 0; j < 64; ++j) asm volatile("" : "+f"(d[j])::"memory");
}

__global__ void __launch_bounds__(DOT_NT, 1)
probe_dot_tc_kernel(const float* __restrict__ x_in, const float* __restrict__ w,
                    float* __restrict__ x_out, int n_rows, int k, int rows, int tile) {
  extern __shared__ __align__(128) float wsm[];  // hi then lo, each in core-matrix order
  for (int e = threadIdx.x; e < LANES * LANES; e += DOT_NT) {
    const int wr = e / LANES, n = e % LANES, q = wr & 7;
    const int kk = (wr & ~7) + ((q & 1) ? 4 + (q >> 1) : (q >> 1));
    const int off = ((kk >> 2) * 16 + (n >> 3)) * 32 + (n & 7) * 4 + (kk & 3);
    const float v = w[e];
    const uint32_t hi = tf32_rna(v);
    wsm[off] = __uint_as_float(hi);
    wsm[LANES * LANES + off] = __uint_as_float(tf32_rna(v - __uint_as_float(hi)));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // stores -> wgmma reads
  __syncthreads();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int slab = blockIdx.x * DOT_SLAB * DOT_WGS + wg * DOT_SLAB;
  const int r[2] = {slab + 16 * warp + (lane >> 2), slab + 16 * warp + (lane >> 2) + 8};
  const int col = 2 * (lane & 3);
  // The warpgroup skips the chain where its slab holds no live row.
  bool live_slab = false;
  for (int i = slab; i < min(slab + DOT_SLAB, n_rows); ++i) live_slab |= (i % tile) < rows;

  float d[64];
#pragma unroll
  for (int c = 0; c < 16; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 v = make_float2(0.f, 0.f);
      if (r[h] < n_rows) v = *reinterpret_cast<const float2*>(x_in + (size_t)r[h] * LANES + 8 * c + col);
      d[4 * c + 2 * h] = v.x;
      d[4 * c + 2 * h + 1] = v.y;
    }
  }
  if (live_slab) {
    const uint64_t b_hi = dot_desc(wsm), b_lo = dot_desc(wsm + LANES * LANES);
    constexpr uint64_t KBLOCK = 4096 >> 4;  // one k-block of B: 8 k x 128 n
    for (int it = 0; it < 32 * k; ++it) {
      uint32_t ah[16][4], al[16][4];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float a[4] = {d[4 * c], d[4 * c + 2], d[4 * c + 1], d[4 * c + 3]};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ah[c][j] = tf32_rna(a[j]);
          al[c][j] = tf32_rna(a[j] - __uint_as_float(ah[c][j]));
        }
      }
      fence_accumulator(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int c = 0; c < 16; ++c) wgmma_tf32(d, al[c], b_hi + c * KBLOCK, c > 0);
#pragma unroll
      for (int c = 0; c < 16; ++c) wgmma_tf32(d, ah[c], b_lo + c * KBLOCK, 1);
#pragma unroll
      for (int c = 0; c < 16; ++c) wgmma_tf32(d, ah[c], b_hi + c * KBLOCK, 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_accumulator(d);
#pragma unroll
      for (int j = 0; j < 64; ++j) d[j] += 1.0f;
    }
  }
#pragma unroll
  for (int c = 0; c < 16; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r[h] >= n_rows) continue;
      const size_t o = (size_t)r[h] * LANES + 8 * c + col;
      const float2 v = (r[h] % tile) < rows ? make_float2(d[4 * c + 2 * h], d[4 * c + 2 * h + 1])
                                            : *reinterpret_cast<const float2*>(x_in + o);
      *reinterpret_cast<float2*>(x_out + o) = v;
    }
  }
}

// --- Launchers -----------------------------------------------------------------------------


template <int OP, typename T>
static int launch_elem_cta(const void* in, void* out, int n_rows, int width, int k, int rows,
                           int tile, cudaStream_t s) {
  probe_elem_kernel<OP, T><<<n_rows, NT, 0, s>>>((const T*)in, (T*)out, n_rows,
                                                                   width, k, rows, tile);
  return (int)cudaGetLastError();
}

template <int OP, typename T>
static int launch_shift_cta(const void* p_in, void* p_out, const int32_t* a_in, int32_t* a_out,
                            int n_rows, int k, int rows, int tile, cudaStream_t s) {
  probe_shift_kernel<OP, T><<<n_rows, NT, 0, s>>>(
      (const T*)p_in, (T*)p_out, a_in, a_out, n_rows, k, rows, tile);
  return (int)cudaGetLastError();
}

template <int OP>
static int launch_reduce_cta(const int32_t* p_in, int32_t* p_out, const int32_t* a_in,
                             int32_t* a_out, int n_rows, int k, int rows, int tile,
                             cudaStream_t s) {
  probe_reduce_kernel<OP><<<n_rows, NT, 0, s>>>(p_in, p_out, a_in, a_out, n_rows, k,
                                                          rows, tile);
  return (int)cudaGetLastError();
}

// Both layouts of any_plane; any4 in the CTA layout only, so that only
// any_plane instantiates the L_WARP tile kernel.
template <int OP, int L>
static int launch_tile(const int32_t* p_in, int32_t* p_out, const int32_t* a_in,
                       int32_t* a_out, int n_rows, int k, cudaStream_t s) {
  if (n_rows % TILE_ROWS != 0 || !a_in || !a_out) return ERR_BAD_ARGUMENT;
  probe_reduce_tile_kernel<OP, L><<<n_rows / TILE_ROWS, TILE_NT, 0, s>>>(p_in, p_out, a_in,
                                                                          a_out, k);
  return (int)cudaGetLastError();
}

static int launch_dotred_cta(const int32_t* x_in, const float* w, int32_t* x_out, int n_rows,
                             int k, int rows, int tile, cudaStream_t s) {
  probe_dot_kernel<<<n_rows, NT, 0, s>>>(x_in, w, x_out, n_rows, k, rows, tile);
  return (int)cudaGetLastError();
}

static int launch_dot_tc(const float* x_in, const float* w, float* x_out, int n_rows, int k,
                         int rows, int tile, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      probe_dot_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DOT_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_rows + DOT_SLAB * DOT_WGS - 1) / (DOT_SLAB * DOT_WGS);
  probe_dot_tc_kernel<<<grid, DOT_NT, DOT_SMEM, s>>>(x_in, w, x_out, n_rows, k, rows, tile);
  return (int)cudaGetLastError();
}

}  // namespace pomcpp_probes

extern "C" {

using namespace pomcpp_probes;

// elem_size: bytes per element (4, 2 or 1); narrow types exist for E_CHAIN only.
int pomcpp_probe_elem(int op, int layout, int elem_size, const void* in, void* out, int n_rows,
                      int width, int k, int rows, int tile, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (layout == L_WARP)
    return pw::probe_elem(op, elem_size, in, out, n_rows, width, k, rows, tile, s);
  if (layout != L_CTA) return ERR_BAD_ARGUMENT;
  return elem_case(op, elem_size, width, tile, [&](auto o, auto ty) {
    return launch_elem_cta<decltype(o)::value, decltype(ty)>(in, out, n_rows, width, k, rows,
                                                              tile, s);
  });
}

// Narrow planes exist for S_ROLL2 only; a_in / a_out may be null for the
// plane-only probes (S_ROLL, S_ROLL2).
int pomcpp_probe_shift(int op, int layout, int elem_size, const void* p_in, void* p_out,
                       const int32_t* a_in, int32_t* a_out, int n_rows, int k, int rows,
                       int tile, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (layout == L_WARP)
    return pw::probe_shift(op, elem_size, p_in, p_out, a_in, a_out, n_rows, k, rows, tile, s);
  if (layout != L_CTA) return ERR_BAD_ARGUMENT;
  return shift_case(op, elem_size, tile, [&](auto o, auto ty) {
    return launch_shift_cta<decltype(o)::value, decltype(ty)>(p_in, p_out, a_in, a_out, n_rows,
                                                               k, rows, tile, s);
  });
}

int pomcpp_probe_reduce(int op, int layout, const int32_t* p_in, int32_t* p_out,
                        const int32_t* a_in, int32_t* a_out, int n_rows, int k, int rows,
                        int tile, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (layout != L_CTA && layout != L_WARP) return ERR_BAD_ARGUMENT;
  if (tile < 1) return ERR_BAD_ARGUMENT;
  if (op == R_ANY_PLANE)
    return layout == L_CTA
               ? launch_tile<R_ANY_PLANE, L_CTA>(p_in, p_out, a_in, a_out, n_rows, k, s)
               : launch_tile<R_ANY_PLANE, L_WARP>(p_in, p_out, a_in, a_out, n_rows, k, s);
  if (layout == L_WARP)
    return pw::probe_reduce(op, p_in, p_out, a_in, a_out, n_rows, k, rows, tile, s);
#define REDUCE(OP) \
  return launch_reduce_cta<OP>(p_in, p_out, a_in, a_out, n_rows, k, rows, tile, s)
  switch (op) {
    case R_SUMRED: REDUCE(R_SUMRED);
    case R_AXIS1_ANY: REDUCE(R_AXIS1_ANY);
    case R_PACKED_SUM: REDUCE(R_PACKED_SUM);
    case R_MIN_RED4: REDUCE(R_MIN_RED4);
    case R_ONEHOT_RD: REDUCE(R_ONEHOT_RD);
    case R_ANY4: return launch_tile<R_ANY4, L_CTA>(p_in, p_out, a_in, a_out, n_rows, k, s);
  }
#undef REDUCE
  return ERR_BAD_ARGUMENT;
}

// op D_DOT runs on the tensor cores whatever the layout; D_DOTRED in both.
int pomcpp_probe_dot(int op, int layout, const void* x_in, const float* w, void* x_out,
                     int n_rows, int k, int rows, int tile, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (layout != L_CTA && layout != L_WARP) return ERR_BAD_ARGUMENT;
  if (tile < 1 || n_rows < 1) return ERR_BAD_ARGUMENT;
  switch (op) {
    case D_DOT:
      return launch_dot_tc((const float*)x_in, w, (float*)x_out, n_rows, k, rows, tile, s);
    case D_DOTRED: {
      const int32_t* xi = (const int32_t*)x_in;
      int32_t* xo = (int32_t*)x_out;
      return layout == L_CTA ? launch_dotred_cta(xi, w, xo, n_rows, k, rows, tile, s)
                             : pw::probe_dotred(xi, w, xo, n_rows, k, rows, tile, s);
    }
  }
  return ERR_BAD_ARGUMENT;
}

const char* pomcpp_probes_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
