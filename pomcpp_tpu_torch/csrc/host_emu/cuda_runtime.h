// A host stand-in for <cuda_runtime.h>, for the tests only: with this
// directory first on the include path, g++ compiles fused_step.cu as plain
// C++ and the warp-layout chunk kernel runs on the CPU, one warp at a time,
// so that tests/test_torch_csrc.py can hold the kernel's own source against
// the plain PyTorch version where there is no card.  No part of the port
// loads this build; on a CUDA tensor the wrappers launch the nvcc build.
//
// A warp is 32 fibers (ucontext) that run the kernel body in turn.  Every
// *_sync intrinsic is a rendezvous: a lane deposits its operand and yields
// until all 32 lanes have arrived at the SAME kind of intrinsic, then each
// takes its result.  A lane that returns, or a lane that waits at another
// kind of intrinsic, while others wait is the undefined behaviour of a
// full-mask intrinsic under divergence; the emulator reports it
// (cudaErrorLaunchFailure from cudaGetLastError) instead of hanging.
// Between two intrinsics a lane runs alone, far ahead of the others, so a
// missing __syncwarp() around shared memory shows as a wrong result.
// CTA-wide barriers are not emulated: a kernel that reaches one aborts.
// Each lane's shuffles and warp reductions (redux.sync: __reduce_*_sync)
// are counted (emu::warp().shuffles and .reduxes, by lane index, summed over
// every warp run), so a test can hold a kernel to the exchange its design
// claims.
#pragma once

#include <ucontext.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define POMCPP_HOST_EMU 1

using std::abs;
using std::max;
using std::min;

struct uint4 { uint32_t x, y, z, w; };
struct int4 { int x, y, z, w; };
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) { return uint4{x, y, z, w}; }
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }

typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorLaunchFailure = 719;
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : e == cudaErrorInvalidValue ? "invalid argument"
                                                                   : "emulated launch failure";
}

namespace emu {

constexpr int WARP = 32;
enum Kind { K_SHFL, K_UP, K_DOWN, K_XOR, K_BALLOT, K_OR, K_ADD, K_MIN, K_MAX, K_MIN_S, K_MAX_S,
            K_SYNCWARP };

struct Idx { unsigned x, y, z; };

struct Warp {
  ucontext_t sched, lane[WARP];
  std::vector<char> stack[WARP];
  bool finished[WARP];
  int cur = 0, arrived = 0, kind[WARP];
  unsigned gen = 0, progress = 0, in[WARP], aux[WARP], out[WARP];
  Idx tid{0, 0, 0}, bid{0, 0, 0};
  int tid_base = 0;
  const std::function<void()>* body = nullptr;
  int error = cudaSuccess;
  unsigned long long shuffles[WARP] = {};  // __shfl*_sync calls, per lane
  unsigned long long reduxes[WARP] = {};   // __reduce_*_sync calls, per lane
};

inline Warp& warp() {
  static Warp w;
  return w;
}

inline const Idx& thread_idx() {
  Warp& w = warp();
  w.tid.x = (unsigned)(w.tid_base + w.cur);
  return w.tid;
}
inline const Idx& block_idx() { return warp().bid; }

inline void lane_entry() {
  Warp& w = warp();
  (*w.body)();
  w.finished[w.cur] = true;
  ++w.progress;
  swapcontext(&w.lane[w.cur], &w.sched);
}

inline void resolve(Warp& w) {
  const int k = w.kind[0];
  for (int i = 1; i < WARP; ++i)
    if (w.kind[i] != k) w.error = cudaErrorLaunchFailure;
  unsigned ballot = 0, acc_or = 0, acc_add = 0, acc_min = ~0u, acc_max = 0;
  int min_s = INT_MAX, max_s = INT_MIN;
  for (int i = 0; i < WARP; ++i) {
    if (w.in[i]) ballot |= 1u << i;
    acc_or |= w.in[i];
    acc_add += w.in[i];
    acc_min = std::min(acc_min, w.in[i]);
    acc_max = std::max(acc_max, w.in[i]);
    min_s = std::min(min_s, (int)w.in[i]);
    max_s = std::max(max_s, (int)w.in[i]);
  }
  for (int i = 0; i < WARP; ++i) {
    int src = i;
    switch (k) {
      case K_SHFL: src = (int)(w.aux[i] & 31u); break;
      case K_UP: src = i - (int)w.aux[i] >= 0 ? i - (int)w.aux[i] : i; break;
      case K_DOWN: src = i + (int)w.aux[i] < WARP ? i + (int)w.aux[i] : i; break;
      case K_XOR: src = (i ^ (int)w.aux[i]) & 31; break;
      default: break;
    }
    switch (k) {
      case K_BALLOT: w.out[i] = ballot; break;
      case K_OR: w.out[i] = acc_or; break;
      case K_ADD: w.out[i] = acc_add; break;
      case K_MIN: w.out[i] = acc_min; break;
      case K_MAX: w.out[i] = acc_max; break;
      case K_MIN_S: w.out[i] = (unsigned)min_s; break;
      case K_MAX_S: w.out[i] = (unsigned)max_s; break;
      default: w.out[i] = w.in[src]; break;
    }
  }
}

// The rendezvous of one *_sync intrinsic.
inline unsigned collective(int kind, unsigned mask, unsigned v, unsigned a) {
  Warp& w = warp();
  const int me = w.cur;
  if (mask != 0xffffffffu) w.error = cudaErrorLaunchFailure;
  if (kind == K_SHFL || kind == K_UP || kind == K_DOWN || kind == K_XOR) ++w.shuffles[me];
  if (kind == K_OR || kind == K_ADD || kind == K_MIN || kind == K_MAX || kind == K_MIN_S ||
      kind == K_MAX_S)
    ++w.reduxes[me];
  w.in[me] = v;
  w.aux[me] = a;
  w.kind[me] = kind;
  const unsigned my_gen = w.gen;
  ++w.progress;
  if (++w.arrived == WARP) {
    resolve(w);
    w.arrived = 0;
    ++w.gen;
  }
  while (w.gen == my_gen) swapcontext(&w.lane[me], &w.sched);
  return w.out[me];
}

// Run `body` as the 32 lanes of one warp.
inline void run_warp(int block, int tid_base, const std::function<void()>& body) {
  Warp& w = warp();
  w.bid.x = (unsigned)block;
  w.tid_base = tid_base;
  w.body = &body;
  w.arrived = 0;
  for (int i = 0; i < WARP; ++i) {
    if (w.stack[i].empty()) w.stack[i].resize(256 * 1024);
    w.finished[i] = false;
    getcontext(&w.lane[i]);
    w.lane[i].uc_stack.ss_sp = w.stack[i].data();
    w.lane[i].uc_stack.ss_size = w.stack[i].size();
    w.lane[i].uc_link = &w.sched;
    makecontext(&w.lane[i], lane_entry, 0);
  }
  for (;;) {
    const unsigned before = w.progress;
    int running = 0;
    for (int i = 0; i < WARP; ++i) {
      if (w.finished[i]) continue;
      ++running;
      w.cur = i;
      swapcontext(&w.sched, &w.lane[i]);
    }
    if (running == 0) return;
    if (w.progress == before) {  // divergent intrinsic: nobody can move
      w.error = cudaErrorLaunchFailure;
      return;
    }
  }
}

template <typename F>
inline void launch(int grid, int block, F&& kernel_call) {
  const std::function<void()> body = kernel_call;
  for (int b = 0; b < grid && warp().error == cudaSuccess; ++b)
    for (int t = 0; t < block && warp().error == cudaSuccess; t += WARP) run_warp(b, t, body);
}

}  // namespace emu

#define threadIdx (emu::thread_idx())
#define blockIdx (emu::block_idx())

inline cudaError_t cudaGetLastError() {
  const int e = emu::warp().error;
  emu::warp().error = cudaSuccess;
  return e;
}

inline long long clock64() { return 0; }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  const unsigned long long old = *p;
  *p += v;
  return old;
}
template <typename T>
inline cudaError_t cudaMemcpyFromSymbol(void* dst, const T& symbol, size_t n) {
  std::memcpy(dst, &symbol, n);
  return cudaSuccess;
}
template <typename T>
inline cudaError_t cudaMemcpyToSymbol(T& symbol, const void* src, size_t n) {
  std::memcpy(&symbol, src, n);
  return cudaSuccess;
}

// No SM here: the query answers "none resident".
template <typename K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 0;
  return cudaSuccess;
}

inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, sizeof u);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
inline int __float_as_int(float f) { return (int)__float_as_uint(f); }
inline float __int_as_float(int i) { return __uint_as_float((unsigned)i); }

inline int __shfl_sync(unsigned m, int v, int src) {
  return (int)emu::collective(emu::K_SHFL, m, (unsigned)v, (unsigned)src);
}
inline int __shfl_up_sync(unsigned m, int v, unsigned d) {
  return (int)emu::collective(emu::K_UP, m, (unsigned)v, d);
}
inline int __shfl_down_sync(unsigned m, int v, unsigned d) {
  return (int)emu::collective(emu::K_DOWN, m, (unsigned)v, d);
}
inline int __shfl_xor_sync(unsigned m, int v, int lane_mask) {
  return (int)emu::collective(emu::K_XOR, m, (unsigned)v, (unsigned)lane_mask);
}
// The unsigned and float overloads move the value's bits, as the card's do.
inline unsigned __shfl_sync(unsigned m, unsigned v, int src) {
  return emu::collective(emu::K_SHFL, m, v, (unsigned)src);
}
inline unsigned __shfl_xor_sync(unsigned m, unsigned v, int lane_mask) {
  return emu::collective(emu::K_XOR, m, v, (unsigned)lane_mask);
}
inline float __shfl_sync(unsigned m, float v, int src) {
  return __uint_as_float(emu::collective(emu::K_SHFL, m, __float_as_uint(v), (unsigned)src));
}
inline float __shfl_xor_sync(unsigned m, float v, int lane_mask) {
  return __uint_as_float(
      emu::collective(emu::K_XOR, m, __float_as_uint(v), (unsigned)lane_mask));
}
inline unsigned __ballot_sync(unsigned m, int p) {
  return emu::collective(emu::K_BALLOT, m, p != 0, 0);
}
inline int __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
// redux.sync: unsigned and signed overloads, as sm_80's.
inline unsigned __reduce_or_sync(unsigned m, unsigned v) {
  return emu::collective(emu::K_OR, m, v, 0);
}
inline unsigned __reduce_add_sync(unsigned m, unsigned v) {
  return emu::collective(emu::K_ADD, m, v, 0);
}
inline int __reduce_add_sync(unsigned m, int v) {
  return (int)emu::collective(emu::K_ADD, m, (unsigned)v, 0);
}
inline unsigned __reduce_min_sync(unsigned m, unsigned v) {
  return emu::collective(emu::K_MIN, m, v, 0);
}
inline int __reduce_min_sync(unsigned m, int v) {
  return (int)emu::collective(emu::K_MIN_S, m, (unsigned)v, 0);
}
inline unsigned __reduce_max_sync(unsigned m, unsigned v) {
  return emu::collective(emu::K_MAX, m, v, 0);
}
inline int __reduce_max_sync(unsigned m, int v) {
  return (int)emu::collective(emu::K_MAX_S, m, (unsigned)v, 0);
}
inline void __syncwarp(unsigned m = 0xffffffffu) { emu::collective(emu::K_SYNCWARP, m, 0, 0); }

[[noreturn]] inline void emu_no_cta_barrier() {
  std::fprintf(stderr, "host emulation: CTA-wide barriers are not emulated\n");
  std::abort();
}
inline void __syncthreads() { emu_no_cta_barrier(); }
inline int __syncthreads_or(int) { emu_no_cta_barrier(); }

inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned n) {
  return (unsigned)(((((uint64_t)hi) << 32) | lo) >> (n & 31u));
}
inline int __ffs(unsigned v) { return __builtin_ffs((int)v); }
// Byte i of the result is byte (s >> 4i) & 7 of the eight bytes y:x.
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t xy = ((uint64_t)y << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i) r |= (unsigned)((xy >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
}
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }

// kernel<<<grid, block, 0, stream>>>(args...) of the real build.
#define POMCPP_LAUNCH(kernel, grid, block, stream, ...) \
  emu::launch((grid), (block), [&] { kernel(__VA_ARGS__); })
