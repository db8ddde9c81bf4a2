// Stand-in for <cuda_runtime.h>: compiles a CUDA source of this package
// with g++ and runs its kernels on the host, for tests on machines without
// a card (tests/test_torch_*_emulated.py).
//
//   g++ -std=c++17 -O1 -fPIC -shared -I csrc/emu -x c++ csrc/smith_waterman.cu
//   g++ ... -x c++ csrc/bench_kernels.cu
//   g++ ... -mfma -ffp-contract=off -DFGT_EMU_FTZ -x c++ csrc/pairhmm.cu
//
// The last line mirrors nvcc's -ftz=true --fmad=false for pairhmm.cu:
// FGT_EMU_FTZ sets flush-to-zero and denormals-are-zero in MXCSR for the
// length of each launch (and restores it after, so the caller's float
// arithmetic is untouched), -ffp-contract=off keeps g++ from fusing what
// the source does not, and -mfma makes __fmaf_rn one rounding in hardware
// under that MXCSR.
//
// A launch runs the blocks one after another.  The threads of a block run
// as coroutines (ucontext), each on a stack of its own; a thread runs until
// it reaches a warp-wide operation, which is a barrier of the live lanes of
// its warp: __syncwarp, the shuffles and the ballot, which write the lane's
// value to an exchange slot, wait for the warp, read the source lane's slot
// (the ballot: every live lane's) and wait again.  __syncthreads is the same
// barrier over the live threads of the block.  Hopper's DPX intrinsics are
// their plain definitions; atomics are plain read-modify-writes, since no
// thread is interrupted between two warp-wide operations.  The card has
// kEmuSMs multiprocessors of one resident block each.  Dynamic shared
// memory is one buffer per block, filled with 0x55 bytes: a kernel that
// reads what it did not write sees large values, not zeros.  Only what the
// package's kernels use is here; every pointer is a host pointer.
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>
#include <ucontext.h>

#include <functional>
#include <vector>

#ifdef FGT_EMU_FTZ
#if !defined(__x86_64__)
#error "FGT_EMU_FTZ sets flush-to-zero through MXCSR: x86-64 only"
#endif
#include <xmmintrin.h>
#endif

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};

inline dim3 threadIdx, blockIdx, blockDim, gridDim;

typedef int cudaError_t;
enum : int { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };

// the stand-in card: one device of kEmuSMs multiprocessors, each holding one
// block at a time
constexpr int kEmuSMs = 2;

template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = kEmuSMs;
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F,
                                                                 int, size_t) {
  *n = 1;
  return cudaSuccess;
}

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

// DPX (sm_90): max(a + b, c); max(a, b, c, 0); max(a, b) and a >= b
inline int __viaddmax_s32(int a, int b, int c) { return max(a + b, c); }
inline int __vimax3_s32_relu(int a, int b, int c) {
  return max(max(a, b), max(c, 0));
}
inline int __vibmax_s32(int a, int b, bool* pred) {
  *pred = a >= b;
  return a >= b ? a : b;
}

namespace fgt_emu {

constexpr size_t kStack = 256 * 1024;

struct Lane {
  ucontext_t ctx;
  std::vector<char> stack;
  bool done = false;
};

struct Runtime {
  ucontext_t sched;
  std::vector<Lane> lanes;
  std::vector<int> arrived, live;
  std::vector<unsigned> gen;
  std::vector<uint64_t> slot;
  std::vector<unsigned char> smem;
  std::function<void()> body;
  int cur = -1;
  int barrived = 0, blive = 0;  // the block's barrier
  unsigned bgen = 0;
};

inline Runtime rt;

inline void yield() { swapcontext(&rt.lanes[rt.cur].ctx, &rt.sched); }

inline void release_if_complete(int w) {
  if (rt.arrived[w] > 0 && rt.arrived[w] == rt.live[w]) {
    rt.arrived[w] = 0;
    ++rt.gen[w];
  }
}

// every live lane of the calling thread's warp gets here before any leaves
inline void warp_barrier() {
  const int w = rt.cur / 32;
  const unsigned g = rt.gen[w];
  ++rt.arrived[w];
  release_if_complete(w);
  while (rt.gen[w] == g) yield();
}

inline void release_block_if_complete() {
  if (rt.barrived > 0 && rt.barrived == rt.blive) {
    rt.barrived = 0;
    ++rt.bgen;
  }
}

// every live thread of the block gets here before any leaves
inline void block_barrier() {
  const unsigned g = rt.bgen;
  ++rt.barrived;
  release_block_if_complete();
  while (rt.bgen == g) yield();
}

inline void lane_entry(int i) {
  rt.body();
  rt.lanes[i].done = true;
  const int w = i / 32;
  --rt.live[w];
  release_if_complete(w);
  --rt.blive;
  release_block_if_complete();
}

template <class T>
inline T exchange(T v, int src) {
  uint64_t bits = 0;
  memcpy(&bits, &v, sizeof(T));
  rt.slot[rt.cur] = bits;
  warp_barrier();
  bits = rt.slot[src];
  warp_barrier();
  T out;
  memcpy(&out, &bits, sizeof(T));
  return out;
}

// bit l: lane l of the calling thread's warp is live and passed a nonzero
// ``pred``
inline unsigned ballot(int pred) {
  rt.slot[rt.cur] = pred != 0;
  warp_barrier();
  unsigned bits = 0;
  const int w0 = rt.cur & ~31;
  for (int l = 0; l < 32 && w0 + l < (int)rt.lanes.size(); ++l)
    if (!rt.lanes[w0 + l].done && rt.slot[w0 + l]) bits |= 1u << l;
  warp_barrier();
  return bits;
}

template <class T>
inline T* dynamic_smem() {
  return reinterpret_cast<T*>(rt.smem.data());
}

// MXCSR's flush-to-zero (bit 15) and denormals-are-zero (bit 6) for the
// life of the object, where the source is built with FGT_EMU_FTZ; the
// lanes' contexts are made under it (a context carries MXCSR)
struct FlushDenormals {
#ifdef FGT_EMU_FTZ
  unsigned saved = _mm_getcsr();
  FlushDenormals() { _mm_setcsr(saved | 0x8040u); }
  ~FlushDenormals() { _mm_setcsr(saved); }
#endif
};

template <class F>
inline void launch(int grid, int block, size_t smem, F kernel) {
  const FlushDenormals ftz;
  rt.body = kernel;
  rt.lanes = std::vector<Lane>(block);
  for (Lane& l : rt.lanes) l.stack.resize(kStack);
  const int warps = (block + 31) / 32;
  rt.slot.assign(block, 0);
  blockDim.x = block;
  gridDim.x = grid;
  for (int bx = 0; bx < grid; ++bx) {
    blockIdx.x = bx;
    rt.smem.assign(smem + 16, 0x55);  // not zeroed: as on the card
    rt.arrived.assign(warps, 0);
    rt.gen.assign(warps, 0);
    rt.live.assign(warps, 0);
    rt.barrived = 0;
    rt.blive = block;
    for (int i = 0; i < block; ++i) {
      Lane& l = rt.lanes[i];
      l.done = false;
      ++rt.live[i / 32];
      getcontext(&l.ctx);
      l.ctx.uc_stack.ss_sp = l.stack.data();
      l.ctx.uc_stack.ss_size = l.stack.size();
      l.ctx.uc_link = &rt.sched;
      makecontext(&l.ctx, reinterpret_cast<void (*)()>(lane_entry), 1, i);
    }
    for (bool running = true; running;) {
      running = false;
      for (int i = 0; i < block; ++i) {
        if (rt.lanes[i].done) continue;
        running = true;
        rt.cur = i;
        threadIdx.x = i;
        swapcontext(&rt.sched, &rt.lanes[i].ctx);
      }
    }
  }
  rt.cur = -1;
}

}  // namespace fgt_emu

template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned delta, int = 32) {
  const int lane = fgt_emu::rt.cur & 31;
  const int src = lane >= (int)delta ? fgt_emu::rt.cur - (int)delta
                                     : fgt_emu::rt.cur;
  return fgt_emu::exchange(v, src);
}

template <class T>
inline T __shfl_xor_sync(unsigned, T v, int mask, int = 32) {
  return fgt_emu::exchange(v, fgt_emu::rt.cur ^ (mask & 31));
}

template <class T>
inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int lane = fgt_emu::rt.cur & 31;
  const int from = (lane & ~(width - 1)) + (src & (width - 1));
  return fgt_emu::exchange(v, (fgt_emu::rt.cur & ~31) + from);
}

inline unsigned __ballot_sync(unsigned, int pred) {
  return fgt_emu::ballot(pred);
}

inline int __any_sync(unsigned, int pred) {
  return fgt_emu::ballot(pred) != 0u;
}

template <class T>
inline T __ldg(const T* p) {
  return *p;
}

inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }

inline unsigned __float_as_uint(float x) {
  unsigned u;
  memcpy(&u, &x, sizeof u);
  return u;
}

inline float __uint_as_float(unsigned u) {
  float x;
  memcpy(&x, &u, sizeof x);
  return x;
}

inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }

// a thread runs until its next warp-wide operation, so a read-modify-write
// between two of them is atomic
inline int atomicAdd(int* p, int v) {
  const int old = *p;
  *p = old + v;
  return old;
}

inline void __threadfence() {}

inline void __syncwarp(unsigned = 0xffffffffu) { fgt_emu::warp_barrier(); }

inline void __syncthreads() { fgt_emu::block_barrier(); }
