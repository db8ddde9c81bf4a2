// Local affine Smith-Waterman for NVIDIA Hopper (sm_90a): score-only
// sweep, full sweep with traceback pointers, and the pointer walk.
//
// Replaces three kernels of falcon_genome_tpu/ops/smith_waterman.py:
//   K1 fgt_sw_score     <- _sw_score_kernel (Pallas, the aligner's candidate
//                          ranking)
//   K2 fgt_sw_full      <- _sw_kernel (Pallas, full SW + pointer byte/cell)
//   K3 fgt_sw_traceback <- _traceback_core (device JAX, lockstep walk)
//
// Semantics (bit-equal to the reference's _sw_scan_core + _traceback_core):
//   cell (i, j), 1-based read row i = r + 1, window column j:
//     E = max(H(i, j-1) - go, E(i, j-1) - ge)        go = gap_open + gap_ext
//     F = max(H(i-1, j) - go, F(i-1, j) - ge)
//     H = max(0, H(i-1, j-1) + sub, E, F)
//   cells outside 1 <= j <= wlen, r < rlen hold H = 0, E = F = NEG;
//   best = max H; ties go to the smallest diagonal d = r + j, then the
//   smallest row (the reference's strict improvement across diagonals),
//   reported as bestpos = d * 4096 + r;
//   pointer byte = hdir | eext << 2 | fext << 3 with hdir 0 stop, 1 diag,
//   2 from E, 3 from F (that priority), eext/fext = strict ext > open.
//
// What bounds it on the H100: K1 and K2 are serial integer max-plus
// recurrences along a wavefront -- bound by the instruction issue rate
// (every warp instruction of a step takes a scheduler slot), not by
// memory (a few hundred bytes of input per alignment).  K2 also writes its
// pointers, 4 bits a cell, 23 KB per alignment at R = 160, W = 256 (0.19
// GB for 8192 aligner lanes), a DRAM write stream beside the recurrence.
// K3 follows a chain of dependent pointers per alignment: bound by the
// latency of its loads, so it loads a run of cells per round trip.
//
// Design: one warp per alignment.  Thread t owns NR consecutive rows
// (NR = ceil(R / 32), a template parameter up to kMaxRows, so the rows'
// state lives in registers) and computes column j = s - t + 1 of all of
// them at step s: each step does NR cells for one pair of __shfl_up_sync,
// which hands the H and F of the thread's last row to the thread below,
// and the warp sweeps at most wlen + 31 steps once (as far as the last
// thread with a row of the read needs).  Reads longer than 32 kMaxRows
// rows run in stripes of that many rows; the stripe's last row is kept in
// shared memory for the next stripe's first row.  Per step, not per cell:
//   * the window enters shared memory once per warp as int codes, with a
//     code that equals no read base left and right of it, and a step loads
//     its column's code once for NR cells;
//   * no cell tests whether it lies in the matrix: a cell left of the
//     window sees only zeros and the no-base code, so it holds exactly
//     H = 0 and E, F <= -go (penalties >= 0, which the wrapper checks),
//     which is what the first column reads of the boundary; cells right
//     of the window or below the read are computed and never read by a
//     cell inside;
//   * each row keeps its best cell as one key, H * 4096 + 4095 - j, under
//     a max, so the smallest column wins a tie; a column outside the
//     window adds -2^30 and never wins.  At the end the keys of the read's
//     rows are turned into (score, d * 4096 + r) and reduced under the
//     (score desc, bestpos asc) order, which is total, so the order of
//     visiting cells cannot change the result;
//   * K2 takes H and its direction from one max over the candidates
//     scaled by 4 with a code in the direction's priority at ties (stop 3,
//     diagonal 2, E 1, F 0): H is that max >> 2, hdir its low bits ^ 3.
// The maxima are plain max(); the compiler emits IMNMX/VIMNMX3 for them
// (the DPX intrinsics written out were slower, PERF.md).
// K2's pointers: row r of a stripe (thread t = r / NR) at step s is 4 bits
// of word ((stripe * words + s / 8) * 32 NR + r), at bit 4 (s % 8).  A
// thread gathers 8 steps of its NR rows in NR registers and the warp then
// stores 32 NR consecutive words.  K3 reads that layout a cell a lane
// (sw_traceback_kernel).
#include <cuda_runtime.h>
#include <stdint.h>

#ifdef __CUDACC__
#define FGT_DYNAMIC_SMEM(T, name) extern __shared__ T name[]
#define FGT_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#else  // g++ against csrc/emu/cuda_runtime.h: a host loop over the blocks
#define FGT_DYNAMIC_SMEM(T, name) T* name = fgt_emu::dynamic_smem<T>()
#define FGT_LAUNCH(kernel, grid, block, smem, stream, ...) \
  fgt_emu::launch(grid, block, smem, [=] { kernel(__VA_ARGS__); })
#endif

namespace {

constexpr int kNeg = -(1 << 28);
constexpr int kPosStride = 4096;
constexpr int kWarps = 8;          // alignments (warps) per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRows = 12;       // rows per thread: one stripe up to 384
constexpr int kPad = 32;           // window codes in front of column 1
constexpr int kNoCode = 1 << 16;   // window code outside it: no read base
constexpr int kOffKey = -(1 << 30);  // best-cell key outside the window
constexpr int kBlk = 8;            // steps per pointer word, 4 bits a cell

__device__ __forceinline__ void keep_best(int& s, int& p, int os, int op) {
  if (os > s || (os == s && op < p)) {
    s = os;
    p = op;
  }
}

// Steps a stripe sweeps at most: W + 31, rounded up to whole pointer
// words (kBlk steps of 4 bits).
__host__ __device__ __forceinline__ int steps_cap(int W) {
  return (W + 31 + kBlk - 1) / kBlk * kBlk;
}

template <int NR, bool FULL, bool STRIPED>
__global__ void __launch_bounds__(kWarps * 32)
sw_kernel(const int8_t* __restrict__ read, const int8_t* __restrict__ win,
          const int* __restrict__ rlen, const int* __restrict__ wlen,
          int B, int R, int W, int match, int mismatch, int go, int ge,
          uint32_t* __restrict__ ptr, int* __restrict__ score_out,
          int* __restrict__ pos_out) {
  constexpr int kRows = 32 * NR;  // rows of a stripe
  FGT_DYNAMIC_SMEM(int, smem);
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + wib;
  if (b >= B) return;  // uniform across the warp
  const int cap = steps_cap(W);
  const int span = kPad + cap;
  int* wc = smem + wib * (span + (STRIPED ? 2 * (cap + 1) : 0));
  int* bufH = wc + span;  // STRIPED: the last row of the stripe above
  int* bufF = bufH + cap + 1;
  const int rl = min(rlen[b], R);
  const int wl = min(wlen[b], W);
  const int8_t* rd = read + (size_t)b * R;
  const int8_t* wn = win + (size_t)b * W;
  // window codes: wc[kPad + j - 1] is column j
  for (int p = lane; p < span; p += 32) {
    const int q = p - kPad;
    wc[p] = (q >= 0 && q < wl) ? (int)wn[q] : kNoCode;
  }
  // the boundary where a stripe's last row does not reach: a column right
  // of the window, whose cells must stay as small as those inside (a
  // row's best-cell key holds scores below 2^18 only)
  for (int p = lane; STRIPED && p <= cap; p += 32) {
    bufH[p] = 0;
    bufF[p] = kNeg;
  }
  __syncwarp();
  const int nblk = cap / kBlk;  // pointer words of a row in a stripe
  uint32_t* pb = FULL ? ptr + (size_t)b * (STRIPED ? (R + kRows - 1) / kRows
                                                   : 1) * nblk * kRows
                      : nullptr;
  int best_s = 0, best_p = 0;
  const int nstripes = STRIPED ? (max(rl, 0) + kRows - 1) / kRows
                               : (rl > 0 && wl > 0 ? 1 : 0);
  for (int st = 0; st < nstripes; ++st) {
    const int r0 = st * kRows + lane * NR;  // this thread's first row
    int rb[NR], H[NR], E[NR], key[NR];
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      rb[k] = r0 + k < rl ? (int)rd[r0 + k] : 0;
      H[k] = 0;
      E[k] = kNeg;
      key[k] = 0;
    }
    int upPrev = 0;   // H of the row above at the previous column
    int fb = kNeg;    // F of this thread's last row (read by the next)
    // the last thread with a row of the read ends on column wl
    const int nsteps = wl + (min(rl - st * kRows, kRows) - 1) / NR;
    for (int s0 = 0; s0 < nsteps; s0 += kBlk) {
      unsigned acc[NR];  // FULL: the rows' pointers of kBlk steps
#pragma unroll
      for (int k = 0; k < NR; ++k) acc[k] = 0u;
#pragma unroll
      for (int u = 0; u < kBlk; ++u) {
        const int s = s0 + u;
        const int j = s - lane + 1;
        int uH = __shfl_up_sync(kFull, H[NR - 1], 1);
        int uF = __shfl_up_sync(kFull, fb, 1);
        if (STRIPED && st > 0) {  // the row above is the previous stripe's
          uH = lane == 0 ? bufH[j] : uH;
          uF = lane == 0 ? bufF[j] : uF;
        } else {
          uH = lane == 0 ? 0 : uH;
          uF = lane == 0 ? kNeg : uF;
        }
        const int c = wc[kPad + j - 1];
        // key of a cell: h * 4096 + 4095 - j inside the window; a column
        // outside it can never win
        const bool col = (unsigned)(j - 1) < (unsigned)wl;
        const int low = col ? 4095 - j : kOffKey;
        int dg = upPrev;
        upPrev = uH;
        int uh = uH, uf = uF;
#pragma unroll
        for (int k = 0; k < NR; ++k) {
          const int old = H[k];
          const int diag = dg + (rb[k] == c ? match : -mismatch);
          int e, f, h;
          if (FULL) {
            const int e_open = old - go, e_ext = E[k] - ge;
            const int f_open = uh - go, f_ext = uf - ge;
            e = max(e_open, e_ext);
            f = max(f_open, f_ext);
            // x 4 plus a code in hdir's priority at ties: stop 3, diag 2,
            // E 1, F 0
            const int h4 = max(max(diag * 4 + 2, e * 4 + 1), max(f * 4, 3));
            h = h4 >> 2;
            const unsigned hdir = ((unsigned)h4 & 3u) ^ 3u;
            acc[k] |= (hdir | (e_ext > e_open ? 4u : 0u)
                       | (f_ext > f_open ? 8u : 0u)) << (4 * u);
          } else {
            e = max(old - go, E[k] - ge);
            f = max(uh - go, uf - ge);
            h = max(max(0, diag), max(e, f));
          }
          key[k] = max(key[k], (h << 12) + low);
          H[k] = h;
          E[k] = e;
          dg = old;
          uh = h;
          uf = f;
        }
        fb = uf;
        if (STRIPED && lane == 31 && j >= 1) {
          bufH[j] = uh;
          bufF[j] = uf;
        }
      }
      if (FULL) {  // one word per row: a warp stores 32 NR words in a row
        uint32_t* out = pb + ((size_t)st * nblk + s0 / kBlk) * kRows +
                        lane * NR;
#pragma unroll
        for (int k = 0; k < NR; ++k) out[k] = acc[k];
      }
    }
    // the rows' best cells: (score desc, bestpos asc) over the rows of the
    // read; a key below 4096 is a score of 0
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int r = r0 + k;
      if (r < rl && key[k] >= 4096) {
        const int j = 4095 - (key[k] & 4095);
        keep_best(best_s, best_p, key[k] >> 12, (r + j) * kPosStride + r);
      }
    }
    __syncwarp();
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int os = __shfl_xor_sync(kFull, best_s, off);
    const int op = __shfl_xor_sync(kFull, best_p, off);
    keep_best(best_s, best_p, os, op);
  }
  if (lane == 0) {
    score_out[b] = best_s;
    pos_out[b] = best_p;
  }
}

// K3, the pointer walk: a warp per alignment, in runs.  A step moves
// from (i, j) to (i-1, j-1) in phase H on a diagonal pointer, to (i, j-1)
// in a deletion run (phase E), to (i-1, j) in an insertion run (phase F):
// each phase moves in one direction while its test holds (hdir 1; the
// E-extend bit; the F-extend bit).  So lane k of the warp loads the
// pointer of the cell k steps further in the phase's direction (kDepth
// cells a lane: 32 kDepth cells in flight, one round trip), a ballot finds
// the first cell where the test fails, every cell before it takes the
// phase's op, and the cell itself takes one step of the reference's walk,
// which may change the phase.  A walk of 150 matches is 150 / (32 kDepth)
// round trips, not 150.  The ops go as whole bytes into shared memory and
// the block writes its kWalkWarps alignments' bytes of a packed row next
// to each other; bytes past a walk's end are written as 0 (op -1).
constexpr int kWalkWarps = 8;  // alignments (warps) per block
constexpr int kDepth = 2;      // cells a lane loads per round trip
// a round trip completes at most 8 kDepth + 1 bytes of ops, one a lane,
// and hands the byte after them on from the lane after the last
static_assert(kDepth >= 1 && 8 * kDepth + 1 <= 31, "kDepth too large");
static_assert(kBlk == 8, "K3 takes s / kBlk and s % kBlk as s >> 3, s & 7");

template <bool STRIPED>  // reads of more than one stripe
__global__ void __launch_bounds__(kWalkWarps * 32)
sw_traceback_kernel(const uint32_t* __restrict__ ptr,
                    const int* __restrict__ best, const int* __restrict__ pos,
                    int B, int NR, int nst, int nblk, int max_steps,
                    uint8_t* __restrict__ packed, int* __restrict__ coords) {
  FGT_DYNAMIC_SMEM(int, smem);  // kWalkWarps byte counts, then the ops
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int b0 = blockIdx.x * kWalkWarps;
  const int b = b0 + wib;
  const int S4 = (max_steps + 3) / 4;
  uint8_t* ops = reinterpret_cast<uint8_t*>(smem + kWalkWarps);
  if (b < B) {  // uniform across the warp
    const int rows = 32 * NR;  // rows of a stripe
    // x / NR = x * inv >> 16 for 0 <= x < 4096 and NR <= 12
    const int inv = (65536 + NR - 1) / NR;
    const uint32_t* pb = ptr + (size_t)b * nst * nblk * rows;
    const int p = pos[b];
    const int bi = p % kPosStride + 1, bj = p / kPosStride - bi + 1;
    int i = bi, j = bj, phase = 0, t = 0;  // phase 0 = H, 1 = E, 2 = F
    bool active = best[b] > 0;
    unsigned part = 0;  // ops of byte t / 4 so far
    while (active) {
      const int ai = phase != 1, aj = phase != 2;  // the run's direction
      // the phase's test on a pointer: hdir 1, E-extend, F-extend
      const int tmask = (0x843 >> (4 * phase)) & 15;
      const int tval = phase == 0 ? 1 : tmask;
      // the pointers of cells lane + 32 d, all loads in flight at once; a
      // cell outside the walk reads word 0 and holds 16, which fails
      // every phase's test
      int ptr4[kDepth];
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const int k = lane + 32 * d;
        const int ik = i - ai * k, jk = j - aj * k;
        const bool valid = ik > 0 && jk > 0 && t + k < max_steps;
        // cell (ik, jk): row rr of stripe st, swept at step s of it, in
        // word s / kBlk of its row at bit 4 (s % kBlk)
        const int g = ik - 1;
        const int st = STRIPED ? ((g >> 5) * inv) >> 16 : 0;
        const int rr = g - st * rows;
        const int s = jk - 1 + ((rr * inv) >> 16);
        const uint32_t w = pb[valid ? (st * nblk + (s >> 3)) * rows + rr : 0];
        ptr4[d] = valid ? (int)(w >> (4 * (s & 7))) & 15 : 16;
      }
      unsigned brk = 0;
      int n = 32 * kDepth;
#pragma unroll
      for (int d = kDepth - 1; d >= 0; --d) {
        const unsigned m = __ballot_sync(kFull, (ptr4[d] & tmask) != tval);
        if (m) {
          brk = m;
          n = 32 * d + __ffs(m) - 1;
        }
      }
      // cells 0 .. n-1 take the phase's op (SAM op + 1: M 1, I 2, D 3)
      const int rc = (0x2d >> (2 * phase)) & 3;
      int ni = i - ai * n, nj = j - aj * n;
      int bc = 0;  // op + 1 of cell n, 0 for none
      active = brk == 0;
      if (brk) {   // cell n: one step of the reference's walk
        int mine = ptr4[0];  // this lane's cell in cell n's 32
#pragma unroll
        for (int d = 1; d < kDepth; ++d) mine = n >> 5 == d ? ptr4[d] : mine;
        const int byte = __shfl_sync(kFull, mine, n & 31);
        if (ni > 0 && nj > 0 && t + n < max_steps) {
          // where the step goes: 0 stop, 1 diagonal, 2 E (left), 3 F (up)
          const int dir = phase == 0 ? byte & 3 : phase + 1;
          bc = (0xb4 >> (2 * dir)) & 3;
          ni -= (0xa >> dir) & 1;
          nj -= (0x6 >> dir) & 1;
          // E continues on its extend bit (bit 2), F on its own (bit 3)
          phase = dir >= 2 ? ((byte >> dir) & 1) * (dir - 1) : 0;
          active = dir != 0;
        }
      }
      // the bytes from t / 4 on: lane l fills byte t / 4 + l with the ops
      // of its four positions that lie in [t, t + n] (run, then cell n)
      const int base = (t & ~3) + 4 * lane;
      const int lo = lane == 0 ? t & 3 : 0;
      const int hi = min(max(t + n - base, 0), 4);
      unsigned v = (rc * 0x55u) & ((1u << (2 * hi)) - (1u << (2 * lo)));
      const int at = t + n - base;
      if (at >= 0 && at < 4) v |= (unsigned)bc << (2 * at);
      if (lane == 0) v |= part;
      const int t_new = t + n + (bc != 0);
      const int full = (t_new >> 2) - (t >> 2);  // bytes completed
      if (lane < full) ops[wib * S4 + (t >> 2) + lane] = (uint8_t)v;
      part = __shfl_sync(kFull, v, full);
      t = t_new;
      i = ni;
      j = nj;
    }
    if ((t & 3) && lane == 0) ops[wib * S4 + (t >> 2)] = (uint8_t)part;
    if (lane == 0) smem[wib] = (t + 3) >> 2;
    if (lane < 4) coords[lane * B + b] = lane == 0 ? i : lane == 1 ? j
                                         : lane == 2 ? bi : bj;
  }
  __syncthreads();
  // row q of packed holds byte q of every alignment: the block's
  // kWalkWarps bytes of a row lie side by side
  for (int x = threadIdx.x; x < S4 * kWalkWarps; x += kWalkWarps * 32) {
    const int q = x / kWalkWarps, w = x % kWalkWarps;
    if (b0 + w < B)
      packed[(size_t)q * B + b0 + w] = q < smem[w] ? ops[w * S4 + q] : 0;
  }
}

// The arguments of one sweep call, as the C entry points receive them.
struct Call {
  const void* read;
  const void* win;
  const void* rlen;
  const void* wlen;
  int B, R, W, match, mismatch, go, ge;
  void* ptr;
  void* score_out;
  void* pos_out;
  void* stream;
};

template <int NR, bool FULL, bool STRIPED>
int launch_sw(const Call& a) {
  const int cap = steps_cap(a.W);
  const size_t smem = (size_t)kWarps *
                      (kPad + cap + (STRIPED ? 2 * (cap + 1) : 0)) *
                      sizeof(int);
  auto* kernel = sw_kernel<NR, FULL, STRIPED>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (a.B + kWarps - 1) / kWarps;
  if (grid > 0) {
    FGT_LAUNCH(kernel, grid, kWarps * 32, smem, (cudaStream_t)a.stream,
               (const int8_t*)a.read, (const int8_t*)a.win,
               (const int*)a.rlen, (const int*)a.wlen, a.B, a.R, a.W,
               a.match, a.mismatch, a.go, a.ge, (uint32_t*)a.ptr,
               (int*)a.score_out, (int*)a.pos_out);
  }
  return (int)cudaGetLastError();
}

// NR = ceil(R / 32) rows per thread in one stripe up to 32 kMaxRows rows;
// longer reads in stripes of kMaxRows rows per thread.
template <bool FULL>
int dispatch_rows(const Call& a) {
  if (a.W < 1) return (int)cudaErrorInvalidValue;
  switch (max(1, (a.R + 31) / 32)) {
#define FGT_CASE(N) \
  case N:           \
    return launch_sw<N, FULL, false>(a);
    FGT_CASE(1)
    FGT_CASE(2)
    FGT_CASE(3)
    FGT_CASE(4)
    FGT_CASE(5)
    FGT_CASE(6)
    FGT_CASE(7)
    FGT_CASE(8)
    FGT_CASE(9)
    FGT_CASE(10)
    FGT_CASE(11)
    FGT_CASE(12)
#undef FGT_CASE
    default:
      return launch_sw<kMaxRows, FULL, true>(a);
  }
}

}  // namespace

extern "C" {

int fgt_sw_score(const void* read, const void* win, const void* rlen,
                 const void* wlen, int B, int R, int W, int match,
                 int mismatch, int go, int ge, void* score_out,
                 void* pos_out, void* stream) {
  return dispatch_rows<false>(Call{read, win, rlen, wlen, B, R, W, match,
                                   mismatch, go, ge, nullptr, score_out,
                                   pos_out, stream});
}

int fgt_sw_full(const void* read, const void* win, const void* rlen,
                const void* wlen, int B, int R, int W, int match,
                int mismatch, int go, int ge, void* ptr, void* score_out,
                void* pos_out, void* stream) {
  return dispatch_rows<true>(Call{read, win, rlen, wlen, B, R, W, match,
                                  mismatch, go, ge, ptr, score_out, pos_out,
                                  stream});
}

int fgt_sw_traceback(const void* ptr, const void* best, const void* pos,
                     int B, int NR, int nst, int nblk, int max_steps,
                     void* packed, void* coords, void* stream) {
  if (NR < 1 || NR > kMaxRows || max_steps < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      kWalkWarps * sizeof(int) + (size_t)kWalkWarps * ((max_steps + 3) / 4);
  auto* kernel = nst > 1 ? sw_traceback_kernel<true>
                         : sw_traceback_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (B + kWalkWarps - 1) / kWalkWarps;
  if (grid > 0) {
    FGT_LAUNCH(kernel, grid, kWalkWarps * 32, smem, (cudaStream_t)stream,
               (const uint32_t*)ptr, (const int*)best, (const int*)pos, B,
               NR, nst, nblk, max_steps, (uint8_t*)packed, (int*)coords);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
