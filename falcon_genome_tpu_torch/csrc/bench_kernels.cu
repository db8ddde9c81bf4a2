// Benchmark kernels for NVIDIA Hopper (sm_90a): the float32 FMA-issue
// ceiling and the score-only Smith-Waterman ablation.
//
// K6 fgt_fma_ceiling      <- bench_pallas_fma_ceiling (bench.py), the
//                            dependence-free twin of the PairHMM kernel's
//                            loop that divides pairhmm_mfu.
//   x (R, B) float32 -> (B,) float32.  Every element (r, b) runs kChains
//   chains s = s * a + b (fused) for `trips` trips, all starting at
//   x[r, b]; the chains are summed in order 0..63, then the rows of lane
//   b in order 0..R-1.
//   What bounds it: nothing but FFMA issue.  2 * 64 * trips flops per
//   element against 4 bytes read; at R = 160, B = 2048, trips = 272 that
//   is 11.4 GFLOP, 0.17 ms at the H100 SXM's 67 TFLOP/s float32 peak.
//   Design: one thread per (row, lane) element with its 64 chains in
//   registers -- the register-FMA issue ceiling (the TPU's was a VMEM
//   streaming ceiling).  One block per lane, one thread per row; the row
//   sum goes through shared memory, added by thread 0 in row order.
//   All 64 chains hold the same value, and a compiler folds identical
//   chains into one: each chain starts at x + c * zero, where `zero` is a
//   kernel argument (0 at run time), so the chains stay distinct to the
//   compiler and equal to x in value.  The trip loop is not unrolled past
//   kUnroll trips, so its body holds exactly 64 * kUnroll FFMAs, which
//   chip_smoke.py counts in the SASS.
//
// K7 fgt_sw_score_ablate  <- make_kernel (benchmarks/ablate_sw.py), the
//                            score-only Smith-Waterman kernel with groups
//                            of work removed.
//   Follows make_kernel exactly: every diagonal d = 1..R+W is swept for
//   all R rows (no early stop); the cell at row r, column j = d - r reads
//   win[min(j - 1, W - 1)] for j >= 1 and 0 for j <= 0 (kNoWindow: 0
//   always); cells before diagonal 1 hold H = 0, E = F = NEG; E/F/H as
//   fgt_sw_score; unless kNoMask, cells outside 1 <= j <= wlen, r < rlen
//   hold H = 0, E = F = NEG; unless kNoBest, the best H under (score
//   desc, d * 4096 + r asc) over all R rows, else the max over rows of H
//   on diagonal R + W with pos 0.  The base variant equals fgt_sw_score.
//   What bounds it: int32 issue, ~12 ops per cell, (R + W) * R cells per
//   alignment (189 M at R = 160, W = 416, B = 2048); a few hundred bytes
//   of input per alignment.
//   Design: fgt_sw_score's sweep (csrc/smith_waterman.cu sw_kernel),
//   copied rather than shared, because its step differs in what the
//   ablation removes (an explicit mask select, a window code 0 left of
//   column 1, the full band) and a shared step would put those
//   parameters on K1's: one warp per alignment, NR = ceil(R / 32)
//   consecutive rows a thread in registers (stripes of 32 kMaxRows rows
//   beyond, the boundary row in shared memory), thread t at step s on
//   column j = s - t + c for all of its rows, one pair of __shfl_up_sync
//   per NR cells; the window's codes in shared memory once per warp (0
//   left of column 1, the clamped window right of it), one load per
//   step; each row's best cell as one key under max, no branch per cell;
//   the mask a select per cell; 8 warps a block.  A thread's rows share
//   a column, so row r0 + k enters the band k columns before row r0, and
//   thread t enters it NR - 1 steps before thread t - 1: a stripe sweeps
//   R + W + 32 (NR - 1) steps, of which the first and the last 32 (NR -
//   1) hold cells outside the band (before diagonal 1, held at the
//   initial state; after diagonal R + W, frozen, so that at the end a
//   row's H is its H on diagonal R + W).  Those steps run a guarded copy
//   of the step in loops of their own; the loop between them tests no
//   cell for the band, and each flag removes exactly its group of work
//   from it: the best key, the mask select, the shared-memory code load.
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

constexpr int kChains = 64;
constexpr int kUnroll = 4;  // trips per iteration of the trip loop
constexpr int kNeg = -(1 << 28);
constexpr int kPosStride = 4096;
constexpr int kWarps = 8;       // alignments (warps) per block, at most
constexpr int kMaxRows = 12;    // rows per thread: one stripe up to 384
constexpr int kSteps = 8;       // steps per trip of the unguarded loop
constexpr int kMaxSmem = 232448;  // shared memory a block may have
constexpr unsigned kFull = 0xffffffffu;

__global__ void fma_ceiling_kernel(const float* __restrict__ x,
                                   float* __restrict__ out, int R, int B,
                                   int trips, float a, float b, float zero) {
  FGT_DYNAMIC_SMEM(float, rows);
  const int r = threadIdx.x;
  const int lane = blockIdx.x;
  const float x0 = x[(size_t)r * B + lane];
  float s[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) s[c] = x0 + (float)c * zero;
#pragma unroll 1
  for (int t = 0; t < trips; t += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) s[c] = fmaf(s[c], a, b);
    }
  }
  float tot = s[0];
#pragma unroll
  for (int c = 1; c < kChains; ++c) tot += s[c];
  rows[r] = tot;
  __syncthreads();
  if (r == 0) {
    float acc = rows[0];
    for (int k = 1; k < R; ++k) acc += rows[k];
    out[lane] = acc;
  }
}

__device__ __forceinline__ void keep_best(int& s, int& p, int os, int op) {
  if (os > s || (os == s && op < p)) {
    s = os;
    p = op;
  }
}

// Ints of shared memory a warp uses: the window codes of columns
// 2 - 32 NR stripes .. R + W, and for STRIPED two boundary rows (H and F
// over diagonals 0 .. R + W), one written while the other is read.
__host__ __device__ __forceinline__ int ablate_smem_ints(
    int nr, bool striped, bool no_window, int R, int W) {
  const int rows = 32 * nr;
  const int nst = striped ? (R + rows - 1) / rows : 1;
  return (no_window ? 0 : nst * rows - 1 + R + W) +
         (striped ? 4 * (R + W + 1) : 0);
}

// What a stripe's steps share: the thread's place, the row above the
// stripe, the window's codes, the parameters.
struct Sweep {
  int lane, D, lag, wl, match, mismatch, go, ge;
  int c;    // column of lane 0 at step 0
  int jj0;  // diagonal of the thread's first row at step 0
  const int* code;  // code[s]: the code of the thread's column at step s
  const int* upH;   // STRIPED, st > 0: the previous stripe's last row
  int* dnH;         // STRIPED: this stripe's last row, for the next one
  bool above;       // STRIPED, st > 0: lane 0 reads upH
  bool writer;      // lane 31 of a stripe with one below it
};

// Which cells outside the band a step may hold: kPre, cells before
// diagonal 1, which must hold the initial state (the mask holds them so
// already, since they lie left of column 1; without it they are set) and
// whose keys may carry more than 12 low bits; kPost, cells after diagonal
// D, frozen, so that a row's H stays its H on diagonal D and its key
// cannot grow (a later cell's low bits are smaller).
constexpr int kPre = 1, kPost = 2;

// One step of a stripe: column j = s - lane + c of the thread's NR rows,
// row k on diagonal jj + k.  G: 0, kPre or kPost, the band edge the step
// may cross.
template <int NR, bool STRIPED, bool kNoBest, bool kNoMask, bool kNoWindow,
          int G>
__device__ __forceinline__ void ablate_step(
    int s, const Sweep& w, const int (&rb)[NR], const bool (&rv)[NR],
    int (&H)[NR], int (&E)[NR], int (&key)[NR], int& upPrev, int& fb) {
  const int jj = w.jj0 + s;
  int uH = __shfl_up_sync(kFull, H[NR - 1], 1);
  int uF = __shfl_up_sync(kFull, fb, 1);
  if (STRIPED && w.above) {  // the row above is the previous stripe's
    const int i = (G & kPre) ? max(s - w.lag, 0) : s - w.lag;
    uH = w.lane == 0 ? w.upH[i] : uH;
    uF = w.lane == 0 ? w.upH[w.D + 1 + i] : uF;
  } else {
    uH = w.lane == 0 ? 0 : uH;
    uF = w.lane == 0 ? kNeg : uF;
  }
  const int cd = kNoWindow ? 0 : w.code[s];
  // key of a cell: h * 4096 + D - jj; row k decodes d = jj + k (a cell
  // before diagonal 1 has h = 0 and must stay below 4096)
  const int low = (G & kPre) ? min(w.D - jj, 4095) : w.D - jj;
  const int j = s - w.lane + w.c;
  const bool col = kNoMask || (j >= 1 && j <= w.wl);
  int dg = upPrev;
  upPrev = uH;
  int uh = uH, uf = uF;
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const int old = H[k];
    int e = max(old - w.go, E[k] - w.ge);
    int f = max(uh - w.go, uf - w.ge);
    int h = max(max(0, dg + (rb[k] == cd ? w.match : -w.mismatch)),
                max(e, f));
    if (!kNoMask) {
      const bool v = col && rv[k];
      h = v ? h : 0;
      e = v ? e : kNeg;
      f = v ? f : kNeg;
    }
    if (kNoMask && (G & kPre) && jj + k < 1) {  // before diagonal 1
      h = 0;
      e = kNeg;
      f = kNeg;
    }
    if ((G & kPost) && jj + k > w.D) {  // after diagonal D: frozen
      h = old;
      e = E[k];
    }
    if (!kNoBest) key[k] = max(key[k], (h << 12) + low);
    H[k] = h;
    E[k] = e;
    dg = old;
    uh = h;
    uf = f;
  }
  fb = uf;
  if (STRIPED && w.writer && (!(G & kPost) || s < w.D)) {
    w.dnH[s + 1] = uh;  // the last row, on diagonal s + 1
    w.dnH[w.D + 1 + s + 1] = uf;
  }
}

template <int NR, bool STRIPED, bool kNoBest, bool kNoMask, bool kNoWindow>
__global__ void __launch_bounds__(kWarps * 32)
sw_ablate_kernel(const int8_t* __restrict__ read,
                 const int8_t* __restrict__ win,
                 const int* __restrict__ rlen, const int* __restrict__ wlen,
                 int B, int R, int W, int match, int mismatch, int go,
                 int ge, int zero, int* __restrict__ score_out,
                 int* __restrict__ pos_out) {
  constexpr int kRows = 32 * NR;       // rows of a stripe
  constexpr int kLag = 32 * (NR - 1);  // steps with cells before the band
  FGT_DYNAMIC_SMEM(int, smem);
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + wib;
  if (b >= B) return;  // uniform across the warp
  const int D = R + W;  // the last diagonal
  const int nst = STRIPED ? (R + kRows - 1) / kRows : 1;
  const int pad = nst * kRows - 1;  // codes left of column 1
  const int ncode = kNoWindow ? 0 : pad + D;
  int* wc = smem + wib * ablate_smem_ints(NR, STRIPED, kNoWindow, R, W);
  int* buf = wc + ncode;  // STRIPED: [stripe & 1][H, F][diagonal 0 .. D]
  const int rl = rlen[b];
  const int wl = wlen[b];
  const int8_t* rd = read + (size_t)b * R;
  const int8_t* wn = win + (size_t)b * W;
  // wc[pad + j - 1] is column j's code: 0 left of the window, the window
  // clamped to its last column right of it
  for (int p = lane; p < ncode; p += 32) {
    const int j = p - pad + 1;
    wc[p] = j < 1 ? 0 : (int)wn[min(j - 1, W - 1)];
  }
  // diagonal 0 of both boundary rows: the initial state
  if (STRIPED && lane < 2) {
    buf[lane * 2 * (D + 1)] = 0;
    buf[lane * 2 * (D + 1) + D + 1] = kNeg;
  }
  __syncwarp();
  const int S = D + kLag;  // steps of a stripe
  int best_s = 0, best_p = 0, last = 0;
  for (int st = 0; st < nst; ++st) {
    const int r0 = st * kRows + lane * NR;  // this thread's first row
    int rb[NR], H[NR], E[NR], key[NR];
    bool rv[NR];
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int r = r0 + k;
      rb[k] = r < R ? (int)rd[r] : 0;
      rv[k] = r < rl;
      H[k] = 0;
      E[k] = kNeg;
      key[k] = 0;
    }
    int upPrev = 0;  // H of the row above at the previous column
    int fb = kNeg;   // F of this thread's last row (read by the next)
    // at step s this thread is on column j = s - lane + c, and its row k
    // on diagonal jj0 + s + k
    const int c = 1 - kLag - st * kRows;
    const Sweep w{lane, D, kLag, wl, match, mismatch, go, ge, c,
                  lane * (NR - 1) + 1 - kLag, wc + pad - 1 + c - lane,
                  buf + ((st + 1) & 1) * 2 * (D + 1),
                  buf + (st & 1) * 2 * (D + 1), st > 0,
                  lane == 31 && st + 1 < nst};
    // steps [0, lag) hold cells before diagonal 1, steps [D, S) cells
    // after D (D > lag, as R > 32 (NR - 1)); the unguarded loop runs
    // whole trips between them.  In the first stripe every cell of steps
    // [0, lag) lies left of column 1; a compiler that sees lag as a
    // constant drops those steps under the mask, and the variants would
    // not sweep the same band: lag + zero (zero is 0 at run time) keeps
    // them, as make_kernel computes its masked cells.
    const int lag = kLag + zero;
    const int hi = lag + (D - lag) / kSteps * kSteps;
    int s = 0;
#pragma unroll 1
    for (; s < lag; ++s)
      ablate_step<NR, STRIPED, kNoBest, kNoMask, kNoWindow, kPre>(
          s, w, rb, rv, H, E, key, upPrev, fb);
#pragma unroll 1
    for (; s < hi; s += kSteps) {
#pragma unroll
      for (int u = 0; u < kSteps; ++u)
        ablate_step<NR, STRIPED, kNoBest, kNoMask, kNoWindow, 0>(
            s + u, w, rb, rv, H, E, key, upPrev, fb);
    }
#pragma unroll 1
    for (; s < S; ++s)
      ablate_step<NR, STRIPED, kNoBest, kNoMask, kNoWindow, kPost>(
          s, w, rb, rv, H, E, key, upPrev, fb);
    // the rows of the matrix: their H on diagonal D (kNoBest), or their
    // best cells under (score desc, bestpos asc); a key below 4096 is a
    // score of 0
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int r = r0 + k;
      if (r >= R) continue;
      if (kNoBest) {
        last = max(last, H[k]);
      } else if (key[k] >= 4096) {
        const int d = D - (key[k] & 4095) + k;
        keep_best(best_s, best_p, key[k] >> 12, d * kPosStride + r);
      }
    }
    __syncwarp();
  }
  if (kNoBest) {
    for (int off = 16; off > 0; off >>= 1)
      last = max(last, __shfl_xor_sync(kFull, last, off));
    best_s = last;
    best_p = 0;
  } else {
    for (int off = 16; off > 0; off >>= 1) {
      const int os = __shfl_xor_sync(kFull, best_s, off);
      const int op = __shfl_xor_sync(kFull, best_p, off);
      keep_best(best_s, best_p, os, op);
    }
  }
  if (lane == 0) {
    score_out[b] = best_s;
    pos_out[b] = best_p;
  }
}

// The arguments of one ablation call, as the C entry point receives them.
struct AblateCall {
  const void* read;
  const void* win;
  const void* rlen;
  const void* wlen;
  int B, R, W, match, mismatch, go, ge;
  void* score_out;
  void* pos_out;
  void* stream;
};

template <int NR, bool STRIPED, bool kNoBest, bool kNoMask, bool kNoWindow>
int launch_ablate(const AblateCall& a) {
  auto* kernel = sw_ablate_kernel<NR, STRIPED, kNoBest, kNoMask, kNoWindow>;
  const size_t per_warp =
      (size_t)ablate_smem_ints(NR, STRIPED, kNoWindow, a.R, a.W) *
      sizeof(int);
  int warps = kWarps;  // fewer warps a block where shared memory is short
  while (warps > 1 && warps * per_warp > kMaxSmem) warps /= 2;
  const size_t smem = warps * per_warp;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (a.B + warps - 1) / warps;
  if (grid > 0) {
    FGT_LAUNCH(kernel, grid, warps * 32, smem, (cudaStream_t)a.stream,
               (const int8_t*)a.read, (const int8_t*)a.win,
               (const int*)a.rlen, (const int*)a.wlen, a.B, a.R, a.W,
               a.match, a.mismatch, a.go, a.ge, 0, (int*)a.score_out,
               (int*)a.pos_out);
  }
  return (int)cudaGetLastError();
}

// NR = ceil(R / 32) rows per thread in one stripe up to 32 kMaxRows rows;
// longer reads in stripes of kMaxRows rows per thread.
template <bool kNoBest, bool kNoMask, bool kNoWindow>
int ablate_rows(const AblateCall& a) {
  switch (max(1, (a.R + 31) / 32)) {
#define FGT_CASE(N) \
  case N:           \
    return launch_ablate<N, false, kNoBest, kNoMask, kNoWindow>(a);
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
      return launch_ablate<kMaxRows, true, kNoBest, kNoMask, kNoWindow>(a);
  }
}

}  // namespace

extern "C" {

int fgt_fma_ceiling(const void* x, int R, int B, int trips, float a,
                    float b, float zero, void* out, void* stream) {
  if (R < 1 || R > 1024 || trips % kUnroll != 0)
    return (int)cudaErrorInvalidValue;  // the wrapper refuses these
  if (B > 0) {
    FGT_LAUNCH(fma_ceiling_kernel, B, R, R * sizeof(float),
               (cudaStream_t)stream, (const float*)x, (float*)out, R, B,
               trips, a, b, zero);
  }
  return (int)cudaGetLastError();
}

// flags: 1 no_best, 2 no_mask, 4 no_window.  The wrapper keeps R + W +
// 12 <= 4096 (a key's low 12 bits hold D - jj) and R * match < 2^18.
int fgt_sw_score_ablate(const void* read, const void* win, const void* rlen,
                        const void* wlen, int B, int R, int W, int match,
                        int mismatch, int go, int ge, int flags,
                        void* score_out, void* pos_out, void* stream) {
  if (R < 1 || W < 1 || R + W + kMaxRows > kPosStride)
    return (int)cudaErrorInvalidValue;
  const AblateCall a{read, win, rlen, wlen, B, R, W, match, mismatch, go,
                     ge, score_out, pos_out, stream};
  switch (flags) {
#define FGT_CASE(F) \
  case F:           \
    return ablate_rows<(F & 1) != 0, (F & 2) != 0, (F & 4) != 0>(a);
    FGT_CASE(0)
    FGT_CASE(1)
    FGT_CASE(2)
    FGT_CASE(3)
    FGT_CASE(4)
    FGT_CASE(5)
    FGT_CASE(6)
    FGT_CASE(7)
#undef FGT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
