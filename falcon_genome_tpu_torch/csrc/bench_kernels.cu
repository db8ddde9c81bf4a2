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
//                            score-only Smith-Waterman kernel with slot
//                            groups removed.
//   Follows make_kernel exactly: every diagonal d = 1..R+W is swept for
//   all R rows (no early stop); the cell at row r, column j = d - r reads
//   win[min(j - 1, W - 1)] for j >= 1 and 0 for j <= 0 (kNoWindow: 0
//   always); E/F/H as fgt_sw_score; unless kNoMask, cells outside
//   1 <= j <= wlen, r < rlen hold H = 0, E = F = NEG; unless kNoBest, the
//   best H under (score desc, d * 4096 + r asc) over all R rows, else the
//   max over rows of H on the last diagonal with pos 0.  The base variant
//   equals fgt_sw_score.
//   What bounds it: int32 issue, ~12 ops per cell, (R + W) * R cells per
//   alignment (136 M at R = 160, W = 416, B = 2048); a few hundred bytes
//   of input per alignment.
//   Design: fgt_sw_score's -- one warp per alignment, 32-row stripes, the
//   row above through __shfl_up_sync and, across stripes, a shared-memory
//   row indexed by column (columns 1 - R .. R + W, since the swept band
//   starts left of the matrix).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 64;
constexpr int kUnroll = 4;  // trips per iteration of the trip loop
constexpr int kNeg = -(1 << 28);
constexpr int kPosStride = 4096;
constexpr int kWarps = 4;  // alignments (warps) per block
constexpr unsigned kFull = 0xffffffffu;

__global__ void fma_ceiling_kernel(const float* __restrict__ x,
                                   float* __restrict__ out, int R, int B,
                                   int trips, float a, float b, float zero) {
  extern __shared__ float rows[];
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

template <bool kNoBest, bool kNoMask, bool kNoWindow>
__global__ void __launch_bounds__(kWarps * 32)
sw_ablate_kernel(const int8_t* __restrict__ read,
                 const int8_t* __restrict__ win,
                 const int* __restrict__ rlen, const int* __restrict__ wlen,
                 int B, int R, int W, int match, int mismatch, int go,
                 int ge, int* __restrict__ score_out,
                 int* __restrict__ pos_out) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + wib;
  if (b >= B) return;  // uniform across the warp
  const int ncol = 2 * R + W + 1;  // column j at index j + R
  int* bufH = smem + wib * 2 * ncol;
  int* bufF = bufH + ncol;
  const int rl = rlen[b];
  const int wl = wlen[b];
  const int8_t* rd = read + (size_t)b * R;
  const int8_t* wn = win + (size_t)b * W;
  const int D = R + W;
  const int nstripes = (R + 31) >> 5;
  int best_s = 0, best_p = 0, last = 0;
  for (int s = 0; s < nstripes; ++s) {
    const int r = (s << 5) + lane;
    const bool row = r < R;
    const bool rowvalid = r < rl;
    const int rb = row ? (int)rd[r] : -1;
    int hL = 0, eL = kNeg;    // H, E of (r, j - 1)
    int myH = 0, myF = kNeg;  // this row's last H, F (read by row r + 1)
    int upPrev = 0;           // H(r - 1, j - 1)
    for (int d = 1; d <= D; ++d) {
      const int j = d - r;
      int uH = __shfl_up_sync(kFull, myH, 1);
      int uF = __shfl_up_sync(kFull, myF, 1);
      if (lane == 0) {
        // row 0 sees the fill (H 0, F NEG); a later stripe's first row
        // reads the previous stripe's last row, which holds its initial
        // state on diagonal 0
        const bool prev = s > 0 && d >= 2;
        uH = prev ? bufH[j + R] : 0;
        uF = prev ? bufF[j + R] : kNeg;
      }
      const int dH = upPrev;
      upPrev = uH;
      int e = max(hL - go, eL - ge);
      int f = max(uH - go, uF - ge);
      const int c = (kNoWindow || j < 1) ? 0 : (int)wn[min(j - 1, W - 1)];
      const int diag = dH + (rb == c ? match : -mismatch);
      int h = max(max(0, diag), max(e, f));
      if (!kNoMask && !(rowvalid && j >= 1 && j <= wl)) {
        h = 0;
        e = kNeg;
        f = kNeg;
      }
      if (row) {
        if (kNoBest) {
          if (d == D) last = max(last, h);
        } else {
          keep_best(best_s, best_p, h, d * kPosStride + r);
        }
      }
      hL = h;
      eL = e;
      myH = h;
      myF = f;
      if (lane == 31 && s + 1 < nstripes) {
        bufH[j + R] = h;
        bufF[j + R] = f;
      }
      __syncwarp();
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

template <bool kNoBest, bool kNoMask, bool kNoWindow>
int launch_ablate(const void* read, const void* win, const void* rlen,
                  const void* wlen, int B, int R, int W, int match,
                  int mismatch, int go, int ge, void* score_out,
                  void* pos_out, void* stream) {
  auto kernel = sw_ablate_kernel<kNoBest, kNoMask, kNoWindow>;
  const size_t smem = (size_t)kWarps * 2 * (2 * R + W + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (B + kWarps - 1) / kWarps;
  if (grid > 0) {
    kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
        (const int8_t*)read, (const int8_t*)win, (const int*)rlen,
        (const int*)wlen, B, R, W, match, mismatch, go, ge,
        (int*)score_out, (int*)pos_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fgt_fma_ceiling(const void* x, int R, int B, int trips, float a,
                    float b, float zero, void* out, void* stream) {
  if (R < 1 || R > 1024 || trips % kUnroll != 0)
    return (int)cudaErrorInvalidValue;  // the wrapper refuses these
  if (B > 0) {
    fma_ceiling_kernel<<<B, R, R * sizeof(float), (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, R, B, trips, a, b, zero);
  }
  return (int)cudaGetLastError();
}

// flags: 1 no_best, 2 no_mask, 4 no_window
int fgt_sw_score_ablate(const void* read, const void* win, const void* rlen,
                        const void* wlen, int B, int R, int W, int match,
                        int mismatch, int go, int ge, int flags,
                        void* score_out, void* pos_out, void* stream) {
  switch (flags) {
#define FGT_CASE(F)                                                       \
  case F:                                                                 \
    return launch_ablate<(F & 1) != 0, (F & 2) != 0, (F & 4) != 0>(       \
        read, win, rlen, wlen, B, R, W, match, mismatch, go, ge, score_out, \
        pos_out, stream);
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
