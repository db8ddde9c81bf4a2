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
// recurrences along a wavefront -- latency- and issue-bound, not
// memory-bound (a few hundred bytes of input per alignment).  K2 also
// writes one pointer byte per cell, (R + W) * R bytes per alignment
// (0.55 GB for 8192 aligner lanes at R = 160, W = 256), so it carries a
// DRAM write stream beside the recurrence.  K3 is a dependent chain of
// single-byte loads per alignment: latency-bound.
//
// Design: one warp per alignment, rows in stripes of 32 -- thread t owns
// row 32 s + t of stripe s and computes column j = k - t + 1 at step k, so
// the warp holds one anti-diagonal of the stripe and passes each row's H
// and F to the row below with __shfl_up_sync.  The stripe's last row is
// kept in shared memory for the next stripe's first row.  This covers any
// read length with no per-length template and lets each alignment stop at
// its own rlen/wlen.  At step k every thread of the warp is on the same
// diagonal d = 32 s + k + 1, so the pointer array is laid out per
// alignment as [d][r]: a warp's 32 pointer bytes per step are one
// contiguous 32-byte store.  Best cells are kept per thread under the
// (score desc, bestpos asc) order and reduced across the warp with
// shuffles.  K3 is one thread per alignment walking that layout.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -(1 << 28);
constexpr int kPosStride = 4096;
constexpr int kWarps = 4;          // alignments (warps) per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void keep_best(int& s, int& p, int os, int op) {
  if (os > s || (os == s && op < p)) {
    s = os;
    p = op;
  }
}

template <bool FULL>
__global__ void __launch_bounds__(kWarps * 32)
sw_kernel(const int8_t* __restrict__ read, const int8_t* __restrict__ win,
          const int* __restrict__ rlen, const int* __restrict__ wlen,
          int B, int R, int W, int match, int mismatch, int go, int ge,
          int8_t* __restrict__ ptr, int* __restrict__ score_out,
          int* __restrict__ pos_out) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + wib;
  if (b >= B) return;  // uniform across the warp
  int* bufH = smem + wib * 2 * (W + 1);
  int* bufF = bufH + (W + 1);
  const int rl = min(rlen[b], R);
  const int wl = min(wlen[b], W);
  for (int j = lane; j <= W; j += 32) {  // row 0 boundary: H = 0, F = NEG
    bufH[j] = 0;
    bufF[j] = kNeg;
  }
  __syncwarp();
  const int8_t* rd = read + (size_t)b * R;
  const int8_t* wn = win + (size_t)b * W;
  int8_t* pb = FULL ? ptr + (size_t)b * (size_t)(R + W) * R : nullptr;
  int best_s = 0, best_p = 0;
  const int nstripes = (rl + 31) >> 5;
  for (int s = 0; s < nstripes; ++s) {
    const int r = (s << 5) + lane;
    const bool rowvalid = r < rl;
    const int rb = rowvalid ? (int)rd[r] : -1;
    int hL = 0, eL = kNeg;      // H, E of (r, j - 1)
    int myH = 0, myF = kNeg;    // this row's last H, F (read by row r + 1)
    int upPrev = 0;             // H(r - 1, j - 1)
    const int nsteps = wl + 31;
    for (int k = 0; k < nsteps; ++k) {
      const int j = k - lane + 1;
      int uH = __shfl_up_sync(kFull, myH, 1);
      int uF = __shfl_up_sync(kFull, myF, 1);
      if (lane == 0) {  // row above comes from the previous stripe
        const bool in = j <= wl;
        uH = in ? bufH[j] : 0;
        uF = in ? bufF[j] : kNeg;
      }
      const int dH = upPrev;
      upPrev = uH;
      const int e_open = hL - go, e_ext = eL - ge;
      int e = max(e_open, e_ext);
      const int f_open = uH - go, f_ext = uF - ge;
      int f = max(f_open, f_ext);
      const bool valid = rowvalid && j >= 1 && j <= wl;
      const int c = valid ? (int)wn[j - 1] : 5;
      const int diag = dH + (rb == c ? match : -mismatch);
      int h = max(max(0, diag), max(e, f));
      if (valid) {
        const int d = r + j;
        keep_best(best_s, best_p, h, d * kPosStride + r);
        if (FULL) {
          const int hdir = h == 0 ? 0 : (h == diag ? 1 : (h == e ? 2 : 3));
          pb[(size_t)d * R + r] = (int8_t)(hdir | ((e_ext > e_open) << 2)
                                           | ((f_ext > f_open) << 3));
        }
      } else {
        h = 0;
        e = kNeg;
        f = kNeg;
      }
      hL = h;
      eL = e;
      myH = h;
      myF = f;
      if (lane == 31 && j >= 1 && j <= wl) {
        bufH[j] = h;
        bufF[j] = f;
      }
      __syncwarp();
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

__global__ void sw_traceback_kernel(const int8_t* __restrict__ ptr,
                                    const int* __restrict__ best,
                                    const int* __restrict__ pos, int B,
                                    int R, int W, int max_steps,
                                    uint8_t* __restrict__ packed,
                                    int* __restrict__ coords) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int8_t* pb = ptr + (size_t)b * (size_t)(R + W) * R;
  const int p = pos[b];
  const int dprog = p / kPosStride, r = p % kPosStride;
  const int bi = r + 1, bj = dprog - r;
  int i = bi, j = bj, phase = 0;  // phase 0 = H, 1 = E (D run), 2 = F (I run)
  bool active = best[b] > 0;
  const int S4 = (max_steps + 3) / 4;
  unsigned acc = 0;
  for (int t = 0; t < 4 * S4; ++t) {
    int op = -1;
    if (active && t < max_steps && i > 0 && j > 0) {
      const int byte = pb[(size_t)(i + j - 1) * R + (i - 1)];
      const int hdir = byte & 3;
      const bool is_h = phase == 0;
      const bool stop = is_h && hdir == 0;
      const bool do_m = is_h && hdir == 1;
      const bool in_e = phase == 1 || (is_h && hdir == 2);
      const bool in_f = !in_e && (phase == 2 || (is_h && hdir == 3));
      if (!stop) {
        op = do_m ? 0 : (in_e ? 2 : 1);  // SAM M / D / I
        if (do_m || in_f) --i;
        if (do_m || in_e) --j;
      }
      phase = (in_e && ((byte >> 2) & 1)) ? 1
              : ((in_f && ((byte >> 3) & 1)) ? 2 : 0);
      active = !stop;
    } else {
      active = false;
    }
    acc |= (unsigned)(op + 1) << (2 * (t & 3));
    if ((t & 3) == 3) {
      packed[(size_t)(t >> 2) * B + b] = (uint8_t)acc;
      acc = 0;
    }
  }
  coords[b] = i;
  coords[B + b] = j;
  coords[2 * B + b] = bi;
  coords[3 * B + b] = bj;
}

template <bool FULL>
int launch_sw(const void* read, const void* win, const void* rlen,
              const void* wlen, int B, int R, int W, int match,
              int mismatch, int go, int ge, void* ptr, void* score_out,
              void* pos_out, void* stream) {
  const size_t smem = (size_t)kWarps * 2 * (W + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sw_kernel<FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (B + kWarps - 1) / kWarps;
  if (grid > 0) {
    sw_kernel<FULL><<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
        (const int8_t*)read, (const int8_t*)win, (const int*)rlen,
        (const int*)wlen, B, R, W, match, mismatch, go, ge, (int8_t*)ptr,
        (int*)score_out, (int*)pos_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fgt_sw_score(const void* read, const void* win, const void* rlen,
                 const void* wlen, int B, int R, int W, int match,
                 int mismatch, int go, int ge, void* score_out,
                 void* pos_out, void* stream) {
  return launch_sw<false>(read, win, rlen, wlen, B, R, W, match, mismatch,
                          go, ge, nullptr, score_out, pos_out, stream);
}

int fgt_sw_full(const void* read, const void* win, const void* rlen,
                const void* wlen, int B, int R, int W, int match,
                int mismatch, int go, int ge, void* ptr, void* score_out,
                void* pos_out, void* stream) {
  return launch_sw<true>(read, win, rlen, wlen, B, R, W, match, mismatch,
                         go, ge, ptr, score_out, pos_out, stream);
}

int fgt_sw_traceback(const void* ptr, const void* best, const void* pos,
                     int B, int R, int W, int max_steps, void* packed,
                     void* coords, void* stream) {
  const int threads = 128;
  const int grid = (B + threads - 1) / threads;
  if (grid > 0) {
    sw_traceback_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)ptr, (const int*)best, (const int*)pos, B, R, W,
        max_steps, (uint8_t*)packed, (int*)coords);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
