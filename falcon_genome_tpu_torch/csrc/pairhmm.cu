// PairHMM forward likelihood for NVIDIA Hopper (sm_90a).
//
// Two entry points share one kernel template:
//   fgt_pairhmm     replaces K4, _pairhmm_kernel_sc of
//                   falcon_genome_tpu/ops/pairhmm.py: scalar insertion,
//                   deletion and gap-continuation penalties (GATK
//                   HaplotypeCaller runs 45/45/gcp);
//   fgt_pairhmm_pb  replaces K5, _pairhmm_kernel of the same file: per-base
//                   p_ins, p_del, p_cont planes (B, R), as BQSR's BI/BD
//                   tags give them.
// Semantics follow the reference's portable wavefront _pairhmm_jax, which
// the tests hold the kernels' plain PyTorch twin to.  Every transition is
// indexed by the DESTINATION row i (a_mm = 1 - min(1, p_ins + p_del) and
// a_im = 1 - p_cont per row, in float32):
//   M(i,j) = prior * (M(i-1,j-1) a_mm + (I(i-1,j-1) + D(i-1,j-1)) a_im)
//   I(i,j) = M(i-1,j) p_ins + I(i-1,j) p_cont
//   D(i,j) = M(i,j-1) p_del + D(i,j-1) p_cont
//   prior = 1 - err on a match (N matches everything), err / 3 otherwise;
//   D(0, j) = 2^120 / hap_len (free start), cells with j < 1 are zero;
//   acc = sum over j in [1, hlen] of M(rlen, j) + I(rlen, j);
//   hap positions past H repeat the last one (the reference's clipped
//   gather);
//   every 64 diagonals d = i + j, a pair whose largest |M|+|I|+|D| over
//   the current and previous diagonal is in (0, 2^-60) is rescaled by
//   2^100 (state, boundary and acc), the shift kept in log10; a NaN in
//   that state (0 * inf once the boundary has overflowed) stops it, as
//   the reference's NaN-propagating max does;
//   float32 arithmetic as the reference's CPU backend runs it: every
//   result subnormal-flushed (this source is built with -ftz=true), and
//   a * b + c * d as fma(a, b, c * d) with no other contraction (built
//   with --fmad=false; the FMAs below are explicit), and the mismatch
//   prior err / 3 as err * float(1/3).
// The kernel returns acc and the shift; the wrapper forms
// log10(acc) - shift - 120 log10(2), or -inf where acc is 0.
//
// What bounds it on the H100: a serial f32 recurrence over rlen + hlen
// anti-diagonals per pair, with a handful of FMAs per cell and ~1 KB of
// input per pair -- latency- and issue-bound, never DRAM-bound.
//
// Design (after gpuPairHMM): one warp per read x haplotype pair.  Thread t
// owns NR consecutive read rows (NR = ceil(R / 32), a template parameter,
// so the state lives in registers); the warp sweeps anti-diagonals and
// passes the only cross-thread values -- the last row's M, I, D -- to the
// next thread with __shfl_up_sync.  The haplotype sits in shared memory.
// K5 keeps each thread's rows' five transition constants in registers
// beside the state; a pad row past rlen (phred 0: p_ins = p_cont = 1,
// a_mm = a_im = 0) is computed like any other row, as in the plain version,
// so its overflow reaches the rescale test the same way.
// The rescale test is a warp max-reduction with shuffles, at the same
// diagonals and with the same threshold and factor as the reference; no
// float64 anywhere.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // pairs (warps) per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRescaleEvery = 64;

// Transition constants: scalars (K4) or (B, R) probability planes (K5).
struct Trans {
  float p_ins, p_del, p_cont, a_mm, a_im;
  const float* ins;  // planes; null for K4
  const float* del;
  const float* cont;
};

template <int NR, bool kPerBase>
__global__ void __launch_bounds__(kWarps * 32)
pairhmm_kernel(const uint8_t* __restrict__ read,
               const float* __restrict__ p_err,
               const int* __restrict__ rlen, const uint8_t* __restrict__ hap,
               const int* __restrict__ hlen, int B, int R, int H, Trans tr,
               float* __restrict__ acc_out,
               float* __restrict__ shift_out) {
  extern __shared__ uint8_t hs_all[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + wib;
  if (b >= B) return;  // uniform across the warp
  uint8_t* hs = hs_all + wib * H;
  for (int j = lane; j < H; j += 32) hs[j] = hap[(size_t)b * H + j];
  __syncwarp();

  const int rl = rlen[b];
  const int hl = hlen[b];
  const float thresh = 0x1p-60f;
  const float factor = 0x1p100f;
  const float shift_step = 30.102999566398120f;  // 100 log10(2)

  int rc[NR];
  float pm[NR], pmm[NR];
  float M1[NR], I1[NR], D1[NR], M2[NR], I2[NR], D2[NR];
  // K5's per-row constants (unused, and eliminated, for K4)
  float ti[NR], td[NR], tc[NR], tmm[NR], tim[NR];
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const int r = lane * NR + k;
    const bool row = r < R;
    const size_t at = (size_t)b * R + r;
    const float pe = row ? p_err[at] : 0.0f;
    rc[k] = row ? (int)read[at] : 4;
    pm[k] = 1.0f - pe;
    pmm[k] = pe * (1.0f / 3.0f);
    M1[k] = I1[k] = D1[k] = M2[k] = I2[k] = D2[k] = 0.0f;
    if constexpr (kPerBase) {
      ti[k] = row ? tr.ins[at] : 0.0f;
      td[k] = row ? tr.del[at] : 0.0f;
      tc[k] = row ? tr.cont[at] : 0.0f;
      tmm[k] = 1.0f - fminf(1.0f, ti[k] + td[k]);
      tim[k] = 1.0f - tc[k];
    }
  }
  float bound = 0x1p120f / fmaxf((float)hl, 1.0f);
  float acc = 0.0f, sh = 0.0f;
  float pM = 0.0f, pI = 0.0f, pD = 0.0f;  // row above, diagonal d - 2
  const int dmax = rl + hl;
  for (int d = 1; d <= dmax; ++d) {
    // row above this thread's first row: d - 1 from the shuffle, d - 2
    // from the previous step's shuffle; row 0 sees the DP boundary
    float uM1 = __shfl_up_sync(kFull, M1[NR - 1], 1);
    float uI1 = __shfl_up_sync(kFull, I1[NR - 1], 1);
    float uD1 = __shfl_up_sync(kFull, D1[NR - 1], 1);
    float uM2 = pM, uI2 = pI, uD2 = pD;
    if (lane == 0) {
      uM1 = 0.0f;
      uI1 = 0.0f;
      uD1 = bound;
      uM2 = 0.0f;
      uI2 = 0.0f;
      uD2 = bound;
    }
    pM = uM1;
    pI = uI1;
    pD = uD1;
    float Mn[NR], In[NR], Dn[NR];
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int r = lane * NR + k;
      const int j = d - r - 1;
      const float m2u = k == 0 ? uM2 : M2[k - 1];
      const float i2u = k == 0 ? uI2 : I2[k - 1];
      const float d2u = k == 0 ? uD2 : D2[k - 1];
      const float m1u = k == 0 ? uM1 : M1[k - 1];
      const float i1u = k == 0 ? uI1 : I1[k - 1];
      if (j >= 1 && r < R) {
        const int c = hs[min(j, H) - 1];
        const bool match = rc[k] == c || rc[k] >= 4 || c >= 4;
        const float prior = match ? pm[k] : pmm[k];
        const float p_ins = kPerBase ? ti[k] : tr.p_ins;
        const float p_del = kPerBase ? td[k] : tr.p_del;
        const float p_cont = kPerBase ? tc[k] : tr.p_cont;
        const float a_mm = kPerBase ? tmm[k] : tr.a_mm;
        const float a_im = kPerBase ? tim[k] : tr.a_im;
        Mn[k] = prior * __fmaf_rn(m2u, a_mm, (i2u + d2u) * a_im);
        In[k] = __fmaf_rn(m1u, p_ins, i1u * p_cont);
        Dn[k] = __fmaf_rn(M1[k], p_del, D1[k] * p_cont);
        if (r + 1 == rl && j <= hl) acc += Mn[k] + In[k];
      } else {
        Mn[k] = In[k] = Dn[k] = 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      M2[k] = M1[k];
      I2[k] = I1[k];
      D2[k] = D1[k];
      M1[k] = Mn[k];
      I1[k] = In[k];
      D1[k] = Dn[k];
    }
    if (d % kRescaleEvery == 0) {
      float m = 0.0f;
      bool nan = false;
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        const float v1 = fabsf(M1[k]) + fabsf(I1[k]) + fabsf(D1[k]);
        const float v2 = fabsf(M2[k]) + fabsf(I2[k]) + fabsf(D2[k]);
        nan |= isnan(v1) || isnan(v2);
        m = fmaxf(m, fmaxf(v1, v2));
      }
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
      nan = __any_sync(kFull, nan);
      if (!nan && m > 0.0f && m < thresh) {
#pragma unroll
        for (int k = 0; k < NR; ++k) {
          M1[k] *= factor;
          I1[k] *= factor;
          D1[k] *= factor;
          M2[k] *= factor;
          I2[k] *= factor;
          D2[k] *= factor;
        }
        pM *= factor;
        pI *= factor;
        pD *= factor;
        acc *= factor;
        bound *= factor;
        sh += shift_step;
      }
    }
  }
  // one lane owns row rlen - 1; every other lane's acc is 0
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) {
    acc_out[b] = acc;
    shift_out[b] = sh;
  }
}

template <int NR, bool kPerBase>
int launch_pairhmm(const void* read, const void* p_err, const void* rlen,
                   const void* hap, const void* hlen, int B, int R, int H,
                   const Trans& tr, void* acc_out, void* shift_out,
                   void* stream) {
  const size_t smem = (size_t)kWarps * H;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pairhmm_kernel<NR, kPerBase>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (B + kWarps - 1) / kWarps;
  if (grid > 0) {
    pairhmm_kernel<NR, kPerBase>
        <<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
            (const uint8_t*)read, (const float*)p_err, (const int*)rlen,
            (const uint8_t*)hap, (const int*)hlen, B, R, H, tr,
            (float*)acc_out, (float*)shift_out);
  }
  return (int)cudaGetLastError();
}

template <bool kPerBase>
int dispatch_rows(const void* read, const void* p_err, const void* rlen,
                  const void* hap, const void* hlen, int B, int R, int H,
                  const Trans& tr, void* acc_out, void* shift_out,
                  void* stream) {
  switch ((R + 31) / 32) {
#define FGT_CASE(N)                                                        \
  case N:                                                                  \
    return launch_pairhmm<N, kPerBase>(read, p_err, rlen, hap, hlen, B, R, \
                                       H, tr, acc_out, shift_out, stream);
    FGT_CASE(1)
    FGT_CASE(2)
    FGT_CASE(3)
    FGT_CASE(4)
    FGT_CASE(5)
    FGT_CASE(6)
    FGT_CASE(7)
    FGT_CASE(8)
#undef FGT_CASE
    default:
      return (int)cudaErrorInvalidValue;  // R > 256: the wrapper refuses it
  }
}

}  // namespace

extern "C" int fgt_pairhmm(const void* read, const void* p_err,
                           const void* rlen, const void* hap,
                           const void* hlen, int B, int R, int H,
                           float p_ins, float p_del, float p_cont,
                           float a_mm, float a_im, void* acc_out,
                           void* shift_out, void* stream) {
  const Trans tr{p_ins, p_del, p_cont, a_mm, a_im, nullptr, nullptr,
                 nullptr};
  return dispatch_rows<false>(read, p_err, rlen, hap, hlen, B, R, H, tr,
                              acc_out, shift_out, stream);
}

extern "C" int fgt_pairhmm_pb(const void* read, const void* p_err,
                              const void* p_ins, const void* p_del,
                              const void* p_cont, const void* rlen,
                              const void* hap, const void* hlen, int B,
                              int R, int H, void* acc_out, void* shift_out,
                              void* stream) {
  const Trans tr{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, (const float*)p_ins,
                 (const float*)p_del, (const float*)p_cont};
  return dispatch_rows<true>(read, p_err, rlen, hap, hlen, B, R, H, tr,
                             acc_out, shift_out, stream);
}
