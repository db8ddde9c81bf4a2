// PairHMM forward likelihood for NVIDIA Hopper (sm_90a).
//
// Two entry points over one kernel template (kPerBase):
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
//   the reference's NaN-propagating max does; the reference tests all
//   R + H diagonals, so a pair whose row 0 can fall below 2^-60 sweeps on
//   past rlen + hlen, without sums, for the test alone (a quality-0 first
//   base; see `late` in the kernel);
//   float32 arithmetic as XLA's CPU backend runs the reference (read off
//   the object code it emits, where LLVM forms the fused multiply-adds):
//   every result subnormal-flushed (this source is built with -ftz=true),
//   each a * b + c * d above as fma(a, b, c * d) with no other
//   contraction (built with --fmad=false; the FMAs below are explicit),
//   and the mismatch prior err / 3 as err * float(1/3);
//   the phred -> probability table is the reference's powf(10, -q * 0.1f);
//   the likelihood sum adds fma(X, prior, I) from two rows a thread on
//   (33 read rows and more, where XLA splits the row reduction and leaves
//   the prior's product unrounded), X being M before its prior, and
//   prior * X + I up to 32 rows;
//   log10(acc) - shift - 120 log10(2) is XLA's float32 log (its Cephes
//   polynomial, FMAs where XLA's code has them) times float(log10(e))
//   less the shift in one FMA, then plus float(-120 log10(2)); -inf where
//   acc is 0.
// The kernel writes that log10 likelihood per pair.
//
// What bounds it on the H100: a serial f32 recurrence over rlen + hlen
// anti-diagonals per pair, 8 floating-point instructions per cell and
// ~1 KB of input per pair -- bound by the instruction rate (every warp
// instruction of a step, float or not, takes a scheduler slot of its SM
// sub-partition), never by DRAM.
//
// Design: one warp per read x haplotype pair.  Thread t owns NR
// consecutive read rows (NR = ceil(R / 32), a template parameter, so the
// state lives in registers); the warp sweeps anti-diagonals and passes the
// only cross-thread values -- the last row's M, I, D -- to the next thread
// with __shfl_up_sync.
//
// Where the rescale can fire, the sweep must stay a wavefront over ALL
// rows of the bucket: the rescale test takes the largest |M|+|I|+|D| over
// every row of diagonals d and d - 1 at each d that is a multiple of 64,
// and a pair that fires is flushed differently from one that does not.  A
// column-per-thread skew (one column per thread per step, as gpuPairHMM
// sweeps) puts the cells of one diagonal at different steps and cannot give
// the same rescale decisions.  Cells right of the haplotype (j > hlen) and
// pad rows past rlen (phred 0: p_ins = p_cont = 1, a_mm = a_im = 0) feed
// that maximum too, so there they are computed like any other cell, as in
// the plain version.
//
// For most pairs the test cannot fire: row 0 lies on every tested
// diagonal, its M there is prior * (bound * a_im) with row 0's own prior
// and a_im (K5's from its gcp plane's row 0; the gap opens do not enter),
// and the boundary changes only through a rescale.  So while the smaller
// prior times bound * a_im is at least 2^-60 (`late` false, the same
// rounding), the largest cell of every tested diagonal is too, and no
// rescale fires.  Rows at or past rlen then feed nothing: the recurrence
// flows downward, with row i's transitions its own, and only row
// rlen - 1's sum is the pair's.  K4 and K5 sweep such a pair over its own
// ceil(rlen / 32) rows a thread, rlen + hlen diagonals and no test; a
// `late` pair (a quality-0 first base, a gap continuation phred of 0 on
// row 0) takes the bucket's rows and the full sweep.  Each cell's
// arithmetic is the same either way, so are the bits.
//
// What the design does about that bound (per diagonal of a thread's
// NR rows: 3 shuffles, 3 selects for the boundary, one shared-memory byte,
// and per cell 8 float instructions of the recurrence, 2 adds for the
// row's sum, one AND and one select; about 74 instructions at NR = 5, of
// which 50 are FFMA/FMUL/FADD):
//   * bases are 4-bit masks (A, C, G, T = 1, 2, 4, 8; any other code 15),
//     so "equal, or either is N" is one AND.  The haplotype enters shared
//     memory as masks, padded in front by 32 NR bytes and behind by R
//     repeats of its last base, so the byte of diagonal d is at a fixed
//     offset from d with no clipping.  Row k of a thread needs at diagonal
//     d the byte row k - 1 used at d - 1: the thread's NR masks live in one
//     window (32 bits up to NR = 8, 64 bits for the 9-12 rows a thread of
//     reads up to 384 bases) that shifts by 4 bits per diagonal and takes
//     one new byte;
//   * a trip of the sweep takes four diagonals, the two state sets
//     swapping roles by name, so no register moves from "d - 1" to "d - 2"
//     and a quarter of the loop's own instructions per diagonal; the
//     rescale test falls on the last diagonal of a trip;
//   * no per-cell test of j >= 1: a cell left of the matrix has only zero
//     inputs (the one exception, row 0 at d = 1, is cut by starting the
//     boundary one diagonal late), and zero inputs give exact zeros;
//   * every row keeps its own sum of M + I over all diagonals; only row
//     rlen - 1's is the pair's (it sees exactly j in [1, hlen] by the time
//     the sweep ends at d = rlen + hlen, and +0 before), the others are
//     dropped.  This takes the test of "last row, inside the haplotype"
//     out of the cell; up to diagonal rlen that row is left of the matrix,
//     so the trips before it skip the sums;
//   * rows past R (R not 32 NR) are cut by a select, in a sweep of its own
//     (kRagged) that only the late pairs of such a bucket take.
//   * phreds arrive as the uint8 they are and turn into probabilities
//     through the 256-entry float32 table that the plain version indexes
//     (the wrapper puts it on the device once), so no float32 planes are
//     made, written and read back around the launch.
//   * the warps take pairs from a queue of the launch (an atomic ticket),
//     each until none is left, and the grid holds as many blocks as the
//     card runs at once: a block's slot is not held by its slowest pair
//     while its other warps idle, which a pair of its own rows a thread
//     would otherwise make worse.
// The per-thread state is kept in plain arrays passed by reference: the
// same state gathered into one struct went to local memory and cost half
// of the gain.  The rescale test is a warp max-reduction with shuffles,
// at the same diagonals and with the same threshold and factor as the
// reference; no float64 anywhere.  Left for later: the wavefront's ramps
// (a warp's rows enter and leave the matrix over 32 rows a thread of
// diagonals; about 37% of K4's slots at HaplotypeCaller's shape), by
// streaming the next pair into lanes that are done.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

constexpr int kWarps = 8;  // pairs (warps) per block: 8 timed 4% below 4
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRescaleEvery = 64;

// Transition constants: scalars (K4) or (B, R) phred planes (K5).
struct Trans {
  float p_ins, p_del, p_cont, a_mm, a_im;
  const uint8_t* ins;  // planes; null for K4
  const uint8_t* del;
  const uint8_t* cont;
};

// A base code as a mask: two bases match (equal, or either one is not
// A/C/G/T) exactly when their masks share a bit.
__device__ __forceinline__ unsigned base_mask(unsigned code) {
  return code < 4u ? 1u << code : 15u;
}

// One thread's rows of one anti-diagonal, and the row above its first row.
template <int NR>
struct Diag {
  float M[NR], I[NR], D[NR];
};
struct Above {
  float M, I, D;
};

// NR masks of 4 bits: one 32-bit word up to 8 rows a thread, else 64
template <int NR>
using Window = typename std::conditional<(NR > 8), unsigned long long,
                                         unsigned>::type;

// One thread's per-row constants, in registers.
template <int NR>
struct Rows {
  float pm[NR], pmm[NR];  // prior on a match, on a mismatch
  // K5's transitions (unused, and eliminated, for K4)
  float ti[NR], td[NR], tc[NR], tmm[NR], tim[NR];
  Window<NR> rmask;  // the rows' read-base masks, 4 bits each
  unsigned inside;   // bit k: row k < R (kRagged only)
};

// Diagonal d from X (diagonal d - 1) and Y (d - 2); the result overwrites
// Y, rows last to first, so that row k - 1 of Y is still d - 2 when row k
// reads it.  uX receives the row above at d - 1 (the next step's d - 2),
// uY holds the one the previous step received.  kFused: the row sums of a
// bucket of 33 rows and more (fma(X, prior, I)), whatever NR is.
template <int NR, bool kPerBase, bool kRagged, bool kSum,
          bool kFused = (NR > 1)>
__device__ __forceinline__ void sweep_step(
    const Rows<NR>& c, const Trans& tr, bool lane0, float bound,
    unsigned hap_byte, Window<NR>& win, const Diag<NR>& X, Diag<NR>& Y,
    Above& uX, const Above& uY, float (&acc)[NR]) {
  uX.M = __shfl_up_sync(kFull, X.M[NR - 1], 1);
  uX.I = __shfl_up_sync(kFull, X.I[NR - 1], 1);
  uX.D = __shfl_up_sync(kFull, X.D[NR - 1], 1);
  if (lane0) {  // the DP boundary above row 0
    uX.M = 0.0f;
    uX.I = 0.0f;
    uX.D = bound;
  }
  win = (win << 4) | hap_byte;
#pragma unroll
  for (int k = NR - 1; k >= 0; --k) {
    const float m2u = k == 0 ? uY.M : Y.M[k - 1];
    const float i2u = k == 0 ? uY.I : Y.I[k - 1];
    const float d2u = k == 0 ? uY.D : Y.D[k - 1];
    const float m1u = k == 0 ? uX.M : X.M[k - 1];
    const float i1u = k == 0 ? uX.I : X.I[k - 1];
    const bool match =
        (win & c.rmask & (Window<NR>(15u) << (4 * k))) != 0u;
    const float prior = match ? c.pm[k] : c.pmm[k];
    const float p_ins = kPerBase ? c.ti[k] : tr.p_ins;
    const float p_del = kPerBase ? c.td[k] : tr.p_del;
    const float p_cont = kPerBase ? c.tc[k] : tr.p_cont;
    const float a_mm = kPerBase ? c.tmm[k] : tr.a_mm;
    const float a_im = kPerBase ? c.tim[k] : tr.a_im;
    const float Xm = __fmaf_rn(m2u, a_mm, (i2u + d2u) * a_im);
    float Mn = prior * Xm;
    float In = __fmaf_rn(m1u, p_ins, i1u * p_cont);
    float Dn = __fmaf_rn(X.M[k], p_del, X.D[k] * p_cont);
    if (kRagged && !((c.inside >> k) & 1u)) Mn = In = Dn = 0.0f;
    Y.M[k] = Mn;
    Y.I[k] = In;
    Y.D[k] = Dn;
    // a row past R is never the pair's last row: its sum is dropped
    if (kSum) acc[k] += kFused ? __fmaf_rn(Xm, prior, In) : Mn + In;
  }
}

// Diagonals d (odd) and d + 1: S1 and S0 hold d - 1 and d - 2 going in,
// d + 1 and d coming out; hp[d] is the thread's new haplotype byte at d.
template <int NR, bool kPerBase, bool kRagged, bool kSum,
          bool kFused = (NR > 1)>
__device__ __forceinline__ void sweep_two(
    const Rows<NR>& c, const Trans& tr, bool lane0, float bound,
    const uint8_t* hp, int d, Window<NR>& win, Diag<NR>& S0, Diag<NR>& S1,
    Above& u0, Above& u1, float (&acc)[NR]) {
  sweep_step<NR, kPerBase, kRagged, kSum, kFused>(c, tr, lane0, bound, hp[d],
                                                  win, S1, S0, u1, u0, acc);
  sweep_step<NR, kPerBase, kRagged, kSum, kFused>(
      c, tr, lane0, bound, hp[d + 1], win, S0, S1, u0, u1, acc);
}

// The rescale test after diagonal d (a multiple of 64): A and B hold
// diagonals d and d - 1, u the row above at d - 1 (the next step's d - 2).
template <int NR>
__device__ __forceinline__ void rescale(Diag<NR>& A, Diag<NR>& B, Above& u,
                                        float& bound, float (&acc)[NR],
                                        float& sh) {
  const float thresh = 0x1p-60f;
  const float factor = 0x1p100f;
  const float shift_step = 30.102999566398120f;  // 100 log10(2)
  float m = 0.0f;
  bool nan = false;
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const float v1 = fabsf(A.M[k]) + fabsf(A.I[k]) + fabsf(A.D[k]);
    const float v2 = fabsf(B.M[k]) + fabsf(B.I[k]) + fabsf(B.D[k]);
    nan |= isnan(v1) || isnan(v2);
    m = fmaxf(m, fmaxf(v1, v2));
  }
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  nan = __any_sync(kFull, nan);
  if (!nan && m > 0.0f && m < thresh) {
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      A.M[k] *= factor;
      A.I[k] *= factor;
      A.D[k] *= factor;
      B.M[k] *= factor;
      B.I[k] *= factor;
      B.D[k] *= factor;
      acc[k] *= factor;
    }
    u.M *= factor;
    u.I *= factor;
    u.D *= factor;
    bound *= factor;
    sh += shift_step;
  }
}

// ln(x) for a positive normal x (or +inf) as XLA's CPU backend computes it:
// the Cephes polynomial of its code generator, operation for operation,
// with an FMA where its object code has one
__device__ __forceinline__ float xla_log(float x) {
  const unsigned bits = __float_as_uint(x);
  float e = (float)((int)(bits >> 23) - 127) + 1.0f;
  const float m = __uint_as_float((bits & 0x007fffffu) | 0x3f000000u);
  const bool small = m < 0.707106769f;
  const float t = (m - 1.0f) + (small ? m : 0.0f);
  e = e - (small ? 1.0f : 0.0f);
  const float z = t * t;
  const float t3 = z * t;
  const float a = __fmaf_rn(__fmaf_rn(t, 7.0376836e-2f, -1.1514610e-1f), t,
                            1.16769984e-1f);
  const float b = __fmaf_rn(__fmaf_rn(t, -1.2420141e-1f, 1.4249323e-1f), t,
                            -1.6668057e-1f);
  const float c = __fmaf_rn(__fmaf_rn(t, 2.0000714e-1f, -2.4999994e-1f), t,
                            3.3333331e-1f);
  const float y = __fmaf_rn(__fmaf_rn(__fmaf_rn(a, t3, b), t3, c), t3,
                            e * -2.12194440e-4f);
  const float r = __fmaf_rn(e, 0.693359375f, __fmaf_rn(-0.5f, z, t) + y);
  return x == __uint_as_float(0x7f800000u) ? x : r;
}

// log10 likelihood from the scaled sum and its log10 shift, as the
// reference's epilogue computes it; -inf where the sum is 0
__device__ __forceinline__ float finish(float acc, float sh) {
  if (!(acc > 0.0f)) return -__uint_as_float(0x7f800000u);
  const float r = xla_log(fmaxf(acc, 0x1p-126f));
  return __fmaf_rn(r, 0.434294492f, -sh) + -36.1236f;
}

// Whether a pair's state can still be rescaled past its own rows and
// diagonals: row 0's smaller prior times bound * a_im, the M of row 0 on
// every tested diagonal, below the threshold (or NaN)
__device__ __forceinline__ bool late_rescale(float pm, float pmm, float bound,
                                             float a_im) {
  return !(fminf(pm, pmm) * (bound * a_im) >= 0x1p-60f);
}

// Pair b's haplotype as masks into the warp's window hs: 32 NR zeros in
// front (read only by cells left of the matrix), then the haplotype and
// its last base repeated R times (the clipped gather)
template <int NR>
__device__ __forceinline__ void load_hap(uint8_t* hs,
                                         const uint8_t* __restrict__ hap,
                                         int b, int R, int H, int lane) {
  constexpr int kPad = 32 * NR;
  const int span = kPad + H + R;
  for (int p = lane; p < span; p += 32)
    hs[p] = p < kPad
                ? 0
                : base_mask(hap[(size_t)b * H + min(p - kPad, H - 1)]);
}

// The pair's sum (row rlen - 1's; 0 where it has no such row) and its
// log10 shift
struct Sum {
  float acc, sh;
};

// Pair b on the calling warp, thread `lane` holding rows lane NR .. lane NR
// + NR - 1; hs is the warp's haplotype window past its front zeros (at
// least 32 NR of them).  kAllRows: the bucket's rows (32 NR >= R), with the
// rescale test every 64 diagonals and, for a `late` pair, the sweep on to
// R + H.  Otherwise the pair's own rows (32 NR >= rlen), for a pair with
// 1 <= rlen <= R whose `late` is false: no test, since none can fire, and
// no select for rows past rlen, whose values reach nothing.  kFused: the
// bucket's row-sum rule.
template <int NR, bool kPerBase, bool kRagged, bool kFused, bool kAllRows>
__device__ __forceinline__ Sum sweep_pair(
    const uint8_t* __restrict__ read, const uint8_t* __restrict__ base_q,
    const float* __restrict__ prob, int b, int rl, int hl, int R, int H,
    const Trans& tr, const uint8_t* hs, int lane) {
  Rows<NR> c;
  c.rmask = 0u;
  c.inside = 0u;
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const int r = lane * NR + k;
    const bool row = r < R;
    const size_t at = (size_t)b * R + r;
    // phred -> probability through the wrapper's 256-entry table
    const float pe = row ? __ldg(prob + base_q[at]) : 0.0f;
    c.rmask |= Window<NR>(base_mask(row ? read[at] : 4u)) << (4 * k);
    c.inside |= (row ? 1u : 0u) << k;
    c.pm[k] = 1.0f - pe;
    c.pmm[k] = pe * (1.0f / 3.0f);
    if constexpr (kPerBase) {
      c.ti[k] = row ? __ldg(prob + tr.ins[at]) : 0.0f;
      c.td[k] = row ? __ldg(prob + tr.del[at]) : 0.0f;
      c.tc[k] = row ? __ldg(prob + tr.cont[at]) : 0.0f;
      c.tmm[k] = 1.0f - fminf(1.0f, c.ti[k] + c.td[k]);
      c.tim[k] = 1.0f - c.tc[k];
    }
  }
  // row r at diagonal d reads the haplotype at d - r - 2, clipped to
  // [0, H): with the padding, byte d of hp for this thread's first row
  const uint8_t* hp = hs - lane * NR - 2;
  const bool lane0 = lane == 0;
  float bound = 0x1p120f / fmaxf((float)hl, 1.0f);
  float sh = 0.0f;
  float acc[NR];
  Diag<NR> S0, S1;  // diagonals d - 2 and d - 1 at an odd d
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    acc[k] = 0.0f;
    S0.M[k] = S0.I[k] = S0.D[k] = 0.0f;
    S1.M[k] = S1.I[k] = S1.D[k] = 0.0f;
  }
  // rows above: u0 starts as zeros, so diagonal 1 (row 0 at j = 0) stays
  // zero; from diagonal 2 on row 0 sees D(0, j - 1) = bound
  Above u0{0.0f, 0.0f, 0.0f}, u1{0.0f, 0.0f, 0.0f};
  Window<NR> win = 0u;
  const int dmax = min(rl + hl, R + H);
  const bool has_row = rl >= 1 && rl <= R;
  // a pair whose row 0 can fall below the rescale threshold sweeps on to
  // R + H, as the reference does: a rescale there still scales its sum
  const float a_im0 = kPerBase ? c.tim[0] : tr.a_im;
  const bool late =
      kAllRows &&
      __shfl_sync(kFull,
                  (int)(has_row && late_rescale(c.pm[0], c.pmm[0], bound,
                                                a_im0)),
                  0) != 0;
  // up to diagonal rlen, row rlen - 1 is left of the matrix and its sum
  // stays +0: those trips leave the sums out
  const int dquiet = has_row ? min(rl, dmax) : dmax;
  int d = 1;
  for (; d + 3 <= dquiet; d += 4) {
    sweep_two<NR, kPerBase, kRagged, false, kFused>(c, tr, lane0, bound, hp,
                                                    d, win, S0, S1, u0, u1,
                                                    acc);
    sweep_two<NR, kPerBase, kRagged, false, kFused>(c, tr, lane0, bound, hp,
                                                    d + 2, win, S0, S1, u0,
                                                    u1, acc);
    // S1 is diagonal d + 3, S0 d + 2, u0 the row above at d + 2
    if (kAllRows && (d + 3) % kRescaleEvery == 0)
      rescale(S1, S0, u0, bound, acc, sh);
  }
  for (; d + 3 <= dmax; d += 4) {
    sweep_two<NR, kPerBase, kRagged, true, kFused>(c, tr, lane0, bound, hp,
                                                   d, win, S0, S1, u0, u1,
                                                   acc);
    sweep_two<NR, kPerBase, kRagged, true, kFused>(c, tr, lane0, bound, hp,
                                                   d + 2, win, S0, S1, u0,
                                                   u1, acc);
    if (kAllRows && (d + 3) % kRescaleEvery == 0)
      rescale(S1, S0, u0, bound, acc, sh);
  }
  // at most three diagonals are left, none of them a multiple of 64
  if (d + 1 <= dmax) {
    sweep_two<NR, kPerBase, kRagged, true, kFused>(c, tr, lane0, bound, hp,
                                                   d, win, S0, S1, u0, u1,
                                                   acc);
    d += 2;
  }
  if (d <= dmax)  // an odd rlen + hlen ends on a first half
    sweep_step<NR, kPerBase, kRagged, true, kFused>(
        c, tr, lane0, bound, hp[d], win, S1, S0, u1, u0, acc);
  // past the pair's end: no sums, the rescale test on every multiple of 64
  if (kAllRows) {
    for (int e = late ? dmax + 1 : R + H + 1; e <= R + H; ++e) {
      if (e & 1)
        sweep_step<NR, kPerBase, kRagged, false, kFused>(
            c, tr, lane0, bound, hp[e], win, S1, S0, u1, u0, acc);
      else
        sweep_step<NR, kPerBase, kRagged, false, kFused>(
            c, tr, lane0, bound, hp[e], win, S0, S1, u0, u1, acc);
      if (e % kRescaleEvery == 0) rescale(S1, S0, u0, bound, acc, sh);
    }
  }
  // the pair's sum is row rlen - 1's
  const int last = has_row ? rl - 1 : 0;
  float mine = 0.0f;
#pragma unroll
  for (int k = 0; k < NR; ++k)
    if (k == last % NR) mine = acc[k];
  mine = __shfl_sync(kFull, mine, last / NR);
  return Sum{has_row ? mine : 0.0f, sh};
}

// The sweep of a pair over its own rows, `rows` = ceil(rlen / 32) a thread
// (1 .. NR, the same across the warp): one inlined sweep_pair for each, all
// inside the bucket's kernel, whose registers the NR sweep sets
template <int NR, bool kPerBase, int N = 1>
__device__ __forceinline__ Sum sweep_own_rows(
    int rows, const uint8_t* __restrict__ read,
    const uint8_t* __restrict__ base_q, const float* __restrict__ prob,
    int b, int rl, int hl, int R, int H, const Trans& tr, const uint8_t* hs,
    int lane) {
  if constexpr (N < NR) {
    if (rows > N)
      return sweep_own_rows<NR, kPerBase, N + 1>(rows, read, base_q, prob, b,
                                                 rl, hl, R, H, tr, hs, lane);
  }
  return sweep_pair<N, kPerBase, false, (NR > 1), false>(
      read, base_q, prob, b, rl, hl, R, H, tr, hs, lane);
}

// Each warp takes pairs from the launch's queue until none is left.
// queue[0] is the next pair, queue[1] the warps done; the last warp done
// sets both back to 0, so the next launch on the stream, K4's or K5's,
// finds them so.  kRagged is true in every instantiation (a late pair
// chooses the row select in the kernel); it stays a parameter so that the
// kernels keep the names that traces and SASS comparisons match.
template <int NR, bool kPerBase, bool kRagged>
__global__ void __launch_bounds__(kWarps * 32)
pairhmm_kernel(const uint8_t* __restrict__ read,
               const uint8_t* __restrict__ base_q,
               const float* __restrict__ prob,
               const int* __restrict__ rlen, const uint8_t* __restrict__ hap,
               const int* __restrict__ hlen, int B, int R, int H, Trans tr,
               float* __restrict__ logp_out, int* __restrict__ queue) {
  static_assert(kRagged, "one instantiation a row count, every bucket");
  FGT_DYNAMIC_SMEM(uint8_t, hs_all);
  constexpr int kPad = 32 * NR;
  const int lane = threadIdx.x & 31;
  for (;;) {
    int b = lane == 0 ? atomicAdd(queue, 1) : 0;
    b = __shfl_sync(kFull, b, 0);
    if (b >= B) break;
    __syncwarp();  // every lane is done with the window's last pair
    uint8_t* hs = hs_all + (threadIdx.x >> 5) * (kPad + H + R);
    load_hap<NR>(hs, hap, b, R, H, lane);
    __syncwarp();
    const int rl = rlen[b];
    const int hl = hlen[b];
    // row 0's prior and a_im on the pair's first tested diagonal, as
    // sweep_pair forms them, decide whether the rescale can fire (every
    // lane alike)
    const size_t row0 = (size_t)b * R;
    const float pe = __ldg(prob + base_q[row0]);
    const float a_im0 =
        kPerBase ? 1.0f - __ldg(prob + tr.cont[row0]) : tr.a_im;
    const bool own =
        rl >= 1 && rl <= R &&
        !late_rescale(1.0f - pe, pe * (1.0f / 3.0f),
                      0x1p120f / fmaxf((float)hl, 1.0f), a_im0);
    // a late pair: the bucket's rows, with the row select only where the
    // bucket does not fill them (uniform across the launch)
    const Sum s =
        own ? sweep_own_rows<NR, kPerBase>((rl + 31) / 32, read, base_q, prob,
                                           b, rl, hl, R, H, tr, hs + kPad,
                                           lane)
        : R == 32 * NR
            ? sweep_pair<NR, kPerBase, false, (NR > 1), true>(
                  read, base_q, prob, b, rl, hl, R, H, tr, hs + kPad, lane)
            : sweep_pair<NR, kPerBase, true, (NR > 1), true>(
                  read, base_q, prob, b, rl, hl, R, H, tr, hs + kPad, lane);
    if (lane == 0) logp_out[b] = finish(s.acc, s.sh);
  }
  if (lane == 0) {
    __threadfence();  // this warp's last ticket before its count
    if (atomicAdd(queue + 1, 1) == (int)gridDim.x * kWarps - 1) {
      queue[0] = 0;
      queue[1] = 0;
    }
  }
}

// The arguments of one call, as the C entry points receive them.
struct Call {
  const void* read;
  const void* base_q;  // (B, R) uint8 phreds
  const void* prob;    // float32[256]: phred -> probability
  const void* rlen;
  const void* hap;
  const void* hlen;
  int B, R, H;
  Trans tr;
  void* logp_out;
  void* queue;  // int32[2], zero
  void* stream;
};

// lets `kernel` take `smem` bytes of dynamic shared memory
template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                   (int)smem)
             : cudaSuccess;
}

// The bucket R at NR = N rows a thread: one instantiation (<N, kPerBase,
// true>) for every bucket, so that each N compiles its own-rows sweeps
// once; none of them has the row select, and the late pairs choose the
// sweep with or without it in the kernel.
template <int NR, bool kPerBase>
int launch_pairhmm(const Call& a) {
  const size_t smem = (size_t)kWarps * (32 * NR + a.H + a.R);
  const auto kernel = pairhmm_kernel<NR, kPerBase, true>;
  cudaError_t e = allow_smem(kernel, smem);
  // the blocks the card runs at once (asked once a thread for each card
  // and size), and no more than the pairs fill
  thread_local int held_dev = -1;
  thread_local size_t held_smem = 0;
  thread_local int held = 0;
  int dev = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != held_dev || smem != held_smem) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kWarps * 32, smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    held = per_sm * sms > 1 ? per_sm * sms : 1;
    held_dev = dev;
    held_smem = smem;
  }
  const int grid = min(held, (a.B + kWarps - 1) / kWarps);
  if (grid > 0) {
    FGT_LAUNCH(kernel, grid, kWarps * 32, smem, (cudaStream_t)a.stream,
               (const uint8_t*)a.read, (const uint8_t*)a.base_q,
               (const float*)a.prob, (const int*)a.rlen,
               (const uint8_t*)a.hap, (const int*)a.hlen, a.B, a.R, a.H,
               a.tr, (float*)a.logp_out, (int*)a.queue);
  }
  return (int)cudaGetLastError();
}

template <bool kPerBase>
int dispatch_rows(const Call& a) {
  if (a.R < 1 || a.H < 1) return (int)cudaErrorInvalidValue;
  switch ((a.R + 31) / 32) {
#define FGT_CASE(N) \
  case N:           \
    return launch_pairhmm<N, kPerBase>(a);
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
      return (int)cudaErrorInvalidValue;  // R > 384: the wrapper refuses it
  }
}

}  // namespace

extern "C" int fgt_pairhmm(const void* read, const void* base_q,
                           const void* table, const void* rlen,
                           const void* hap, const void* hlen, int B, int R,
                           int H, float p_ins, float p_del, float p_cont,
                           float a_mm, float a_im, void* logp_out,
                           void* queue, void* stream) {
  const Trans tr{p_ins, p_del, p_cont, a_mm, a_im, nullptr, nullptr,
                 nullptr};
  return dispatch_rows<false>(Call{read, base_q, table, rlen, hap, hlen, B,
                                   R, H, tr, logp_out, queue, stream});
}

extern "C" int fgt_pairhmm_pb(const void* read, const void* base_q,
                              const void* ins_q, const void* del_q,
                              const void* gcp, const void* table,
                              const void* rlen, const void* hap,
                              const void* hlen, int B, int R, int H,
                              void* logp_out, void* queue, void* stream) {
  const Trans tr{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, (const uint8_t*)ins_q,
                 (const uint8_t*)del_q, (const uint8_t*)gcp};
  return dispatch_rows<true>(Call{read, base_q, table, rlen, hap, hlen, B, R,
                                  H, tr, logp_out, queue, stream});
}
