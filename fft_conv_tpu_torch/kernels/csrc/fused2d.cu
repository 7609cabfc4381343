// Fused 2D overlap-save FFT convolution for Hopper (sm_90a), in FP32.
//
// Kernel B2 (fused2d_forward) replaces the TPU kernel
// fft_conv_tpu/kernels/fused2d.py:308 (_make_kernel_2d, built by
// _fused2d_call): the valid cross-correlation of a (B, Cin, Hp, Wp) signal
// with a (Cout, Cin/g, K1, K2) kernel, computed on overlap-save tiles of
// T1 x T2 samples (T1 in {128, 256, 384} at T2 = 128, T1 = 128 at T2 = 256)
// that overlap by K1-1 rows and K2-1 columns. Per tile: the one-sided H DFT
// (NB1 = T1/2+1 rows), the full W DFT, a per-bin grouped complex MAC over the
// group's input channels against the conjugated kernel spectra, the inverse
// W DFT, and the H irfft on the V1 valid rows (DC and Nyquist weighted 1, the
// rest 2). The host side (tile plan, factors, kernel spectra, tile ranges) is
// in fft_conv_tpu_torch/kernels/fused2d.py.
//
// Factored DFTs. The TPU kernel runs every DFT as a dense matrix product on
// its matrix unit: 128 complex multiply-adds per point and axis. Here each
// axis is a four-step transform T = A * B (128 = 16 * 8, 256 = 16 * 16,
// 384 = 24 * 16; fourstep.fft_factor_matrices, built in float64 and cast to
// float32 by the host): the A-point DFT over j1 of x[j1 B + j2], the twiddle
// tw[m1, j2], the B-point DFT over j2, bin m1 + A m2. A thread holds one short
// DFT in registers; a power-of-two length runs as radix-2 butterflies on the
// roots of unity (row 1 of the factor), 24 as the dense product. Real data is
// packed in pairs: rows 2r and 2r+1 of the window are one complex row for the
// W DFT, whose bins k and -k are split apart when the H DFT reads them;
// columns 0 and T2/2 (real in H) share one complex H transform; the inverse
// runs the H irfft on two columns at once as one complex transform of their
// Hermitian extensions. So a tile costs a few tens of flops per point and
// axis, where a dense 128-point product costs 512 (real input) to 1024.
//
// Partition. A block holds one NB1 x T2 complex plane in shared memory
// (66.5 KB at T1 = T2 = 128, 197.6 KB at T1 = 384), swizzled (column
// c ^ (row & 15)) so that neighbouring rows fall in distinct banks. Two
// kernels run back to back on the caller's stream:
//   phase 1, grid (B * Cin, tiles): read one channel's window straight from
//     the padded signal (zeros past its edge), the W DFT of the packed rows
//     in place, then the H DFT on G columns at a time through a staging
//     buffer, its bins written in natural order (D[-k1, -k2] = conj D[k1, k2]
//     fills the columns past T2/2) to a scratch D (tiles, B * Cin, NB1, T2);
//   phase 2, grid (B * Cout, tiles): MAC over the group's channels of D
//     against the spectra (both read through L2) into the plane, the inverse
//     W DFT in place, then the H irfft on G column pairs at a time, storing
//     the V1 x V2 valid samples straight into (B, Cout, OH, OW).
// The caller runs the tiles in ranges so that D stays bounded.
//
// Bound. At the library's 2D benchmark shapes (B=2, 8 -> 8 channels,
// 512 x 512, K in {16, 34}) the factored transforms and the MAC come to about
// 1 GFLOP a call and the signal, spectra and output to about 37 MB, so the
// card's bound is a few hundredths of a millisecond and neither HBM nor the
// FP32 rate sets the pace: shared-memory traffic does (each axis reads and
// writes the plane twice), with the barriers between the steps, and phase 2
// re-reading D and the spectra through L2 once per output channel, most of
// B2's time. Serving several output channels per read of D (the
// tensor-core route's MAC stage does, below), TMA staging and fusing the two
// phases are left for later work.
//
// Entry point: fused2d_forward (plain C interface, loaded with ctypes). It
// returns cudaGetLastError() after the launches; 0 means both were accepted.
//
// Kernel B5 (fused2d_v3_forward, further down) replaces the TPU kernel
// fft_conv_tpu/kernels/fused2d.py:419 (_make_kernel_2d_v3): the same function
// on the "v3" schedule, where the forward runs H first and the inverse runs H
// first on the MAC's output. It uses B2's plan, factors, plane, staging and
// short DFTs (B2Smem without the packed column), and the v3 layouts: D and the
// spectra as split (re, im) planes.
//   phase 1, grid (B * Cin, tiles): the H DFT of the window's columns q and
//     q + T2/2 packed as one complex column, read straight from the signal;
//     bins k and -k of each packed column split into the two columns'
//     one-sided spectra; the W DFT of the NB1 rows in place; D out as
//     (tiles, B * Cin, 2, NB1, T2), equal to B2's D up to rounding;
//   phase 2, grid (B * Cout, tiles): B2's MAC into the plane, then the folded
//     H-first inverse: the real output needs only the W-Hermitian half h of
//     z = C Y (C the one-sided H inverse), and h[., l] is one T1-point inverse
//     DFT of a spectrum assembled from Y's columns l and T2 - l (T2/2 of them
//     a tile, columns 0 and T2/2 sharing one), written back into the slots of
//     those two columns; then the W c2r of the V1 valid rows, two rows as one
//     complex T2-point inverse, stored straight into (B, Cout, OH, OW).
// Per tile and output channel the inverse runs T2/2 T1-point transforms and
// ceil(V1/2) T2-point ones, where B2's runs T2/2 and NB1. The only dense short DFT is
// the 24-point one at T1 = 384, as in B2.
//
// B2's tensor-core modes (fused2d.py: set_fused2d_precision "bf16x3" and
// "bf16", the JAX package's switch of that name, fft_conv_tpu/kernels/
// fused2d.py:52-71, whose modes reach every DFT product of the 2D body
// through _dot; they replace the same TPU kernel, _make_kernel_2d). A route
// of three kernels <T1, T2, MODE> (entry point fused2d_forward_tc) computes
// B2's function on B2's plan, with every DFT step a bf16 mma.sync product
// with an FP32 accumulator (bf16_mma.cuh: dft_tile), as the TPU kernel forms
// each DFT product from bf16 operands under those modes: each axis factored
// as B2 factors it (16 * 8, 16 * 16, 24 * 16; a 24-point step is three
// whole k-steps of 16), each step's matrix read as B fragments from the
// host's buffer (fused2d.py: _tc_fragments). Factored and not dense: a
// dense 128-point step would do 5x the products of 16 * 8, and its matrices
// (hi and lo, forward and conjugated) would take 512 KB where all the
// factored steps' take 28 KB, re-read by every warp. The operands stay FP32
// in the planes and a warp splits them into bf16 hi/lo as it loads them, so
// that one plane serves every mode and fits a block at T1 = 384. The
// twiddles (rounded as the plain version rounds them, without FMA: a bf16
// rounding that goes the other way early in a tile spreads through its
// later steps), the split of the packed pairs, the MAC, the Hermitian
// extension and 1/(T1 T2) stay FP32, and so do D and Y: the operands of the
// DFT steps are the only values rounded to bf16, where the plain version
// (fused2d.py: _tc_spectra, _tc_inverse) rounds them.
//   phase 1, fused2d_spectra_tc, grid (B * Cin, tiles): the window by
//     4-byte cp.async, rows 2r and 2r + 1 packed as one complex row (zeros
//     past the edge); the W DFT of the packed rows, each warp owning 8 rows
//     through both steps (row_dft_tc: the steps meet at __syncwarp, and a
//     row DFT leaves bin m1 + A m2 at column m1 B + m2, tc_col); the H DFT on
//     G columns a pass through the staging, each warp owning G / 8 of them
//     through both steps (hstep_tiles); D (tiles, B * Cin, NB1, T2) in
//     natural order, as B2's;
//   MAC stage, fused2d_mac_tc, grid (unit blocks, NB1, groups x output-
//     channel blocks): for one bin row k1 and up to 8 units (a unit is one
//     tile of one batch row) and the group's output channels (64 rows of
//     the plane at T2 = 128, fused2d.py: _tc_geometry), Y = sum_c D[c] K[o,
//     c] in FP32 in the channels' order, each thread one column, holding
//     the spectra of 4 output and 4 input channels in registers, D's rows
//     streamed through the block's cp.async ring 3 units ahead; then the
//     inverse W DFT of the block's rows (row_dft_tc) and Y (tiles, B, Cout,
//     NB1, T2) out as the next stage's plane image;
//   inverse stage, fused2d_inverse_tc, grid (B * Cout, tiles): Y's plane in
//     by 16-byte cp.async, the H irfft of G column pairs a pass through the
//     staging (hstep_tiles), the V1 x V2 valid samples into (B, Cout, OH,
//     OW).
// What bounds each stage, by count at the 2D rows (B = 2, 8 -> 8, 512^2,
// K = 16 / 34: 25 / 36 tiles; times in PERF.md). Phase 1 and the
// inverse stage: shared memory, each axis reading and writing the plane or
// the staging in the per-warp chain of loads, products and stores of each
// 16-vector tile. Each warp owns its rows (W) or columns (H) through both
// steps of a transform, so the steps meet at __syncwarp: phase 1 waits at
// two block barriers (its window in, the W DFT done) and the inverse stage
// at one, where B2's pair waited at two for every step pair. The MAC
// stage: bytes through L2. Where B2's pair re-read D and the spectra per
// output channel (426 / 613 MB a call), one read of D serves every output
// channel and one of a block's spectra its 8 units: D 26.6 / 38.3 MB once,
// the spectra 4.26 MB once a unit block (7 / 9 blocks), Y written and read
// once (2 x 26.6 / 38.3 MB), about 110 / 155 MB, with D's rows in flight 3
// units ahead (a barrier a unit); its FP32 MAC, 0.21 / 0.31 GFLOP, is a few
// microseconds at the card's FP32 rate. The step lanes are placed for 16
// distinct bank pairs a load or store at T2 = 128 (the row groups' j2 and
// m1 pairs, stg, the H steps' vector order).
//
// B5's tensor-core modes (the same switch under set_fused2d_kernel("v3"),
// replacing fft_conv_tpu/kernels/fused2d.py:419, _make_kernel_2d_v3, whose
// _dot products at :456-458 and :473-477 take the mode): a route of three
// kernels a tile range behind fused2d_v3_forward_tc, on B2's route's
// pieces in B5's order, with the same D, Y, fragments and geometry.
//   phase 1, fused2d_v3_spectra_tc, grid (B * Cin, tiles): the window by
//     4-byte cp.async, columns q and q + T2/2 as one complex column, laid
//     out (v3_win) in the slots that the column's bins take after its H DFT
//     (v3_bin), so that each warp's H DFT (hstep_tiles) writes over what only
//     it reads and the window needs no buffer of its own (at T1 = 384 the
//     plane and the staging fill the block); then the W DFT of T1/2 rows, not
//     NB1: rows 0 and T1/2 of the one-sided spectrum, both real, packed as
//     one complex row X[0] + i X[T1/2], so that at T1 = 128 the 8 warps take
//     the 64 rows in one round of 8 each. Each warp owns its rows from the
//     split to D (row_group_tc): step 1 splits bins k and -k of the packed
//     columns in FP32 as it loads them (the arithmetic of v3_split), and
//     step 2 stores the bins to D in natural order straight from the
//     product, but row 0's bins Z, which the warp splits in FP32 into D's
//     rows 0 and T1/2 ((Z[k] + conj Z[-k]) / 2 and (Z[k] - conj Z[-k]) / 2i,
//     as B2's phase 1 splits its packed column): B2's D, which the MAC stage
//     reads against natural-order spectra. Two block barriers: the window
//     in, the H DFT done;
//   MAC stage, fused2d_mac_tc<T1, T2, 0>: B2's, without the inverse W DFT
//     (B5's inverse runs H first, on every bin row, which a MAC block does
//     not hold): Y's rows in natural bin order, the plane image as before;
//   inverse stage, fused2d_v3_inverse_tc, grid (B * Cout, tiles): Y in by
//     16-byte cp.async; the folded H inverse of fused2d_v3_mac_inverse
//     (folded_s's values, formed without branches by folded_s_tc: columns 0
//     and T2/2 share one transform, the imaginary parts of their bins 0 and
//     T1/2 dropped), each warp owning its column pairs
//     through both steps, h[2p] and h[2p + 1] written into row p of the
//     plane, at columns l and T2 - l of the pair's own (pair_store); then
//     the W c2r of the ceil(V1 / 2) row pairs in place, warp w owning pairs
//     [w P / 8, (w + 1) P / 8) of the P (all 8 warps busy: 7 pairs each at
//     K = 16, 5 or 6 at K = 34), each its pairs through both steps
//     (row_group_tc with step 1's tiles closed under c -> T2 - c, whose
//     loads form E_2p + i E_2p+1 from columns c and T2 - c of row p,
//     pair_c2r_in, E_2p+1 zero past an odd V1), step 2 storing the two
//     output rows' samples with 1/(T1 T2) straight from the product, eight
//     consecutive samples of a row a lane group, the 1/T1 left for the
//     output so that no bf16 operand is rounded after a division by T1 =
//     384. Two block barriers: Y in, the H inverse done; no staging, no
//     chunks and no second pass for the c2r.
// What bounds it, by count as B2's route: shared memory in phase 1 and the
// inverse stage, bytes through L2 in the MAC stage. Measured by knocking
// parts out (PERF.md), the scalar work around the products weighs most: the
// index arithmetic and the branches of the loads that form each step's
// input, so those loads run without branches and the window's loop steps
// its addresses. Times in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // a Hopper block's shared memory

// ---- Kernel B2: factored DFTs ------------------------------------------------

// The four-step split T = A * B of a DFT length T in {128, 256, 384}
// (fused2d.py: _SPLITS).
__host__ __device__ constexpr int split_a(int t) { return t == 384 ? 24 : 16; }
__host__ __device__ constexpr int split_b(int t) { return t == 128 ? 8 : 16; }
// columns (phase 1) or column pairs (phase 2) of one H pass through the staging
__host__ __device__ constexpr int stage_cols(int t1) { return t1 >= 384 ? 8 : 32; }

// One block's dynamic shared memory, either phase: the NB1 x T2 plane, the
// staging (G x T1), the packed DC/Nyquist column (T1; B2 only) and the
// factors (A and B roots and the twiddle of each axis), all float2. Past
// T1 = 384 the plane alone, which is already more than a block can hold.
__host__ __device__ constexpr size_t smem_bytes(int t1, int t2, bool packed = true) {
  return t1 > 384 ? sizeof(float2) * (size_t)(t1 / 2 + 1) * t2
                  : sizeof(float2) * ((size_t)(t1 / 2 + 1) * t2 + (size_t)stage_cols(t1) * t1 +
                                      (packed ? t1 : 0) + split_a(t1) + split_b(t1) + t1 +
                                      split_a(t2) + split_b(t2) + t2);
}

template <int T1, int T2>
struct B2Plan {
  static constexpr int kA1 = split_a(T1), kB1 = split_b(T1);
  static constexpr int kA2 = split_a(T2), kB2 = split_b(T2);
  static constexpr int kNB1 = T1 / 2 + 1, kG = stage_cols(T1);
  static constexpr int kPlane = kNB1 * T2, kStage = kG * T1;
  static constexpr int kFac = kA1 + kB1 + T1 + kA2 + kB2 + T2;
  static constexpr size_t kSmem = smem_bytes(T1, T2);
  static constexpr size_t kSmemV3 = smem_bytes(T1, T2, false);  // B5: no packed column
  static constexpr int kMinBlocks = T1 == 128 && T2 == 128 ? 2 : 1;
  static_assert(kSmem <= (size_t)kMaxSmem, "B2's plane does not fit a block");
  static_assert(kThreads % kA2 == 0 && kB1 % 2 == 0, "unsupported split");
};

__host__ __device__ constexpr int bitrev(int i, int n) {
  int r = 0;
  for (int m = n >> 1; m > 0; m >>= 1, i >>= 1) r = (r << 1) | (i & 1);
  return r;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// a * w, or a * conj(w) for the inverse
template <bool INV>
__device__ __forceinline__ float2 cmulw(float2 a, float2 w) {
  if (INV) w.y = -w.y;
  return make_float2(fmaf(a.x, w.x, -a.y * w.y), fmaf(a.x, w.y, a.y * w.x));
}

// acc += a * b (complex)
__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

// One radix-2 stage of LEN-point butterflies (decimation in time), then the
// next; the twiddle root[0] = 1 is skipped.
template <int N, int LEN, bool INV>
__device__ __forceinline__ void dit_stages(float2 (&t)[N], const float2* root) {
  if constexpr (LEN <= N) {
#pragma unroll
    for (int i = 0; i < N; i += LEN) {
#pragma unroll
      for (int j = 0; j < LEN / 2; ++j) {
        const float2 u = t[i + j];
        float2 w = t[i + j + LEN / 2];
        if (j != 0) w = cmulw<INV>(w, root[j * (N / LEN)]);
        t[i + j] = cadd(u, w);
        t[i + j + LEN / 2] = csub(u, w);
      }
    }
    dit_stages<N, 2 * LEN, INV>(t, root);
  }
}

// v <- the N-point DFT of v (INV: conjugated, unscaled), natural order in and
// out; root[k] = exp(-2 pi i k / N) in shared memory. A power of two runs as
// radix-2 butterflies on the bit-reversed input; another N as the dense
// product f[m, j] = root[(m j) % N].
template <int N, bool INV>
__device__ __forceinline__ void short_dft(float2 (&v)[N], const float2* root) {
  float2 t[N];
  if constexpr ((N & (N - 1)) == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) t[i] = v[bitrev(i, N)];
    dit_stages<N, 2, INV>(t, root);
  } else {
#pragma unroll
    for (int m = 0; m < N; ++m) {
      float2 acc = v[0];
#pragma unroll
      for (int j = 1; j < N; ++j) {
        const int k = (m * j) % N;
        if (k == 0) {
          acc = cadd(acc, v[j]);
        } else {
          const float2 w = root[k];
          cmac(acc, v[j], INV ? make_float2(w.x, -w.y) : w);
        }
      }
      t[m] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = t[i];
}

// Index of (row, column) in the swizzled plane of rows of T2 complex values.
template <int T2>
__device__ __forceinline__ int sw(int r, int c) {
  return r * T2 + (c ^ (r & 15));
}

// In-place DFT (INV: conjugated, unscaled) of rows [0, nrows) of the plane,
// T = A * B, natural bin order in and out. Step 1, one (row, j2) a thread at
// a time, in place: the A-point DFT over j1 of [j1 B + j2] and the twiddle,
// left at [m1 B + j2]. Step 2, 256 / A rows at a time: the B-point DFT over j2
// of [m1 B + j2], held in registers across a barrier and written back at the
// natural bins m1 + A m2. Neighbouring lanes take neighbouring rows, which the
// swizzle puts in distinct banks. Ends with a barrier.
template <int T, bool INV>
__device__ void row_dft(float2* s_p, int nrows, const float2* ra, const float2* rb,
                        const float2* tw) {
  constexpr int A = split_a(T), B = split_b(T), R = kThreads / A;
  const int tid = threadIdx.x;
  for (int t = tid; t < nrows * B; t += kThreads) {
    const int row = t % nrows, j2 = t / nrows;
    float2 v[A];
#pragma unroll
    for (int j1 = 0; j1 < A; ++j1) v[j1] = s_p[sw<T>(row, j1 * B + j2)];
    short_dft<A, INV>(v, ra);
#pragma unroll
    for (int m1 = 0; m1 < A; ++m1)
      s_p[sw<T>(row, m1 * B + j2)] = m1 == 0 ? v[0] : cmulw<INV>(v[m1], tw[m1 * B + j2]);
  }
  __syncthreads();
  const int m1 = tid / R;
  for (int r0 = 0; r0 < nrows; r0 += R) {
    const int row = r0 + tid % R;
    float2 u[B];
    if (row < nrows) {
#pragma unroll
      for (int j2 = 0; j2 < B; ++j2) u[j2] = s_p[sw<T>(row, m1 * B + j2)];
      short_dft<B, INV>(u, rb);
    }
    __syncthreads();  // every row of the round is read before any is written
    if (row < nrows) {
#pragma unroll
      for (int m2 = 0; m2 < B; ++m2) s_p[sw<T>(row, m1 + A * m2)] = u[m2];
    }
    __syncthreads();
  }
}

// Shared memory of a B2 block: plane, staging, packed column (PACKED; B5's
// blocks have none), factors.
template <int T1, int T2, bool PACKED = true>
struct B2Smem {
  float2 *plane, *stage, *packed, *ra1, *rb1, *tw1, *ra2, *rb2, *tw2;

  // carves the dynamic shared memory and stages the factors (no barrier)
  __device__ __forceinline__ B2Smem(unsigned char* raw, const float2* __restrict__ fac) {
    using P = B2Plan<T1, T2>;
    plane = reinterpret_cast<float2*>(raw);
    stage = plane + P::kPlane;
    packed = PACKED ? stage + P::kStage : nullptr;
    ra1 = stage + P::kStage + (PACKED ? T1 : 0);
    for (int i = threadIdx.x; i < P::kFac; i += kThreads) ra1[i] = __ldg(fac + i);
    rb1 = ra1 + P::kA1;
    tw1 = rb1 + P::kB1;
    ra2 = tw1 + T1;
    rb2 = ra2 + P::kA2;
    tw2 = rb2 + P::kB2;
  }
};

template <int T1, int T2>
__global__ void __launch_bounds__(kThreads, B2Plan<T1, T2>::kMinBlocks)
fused2d_spectra(const float* __restrict__ x,    // (B, Cin, hp, wp)
                const float2* __restrict__ fac,  // factors, fused2d.py: _device_factors
                float2* __restrict__ d,          // (tiles of this launch, B * Cin, NB1, T2)
                int hp, int wp, int v1, int v2, int nt2, int tile0) {
  using P = B2Plan<T1, T2>;
  constexpr int A1 = P::kA1, B1 = P::kB1, G = P::kG, N1 = T1 / 2, N2 = T2 / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const B2Smem<T1, T2> s(smem_raw, fac);
  float2* s_p = s.plane;

  const int tid = threadIdx.x;
  const int tile = tile0 + blockIdx.y;
  const int h0 = (tile / nt2) * v1, w0 = (tile % nt2) * v2;
  const float* xs = x + (int64_t)blockIdx.x * hp * wp;

  // the window, rows 2r and 2r + 1 packed as complex row r (zeros past the edge)
  for (int i = tid; i < N1 * T2; i += kThreads) {
    const int r = i / T2, c = i % T2, hr = h0 + 2 * r, wc = w0 + c;
    float2 z = make_float2(0.f, 0.f);
    if (wc < wp) {
      if (hr < hp) z.x = __ldg(xs + (int64_t)hr * wp + wc);
      if (hr + 1 < hp) z.y = __ldg(xs + (int64_t)(hr + 1) * wp + wc);
    }
    s_p[sw<T2>(r, c)] = z;
  }
  __syncthreads();

  // W DFT of the packed rows: Z_r[k] = X_2r[k] + i X_2r+1[k]
  row_dft<T2, false>(s_p, N1, s.ra2, s.rb2, s.tw2);

  // H DFT of column col of X, col in [1, T2/2), or of X[., 0] + i X[., T2/2]
  // for col = 0; G columns a pass
  float2* dout = d + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * P::kPlane;
  for (int c0 = 0; c0 < N2; c0 += G) {
    for (int t = tid; t < G * B1; t += kThreads) {
      const int g = t % G, j2 = t / G, col = c0 + g;
      const bool odd = j2 & 1;  // row j1 B1 + j2 has the parity of j2
      const int ck = col == 0 ? 0 : col, cm = col == 0 ? N2 : T2 - col;
      float2 v[A1];
#pragma unroll
      for (int j1 = 0; j1 < A1; ++j1) {
        const int rr = (j1 * B1 + j2) >> 1;
        const float2 zk = s_p[sw<T2>(rr, ck)], zm = s_p[sw<T2>(rr, cm)];
        if (col == 0)  // X_r[0] + i X_r[T2/2], both real
          v[j1] = odd ? make_float2(zk.y, zm.y) : make_float2(zk.x, zm.x);
        else  // X_2r[k] = (Z[k] + conj Z[-k]) / 2, X_2r+1[k] = (Z[k] - conj Z[-k]) / 2i
          v[j1] = odd ? make_float2(0.5f * (zk.y + zm.y), 0.5f * (zm.x - zk.x))
                      : make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
      }
      short_dft<A1, false>(v, s.ra1);
#pragma unroll
      for (int m1 = 0; m1 < A1; ++m1)
        s.stage[(m1 * B1 + j2) * G + g] =
            m1 == 0 ? v[0] : cmulw<false>(v[m1], s.tw1[m1 * B1 + j2]);
    }
    __syncthreads();
    for (int t = tid; t < G * A1; t += kThreads) {
      const int g = t % G, m1 = t / G, col = c0 + g;
      float2 u[B1];
#pragma unroll
      for (int j2 = 0; j2 < B1; ++j2) u[j2] = s.stage[(m1 * B1 + j2) * G + g];
      short_dft<B1, false>(u, s.rb1);
#pragma unroll
      for (int m2 = 0; m2 < B1; ++m2) {
        const int k1 = m1 + A1 * m2;
        if (col == 0) {
          s.packed[k1] = u[m2];
        } else {
          if (k1 <= N1) dout[k1 * T2 + col] = u[m2];
          if (k1 == 0 || k1 >= N1)  // D[-k1, -col] = conj X[k1, col]
            dout[((T1 - k1) % T1) * T2 + T2 - col] = make_float2(u[m2].x, -u[m2].y);
        }
      }
    }
    __syncthreads();
    if (c0 == 0) {  // split C = X0 + i XN into columns 0 and T2/2
      for (int k = tid; k < P::kNB1; k += kThreads) {
        const float2 p = s.packed[k], q = s.packed[(T1 - k) % T1];
        dout[k * T2] = make_float2(0.5f * (p.x + q.x), 0.5f * (p.y - q.y));
        dout[k * T2 + N2] = make_float2(0.5f * (p.y + q.y), 0.5f * (q.x - p.x));
      }
    }
  }
}

template <int T1, int T2>
__global__ void __launch_bounds__(kThreads, B2Plan<T1, T2>::kMinBlocks)
fused2d_mac_inverse(const float2* __restrict__ d,    // (tiles of this launch, B * Cin, NB1, T2)
                    const float2* __restrict__ ks,   // (Cout, Cin/g, NB1, T2), conjugated
                    const float2* __restrict__ fac,  // factors, fused2d.py: _device_factors
                    float* __restrict__ out,         // (B, Cout, oh, ow)
                    int batch, int cin, int cout, int groups, int v1, int v2, int nt2,
                    int tile0, int oh, int ow) {
  using P = B2Plan<T1, T2>;
  constexpr int A1 = P::kA1, B1 = P::kB1, G = P::kG, N1 = T1 / 2, N2 = T2 / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const B2Smem<T1, T2> s(smem_raw, fac);
  float2* s_p = s.plane;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / cout, o = blockIdx.x % cout;
  const int cpg = cin / groups, g0 = o / (cout / groups);
  const int tile = tile0 + blockIdx.y;
  const int h0 = (tile / nt2) * v1, w0 = (tile % nt2) * v2;
  const int64_t plane = P::kPlane;

  // per-bin MAC over this out-channel's group: Y = sum_c D[c] * K[o, c]
  const float2* dg = d + (((int64_t)blockIdx.y * batch + b) * cin + (int64_t)g0 * cpg) * plane;
  const float2* ko = ks + (int64_t)o * cpg * plane;
  for (int i = tid; i < P::kPlane; i += kThreads) {
    float2 y = make_float2(0.f, 0.f);
    for (int ci = 0; ci < cpg; ++ci) cmac(y, __ldg(dg + ci * plane + i), __ldg(ko + ci * plane + i));
    s_p[sw<T2>(i / T2, i % T2)] = y;
  }
  __syncthreads();

  // inverse W DFT of the NB1 rows, in place
  row_dft<T2, true>(s_p, P::kNB1, s.ra2, s.rb2, s.tw2);

  // H irfft of columns 2q and 2q + 1 at once: the inverse DFT of
  // c = H_2q + i H_2q+1, H the Hermitian extension of a one-sided column,
  // whose real and imaginary parts are the two real output columns
  const float scale = 1.f / (float)(T1 * T2);
  float* oplane = out + ((int64_t)b * cout + o) * oh * ow;
  for (int c0 = 0; c0 < N2; c0 += G) {
    for (int t = tid; t < G * B1; t += kThreads) {
      const int g = t % G, j2 = t / G, q = c0 + g;
      float2 v[A1];
#pragma unroll
      for (int j1 = 0; j1 < A1; ++j1) {
        const int k = j1 * B1 + j2, kk = k <= N1 ? k : T1 - k, sh = kk & 15;
        // columns 2q and 2q + 1 sit side by side, in swapped order for odd rows
        const float4 e = *reinterpret_cast<const float4*>(s_p + kk * T2 + ((2 * q) ^ (sh & ~1)));
        const float2 e0 = sh & 1 ? make_float2(e.z, e.w) : make_float2(e.x, e.y);
        const float2 e1 = sh & 1 ? make_float2(e.x, e.y) : make_float2(e.z, e.w);
        if (k == 0 || k == N1)  // real bins: their imaginary parts drop out
          v[j1] = make_float2(e0.x, e1.x);
        else if (k < N1)  // E0 + i E1
          v[j1] = make_float2(e0.x - e1.y, e0.y + e1.x);
        else  // conj(E0) + i conj(E1) of bin T1 - k
          v[j1] = make_float2(e0.x + e1.y, e1.x - e0.y);
      }
      short_dft<A1, true>(v, s.ra1);
#pragma unroll
      for (int m1 = 0; m1 < A1; ++m1)
        s.stage[(m1 * B1 + j2) * G + g] =
            m1 == 0 ? v[0] : cmulw<true>(v[m1], s.tw1[m1 * B1 + j2]);
    }
    __syncthreads();
    for (int t = tid; t < G * A1; t += kThreads) {
      const int g = t % G, m1 = t / G, z = 2 * (c0 + g), ox = w0 + z;
      float2 u[B1];
#pragma unroll
      for (int j2 = 0; j2 < B1; ++j2) u[j2] = s.stage[(m1 * B1 + j2) * G + g];
      short_dft<B1, true>(u, s.rb1);
#pragma unroll
      for (int m2 = 0; m2 < B1; ++m2) {
        const int vr = m1 + A1 * m2, oy = h0 + vr;
        if (vr < v1 && oy < oh) {
          float* row = oplane + (int64_t)oy * ow + ox;
          if (z < v2 && ox < ow) row[0] = u[m2].x * scale;
          if (z + 1 < v2 && ox + 1 < ow) row[1] = u[m2].y * scale;
        }
      }
    }
    __syncthreads();  // the staging is read before the next pass overwrites it
  }
}

template <int T1, int T2>
cudaError_t launch(const float* x, const float2* ks, const float2* fac, float2* d, float* out,
                   int batch, int cin, int cout, int groups, int hp, int wp, int v1, int v2,
                   int nt2, int tile0, int ntile, int oh, int ow, cudaStream_t stream) {
  constexpr size_t smem = B2Plan<T1, T2>::kSmem;
  if (v1 < 1 || v1 > T1 || v2 < 1 || v2 > T2 || nt2 < 1 || ntile < 1 || ntile > 65535 ||
      tile0 < 0 || groups < 1 || cin % groups || cout % groups)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused2d_spectra<T1, T2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      fused2d_mac_inverse<T1, T2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  fused2d_spectra<T1, T2><<<dim3(batch * cin, ntile), kThreads, smem, stream>>>(
      x, fac, d, hp, wp, v1, v2, nt2, tile0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused2d_mac_inverse<T1, T2><<<dim3(batch * cout, ntile), kThreads, smem, stream>>>(
      d, ks, fac, out, batch, cin, cout, groups, v1, v2, nt2, tile0, oh, ow);
  return cudaGetLastError();
}

// ---- Kernel B5: B2's factored transforms on the v3 schedule -------------------

// Where bin k1 of packed column q (columns q and q + T2/2 of a window as one
// complex column Z) lies in B5's plane after the H DFT: bins k and -k side by
// side in one row, bin k1 < T1/2 at row k1 of column q, k1 > T1/2 at row
// T1 - k1 of column q + T2/2, k1 = T1/2 at row 0 of column q + T2/2.
template <int T1, int T2>
__device__ __forceinline__ int v3_bin(int k1, int q) {
  constexpr int N1 = T1 / 2, N2 = T2 / 2;
  return k1 < N1 ? sw<T2>(k1, q) : sw<T2>(k1 == N1 ? 0 : T1 - k1, q + N2);
}

// Splits each packed column's bins (v3_bin) into its two columns' one-sided
// bins, in place, by all the block's threads (no barrier):
// X_q[k] = (Z[k] + conj Z[-k]) / 2, X_q+T2/2[k] = (Z[k] - conj Z[-k]) / 2i;
// row 0 holds Z[0] and Z[T1/2], where both columns are real.
template <int T1, int T2>
__device__ __forceinline__ void v3_split(float2* s_p) {
  constexpr int N1 = T1 / 2, N2 = T2 / 2;
  for (int i = threadIdx.x; i < N1 * N2; i += kThreads) {
    const int k = i / N2, q = i % N2;
    const float2 a = s_p[sw<T2>(k, q)], b = s_p[sw<T2>(k, q + N2)];
    if (k == 0) {
      s_p[sw<T2>(0, q)] = make_float2(a.x, 0.f);
      s_p[sw<T2>(0, q + N2)] = make_float2(a.y, 0.f);
      s_p[sw<T2>(N1, q)] = make_float2(b.x, 0.f);
      s_p[sw<T2>(N1, q + N2)] = make_float2(b.y, 0.f);
    } else {
      s_p[sw<T2>(k, q)] = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
      s_p[sw<T2>(k, q + N2)] = make_float2(0.5f * (a.y + b.y), 0.5f * (b.x - a.x));
    }
  }
}

// Phase 1 of B5: the window's tile spectra, H first. Writes D as B2's D in
// split planes [dr; di] (tiles of this launch, B * Cin, 2, NB1, T2).
template <int T1, int T2>
__global__ void __launch_bounds__(kThreads, B2Plan<T1, T2>::kMinBlocks)
fused2d_v3_spectra(const float* __restrict__ x,    // (B, Cin, hp, wp)
                   const float2* __restrict__ fac,  // factors, fused2d.py: _device_factors
                   float* __restrict__ d,           // (tiles of this launch, B * Cin, 2, NB1, T2)
                   int hp, int wp, int v1, int v2, int nt2, int tile0) {
  using P = B2Plan<T1, T2>;
  constexpr int A1 = P::kA1, B1 = P::kB1, G = P::kG, N2 = T2 / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const B2Smem<T1, T2, false> s(smem_raw, fac);
  float2* s_p = s.plane;

  const int tid = threadIdx.x;
  const int tile = tile0 + blockIdx.y;
  const int h0 = (tile / nt2) * v1, w0 = (tile % nt2) * v2;
  const float* xs = x + (int64_t)blockIdx.x * hp * wp;
  __syncthreads();  // the factors are staged before the first DFT reads them

  // H DFT of the real columns q and q + T2/2 as one complex column Z, read
  // straight from the signal (zeros past its edge), G pairs a pass. Bin k1 of
  // Z goes to row k1 of column q for k1 < T1/2, to row T1 - k1 of column
  // q + T2/2 for k1 > T1/2 and to row 0 of column q + T2/2 for k1 = T1/2:
  // bins k and -k side by side in one row
  for (int c0 = 0; c0 < N2; c0 += G) {
    for (int t = tid; t < G * B1; t += kThreads) {
      const int g = t % G, j2 = t / G, wa = w0 + c0 + g, wb = wa + N2;
      float2 v[A1];
#pragma unroll
      for (int j1 = 0; j1 < A1; ++j1) {
        const int hr = h0 + j1 * B1 + j2;
        const float* row = xs + (int64_t)hr * wp;
        v[j1] = make_float2(hr < hp && wa < wp ? __ldg(row + wa) : 0.f,
                            hr < hp && wb < wp ? __ldg(row + wb) : 0.f);
      }
      short_dft<A1, false>(v, s.ra1);
#pragma unroll
      for (int m1 = 0; m1 < A1; ++m1)
        s.stage[(m1 * B1 + j2) * G + g] =
            m1 == 0 ? v[0] : cmulw<false>(v[m1], s.tw1[m1 * B1 + j2]);
    }
    __syncthreads();
    for (int t = tid; t < G * A1; t += kThreads) {
      const int g = t % G, m1 = t / G, q = c0 + g;
      float2 u[B1];
#pragma unroll
      for (int j2 = 0; j2 < B1; ++j2) u[j2] = s.stage[(m1 * B1 + j2) * G + g];
      short_dft<B1, false>(u, s.rb1);
#pragma unroll
      for (int m2 = 0; m2 < B1; ++m2) s_p[v3_bin<T1, T2>(m1 + A1 * m2, q)] = u[m2];
    }
    __syncthreads();  // the staging is read before the next pass overwrites it
  }

  v3_split<T1, T2>(s_p);
  __syncthreads();

  // W DFT of the NB1 rows in place, then D out as its re and im planes
  row_dft<T2, false>(s_p, P::kNB1, s.ra2, s.rb2, s.tw2);
  float* dout = d + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * 2 * P::kPlane;
  for (int i = tid; i < P::kPlane; i += kThreads) {
    const float2 z = s_p[sw<T2>(i / T2, i % T2)];
    dout[i] = z.x;
    dout[P::kPlane + i] = z.y;
  }
}

// (yr, yi) += (dr + i di) (kr + i ki), four bins at a time
__device__ __forceinline__ void cmac4(float4& yr, float4& yi, float4 dr, float4 di, float4 kr,
                                      float4 ki) {
  yr.x = fmaf(dr.x, kr.x, fmaf(-di.x, ki.x, yr.x));
  yr.y = fmaf(dr.y, kr.y, fmaf(-di.y, ki.y, yr.y));
  yr.z = fmaf(dr.z, kr.z, fmaf(-di.z, ki.z, yr.z));
  yr.w = fmaf(dr.w, kr.w, fmaf(-di.w, ki.w, yr.w));
  yi.x = fmaf(dr.x, ki.x, fmaf(di.x, kr.x, yi.x));
  yi.y = fmaf(dr.y, ki.y, fmaf(di.y, kr.y, yi.y));
  yi.z = fmaf(dr.z, ki.z, fmaf(di.z, kr.z, yi.z));
  yi.w = fmaf(dr.w, ki.w, fmaf(di.w, kr.w, yi.w));
}

// Element k of the spectrum S whose T1-point inverse DFT is T1 h[., l] in the
// folded H inverse of column pair (l, T2 - l), l in [0, T2/2), read from Y
// in the plane: S[k] = Y[k, l], S[-k] = conj Y[k, -l] (0 < k < T1/2) and the
// mean of the two at k = 0 and T1/2; for l = 0 the real columns 0 and T2/2
// as one, S_0 + i S_T2/2 (both S Hermitian).
template <int T1, int T2>
__device__ __forceinline__ float2 folded_s(const float2* s_p, int k, int l) {
  constexpr int N1 = T1 / 2, N2 = T2 / 2;
  const int m = l == 0 ? N2 : T2 - l, kk = k <= N1 ? k : T1 - k;
  const bool mid = k == 0 || k == N1;
  if (l == 0) {
    const float2 a = s_p[sw<T2>(kk, 0)], e = s_p[sw<T2>(kk, N2)];
    return mid ? make_float2(a.x, e.x)
               : k < N1 ? make_float2(a.x - e.y, a.y + e.x) : make_float2(a.x + e.y, e.x - a.y);
  }
  if (mid) {
    const float2 a = s_p[sw<T2>(kk, l)], e = s_p[sw<T2>(kk, m)];
    return make_float2(0.5f * (a.x + e.x), 0.5f * (a.y - e.y));
  }
  if (k < N1) return s_p[sw<T2>(kk, l)];
  const float2 e = s_p[sw<T2>(kk, m)];
  return make_float2(e.x, -e.y);
}

// The slot of h[n, l] of the folded H inverse, l in [0, T2/2): row n of
// column l for n < NB1, else row n - NB1 of column T2 - l (T2/2 for l = 0),
// the slots of the pair's own columns, so that a pass writes over what only
// it reads.
template <int T1, int T2>
__device__ __forceinline__ int folded_slot(int n, int l) {
  constexpr int NB1 = T1 / 2 + 1, N2 = T2 / 2;
  return n < NB1 ? sw<T2>(n, l) : sw<T2>(n - NB1, l == 0 ? N2 : T2 - l);
}

// h[n, l] of the folded H inverse, l in [0, T2/2] (folded_slot); columns 0
// and T2/2 share their slots as the real and imaginary parts of one value
template <int T1, int T2>
__device__ __forceinline__ float2 folded_h(const float2* s_p, int n, int l) {
  constexpr int N2 = T2 / 2;
  const int c = l == N2 ? 0 : l;
  const float2 z = s_p[folded_slot<T1, T2>(n, c)];
  return c != 0 ? z : make_float2(l == 0 ? z.x : z.y, 0.f);
}

// Element c of the W c2r input of rows r and r + 1 of h: E_r + i E_r+1, E
// the Hermitian extension of a row of h (folded_h), E_r+1 = 0 where row
// r + 1 is past the valid rows (two false). The real and imaginary parts of
// its inverse DFT are the two output rows.
template <int T1, int T2>
__device__ __forceinline__ float2 c2r_in(const float2* s_p, int r, bool two, int c) {
  constexpr int N2 = T2 / 2;
  const int l = c <= N2 ? c : T2 - c;
  const float2 e0 = folded_h<T1, T2>(s_p, r, l);
  const float2 e1 = two ? folded_h<T1, T2>(s_p, r + 1, l) : make_float2(0.f, 0.f);
  return c <= N2 ? make_float2(e0.x - e1.y, e0.y + e1.x)   // E0 + i E1
                 : make_float2(e0.x + e1.y, e1.x - e0.y);  // conj(E0) + i conj(E1)
}

// Phase 2 of B5: the MAC, then the v3 inverse, H first and folded.
template <int T1, int T2>
__global__ void __launch_bounds__(kThreads, B2Plan<T1, T2>::kMinBlocks)
fused2d_v3_mac_inverse(const float* __restrict__ d,    // (tiles of this launch, B * Cin, 2, NB1, T2)
                       const float* __restrict__ ks,   // (Cout, Cin/g, 2, NB1, T2), conjugated
                       const float2* __restrict__ fac,  // factors, fused2d.py: _device_factors
                       float* __restrict__ out,         // (B, Cout, oh, ow)
                       int batch, int cin, int cout, int groups, int v1, int v2, int nt2,
                       int tile0, int oh, int ow) {
  using P = B2Plan<T1, T2>;
  constexpr int A1 = P::kA1, B1 = P::kB1, A2 = P::kA2, B2 = P::kB2, G = P::kG, N2 = T2 / 2;
  // row pairs of one W chunk: a power of two, at least A2, whose T2-point
  // transforms fit the staging
  constexpr int R = P::kStage / T2 >= 64 ? 64 : P::kStage / T2 >= 32 ? 32 : 16;
  static_assert(R * T2 <= P::kStage && R >= A2, "the W chunk does not fit the staging");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const B2Smem<T1, T2, false> s(smem_raw, fac);
  float2* s_p = s.plane;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / cout, o = blockIdx.x % cout;
  const int cpg = cin / groups, g0 = o / (cout / groups);
  const int tile = tile0 + blockIdx.y;
  const int h0 = (tile / nt2) * v1, w0 = (tile % nt2) * v2;
  const int64_t plane = P::kPlane;

  // per-bin MAC over this out-channel's group: Y = sum_c D[c] * K[o, c]
  const float* dg = d + (((int64_t)blockIdx.y * batch + b) * cin + (int64_t)g0 * cpg) * 2 * plane;
  const float* ko = ks + (int64_t)o * cpg * 2 * plane;
  for (int i = tid; i < P::kPlane / 4; i += kThreads) {
    float4 yr = make_float4(0.f, 0.f, 0.f, 0.f), yi = yr;
    for (int c = 0; c < cpg; ++c) {
      const float4* dc = reinterpret_cast<const float4*>(dg + c * 2 * plane);
      const float4* kc = reinterpret_cast<const float4*>(ko + c * 2 * plane);
      cmac4(yr, yi, __ldg(dc + i), __ldg(dc + plane / 4 + i), __ldg(kc + i),
            __ldg(kc + plane / 4 + i));
    }
    const int k = 4 * i / T2, c = 4 * i % T2;
    s_p[sw<T2>(k, c)] = make_float2(yr.x, yi.x);
    s_p[sw<T2>(k, c + 1)] = make_float2(yr.y, yi.y);
    s_p[sw<T2>(k, c + 2)] = make_float2(yr.z, yi.z);
    s_p[sw<T2>(k, c + 3)] = make_float2(yr.w, yi.w);
  }
  __syncthreads();

  // Folded H inverse. out = Re(IDFT_W(z)), z = C Y the one-sided H inverse,
  // needs only the W-Hermitian half h[n, l] = (z[n, l] + conj z[n, -l]) / 2,
  // l in [0, T2/2], and T1 h[., l] is the T1-point inverse DFT of S with
  // S[k] = Y[k, l], S[-k] = conj Y[k, -l] (0 < k < T1/2) and the mean of the
  // two at k = 0 and T1/2: one transform per column pair (l, T2 - l), and one
  // for the real columns 0 and T2/2 together as S_0 + i S_T2/2. Each pass of G
  // pairs reads its pairs' columns, then writes the V1 valid rows of h back
  // into them (folded_h); the 1/T1 is left for the output.
  for (int c0 = 0; c0 < N2; c0 += G) {
    for (int t = tid; t < G * B1; t += kThreads) {
      const int g = t % G, j2 = t / G, l = c0 + g;
      float2 v[A1];
#pragma unroll
      for (int j1 = 0; j1 < A1; ++j1) v[j1] = folded_s<T1, T2>(s_p, j1 * B1 + j2, l);
      short_dft<A1, true>(v, s.ra1);
#pragma unroll
      for (int m1 = 0; m1 < A1; ++m1)
        s.stage[(m1 * B1 + j2) * G + g] =
            m1 == 0 ? v[0] : cmulw<true>(v[m1], s.tw1[m1 * B1 + j2]);
    }
    __syncthreads();
    for (int t = tid; t < G * A1; t += kThreads) {
      const int g = t % G, m1 = t / G, l = c0 + g;
      float2 u[B1];
#pragma unroll
      for (int j2 = 0; j2 < B1; ++j2) u[j2] = s.stage[(m1 * B1 + j2) * G + g];
      short_dft<B1, true>(u, s.rb1);
#pragma unroll
      for (int m2 = 0; m2 < B1; ++m2) {
        const int n = m1 + A1 * m2;
        if (n < v1) s_p[folded_slot<T1, T2>(n, l)] = u[m2];
      }
    }
    __syncthreads();  // the staging is read before the next pass overwrites it
  }

  // W c2r of the V1 rows of h: rows 2p and 2p + 1 as one complex T2-point
  // inverse of c = E_2p + i E_2p+1, E the Hermitian extension of a row, whose
  // real and imaginary parts are the two output rows; R row pairs a chunk
  // through the staging, held at [(m1 B2 + j2) R + (p ^ m1)] so that both
  // steps read and write it without bank conflicts
  const float scale = 1.f / (float)(T1 * T2);
  float* oplane = out + ((int64_t)b * cout + o) * oh * ow;
  const int npair = (v1 + 1) / 2;
  for (int p0 = 0; p0 < npair; p0 += R) {
    for (int t = tid; t < R * B2; t += kThreads) {
      const int pr = t % R, j2 = t / R, r = 2 * (p0 + pr);
      if (r >= v1) continue;
      const bool two = r + 1 < v1;
      float2 v[A2];
#pragma unroll
      for (int j1 = 0; j1 < A2; ++j1) v[j1] = c2r_in<T1, T2>(s_p, r, two, j1 * B2 + j2);
      short_dft<A2, true>(v, s.ra2);
#pragma unroll
      for (int m1 = 0; m1 < A2; ++m1)
        s.stage[(m1 * B2 + j2) * R + (pr ^ m1)] =
            m1 == 0 ? v[0] : cmulw<true>(v[m1], s.tw2[m1 * B2 + j2]);
    }
    __syncthreads();
    for (int t = tid; t < R * A2; t += kThreads) {
      const int m1 = t % A2, pr = t / A2, r = 2 * (p0 + pr), oy = h0 + r;
      if (r >= v1 || oy >= oh) continue;
      float2 u[B2];
#pragma unroll
      for (int j2 = 0; j2 < B2; ++j2) u[j2] = s.stage[(m1 * B2 + j2) * R + (pr ^ m1)];
      short_dft<B2, true>(u, s.rb2);
      float* row = oplane + (int64_t)oy * ow;
      const bool two = r + 1 < v1 && oy + 1 < oh;
#pragma unroll
      for (int m2 = 0; m2 < B2; ++m2) {
        const int z = m1 + A2 * m2, ox = w0 + z;
        if (z < v2 && ox < ow) {
          row[ox] = u[m2].x * scale;
          if (two) row[ow + ox] = u[m2].y * scale;
        }
      }
    }
    __syncthreads();
  }
}

template <int T1, int T2>
cudaError_t launch_v3(const float* x, const float* ks, const float2* fac, float* d, float* out,
                      int batch, int cin, int cout, int groups, int hp, int wp, int v1, int v2,
                      int nt2, int tile0, int ntile, int oh, int ow, cudaStream_t stream) {
  constexpr size_t smem = B2Plan<T1, T2>::kSmemV3;
  if (v1 < 1 || v1 > T1 || v2 < 1 || v2 > T2 || nt2 < 1 || ntile < 1 || ntile > 65535 ||
      tile0 < 0 || groups < 1 || cin % groups || cout % groups)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused2d_v3_spectra<T1, T2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      fused2d_v3_mac_inverse<T1, T2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  fused2d_v3_spectra<T1, T2><<<dim3(batch * cin, ntile), kThreads, smem, stream>>>(
      x, fac, d, hp, wp, v1, v2, nt2, tile0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused2d_v3_mac_inverse<T1, T2><<<dim3(batch * cout, ntile), kThreads, smem, stream>>>(
      d, ks, fac, out, batch, cin, cout, groups, v1, v2, nt2, tile0, oh, ow);
  return cudaGetLastError();
}

// ---- B2's tensor-core route (the modes "bf16x3" and "bf16") ------------------

constexpr int kWarps = kThreads / 32;
// rows a warp owns through both steps of a row DFT (row_dft_tc)
constexpr int kRowGroup = 8;
// The MAC stage: the output channels a thread holds a pass and the input
// channels a chunk (their spectra held in registers), the units in flight
// in the block's ring of D, and the bytes of its plane, which bound the
// (unit, output channel) rows of a block (fused2d.py: _TC_PLANE_BYTES).
constexpr int kMacOJ = 4;
constexpr int kMacKC = 4;
constexpr int kMacStages = 4;
constexpr int kMacPlaneBytes = 64 * 1024;

// a * w, or a * conj(w) for the inverse, rounded as the plain version rounds
// it (two products, then their sum, each to FP32; no FMA), so that the bf16
// operand the next step rounds it to is the plain version's
template <bool INV>
__device__ __forceinline__ float2 cmulw_rn(float2 a, float2 w) {
  if (INV) w.y = -w.y;
  return make_float2(__fsub_rn(__fmul_rn(a.x, w.x), __fmul_rn(a.y, w.y)),
                     __fadd_rn(__fmul_rn(a.x, w.y), __fmul_rn(a.y, w.x)));
}

// The column that holds bin (or sample) k of a row after row_dft_tc<T>:
// bin m1 + A m2 is left at m1 B + m2.
template <int T>
__device__ __forceinline__ int tc_col(int k) {
  return (k % split_a(T)) * split_b(T) + k / split_a(T);
}

// Index of (column c of a pass, element k) in the staging of an H pass: column
// by column, bits 2 and 3 of k swizzled by c + k / 16, so that a lane group
// of step 1 (8 consecutive j2 of one column, 4 m1) and one of step 2 (8
// columns, 4 consecutive j2) each reach 16 distinct bank pairs.
template <int T1>
__device__ __forceinline__ int stg(int c, int k) {
  return c * T1 + (k ^ (((c + (k >> 4)) & 3) << 2));
}

// Asynchronous copies into shared memory (cp.async): 16 or 8 bytes, or 4
// bytes of which only the first `bytes` are read (the rest zero-filled);
// copies committed as groups, waited for as all or all but the N newest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// In-place DFT (INV: conjugated, unscaled) of rows [0, nrows) of the plane,
// T = A * B, on the tensor cores, each warp owning kRowGroup rows at a time
// through both steps, which meet at __syncwarp. Step 1, tiles of the 8 rows
// at j2 and j2 + 1: vector (row, j2) = element j1 at column j1 B + j2, its
// A-point DFT and then the twiddle tw[m1 B + j2] in FP32, back at column
// m1 B + j2. Step 2, tiles of the 8 rows at m1 and m1 + 1 (lane group g
// takes m1 + (g & 1), so that its 4 elements reach 16 distinct bank pairs at
// B = 8): vector (row, m1) = element j2 at column m1 B + j2, its B-point DFT,
// back in the same columns: bin m1 + A m2 at column m1 B + m2 (tc_col). Each
// vector stays in its own slots, so no second plane. No block barrier: the
// caller syncs before other warps read the rows.
template <int T, bool X3, bool INV>
__device__ __forceinline__ void row_dft_tc(float2* s_p, int nrows,
                                           const uint32_t* __restrict__ frag, const float2* tw) {
  constexpr int A = split_a(T), B = split_b(T), RG = kRowGroup;
  static_assert(RG == 8 && A % 2 == 0 && B % 2 == 0, "a row group's steps take whole tiles");
  const uint32_t* fa = frag + bf16_mma::frag_offset(A, INV);
  const uint32_t* fb = frag + bf16_mma::frag_offset(B, INV);
  const float2 zero = make_float2(0.f, 0.f);
  for (int r0 = (threadIdx.x >> 5) * RG; r0 < nrows; r0 += kWarps * RG) {
#pragma unroll 1
    for (int j2a = 0; j2a < B; j2a += 2) {
      bf16_mma::dft_tile<A, X3>(
          0, 16, fa,
          [&](int v, int j1) {
            const int row = r0 + (v & 7);
            return row < nrows ? s_p[sw<T>(row, j1 * B + j2a + (v >> 3))] : zero;
          },
          [&](int v, int m1, float2 val) {
            const int row = r0 + (v & 7), j2 = j2a + (v >> 3);
            if (row < nrows)
              s_p[sw<T>(row, m1 * B + j2)] = m1 == 0 ? val : cmulw_rn<INV>(val, tw[m1 * B + j2]);
          });
    }
    __syncwarp();
#pragma unroll 1
    for (int m1a = 0; m1a < A; m1a += 2) {
      bf16_mma::dft_tile<B, X3>(
          0, 16, fb,
          [&](int v, int j2) {
            const int row = r0 + (v & 7), m1 = m1a + ((v ^ (v >> 3)) & 1);
            return row < nrows ? s_p[sw<T>(row, m1 * B + j2)] : zero;
          },
          [&](int v, int m2, float2 val) {
            const int row = r0 + (v & 7), m1 = m1a + ((v ^ (v >> 3)) & 1);
            if (row < nrows) s_p[sw<T>(row, m1 * B + m2)] = val;
          });
    }
    __syncwarp();
  }
}

// One pass of an H transform, T1 = A1 * B1, over G columns (or column
// pairs) on the tensor cores, each warp owning CW = G / kWarps of them
// through both steps, which meet at __syncwarp; the warp's columns of the
// staging are its own, so passes need no block barrier either. Step 1:
// vector m = (column m / B1, j2 = m % B1), element j1 = ld(m, j1), its
// A1-point DFT (INV: conjugated) and the twiddle tw[m1 B1 + j2] in FP32
// into the staging at (column, m1 B1 + j2); the warp's vectors are tiles of
// that order. Step 2, tile p: vector v = (column CW w + v % CW, m1 = p 16 /
// CW + v / CW), its B1-point DFT over j2 from the staging, output m2 to
// st(column, m1, m2, value) (bin or sample m1 + A1 m2); at T1 = 128 and 256
// a load of step 2 reaches 16 distinct bank pairs of stg.
template <int T1, bool X3, bool INV, typename LD, typename ST>
__device__ __forceinline__ void hstep_tiles(float2* stage, const uint32_t* __restrict__ frag,
                                            LD ld, const float2* tw, ST st) {
  constexpr int A1 = split_a(T1), B1 = split_b(T1), G = stage_cols(T1), CW = G / kWarps;
  static_assert(G % kWarps == 0 && CW * B1 % 16 == 0 && 16 % CW == 0,
                "a warp's columns take whole tiles");
  const int warp = threadIdx.x >> 5;
  const float2 zero = make_float2(0.f, 0.f);
#pragma unroll 1
  for (int m0 = warp * CW * B1; m0 < (warp + 1) * CW * B1; m0 += 16)
    bf16_mma::dft_tile<A1, X3>(
        m0, G * B1, frag + bf16_mma::frag_offset(A1, INV), ld,
        [&](int m, int m1, float2 v) {
          const int j2 = m % B1;
          stage[stg<T1>(m / B1, m1 * B1 + j2)] = m1 == 0 ? v : cmulw_rn<INV>(v, tw[m1 * B1 + j2]);
        });
  __syncwarp();
#pragma unroll 1
  for (int p = 0; p < (CW * A1 + 15) / 16; ++p)
    bf16_mma::dft_tile<B1, X3>(
        0, 16, frag + bf16_mma::frag_offset(B1, INV),
        [&](int v, int j2) {
          const int m1 = p * (16 / CW) + v / CW;
          return m1 < A1 ? stage[stg<T1>(warp * CW + v % CW, m1 * B1 + j2)] : zero;
        },
        [&](int v, int m2, float2 val) {
          const int m1 = p * (16 / CW) + v / CW;
          if (m1 < A1) st(warp * CW + v % CW, m1, m2, val);
        });
  __syncwarp();
}

// Phase 1 of the tensor-core route (MODE 3: "bf16x3", 1: "bf16"):
// fused2d_spectra's function, every DFT step a bf16 product.
template <int T1, int T2, int MODE>
__global__ void __launch_bounds__(kThreads, B2Plan<T1, T2>::kMinBlocks)
fused2d_spectra_tc(const float* __restrict__ x,        // (B, Cin, hp, wp)
                   const uint32_t* __restrict__ frag,  // fused2d.py: _tc_fragments
                   const float2* __restrict__ fac,     // factors, fused2d.py: _device_factors
                   float2* __restrict__ d,             // (tiles of this launch, B * Cin, NB1, T2)
                   int hp, int wp, int v1, int v2, int nt2, int tile0) {
  using P = B2Plan<T1, T2>;
  constexpr bool X3 = MODE == 3;
  constexpr int A1 = P::kA1, B1 = P::kB1, G = P::kG, N1 = T1 / 2, N2 = T2 / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const B2Smem<T1, T2> s(smem_raw, fac);
  float2* s_p = s.plane;

  const int tid = threadIdx.x;
  const int tile = tile0 + blockIdx.y;
  const int h0 = (tile / nt2) * v1, w0 = (tile % nt2) * v2;
  const float* xs = x + (int64_t)blockIdx.x * hp * wp;

  // the window by cp.async, rows 2r and 2r + 1 as the real and imaginary
  // parts of complex row r (zeros past the edge): window row hr = 2r + part,
  // its T2 samples a row segment of the signal
  for (int i = tid; i < T1 * T2; i += kThreads) {
    const int c = i % T2, rp = i / T2, hr = h0 + rp, wc = w0 + c;
    const bool in = hr < hp && wc < wp;
    cp_async4(reinterpret_cast<float*>(s_p + sw<T2>(rp >> 1, c)) + (rp & 1),
              in ? xs + (int64_t)hr * wp + wc : xs, in ? 4 : 0);
  }
  cp_async_wait_all();
  __syncthreads();

  // W DFT of the packed rows: Z_r[k] = X_2r[k] + i X_2r+1[k], bin k at tc_col(k)
  row_dft_tc<T2, X3, false>(s_p, N1, frag, s.tw2);
  __syncthreads();

  // H DFT of column col of X, col in [1, T2/2), or of X[., 0] + i X[., T2/2]
  // for col = 0, G columns a pass, each warp owning CW of them through both
  // steps (hstep_tiles): step 1 splits the W bins k and -k of the packed
  // rows in FP32 as it loads them (as fused2d_spectra), runs the A1-point
  // DFT of each (col, j2) (lanes on j2, so that a load reads one column's
  // rows) and the twiddle into the warp's columns of the staging at (col,
  // m1 B1 + j2); step 2 runs the B1-point DFT of each (col, m1) and writes
  // the bins k1 = m1 + A1 m2 to D in natural order. The warp that owns
  // column 0 splits its packed bins into columns 0 and T2/2.
  float2* dout = d + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * P::kPlane;
  const int warp = tid >> 5, lane = tid & 31;
  for (int c0 = 0; c0 < N2; c0 += G) {
    hstep_tiles<T1, X3, false>(
        s.stage, frag,
        [&](int m, int j1) {
          const int col = c0 + m / B1, h = j1 * B1 + m % B1, rr = h >> 1;
          const int ck = tc_col<T2>(col == 0 ? 0 : col), cm = tc_col<T2>(col == 0 ? N2 : T2 - col);
          const float2 zk = s_p[sw<T2>(rr, ck)], zm = s_p[sw<T2>(rr, cm)];
          if (col == 0)  // X_r[0] + i X_r[T2/2], both real
            return h & 1 ? make_float2(zk.y, zm.y) : make_float2(zk.x, zm.x);
          // X_2r[k] = (Z[k] + conj Z[-k]) / 2, X_2r+1[k] = (Z[k] - conj Z[-k]) / 2i
          return h & 1 ? make_float2(0.5f * (zk.y + zm.y), 0.5f * (zm.x - zk.x))
                       : make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
        },
        s.tw1,
        [&](int c, int m1, int m2, float2 v) {
          const int col = c0 + c, k1 = m1 + A1 * m2;
          if (col == 0) {
            s.packed[k1] = v;
          } else {
            if (k1 <= N1) dout[k1 * T2 + col] = v;
            if (k1 == 0 || k1 >= N1)  // D[-k1, -col] = conj X[k1, col]
              dout[((T1 - k1) % T1) * T2 + T2 - col] = make_float2(v.x, -v.y);
          }
        });
    if (c0 == 0 && warp == 0) {  // split C = X0 + i XN into columns 0 and T2/2
      for (int k = lane; k < P::kNB1; k += 32) {
        const float2 p = s.packed[k], q = s.packed[(T1 - k) % T1];
        dout[k * T2] = make_float2(0.5f * (p.x + q.x), 0.5f * (p.y - q.y));
        dout[k * T2 + N2] = make_float2(0.5f * (p.y + q.y), 0.5f * (q.x - p.x));
      }
    }
  }
}

// The MAC stage of the tensor-core route, grid (unit blocks, NB1, groups x
// output-channel blocks): one bin row k1, output channels [oc0, oc0 + oc) of
// group g, units [u0, u0 + nu) of this launch (a unit is one tile of one
// batch row, tile * B + b). Y[u, o] = sum_c D[u, c] K[o, c] in FP32, the
// group's channels in order, into plane row u * oc + o. Each thread takes
// one column and, a pass, kMacOJ output channels; a chunk of kMacKC input
// channels at a time it holds their spectra in registers (read once a
// block), while the block streams D's rows unit by unit through a ring of
// kMacStages units in shared memory (16-byte cp.async, kMacStages - 1 units
// ahead, a barrier a unit), each value serving the kThreads / T2 threads of
// its column and their kMacOJ output channels each; the sums stay in the
// plane between chunks. Then the inverse W DFT of every row
// (row_dft_tc), and Y out as the inverse stage's plane image (row k1,
// samples in tc_col order, swizzled as sw swizzles row k1). MODE 0 is B5's
// route, whose inverse runs H first in its own stage: no W DFT here, Y's
// row k1 out in natural bin order (the same image of it), and no DFT step.
template <int T1, int T2, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
fused2d_mac_tc(const float2* __restrict__ d,        // (units of this launch, Cin, NB1, T2)
               const float2* __restrict__ ks,       // (Cout, Cin/g, NB1, T2), conjugated
               const uint32_t* __restrict__ frag,   // fused2d.py: _tc_fragments
               const float2* __restrict__ fac,      // factors, fused2d.py: _device_factors
               float2* __restrict__ y,              // (units of this launch, Cout, NB1, T2)
               int units, int cin, int cout, int groups, int upb, int ocb) {
  using P = B2Plan<T1, T2>;
  constexpr bool X3 = MODE == 3;
  constexpr int L = kThreads / T2, OJ = kMacOJ, KC = kMacKC, NS = kMacStages;
  constexpr int64_t plane = P::kPlane;
  static_assert(kThreads % T2 == 0, "a block's threads take whole rows");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* s_p = reinterpret_cast<float2*>(smem_raw);
  float2* tw = s_p + (size_t)upb * ocb * T2;  // the W twiddle
  const int tid = threadIdx.x;
  float2* ring = tw + T2;  // stage s, channel c, column: (s * KC + c) * T2 + column
  for (int i = tid; i < T2; i += kThreads)
    tw[i] = __ldg(fac + P::kA1 + P::kB1 + T1 + P::kA2 + P::kB2 + i);

  const int cpg = cin / groups, og = cout / groups, noc = (og + ocb - 1) / ocb;
  const int g = blockIdx.z / noc, oc0 = (blockIdx.z % noc) * ocb, oc = min(ocb, og - oc0);
  const int u0 = blockIdx.x * upb, nu = min(upb, units - u0);
  const int k1 = blockIdx.y, col = tid % T2, lane = tid / T2;
  const float2* dk = d + ((int64_t)u0 * cin + (int64_t)g * cpg) * plane + (int64_t)k1 * T2;
  const float2* kk = ks + (int64_t)(g * og + oc0) * cpg * plane + (int64_t)k1 * T2 + col;
  for (int ob = 0; ob < oc; ob += L * OJ) {
    for (int c0 = 0; c0 < cpg; c0 += KC) {
      const int nc = min(KC, cpg - c0);
      // unit u's rows D[u, c0 .. c0 + nc, k1] into ring stage u % NS by the
      // whole block, 16 bytes a copy; one commit group a unit (empty past
      // the block's units)
      auto stage = [&](int u) {
        if (u < nu) {
          const float2* src = dk + ((int64_t)u * cin + c0) * plane;
          float2* dst = ring + (u % NS) * KC * T2;
          for (int i = tid; i < nc * T2 / 2; i += kThreads) {
            const int c = i / (T2 / 2), q = 2 * (i % (T2 / 2));
            cp_async16(dst + c * T2 + q, src + c * plane + q);
          }
        }
        cp_async_commit();
      };
#pragma unroll
      for (int u = 0; u < NS - 1; ++u) stage(u);
      float2 kr[OJ][KC];
#pragma unroll
      for (int j = 0; j < OJ; ++j) {
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const int o = ob + lane + L * j;
          kr[j][c] = o < oc && c < nc ? __ldg(kk + ((int64_t)o * cpg + c0 + c) * plane)
                                      : make_float2(0.f, 0.f);
        }
      }
      for (int u = 0; u < nu; ++u) {
        cp_async_wait<NS - 2>();  // this thread's copies of unit u have landed
        __syncthreads();  // every thread's have, and stage (u - 1) % NS is read
        stage(u + NS - 1);
        const float2* src = ring + (u % NS) * KC * T2 + col;
        float2 acc[OJ];
#pragma unroll
        for (int j = 0; j < OJ; ++j) {
          const int o = ob + lane + L * j;
          acc[j] = c0 > 0 && o < oc ? s_p[sw<T2>(u * oc + o, col)] : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          if (c < nc) {
            const float2 dv = src[c * T2];
#pragma unroll
            for (int j = 0; j < OJ; ++j) cmac(acc[j], dv, kr[j][c]);
          }
        }
#pragma unroll
        for (int j = 0; j < OJ; ++j) {
          const int o = ob + lane + L * j;
          if (o < oc) s_p[sw<T2>(u * oc + o, col)] = acc[j];
        }
      }
      __syncthreads();  // the ring is read before the next chunk's prologue refills it
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // inverse W DFT of the block's rows in place, sample n at tc_col(n)
  const int rows = nu * oc;
  if constexpr (MODE != 0) {
    row_dft_tc<T2, X3, true>(s_p, rows, frag, tw);
    __syncthreads();
  }
  const int sh = k1 & 15;
  for (int i = tid; i < rows * T2; i += kThreads) {
    const int r = i / T2, p = i % T2;
    const int64_t yrow = ((int64_t)(u0 + r / oc) * cout + g * og + oc0 + r % oc) * P::kNB1 + k1;
    y[yrow * T2 + p] = s_p[sw<T2>(r, p ^ sh)];
  }
}

// The inverse stage of the tensor-core route, grid (B * Cout, tiles of this
// launch): the MAC stage's Y of one (b, o, tile), already the plane's
// image, into the plane by 16-byte cp.async; then the H irfft of column
// pairs, storing the V1 x V2 valid samples into (B, Cout, OH, OW).
template <int T1, int T2, int MODE>
__global__ void __launch_bounds__(kThreads, B2Plan<T1, T2>::kMinBlocks)
fused2d_inverse_tc(const float2* __restrict__ y,       // (units of this launch, Cout, NB1, T2)
                   const uint32_t* __restrict__ frag,  // fused2d.py: _tc_fragments
                   const float2* __restrict__ fac,     // factors, fused2d.py: _device_factors
                   float* __restrict__ out,            // (B, Cout, oh, ow)
                   int v1, int v2, int nt2, int tile0, int oh, int ow) {
  using P = B2Plan<T1, T2>;
  constexpr bool X3 = MODE == 3;
  constexpr int A1 = P::kA1, B1 = P::kB1, G = P::kG, N1 = T1 / 2, N2 = T2 / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const B2Smem<T1, T2> s(smem_raw, fac);
  float2* s_p = s.plane;

  const int tid = threadIdx.x;
  const int tile = tile0 + blockIdx.y;
  const int h0 = (tile / nt2) * v1, w0 = (tile % nt2) * v2;
  // unit (tile, b), output channel o: Y's plane blockIdx.y * B * Cout + b * Cout + o
  const float2* yp = y + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * P::kPlane;
  for (int i = tid; i < P::kPlane / 2; i += kThreads) cp_async16(s_p + 2 * i, yp + 2 * i);
  cp_async_wait_all();
  __syncthreads();

  // H irfft of columns 2q and 2q + 1 at once, G pairs a pass, each warp
  // owning CW of them through both steps (hstep_tiles): the inverse DFT of
  // c = H_2q + i H_2q+1, H the Hermitian extension of a one-sided column
  // (formed in FP32 as step 1 loads it, as fused2d_mac_inverse), whose real
  // and imaginary parts are the two output columns; step 1 (lanes on the
  // bins of one pair) into the warp's pairs of the staging with the
  // conjugate twiddle, step 2 onto the output rows m1 + A1 m2, of which the
  // V1 valid ones are stored with 1/(T1 T2)
  const float scale = 1.f / (float)(T1 * T2);
  float* oplane = out + (int64_t)blockIdx.x * oh * ow;
  for (int c0 = 0; c0 < N2; c0 += G) {
    hstep_tiles<T1, X3, true>(
        s.stage, frag,
        [&](int m, int j1) {
          const int q = c0 + m / B1, k = j1 * B1 + m % B1, kk = k <= N1 ? k : T1 - k;
          const float2 e0 = s_p[sw<T2>(kk, tc_col<T2>(2 * q))];
          const float2 e1 = s_p[sw<T2>(kk, tc_col<T2>(2 * q + 1))];
          if (k == 0 || k == N1)  // real bins: their imaginary parts drop out
            return make_float2(e0.x, e1.x);
          if (k < N1)  // E0 + i E1
            return make_float2(e0.x - e1.y, e0.y + e1.x);
          return make_float2(e0.x + e1.y, e1.x - e0.y);  // conj(E0) + i conj(E1) of bin T1 - k
        },
        s.tw1,
        [&](int c, int m1, int m2, float2 v) {
          const int z = 2 * (c0 + c), ox = w0 + z, vr = m1 + A1 * m2, oy = h0 + vr;
          if (vr < v1 && oy < oh) {
            float* row = oplane + (int64_t)oy * ow + ox;
            if (z < v2 && ox < ow) row[0] = v.x * scale;
            if (z + 1 < v2 && ox + 1 < ow) row[1] = v.y * scale;
          }
        });
  }
}

// ---- B5's tensor-core route (the modes "bf16x3" and "bf16") ------------------

// The DFT (INV: conjugated, unscaled) of rows [r0, min(r0 + 8, r1)) of the
// plane, T = A * B, on the tensor cores, by the calling warp through both
// steps, which meet at __syncwarp, each output handed to st (B5's phase 1
// and inverse stage, where row_dft_tc's second pass over the plane to the
// outputs would follow). MIRROR: the W c2r of B5's inverse stage. Step 1,
// tiles of the 8 rows at two j2, j2a = 2i and j2b = 2i + 1 (MIRROR: j2a = i
// and its mirror j2b = (B - i) % B, B / 2 for i = 0, so that a tile holds
// elements c and T - c of each of its rows): vector (row, j2) = element j1
// of the row's input, ld(row, j1 B + j2) (any FP32 arithmetic the input
// needs, read only from the tile's own columns of the row), its A-point DFT
// and the twiddle tw[m1 B + j2] in FP32, in place at column m1 B + j2. Step
// 2, tiles of two rows four apart (rows whose swizzles differ in bit 2, for
// any r0) at eight consecutive m1: vector (row, m1) = element j2 at column
// m1 B + j2, its B-point DFT, output m2 (bin or sample m1 + A m2) to
// st(row, m1, m2, value). The tile's vectors alternate between its two rows,
// so that a lane's 4 loads reach 16 distinct bank pairs at B = 8 and four
// lanes hand st four consecutive outputs of a row (whole 32-byte sectors of
// float2); under MIRROR vectors 0-7 are the first row's and 8-15 the
// second's, so that eight lanes hand st eight consecutive samples (whole
// sectors of float output) at the price of 4-way bank conflicts on the
// loads. No block barrier.
template <int T, bool X3, bool INV, bool MIRROR, typename LD, typename ST>
__device__ __forceinline__ void row_group_tc(float2* s_p, int r0, int r1,
                                             const uint32_t* __restrict__ frag, const float2* tw,
                                             LD ld, ST st) {
  constexpr int A = split_a(T), B = split_b(T);
  static_assert(kRowGroup == 8 && A % 8 == 0 && B % 2 == 0, "a row group's steps take whole tiles");
  const uint32_t* fa = frag + bf16_mma::frag_offset(A, INV);
  const uint32_t* fb = frag + bf16_mma::frag_offset(B, INV);
#pragma unroll 1
  for (int i = 0; i < B / 2; ++i) {
    const int j2a = MIRROR ? i : 2 * i, j2b = MIRROR ? (i == 0 ? B / 2 : B - i) : 2 * i + 1;
    bf16_mma::dft_tile<A, X3>(
        0, 16, fa,
        [&](int v, int j1) {  // a row past the group loads the last one's input
          return ld(min(r0 + (v & 7), r1 - 1), j1 * B + (v >> 3 ? j2b : j2a));
        },
        [&](int v, int m1, float2 val) {
          const int row = r0 + (v & 7), j2 = v >> 3 ? j2b : j2a;
          if (row < r1)
            s_p[sw<T>(row, m1 * B + j2)] = m1 == 0 ? val : cmulw_rn<INV>(val, tw[m1 * B + j2]);
        });
  }
  __syncwarp();
#pragma unroll 1
  for (int q = 0; q < 4 * (A / 8); ++q) {
    const int ra = r0 + q % 4, m1a = 8 * (q / 4);
    if (ra >= r1) continue;  // both rows of the tile past the group
    bf16_mma::dft_tile<B, X3>(
        0, 16, fb,
        [&](int v, int j2) {
          const int row = ra + 4 * (MIRROR ? v >> 3 : v & 1), m1 = m1a + (MIRROR ? v & 7 : v >> 1);
          return s_p[sw<T>(min(row, r1 - 1), m1 * B + j2)];
        },
        [&](int v, int m2, float2 val) {
          const int row = ra + 4 * (MIRROR ? v >> 3 : v & 1), m1 = m1a + (MIRROR ? v & 7 : v >> 1);
          if (row < r1) st(row, m1, m2, val);
        });
  }
  __syncwarp();
}

// Where sample h of packed column q (columns q and q + T2/2 of the window as
// one complex column) lies in phase 1's plane: rows h and h + T1/2 at row
// h % (T1/2) of columns q and q + T2/2, the slots that the column's bins take
// after its H DFT (v3_bin), so that the DFT writes over what only it reads.
template <int T1, int T2>
__device__ __forceinline__ int v3_win(int h, int q) {
  return sw<T2>(h % (T1 / 2), h < T1 / 2 ? q : q + T2 / 2);
}

// Phase 1 of B5's tensor-core route (MODE 3: "bf16x3", 1: "bf16"):
// fused2d_v3_spectra's function, every DFT step a bf16 product, D out as B2's
// (complex, natural bin order) for the MAC stage.
template <int T1, int T2, int MODE>
__global__ void __launch_bounds__(kThreads, B2Plan<T1, T2>::kMinBlocks)
fused2d_v3_spectra_tc(const float* __restrict__ x,        // (B, Cin, hp, wp)
                      const uint32_t* __restrict__ frag,  // fused2d.py: _tc_fragments
                      const float2* __restrict__ fac,     // factors, fused2d.py: _device_factors
                      float2* __restrict__ d,             // (tiles of this launch, B * Cin, NB1, T2)
                      int hp, int wp, int v1, int v2, int nt2, int tile0) {
  using P = B2Plan<T1, T2>;
  constexpr bool X3 = MODE == 3;
  constexpr int A1 = P::kA1, B1 = P::kB1, A2 = P::kA2, B2 = P::kB2, G = P::kG, N1 = T1 / 2,
                N2 = T2 / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const B2Smem<T1, T2, false> s(smem_raw, fac);
  float2* s_p = s.plane;

  const int tid = threadIdx.x;
  const int tile = tile0 + blockIdx.y;
  const int h0 = (tile / nt2) * v1, w0 = (tile % nt2) * v2;
  const float* xs = x + (int64_t)blockIdx.x * hp * wp;

  // the window by cp.async, sample (h, c) the real (c < T2/2) or imaginary
  // part of packed column c % (T2/2) at v3_win (zeros past the edge)
  {
    const int c = tid % T2, wc = w0 + c;  // a thread's column, every kThreads / T2-th row
    const float* src = xs + (int64_t)h0 * wp + wc;
    for (int h = tid / T2; h < T1; h += kThreads / T2) {
      const bool in = wc < wp && h0 + h < hp;
      cp_async4(reinterpret_cast<float*>(s_p + v3_win<T1, T2>(h, c % N2)) + c / N2,
                in ? src + (int64_t)h * wp : xs, in ? 4 : 0);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // H DFT of the packed columns, G a pass, each warp owning CW of them
  // through both steps (hstep_tiles), its bins written over its own samples
  // (v3_bin)
  for (int c0 = 0; c0 < N2; c0 += G)
    hstep_tiles<T1, X3, false>(
        s.stage, frag,
        [&](int m, int j1) { return s_p[v3_win<T1, T2>(j1 * B1 + m % B1, c0 + m / B1)]; },
        s.tw1,
        [&](int c, int m1, int m2, float2 v) { s_p[v3_bin<T1, T2>(m1 + A1 * m2, c0 + c)] = v; });
  __syncthreads();

  // W DFT of the T1/2 rows, each warp owning kRowGroup rows at a time from
  // the split to D (row_group_tc): step 1 splits bins k and -k of packed
  // column c % (T2/2) into column c's one-sided bin k in FP32 as it loads
  // them (as v3_split, from the tile's own columns c and c -+ T2/2), and row
  // 0 takes bins 0 and T1/2 of every column, both real, as one complex row
  // X[0, c] + i X[T1/2, c]; step 2 stores bin k2 of each row to D in natural
  // order, but row 0's bins Z, which go back to the plane (tc_col) and are
  // split in FP32 into D's rows 0 and T1/2: (Z[k] + conj Z[-k]) / 2 and
  // (Z[k] - conj Z[-k]) / 2i
  float2* dout = d + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * P::kPlane;
  for (int r0 = (tid >> 5) * kRowGroup; r0 < N1; r0 += kWarps * kRowGroup) {
    row_group_tc<T2, X3, false, false>(
        s_p, r0, N1, frag, s.tw2,
        [&](int k, int c) {
          const float2 a = s_p[sw<T2>(k, c % N2)], b = s_p[sw<T2>(k, c % N2 + N2)];
          const bool low = c < N2;
          const float2 u = low ? a : make_float2(a.y, -a.x), w = low ? b : make_float2(b.y, -b.x);
          // X_c[k] = (Z[k] + conj Z[-k]) / 2 below T2/2, (Z[k] - conj Z[-k]) / 2i above (the
          // same sums with their terms swapped or negated); row 0: X[0, c] + i X[T1/2, c]
          return k == 0 ? (low ? make_float2(a.x, b.x) : make_float2(a.y, b.y))
                        : make_float2(0.5f * (u.x + w.x), 0.5f * (u.y - w.y));
        },
        [&](int k, int m1, int m2, float2 v) {
          if (k == 0)
            s_p[sw<T2>(0, m1 * B2 + m2)] = v;
          else
            dout[k * T2 + m1 + A2 * m2] = v;
        });
    if (r0 == 0) {
      for (int k2 = tid & 31; k2 < T2; k2 += 32) {
        const float2 z = s_p[sw<T2>(0, tc_col<T2>(k2))];
        const float2 m = s_p[sw<T2>(0, tc_col<T2>((T2 - k2) % T2))];
        dout[k2] = make_float2(0.5f * (z.x + m.x), 0.5f * (z.y - m.y));
        dout[N1 * T2 + k2] = make_float2(0.5f * (z.y + m.y), 0.5f * (m.x - z.x));
      }
    }
  }
}

// The slot of h[n, l] (folded_h's values, l in [0, T2/2)) in the inverse
// stage of B5's tensor-core route: row n / 2 of the plane, the row that row
// pair n / 2 of the W c2r takes in place, at column l for even n and T2 - l
// for odd n; for l = 0 the two real values h[n, 0] and h[n, T2/2] go to
// columns 0 and T2/2, the even row's as the real parts and the odd row's as
// the imaginary parts. Each slot lies in a column that column pair l's folded
// H inverse reads (folded_s: l and T2 - l, or 0 and T2/2), so a warp's pass
// writes over what only it reads, and row p ends up holding both rows of h
// that element c of its c2r input needs at columns c and T2 - c (pair_c2r_in).
template <int T2>
__device__ __forceinline__ void pair_store(float2* s_p, int n, int l, float2 h) {
  constexpr int N2 = T2 / 2;
  if (l == 0) {  // h = h[n, 0] + i h[n, T2/2]
    reinterpret_cast<float*>(s_p + sw<T2>(n >> 1, 0))[n & 1] = h.x;
    reinterpret_cast<float*>(s_p + sw<T2>(n >> 1, N2))[n & 1] = h.y;
  } else {
    s_p[sw<T2>(n >> 1, n & 1 ? T2 - l : l)] = h;
  }
}

// folded_s's element k of column pair l, with the same FP32 arithmetic and
// no branch: one load (two for l = 0 and for bins 0 and T1/2) and selects.
template <int T1, int T2>
__device__ __forceinline__ float2 folded_s_tc(const float2* s_p, int k, int l) {
  constexpr int N1 = T1 / 2, N2 = T2 / 2;
  const int m = l == 0 ? N2 : T2 - l, kk = k <= N1 ? k : T1 - k;
  const bool mid = k == 0 || k == N1, up = k > N1, two = mid || l == 0;
  const float2 a = s_p[sw<T2>(kk, up && !two ? m : l)];
  float2 e = make_float2(0.f, 0.f);
  if (two) e = s_p[sw<T2>(kk, m)];
  const float ay = up ? -a.y : a.y;  // conj of bin T1 - k: a sign flip, no rounding
  if (l == 0)  // S_0 + i S_T2/2 from columns 0 and T2/2
    return mid ? make_float2(a.x, e.x) : make_float2(a.x - (up ? -e.y : e.y), ay + e.x);
  return mid ? make_float2(0.5f * (a.x + e.x), 0.5f * (a.y - e.y)) : make_float2(a.x, ay);
}

// Element c of row pair p's W c2r input from row p of the plane (pair_store):
// E_2p[c] + i E_2p+1[c], E the Hermitian extension of a row of h, as c2r_in
// forms it, E_2p+1 zero where row 2p + 1 is past the valid rows (two false).
template <int T2>
__device__ __forceinline__ float2 pair_c2r_in(const float2* s_p, int p, bool two, int c) {
  constexpr int N2 = T2 / 2;
  const float2 a = s_p[sw<T2>(p, c)], b = s_p[sw<T2>(p, (T2 - c) % T2)];
  // c < T2/2: a = h[2p, c], b = h[2p + 1, c]; c > T2/2: a = h[2p + 1, T2 - c], b = h[2p, T2 - c]
  const bool low = c < N2;
  const float2 e0 = low ? a : b;
  float2 e1 = low ? b : a;
  if (!two) e1 = make_float2(0.f, 0.f);
  // E0 + i E1 below T2/2, conj(E0) + i conj(E1) above: one sign flip, no rounding
  const float2 z = make_float2(e0.x - (low ? e1.y : -e1.y), (low ? e0.y : -e0.y) + e1.x);
  const bool real = c == 0 || c == N2;  // bins 0 and T2/2: the two real values as they are
  return real ? make_float2(a.x, two ? a.y : 0.f) : z;
}

// The inverse stage of B5's tensor-core route, grid (B * Cout, tiles of this
// launch): the MAC stage's Y of one (b, o, tile) (MODE 0's natural order)
// into the plane by 16-byte cp.async; the folded H inverse of
// fused2d_v3_mac_inverse, a pass of G column pairs through the staging, each
// warp owning CW of them through both steps (hstep_tiles), h written over
// the pairs' own columns into the rows of its row pairs (pair_store); then
// the W c2r of the ceil(V1 / 2) row pairs in place in the plane, warp w
// owning pairs [w P / 8, (w + 1) P / 8) of the P, kRowGroup at a time
// through both steps (row_group_tc, its step-1 tiles closed under c -> T2 -
// c, whose loads form E_2p + i E_2p+1, pair_c2r_in; step 2 stores the two
// output rows with 1/(T1 T2)): two block barriers in all.
template <int T1, int T2, int MODE>
__global__ void __launch_bounds__(kThreads, B2Plan<T1, T2>::kMinBlocks)
fused2d_v3_inverse_tc(const float2* __restrict__ y,       // (units of this launch, Cout, NB1, T2)
                      const uint32_t* __restrict__ frag,  // fused2d.py: _tc_fragments
                      const float2* __restrict__ fac,     // factors, fused2d.py: _device_factors
                      float* __restrict__ out,            // (B, Cout, oh, ow)
                      int v1, int v2, int nt2, int tile0, int oh, int ow) {
  using P = B2Plan<T1, T2>;
  constexpr bool X3 = MODE == 3;
  constexpr int A1 = P::kA1, B1 = P::kB1, A2 = P::kA2, G = P::kG, N2 = T2 / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const B2Smem<T1, T2, false> s(smem_raw, fac);
  float2* s_p = s.plane;

  const int tid = threadIdx.x;
  const int tile = tile0 + blockIdx.y;
  const int h0 = (tile / nt2) * v1, w0 = (tile % nt2) * v2;
  const float2* yp = y + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * P::kPlane;
  for (int i = tid; i < P::kPlane / 2; i += kThreads) cp_async16(s_p + 2 * i, yp + 2 * i);
  cp_async_wait_all();
  __syncthreads();

  for (int c0 = 0; c0 < N2; c0 += G)
    hstep_tiles<T1, X3, true>(
        s.stage, frag,
        [&](int m, int j1) { return folded_s_tc<T1, T2>(s_p, j1 * B1 + m % B1, c0 + m / B1); },
        s.tw1,
        [&](int c, int m1, int m2, float2 v) {
          const int n = m1 + A1 * m2;
          if (n < v1) pair_store<T2>(s_p, n, c0 + c, v);
        });
  __syncthreads();

  const float scale = 1.f / (float)(T1 * T2);
  float* oplane = out + (int64_t)blockIdx.x * oh * ow;
  const int npair = (v1 + 1) / 2, warp = tid >> 5;
  const int pe = (warp + 1) * npair / kWarps;
  for (int p0 = warp * npair / kWarps; p0 < pe; p0 += kRowGroup)
    row_group_tc<T2, X3, true, true>(
        s_p, p0, pe, frag, s.tw2,
        [&](int p, int c) { return pair_c2r_in<T2>(s_p, p, 2 * p + 1 < v1, c); },
        [&](int p, int m1, int m2, float2 v) {  // sample z of output rows 2p and 2p + 1
          const int z = m1 + A2 * m2, r = 2 * p, oy = h0 + r, ox = w0 + z;
          if (z < v2 && ox < ow && oy < oh) {
            float* row = oplane + (int64_t)oy * ow + ox;
            row[0] = v.x * scale;
            if (r + 1 < v1 && oy + 1 < oh) row[ow] = v.y * scale;
          }
        });
}

// B2's tensor-core route, or with V3 B5's: phase 1, the MAC stage (MODE 0
// for B5: no W DFT) and the inverse stage of each.
template <int T1, int T2, int MODE, bool V3>
cudaError_t launch_tc(const float* x, const float2* ks, const uint32_t* frag, const float2* fac,
                      float2* d, float2* y, float* out, int batch, int cin, int cout, int groups,
                      int hp, int wp, int v1, int v2, int nt2, int tile0, int ntile, int oh,
                      int ow, int upb, int ocb, cudaStream_t stream) {
  using P = B2Plan<T1, T2>;
  constexpr size_t smem = V3 ? P::kSmemV3 : P::kSmem;
  const auto spectra = V3 ? fused2d_v3_spectra_tc<T1, T2, MODE> : fused2d_spectra_tc<T1, T2, MODE>;
  const auto mac = fused2d_mac_tc<T1, T2, V3 ? 0 : MODE>;
  const auto inverse = V3 ? fused2d_v3_inverse_tc<T1, T2, MODE> : fused2d_inverse_tc<T1, T2, MODE>;
  // the MAC stage's plane, twiddle and D rings
  constexpr size_t mac_ring = sizeof(float2) * (T2 + kMacStages * kMacKC * T2);
  constexpr size_t mac_smem = kMacPlaneBytes + mac_ring;
  if (v1 < 1 || v1 > T1 || v2 < 1 || v2 > T2 || nt2 < 1 || ntile < 1 || ntile > 65535 ||
      tile0 < 0 || groups < 1 || cin % groups || cout % groups || upb < 1 || ocb < 1 ||
      (int64_t)upb * ocb * T2 * (int64_t)sizeof(float2) > kMacPlaneBytes)
    return cudaErrorInvalidValue;
  const int units = ntile * batch, og = cout / groups;
  cudaError_t err =
      cudaFuncSetAttribute(spectra, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mac, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)mac_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(inverse, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  spectra<<<dim3(batch * cin, ntile), kThreads, smem, stream>>>(x, frag, fac, d, hp, wp, v1, v2,
                                                                nt2, tile0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 mac_grid((units + upb - 1) / upb, P::kNB1, groups * ((og + ocb - 1) / ocb));
  mac<<<mac_grid, kThreads, sizeof(float2) * (size_t)upb * ocb * T2 + mac_ring, stream>>>(
      d, ks, frag, fac, y, units, cin, cout, groups, upb, ocb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  inverse<<<dim3(batch * cout, ntile), kThreads, smem, stream>>>(y, frag, fac, out, v1, v2, nt2,
                                                                 tile0, oh, ow);
  return cudaGetLastError();
}

template <int MODE, bool V3>
cudaError_t launch_tc_plan(int t1, int t2, const float* x, const float2* ks,
                           const uint32_t* frag, const float2* fac, float2* d, float2* y,
                           float* out, int batch, int cin, int cout, int groups, int hp, int wp,
                           int v1, int v2, int nt2, int tile0, int ntile, int oh, int ow, int upb,
                           int ocb, cudaStream_t stream) {
#define FUSED2D_TC_LAUNCH(T1, T2)                                                            \
  if (t1 == T1 && t2 == T2)                                                                  \
    return launch_tc<T1, T2, MODE, V3>(x, ks, frag, fac, d, y, out, batch, cin, cout, groups, \
                                       hp, wp, v1, v2, nt2, tile0, ntile, oh, ow, upb, ocb,     \
                                       stream);
  FUSED2D_TC_LAUNCH(128, 128)
  FUSED2D_TC_LAUNCH(256, 128)
  FUSED2D_TC_LAUNCH(384, 128)
  FUSED2D_TC_LAUNCH(128, 256)
#undef FUSED2D_TC_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// Runs tiles [tile0, tile0 + ntile) (row-major over nt1 x nt2) of one
// convolution with kernel B2. x (B, Cin, hp, wp) f32; ks (Cout, Cin/groups,
// t1/2+1, t2) the conjugated spectra; fac the factors (fused2d.py:
// _device_factors); d scratch (ntile, B, Cin, t1/2+1, t2); out (B, Cout, oh,
// ow) f32. Complex arrays are interleaved (re, im) float pairs. Returns
// cudaGetLastError() after the two launches (0 when both were accepted).
extern "C" int fused2d_forward(const void* x, const void* ks, const void* fac, void* d,
                               void* out, int batch, int cin, int cout, int groups, int hp,
                               int wp, int t1, int t2, int v1, int v2, int nt2, int tile0,
                               int ntile, int oh, int ow, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* ksc = static_cast<const float2*>(ks);
  const auto* fc = static_cast<const float2*>(fac);
  auto* dc = static_cast<float2*>(d);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define FUSED2D_LAUNCH(T1, T2)                                                              \
  if (t1 == T1 && t2 == T2)                                                                 \
    return launch<T1, T2>(xf, ksc, fc, dc, of, batch, cin, cout, groups, hp, wp, v1, v2, nt2, \
                          tile0, ntile, oh, ow, s);
  FUSED2D_LAUNCH(128, 128)
  FUSED2D_LAUNCH(256, 128)
  FUSED2D_LAUNCH(384, 128)
  FUSED2D_LAUNCH(128, 256)
#undef FUSED2D_LAUNCH
  return cudaErrorInvalidValue;
}

// fused2d_forward under a tensor-core mode: mode 3 is "bf16x3", 1 is "bf16";
// frag the fragment buffer of fused2d.py:_tc_fragments; y scratch (ntile, B,
// Cout, t1/2+1, t2) complex for the MAC stage's output; upb and ocb the
// units (tile, batch row) and the output channels of a MAC-stage block
// (fused2d.py: _tc_geometry), upb * ocb * t2 * 8 at most
// fused2d_tc_plane_bytes(); the other arguments as fused2d_forward's.
// Returns cudaGetLastError() after the three launches (0 when all were
// accepted).
namespace {

template <bool V3>
int forward_tc(const void* x, const void* ks, const void* frag, const void* fac, void* d,
               void* y, void* out, int batch, int cin, int cout, int groups, int hp, int wp,
               int t1, int t2, int mode, int v1, int v2, int nt2, int tile0, int ntile, int oh,
               int ow, int upb, int ocb, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* ksc = static_cast<const float2*>(ks);
  const auto* fr = static_cast<const uint32_t*>(frag);
  const auto* fc = static_cast<const float2*>(fac);
  auto* dc = static_cast<float2*>(d);
  auto* yc = static_cast<float2*>(y);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (mode == 3)
    return launch_tc_plan<3, V3>(t1, t2, xf, ksc, fr, fc, dc, yc, of, batch, cin, cout, groups,
                                 hp, wp, v1, v2, nt2, tile0, ntile, oh, ow, upb, ocb, s);
  if (mode == 1)
    return launch_tc_plan<1, V3>(t1, t2, xf, ksc, fr, fc, dc, yc, of, batch, cin, cout, groups,
                                 hp, wp, v1, v2, nt2, tile0, ntile, oh, ow, upb, ocb, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fused2d_forward_tc(const void* x, const void* ks, const void* frag,
                                  const void* fac, void* d, void* y, void* out, int batch,
                                  int cin, int cout, int groups, int hp, int wp, int t1, int t2,
                                  int mode, int v1, int v2, int nt2, int tile0, int ntile, int oh,
                                  int ow, int upb, int ocb, void* stream) {
  return forward_tc<false>(x, ks, frag, fac, d, y, out, batch, cin, cout, groups, hp, wp, t1, t2,
                           mode, v1, v2, nt2, tile0, ntile, oh, ow, upb, ocb, stream);
}

// Kernel B5 under a tensor-core mode: its tensor-core route, with arguments
// as fused2d_forward_tc's (ks the complex spectra, d and y complex scratch
// of the same shapes; upb and ocb from fused2d.py: _tc_geometry). Returns
// cudaGetLastError() after the three launches (0 when all were accepted).
extern "C" int fused2d_v3_forward_tc(const void* x, const void* ks, const void* frag,
                                     const void* fac, void* d, void* y, void* out, int batch,
                                     int cin, int cout, int groups, int hp, int wp, int t1,
                                     int t2, int mode, int v1, int v2, int nt2, int tile0,
                                     int ntile, int oh, int ow, int upb, int ocb, void* stream) {
  return forward_tc<true>(x, ks, frag, fac, d, y, out, batch, cin, cout, groups, hp, wp, t1, t2,
                          mode, v1, v2, nt2, tile0, ntile, oh, ow, upb, ocb, stream);
}

// The bytes of the tensor-core route's MAC-stage plane, which bound its
// blocks' rows (fused2d.py: _TC_PLANE_BYTES; a card test holds the two equal).
extern "C" long long fused2d_tc_plane_bytes() { return kMacPlaneBytes; }

// B2's dynamic shared memory of one block of either kernel for a (t1, t2)
// tile, or -1 for a T2 it does not take. The host's tile plan mirrors this
// formula (fused2d.py: _smem_bytes); a card test holds the two together.
extern "C" long long fused2d_smem_bytes(int t1, int t2) {
  if ((t2 != 128 && t2 != 256) || t1 < 128 || t1 % 128) return -1;
  return (long long)smem_bytes(t1, t2);
}

// Kernel B5 on tiles [tile0, tile0 + ntile) of one convolution: arguments as
// fused2d_forward's, but ks (Cout, Cin/groups, 2, t1/2+1, t2) float32, the
// conjugated spectra as (re, im) planes, and d scratch (ntile, B, Cin, 2,
// t1/2+1, t2) float32. Returns cudaGetLastError() after the two launches.
extern "C" int fused2d_v3_forward(const void* x, const void* ks, const void* fac, void* d,
                                  void* out, int batch, int cin, int cout, int groups, int hp,
                                  int wp, int t1, int t2, int v1, int v2, int nt2, int tile0,
                                  int ntile, int oh, int ow, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* ksf = static_cast<const float*>(ks);
  const auto* fc = static_cast<const float2*>(fac);
  auto* df = static_cast<float*>(d);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define FUSED2D_V3_LAUNCH(T1, T2)                                                             \
  if (t1 == T1 && t2 == T2)                                                                   \
    return launch_v3<T1, T2>(xf, ksf, fc, df, of, batch, cin, cout, groups, hp, wp, v1, v2,    \
                             nt2, tile0, ntile, oh, ow, s);
  FUSED2D_V3_LAUNCH(128, 128)
  FUSED2D_V3_LAUNCH(256, 128)
  FUSED2D_V3_LAUNCH(384, 128)
  FUSED2D_V3_LAUNCH(128, 256)
#undef FUSED2D_V3_LAUNCH
  return cudaErrorInvalidValue;
}

// B5's dynamic shared memory of one block of either kernel for a (t1, t2)
// tile: B2's without the packed column. -1 for a T2 it does not take
// (fused2d.py: _smem_bytes_v3).
extern "C" long long fused2d_v3_smem_bytes(int t1, int t2) {
  if ((t2 != 128 && t2 != 256) || t1 < 128 || t1 % 128) return -1;
  return (long long)smem_bytes(t1, t2, false);
}

// The CUDA runtime's message for an error code returned above.
extern "C" const char* fused2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
