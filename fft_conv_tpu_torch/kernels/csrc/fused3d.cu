// Fused 3D FFT convolution for Hopper (sm_90a), in FP32: two chains of
// kernels that share their H/W stages.
//
// B3 replaces the TPU kernel fft_conv_tpu/kernels/fused3d.py:735
// (_make_kernel_v4, built by _fused3d_call_v4), the overlap-save-D plan for
// KD <= 9; B4 replaces fft_conv_tpu/kernels/fused3d.py:1233 (_make_kernel_3d,
// built by _fused3d_call), the "tap" plan for KD > 9 and for shapes where the
// v4 plan does not fit. Both compute the valid cross-correlation of a padded
// (B, Cin, D, H, W) signal with a (Cout, Cin/g, KD, KH, KW) kernel. The whole
// volume is transformed along H and W per d-slab: a one-sided H DFT at a
// working length Hw >= H (NBH = Hw/2+1 rows; see below) and a 64-point W DFT
// over a block of 64 columns
// (zeros past the signal's edge; wider signals run as overlap-save W blocks,
// the last one clamped to end at the edge). Along D, B3 takes a DFT-16 per
// block of 16 slabs on a hop of 8 (zeros past D), so its MAC over each
// group's input channels against the conjugated kernel spectra is pointwise
// and the inverse DFT-16 keeps the 8 valid d of each block; B4 keeps D in
// the tap domain and correlates along it, Y[o, d] = sum_c sum_u T[c, d + u]
// K[o, c, u], against the conjugated per-tap 2D spectra. Then the inverse W
// DFT and the H irfft (DC and Nyquist weighted 1, the rest 2, their
// imaginary rows zeroed) keep the valid columns and rows. All arithmetic is
// FP32 on CUDA cores (the tensor-core chains of the precision modes "bf16x3"
// and "bf16" are described in the section of the tensor-core kernels). The W DFT-64 and
// its inverse are four-step transforms
// 64 = 8 * 8 (fourstep.fft_factor_matrices(8, 8), built in float64 and cast
// to float32 by the host): per row, the 8-point DFT over j1 of x[8 j1 + j2]
// and the twiddle tw[m1, j2], in place in shared memory, then the 8-point DFT
// over j2 onto the bin m1 + 8 m2, in natural order. Each short DFT runs in
// registers as radix-2 butterflies on the roots of unity.
//
// The H transforms. For every H from 16 to 256 they run at the working
// length Hw, the least even length >= H that splits as Hw = HA * HB with
// both factors at most 16 and HB even (fused3d.py: _h_work,
// fourstep.padded_split): H itself where it splits (the powers of two as
// 4 * 4 to 16 * 16, 48 = 8 * 6, the stuffed 78 = 13 * 6 of the 3D
// transposed K=8 row), else a few rows more (82 -> 84 = 7 * 12 for K=10; at
// most 3 rows, at H = 33). The signal's rows H to Hw - 1 are zeros: the
// H-circular correlation at Hw equals the linear one on the valid rows,
// since no stored row wraps. The H transforms are factored four-step and run
// on slab pairs, as B1 runs its columns: the forward packs slabs 2p and
// 2p + 1 as one complex column x_2p + i x_2p+1, takes its Hw-point DFT and
// splits bins k and Hw - k into the two slabs' one-sided rows; the inverse
// takes one conjugated Hw-point DFT of E_2p + i E_2p+1, each
// Hermitian-extended (DC and Nyquist taken real, as the irfft weights them),
// whose real and imaginary parts are the two slabs' output rows. An odd last
// slab is paired with zeros. Their short DFTs (dft_emit) are radix-2 for a
// power of two and the real-symmetric form for 3, 5, 6, 7, 9 to 15, each a
// pair of sums for two bins. Outside 16 to 256 (H < 16, and 256 < H <= 906,
// as far as the plan's NBH <= 454 goes) Hw = H and the H transforms are
// dense products, a one-sided H DFT and an irfft on the valid rows. The D
// DFT-16 and its inverse are four-step transforms 16 = 4 * 4 (fused3d.py:
// _D_SPLIT), the MACs complex FMAs. The host side (plans, factors, kernel
// spectra, item ranges) is in fft_conv_tpu_torch/kernels/fused3d.py.
//
// Partition. A TPU cell holds a whole volume of every channel in its vector
// memory (90.5 MB at the 64^3 benchmark); one D-block's spectrum of one
// channel is 16 x 33 x 64 complex (270 KB), more than a Hopper block can
// hold. So the work is cut into kernels launched back to back on the
// caller's stream, each handing its result to the next through a scratch
// buffer in device memory (L2 at the benchmark). An "item" is one (batch,
// W-block) pair:
//   1 hw_forward (B3 and B4), grid (items * Cin, D / SB): SB d-slabs from
//     the signal, the one-sided H DFT into shared memory, the factored W DFT
//     (step 1 in place, step 2 stored from registers) into the scratch T
//     (items, Cin, D, NBH, 64);
//   2 d_mac (B3), grid (positions / 8, Cout / OPB): a block owns 8 (n, z)
//     bins and OPB output channels of one group, stages their spectra in
//     shared memory once and walks every (item, D-block) pair of the launch,
//     a warp a pair: per input channel the factored DFT-16 of the block's 16
//     slabs of T (4 lanes a bin, each at 4 of the 16 D-bins), the MAC, and
//     after the group's channels the inverse DFT-16 onto the 8 valid d,
//     finished across the 4 lanes by shuffles. S lives in registers only.
//     Writes Z (items, Cout, OD, NBH, 64);
//   2' tap_mac (B4, in place of 2), grid (positions / 16, Cout / OPB): a
//     block owns 16 bins and OPB output channels of one group, stages their
//     per-tap spectra once and walks every (item, chunk of 8 valid d) pair,
//     a thread a (bin, pair): for each of the group's channels it slides a
//     window of T values over the KD taps in registers, a slab a tap, and
//     reads its OPB spectra at that tap from shared memory; the sums stay in
//     registers (OPB x 8 complex, whatever KD is). Writes Z;
//   3 hw_inverse (B3 and B4), grid (items * Cout, OD / SB): SB slabs of Z
//     into shared memory, the factored inverse W DFT in place, the H inverse
//     on the valid rows, and the valid (d, h, w) samples stored straight
//     into (B, Cout, OD, OH, OW).
// Two versions of phases 1 and 3 run:
//   * factored (H = 16 to 256, fused3d_hw_forward_f and fused3d_hw_inverse_f,
//     SB = kSBF = 2 slabs, one pair; built for the constant splits of Hw =
//     16, 32, 64, 128 and once for a split handed as arguments, whose H
//     steps dispatch to the short DFT of each radix): phase 1 copies the two
//     slabs' H x 64 samples into shared memory by cp.async, 16 bytes a
//     thread (4-byte copies with zero-fill where a row runs past W or starts
//     off alignment, zero-fill past D, zeros in rows H to Hw - 1), all issued
//     at the block's start, into two planes of Hw + 2 rows (px: 16-byte
//     chunks permuted per row), slab 2p in one and
//     2p + 1 in the other, so that the packed complex column is read across
//     them; then, each step in place and ended by a barrier, the H DFT's two
//     steps, W step 1 fused with the split of bins k and Hw - k, and W step 2,
//     whose rows are put back in natural bin order and stored to T a whole
//     512-byte row per warp instruction. Phase 4 copies its contiguous run of
//     Z by 8-byte cp.async into the swizzled rows (sw), runs W step 1, then W
//     step 2 on the rows k of both slabs at once, writing the pair's
//     Hermitian-extended column V in place of their rows, then the H inverse's
//     two steps, storing Re and Im of its rows below OH to the two slabs;
//   * dense (H < 16 or H > 256, fused3d_hw_forward and fused3d_hw_inverse): SB
//     is 4 when 4 * NBH * 64 complex values fit a block's shared memory
//     (67.6 KB at H = 64), else 2 or 1. The H DFT reads the signal with
//     __ldg inside its contraction and the H irfft reads the rows of E, both
//     register-tiled: a thread owns one column of SB slabs and up to 9
//     (complex) or 15 (real) rows, and per contraction step reads one L1
//     broadcast per row and one value per slab, about one load per 5 FMAs at
//     SB = 4.
// The rows of the dense kernels and of the factored inverse are swizzled (sw)
// so that the strided accesses of the W steps, a half-warp on 8 columns 8
// apart in each of two rows, fall in distinct banks. The factors stay out of
// shared memory (roots in registers, the twiddles through L1), whose size is
// the plan's formula, Cfg<SB>::smem at the plan's SB; the factored kernels
// use kSBF <= SB slabs of it.
//
// Bound. At the library's 3D benchmark (B=2, 8 -> 8 channels, 64^3, K=8) B3's
// call needs about 0.52 GFLOP (FMA = 2; kernels/costs.py: fused3d_work, every
// transform factored where its length splits, the DFT-16s too, no product
// by 1, -1 or +-i, none over zeros past D, none for outputs not stored):
// 0.008 ms at the FP32 CUDA-core rate of 67 TFLOP/s. It must move about 46
// MB (signal 16.8, spectra 17.3, output 11.9): 0.014 ms at 3.35 TB/s, so
// bytes bound it. Done as dense products the same call was 3.7 GFLOP, half
// of them the W DFTs (H DFT 0.55, W DFT 1.11, DFT-16 0.29, MAC 0.28, inverse
// D 0.25, inverse W 0.88, H irfft 0.39). With every DFT factored the kernels
// do about 0.68 GFLOP, 0.48 of it in d_mac (costs.fused3d_kernel_flops). B4
// at the same volume with K=10 needs about
// 1.34 GFLOP (0.020 ms, the tap MAC 1.19 of it) against 38.2 MB to move
// (0.011 ms); operations bound it. At the stuffed volumes of the transposed
// rows the least work is counted at the signal's own H (no credit for the
// padding to Hw): 78^3 at K=8 (B3, two W blocks) 1.62 GFLOP and 74.2 MB,
// 0.024 ms (operations); 82^3 at K=10 (B4) 5.17 GFLOP, the tap MAC 4.0 of
// it, 0.077 ms (operations). The H/W pair's stage there moves 151 and 167
// MB (the signal and T, Z and the output, once each; costs.fused3d_hw_work):
// 0.045 and 0.050 ms, bytes bound it.
//
// Schedule of the factored H/W kernels. Neither bound holds them: the pair
// moves about 61 MB at 64^3 (x 16.8 and T 17.3 in the forward, Z 15.4 and
// the output 11.9 in the inverse; 0.018 ms at 3.35 TB/s) and does about 0.2
// GFLOP. Each block runs a chain of copies, barriers and short DFTs, so a
// block holds one slab pair ((Hw + 2) * 512 B: 33.8 KB at Hw = 64, 132 KB
// at 256), its steps keep no sums across a barrier, and for the four
// constant splits __launch_bounds__(256, kHwBlocks = 3) caps a thread at 80
// registers, so that 3 blocks (24 warps) share an SM; the grids are 512
// blocks (forward) and 464 / 448 (inverse, B3 / B4) at the benchmark, on
// 396 slots. The kernels that take their split as arguments hold the
// runtime row strides and radix cases in registers too: at 80 they spill,
// so they are bounded at kHwBlocksAny = 2 blocks an SM (128 registers);
// shared memory allows 2 blocks up to Hw = 224 and 1 up to 256. On the H100
// (PERF.md) the forward takes about 0.022 ms and the inverse 0.016 at 64^3,
// about half the HBM rate; two pairs a block, 2 to 4 blocks an SM and
// 128-thread blocks all time within 5% of that. The precision modes'
// tensor-core H/W kernels (below) keep one slab pair a block too, in one
// plane of complex rows, built for the rows' four splits and once for a
// split taken as arguments, each bounded for 2 blocks an SM.
//
// Schedule of the D kernels. Their stage moves T in, the spectra in and Z
// out (50.0 MB for B3 at the benchmark, 0.0149 ms at 3.35 TB/s, bytes bound
// it: costs.fused3d_d_work; 43.0 MB and 1.19 GFLOP for B4 at K=10, 0.0178
// ms, operations bound it: costs.fused3d_tap_mac_work). As two kernels
// (DFT-16, then MAC and inverse) B3 would pass S, twice the size of T,
// through L2 and re-read it and the spectra, about 0.4 GB. d_mac keeps S in
// registers and reads each spectrum value
// once per block: a block owns 8 bins and all 8 output channels of a group
// (a 64 KB tile), so T is read twice (the blocks of a D-block pair overlap
// by 8 slabs; re-read rather than carried, since a carry would hold 4
// complex values a lane per channel of the group) and the L2 traffic is
// about 67 MB. 264 blocks of 8 warps, 2 an SM, one wave on 132 SMs. The
// DFT-16 runs at one output of step 1 a lane (the 4 lanes of a bin read
// the same 16 slabs, one request), so no shuffle is needed before the MAC;
// the inverse ends in a reduce-scatter over the 4 lanes that keeps only the
// 8 valid d. tap_mac reads each spectrum value once per block (16 bins x 4
// output channels) and T (17 slabs for 8 d at KD = 10) twice, one output
// chunk each; per tap a thread does 32 complex MACs for 4 shared-memory
// reads and one L2 read, issued a tap ahead. A group whose
// tile exceeds kStageBytes is staged in chunks of channels (d_mac) or of
// (channel, tap) entries (tap_mac), re-staged once per round of pairs.
// Under the precision modes B3 runs d_mac_tc (below) in place of d_mac:
// 16 bins a block, at most 4 output channels, T staged by cp.async, one
// wave at 2 blocks an SM; B4 keeps tap_mac. wgmma and TMA staging are left
// for later work.
//
// B6 replaces fft_conv_tpu/kernels/fused3d.py:1184 (_pack3d_call), the TPU's
// x-pack kernel of the "pk" x-pack mode: a pure permutation of the signal
// into the layout xp (items, H, Cin * PP, 128), xp[item, h, c * PP + p,
// 64 * s + w] = x[b, c, 2p + s, h, start + w] (zeros for d >= D and past W),
// where PP is the plan's d-pair count and start the item's W-block start.
// It also fuses the wrapper's pad and W-block stack in front of the TPU
// kernel, so nothing runs ahead of it. B3 then reads xp in place of x
// (hw_forward's packed mode: slab d of channel c is row c * PP + d / 2,
// lanes 64 * (d % 2) + [0, 64), every lane valid). Bound: bytes, the signal
// read once and xp written once (16.8 + 21.0 MB at the 64^3 benchmark row,
// 0.0113 ms at 3.35 TB/s). One thread writes one float4 of an xp row, so a
// warp reads two 256 B runs of the signal and writes one 512 B row; a read
// is a float4 where the source is 16 B aligned and wholly inside W, else
// four masked scalars (the clamped last W block starts off alignment).
//
// B7 (fused3d_spectra_taps, below) computes B3's kernel spectra from the raw
// taps on the card under set_fused3d_inline, the port of the TPU kernel's
// inline-spectra body.
//
// Entry points: fused3d_forward (B3), fused3d_tap_forward (B4), their
// tensor-core chains fused3d_forward_tc and fused3d_tap_forward_tc,
// fused3d_pack (B6) and fused3d_spectra_v4 (B7), plain C interfaces loaded
// with ctypes. Each returns cudaGetLastError() after its launches; 0 means
// all were accepted.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bf16_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTW = 64;                         // W transform length = column threads
constexpr int kRowGroups = kThreads / kTW;      // interleaved row groups
constexpr int kDB = 16;                         // D block length
constexpr int kDHop = 8;                        // D hop = valid d per block
constexpr int kMaxSmem = 232448;                // a Hopper block's shared memory

template <int SB>
struct Cfg {
  // rows a thread owns per pass of the dense H stages: complex (H forward)
  // and real (H irfft); sized so that the sums and the loads the compiler
  // hoists ahead of them stay within 128 registers without spills
  static constexpr int kRpt = SB == 4 ? 9 : (SB == 2 ? 13 : 17);
  static constexpr int kRptR = SB == 4 ? 15 : (SB == 2 ? 21 : 29);
  static size_t smem(int nbh) { return (size_t)SB * nbh * kTW * sizeof(float2); }
};

// acc += a * b (complex)
__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

// ---- The W DFT-64, factored as 8 * 8 ------------------------------------------

// The four-step split 64 = A * B (fused3d.py: _W_SPLIT). The host hands the
// factors (fused3d.py: _w_factors) as one vector: the A roots of unity, the
// B roots and the (A, B) twiddle tw[m1, j2], row-major; the inverse
// conjugates all three.
constexpr int kWA = 8, kWB = 8;
static_assert(kWA * kWB == kTW, "the W split must factor the W length");

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

// One radix-2 stage of LEN-point butterflies (decimation in time), then the
// next; the twiddle root[0] = 1 is skipped, and with FOLD so is root[N / 4]
// = -i, taken as a swap and a sign (the H steps' short DFTs; the W and D
// ones keep the product). root holds R >= N / 2 roots.
template <int N, int LEN, bool INV, int R, bool FOLD = false>
__device__ __forceinline__ void dit_stages(float2 (&t)[N], const float2 (&root)[R]) {
  if constexpr (LEN <= N) {
#pragma unroll
    for (int i = 0; i < N; i += LEN) {
#pragma unroll
      for (int j = 0; j < LEN / 2; ++j) {
        const float2 u = t[i + j];
        float2 w = t[i + j + LEN / 2];
        const int k = j * (N / LEN);
        if (FOLD && 4 * k == N)
          w = INV ? make_float2(-w.y, w.x) : make_float2(w.y, -w.x);  // w * (+-i)
        else if (k != 0)
          w = cmulw<INV>(w, root[k]);
        t[i + j] = cadd(u, w);
        t[i + j + LEN / 2] = csub(u, w);
      }
    }
    dit_stages<N, 2 * LEN, INV, R, FOLD>(t, root);
  }
}

// v <- the N-point DFT of v (N a power of two; INV: conjugated, unscaled),
// natural order in and out, as radix-2 butterflies on the bit-reversed
// input; root[k] = exp(-2 pi i k / N) for k < N / 2 (of R >= N / 2), in
// registers.
template <int N, bool INV, int R, bool FOLD = false>
__device__ __forceinline__ void short_dft(float2 (&v)[N], const float2 (&root)[R]) {
  static_assert(R >= N / 2, "the roots of the short DFT");
  float2 t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = v[bitrev(i, N)];
  dit_stages<N, 2, INV, R, FOLD>(t, root);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = t[i];
}

// The roots of the two short DFTs, from the factor vector into registers.
__device__ __forceinline__ void load_roots(const float2* __restrict__ fac, float2 (&ra)[kWA / 2],
                                           float2 (&rb)[kWB / 2]) {
#pragma unroll
  for (int k = 0; k < kWA / 2; ++k) ra[k] = __ldg(fac + k);
#pragma unroll
  for (int k = 0; k < kWB / 2; ++k) rb[k] = __ldg(fac + kWA + k);
}

// Index of (row, column) in a block's shared rows of 64 complex values. The
// column c = 8 a + b is stored at 8 (a ^ (row & 1)) + (b ^ a), a permutation
// of the row, so that each half-warp's 16 float2 fall in distinct banks when
// it reads or writes two neighbouring rows, the first even, at the 8 columns
// 8 a + b of one a (W step 1, the inverse's step 2 stores) or of one b (W
// step 2), or 16 neighbouring columns of one row (the H stages).
__device__ __forceinline__ int sw(int r, int c) {
  return r * kTW + (c ^ (c >> 3) ^ ((r & 1) << 3));
}

// Step 1 of the factored W DFT (INV: conjugated) on rows [0, nrows) of the
// block's shared rows, in place: for each (row, j2), the A-point DFT over j1
// of column j1 B + j2 and the twiddle tw[m1, j2], left at column m1 B + j2.
// B neighbouring threads take the B values of j2 of one row. No barrier.
template <bool INV, int NT = kThreads>
__device__ __forceinline__ void w_step1(float2* s_r, int nrows, const float2 (&ra)[kWA / 2],
                                        const float2* __restrict__ tw) {
  for (int i = threadIdx.x; i < nrows * kWB; i += NT) {
    const int row = i / kWB, j2 = i % kWB;
    float2 v[kWA];
#pragma unroll
    for (int j1 = 0; j1 < kWA; ++j1) v[j1] = s_r[sw(row, j1 * kWB + j2)];
    short_dft<kWA, INV>(v, ra);
#pragma unroll
    for (int m1 = 0; m1 < kWA; ++m1)
      s_r[sw(row, m1 * kWB + j2)] = m1 == 0 ? v[0] : cmulw<INV>(v[m1], __ldg(tw + m1 * kWB + j2));
  }
}

// Rows of an m-row product are computed in n passes of `rows` rows each
// (the last may be shorter), at most rows_max per pass.
struct Passes {
  int n, rows;
};

__device__ __forceinline__ Passes split_rows(int m, int rows_max) {
  const int n = (m + rows_max - 1) / rows_max;
  return {n, (m + n - 1) / n};
}

// Number of this thread's interleaved rows rg, rg + 4, ... below nrow.
__device__ __forceinline__ int own_rows(int nrow, int rg) {
  return nrow > rg ? (nrow - rg + kRowGroups - 1) / kRowGroups : 0;
}

// One (batch, W-block) item: its batch index, the first input column of its
// 64-column block, and the block columns [lo, hi) whose outputs it stores.
struct Item {
  int b, start, lo, hi;
};

// The first input column of W block wb.
__device__ __forceinline__ int block_start(int wb, int hop, int w) {
  return min(wb * hop, max(w - kTW, 0));
}

__device__ __forceinline__ Item item_geom(int item, int nwb, int hop, int w, int ow) {
  const int wb = item % nwb;
  Item g;
  g.b = item / nwb;
  g.start = block_start(wb, hop, w);
  g.lo = wb * hop - g.start;
  g.hi = min(hop, ow - g.start);
  return g;
}

// PK: x is B6's packed layout (items, h, Cin * pp, 128) in place of the
// signal (B, Cin, d, h, w); the arithmetic is the same.
template <int SB, bool PK>
__global__ void __launch_bounds__(kThreads, 2)
fused3d_hw_forward(const float* __restrict__ x,    // (B, Cin, d, h, w), or packed
                   const float2* __restrict__ fh,  // (nbh, h) one-sided H DFT rows
                   const float2* __restrict__ wfac,  // W factors (A + B + A * B), see kWA
                   float2* __restrict__ t,         // (items of this launch, Cin, d, nbh, 64)
                   int cin, int d, int h, int w, int ow, int nwb, int hop, int item0, int pp) {
  constexpr int RPT = Cfg<SB>::kRpt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* s_a = reinterpret_cast<float2*>(smem_raw);  // (SB * nbh, 64) rows, swizzled (sw)

  const int nbh = h / 2 + 1;
  const int tid = threadIdx.x, cl = tid % kTW, rg = tid / kTW;
  const int it = blockIdx.x / cin, c = blockIdx.x % cin;
  const int d0 = blockIdx.y * SB, ns = min(SB, d - d0);
  // slab s of the block at xs + soff(s) + hh * hs; d0 is even when SB > 1
  const float* xs;
  int64_t hs;
  bool col_in;
  if (PK) {
    xs = x + ((int64_t)(item0 + it) * h * cin + c) * pp * 2 * kTW + (d0 >> 1) * 2 * kTW +
         (d0 & 1) * kTW + cl;
    hs = (int64_t)cin * pp * 2 * kTW;
    col_in = true;  // B6 wrote the zeros past W
  } else {
    const Item g = item_geom(item0 + it, nwb, hop, w, ow);
    xs = x + (((int64_t)g.b * cin + c) * d + d0) * h * w + g.start + cl;
    hs = w;
    col_in = g.start + cl < w;
  }
  const Passes ps = split_rows(nbh, kRowGroups * RPT);

  // H forward, one-sided: A[s] = F_H (nbh x h) . X[s] (h x 64), X real
  for (int p = 0; p < ps.n; ++p) {
    const int row0 = p * ps.rows, nrow = min(ps.rows, nbh - row0);
    const int nq = own_rows(nrow, rg);
    float2 acc[RPT][SB];
#pragma unroll
    for (int q = 0; q < RPT; ++q)
#pragma unroll
      for (int s = 0; s < SB; ++s) acc[q][s] = make_float2(0.f, 0.f);
#pragma unroll 2
    for (int hh = 0; hh < h; ++hh) {
      float xv[SB];
#pragma unroll
      for (int s = 0; s < SB; ++s) {
        const int64_t soff = PK ? (s >> 1) * 2 * kTW + (s & 1) * kTW : (int64_t)s * h * w;
        xv[s] = (col_in && s < ns) ? __ldg(xs + soff + hh * hs) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        if (q < nq) {
          const float2 f = __ldg(fh + (int64_t)(row0 + rg + q * kRowGroups) * h + hh);
#pragma unroll
          for (int s = 0; s < SB; ++s) {
            acc[q][s].x = fmaf(f.x, xv[s], acc[q][s].x);
            acc[q][s].y = fmaf(f.y, xv[s], acc[q][s].y);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      if (q < nq) {
#pragma unroll
        for (int s = 0; s < SB; ++s)
          s_a[sw(s * nbh + row0 + rg + q * kRowGroups, cl)] = acc[q][s];
      }
    }
  }
  __syncthreads();

  // W forward, T[s] = A[s] . W64 on the slabs inside d, factored: step 1 in
  // place, then step 2, 8 threads a row (m1 = thread % 8), the B-point DFT
  // over j2 of column m1 B + j2, stored at the natural bins m1 + A m2 of the
  // scratch (each store a run of 8 bins, 64 B, per row)
  const int nrows = ns * nbh;
  float2 ra[kWA / 2], rb[kWB / 2];
  load_roots(wfac, ra, rb);
  w_step1<false>(s_a, nrows, ra, wfac + kWA + kWB);
  __syncthreads();
  float2* tout = t + ((int64_t)blockIdx.x * d + d0) * nbh * kTW;
  for (int i = tid; i < nrows * kWA; i += kThreads) {
    const int row = i / kWA, m1 = i % kWA;
    float2 u[kWB];
#pragma unroll
    for (int j2 = 0; j2 < kWB; ++j2) u[j2] = s_a[sw(row, m1 * kWB + j2)];
    short_dft<kWB, false>(u, rb);
#pragma unroll
    for (int m2 = 0; m2 < kWB; ++m2) tout[(int64_t)row * kTW + m1 + kWA * m2] = u[m2];
  }
}

// B6: one thread per float4 of xp (items, h, Cin * pp, 128), n4 of them.
__global__ void __launch_bounds__(kThreads)
fused3d_pack_x(const float* __restrict__ x,  // (B, Cin, d, h, w)
               float4* __restrict__ xp,      // (B * nwb, h, Cin * pp, 128)
               int cin, int d, int h, int w, int pp, int nwb, int hop, int64_t n4) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n4) return;
  const int q = (int)(i % (2 * kTW / 4));         // float4 of the row
  const int64_t row = i / (2 * kTW / 4);          // (item, h, c * pp + p)
  const int cp = (int)(row % (cin * pp));
  const int64_t ih = row / (cin * pp);
  const int hh = (int)(ih % h), item = (int)(ih / h);
  const int c = cp / pp, dd = 2 * (cp % pp) + q / (kTW / 4);
  const int col = block_start(item % nwb, hop, w) + 4 * (q % (kTW / 4));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (dd < d) {
    const float* src =
        x + ((((int64_t)(item / nwb) * cin + c) * d + dd) * h + hh) * w;
    if (col + 3 < w && (reinterpret_cast<uintptr_t>(src + col) & 15) == 0) {
      v = __ldg(reinterpret_cast<const float4*>(src + col));
    } else {
      if (col < w) v.x = __ldg(src + col);
      if (col + 1 < w) v.y = __ldg(src + col + 1);
      if (col + 2 < w) v.z = __ldg(src + col + 2);
      if (col + 3 < w) v.w = __ldg(src + col + 3);
    }
  }
  xp[i] = v;
}

template <int SB>
__global__ void __launch_bounds__(kThreads, 2)
fused3d_hw_inverse(const float2* __restrict__ z,   // (items of this launch, Cout, od, nbh, 64)
                   const float2* __restrict__ wfac,  // W factors (A + B + A * B), see kWA
                   const float2* __restrict__ ch,  // (oh, nbh) H irfft rows as (cr, ci) pairs
                   float* __restrict__ out,        // (B, Cout, od, oh, ow)
                   int cout, int h, int w, int od, int oh, int ow, int nwb, int hop, int item0) {
  constexpr int RPTR = Cfg<SB>::kRptR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* s_z = reinterpret_cast<float2*>(smem_raw);  // (SB * nbh, 64) rows of Z, then E (sw)

  const int nbh = h / 2 + 1, npos = nbh * kTW;
  const int tid = threadIdx.x, cl = tid % kTW, rg = tid / kTW;
  const int it = blockIdx.x / cout, o = blockIdx.x % cout;
  const Item g = item_geom(item0 + it, nwb, hop, w, ow);
  const int d0 = blockIdx.y * SB, ns = min(SB, od - d0);

  // the block's slabs are contiguous in Z; zeros past od
  const float2* zs = z + ((int64_t)blockIdx.x * od + d0) * npos;
  for (int i = tid; i < SB * npos; i += kThreads)
    s_z[sw(i / kTW, i % kTW)] = i < ns * npos ? __ldg(zs + i) : make_float2(0.f, 0.f);
  __syncthreads();

  // W inverse on the slabs inside od, in place, factored with the conjugated
  // factors: step 1, then step 2 in rounds of 256 / 8 rows, 8 threads a row
  // (m1 = thread % 8), each holding its B-point DFT across a barrier and
  // storing it, 1/64 applied, at the natural bins m1 + A m2
  const int nrows = ns * nbh;
  {
    float2 ra[kWA / 2], rb[kWB / 2];
    load_roots(wfac, ra, rb);
    w_step1<true>(s_z, nrows, ra, wfac + kWA + kWB);
    __syncthreads();
    const int m1 = tid % kWA;
    for (int r0 = 0; r0 < nrows; r0 += kThreads / kWA) {
      const int row = r0 + tid / kWA;
      float2 u[kWB];
      if (row < nrows) {
#pragma unroll
        for (int j2 = 0; j2 < kWB; ++j2) u[j2] = s_z[sw(row, m1 * kWB + j2)];
        short_dft<kWB, true>(u, rb);
      }
      __syncthreads();  // every read of the round's rows is done
      if (row < nrows) {
#pragma unroll
        for (int m2 = 0; m2 < kWB; ++m2)
          s_z[sw(row, m1 + kWA * m2)] = make_float2(u[m2].x * (1.f / kTW), u[m2].y * (1.f / kTW));
      }
    }
  }
  __syncthreads();

  // H irfft on the valid rows: out[v, w] = sum_n cr[v, n] Er[n, w] + ci[v, n] Ei[n, w]
  const bool col_out = cl >= g.lo && cl < g.hi;
  float* obase = out + (((int64_t)g.b * cout + o) * od + d0) * oh * ow;
  const Passes pr = split_rows(oh, kRowGroups * RPTR);
  for (int p = 0; p < pr.n; ++p) {
    const int row0 = p * pr.rows, nrow = min(pr.rows, oh - row0);
    const int nq = own_rows(nrow, rg);
    float acc[RPTR][SB];
#pragma unroll
    for (int q = 0; q < RPTR; ++q)
#pragma unroll
      for (int s = 0; s < SB; ++s) acc[q][s] = 0.f;
#pragma unroll 2
    for (int n = 0; n < nbh; ++n) {
      float2 ev[SB];
#pragma unroll
      for (int s = 0; s < SB; ++s) ev[s] = s_z[sw(s * nbh + n, cl)];
#pragma unroll
      for (int q = 0; q < RPTR; ++q) {
        if (q < nq) {
          const float2 c2 = __ldg(ch + (int64_t)(row0 + rg + q * kRowGroups) * nbh + n);
#pragma unroll
          for (int s = 0; s < SB; ++s)
            acc[q][s] = fmaf(c2.x, ev[s].x, fmaf(c2.y, ev[s].y, acc[q][s]));
        }
      }
    }
    if (col_out) {
#pragma unroll
      for (int q = 0; q < RPTR; ++q) {
        if (q < nq) {
          const int row = row0 + rg + q * kRowGroups;
#pragma unroll
          for (int s = 0; s < SB; ++s)
            if (s < ns) obase[((int64_t)s * oh + row) * ow + g.start + cl] = acc[q][s];
        }
      }
    }
  }
}

// ---- The factored H/W kernels, for every H from 16 to 256 ------------------

// The four-step split Hw = HA * HB of the H DFT at the working length Hw
// (fused3d.py: _h_work, fourstep.padded_split: both factors at most 16, HB
// even). The kernels are built once for each of the four powers of two below
// (their splits are constants, as in fourstep.split_factors) and once with H
// = 0, which takes any split the host hands it (ha, hb) and dispatches each H
// step to the DFT built for its radix. The host hands the factors in one
// vector laid out as the W factors are: the HA roots, the HB roots and the
// (HA, HB) twiddle tw[m1, j2] = exp(-2 pi i m1 j2 / Hw), row-major.
template <int H>
struct HSplit {
  static constexpr int A = 0, B = 0;  // the split comes as kernel arguments
};
template <>
struct HSplit<16> {
  static constexpr int A = 4, B = 4;
};
template <>
struct HSplit<32> {
  static constexpr int A = 8, B = 4;
};
template <>
struct HSplit<64> {
  static constexpr int A = 8, B = 8;
};
template <>
struct HSplit<128> {
  static constexpr int A = 16, B = 8;
};
constexpr int kMaxRadix = 16;

// Slabs a block of the factored kernels holds (an even count: one slab pair
// or two), its threads, and the blocks an SM holds at once, which caps a
// thread at 80 registers; see Schedule in the header. At the 64^3 rows
// kSBF = 4, 2 to 4 blocks an SM and 128-thread blocks all timed within 5%
// of this choice (PERF.md), so it is the simplest: one pair a block.
constexpr int kSBF = 2;
constexpr int kHwThreads = 256;
constexpr int kHwBlocks = 3;
// the same for the kernels that take their split as arguments (H = 0): at
// 3 blocks (80 registers) ptxas spills their runtime strides, at 2 it does
// not
constexpr int kHwBlocksAny = 2;
// rows of threads: a block's threads as kHwRows rows of 64 columns
constexpr int kHwRows = kHwThreads / kTW;
static_assert(kHwThreads % kTW == 0 && kSBF % 2 == 0, "whole rows of threads, slab pairs");

template <int N>
struct Int {};

// f(Int<n>{}): the radix N itself when it is known at compile time (N > 0),
// else the case of n among N0, N0 + STEP, ..., kMaxRadix (none for another n,
// which the host's checks rule out). f is a functor whose templated
// operator() is forced inline, so that every case is inlined into the kernel.
template <int N0, int STEP, class F>
__device__ __forceinline__ void radix_case(int n, const F& f) {
  if (n == N0) {
    f(Int<N0>{});
    return;
  }
  if constexpr (N0 + STEP <= kMaxRadix) radix_case<N0 + STEP, STEP>(n, f);
}

template <int N, int N0, int STEP, class F>
__device__ __forceinline__ void with_radix(int n, const F& f) {
  if constexpr (N > 0) {
    f(Int<N>{});
  } else {
    radix_case<N0, STEP>(n, f);
  }
}

// The roots an N-point short DFT reads, root[k] = exp(-2 pi i k / N) for k <
// N / 2, and k = N / 2 too for an odd N (roots_of).
__host__ __device__ constexpr int nroots(int n) { return n / 2 + (n & 1); }

// The N-point DFT of v (INV: conjugated, unscaled), N from 2 to 16, handed
// out one bin at a time as emit(m, X[m]) (m a constant once unrolled); v is
// clobbered. A power of two runs short_dft's radix-2 butterflies (FOLD). Another N
// runs the real-symmetric form: with s_j = v_j + v_(N-j) and d_j = v_j -
// v_(N-j) for 0 < j < N / 2,
//   X[m] = P_m - i Q_m and X[N - m] = P_m + i Q_m (INV: the signs swapped),
//   P_m = v_0 [+ (-1)^m v_(N/2), N even] + sum_j s_j cos(2 pi m j / N),
//   Q_m = sum_j d_j sin(2 pi m j / N),
// so that one pair of sums gives two bins. cos and sin are read from
// root[f], f = m j mod N folded to f <= N / 2; the products by 0 and +-1
// (m j mod N a multiple of N / 4) are left out at compile time.
template <int N, bool INV, class Emit>
__device__ __forceinline__ void dft_emit(float2 (&v)[N], const float2 (&root)[nroots(N)],
                                         const Emit& emit) {
  if constexpr ((N & (N - 1)) == 0) {
    short_dft<N, INV, nroots(N), true>(v, root);
#pragma unroll
    for (int m = 0; m < N; ++m) emit(m, v[m]);
  } else {
    constexpr int J = (N - 1) / 2;  // the pairs (j, N - j)
#pragma unroll
    for (int j = 1; j <= J; ++j) {
      const float2 a = v[j], b = v[N - j];
      v[j] = cadd(a, b);      // s_j
      v[N - j] = csub(a, b);  // d_j
    }
    float2 x0 = v[0];
    if (N % 2 == 0) x0 = cadd(x0, v[N / 2]);
#pragma unroll
    for (int j = 1; j <= J; ++j) x0 = cadd(x0, v[j]);
    emit(0, x0);
#pragma unroll
    for (int m = 1; m <= N / 2; ++m) {
      float2 p = v[0], q = make_float2(0.f, 0.f);
      if (N % 2 == 0) p = (m & 1) ? csub(p, v[N / 2]) : cadd(p, v[N / 2]);
#pragma unroll
      for (int j = 1; j <= J; ++j) {
        const int e = m * j % N, f = e <= N / 2 ? e : N - e;
        if (4 * e % N == 0) {  // cos and sin are 0 or +-1
          if (e == 0) p = cadd(p, v[j]);
          if (2 * e == N) p = csub(p, v[j]);
          if (4 * e == N) q = cadd(q, v[N - j]);
          if (4 * e == 3 * N) q = csub(q, v[N - j]);
        } else {
          // cos(2 pi e / N) = root[f].x, sin(2 pi e / N) = -+root[f].y
          const float cs = root[f].x, sn = e <= N / 2 ? -root[f].y : root[f].y;
          p.x = fmaf(cs, v[j].x, p.x);
          p.y = fmaf(cs, v[j].y, p.y);
          q.x = fmaf(sn, v[N - j].x, q.x);
          q.y = fmaf(sn, v[N - j].y, q.y);
        }
      }
      if (2 * m == N) {
        emit(m, p);  // Q = 0: every m j mod N is 0 or N / 2
      } else {
        const float2 lo = make_float2(p.x + q.y, p.y - q.x);  // P - i Q
        const float2 hi = make_float2(p.x - q.y, p.y + q.x);  // P + i Q
        emit(m, INV ? hi : lo);
        emit(N - m, INV ? lo : hi);
      }
    }
  }
}

// The nroots(N) roots of unity exp(-2 pi i k / N) an N-point short DFT
// reads, from the N roots at the head of a factor vector's part.
template <int N>
__device__ __forceinline__ void roots_of(const float2* __restrict__ fac,
                                         float2 (&root)[nroots(N)]) {
#pragma unroll
  for (int k = 0; k < nroots(N); ++k) root[k] = __ldg(fac + k);
}

// Asynchronous copies into shared memory (cp.async): 16 bytes; 8 or 4 bytes
// of which only `bytes` are read, the rest zero-filled (0: all zeros).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

// 16 bytes, of which only `bytes` are read (0: all zeros).
__device__ __forceinline__ void cp_async16z(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Index of (row, column) in a plane of 64-float rows of the factored forward.
// The 16-byte chunks of row r are permuted, chunk q stored at q ^ f(r) with
// f = 0, 3, 4, 7 for r % 4 = 0..3, so that the copies land as whole chunks
// and, with the lane orders below, every step is free of bank conflicts: a
// warp on 32 neighbouring columns of one row (the copies and the H steps), 8
// lanes on 8 neighbouring columns of each of 4 neighbouring rows (W step 1,
// where HB / 2 is a multiple of 4 or the rows run on, and the stores of W
// step 2), and 16-byte reads of chunks 2 m1 and 2 m1 + 1 by a quarter warp
// of m1 = 2q, 2q + 1 on 4 neighbouring rows (W step 2).
__device__ __forceinline__ int px(int r, int c) {
  const int f = ((r & 1) * 3) | ((r & 2) << 1);
  return r * kTW + ((((c >> 2) ^ f) << 2) | (c & 3));
}

// Step 0 of the factored forward kernels: the np live pairs' slabs from slab
// d0 of channel c of item `item` (ns of them inside d), h rows of 64 samples
// each, by 16-byte copies, all issued at once, into pair regions of two
// planes of H + 2 rows (px), slab 2p in the first plane of region p and
// 2p + 1 in the second; zeros past w, past d and in rows h to H - 1. Ends
// with a barrier.
template <bool PK>
__device__ __forceinline__ void copy_pairs(float* s_x, const float* __restrict__ x, int np,
                                           int ns, int H, int cin, int d, int h, int w, int ow,
                                           int nwb, int hop, int item, int c, int d0, int pp) {
  const int PR = H + 2, PAIR = 2 * PR * kTW, tid = threadIdx.x;
  // slab s of the block at xs + soff(s) + hh * hs
  const float* xs;
  int64_t hs;
  int start = 0;
  if (PK) {  // slab d of channel c in row c * pp + d / 2, lanes 64 (d % 2) + [0, 64)
    xs = x + ((int64_t)item * h * cin + c) * pp * 2 * kTW + (int64_t)(d0 >> 1) * 2 * kTW;
    hs = (int64_t)cin * pp * 2 * kTW;
  } else {
    const Item g = item_geom(item, nwb, hop, w, ow);
    xs = x + (((int64_t)g.b * cin + c) * d + d0) * h * w + g.start;
    hs = w;
    start = g.start;
  }
  const int q = tid % 16, col4 = start + 4 * q;
  for (int s = 0; s < 2 * np; ++s) {
    float* plane = s_x + (s >> 1) * PAIR + (s & 1) * PR * kTW;
    const int64_t soff = PK ? (s >> 1) * 2 * kTW + (s & 1) * kTW : (int64_t)s * h * w;
    for (int hh = tid / 16; hh < H; hh += kHwThreads / 16) {
      float* dst = plane + px(hh, 4 * q);
      const float* src = xs + soff + hh * hs + 4 * q;
      if (hh >= h) {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (PK || (s < ns && col4 + 3 < w && (reinterpret_cast<uintptr_t>(src) & 15) == 0)) {
        cp_async16(dst, src);  // B6 wrote the zeros past w and past d
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = s < ns && col4 + e < w;
          cp_async4(dst + e, in ? src + e : x, in ? 4 : 0);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

// One-sided H rows of the two slabs of a pair from the bins k and H - k of
// their packed DFT Z = X_a + i X_b: X_a[k] = (Z[k] + conj Z[-k]) / 2 into z,
// X_b[k] = (Z[k] - conj Z[-k]) / 2i into zm.
__device__ __forceinline__ void split_bins(float2& z, float2& zm) {
  const float2 a = z, b = zm;
  z = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
  zm = make_float2(0.5f * (a.y + b.y), 0.5f * (b.x - a.x));
}

// The H steps of the factored kernels, one functor a step: operator()(Int<N>)
// runs the step at radix N (with_radix), each short DFT handing its bins to a
// store (dft_emit). Planes and rows are as in the kernels below.

// Forward: a bin of step 1 (m1) times the twiddle tw[m1, j2], to row
// m1 HB + j2 of both planes.
struct FwdStore1 {
  float *re, *im;
  const float2* tw;
  int hb, j2, col;
  __device__ __forceinline__ void operator()(int m1, float2 y) const {
    if (m1 != 0) y = cmulw<false>(y, __ldg(tw + m1 * hb + j2));
    const int o = px(m1 * hb + j2, col);
    re[o] = y.x;
    im[o] = y.y;
  }
};

// Forward: a bin of step 2 (m2) to row row0 + m2 of both planes.
struct FwdStore2 {
  float *re, *im;
  int row0, col;
  __device__ __forceinline__ void operator()(int m2, float2 y) const {
    const int o = px(row0 + m2, col);
    re[o] = y.x;
    im[o] = y.y;
  }
};

// Forward step 1: for each (pair, j2, column), the A-point DFT over j1 of
// rows j1 HB + j2 and the twiddle, in place.
struct FwdStep1 {
  float* s_x;
  const float2* hfac;
  int ha, hb, pr, np, col, rg;
  template <int A>
  __device__ __forceinline__ void operator()(Int<A>) const {
    float2 ra[nroots(A)];
    roots_of<A>(hfac, ra);
    for (int p = 0; p < np; ++p) {
      float* re = s_x + p * 2 * pr * kTW;
      float* im = re + pr * kTW;
#pragma unroll 1
      for (int j2 = rg; j2 < hb; j2 += kHwRows) {
        float2 v[A];
#pragma unroll
        for (int j1 = 0; j1 < A; ++j1) {
          const int o = px(j1 * hb + j2, col);
          v[j1] = make_float2(re[o], im[o]);
        }
        dft_emit<A, false>(v, ra, FwdStore1{re, im, hfac + A + hb, hb, j2, col});
      }
    }
  }
};

// Forward step 2: for each (pair, m1, column), the B-point DFT over j2 of
// rows m1 B + j2, in place.
struct FwdStep2 {
  float* s_x;
  const float2* hfac;
  int ha, hb, pr, np, col, rg;
  template <int B>
  __device__ __forceinline__ void operator()(Int<B>) const {
    float2 rb[nroots(B)];
    roots_of<B>(hfac + ha, rb);
    for (int p = 0; p < np; ++p) {
      float* re = s_x + p * 2 * pr * kTW;
      float* im = re + pr * kTW;
#pragma unroll 1
      for (int m1 = rg; m1 < ha; m1 += kHwRows) {
        float2 u[B];
#pragma unroll
        for (int j2 = 0; j2 < B; ++j2) {
          const int o = px(m1 * B + j2, col);
          u[j2] = make_float2(re[o], im[o]);
        }
        dft_emit<B, false>(u, rb, FwdStore2{re, im, m1 * B, col});
      }
    }
  }
};

// Inverse: the row of V[j] of a pair (V[j] at row base + j for j <= H / 2,
// else at base + NBH + H - j, base = 2 p NBH).
__device__ __forceinline__ int vrow(int base, int h, int j) {
  return base + (j <= h / 2 ? j : h / 2 + 1 + h - j);
}

// Inverse: a bin of step 3 (m1) times the conjugate twiddle, to V[m1 HB + j2].
struct InvStore3 {
  float2* s_z;
  const float2* tw;
  int base, h, hb, j2, col;
  __device__ __forceinline__ void operator()(int m1, float2 y) const {
    if (m1 != 0) y = cmulw<true>(y, __ldg(tw + m1 * hb + j2));
    s_z[sw(vrow(base, h, m1 * hb + j2), col)] = y;
  }
};

// Inverse: a bin of step 4 (m2), output row m1 + HA m2 of slabs 2p (Re) and
// 2p + 1 (Im), 1/H applied, where it is below oh and the slab inside od.
struct InvStore4 {
  float* obase;
  int p, ha, m1, col, ns, oh, ow;
  float inv_h;
  __device__ __forceinline__ void operator()(int m2, float2 y) const {
    const int hh = m1 + ha * m2;
    if (hh < oh) {
      obase[((int64_t)2 * p * oh + hh) * ow + col] = y.x * inv_h;
      if (2 * p + 1 < ns) obase[((int64_t)(2 * p + 1) * oh + hh) * ow + col] = y.y * inv_h;
    }
  }
};

// Inverse step 3: for each (pair, j2, column), the conjugated A-point DFT
// over j1 of V[j1 HB + j2] and the conjugate twiddle, in place.
struct InvStep3 {
  float2* s_z;
  const float2* hfac;
  int ha, hb, np, col, rg;
  template <int A>
  __device__ __forceinline__ void operator()(Int<A>) const {
    const int h = A * hb;
    float2 ra[nroots(A)];
    roots_of<A>(hfac, ra);
    for (int p = 0; p < np; ++p) {
      const int base = 2 * p * (h / 2 + 1);
#pragma unroll 1
      for (int j2 = rg; j2 < hb; j2 += kHwRows) {
        float2 v[A];
#pragma unroll
        for (int j1 = 0; j1 < A; ++j1) v[j1] = s_z[sw(vrow(base, h, j1 * hb + j2), col)];
        dft_emit<A, true>(v, ra, InvStore3{s_z, hfac + A + hb, base, h, hb, j2, col});
      }
    }
  }
};

// Inverse step 4: for each (pair, m1 < oh, column), the conjugated B-point
// DFT over j2 of V[m1 B + j2] onto the output rows m1 + HA m2.
struct InvStep4 {
  float2* s_z;
  const float2* hfac;
  float* obase;
  int ha, hb, np, ns, col, rg, oh, ow;
  template <int B>
  __device__ __forceinline__ void operator()(Int<B>) const {
    const int h = ha * B;
    const float inv_h = 1.f / h;
    float2 rb[nroots(B)];
    roots_of<B>(hfac + ha, rb);
    for (int p = 0; p < np; ++p) {
      const int base = 2 * p * (h / 2 + 1);
#pragma unroll 1
      for (int m1 = rg; m1 < ha && m1 < oh; m1 += kHwRows) {
        float2 u[B];
#pragma unroll
        for (int j2 = 0; j2 < B; ++j2) u[j2] = s_z[sw(vrow(base, h, m1 * B + j2), col)];
        dft_emit<B, true>(u, rb, InvStore4{obase, p, ha, m1, col, ns, oh, ow, inv_h});
      }
    }
  }
};

// Factored hw_forward at the working length H = HA * HB (HT, or the
// arguments ha, hb when HT = 0), grid (items * Cin, d / SB), for a signal of
// h <= H rows (rows h to H - 1 are zeros). The SB slabs sit in SB / 2 pair
// regions of two planes (px) of H + 2 rows: slab 2p in the "re" plane, slab
// 2p + 1 in the "im" plane, so that a column of the two planes is the packed
// complex column x_2p + i x_2p+1. Steps, each in place and ended by a
// barrier: 0 the copies; 1 and 2 the H-point DFT of each packed column,
// four-step, leaving bin k = m1 + HA m2 at row m1 HB + m2; 3 W step 1 fused
// with the split of bins k and H - k into the two slabs' rows (X_2p[k] where
// Z[k] was, X_2p+1[k] where Z[H - k] was, the four real rows of k = 0 and
// H / 2 in rows 0, HB / 2, H and H + 1); 4 W step 2, each warp on 4 rows, the
// bins put back in natural order and each row stored to T as one 512-byte
// run.
template <int HT, int SB, bool PK>
__global__ void __launch_bounds__(kHwThreads, HT ? kHwBlocks : kHwBlocksAny)
fused3d_hw_forward_f(const float* __restrict__ x,       // (B, Cin, d, h, w), or packed
                     const float2* __restrict__ hfac,   // H factors (HA + HB + HA * HB)
                     const float2* __restrict__ wfac,   // W factors (A + B + A * B)
                     float2* __restrict__ t,            // (items of this launch, Cin, d, H/2+1, 64)
                     int cin, int d, int h, int w, int ow, int nwb, int hop, int item0, int pp,
                     int ha, int hb) {
  const int HA = HT ? HSplit<HT>::A : ha, HB = HT ? HSplit<HT>::B : hb;
  const int H = HA * HB, NBH = H / 2 + 1;
  const int PR = H + 2;               // rows of a plane: H bins, two spare rows
  const int PAIR = 2 * PR * kTW;      // floats of a pair region
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_x = reinterpret_cast<float*>(smem_raw);

  const int tid = threadIdx.x, col = tid % kTW, rg = tid / kTW;
  const int it = blockIdx.x / cin, c = blockIdx.x % cin;
  const int d0 = blockIdx.y * SB, ns = min(SB, d - d0), np = (ns + 1) / 2;

  // 0: the live pairs' slabs
  copy_pairs<PK>(s_x, x, np, ns, H, cin, d, h, w, ow, nwb, hop, item0 + it, c, d0, pp);

  // 1: for each (pair, j2, column), the HA-point DFT over j1 of rows
  // j1 HB + j2 and the twiddle, in place; 2: for each (pair, m1, column), the
  // HB-point DFT over j2 of rows m1 HB + j2; bin m1 + HA m2 stays at row
  // m1 HB + m2
  with_radix<HSplit<HT>::A, 2, 1>(HA, FwdStep1{s_x, hfac, HA, HB, PR, np, col, rg});
  __syncthreads();
  with_radix<HSplit<HT>::B, 2, 2>(HB, FwdStep2{s_x, hfac, HA, HB, PR, np, col, rg});
  __syncthreads();

  float2 wa[kWA / 2];
  roots_of<kWA>(wfac, wa);
  const float2* wtw = wfac + kWA + kWB;

  // 3: for each (pair, bin k < H / 2, j2), with k = m1 + HA m2 taken as
  // m1 = tk / (HB / 2), m2 = tk % (HB / 2) so that neighbouring tasks tk hold
  // neighbouring rows: the split of Z[k] and Z[H - k] (for k = 0, Z[0] and
  // Z[H / 2]) at columns j1 8 + j2, then W step 1 on the slabs' rows, written
  // back at columns m1 8 + j2
  const int jw = tid % kWB;
  for (int p = 0; p < np; ++p) {
    float* re = s_x + p * PAIR;
    float* im = re + PR * kTW;
    for (int tk = tid / kWB; tk < H / 2; tk += kHwThreads / kWB) {
      const int m1 = tk / (HB / 2), m2 = tk % (HB / 2);
      // the rows of bin k and of bin H - k (for k = 0, of bin H / 2)
      const int r = m1 * HB + m2;
      const int rp = m1 ? (HA - m1) * HB + HB - 1 - m2 : m2 ? HB - m2 : HB / 2;
      float2 a[kWA], b[kWA], tw[kWA];
#pragma unroll
      for (int j1 = 0; j1 < kWA; ++j1) {
        const int o = px(r, j1 * kWB + jw), op = px(rp, j1 * kWB + jw);
        a[j1] = make_float2(re[o], im[o]);
        b[j1] = make_float2(re[op], im[op]);
        tw[j1] = __ldg(wtw + j1 * kWB + jw);  // tw[m1, j2], used at m1 = j1
      }
      if (tk != 0) {
#pragma unroll
        for (int j1 = 0; j1 < kWA; ++j1) split_bins(a[j1], b[j1]);
        short_dft<kWA, false>(a, wa);
        short_dft<kWA, false>(b, wa);
#pragma unroll
        for (int m = 0; m < kWA; ++m) {
          const float2 ya = m == 0 ? a[0] : cmulw<false>(a[m], tw[m]);
          const float2 yb = m == 0 ? b[0] : cmulw<false>(b[m], tw[m]);
          const int o = px(r, m * kWB + jw), op = px(rp, m * kWB + jw);
          re[o] = ya.x;
          im[o] = ya.y;
          re[op] = yb.x;
          im[op] = yb.y;
        }
      } else {
        // Z[0] and Z[H / 2] pack two real rows each (X_2p + i X_2p+1): the
        // 8-point DFT of a packed row splits into those of its two real rows,
        // Hermitian in m; X_2p+1[0] goes to row H, X_2p+1[H / 2] to row H + 1
        short_dft<kWA, false>(a, wa);
        short_dft<kWA, false>(b, wa);
#pragma unroll
        for (int m = 0; m < kWA; ++m) {
          float2 p0 = a[m], q0 = a[(kWA - m) % kWA], p1 = b[m], q1 = b[(kWA - m) % kWA];
          split_bins(p0, q0);
          split_bins(p1, q1);
          if (m != 0) {
            p0 = cmulw<false>(p0, tw[m]);
            q0 = cmulw<false>(q0, tw[m]);
            p1 = cmulw<false>(p1, tw[m]);
            q1 = cmulw<false>(q1, tw[m]);
          }
          const int cc = m * kWB + jw;
          re[px(r, cc)] = p0.x;
          im[px(r, cc)] = p0.y;
          re[px(H, cc)] = q0.x;
          im[px(H, cc)] = q0.y;
          re[px(rp, cc)] = p1.x;
          im[px(rp, cc)] = p1.y;
          re[px(H + 1, cc)] = q1.x;
          im[px(H + 1, cc)] = q1.y;
        }
      }
    }
  }
  __syncthreads();

  // 4: W step 2, a warp on 4 rows: lane (m1, row) reads columns m1 8 + [0, 8)
  // as 16-byte chunks, runs the 8-point DFT over j2 and writes the bins
  // m1 + 8 m2 back in natural order; then each of the 4 rows goes to T as one
  // 512-byte run, lane L storing bins 2 L and 2 L + 1
  float2 wb[kWB / 2];
  roots_of<kWB>(wfac + kWA, wb);
  float2* tout = t + ((int64_t)blockIdx.x * d + d0) * NBH * kTW;
  const int lane = tid % 32, m1 = ((lane >> 3) << 1) | (lane & 1), rl = (lane >> 1) & 3;
  for (int p = 0; p < np; ++p) {
    float* re = s_x + p * PAIR;
    float* im = re + PR * kTW;
    for (int r0 = 4 * (tid / 32); r0 < PR; r0 += 4 * (kHwThreads / 32)) {
      const int r = r0 + rl;
      float2 u[kWB];
      if (r < PR) {
        const float4 a0 = *reinterpret_cast<const float4*>(re + px(r, m1 * kWB));
        const float4 a1 = *reinterpret_cast<const float4*>(re + px(r, m1 * kWB + 4));
        const float4 b0 = *reinterpret_cast<const float4*>(im + px(r, m1 * kWB));
        const float4 b1 = *reinterpret_cast<const float4*>(im + px(r, m1 * kWB + 4));
        u[0] = make_float2(a0.x, b0.x);
        u[1] = make_float2(a0.y, b0.y);
        u[2] = make_float2(a0.z, b0.z);
        u[3] = make_float2(a0.w, b0.w);
        u[4] = make_float2(a1.x, b1.x);
        u[5] = make_float2(a1.y, b1.y);
        u[6] = make_float2(a1.z, b1.z);
        u[7] = make_float2(a1.w, b1.w);
        short_dft<kWB, false>(u, wb);
      }
      __syncwarp();  // the warp's rows are its own: every read of them is done
      if (r < PR) {
#pragma unroll
        for (int m2 = 0; m2 < kWB; ++m2) {
          const int o = px(r, m1 + kWA * m2);
          re[o] = u[m2].x;
          im[o] = u[m2].y;
        }
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r2 = r0 + q;
        // the slab and one-sided bin of plane row r2 (see step 3)
        const int kz = r2 / HB + HA * (r2 % HB);
        const int s = 2 * p + (r2 >= H || kz > H / 2);
        const int kk = r2 == H ? 0 : r2 == H + 1 ? H / 2 : kz > H / 2 ? H - kz : kz;
        if (r2 < PR && s < ns) {
          const float2 vr = *reinterpret_cast<const float2*>(re + px(r2, 2 * lane));
          const float2 vi = *reinterpret_cast<const float2*>(im + px(r2, 2 * lane));
          *reinterpret_cast<float4*>(tout + ((int64_t)s * NBH + kk) * kTW + 2 * lane) =
              make_float4(vr.x, vi.x, vr.y, vi.y);
        }
      }
    }
  }
}

// Factored hw_inverse at the working length H = HA * HB (HT, or ha, hb when
// HT = 0), grid (items * Cout, od / SB). Steps, each ended by a barrier: 0
// the block's contiguous run of Z by 8-byte copies into the swizzled rows
// (sw); 1 W step 1, as in the dense kernel; 2 W step 2 on the rows k of both
// slabs of a pair at once (for k = 0 also their rows H / 2), 1/64 applied,
// then the pair's Hermitian-extended column V = E_2p + i E_2p+1 written in
// place: V[k] at row k of slab 2p, V[H - k] at row k of slab 2p + 1 (V[0] and
// V[H / 2] real in each part, as the dense irfft weights DC and Nyquist); 3
// and 4 the conjugated H-point DFT of each column of V, four-step, whose real
// and imaginary parts are the two slabs' output rows; rows below oh and the
// block's columns [lo, hi) are stored, 1/H applied.
template <int HT, int SB>
__global__ void __launch_bounds__(kHwThreads, HT ? kHwBlocks : kHwBlocksAny)
fused3d_hw_inverse_f(const float2* __restrict__ z,     // (items of launch, Cout, od, H/2+1, 64)
                     const float2* __restrict__ hfac,  // H factors (HA + HB + HA * HB)
                     const float2* __restrict__ wfac,  // W factors (A + B + A * B)
                     float* __restrict__ out,          // (B, Cout, od, oh, ow)
                     int cout, int w, int od, int oh, int ow, int nwb, int hop, int item0,
                     int ha, int hb) {
  const int HA = HT ? HSplit<HT>::A : ha, HB = HT ? HSplit<HT>::B : hb;
  const int H = HA * HB, NBH = H / 2 + 1, NPOS = NBH * kTW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* s_z = reinterpret_cast<float2*>(smem_raw);  // (SB * NBH, 64) rows (sw)

  const int tid = threadIdx.x, col = tid % kTW, rg = tid / kTW;
  const int d0 = blockIdx.y * SB, ns = min(SB, od - d0), np = (ns + 1) / 2;

  // 0: the live pairs' slabs, contiguous in Z; zeros past od
  const float2* zs = z + ((int64_t)blockIdx.x * od + d0) * NPOS;
  for (int i = tid; i < 2 * np * NPOS; i += kHwThreads) {
    const bool in = i < ns * NPOS;
    cp_async8(s_z + sw(i / kTW, i % kTW), in ? zs + i : zs, in ? 8 : 0);
  }
  cp_async_wait_all();
  __syncthreads();

  float2 wa[kWA / 2], wb[kWB / 2];
  load_roots(wfac, wa, wb);
  w_step1<true, kHwThreads>(s_z, ns * NBH, wa, wfac + kWA + kWB);
  __syncthreads();

  // 2: W step 2 on (pair, k < H / 2, m1), 8 lanes of one warp a task; each
  // task reads its rows, then writes them back in place
  {
    const int m1 = tid % kWA;
    for (int p = 0; p < np; ++p) {
      for (int k0 = 0; k0 < H / 2; k0 += kHwThreads / kWA) {
        const int k = k0 + tid / kWA;
        const bool live = k < H / 2;
        const int ra = 2 * p * NBH + k, rb = ra + NBH;
        // V[k] and V[H - k]; for k = 0, V[0] and V[H / 2]
        const int r2 = k == 0 ? ra + H / 2 : rb;
        float2 u[kWB], v[kWB];
        if (live) {
#pragma unroll
          for (int j2 = 0; j2 < kWB; ++j2) {
            u[j2] = s_z[sw(ra, m1 * kWB + j2)];
            v[j2] = s_z[sw(rb, m1 * kWB + j2)];
          }
          short_dft<kWB, true>(u, wb);
          short_dft<kWB, true>(v, wb);
          if (k != 0) {
#pragma unroll
            for (int m2 = 0; m2 < kWB; ++m2) {
              const float2 e = u[m2], f = v[m2];
              u[m2] = make_float2(e.x - f.y, e.y + f.x);  // E_2p + i E_2p+1
              v[m2] = make_float2(e.x + f.y, f.x - e.y);  // conj E_2p + i conj E_2p+1
            }
          } else {
            float2 e[kWB];
#pragma unroll
            for (int j2 = 0; j2 < kWB; ++j2) {
              u[j2] = make_float2(u[j2].x, v[j2].x);
              v[j2] = s_z[sw(ra + H / 2, m1 * kWB + j2)];
              e[j2] = s_z[sw(rb + H / 2, m1 * kWB + j2)];
            }
            short_dft<kWB, true>(v, wb);
            short_dft<kWB, true>(e, wb);
#pragma unroll
            for (int m2 = 0; m2 < kWB; ++m2) v[m2] = make_float2(v[m2].x, e[m2].x);
          }
        }
        __syncwarp();  // a task's 8 lanes have read its rows
        if (live) {
#pragma unroll
          for (int m2 = 0; m2 < kWB; ++m2) {
            const int cc = m1 + kWA * m2;
            s_z[sw(ra, cc)] = make_float2(u[m2].x * (1.f / kTW), u[m2].y * (1.f / kTW));
            s_z[sw(r2, cc)] = make_float2(v[m2].x * (1.f / kTW), v[m2].y * (1.f / kTW));
          }
        }
      }
    }
  }
  __syncthreads();

  // 3: for each (pair, j2, column), the conjugated HA-point DFT over j1 of
  // V[j1 HB + j2] and the conjugate twiddle, in place; 4: for each (pair,
  // m1, column), the conjugated HB-point DFT over j2 onto the rows
  // h = m1 + HA m2, Re to slab 2p and Im to slab 2p + 1, 1/H applied
  with_radix<HSplit<HT>::A, 2, 1>(HA, InvStep3{s_z, hfac, HA, HB, np, col, rg});
  __syncthreads();
  // the item's geometry only now, so that no register holds it through the
  // steps above
  const int it = blockIdx.x / cout, o = blockIdx.x % cout;
  const Item g = item_geom(item0 + it, nwb, hop, w, ow);
  if (col >= g.lo && col < g.hi)
    with_radix<HSplit<HT>::B, 2, 2>(
        HB, InvStep4{s_z, hfac, out + (((int64_t)g.b * cout + o) * od + d0) * oh * ow + g.start,
                     HA, HB, np, ns, col, rg, oh, ow});
}

// ---- The D stages: B3's DFT-16, MAC and inverse in one kernel; B4's tap MAC --

// The four-step split of the D DFT-16, 16 = kDF * kDF (fused3d.py: _D_SPLIT).
// The host hands its factors in one vector laid out as the W factors: the 4
// roots exp(-2 pi i k / 4) of step 1, the 4 of step 2 and the (4, 4) twiddle
// tw[m1, j2] = exp(-2 pi i m1 j2 / 16), row-major; the inverse conjugates all
// three.
constexpr int kDF = 4;
static_assert(kDF * kDF == kDB && kDF == 4, "the D block must split 4 * 4");
// fused3d_d_mac: the bins a warp holds (lane bin + kDBins l, l < kDF), the
// most warps a block (one (item, D-block) pair each at a time) and the most
// output channels a block (fused3d.py: _D_OPB)
constexpr int kDBins = 32 / kDF;
constexpr int kDWarps = 8;
constexpr int kDOpb = 8;
// fused3d_tap_mac: the bins a block, its most threads, the most output
// channels a block and the valid d a thread (fused3d.py: _TAP_DC)
constexpr int kTapBins = 16;
constexpr int kTapThreads = 256;
constexpr int kTapOpb = 4;
constexpr int kTapDC = 8;
static_assert(32 % kTapBins == 0 && kTapBins % 2 == 0, "whole warps, 16-byte copies");
// the kernel spectra one block of a D kernel stages in shared memory at once
constexpr int kStageBytes = 65536;

__device__ __forceinline__ float2 shfl_xor2(float2 v, int mask) {
  return make_float2(__shfl_xor_sync(0xffffffffu, v.x, mask),
                     __shfl_xor_sync(0xffffffffu, v.y, mask));
}

// B3's D stage, grid (npos / kDBins, cout / OPB), 32 * P threads. A block
// owns kDBins (h, w) bins and OPB output channels of one group; it stages
// their conjugated spectra (in chunks of cc channels) and walks every (item,
// D-block) pair of the launch, warp w taking pairs w, w + P, ... Lane bin +
// kDBins l owns the D-bins f = l + 4 f2 (f2 < 4) of its bin: per input
// channel it reads the block's 16 slabs (8 j + [0, 16), zeros past d; the 4
// lanes of a bin read the same addresses), takes step 1 of the factored
// DFT-16 at its one output m1 = l, the twiddle and step 2 in registers, and
// MACs its 4 D-bins into y[OPB][4]. After the group's channels, per output
// channel: step 1 of the conjugated DFT-16 over f2, its twiddle, and step 2
// over l across the bin's 4 lanes onto the 8 valid d only, as a
// reduce-scatter of two shuffle rounds, after which lane l holds d = 8 j + l
// and 8 j + l + 4. S never leaves registers.
template <int OPB>
__global__ void __launch_bounds__(32 * kDWarps, 2)
fused3d_d_mac(const float2* __restrict__ t,     // (items of this launch, Cin, d, nbh, 64)
              const float2* __restrict__ ks,    // (Cout, Cin/g, 16, nbh, 64), conjugated
              const float2* __restrict__ dfac,  // DFT-16 factors (4 + 4 + 16), see kDF
              float2* __restrict__ z,           // (items of this launch, Cout, od, nbh, 64)
              int cin, int cout, int groups, int d, int nbh, int nbd, int od, int nitem,
              int cc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* s_k = reinterpret_cast<float2*>(smem_raw);  // rows (channel, o, f) of kDBins
  const int64_t npos = (int64_t)nbh * kTW;
  const int lane = threadIdx.x % 32, bin = lane % kDBins, l = lane / kDBins;
  const int warp = threadIdx.x / 32, nwarp = blockDim.x / 32;
  const int64_t pos0 = (int64_t)blockIdx.x * kDBins, pos = pos0 + bin;
  const int cpg = cin / groups, o0 = blockIdx.y * OPB, c0 = o0 / (cout / groups) * cpg;
  const int nchunk = (cpg + cc - 1) / cc, npair = nitem * nbd;

  // channels [k cc, k cc + cc) of the group (fewer in the last chunk), every
  // copy issued at once, 16 bytes each
  auto stage = [&](int k) {
    const int rows = min(cc, cpg - k * cc) * OPB * kDB;
    for (int i = threadIdx.x; i < rows * (kDBins / 2); i += blockDim.x) {
      const int row = i / (kDBins / 2), q = i % (kDBins / 2);
      const int c = k * cc + row / (OPB * kDB), o = row / kDB % OPB, f = row % kDB;
      cp_async16(s_k + row * kDBins + 2 * q,
                 ks + (((int64_t)(o0 + o) * cpg + c) * kDB + f) * npos + pos0 + 2 * q);
    }
    cp_async_wait_all();
  };

  // step 1's root exp(-2 pi i l / 4) and its square (-1)^l, the forward's
  // twiddles tw[l, j2], step 2's roots
  const float2 rl = __ldg(dfac + l);
  const float sl = (l & 1) ? -1.f : 1.f;
  float2 twf[kDF], rb[kDF / 2];
#pragma unroll
  for (int j2 = 1; j2 < kDF; ++j2) twf[j2] = __ldg(dfac + 2 * kDF + l * kDF + j2);
  roots_of<kDF>(dfac + kDF, rb);

  if (nchunk == 1) {
    stage(0);
    __syncthreads();
  }
  for (int p0 = 0; p0 < npair; p0 += nwarp) {
    const int p = p0 + warp, it = p / nbd, j = p % nbd;
    const bool live = p < npair;  // uniform in the warp
    float2 y[OPB][kDF];
#pragma unroll
    for (int o = 0; o < OPB; ++o)
#pragma unroll
      for (int f2 = 0; f2 < kDF; ++f2) y[o][f2] = make_float2(0.f, 0.f);
    for (int k = 0; k < nchunk; ++k) {
      if (nchunk > 1) {
        __syncthreads();  // every read of the last chunk is done
        stage(k);
        __syncthreads();
      }
      if (!live) continue;
      const int ncl = min(cc, cpg - k * cc);
      for (int cl = 0; cl < ncl; ++cl) {
        const float2* tp = t + ((int64_t)it * cin + c0 + k * cc + cl) * d * npos + pos;
        // step 1 at m1 = l, a[j2] = sum_j1 x[4 j1 + j2] r^j1 with r^2 = (-1)^l,
        // and the twiddle tw[l, j2]
        float2 a[kDF];
#pragma unroll
        for (int j2 = 0; j2 < kDF; ++j2) {
          float2 x[kDF];
#pragma unroll
          for (int j1 = 0; j1 < kDF; ++j1) {
            const int s = j * kDHop + j1 * kDF + j2;
            x[j1] = s < d ? __ldg(tp + s * npos) : make_float2(0.f, 0.f);
          }
          a[j2] = make_float2(fmaf(sl, x[2].x, x[0].x), fmaf(sl, x[2].y, x[0].y));
          cmac(a[j2], make_float2(fmaf(sl, x[3].x, x[1].x), fmaf(sl, x[3].y, x[1].y)), rl);
          if (j2 != 0) a[j2] = cmulw<false>(a[j2], twf[j2]);
        }
        // step 2 over j2 onto f = l + 4 f2, then the MAC
        short_dft<kDF, false>(a, rb);
        const float2* kp = s_k + (cl * OPB * kDB + l) * kDBins + bin;
#pragma unroll
        for (int o = 0; o < OPB; ++o)
#pragma unroll
          for (int f2 = 0; f2 < kDF; ++f2)
            cmac(y[o][f2], a[f2], kp[(o * kDB + kDF * f2) * kDBins]);
      }
    }
    if (!live) continue;

    // inverse DFT-16 onto d = m1 + 4 m2, m2 < 2: step 1 over j1 = f2 onto m1,
    // the twiddle conj tw[m1, l], step 2 over j2 = l across the bin's lanes
    // (xor kDBins flips bit 0 of l, xor 2 kDBins bit 1); 1/16 at the store
    float2 ra[kDF / 2], twi[kDF];
    roots_of<kDF>(dfac, ra);
#pragma unroll
    for (int m1 = 1; m1 < kDF; ++m1) twi[m1] = __ldg(dfac + 2 * kDF + m1 * kDF + l);
    const float2 rot = __ldg(dfac + kDF + l);  // exp(-2 pi i l / 4), conjugated
    const bool b1 = l & 2, b0 = l & 1;
#pragma unroll
    for (int o = 0; o < OPB; ++o) {
      short_dft<kDF, true>(y[o], ra);
      float2 v[kDF][2];
#pragma unroll
      for (int m1 = 0; m1 < kDF; ++m1) {
        v[m1][0] = m1 == 0 ? y[o][0] : cmulw<true>(y[o][m1], twi[m1]);
        v[m1][1] = cmulw<true>(v[m1][0], rot);
      }
      // a lane keeps the m1 whose bit 1 is b1, then the m1 = l
      float2 w[2][2];
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int m2 = 0; m2 < 2; ++m2)
          w[k][m2] = cadd(b1 ? v[2 + k][m2] : v[k][m2],
                          shfl_xor2(b1 ? v[k][m2] : v[2 + k][m2], 2 * kDBins));
#pragma unroll
      for (int m2 = 0; m2 < 2; ++m2) {
        const float2 u = cadd(b0 ? w[1][m2] : w[0][m2], shfl_xor2(b0 ? w[0][m2] : w[1][m2], kDBins));
        const int dd = j * kDHop + l + kDF * m2;
        if (dd < od)
          z[(((int64_t)it * cout + o0 + o) * od + dd) * npos + pos] =
              make_float2(u.x * (1.f / kDB), u.y * (1.f / kDB));
      }
    }
  }
}

// B4's tap MAC, grid (npos / kTapBins, cout / OPB), kTapBins * P threads. A
// block owns kTapBins bins and OPB output channels of one group; it stages
// their conjugated per-tap spectra (entries e = c kd + u of the group, in
// chunks of ce) and walks every (item, chunk of kTapDC valid d) pair of the
// launch, pair lane threadIdx / kTapBins taking pairs lane, lane + P, ...
// Per channel a thread slides a window of the kTapDC slabs d0 + u + [0,
// kTapDC) over the taps u in registers, loading one slab a tap, a tap ahead,
// and reads its OPB spectra at that tap from shared memory: OPB * kTapDC
// complex MACs per T load. The sums stay in registers (OPB x kTapDC
// complex, whatever kd is).
template <int OPB>
__global__ void __launch_bounds__(kTapThreads, 2)
fused3d_tap_mac(const float2* __restrict__ t,   // (items of this launch, Cin, d, nbh, 64)
                const float2* __restrict__ ks,  // (Cout, Cin/g, kd, nbh, 64), conjugated
                float2* __restrict__ z,         // (items of this launch, Cout, od, nbh, 64)
                int cin, int cout, int groups, int d, int nbh, int kd, int od, int nitem,
                int ce) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* s_k = reinterpret_cast<float2*>(smem_raw);  // rows (entry, o) of kTapBins
  const int64_t npos = (int64_t)nbh * kTW;
  const int bin = threadIdx.x % kTapBins, lp = threadIdx.x / kTapBins;
  const int nlp = blockDim.x / kTapBins;
  const int64_t pos0 = (int64_t)blockIdx.x * kTapBins, pos = pos0 + bin;
  const int cpg = cin / groups, o0 = blockIdx.y * OPB, c0 = o0 / (cout / groups) * cpg;
  const int nent = cpg * kd, nchunk = (nent + ce - 1) / ce;
  const int ndc = (od + kTapDC - 1) / kTapDC, npair = nitem * ndc;

  auto stage = [&](int k) {
    const int rows = min(ce, nent - k * ce) * OPB;
    for (int i = threadIdx.x; i < rows * (kTapBins / 2); i += blockDim.x) {
      const int row = i / (kTapBins / 2), q = i % (kTapBins / 2);
      const int e = k * ce + row / OPB, o = row % OPB;
      cp_async16(s_k + row * kTapBins + 2 * q,
                 ks + ((int64_t)(o0 + o) * nent + e) * npos + pos0 + 2 * q);
    }
    cp_async_wait_all();
  };

  if (nchunk == 1) {
    stage(0);
    __syncthreads();
  }
  for (int p0 = 0; p0 < npair; p0 += nlp) {
    const int p = p0 + lp, it = p / ndc, d0 = p % ndc * kTapDC;
    const bool live = p < npair;
    // Y[o, d0 + q] = sum over the group's channels c and the taps u of
    // T[c, d0 + q + u] K[o, c, u]; slabs at or past d (read only for q with
    // d0 + q >= od, which is not stored) count as zeros
    float2 acc[OPB][kTapDC];
#pragma unroll
    for (int o = 0; o < OPB; ++o)
#pragma unroll
      for (int q = 0; q < kTapDC; ++q) acc[o][q] = make_float2(0.f, 0.f);
    for (int k = 0; k < nchunk; ++k) {
      if (nchunk > 1) {
        __syncthreads();  // every read of the last chunk is done
        stage(k);
        __syncthreads();
      }
      if (!live) continue;
      const int ehi = min(nent, (k + 1) * ce);
      for (int e = k * ce; e < ehi;) {
        // the taps [ulo, uhi) of channel c that this chunk holds
        const int c = e / kd, ulo = e % kd, uhi = min(kd, ulo + ehi - e);
        // slab d0 + ulo + q of channel c at tc + q * npos
        const float2* tc = t + (((int64_t)it * cin + c0 + c) * d + d0 + ulo) * npos + pos;
        const float2* kp = s_k + (e - k * ce) * OPB * kTapBins + bin;  // tap ulo
        float2 win[kTapDC];
#pragma unroll
        for (int q = 0; q < kTapDC; ++q)
          win[q] = d0 + ulo + q < d ? __ldg(tc + q * npos) : make_float2(0.f, 0.f);
        // taps before `loads` bring in their next slab (one inside d that a
        // later tap reads)
        const int loads = min(uhi - ulo - 1, d - d0 - ulo - kTapDC);
        tc += kTapDC * npos;
#pragma unroll 1
        for (int u = 0; u < uhi - ulo; ++u, tc += npos, kp += OPB * kTapBins) {
          // slab d0 + ulo + u + kTapDC enters the window after this tap
          const float2 next = u < loads ? __ldg(tc) : make_float2(0.f, 0.f);
          float2 kv[OPB];
#pragma unroll
          for (int o = 0; o < OPB; ++o) kv[o] = kp[o * kTapBins];
#pragma unroll
          for (int o = 0; o < OPB; ++o)
#pragma unroll
            for (int q = 0; q < kTapDC; ++q) cmac(acc[o][q], win[q], kv[o]);
#pragma unroll
          for (int q = 0; q + 1 < kTapDC; ++q) win[q] = win[q + 1];
          win[kTapDC - 1] = next;
        }
        e += uhi - ulo;
      }
    }
    if (!live) continue;
#pragma unroll
    for (int q = 0; q < kTapDC; ++q) {
      const int dd = d0 + q;
      if (dd < od) {
#pragma unroll
        for (int o = 0; o < OPB; ++o)
          z[(((int64_t)it * cout + o0 + o) * od + dd) * npos + pos] = acc[o][q];
      }
    }
  }
}

// ---- The tensor-core kernels: the precision modes "bf16x3" and "bf16" -------
//
// Under set_fused3d_precision("bf16x3") (MODE 3) and ("bf16") (MODE 1), the
// JAX package's modes of the same names (fft_conv_tpu/kernels/fused3d.py:104,
// whose _dot feeds every DFT product of both 3D Pallas bodies), B3 and B4 run
// these kernels in place of their FP32 H/W kernels and B3 in place of d_mac:
// every DFT step is a bf16 mma.sync product with an FP32 accumulator
// (bf16_mma.cuh: dft_step; "bf16x3" lo.hi + hi.lo + hi.hi of hi/lo splits,
// "bf16" hi.hi), on the same factors as the FP32 kernels where those factor,
// each radix r run as a step of size step_size(r) with the r-point matrix in
// its corner; the twiddles (rounded without FMA, as the plain version rounds
// them: cmulw_rn), the split of bins k and Hw - k, the Hermitian extension,
// the MACs (B4's tap_mac unchanged) and the scales stay FP32. The matrices
// come from the per-call table of fused3d.py:_tc_fragments_3d (tc_table).
//
// The H/W pair holds one slab pair a block in a plane of rows of 64 complex
// values (TcPlane: one 8-byte access a complex element), and is built for
// the splits (HA, HB) of the rows it serves, (8, 8) at 64^3, (8, 6) at 48^3,
// (13, 6) at the stuffed 78^3 and (7, 12) at the stuffed 84, with every
// index a constant, and once with the split as arguments for every other H
// from 1 to 256 (HA = HB = 0 in the template; one dense H step, HB = 1, for
// H < 16). Their columns are permuted per row so that each step's tensor-
// core loads and stores (4 vectors x 4 elements a half-warp) fall in
// distinct banks at every built split: a CPU model of the banks counts no
// conflict in any step (the runtime instance's H steps keep 4-way ones).
// Every step runs whole tiles (bf16_mma.cuh: FULL), so that no load sits in
// a branch, and a lane's W twiddles are two values held through the step
// (WTwiddles). Both are bounded for kHwTcBlocks = 2 blocks an SM (128
// registers):
//   * hw_forward_tc, grid (items * Cin, ceil(d / 2)): the two slabs read
//     into registers, 16 bytes a load, all of a thread's rows at once, and
//     written as the packed complex column x_2p + i x_2p+1 (load_pair); the
//     Hw-point DFT of each column as the HA-point step over j1 (vectors (j2,
//     column), then the twiddle) and the HB-point step over j2 (vectors (m1,
//     column)), leaving bin k = m1 + HA m2 at row m1 HB + m2 (tc_bin_row;
//     for H < 16 one H-point step); the first W step (8 points) on the
//     one-sided rows, a tile of vectors (slab, j2) a bin pair (k, Hw - k),
//     its loads forming the split of the two bins (split_of) so that no pass
//     of its own runs, its stores in place (the slabs' rows where Z[k] and
//     Z[Hw - k] were, rows Hw and Hw + 1 for the second slab's k = 0 and
//     Hw / 2); the second W step on two rows a tile, storing each vector's
//     bins m1 + 8 m2 to T. Four barriers;
//   * hw_inverse_tc, grid (items * Cout, ceil(od / 2)): the pair's rows of Z
//     by 16-byte cp.async into the rows of V's indices (E_2p[k] at row k,
//     E_2p+1[k] at row Hw - k, its k = 0 at row Hw and its Nyquist at the row
//     tc_nyquist_offset picks); the two conjugated W steps in place, 1/64
//     applied; the conjugated Hw-point DFT of V = E_2p + i E_2p+1, whose
//     Hermitian extension the first H step's loads form (hermitian_v, from
//     the rows of j and Hw - j; its tiles hold the columns of j2 and its
//     mirror HB - j2, so that its stores land in place), the second storing
//     Re and Im of the rows below OH to the two slabs, 1/Hw applied. Four
//     barriers;
//   * d_mac_tc (B3), grid (positions / 16, Cout / OPB), OPB <= 4, 8 warps,
//     bounded for 2 blocks an SM: the 264 blocks at 64^3 run as one wave.
//     A block stages its bins' spectra (16 bins x OPB output channels x 16
//     D-bins of each of the group's channels; in chunks of cc where the
//     group does not fit kStageBytes) and walks its (item, D-block) pairs in
//     rounds of one pair a warp; per round and input channel the slabs its
//     pairs read (16 bins each, one copy of the slabs two D-blocks share)
//     are staged by cp.async in one of two tiles, the next channel's copies
//     (and in the first round its spectra) issued as the products of this
//     one run, so that each block reads T once and the call twice (two
//     output-channel blocks). Per channel a warp's pair covers one m-tile of 16 bins: the
//     DFT-16 of its 16 slabs is one dense 16-point step (two k-steps, four
//     n-tiles), each n-tile's D-bins MACed into the lane's sums as it comes
//     out (lane (g, t) holds bins g, g + 8 at D-bins t + 4 nt); after the
//     group's channels, per output channel, the sums are already the A
//     fragments of the conjugated DFT-16, run onto the two n-tiles of the 8
//     valid d. The tiles' rows and the spectra are swizzled (bin ^ 4 (row &
//     3)) so that the A-fragment and spectrum loads are free of conflicts.
// Bound: the same bytes as the FP32 chains; the products at the bf16 rate
// (kernels/costs.py: fused3d_tc_work, fused3d_tap_tc_work).

// a * w, or a * conj(w) for the inverse, each product rounded on its own (no
// FMA), as torch rounds the plain version's twiddle, so that the operand the
// next step rounds to bf16 is the plain version's
template <bool INV>
__device__ __forceinline__ float2 cmulw_rn(float2 a, float2 w) {
  if (INV) w.y = -w.y;
  return make_float2(__fsub_rn(__fmul_rn(a.x, w.x), __fmul_rn(a.y, w.y)),
                     __fadd_rn(__fmul_rn(a.x, w.y), __fmul_rn(a.y, w.x)));
}

// The blocks of a call's fragment table (fused3d.py: _tc_fragments_3d): the
// HA-point DFT, the HB-point DFT (only for HB > 1), the W 8-point and the D
// 16-point DFT, each at its step size, forward then conjugated.
struct TcTable {
  const uint32_t *a, *b, *w, *d;
  int ra, rb;  // the step sizes of HA and HB
};

__host__ __device__ __forceinline__ TcTable tc_table(const uint32_t* frag, int ha, int hb) {
  TcTable t;
  t.ra = bf16_mma::step_size(ha);
  t.rb = hb > 1 ? bf16_mma::step_size(hb) : 0;
  t.a = frag;
  t.b = t.a + bf16_mma::table_words(t.ra);
  t.w = t.b + (hb > 1 ? bf16_mma::table_words(t.rb) : 0);
  t.d = t.w + bf16_mma::table_words(8);
  return t;
}

// The conjugated matrix of a block of step size r.
__device__ __forceinline__ const uint32_t* conj_block(const uint32_t* block, int r) {
  return block + bf16_mma::table_words(r) / 2;
}

// One r-point DFT step (r <= 16) of nvec vectors (a multiple of 16: whole
// tiles), at step size R8 (8 or 16; 0: r8 = step_size(r), taken at run
// time) with the r x r matrix in the corner of frag's: ld(m, j) is read for
// j < r only, st(m, k, v) called for k < r only.
template <int R8, bool X3, typename LD, typename ST>
__device__ __forceinline__ void tc_step(int r, int r8, int nvec, const uint32_t* frag, LD ld,
                                        ST st) {
  constexpr int NW = kHwThreads / 32;
  const auto ldr = [&](int m, int j) { return j < r ? ld(m, j) : make_float2(0.f, 0.f); };
  const auto str = [&](int m, int k, float2 v) {
    if (k < r) st(m, k, v);
  };
  if constexpr (R8 != 0)
    bf16_mma::dft_step<R8, X3, NW, true>(nvec, frag, ldr, str);
  else if (r8 == 8)
    bf16_mma::dft_step<8, X3, NW, true>(nvec, frag, ldr, str);
  else
    bf16_mma::dft_step<16, X3, NW, true>(nvec, frag, ldr, str);
}

// The blocks an SM the tensor-core H/W kernels are bounded for (128
// registers a thread).
constexpr int kHwTcBlocks = 2;

// The plane of the tensor-core H/W kernels at the split (HA, HB) (HB = 0:
// the split comes as arguments): rows of 64 complex values, column c of row
// r at c ^ ((c >> 2) & 4) ^ 4 rot(r), rot(r) = (r / HB + r % HB) mod 4.
// Bit 4 of the column moves to bit 2, so that a half-warp of the W steps (4
// vectors x 4 elements at columns 8 a + b, b < 4) spreads over 16 bank pairs;
// rot spreads the H steps' half-warps (4 columns x 4 rows r = j1 HB + j2, j1
// or j2 running) alike, as it steps by one with either of r's digits. The
// split taken at run time keeps rot = 0 (4-way conflicts in its H steps).
template <int HA, int HB>
struct TcPlane {
  float2* p;
  // row r = a HB + b given with the sum of its digits, a + b (the H steps
  // know them, so that their rot needs no division)
  __device__ __forceinline__ float2& at(int r, int digits, int c) const {
    const int rot = HB > 0 ? digits & 3 : 0;
    return p[r * kTW + (c ^ ((c >> 2) & 4) ^ (rot << 2))];
  }
  __device__ __forceinline__ float2& operator()(int r, int c) const {
    constexpr unsigned B = HB > 0 ? HB : 1;
    return at(r, HB > 0 ? (int)((unsigned)r / B + (unsigned)r % B) : 0, c);
  }
};

// The row offset past Hw of the second slab's Nyquist bin in the inverse's
// plane: where rot matches that of the row the first H step's mirrored
// loads would read beside it, so that they stay free of conflicts (1 for
// the split taken at run time).
template <int HA, int HB>
__host__ __device__ constexpr int tc_nyquist_offset() {
  if constexpr (HB == 0) {
    return 1;
  } else {
    constexpr int target = HA % 2 == 0 ? HA / 2 % 4 : ((HA - 1) / 2 + HB / 2) % 4;
    constexpr int i = ((target - HA) % 4 + 4) % 4;
    static_assert((i == 0 ? 4 : i) < HB, "the Nyquist row must keep the row digit");
    return i == 0 ? 4 : i;
  }
}

// The twiddles tw[m1, j2] of the first W step that this lane applies: its
// vectors all have j2 = g (lane = 4 g + t) and its outputs are m1 = t and
// 4 + t (bf16_mma::dft_tile's layout), so two values serve the whole step.
struct WTwiddles {
  float2 lo, hi;
  __device__ __forceinline__ explicit WTwiddles(const float2* __restrict__ tw) {
    const int lane = threadIdx.x & 31;
    lo = __ldg(tw + (lane & 3) * kWB + (lane >> 2));
    hi = __ldg(tw + (4 + (lane & 3)) * kWB + (lane >> 2));
  }
  __device__ __forceinline__ float2 of(int m1) const { return m1 < 4 ? lo : hi; }
};

// Rows of the plane at the working length hw (both kernels): through the
// Nyquist row, which is past rows hw and hw + 1.
template <int HA, int HB>
__host__ __device__ constexpr int tc_rows(int hw) {
  return hw + tc_nyquist_offset<HA, HB>() + 1;
}

// The row of bin k after the two H steps (k = m1 + HA m2 at m1 HB + m2).
__device__ __forceinline__ int tc_bin_row(unsigned k, unsigned ha, unsigned hb) {
  return (int)((k % ha) * hb + k / ha);
}

// Slab s's one-sided row of the pair's packed bins Z[k] = a and Z[Hw - k] =
// b (k = 0 and Hw / 2 with themselves): X_2p[k] = (a + conj b) / 2 for s =
// 0, X_2p+1[k] = (a - conj b) / 2i for s = 1, branch-free.
__device__ __forceinline__ float2 split_of(int s, float2 a, float2 b) {
  const float u = s ? a.y : a.x, w = s ? b.y : b.x, p = s ? b.x : a.y, q = s ? a.x : b.y;
  return make_float2(0.5f * (u + w), 0.5f * (p - q));
}

// V[j] = E_2p[j] + i E_2p+1[j], Hermitian-extended (V[Hw - k] = conj E_2p[k]
// + i conj E_2p+1[k]; DC and Nyquist real parts only), from u, the plane's
// row j, and w, the row of its partner (E_2p+1[j] for j <= Hw / 2, E_2p[Hw -
// j] above), branch-free.
__device__ __forceinline__ float2 hermitian_v(int j, float2 u, float2 w, int hw) {
  const bool hi = 2 * j > hw;
  const float sg = j == 0 || 2 * j == hw ? 0.f : hi ? -1.f : 1.f;
  const float2 ea = hi ? w : u, eb = hi ? u : w;
  return make_float2(ea.x - sg * eb.y, sg * ea.y + eb.x);
}

// 16 bytes of row hh of slab s from src (columns col4 .. col4 + 3 of the
// block, zeros past w), by one 16-byte load where it is aligned and inside
// w, else by four.
__device__ __forceinline__ float4 fetch4(const float* __restrict__ src, int col4, int w) {
  if (col4 + 3 < w && (reinterpret_cast<uintptr_t>(src) & 15) == 0)
    return __ldg(reinterpret_cast<const float4*>(src));
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = col4 + e < w ? __ldg(src + e) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The forward's first step: slabs d0 and d0 + 1 (ns of them inside d) of
// channel c of item `item`, rows h of 64 samples, as the packed complex
// column x_2p + i x_2p+1 in rows [0, H) of the plane (zeros past w, past d
// and in rows h to H - 1). A thread takes columns 4q .. 4q + 3 of rows
// threadIdx / 16 + 16 i, all of them (rounds of 4 for a split taken at run
// time) loaded before any is stored. No barrier.
template <bool PK, int H_, class Plane>
__device__ __forceinline__ void load_pair(const Plane& cell, const float* __restrict__ x, int ns,
                                          int H, int cin, int d, int h, int w, int ow, int nwb,
                                          int hop, int item, int c, int d0, int pp) {
  const float* xs;
  int64_t hs, ss;
  int start = 0;
  if (PK) {  // slab d of channel c in row c * pp + d / 2, lanes 64 (d % 2) + [0, 64)
    xs = x + ((int64_t)item * h * cin + c) * pp * 2 * kTW + (int64_t)(d0 >> 1) * 2 * kTW;
    hs = (int64_t)cin * pp * 2 * kTW;
    ss = kTW;
  } else {
    const Item g = item_geom(item, nwb, hop, w, ow);
    xs = x + (((int64_t)g.b * cin + c) * d + d0) * h * w + g.start;
    hs = w;
    ss = (int64_t)h * w;
    start = g.start;
  }
  constexpr int NI = H_ ? (H_ + 15) / 16 : 4;
  const int q = threadIdx.x % 16, col4 = start + 4 * q, odd = q & 1;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r0 = threadIdx.x / 16; r0 < H; r0 += 16 * NI) {
    float4 a[NI], b[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int hh = r0 + 16 * i;
      a[i] = b[i] = zero;
      if (hh < h) {
        const float* src = xs + hh * hs + 4 * q;
        if (PK) {  // B6 wrote the zeros past w and past d
          a[i] = __ldg(reinterpret_cast<const float4*>(src));
          b[i] = __ldg(reinterpret_cast<const float4*>(src + ss));
        } else {
          a[i] = fetch4(src, col4, w);
          if (ns > 1) b[i] = fetch4(src + ss, col4, w);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int hh = r0 + 16 * i;
      if (hh < H) {
        // columns 4q, 4q + 1 and 4q + 2, 4q + 3, odd lanes the second first
        // (a quarter-warp's 16-byte stores then fill 8 bank groups)
        const float4 lo = make_float4(a[i].x, b[i].x, a[i].y, b[i].y);
        const float4 hi = make_float4(a[i].z, b[i].z, a[i].w, b[i].w);
        *reinterpret_cast<float4*>(&cell(hh, 4 * q + 2 * odd)) = odd ? hi : lo;
        *reinterpret_cast<float4*>(&cell(hh, 4 * q + 2 - 2 * odd)) = odd ? lo : hi;
      }
    }
  }
}

// The one-sided row held by plane row r of the forward after its first W
// step: slab s (0 or 1) and bin k <= H / 2.
struct OneSided {
  int s, k;
};

__device__ __forceinline__ OneSided one_sided(unsigned r, unsigned ha, unsigned hb) {
  const int h = ha * hb;
  if ((int)r >= h) return {1, (int)r == h ? 0 : h / 2};
  const int kz = r / hb + ha * (r % hb);
  return 2 * kz > h ? OneSided{1, h - kz} : OneSided{0, kz};
}

template <int HA_, int HB_, bool X3, bool PK>
__global__ void __launch_bounds__(kHwThreads, kHwTcBlocks)
fused3d_hw_forward_tc(const float* __restrict__ x,         // (B, Cin, d, h, w), or packed
                      const uint32_t* __restrict__ frag,   // fused3d.py: _tc_fragments_3d
                      const float2* __restrict__ hfac,     // H factors (HB > 1), see HSplit
                      const float2* __restrict__ wfac,     // W factors, see kWA
                      float2* __restrict__ t,              // (items of this launch, Cin, d, H/2+1, 64)
                      int cin, int d, int h, int w, int ow, int nwb, int hop, int item0, int pp,
                      int ha, int hb) {
  constexpr int H_ = HA_ * HB_;
  constexpr int RA = H_ ? bf16_mma::step_size(HA_) : 0, RB = H_ ? bf16_mma::step_size(HB_) : 0;
  const int HA = H_ ? HA_ : ha, HB = H_ ? HB_ : hb, H = HA * HB, NBH = H / 2 + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TcPlane<HA_, HB_> cell{reinterpret_cast<float2*>(smem_raw)};
  const int it = blockIdx.x / cin, c = blockIdx.x % cin;
  const int d0 = blockIdx.y * 2, ns = min(2, d - d0);
  load_pair<PK, H_>(cell, x, ns, H, cin, d, h, w, ow, nwb, hop, item0 + it, c, d0, pp);
  __syncthreads();
  const TcTable tab = tc_table(frag, HA, HB);

  // the H steps: vector m = j2 * 64 + column, elements j1 at rows j1 HB + j2,
  // then the twiddle; vector m = m1 * 64 + column, elements j2 at rows
  // m1 HB + j2 (a tile: 16 columns of one j2, or of one m1)
  tc_step<RA, X3>(HA, tab.ra, HB * kTW, tab.a,
      [&](int m, int j1) { return cell.at(j1 * HB + (m >> 6), j1 + (m >> 6), m & 63); },
      [&](int m, int m1, float2 v) {
        const int j2 = m >> 6;
        if (m1 != 0 && HB > 1) v = cmulw_rn<false>(v, __ldg(hfac + HA + HB + m1 * HB + j2));
        cell.at(m1 * HB + j2, m1 + j2, m & 63) = v;
      });
  __syncthreads();
  if (HB > 1) {
    tc_step<RB, X3>(HB, tab.rb, HA * kTW, tab.b,
        [&](int m, int j2) { return cell.at((m >> 6) * HB + j2, (m >> 6) + j2, m & 63); },
        [&](int m, int m2, float2 v) { cell.at((m >> 6) * HB + m2, (m >> 6) + m2, m & 63) = v; });
    __syncthreads();
  }

  // W step 1, tile k (k <= H / 2) of vectors v = 8 s + j2: the split of bins
  // k and H - k at columns 8 j1 + j2 as it loads (split_of), the 8-point DFT
  // over j1 and the twiddle, in place: slab 0's row where Z[k] was, slab 1's
  // where Z[H - k] was (rows H and H + 1 for k = 0 and H / 2)
  const WTwiddles wt(wfac + kWA + kWB);
  const auto w1_rows = [&](int m, int& ra, int& rb, int& dst) {
    const int k = m >> 4, s = (m >> 3) & 1;
    ra = tc_bin_row(k, HA, HB);
    rb = tc_bin_row(k == 0 ? 0 : H - k, HA, HB);
    dst = s == 0 ? ra : k == 0 ? H : 2 * k == H ? H + 1 : rb;
  };
  bf16_mma::dft_step<8, X3, kHwThreads / 32, true>(NBH * 16, tab.w,
      [&](int m, int j1) {
        int ra, rb, dst;
        w1_rows(m, ra, rb, dst);
        const int col = j1 * kWB + (m & 7);
        return split_of((m >> 3) & 1, cell(ra, col), cell(rb, col));
      },
      [&](int m, int m1, float2 v) {
        int ra, rb, dst;
        w1_rows(m, ra, rb, dst);
        cell(dst, m1 * kWB + (m & 7)) = m1 == 0 ? v : cmulw_rn<false>(v, wt.of(m1));
      });
  __syncthreads();

  // W step 2, a tile two plane rows: vector m = 8 row + m1, elements j2 at
  // columns 8 m1 + j2; bins m1 + 8 m2 stored to T's row of the plane row's
  // one-sided row (the second slab's only when it is inside d)
  float2* tout = t + ((int64_t)blockIdx.x * d + d0) * NBH * kTW;
  bf16_mma::dft_step<8, X3, kHwThreads / 32, true>(2 * NBH * kWA, tab.w,
      [&](int m, int j2) { return cell(m >> 3, (m & 7) * kWB + j2); },
      [&](int m, int m2, float2 v) {
        const OneSided q = one_sided(m >> 3, HA, HB);
        if (q.s < ns) tout[((int64_t)q.s * NBH + q.k) * kTW + (m & 7) + kWA * m2] = v;
      });
}

template <int HA_, int HB_, bool X3>
__global__ void __launch_bounds__(kHwThreads, kHwTcBlocks)
fused3d_hw_inverse_tc(const float2* __restrict__ z,       // (items of launch, Cout, od, H/2+1, 64)
                      const uint32_t* __restrict__ frag,  // fused3d.py: _tc_fragments_3d
                      const float2* __restrict__ hfac,    // H factors (HB > 1)
                      const float2* __restrict__ wfac,    // W factors
                      float* __restrict__ out,            // (B, Cout, od, oh, ow)
                      int cout, int w, int od, int oh, int ow, int nwb, int hop, int item0,
                      int ha, int hb) {
  constexpr int H_ = HA_ * HB_;
  constexpr int RA = H_ ? bf16_mma::step_size(HA_) : 0, RB = H_ ? bf16_mma::step_size(HB_) : 0;
  const int HA = H_ ? HA_ : ha, HB = H_ ? HB_ : hb, H = HA * HB, NBH = H / 2 + 1;
  const int nyq = H + tc_nyquist_offset<HA_, HB_>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TcPlane<HA_, HB_> cell{reinterpret_cast<float2*>(smem_raw)};
  const int d0 = blockIdx.y * 2, ns = min(2, od - d0);
  // the plane row of V index l < 2 NBH: l itself, but the second slab's
  // Nyquist (l = H + 1) at nyq; and of the partner of V index j
  const auto vrow = [&](int l) { return l == H + 1 ? nyq : l; };
  const auto partner = [&](int j) { return j == 0 ? H : 2 * j == H ? nyq : H - j; };

  // the pair's rows of Z, 16-byte copies (zeros for a slab past od): slab
  // 0's row k at V index k, slab 1's at V index H - k (H for k = 0, H + 1
  // for k = H / 2)
  const float2* zs = z + ((int64_t)blockIdx.x * od + d0) * NBH * kTW;
  for (int i = threadIdx.x; i < 2 * NBH * 32; i += kHwThreads) {
    const int row = i >> 5, q = i & 31, s = row >= NBH, k = row - s * NBH;
    const int l = s == 0 ? k : k == 0 ? H : 2 * k == H ? H + 1 : H - k;
    const bool in = s < ns;
    cp_async16z(&cell(vrow(l), 2 * q), zs + (in ? (int64_t)row * kTW + 2 * q : 0), in ? 16 : 0);
  }
  cp_async_wait_all();
  __syncthreads();
  const TcTable tab = tc_table(frag, HA, HB);

  // the conjugated W steps on the V rows (slab 1's zeros past od): vector
  // m = 8 l + j2, then the conjugate twiddle; vector m = 8 l + m1, sample
  // m1 + 8 m2 written to its own column, 1/64 applied (a tile holds two
  // whole rows and loads them before it stores)
  const uint32_t* winv = conj_block(tab.w, 8);
  const WTwiddles wt(wfac + kWA + kWB);
  const int nrows = 2 * NBH;
  bf16_mma::dft_step<8, X3, kHwThreads / 32, true>(nrows * kWB, winv,
      [&](int m, int j1) { return cell(vrow(m >> 3), j1 * kWB + (m & 7)); },
      [&](int m, int m1, float2 v) {
        cell(vrow(m >> 3), m1 * kWB + (m & 7)) = m1 == 0 ? v : cmulw_rn<true>(v, wt.of(m1));
      });
  __syncthreads();
  bf16_mma::dft_step<8, X3, kHwThreads / 32, true>(nrows * kWA, winv,
      [&](int m, int j2) { return cell(vrow(m >> 3), (m & 7) * kWB + j2); },
      [&](int m, int m2, float2 v) {
        cell(vrow(m >> 3), (m & 7) + kWA * m2) = make_float2(v.x * (1.f / kTW), v.y * (1.f / kTW));
      });
  __syncthreads();

  // the conjugated H-point DFT of V's columns, V formed as the first step
  // loads it (hermitian_v); then the row h of each output, Re to the first
  // slab, Im to the second, 1/H applied, below oh and at the columns [lo,
  // hi)
  const int it = blockIdx.x / cout, o = blockIdx.x % cout;
  const Item g = item_geom(item0 + it, nwb, hop, w, ow);
  float* obase = out + (((int64_t)g.b * cout + o) * od + d0) * oh * ow + g.start;
  const float inv_h = 1.f / H;
  const auto store = [&](int hh, int col, float2 v) {
    if (hh < oh && col >= g.lo && col < g.hi) {
      obase[(int64_t)hh * ow + col] = v.x * inv_h;
      if (ns > 1) obase[((int64_t)oh + hh) * ow + col] = v.y * inv_h;
    }
  };
  // V[j] from the rows j = j1 HB + j2 and its partner, whose digits are
  // HA - 1 - j1 and HB - j2 (HA - j1 and 0 for j2 = 0: row H, and the
  // Nyquist row, which tc_nyquist_offset gives those digits' rot)
  const auto vload = [&](int j1, int j2, int col) {
    const int j = j1 * HB + j2, pd = j2 ? HA - 1 - j1 + HB - j2 : HA - j1;
    return hermitian_v(j, cell.at(j, j1 + j2, col), cell.at(partner(j), pd, col), H);
  };
  const uint32_t* ainv = conj_block(tab.a, tab.ra);
  if (HB == 1) {  // H < 16: one dense step, vector m = column
    tc_step<RA, X3>(HA, tab.ra, kTW, ainv, [&](int m, int j1) { return vload(j1, 0, m); },
                    [&](int m, int m1, float2 v) { store(m1, m, v); });
    return;
  }
  // step 1, a tile 8 columns of j2 and of its mirror HB - j2 (vectors v =
  // 8 u + column, j2 = q for u = 0, HB - q for u = 1, HB / 2 beside 0):
  // the rows it loads, j and H - j for j = j2 mod HB, are those it writes,
  // so it writes in place; the conjugate twiddle
  const auto h1_vec = [&](int m, int& j2, int& col) {
    const int q = m >> 7;
    col = ((m >> 4) & 7) * 8 + (m & 7);
    j2 = (m & 8) == 0 ? q : q == 0 ? HB / 2 : HB - q;
  };
  tc_step<RA, X3>(HA, tab.ra, HB * kTW, ainv,
      [&](int m, int j1) {
        int j2, col;
        h1_vec(m, j2, col);
        return vload(j1, j2, col);
      },
      [&](int m, int m1, float2 v) {
        int j2, col;
        h1_vec(m, j2, col);
        cell.at(m1 * HB + j2, m1 + j2, col) =
            m1 == 0 ? v : cmulw_rn<true>(v, __ldg(hfac + HA + HB + m1 * HB + j2));
      });
  __syncthreads();
  // step 2: vector m = m1 * 64 + column (m1 < oh), elements j2 at rows
  // m1 HB + j2, onto the rows h = m1 + HA m2
  tc_step<RB, X3>(HB, tab.rb, min(HA, oh) * kTW, conj_block(tab.b, tab.rb),
      [&](int m, int j2) { return cell.at((m >> 6) * HB + j2, (m >> 6) + j2, m & 63); },
      [&](int m, int m2, float2 v) { store((m >> 6) + HA * m2, m & 63, v); });
}

// B3's tensor-core D stage: the bins a block (one m-tile of vectors) and its
// most output channels (fused3d.py: _D_OPB_TC), which keep a lane's sums,
// OPB x 8 complex, within its registers
constexpr int kDBinsTc = 16;
constexpr int kDOpbTc = 4;

// acc (zeros in) += the 16-point DFT step's products for n-tile nt of the A
// fragments ah (and al under X3) with the matrix frag (hi then lo halves)
template <bool X3>
__device__ __forceinline__ void d16_product(float (&acc)[4], const uint32_t (&ah)[2][4],
                                            const uint32_t (&al)[2][4],
                                            const uint32_t* __restrict__ frag, int nt, int lane) {
  float acl[4] = {};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint2 bh = bf16_mma::b_frag<kDB>(frag, s, nt, lane);
    if (X3) {
      bf16_mma::mma(acl, al[s], bh);
      bf16_mma::mma(acl, ah[s], bf16_mma::b_frag<kDB>(frag + 2 * kDB * kDB, s, nt, lane));
    }
    bf16_mma::mma(acc, ah[s], bh);
  }
  if (X3) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += acl[e];
  }
}

// The column of bin b (< 16) in row r of d_mac_tc's tiles: b ^ 4 (r & 3),
// which puts the 4 rows a quarter of a half-warp reads in distinct banks.
__device__ __forceinline__ int d_col(int r, int b) { return b ^ ((r & 3) << 2); }

template <int OPB, bool X3>
__global__ void __launch_bounds__(32 * kDWarps, 2)
fused3d_d_mac_tc(const float2* __restrict__ t,        // (items of this launch, Cin, d, nbh, 64)
                 const float2* __restrict__ ks,       // (Cout, Cin/g, 16, nbh, 64), conjugated
                 const uint32_t* __restrict__ dfrag,  // the D 16-point block of the table
                 float2* __restrict__ z,              // (items of this launch, Cout, od, nbh, 64)
                 int cin, int cout, int groups, int d, int nbh, int nbd, int od, int nitem,
                 int cc, int trows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* s_k = reinterpret_cast<float2*>(smem_raw);  // rows (channel, o, f) of kDBinsTc
  float2* s_t = s_k + cc * OPB * kDB * kDBinsTc;      // two tiles of trows rows of kDBinsTc
  const int npos = nbh * kTW, pos0 = blockIdx.x * kDBinsTc;  // 32-bit: fewer registers
  const int lane = threadIdx.x % 32, g = lane >> 2, tq = lane & 3;
  const int warp = threadIdx.x / 32, nwarp = blockDim.x / 32;
  const int cpg = cin / groups, o0 = blockIdx.y * OPB, c0 = o0 / (cout / groups) * cpg;
  const int nchunk = (cpg + cc - 1) / cc, npair = nitem * nbd;
  const uint32_t* ih = conj_block(dfrag, kDB);  // the conjugated matrix
  // this lane's columns of bins g and g + 8 in a row r with r % 4 = tq, which
  // is every row it reads (d_col)
  const int ca = g ^ (tq << 2), cb = ca ^ 8;

  // the spectra of channel c of the group, rows (c % cc, o, f), 16-byte
  // copies; those of channels [k cc, k cc + cc) (fewer in the last chunk).
  // When the group fits one chunk they stay for every round, and the first
  // round stages them a channel ahead beside T
  const bool once = nchunk == 1;
  const auto stage_kc = [&](int c) {
    for (int i = threadIdx.x; i < OPB * kDB * (kDBinsTc / 2); i += blockDim.x) {
      const int r = i / (kDBinsTc / 2), q = i % (kDBinsTc / 2), row = c % cc * OPB * kDB + r;
      const int64_t src = (((int64_t)(o0 + r / kDB) * cpg + c) * kDB + r % kDB) * npos;
      cp_async16(s_k + row * kDBinsTc + d_col(row, 2 * q), ks + src + (pos0 + 2 * q));
    }
  };
  const auto stage_k = [&](int k) {
    for (int c = k * cc; c < min(cpg, k * cc + cc); ++c) stage_kc(c);
  };

  for (int p0 = 0; p0 < npair; p0 += nwarp) {
    const int p = p0 + warp, it = p / nbd, j = p % nbd;
    const bool live = p < npair;  // uniform in the warp
    // the round's tile: the slabs 8 j + [0, 16) of each of its pairs, from
    // row 8 (p - p0) + 8 (items before p's in the round), so that two
    // D-blocks of an item share their 8 slabs; a warp copies its first 8
    // rows, and its last 8 too where no pair of the round follows in its
    // item
    const int base = 8 * (p - p0) + 8 * (it - p0 / nbd);
    const int nrow = !live ? 0 : p == min(p0 + nwarp, npair) - 1 || j == nbd - 1 ? 16 : 8;
    const auto stage_t = [&](int cl, int b) {
      const float2* src = t + ((int64_t)it * cin + c0 + cl) * d * npos + pos0;
      float2* dst = s_t + (b * trows + base) * kDBinsTc;
      for (int i = lane; i < nrow * (kDBinsTc / 2); i += 32) {
        const int r = i / (kDBinsTc / 2), q = i % (kDBinsTc / 2), sl = j * kDHop + r;
        cp_async16z(dst + r * kDBinsTc + d_col(r, 2 * q),
                    src + ((int64_t)min(sl, d - 1) * npos + 2 * q), sl < d ? 16 : 0);
      }
    };
    if (p0 > 0) __syncthreads();  // every read of the last round's tiles is done
    stage_t(0, 0);
    if (once && p0 == 0) stage_kc(0);
    // y[o][nt][u]: output channel o, D-bin 4 nt + tq of bin g + 8 u
    float2 y[OPB][4][2];
#pragma unroll
    for (int o = 0; o < OPB; ++o)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) y[o][nt][0] = y[o][nt][1] = make_float2(0.f, 0.f);
    for (int cl = 0; cl < cpg; ++cl) {
      if (!once && cl % cc == 0) {
        __syncthreads();  // every read of the last chunk is done
        stage_k(cl / cc);
      }
      cp_async_wait_all();
      __syncthreads();  // channel cl's tile (and spectra) have landed; tile (cl + 1) % 2 is read
      if (cl + 1 < cpg) {
        stage_t(cl + 1, (cl + 1) & 1);
        if (once && p0 == 0) stage_kc(cl + 1);
      }
      if (!live) continue;
      // the A fragments: bins g and g + 8, slabs 8 j + e at elements e = 8 s
      // + tq and e + 4 (zeros past d)
      const float2* tb = s_t + ((cl & 1) * trows + base) * kDBinsTc;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float2 v = tb[(8 * s + tq + 4 * e) * kDBinsTc + (u ? cb : ca)];
            bf16_mma::split<X3>(v, &ah[s][2 * e + u], &al[s][2 * e + u]);
          }
        }
      }
      // the DFT-16 an n-tile at a time, each tile's D-bins MACed at once
      const float2* kp = s_k + (cl % cc) * OPB * kDB * kDBinsTc;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float acc[4] = {};
        d16_product<X3>(acc, ah, al, dfrag, nt, lane);
#pragma unroll
        for (int o = 0; o < OPB; ++o) {
          const float2* kr = kp + (o * kDB + 4 * nt + tq) * kDBinsTc;
          cmac(y[o][nt][0], make_float2(acc[0], acc[1]), kr[ca]);
          cmac(y[o][nt][1], make_float2(acc[2], acc[3]), kr[cb]);
        }
      }
    }
    if (!live) continue;

    // per output channel, the conjugated DFT-16 onto d = 4 nt + tq, nt < 2:
    // the sums are its A fragments (element f = 8 s + tq is y[.][2 s], f + 4
    // is y[.][2 s + 1]); 1/16 at the store
#pragma unroll
    for (int o = 0; o < OPB; ++o) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            bf16_mma::split<X3>(y[o][2 * s + e][u], &ah[s][2 * e + u], &al[s][2 * e + u]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float acc[4] = {};
        d16_product<X3>(acc, ah, al, ih, nt, lane);
        const int dd = j * kDHop + 4 * nt + tq;
        if (dd < od) {
          float2* zp = z + (((int64_t)it * cout + o0 + o) * od + dd) * npos + (pos0 + g);
          zp[0] = make_float2(acc[0] * (1.f / kDB), acc[1] * (1.f / kDB));
          zp[8] = make_float2(acc[2] * (1.f / kDB), acc[3] * (1.f / kDB));
        }
      }
    }
  }
}

// ---- B7: B3's kernel spectra from the raw taps --------------------------------

// B7 replaces the inline body of the TPU kernel
// (fft_conv_tpu/kernels/fused3d.py:792-812: grid cell 0 of _make_kernel_v4
// under set_fused3d_inline computes the spectra into scratch that persists
// across the cells). A Hopper grid has no first cell that the others wait
// for, so B7 is a launch of its own at the head of B3's chain, writing the
// conjugated spectra
//   ks[o, c, f, n, z] = conj(sum_{t, u, v} k[o, c, t, u, v]
//                            e^{-2 pi i (f t / 16 + n u / hw + z v / 64)})
// at the 16 D-bins, the hw/2+1 one-sided H bins and the 64 W bins in the
// layout fused3d_d_mac reads (the entry point fused3d_spectra_v4). It is
// bound by the bytes it writes (17.3 MB at the 64^3 benchmark row, against
// 0.2 GFLOP), so its stores are whole rows of 64 W bins, 256 contiguous
// bytes a warp, and it spends few instructions a value. It computes
// separably: grid (Cout * Cin/g, ceil(nbh / kSpecNB)); a block stages its
// pair's taps and two root tables in shared memory (see below); thread (z,
// r) owns W bin z, and row group r the D taps t = r, r + 4, ...: for each,
// the W DFT-64 of the KH rows of taps at z, each summed into the block's
// kSpecNB H bins in registers (the H DFT), then stored to shared memory;
// after a barrier, thread (z, r) takes the DFT-16 over the KD taps (zeros
// past KD) of the block's H bins r, r + 4, ... at z, factored 4 * 4 in
// registers as B3's D stage factors it (kDF, dfac), conjugated and stored.
// The roots exp(-2 pi i m / N) of the W and H transforms come from the
// host's float64 tables (fused3d.py: _spectra_roots), taken at (bin * tap)
// mod N into the tables; the DFT-16 factors are B3's (fused3d.py:
// _factor_vector of _D_SPLIT). The W and H steps do most of its
// instructions, so they read only shared memory, each read a broadcast or
// 32 neighbouring values: the taps (a warp reads one), w_tab[v] (a warp
// reads 32 z) and h_tab[u] (one).
constexpr int kSpecNB = 8;
constexpr int kSpecThreads = 256;
constexpr int kSpecRows = kSpecThreads / kTW;
static_assert(kSpecNB % kSpecRows == 0, "whole H bins a row group");

__global__ void __launch_bounds__(kSpecThreads)
fused3d_spectra_taps(const float* __restrict__ k,       // (pairs, kd, kh, kw) taps
                     const float2* __restrict__ roots,  // 64 W roots, hw H roots
                     const float2* __restrict__ dfac,   // DFT-16 factors (4 + 4 + 16)
                     float2* __restrict__ ks,           // (pairs, 16, hw/2+1, 64)
                     int kd, int kh, int kw, int hw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // shared memory: the W roots as a (kw, 64) table, w_tab[v][z] = exp(-2 pi
  // i z v / 64), so that a warp reads 32 neighbouring values; the H roots of
  // the block's bins as a (kh, kSpecNB) table, h_tab[u][j] = exp(-2 pi i (n0
  // + j) u / hw); the partial spectra; the pair's taps
  float2* w_tab = reinterpret_cast<float2*>(smem_raw);
  float2* h_tab = w_tab + kw * kTW;
  float2* part = h_tab + kh * kSpecNB;  // (kd, kSpecNB, 64): the W and H DFTs done
  float* s_taps = reinterpret_cast<float*>(part + kd * kSpecNB * kTW);
  const int nbh = hw / 2 + 1, n0 = blockIdx.y * kSpecNB, ntaps = kd * kh * kw;
  const int z = threadIdx.x % kTW, r = threadIdx.x / kTW;
  const float* taps = k + (int64_t)blockIdx.x * ntaps;
  for (int i = threadIdx.x; i < ntaps; i += kSpecThreads) s_taps[i] = __ldg(taps + i);
  for (int i = threadIdx.x; i < kw * kTW; i += kSpecThreads)
    w_tab[i] = __ldg(roots + (((i / kTW) * (i % kTW)) & (kTW - 1)));
  for (int i = threadIdx.x; i < kh * kSpecNB; i += kSpecThreads)
    h_tab[i] = __ldg(roots + kTW + (i / kSpecNB) * (n0 + i % kSpecNB) % hw);
  __syncthreads();

  for (int t = r; t < kd; t += kSpecRows) {
    float2 acc[kSpecNB];
#pragma unroll
    for (int j = 0; j < kSpecNB; ++j) acc[j] = make_float2(0.f, 0.f);
    for (int u = 0; u < kh; ++u) {
      const float* row = s_taps + (t * kh + u) * kw;
      float2 a = make_float2(0.f, 0.f);  // the W DFT-64 of row u at bin z
#pragma unroll 4
      for (int v = 0; v < kw; ++v) {
        const float x = row[v];
        const float2 e = w_tab[v * kTW + z];
        a.x = fmaf(x, e.x, a.x);
        a.y = fmaf(x, e.y, a.y);
      }
#pragma unroll
      for (int j = 0; j < kSpecNB; ++j) cmac(acc[j], a, h_tab[u * kSpecNB + j]);
    }
#pragma unroll
    for (int j = 0; j < kSpecNB; ++j) part[(t * kSpecNB + j) * kTW + z] = acc[j];
  }

  // the DFT-16 factors: step 1's and step 2's roots (the twiddles tw[m1, j2]
  // are read where they are used)
  float2 ra[kDF / 2], rb[kDF / 2];
  roots_of<kDF>(dfac, ra);
  roots_of<kDF>(dfac + kDF, rb);
  __syncthreads();

#pragma unroll 1
  for (int jj = 0; jj < kSpecNB / kSpecRows; ++jj) {
    const int j = r + kSpecRows * jj, n = n0 + j;
    if (n >= nbh) break;
    // step 1: per j2, the 4-point DFT over j1 of x[4 j1 + j2] and the twiddle
    float2 c[kDF][kDF];
#pragma unroll
    for (int j2 = 0; j2 < kDF; ++j2) {
      float2 v[kDF];
#pragma unroll
      for (int j1 = 0; j1 < kDF; ++j1) {
        const int s = kDF * j1 + j2;
        v[j1] = s < kd ? part[(s * kSpecNB + j) * kTW + z] : make_float2(0.f, 0.f);
      }
      short_dft<kDF, false>(v, ra);
#pragma unroll
      for (int m1 = 0; m1 < kDF; ++m1)
        c[m1][j2] = (m1 && j2) ? cmulw<false>(v[m1], __ldg(dfac + 2 * kDF + m1 * kDF + j2)) : v[m1];
    }
    // step 2: per m1, the 4-point DFT over j2 onto f = m1 + 4 m2; conjugated
    float2* out = ks + ((int64_t)blockIdx.x * kDB * nbh + n) * kTW + z;
#pragma unroll
    for (int m1 = 0; m1 < kDF; ++m1) {
      short_dft<kDF, false>(c[m1], rb);
#pragma unroll
      for (int m2 = 0; m2 < kDF; ++m2)
        out[(int64_t)(m1 + kDF * m2) * nbh * kTW] = make_float2(c[m1][m2].x, -c[m1][m2].y);
    }
  }
}

size_t spectra_smem(int kd, int kh, int kw) {
  return (size_t)(kw * kTW + kh * kSpecNB + kd * kSpecNB * kTW) * sizeof(float2) +
         (size_t)kd * kh * kw * sizeof(float);
}

int slabs_per_block(int nbh) {
  if (Cfg<4>::smem(nbh) <= (size_t)kMaxSmem) return 4;
  if (Cfg<2>::smem(nbh) <= (size_t)kMaxSmem) return 2;
  if (Cfg<1>::smem(nbh) <= (size_t)kMaxSmem) return 1;
  return 0;
}

struct Args {
  const float* x;
  const float2 *ks, *fh, *wfac, *hfac, *dfac, *ch;  // fh, ch: dense H; hfac: factored
  const uint32_t* frag;                             // the tensor-core chains' table
  float2 *t, *z;
  float* out;
  int cin, cout, groups, d, h, w, od, oh, ow, nbd, kd, nwb, hop, item0, nitem;
  int pp;      // > 0: x is B6's packed layout with pp d-pairs (B3 only)
  int ha, hb;  // the factored H/W kernels' split of hw, or 0, 0: the dense ones
  int hw;      // the H transforms' working length: ha * hb, or h (dense)
  cudaStream_t stream;
};

template <int SB, bool PK>
cudaError_t launch_hw_forward(const Args& a) {
  const size_t smem = Cfg<SB>::smem(a.h / 2 + 1);
  cudaError_t err = cudaFuncSetAttribute(
      fused3d_hw_forward<SB, PK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused3d_hw_forward<SB, PK><<<dim3(a.nitem * a.cin, (a.d + SB - 1) / SB), kThreads, smem,
                               a.stream>>>(
      a.x, a.fh, a.wfac, a.t, a.cin, a.d, a.h, a.w, a.ow, a.nwb, a.hop, a.item0, a.pp);
  return cudaGetLastError();
}

template <int SB>
cudaError_t launch_hw_inverse(const Args& a) {
  const size_t smem = Cfg<SB>::smem(a.h / 2 + 1);
  cudaError_t err = cudaFuncSetAttribute(
      fused3d_hw_inverse<SB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused3d_hw_inverse<SB><<<dim3(a.nitem * a.cout, (a.od + SB - 1) / SB), kThreads, smem, a.stream>>>(
      a.z, a.wfac, a.ch, a.out, a.cout, a.h, a.w, a.od, a.oh, a.ow, a.nwb, a.hop, a.item0);
  return cudaGetLastError();
}

// Lets a factored H/W kernel take smem bytes of dynamic shared memory, with
// the SM's carveout at its most shared memory, so that kHwBlocks blocks fit.
template <typename K>
cudaError_t allow_smem(K* kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The factored H/W kernels at the working length a.hw: kSBF slabs of
// hw / 2 + 1 rows a block, as many blocks an SM as that shared memory allows
// (3 up to hw = 144, 2 up to 222, 1 up to 256).
template <int HT, bool PK>
cudaError_t launch_hw_forward_f(const Args& a) {
  const auto kernel = fused3d_hw_forward_f<HT, kSBF, PK>;
  const size_t smem = Cfg<kSBF>::smem(a.hw / 2 + 1);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.nitem * a.cin, (a.d + kSBF - 1) / kSBF), kHwThreads, smem, a.stream>>>(
      a.x, a.hfac, a.wfac, a.t, a.cin, a.d, a.h, a.w, a.ow, a.nwb, a.hop, a.item0, a.pp, a.ha,
      a.hb);
  return cudaGetLastError();
}

template <int HT>
cudaError_t launch_hw_inverse_f(const Args& a) {
  const auto kernel = fused3d_hw_inverse_f<HT, kSBF>;
  const size_t smem = Cfg<kSBF>::smem(a.hw / 2 + 1);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.nitem * a.cout, (a.od + kSBF - 1) / kSBF), kHwThreads, smem, a.stream>>>(
      a.z, a.hfac, a.wfac, a.out, a.cout, a.w, a.od, a.oh, a.ow, a.nwb, a.hop, a.item0, a.ha,
      a.hb);
  return cudaGetLastError();
}

template <int HT>
cudaError_t launch_hw_f(const Args& a, bool forward) {
  if (!forward) return launch_hw_inverse_f<HT>(a);
  return a.pp > 0 ? launch_hw_forward_f<HT, true>(a) : launch_hw_forward_f<HT, false>(a);
}

// Whether a.ha, a.hb is the split the kernels built for HT run.
template <int HT>
bool split_is(const Args& a) {
  return a.ha == HSplit<HT>::A && a.hb == HSplit<HT>::B;
}

// The most output channels of {8, 4, 2, 1}, at most MOST, that divide a
// group's opg, and the launch of the D kernel at that count (only those
// counts are built).
template <template <int> class L, int MOST>
cudaError_t launch_opb(const Args& a) {
  const int opg = a.cout / a.groups;
  if constexpr (MOST >= 8) {
    if (opg % 8 == 0) return L<8>::run(a);
  }
  if constexpr (MOST >= 4) {
    if (opg % 4 == 0) return L<4>::run(a);
  }
  if constexpr (MOST >= 2) {
    if (opg % 2 == 0) return L<2>::run(a);
  }
  return L<1>::run(a);
}

// fused3d_d_mac: as many warps as pairs, at most kDWarps; the group's
// channels staged in chunks of cc within kStageBytes
template <int OPB>
struct LaunchDMac {
  static cudaError_t run(const Args& a) {
    const int npos = (a.hw / 2 + 1) * kTW, cpg = a.cin / a.groups;
    const int warps = std::min(a.nitem * a.nbd, kDWarps);
    const int per_channel = OPB * kDB * kDBins * (int)sizeof(float2);
    const int cc = std::min(cpg, std::max(1, kStageBytes / per_channel));
    const size_t smem = (size_t)cc * OPB * kDB * kDBins * sizeof(float2);
    cudaError_t err = allow_smem(fused3d_d_mac<OPB>, smem);
    if (err != cudaSuccess) return err;
    fused3d_d_mac<OPB><<<dim3(npos / kDBins, a.cout / OPB), 32 * warps, smem, a.stream>>>(
        a.t, a.ks, a.dfac, a.z, a.cin, a.cout, a.groups, a.d, a.hw / 2 + 1, a.nbd, a.od, a.nitem,
        cc);
    return cudaGetLastError();
  }
};

// fused3d_tap_mac: as many pair lanes as pairs (whole warps), at most
// kTapThreads / kTapBins; the group's (channel, tap) entries staged in chunks
// of ce within kStageBytes
template <int OPB>
struct LaunchTapMac {
  static cudaError_t run(const Args& a) {
    const int npos = (a.hw / 2 + 1) * kTW, nent = a.cin / a.groups * a.kd;
    const int npair = a.nitem * ((a.od + kTapDC - 1) / kTapDC), per_warp = 32 / kTapBins;
    const int lanes =
        std::min((npair + per_warp - 1) / per_warp * per_warp, kTapThreads / kTapBins);
    const int per_entry = OPB * kTapBins * (int)sizeof(float2);
    const int ce = std::min(nent, std::max(1, kStageBytes / per_entry));
    const size_t smem = (size_t)ce * OPB * kTapBins * sizeof(float2);
    cudaError_t err = allow_smem(fused3d_tap_mac<OPB>, smem);
    if (err != cudaSuccess) return err;
    fused3d_tap_mac<OPB><<<dim3(npos / kTapBins, a.cout / OPB), lanes * kTapBins, smem,
                           a.stream>>>(a.t, a.ks, a.z, a.cin, a.cout, a.groups, a.d, a.hw / 2 + 1,
                                       a.kd, a.od, a.nitem, ce);
    return cudaGetLastError();
  }
};

// The checks every chain needs, with sb slabs a block (0: none fits):
// channels and groups, the valid box, the W blocks, the item range and the
// grid limits.
bool shape_ok(const Args& a, int sb) {
  return sb != 0 && a.groups >= 1 && a.cin % a.groups == 0 && a.cout % a.groups == 0 &&
         a.d >= 1 && a.od >= 1 && a.od <= a.d && a.oh >= 1 && a.oh <= a.h && a.ow >= 1 &&
         a.ow <= a.w && a.nwb >= 1 && a.hop >= 1 && a.nitem >= 1 && a.item0 >= 0 &&
         (a.d + sb - 1) / sb <= 65535 && (a.od + sb - 1) / sb <= 65535 && a.cout <= 65535;
}

// The checks both FP32 chains need: shape_ok and the H factors of the H/W
// kernels that run (a split of radices 2 to 16, HB even, of a working length
// hw >= h, with hfac; or the dense ones, fh and ch, at the plan's slab count
// sb).
bool hw_args_ok(const Args& a, int sb) {
  const bool fac = a.ha != 0 || a.hb != 0;
  if (fac ? (a.hfac == nullptr || a.ha < 2 || a.ha > kMaxRadix || a.hb < 2 ||
             a.hb > kMaxRadix || a.hb % 2 != 0 || a.hw < a.h)
          : (a.fh == nullptr || a.ch == nullptr))
    return false;
  return shape_ok(a, fac && sb != 0 ? kSBF : sb);
}

// The checks both tensor-core chains need: shape_ok at one slab pair a block
// and the H steps (HA, HB): a split of radices 2 to 16, HB even, of a
// working length hw >= h up to 256, with hfac; or (h, 1) for h < 16, one
// dense step. The table and the W factors are given.
bool tc_args_ok(const Args& a) {
  const bool dense = a.hb == 1;
  if (dense ? (a.ha != a.h || a.h < 1 || a.h > kMaxRadix - 1)
            : (a.hfac == nullptr || a.ha < 2 || a.ha > kMaxRadix || a.hb < 2 ||
               a.hb > kMaxRadix || a.hb % 2 != 0 || a.hw < a.h))
    return false;
  return a.frag != nullptr && a.wfac != nullptr && shape_ok(a, 2);
}

template <int SB>
cudaError_t launch_hw(const Args& a, bool forward) {
  if (!forward) return launch_hw_inverse<SB>(a);
  return a.pp > 0 ? launch_hw_forward<SB, true>(a) : launch_hw_forward<SB, false>(a);
}

// The H/W kernels of one direction: the factored ones when the host hands a
// split (those built for its H where it is one of the four constant splits,
// else those that take it as arguments), else the dense ones at the plan's
// slab count sb.
cudaError_t launch_hw_sb(const Args& a, int sb, bool forward) {
  if (a.ha == 0)
    return sb == 4 ? launch_hw<4>(a, forward) : sb == 2 ? launch_hw<2>(a, forward)
                                                        : launch_hw<1>(a, forward);
  if (split_is<16>(a)) return launch_hw_f<16>(a, forward);
  if (split_is<32>(a)) return launch_hw_f<32>(a, forward);
  if (split_is<64>(a)) return launch_hw_f<64>(a, forward);
  if (split_is<128>(a)) return launch_hw_f<128>(a, forward);
  return launch_hw_f<0>(a, forward);
}

// B3: hw_forward, d_mac, hw_inverse
cudaError_t launch(const Args& a) {
  const int sb = slabs_per_block(a.hw / 2 + 1);
  if (!hw_args_ok(a, sb) || a.dfac == nullptr || a.nbd < 1 || kDHop * a.nbd < a.od ||
      kDHop * (a.nbd - 1) >= a.od || a.pp < 0 || (a.pp > 0 && 2 * a.pp < a.d))
    return cudaErrorInvalidValue;

  cudaError_t err = launch_hw_sb(a, sb, true);
  if (err != cudaSuccess) return err;
  err = launch_opb<LaunchDMac, kDOpb>(a);
  if (err != cudaSuccess) return err;
  return launch_hw_sb(a, sb, false);
}

// B4: hw_forward, tap_mac, hw_inverse
cudaError_t launch_tap(const Args& a) {
  const int sb = slabs_per_block(a.hw / 2 + 1);
  if (!hw_args_ok(a, sb) || a.kd < 1 || a.od != a.d - a.kd + 1) return cudaErrorInvalidValue;

  cudaError_t err = launch_hw_sb(a, sb, true);
  if (err != cudaSuccess) return err;
  err = launch_opb<LaunchTapMac, kTapOpb>(a);
  if (err != cudaSuccess) return err;
  return launch_hw_sb(a, sb, false);
}

// Shared memory of one block of the tensor-core H/W kernels at the split
// (HA, HB) ((0, 0): the split taken as arguments) and the working length
// hw: the plane's rows of 64 complex values.
template <int HA, int HB>
size_t tc_smem(int hw) {
  return (size_t)tc_rows<HA, HB>(hw) * kTW * sizeof(float2);
}

template <int HA, int HB, bool X3, bool PK>
cudaError_t launch_hw_forward_tc(const Args& a) {
  const auto kernel = fused3d_hw_forward_tc<HA, HB, X3, PK>;
  const size_t smem = tc_smem<HA, HB>(a.hw);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.nitem * a.cin, (a.d + 1) / 2), kHwThreads, smem, a.stream>>>(
      a.x, a.frag, a.hfac, a.wfac, a.t, a.cin, a.d, a.h, a.w, a.ow, a.nwb, a.hop, a.item0, a.pp,
      a.ha, a.hb);
  return cudaGetLastError();
}

template <int HA, int HB, bool X3>
cudaError_t launch_hw_inverse_tc(const Args& a) {
  const auto kernel = fused3d_hw_inverse_tc<HA, HB, X3>;
  const size_t smem = tc_smem<HA, HB>(a.hw);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.nitem * a.cout, (a.od + 1) / 2), kHwThreads, smem, a.stream>>>(
      a.z, a.frag, a.hfac, a.wfac, a.out, a.cout, a.w, a.od, a.oh, a.ow, a.nwb, a.hop, a.item0,
      a.ha, a.hb);
  return cudaGetLastError();
}

// One direction of the tensor-core H/W pair built for the split (HA, HB);
// the forward on B6's layout (pp > 0) is built for (8, 8), the 64^3 row's
// split, and runs the kernel that takes its split as arguments at any other.
template <int HA, int HB, bool X3>
cudaError_t launch_hw_tc_at(const Args& a, bool forward) {
  if (!forward) return launch_hw_inverse_tc<HA, HB, X3>(a);
  if (a.pp == 0) return launch_hw_forward_tc<HA, HB, X3, false>(a);
  if constexpr (HA == 0 || (HA == 8 && HB == 8))
    return launch_hw_forward_tc<HA, HB, X3, true>(a);
  else
    return launch_hw_forward_tc<0, 0, X3, true>(a);
}

// The tensor-core H/W kernels of one direction: those built for the call's
// split where it is a row's ((8, 8) at 64^3, (8, 6) at 48^3, (13, 6) at the
// stuffed 78^3, (7, 12) at the stuffed 84), else those that take it as
// arguments.
template <bool X3>
cudaError_t launch_hw_tc(const Args& a, bool forward) {
  const auto is = [&](int ha, int hb) { return a.ha == ha && a.hb == hb; };
  if (is(8, 8)) return launch_hw_tc_at<8, 8, X3>(a, forward);
  if (is(8, 6)) return launch_hw_tc_at<8, 6, X3>(a, forward);
  if (is(13, 6)) return launch_hw_tc_at<13, 6, X3>(a, forward);
  if (is(7, 12)) return launch_hw_tc_at<7, 12, X3>(a, forward);
  return launch_hw_tc_at<0, 0, X3>(a, forward);
}

// fused3d_d_mac_tc: as LaunchDMac, on kDBinsTc bins a block, with two tiles
// of T of the most rows a round of pairs takes
template <bool X3>
struct DMacTc {
  template <int OPB>
  struct L {
    static cudaError_t run(const Args& a) {
      const int npos = (a.hw / 2 + 1) * kTW, cpg = a.cin / a.groups;
      const int npair = a.nitem * a.nbd, warps = std::min(npair, kDWarps);
      const int per_channel = OPB * kDB * kDBinsTc * (int)sizeof(float2);
      const int cc = std::min(cpg, std::max(1, kStageBytes / per_channel));
      int trows = 0;
      for (int p0 = 0; p0 < npair; p0 += warps) {
        const int last = std::min(p0 + warps, npair) - 1;
        trows = std::max(trows, 8 * (last - p0) + 8 * (last / a.nbd - p0 / a.nbd) + kDB);
      }
      const size_t smem =
          (size_t)cc * per_channel + 2 * (size_t)trows * kDBinsTc * sizeof(float2);
      const auto kernel = fused3d_d_mac_tc<OPB, X3>;
      cudaError_t err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<dim3(npos / kDBinsTc, a.cout / OPB), 32 * warps, smem, a.stream>>>(
          a.t, a.ks, tc_table(a.frag, a.ha, a.hb).d, a.z, a.cin, a.cout, a.groups, a.d,
          a.hw / 2 + 1, a.nbd, a.od, a.nitem, cc, trows);
      return cudaGetLastError();
    }
  };
};

// The tensor-core chain of B3 (hw_forward_tc, d_mac_tc, hw_inverse_tc) or of
// B4 (tap: hw_forward_tc, tap_mac, hw_inverse_tc), X3 for "bf16x3".
template <bool X3>
cudaError_t launch_tc_chain(const Args& a, bool tap) {
  cudaError_t err = launch_hw_tc<X3>(a, true);
  if (err != cudaSuccess) return err;
  err = tap ? launch_opb<LaunchTapMac, kTapOpb>(a)
            : launch_opb<DMacTc<X3>::template L, kDOpbTc>(a);
  if (err != cudaSuccess) return err;
  return launch_hw_tc<X3>(a, false);
}

// Either chain under MODE 3 ("bf16x3") or 1 ("bf16"), after the checks of
// launch or launch_tap and tc_args_ok.
cudaError_t launch_tc(const Args& a, bool tap, int mode) {
  const bool ok = tap ? a.kd >= 1 && a.od == a.d - a.kd + 1
                      : a.nbd >= 1 && kDHop * a.nbd >= a.od && kDHop * (a.nbd - 1) < a.od &&
                            a.pp >= 0 && (a.pp == 0 || 2 * a.pp >= a.d);
  if (!ok || !tc_args_ok(a) || (mode != 1 && mode != 3) || (tap && a.pp != 0) ||
      tc_smem<0, 0>(a.hw) > (size_t)kMaxSmem)
    return cudaErrorInvalidValue;
  return mode == 3 ? launch_tc_chain<true>(a, tap) : launch_tc_chain<false>(a, tap);
}

}  // namespace

// Runs items [item0, item0 + nitem) (item = batch index * nwb + W block) of
// one convolution through B3, the v4 chain. The H transforms run at the
// working length hw = ha * hb >= h (fused3d.py: _h_work) on the factored H/W
// kernels, or, with ha = hb = 0, at hw = h on the dense ones. x (B, Cin, d,
// h, w) f32, or with pp > 0 B6's packed layout (B * nwb, h, Cin * pp, 128)
// f32; ks (Cout, Cin/groups, 16, hw/2+1, 64); wfac the W factors, 8 + 8 + 64
// complex (fused3d.py: _w_factors), which hw_forward reads as they are and
// hw_inverse conjugated; factored: hfac the H factors, ha + hb + ha * hb
// complex (fused3d.py: _device_mats), read alike, and fh, ch unused (may be
// null); dense: fh (h/2+1, h) and ch (oh, h/2+1), and hfac unused (may be
// null); dfac the DFT-16 factors, 4 + 4 + 16 complex (fused3d.py:
// _factor_vector of _D_SPLIT, 16-byte aligned like ks); scratch t (nitem,
// Cin, d, hw/2+1, 64) and z (nitem, Cout, od, hw/2+1, 64), nbd = ceil(od /
// 8); out (B, Cout, od, oh, ow) f32. Complex arrays are interleaved (re, im)
// float pairs. W blocks start at min(i * hop, max(w - 64, 0)); with nwb = 1,
// hop is ow. Returns cudaGetLastError() after the three launches (0 when all
// were accepted).
extern "C" int fused3d_forward(const void* x, const void* ks, const void* fh, const void* wfac,
                               const void* hfac, const void* dfac, const void* ch, void* t,
                               void* z, void* out, int cin, int cout,
                               int groups, int d, int h, int w, int od, int oh, int ow, int nbd,
                               int nwb, int hop, int item0, int nitem, int pp, int ha, int hb,
                               void* stream) {
  Args a{};
  a.x = static_cast<const float*>(x);
  a.ks = static_cast<const float2*>(ks);
  a.fh = static_cast<const float2*>(fh);
  a.wfac = static_cast<const float2*>(wfac);
  a.hfac = static_cast<const float2*>(hfac);
  a.dfac = static_cast<const float2*>(dfac);
  a.ch = static_cast<const float2*>(ch);
  a.t = static_cast<float2*>(t);
  a.z = static_cast<float2*>(z);
  a.out = static_cast<float*>(out);
  a.cin = cin;
  a.cout = cout;
  a.groups = groups;
  a.d = d;
  a.h = h;
  a.w = w;
  a.od = od;
  a.oh = oh;
  a.ow = ow;
  a.nbd = nbd;
  a.nwb = nwb;
  a.hop = hop;
  a.item0 = item0;
  a.nitem = nitem;
  a.pp = pp;
  a.ha = ha;
  a.hb = hb;
  a.hw = ha != 0 ? ha * hb : h;
  a.stream = static_cast<cudaStream_t>(stream);
  return launch(a);
}

// Runs items [item0, item0 + nitem) of one convolution through B4, the tap
// chain. x (B, Cin, d, h, w) f32; ks (Cout, Cin/groups, kd, hw/2+1, 64), the
// conjugated per-tap 2D spectra, 16-byte aligned; fh, wfac, hfac, ch, ha and
// hb (hw = ha * hb, or h) as for fused3d_forward; scratch t (nitem, Cin, d,
// hw/2+1, 64) and z (nitem, Cout, od, hw/2+1, 64), od = d - kd + 1; out (B,
// Cout, od, oh, ow) f32. Returns cudaGetLastError() after the three launches
// (0 when all were accepted).
extern "C" int fused3d_tap_forward(const void* x, const void* ks, const void* fh,
                                   const void* wfac, const void* hfac, const void* ch, void* t,
                                   void* z, void* out, int cin, int cout, int groups, int d,
                                   int h, int w, int kd, int od, int oh, int ow, int nwb,
                                   int hop, int item0, int nitem, int ha, int hb,
                                   void* stream) {
  Args a{};
  a.x = static_cast<const float*>(x);
  a.ks = static_cast<const float2*>(ks);
  a.fh = static_cast<const float2*>(fh);
  a.wfac = static_cast<const float2*>(wfac);
  a.hfac = static_cast<const float2*>(hfac);
  a.ch = static_cast<const float2*>(ch);
  a.t = static_cast<float2*>(t);
  a.z = static_cast<float2*>(z);
  a.out = static_cast<float*>(out);
  a.cin = cin;
  a.cout = cout;
  a.groups = groups;
  a.d = d;
  a.h = h;
  a.w = w;
  a.kd = kd;
  a.od = od;
  a.oh = oh;
  a.ow = ow;
  a.nwb = nwb;
  a.hop = hop;
  a.item0 = item0;
  a.nitem = nitem;
  a.ha = ha;
  a.hb = hb;
  a.hw = ha != 0 ? ha * hb : h;
  a.stream = static_cast<cudaStream_t>(stream);
  return launch_tap(a);
}

// B3 under the tensor-core precision modes: fused3d_forward's arguments with
// frag the table of fused3d.py:_tc_fragments_3d in place of fh, dfac and
// ch; ha, hb the H steps (fused3d.py: _tc_split: the split of hw for h from
// 16 to 256, h and 1 below 16), hfac as fused3d_forward takes it (may be
// null for hb = 1); mode 3 ("bf16x3") or 1 ("bf16"). Returns
// cudaGetLastError() after the three launches (0 when all were accepted).
extern "C" int fused3d_forward_tc(const void* x, const void* ks, const void* frag,
                                  const void* wfac, const void* hfac, void* t, void* z, void* out,
                                  int cin, int cout, int groups, int d, int h, int w, int od,
                                  int oh, int ow, int nbd, int nwb, int hop, int item0, int nitem,
                                  int pp, int ha, int hb, int mode, void* stream) {
  Args a{};
  a.x = static_cast<const float*>(x);
  a.ks = static_cast<const float2*>(ks);
  a.frag = static_cast<const uint32_t*>(frag);
  a.wfac = static_cast<const float2*>(wfac);
  a.hfac = static_cast<const float2*>(hfac);
  a.t = static_cast<float2*>(t);
  a.z = static_cast<float2*>(z);
  a.out = static_cast<float*>(out);
  a.cin = cin;
  a.cout = cout;
  a.groups = groups;
  a.d = d;
  a.h = h;
  a.w = w;
  a.od = od;
  a.oh = oh;
  a.ow = ow;
  a.nbd = nbd;
  a.nwb = nwb;
  a.hop = hop;
  a.item0 = item0;
  a.nitem = nitem;
  a.pp = pp;
  a.ha = ha;
  a.hb = hb;
  a.hw = ha * hb;
  a.stream = static_cast<cudaStream_t>(stream);
  return launch_tc(a, false, mode);
}

// B4 under the tensor-core precision modes: fused3d_tap_forward's arguments
// with frag, ha, hb, hfac and mode as for fused3d_forward_tc. Returns
// cudaGetLastError() after the three launches.
extern "C" int fused3d_tap_forward_tc(const void* x, const void* ks, const void* frag,
                                      const void* wfac, const void* hfac, void* t, void* z,
                                      void* out, int cin, int cout, int groups, int d, int h,
                                      int w, int kd, int od, int oh, int ow, int nwb, int hop,
                                      int item0, int nitem, int ha, int hb, int mode,
                                      void* stream) {
  Args a{};
  a.x = static_cast<const float*>(x);
  a.ks = static_cast<const float2*>(ks);
  a.frag = static_cast<const uint32_t*>(frag);
  a.wfac = static_cast<const float2*>(wfac);
  a.hfac = static_cast<const float2*>(hfac);
  a.t = static_cast<float2*>(t);
  a.z = static_cast<float2*>(z);
  a.out = static_cast<float*>(out);
  a.cin = cin;
  a.cout = cout;
  a.groups = groups;
  a.d = d;
  a.h = h;
  a.w = w;
  a.kd = kd;
  a.od = od;
  a.oh = oh;
  a.ow = ow;
  a.nwb = nwb;
  a.hop = hop;
  a.item0 = item0;
  a.nitem = nitem;
  a.ha = ha;
  a.hb = hb;
  a.hw = ha * hb;
  a.stream = static_cast<cudaStream_t>(stream);
  return launch_tc(a, true, mode);
}

// B7: the conjugated spectra ks (pairs, 16, hw/2+1, 64) complex of the taps k
// (pairs, kd, kh, kw) f32, pairs = Cout * Cin/groups, for B3 at the working
// length hw (fused3d.py: kernel_spectra_3d, _spectra_v4_reference); roots
// the 64 + hw roots exp(-2 pi i m / N) of the W and H transforms (fused3d.py:
// _spectra_roots); dfac the DFT-16 factors, 4 + 4 + 16 complex, as
// fused3d_forward takes them. Every element of ks is written. Returns
// cudaGetLastError() after the launch.
extern "C" int fused3d_spectra_v4(const void* k, const void* roots, const void* dfac, void* ks,
                                  int pairs, int kd, int kh, int kw, int hw, void* stream) {
  const int blocks_y = (hw / 2 + 1 + kSpecNB - 1) / kSpecNB;
  const size_t smem = spectra_smem(kd, kh, kw);
  if (pairs < 1 || kd < 1 || kd > 9 || kh < 1 || kh > hw || kw < 1 || kw > kTW ||
      blocks_y > 65535 || smem > (size_t)kMaxSmem || dfac == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused3d_spectra_taps, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused3d_spectra_taps<<<dim3(pairs, blocks_y), kSpecThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(k), static_cast<const float2*>(roots),
      static_cast<const float2*>(dfac), static_cast<float2*>(ks), kd, kh, kw, hw);
  return cudaGetLastError();
}

// B6: packs x (B, Cin, d, h, w) f32 into xp (B * nwb, h, Cin * pp, 128) f32,
// xp[b * nwb + j, h, c * pp + p, 64 * s + wl] = x[b, c, 2p + s, h, start_j +
// wl] with start_j = min(j * hop, max(w - 64, 0)), zeros for 2p + s >= d and
// for start_j + wl >= w. Every element of xp is written. Returns
// cudaGetLastError() after the launch.
extern "C" int fused3d_pack(const void* x, void* xp, int b, int cin, int d, int h, int w,
                            int pp, int nwb, int hop, void* stream) {
  if (b < 1 || cin < 1 || d < 1 || h < 1 || w < 1 || pp < 1 || 2 * pp < d || nwb < 1 ||
      hop < 1 || (nwb > 1 && w < kTW))
    return cudaErrorInvalidValue;
  const int64_t n4 = (int64_t)b * nwb * h * cin * pp * (2 * kTW / 4);
  const int64_t blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  fused3d_pack_x<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float4*>(xp), cin, d, h, w, pp, nwb, hop, n4);
  return cudaGetLastError();
}

// Dynamic shared memory of one block of the H/W kernels for an H with
// nbh = h/2+1 one-sided rows, or -1 when no slab count fits. The host's plan
// mirrors this formula (fused3d.py: _smem_bytes); a card test holds the two
// together.
extern "C" long long fused3d_smem_bytes(int nbh) {
  switch (slabs_per_block(nbh)) {
    case 4:
      return (long long)Cfg<4>::smem(nbh);
    case 2:
      return (long long)Cfg<2>::smem(nbh);
    case 1:
      return (long long)Cfg<1>::smem(nbh);
    default:
      return -1;
  }
}

// The CUDA runtime's message for an error code returned above.
extern "C" const char* fused3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
