// Fused 1D overlap-save FFT convolution for Hopper (sm_90a), in FP32.
//
// Kernel B1. Replaces the TPU kernel fft_conv_tpu/kernels/fused1d.py:291
// (_make_kernel, built by _fused_call): the valid cross-correlation of each
// overlap-save block of N = N1 * 128 samples (N1 in {16, 32, 64}) through the
// one-sided four-step DFT of the N1 x 128 window A[j1, j2] = x[j1 128 + j2]:
// stage 1, the N1-point DFT down each column, on rows k1 in [0, N1/2] only;
// the twiddle tw[k1, j2] = exp(-2 pi i k1 j2 / N); stage 2, the 128-point DFT
// along each row; a per-bin complex MAC over the group's input channels
// against the conjugated kernel spectra (fused1d.py:kernel_spectra_one_sided);
// the inverse in reverse order, emitting only the V1 valid rows of each
// block. The host side (factors, spectra, block ranges) is in
// fft_conv_tpu_torch/kernels/fused1d.py.
//
// Factored DFTs. The TPU kernel runs each stage as a dense matrix product on
// its matrix unit. Here every DFT is a four-step transform run as radix-2
// butterflies in registers (the roots and twiddles of
// fourstep.fft_factor_matrices, built in float64 and cast to float32 by the
// host), in natural bin order:
//   * stage 1 packs the real columns c and c + 64 as one complex column and
//     runs its N1-point DFT split N1 = CA * CB (4 * 4, 8 * 4, 8 * 8) over two
//     steps; bins k and -k are then split into the two real columns' spectra,
//     keeping k1 <= N1/2;
//   * stage 2 and the inverse stage 1 run the 128-point row DFT as 16 * 8;
//   * the inverse stage 2 is a c2r on two columns at once: one complex
//     N1-point inverse of c = G_c + i G_c+64, G the Hermitian extension
//     G[N1 - k1] = conj G[k1] of a one-sided column (DC and Nyquist taken
//     real), whose real and imaginary parts are the two output columns; only
//     the V1 valid rows are stored, 1/N folded into that store.
// So a block costs a few tens of flops per sample and stage where the dense
// products cost 4 (N1/2+1) per sample in stage 1 and 1024 per bin in stage 2.
//
// Partition. Two kernels run back to back on the caller's stream:
//   phase 1, grid (B * Cin, blocks): stage 1 reads one channel's window
//     straight from the (B, Cin, L) signal into registers (reads past L are
//     zeros: no padded copy); stage 2; the one-sided spectrum D (N1/2+1, 128)
//     goes to a scratch buffer (blocks, B, Cin, N1/2+1, 128);
//   phase 2, grid (B * Cout, blocks): MAC over the group's channels of D
//     against the spectra (both read through L2) into shared memory, the
//     inverse row DFT, the conjugate twiddle and the c2r, storing the
//     V1 x 128 valid outputs straight into (B, Cout, L - K + 1).
// A block holds two planes of (N1/2+1) x 128 complex values (18 KB at
// N1 = 16, 66 KB at N1 = 64) and every step reads one and writes the other
// (or its own values in place), so each step ends with one barrier and none
// holds values across one. The row planes are swizzled (column c ^ (row & 15))
// so that neighbouring rows fall in distinct banks; the column steps keep the
// 64 column pairs of one row side by side. The caller runs the overlap-save
// blocks in ranges so that D stays bounded.
//
// Bound. At the library's benchmark shapes (B=2, 8 -> 8 channels,
// L = 32768, K in {256, 1024, 3840}) the least work is about 0.05-0.08 GFLOP
// a call and the signal, spectra and output come to 5-6 MB, so HBM bounds the
// function at about 0.0015-0.002 ms (chip_smoke.py:fused1d_work). What holds
// B1 is latency: the grids are B * Cin x blocks = 304 / 176 / 112 blocks, at
// most about two per SM, so a block's own chain of loads, butterflies and
// barriers sets the time, not a rate. The block size follows from that, per
// phase and per call: where the phase's grid has no more blocks than the card
// has SMs, each block gets 512 threads, one for each task of the larger
// column step at N1 = 32 and 64, so that a column step is one pass with its
// loads in flight together; elsewhere 256, so that two or three blocks share
// an SM (512 threads at 70-100 registers fit only one, so at N1 = 32 the
// benchmark's 176 blocks would run in two waves). The row steps leave threads
// idle at small N1 (9 rows give 72 and 144 tasks at N1 = 16), which costs
// nothing here: the grid has no more blocks that the idle lanes could serve.
// Phase 2 re-reads D and the spectra once per output channel through L2, most
// of its time. TMA staging and fusing the two phases are left for later work.
//
// Tensor-core modes (fused1d.py: set_fused_precision "bf16x3" and "bf16",
// the JAX package's modes of the same names, fft_conv_tpu/kernels/fused1d.py:
// 177 and _dot :255, which replace the same TPU kernel, _make_kernel). A
// route of three kernels <N1, MODE> a block range (entry point
// fused1d_forward_tc) computes B1's function with every DFT step a bf16
// mma.sync product with an FP32 accumulator (bf16_mma.cuh: dft_tile), as the
// TPU kernel forms each DFT product from bf16 operands under those modes:
// the column DFT and the c2r of the 64 column pairs as one dense N1-point
// step at N1 = 16 and 32 (2 N1 real fills every k-step of 16 and needs no
// inner twiddle) and as two 8-point steps at N1 = 64; the row DFTs as 16 * 8.
// The DFT matrices come from the host (fused1d.py: _tc_fragments) laid out
// as the B fragments the lanes read. The planes hold FP32 values and a warp
// splits them into bf16 hi/lo as it loads them; the twiddles (rounded as the
// plain version rounds them, without FMA), the split into one-sided spectra,
// the MAC, the Hermitian extension and 1/N stay FP32, and so do D and Y, as
// the TPU kernel keeps them on its vector unit: the operands of the DFT steps
// are the only values rounded to bf16. 256 threads a block in each kernel:
//   phase 1, fused1d_spectra_tc, grid (B * Cin, blocks): the window by 4-byte
//     cp.async (zeros past L, no branch a load); the column DFT of the
//     packed pairs A[., c] + i A[., c + 64], its tiles dealt to the warps;
//     one pass forming C (the split of bins k and -k and the twiddle) in
//     the row plane; the row DFT of the N1/2+1 rows (rows_tc), whose second
//     step stores D (blocks, B, Cin, N1/2+1, 128) in natural order from the
//     products. Three blocks an SM at N1 = 16 (its grid of B * Cin x blocks
//     in one wave), two elsewhere;
//   MAC stage, fused1d_mac_tc, grid (unit blocks, N1/2+1, groups x output-
//     channel blocks): for one bin row k1, upb units (a unit is one block of
//     one batch row) and ocb output channels (fused1d.py: _tc_geometry),
//     Y = sum_c D[c] K[o, c] in FP32 in the channels' order (tc_mac.cuh:
//     mac_rows, the MAC B2's route runs, on B1's spectra strides: one read
//     of a D row serves every output channel of the block, the spectra of a
//     block sit in registers, D's rows stream through a cp.async ring); then
//     the conjugated row DFT of the block's upb * ocb rows, its tiles dealt
//     to all 8 warps (rows_tc), Y (blocks, B, Cout, N1/2+1, 128) stored in
//     natural order from the products;
//   inverse stage, fused1d_inverse_tc, grid (B * Cout, blocks): C, the
//     c2r's input (the conjugate twiddle and the Hermitian extension), formed
//     from Y's plane read straight through L1; the c2r of the column pairs
//     onto the V1 valid rows, stored with 1/N from the products.
// What bounds them. Where B1's first tensor-core pair re-read D and the
// spectra through L2 once per output channel in its phase 2 (44.8 / 49.0 /
// 60.6 MB a call at the benchmark rows, its MAC most of that phase's time
// when knocked out, PERF.md), the MAC stage reads D once per output-channel
// block and the spectra once per unit block. The 1D grids are small (B * Cin
// x blocks = 304 / 176 / 112 at the benchmark rows), so each kernel's time is
// one block's chain of copies, products and barriers: the MAC stage takes
// the fewest units a block that fit its grid in one wave of two blocks an SM
// (upb = 2 there: 171 / 187 / 231 blocks), and the row DFTs deal their tiles
// to every warp rather than giving each warp rows of its own.
//
// Entry points: fused1d_forward and fused1d_forward_tc (plain C interface,
// loaded with ctypes). Each returns cudaGetLastError() after its launches; 0
// means all were accepted.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tc_mac.cuh"

namespace {

constexpr int kN2 = 128;           // the row DFT's length: one row of the window
constexpr int kPairs = kN2 / 2;    // column pairs (c, c + 64)
constexpr int kRA = 16, kRB = 8;   // the row DFT's split 128 = 16 * 8 (fused1d.py: _ROW_SPLIT)

// The column split N1 = CA * CB (fused1d.py: _COL_SPLITS) and the factor
// vector's layout (fused1d.py: _device_consts): the CA roots of unity, the CB
// roots, the (CA, CB) column twiddle, then the 16 and 8 roots and the (16, 8)
// row twiddle, row-major.
template <int N1>
struct Plan {
  static constexpr int kH = N1 / 2 + 1;  // one-sided k1 rows
  static constexpr int kCA = N1 == 16 ? 4 : 8, kCB = N1 / kCA;
  static constexpr int kPlane = kH * kN2;  // complex values of one plane
  static constexpr size_t kSmem = 2 * (size_t)kPlane * sizeof(float2);
  static constexpr int kOffCB = kCA, kOffCT = kOffCB + kCB, kOffRA = kOffCT + N1;
  static constexpr int kOffRB = kOffRA + kRA, kOffRT = kOffRB + kRB;
  static_assert(kCA * kCB == N1 && kPairs * N1 <= kPlane, "unsupported N1");
};

// The two block sizes (see Bound above); row_step2 needs a multiple of 16.
constexpr int kNarrow = 256, kWide = 512;

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
__device__ __forceinline__ void dit_stages(float2 (&t)[N], const float2 (&root)[N / 2]) {
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

// v <- the N-point DFT of v (N a power of two; INV: conjugated, unscaled),
// natural order in and out, as radix-2 butterflies on the bit-reversed
// input; root[k] = exp(-2 pi i k / N) for k < N / 2, in registers.
template <int N, bool INV>
__device__ __forceinline__ void short_dft(float2 (&v)[N], const float2 (&root)[N / 2]) {
  float2 t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = v[bitrev(i, N)];
  dit_stages<N, 2, INV>(t, root);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = t[i];
}

// The first N / 2 of the N roots of unity at fac, into registers.
template <int N>
__device__ __forceinline__ void load_roots(const float2* __restrict__ fac, float2 (&root)[N / 2]) {
#pragma unroll
  for (int k = 0; k < N / 2; ++k) root[k] = __ldg(fac + k);
}

// Index of (row, column) in a swizzled row plane of (N1/2+1) x 128.
__device__ __forceinline__ int sw(int r, int c) {
  return r * kN2 + (c ^ (r & 15));
}

// Index of (row j, column pair c) in a column buffer of N1 x 64.
__device__ __forceinline__ int cp(int j, int c) {
  return j * kPairs + c;
}

// Row DFT (INV: conjugated, unscaled), step 1, in place on rows [0, nrows)
// of the plane s: for each (row, j2), the 16-point DFT over j1 of column
// j1 8 + j2 and the twiddle, left at column m1 8 + j2. Neighbouring lanes take
// neighbouring rows. No barrier.
template <bool INV, int NT>
__device__ __forceinline__ void row_step1(float2* s, int nrows, const float2* __restrict__ ra_fac,
                                          const float2* __restrict__ tw) {
  float2 ra[kRA / 2];
  load_roots<kRA>(ra_fac, ra);
  for (int t = threadIdx.x; t < nrows * kRB; t += NT) {
    const int row = t % nrows, j2 = t / nrows;
    float2 v[kRA];
#pragma unroll
    for (int j1 = 0; j1 < kRA; ++j1) v[j1] = s[sw(row, j1 * kRB + j2)];
    short_dft<kRA, INV>(v, ra);
#pragma unroll
    for (int m1 = 0; m1 < kRA; ++m1)
      s[sw(row, m1 * kRB + j2)] = m1 == 0 ? v[0] : cmulw<INV>(v[m1], __ldg(tw + m1 * kRB + j2));
  }
}

// Row DFT, step 2, from plane src to plane dst: for each (row, m1), the
// 8-point DFT over j2 of column m1 8 + j2, written at the natural bins
// m1 + 16 m2. NT / 16 neighbouring lanes take neighbouring rows of one m1.
// No barrier.
template <bool INV, int NT>
__device__ __forceinline__ void row_step2(const float2* src, float2* dst, int nrows,
                                          const float2* __restrict__ rb_fac) {
  constexpr int R = NT / kRA;
  float2 rb[kRB / 2];
  load_roots<kRB>(rb_fac, rb);
  const int m1 = threadIdx.x / R;
  for (int row = threadIdx.x % R; row < nrows; row += R) {
    float2 u[kRB];
#pragma unroll
    for (int j2 = 0; j2 < kRB; ++j2) u[j2] = src[sw(row, m1 * kRB + j2)];
    short_dft<kRB, INV>(u, rb);
#pragma unroll
    for (int m2 = 0; m2 < kRB; ++m2) dst[sw(row, m1 + kRA * m2)] = u[m2];
  }
}

template <int N1, int NT>
__global__ void __launch_bounds__(NT)
fused1d_spectra(const float* __restrict__ x, int64_t l_pad, int64_t hop,
                const float2* __restrict__ fac,  // factors, fused1d.py: _device_consts
                const float2* __restrict__ tw,   // (N1/2+1, 128) four-step twiddle rows
                float2* __restrict__ d,          // (blocks of this launch, B, Cin, N1/2+1, 128)
                int blk0, int batch, int cin) {
  using P = Plan<N1>;
  constexpr int H = P::kH, CA = P::kCA, CB = P::kCB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* s_p = reinterpret_cast<float2*>(smem_raw);
  float2* s_q = s_p + P::kPlane;
  const int tid = threadIdx.x;

  // this block's window: samples [blk*hop, blk*hop + N1*128) of one channel
  const float* xs = x + (int64_t)blockIdx.x * l_pad;
  const int64_t start = (int64_t)(blk0 + blockIdx.y) * hop;

  // stage 1, step 1: for each (pair c, j2), the CA-point DFT over j1 of
  // z[j1 CB + j2] = A[., c] + i A[., c + 64], read from the signal, and the
  // column twiddle, to s_q at row m1 CB + j2
  {
    float2 ra[CA / 2];
    load_roots<CA>(fac, ra);
    for (int t = tid; t < kPairs * CB; t += NT) {
      const int c = t % kPairs, j2 = t / kPairs;
      float2 v[CA];
#pragma unroll
      for (int j1 = 0; j1 < CA; ++j1) {
        const int64_t p = start + (int64_t)(j1 * CB + j2) * kN2 + c;
        v[j1] = make_float2(p < l_pad ? __ldg(xs + p) : 0.f,
                            p + kPairs < l_pad ? __ldg(xs + p + kPairs) : 0.f);
      }
      short_dft<CA, false>(v, ra);
#pragma unroll
      for (int m1 = 0; m1 < CA; ++m1)
        s_q[cp(m1 * CB + j2, c)] =
            m1 == 0 ? v[0] : cmulw<false>(v[m1], __ldg(fac + P::kOffCT + m1 * CB + j2));
    }
  }
  __syncthreads();

  // stage 1, step 2: for each (pair c, m1), the CB-point DFT over j2, to s_p
  // at the natural bin m1 + CA m2
  {
    float2 rb[CB / 2];
    load_roots<CB>(fac + P::kOffCB, rb);
    for (int t = tid; t < kPairs * CA; t += NT) {
      const int c = t % kPairs, m1 = t / kPairs;
      float2 u[CB];
#pragma unroll
      for (int j2 = 0; j2 < CB; ++j2) u[j2] = s_q[cp(m1 * CB + j2, c)];
      short_dft<CB, false>(u, rb);
#pragma unroll
      for (int m2 = 0; m2 < CB; ++m2) s_p[cp(m1 + CA * m2, c)] = u[m2];
    }
  }
  __syncthreads();

  // split Z = X_c + i X_c+64 into the two columns' one-sided spectra,
  // X_c[k] = (Z[k] + conj Z[-k]) / 2 and X_c+64[k] = (Z[k] - conj Z[-k]) / 2i,
  // and the twiddle: C[k1, .] into the row plane s_q
  for (int t = tid; t < H * kPairs; t += NT) {
    const int c = t % kPairs, k1 = t / kPairs;
    const float2 zk = s_p[cp(k1, c)], zm = s_p[cp((N1 - k1) % N1, c)];
    const float2 xa = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
    const float2 xb = make_float2(0.5f * (zk.y + zm.y), 0.5f * (zm.x - zk.x));
    s_q[sw(k1, c)] = cmulw<false>(xa, __ldg(tw + k1 * kN2 + c));
    s_q[sw(k1, c + kPairs)] = cmulw<false>(xb, __ldg(tw + k1 * kN2 + c + kPairs));
  }
  __syncthreads();

  // stage 2: the 128-point DFT of each one-sided row, then D out in order
  row_step1<false, NT>(s_q, H, fac + P::kOffRA, fac + P::kOffRT);
  __syncthreads();
  row_step2<false, NT>(s_q, s_p, H, fac + P::kOffRB);
  __syncthreads();
  float2* dout = d + ((int64_t)blockIdx.y * batch * cin + blockIdx.x) * P::kPlane;
  for (int i = tid; i < P::kPlane; i += NT) dout[i] = s_p[sw(i / kN2, i % kN2)];
}

template <int N1, int NT>
__global__ void __launch_bounds__(NT)
fused1d_mac_inverse(const float2* __restrict__ d,    // (blocks of this launch, B, Cin, N1/2+1, 128)
                    const float2* __restrict__ ks,   // (Cout, N1/2+1, Cin/g, 128), conjugated
                    const float2* __restrict__ fac,  // factors, fused1d.py: _device_consts
                    const float2* __restrict__ tw,   // (N1/2+1, 128)
                    float* __restrict__ out,         // (B, Cout, v_total)
                    int blk0, int batch, int cin, int cout, int groups, int v1,
                    int64_t hop, int64_t v_total) {
  using P = Plan<N1>;
  constexpr int H = P::kH, CA = P::kCA, CB = P::kCB, NH = N1 / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* s_p = reinterpret_cast<float2*>(smem_raw);
  float2* s_q = s_p + P::kPlane;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / cout, o = blockIdx.x % cout;
  const int cpg = cin / groups, g = o / (cout / groups);

  // per-bin MAC over this out-channel's group: Y = sum_c D[c] * K[o, c]
  const float2* dg =
      d + (((int64_t)blockIdx.y * batch + b) * cin + (int64_t)g * cpg) * P::kPlane;
  const float2* ko = ks + (int64_t)o * H * cpg * kN2;
  for (int i = tid; i < P::kPlane; i += NT) {
    const int k1 = i / kN2, k2 = i % kN2;
    float2 y = make_float2(0.f, 0.f);
    for (int ci = 0; ci < cpg; ++ci) {
      cmac(y, __ldg(dg + (int64_t)ci * P::kPlane + i),
           __ldg(ko + ((int64_t)k1 * cpg + ci) * kN2 + k2));
    }
    s_p[sw(k1, k2)] = y;
  }
  __syncthreads();

  // inverse stage 1: the conjugated 128-point DFT of each row, into s_q
  row_step1<true, NT>(s_p, H, fac + P::kOffRA, fac + P::kOffRT);
  __syncthreads();
  row_step2<true, NT>(s_p, s_q, H, fac + P::kOffRB);
  __syncthreads();

  // inverse stage 2, step 1: for each (pair c, j2), the conjugate twiddle,
  // the Hermitian extensions of columns c and c + 64 as one complex column
  // (bins 0 and N1/2 taken real), the conjugated CA-point DFT over j1 and the
  // column twiddle, to s_p at row m1 CB + j2
  {
    float2 ra[CA / 2];
    load_roots<CA>(fac, ra);
    for (int t = tid; t < kPairs * CB; t += NT) {
      const int c = t % kPairs, j2 = t / kPairs;
      float2 v[CA];
#pragma unroll
      for (int j1 = 0; j1 < CA; ++j1) {
        const int k = j1 * CB + j2, kk = k <= NH ? k : N1 - k;
        const float2 ga = cmulw<true>(s_q[sw(kk, c)], __ldg(tw + kk * kN2 + c));
        const float2 gb = cmulw<true>(s_q[sw(kk, c + kPairs)], __ldg(tw + kk * kN2 + c + kPairs));
        if (k == 0 || k == NH)  // real bins: their imaginary parts drop out
          v[j1] = make_float2(ga.x, gb.x);
        else if (k < NH)  // G_c + i G_c+64
          v[j1] = make_float2(ga.x - gb.y, ga.y + gb.x);
        else  // conj(G_c) + i conj(G_c+64) of bin N1 - k
          v[j1] = make_float2(ga.x + gb.y, gb.x - ga.y);
      }
      short_dft<CA, true>(v, ra);
#pragma unroll
      for (int m1 = 0; m1 < CA; ++m1)
        s_p[cp(m1 * CB + j2, c)] =
            m1 == 0 ? v[0] : cmulw<true>(v[m1], __ldg(fac + P::kOffCT + m1 * CB + j2));
    }
  }
  __syncthreads();

  // inverse stage 2, step 2: for each (pair c, m1) with m1 < V1, the
  // conjugated CB-point DFT over j2 onto the output rows r = m1 + CA m2;
  // the rows r < V1 are stored, the real part at column c, the imaginary
  // part at c + 64
  {
    float2 rb[CB / 2];
    load_roots<CB>(fac + P::kOffCB, rb);
    const float scale = 1.f / (float)(N1 * kN2);
    float* orow = out + (int64_t)blockIdx.x * v_total;
    const int64_t base = (int64_t)(blk0 + blockIdx.y) * hop;
    const int rows = v1 < CA ? v1 : CA;
    for (int t = tid; t < kPairs * rows; t += NT) {
      const int c = t % kPairs, m1 = t / kPairs;
      float2 u[CB];
#pragma unroll
      for (int j2 = 0; j2 < CB; ++j2) u[j2] = s_p[cp(m1 * CB + j2, c)];
      short_dft<CB, true>(u, rb);
#pragma unroll
      for (int m2 = 0; m2 < CB; ++m2) {
        const int r = m1 + CA * m2;
        const int64_t pos = base + (int64_t)r * kN2 + c;
        if (r < v1 && pos < v_total) orow[pos] = u[m2].x * scale;
        if (r < v1 && pos + kPairs < v_total) orow[pos + kPairs] = u[m2].y * scale;
      }
    }
  }
}

// Launches one phase on a grid of rows x nblk blocks with smem bytes of shared
// memory, with the block size for that grid: kWide where it has no more
// blocks than the card has SMs.
template <typename... Params, typename... Args>
cudaError_t launch_phase(void (*narrow)(Params...), void (*wide)(Params...), int rows, int nblk,
                         int sms, size_t smem, cudaStream_t stream, Args... args) {
  const bool w = (int64_t)rows * nblk <= sms;
  auto* kernel = w ? wide : narrow;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(rows, nblk), w ? kWide : kNarrow, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The card's SM count, for launch_phase.
cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <int N1>
cudaError_t launch(const float* x, int64_t l_pad, const float2* ks, const float2* fac,
                   const float2* tw, float2* d, float* out, int batch, int cin, int cout,
                   int groups, int v1, int blk0, int nblk, int64_t v_total,
                   cudaStream_t stream) {
  if (v1 < 1 || v1 > N1 || nblk < 1 || nblk > 65535 || blk0 < 0 || groups < 1 ||
      cin % groups || cout % groups)
    return cudaErrorInvalidValue;
  const int64_t hop = (int64_t)v1 * kN2;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  err = launch_phase(fused1d_spectra<N1, kNarrow>, fused1d_spectra<N1, kWide>, batch * cin,
                     nblk, sms, Plan<N1>::kSmem, stream, x, l_pad, hop, fac, tw, d, blk0,
                     batch, cin);
  if (err != cudaSuccess) return err;
  return launch_phase(fused1d_mac_inverse<N1, kNarrow>, fused1d_mac_inverse<N1, kWide>,
                      batch * cout, nblk, sms, Plan<N1>::kSmem, stream, (const float2*)d, ks,
                      fac, tw, out, blk0, batch, cin, cout, groups, v1, hop, v_total);
}

// ---------------------------------------------------------------------------
// The tensor-core route (see the head of this file).

constexpr int kTcThreads = 256, kTcWarps = kTcThreads / 32;
// The MAC stage (tc_mac.cuh: mac_rows): the output channels a thread holds a
// pass, the input channels a chunk (their spectra in registers), the units
// in flight in the block's ring of D, and the rows of its plane, which bound
// upb * ocb (fused1d.py: _TC_PLANE_ROWS). A pass takes kTcThreads / 128 *
// kMacOJ = 8 output channels, a block's ocb (fused1d.py: _TC_OCB).
constexpr int kMacOJ = 4;
constexpr int kMacKC = 4;
constexpr int kMacStages = 3;
constexpr int kMacPlaneRows = 64;

// Shared memory of the tensor-core route at N1. Phase 1: the window, N1 rows
// of WS floats (136 for the dense column DFT, 129 for the factored one, so
// that a load of either reaches 32 distinct banks), then in its place the
// row plane (H + 1 rows of 128 complex, swizzled as tc_mac::sw, the last
// row zero so that row DFT tiles of two rows are whole); beside them the
// column DFT's output, N1 rows of 68 complex (dense: Z, bin k of pair c at
// k 68 + c; factored: Q, see qi). The inverse stage: the c2r's input C, N1
// rows of 68 complex laid out as Q.
template <int N1>
struct TcPlan {
  static constexpr bool kFactored = N1 == 64;
  static constexpr int kH = N1 / 2 + 1;
  static constexpr int kWS = kFactored ? 129 : 136, kZS = 68;
  static constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }
  static constexpr size_t kRegion =
      (cmax(4 * (size_t)N1 * kWS, 8 * (size_t)(kH + 1) * kN2) + 15) / 16 * 16;
  static constexpr size_t kZ = 8 * (size_t)N1 * kZS;
  static constexpr size_t kSpectraSmem = kRegion + kZ;
  static constexpr size_t kInverseSmem = kZ;
  // The fragment buffer (fused1d.py:_tc_fragments), in 32-bit words: the
  // dense N1-point DFT where the column DFT is dense, then the 16- and
  // 8-point DFTs (the rows' split; the 8-point one also the factored column
  // DFT's), the forward and then the conjugated matrix, each as its hi and
  // then its lo fragments; a complex R-point matrix takes 2 R^2 words a half.
  static constexpr int fw(int r) { return 2 * r * r; }
  static constexpr int kColF = 0, kColI = 2 * fw(N1), kR16F = kFactored ? 0 : 4 * fw(N1);
  static constexpr int kR16I = kR16F + 2 * fw(16), kR8F = kR16I + 2 * fw(16);
  static constexpr int kR8I = kR8F + 2 * fw(8);
};

// The MAC stage's dynamic shared memory for rows = upb * ocb plane rows: the
// ring, the plane (rows rounded up to even, for the row DFT's tiles of two
// rows) and each row's offset into Y.
__host__ __device__ constexpr size_t mac_smem_bytes(int rows) {
  return sizeof(float2) * (size_t)(kMacStages * kMacKC + (rows + 1) / 2 * 2) * kN2 +
         sizeof(int64_t) * rows;
}

// a * w, or a * conj(w) for the inverse, rounded as the plain version rounds
// it (two products, then their sum, each to FP32; no FMA), so that the bf16
// operand the next step rounds it to is the plain version's
template <bool INV>
__device__ __forceinline__ float2 cmulw_rn(float2 a, float2 w) {
  if (INV) w.y = -w.y;
  return make_float2(__fsub_rn(__fmul_rn(a.x, w.x), __fmul_rn(a.y, w.y)),
                     __fadd_rn(__fmul_rn(a.x, w.y), __fmul_rn(a.y, w.x)));
}

// Index of (row, column pair c) in a plane of N1 rows of 68 complex, c
// swizzled by bits 3-4 of the row, so that the factored column DFT's step 1
// (rows 8 apart), its step 2 and the dense DFT's loads (rows of 4 lanes
// apart) each reach 16 distinct bank pairs a half-warp.
__device__ __forceinline__ int qi(int row, int c) {
  return row * 68 + (c ^ (((row >> 3) & 3) << 2));
}

// Where bin k of column pair c lies after phase 1's column DFT: dense, Z at
// k 68 + c; factored, in place in Q at row (k % 8) 8 + k / 8.
template <int N1>
__device__ __forceinline__ int zi(int k, int c) {
  return TcPlan<N1>::kFactored ? qi((k & 7) * 8 + (k >> 3), c) : k * TcPlan<N1>::kZS + c;
}

// The N1-point DFT (INV: conjugated, unscaled) of the 64 column pairs on the
// tensor cores, element j of pair c = ld(c, j) (FP32, split into bf16 as it
// is loaded), bin k to st(c, k, value): one dense step at N1 = 16 and 32,
// its 4 tiles of 16 pairs dealt to the warps; at N1 = 64 two 8-point steps,
// step 1 (vector (j2, c), element j1 = ld(c, j1 8 + j2)) into q at qi(m1 8 +
// j2, c) with the twiddle ctw[m1 8 + j2] in FP32, a barrier, then step 2
// (vector (m1, c), element j2 at qi(m1 8 + j2, c)) onto the bins m1 + 8 m2.
// Each tile of either step stores only over the slots it loads, so ld may
// read q at qi(j, c) and step 2's st may write it in place.
template <int N1, bool X3, bool INV, typename LD, typename ST>
__device__ __forceinline__ void col_dft_tc(const uint32_t* __restrict__ frag,
                                           const float2* __restrict__ ctw, float2* q, LD ld,
                                           ST st) {
  using T = TcPlan<N1>;
  if constexpr (!T::kFactored) {
    bf16_mma::dft_step<N1, X3, kTcWarps, true>(kPairs, frag + (INV ? T::kColI : T::kColF), ld,
                                               st);
  } else {
    const uint32_t* f8 = frag + (INV ? T::kR8I : T::kR8F);
    bf16_mma::dft_step<8, X3, kTcWarps, true>(
        8 * kPairs, f8, [&](int m, int j1) { return ld(m & 63, j1 * 8 + (m >> 6)); },
        [&](int m, int m1, float2 v) {
          const int j2 = m >> 6;
          q[qi(m1 * 8 + j2, m & 63)] = m1 == 0 ? v : cmulw_rn<INV>(v, __ldg(ctw + m1 * 8 + j2));
        });
    __syncthreads();
    bf16_mma::dft_step<8, X3, kTcWarps, true>(
        8 * kPairs, f8, [&](int m, int j2) { return q[qi((m >> 6) * 8 + j2, m & 63)]; },
        [&](int m, int m2, float2 v) { st(m & 63, (m >> 6) + 8 * m2, v); });
  }
}

// The 128-point DFT (INV: conjugated, unscaled) of rows [0, nrows) of a
// plane swizzled as tc_mac::sw, as 16 * 8 on the tensor cores, the tiles of
// each step dealt to all of the block's warps and a barrier between the
// steps, so that a few rows keep every warp busy. Step 1, in place, tile p:
// the vectors (row, j2) of rows 2p and 2p + 1 (row nrows of an odd nrows
// read too, and left for no one), element j1 at column j1 8 + j2, its
// 16-point DFT and the twiddle rtw[m1 8 + j2] in FP32, back at column m1 8 +
// j2. Step 2, a tile a row: the vectors (row, m1), element j2 at column m1 8
// + j2, its 8-point DFT to st2(row, bin m1 + 16 m2, value), so that a lane
// group's stores are 8 consecutive bins of one row.
template <bool X3, bool INV, typename ST>
__device__ __forceinline__ void rows_tc(float2* plane, int nrows, const uint32_t* __restrict__ fa,
                                        const uint32_t* __restrict__ fb,
                                        const float2* __restrict__ rtw, ST st2) {
  const int warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int p = warp; 2 * p < nrows; p += kTcWarps) {
    bf16_mma::dft_tile<kRA, X3, true>(
        0, 16, fa,
        [&](int v, int j1) { return plane[tc_mac::sw<kN2>(2 * p + (v >> 3), j1 * kRB + (v & 7))]; },
        [&](int v, int m1, float2 val) {
          const int j2 = v & 7;
          plane[tc_mac::sw<kN2>(2 * p + (v >> 3), m1 * kRB + j2)] =
              m1 == 0 ? val : cmulw_rn<INV>(val, __ldg(rtw + m1 * kRB + j2));
        });
  }
  __syncthreads();
#pragma unroll 1
  for (int row = warp; row < nrows; row += kTcWarps) {
    bf16_mma::dft_tile<kRB, X3, true>(
        0, 16, fb, [&](int m1, int j2) { return plane[tc_mac::sw<kN2>(row, m1 * kRB + j2)]; },
        [&](int m1, int m2, float2 val) { st2(row, m1 + kRA * m2, val); });
  }
}

// Phase 1 of the tensor-core route (MODE 3: "bf16x3", 1: "bf16"):
// fused1d_spectra's function, every DFT step a bf16 product, grid (B * Cin,
// blocks of this launch).
template <int N1, int MODE>
__global__ void __launch_bounds__(kTcThreads, N1 == 16 ? 3 : 2)
fused1d_spectra_tc(const float* __restrict__ x, int64_t l_pad, int64_t hop,
                   const uint32_t* __restrict__ frag,  // fused1d.py: _tc_fragments
                   const float2* __restrict__ fac,     // factors, fused1d.py: _device_consts
                   const float2* __restrict__ tw,      // (N1/2+1, 128) four-step twiddle rows
                   float2* __restrict__ d,             // (blocks of this launch, B, Cin, N1/2+1, 128)
                   int blk0, int batch, int cin) {
  using P = Plan<N1>;
  using T = TcPlan<N1>;
  constexpr bool X3 = MODE == 3;
  constexpr int H = T::kH, WS = T::kWS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* win = reinterpret_cast<float*>(smem_raw);
  float2* rp = reinterpret_cast<float2*>(smem_raw);  // the row plane, over the window
  float2* z = reinterpret_cast<float2*>(smem_raw + T::kRegion);
  const int tid = threadIdx.x;
  const float* xs = x + (int64_t)blockIdx.x * l_pad;
  const int64_t start = (int64_t)(blk0 + blockIdx.y) * hop;

  // the window, samples [start, start + 128 N1) of one channel, into rows of
  // WS floats by 4-byte cp.async, zeros past L
  for (int i = tid; i < N1 * kN2; i += kTcThreads) {
    const int64_t p = start + i;
    const bool in = p < l_pad;
    tc_mac::cp_async4(win + (i >> 7) * WS + (i & (kN2 - 1)), xs + (in ? p : 0), in ? 4 : 0);
  }
  tc_mac::cp_async_wait_all();
  __syncthreads();

  // stage 1: the N1-point DFT of each column pair A[., c] + i A[., c + 64]
  col_dft_tc<N1, X3, false>(
      frag, fac + P::kOffCT, z,
      [&](int c, int j) { return make_float2(win[j * WS + c], win[j * WS + c + kPairs]); },
      [&](int c, int k, float2 v) { z[zi<N1>(k, c)] = v; });
  __syncthreads();

  // split Z into the two columns' one-sided spectra (as fused1d_spectra) and
  // the twiddle, C[k1, .] into the row plane; its row H zero
  for (int i = tid; i < H * kPairs; i += kTcThreads) {
    const int c = i & (kPairs - 1), k1 = i >> 6;
    const float2 zk = z[zi<N1>(k1, c)], zm = z[zi<N1>((N1 - k1) & (N1 - 1), c)];
    const float2 xa = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
    const float2 xb = make_float2(0.5f * (zk.y + zm.y), 0.5f * (zm.x - zk.x));
    rp[tc_mac::sw<kN2>(k1, c)] = cmulw_rn<false>(xa, __ldg(tw + k1 * kN2 + c));
    rp[tc_mac::sw<kN2>(k1, c + kPairs)] = cmulw_rn<false>(xb, __ldg(tw + k1 * kN2 + c + kPairs));
  }
  for (int i = tid; i < kN2; i += kTcThreads) rp[H * kN2 + i] = make_float2(0.f, 0.f);
  __syncthreads();

  // stage 2: the 128-point DFT of each row, D out in natural bin order
  float2* dout = d + ((int64_t)blockIdx.y * batch * cin + blockIdx.x) * P::kPlane;
  rows_tc<X3, false>(rp, H, frag + T::kR16F, frag + T::kR8F, fac + P::kOffRT,
                     [&](int k1, int bin, float2 v) { dout[k1 * kN2 + bin] = v; });
}

// The MAC stage of the tensor-core route, grid (unit blocks, N1/2+1 bin
// rows, groups x output-channel blocks): for one bin row k1, units [u0, u0 +
// nu) of this launch (a unit is one overlap-save block of one batch row,
// block * B + b) and output channels [oc0, oc0 + oc) of group g, Y[u, o] =
// sum_c D[u, c] K[o, c] in FP32 (tc_mac.cuh: mac_rows, one read of D's rows
// for every output channel of the block), then the conjugated 128-point row
// DFT of those nu * oc rows (rows_tc), Y's rows out in natural order.
template <int N1, int MODE>
__global__ void __launch_bounds__(kTcThreads, 2)
fused1d_mac_tc(const float2* __restrict__ d,       // (units of this launch, Cin, N1/2+1, 128)
               const float2* __restrict__ ks,      // (Cout, N1/2+1, Cin/g, 128), conjugated
               const uint32_t* __restrict__ frag,  // fused1d.py: _tc_fragments
               const float2* __restrict__ fac,     // factors, fused1d.py: _device_consts
               float2* __restrict__ y,             // (units of this launch, Cout, N1/2+1, 128)
               int units, int cin, int cout, int groups, int upb, int ocb) {
  using P = Plan<N1>;
  using T = TcPlan<N1>;
  constexpr bool X3 = MODE == 3;
  constexpr int H = T::kH;
  constexpr int64_t plane = P::kPlane;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* ring = reinterpret_cast<float2*>(smem_raw);
  float2* s_p = ring + kMacStages * kMacKC * kN2;
  int64_t* yrow = reinterpret_cast<int64_t*>(s_p + (size_t)(upb * ocb + 1) / 2 * 2 * kN2);
  const int cpg = cin / groups, og = cout / groups, noc = (og + ocb - 1) / ocb;
  const int g = blockIdx.z / noc, oc0 = (blockIdx.z % noc) * ocb, oc = min(ocb, og - oc0);
  const int u0 = blockIdx.x * upb, nu = min(upb, units - u0), k1 = blockIdx.y;
  const int rows = nu * oc;
  for (int r = threadIdx.x; r < rows; r += kTcThreads)  // read after mac_rows' barriers
    yrow[r] = (((int64_t)(u0 + r / oc) * cout + g * og + oc0 + r % oc) * H + k1) * kN2;
  tc_mac::mac_rows<kN2, kTcThreads, kMacOJ, kMacKC, kMacStages>(
      s_p, ring, d + ((int64_t)u0 * cin + (int64_t)g * cpg) * plane + (int64_t)k1 * kN2,
      cin * plane, plane, ks + ((int64_t)(g * og + oc0) * H + k1) * cpg * kN2,
      (int64_t)H * cpg * kN2, kN2, cpg, nu, oc);
  rows_tc<X3, true>(s_p, rows, frag + T::kR16I, frag + T::kR8I, fac + P::kOffRT,
                    [&](int r, int bin, float2 v) { y[yrow[r] + bin] = v; });
}

// The inverse stage of the tensor-core route, grid (B * Cout, blocks of this
// launch), for one (block, b, o): the c2r's input C from Y, as
// fused1d_mac_inverse forms it (the conjugate twiddle, then the Hermitian
// extensions G[N1 - k] = conj G[k] of columns c and c + 64 as one complex
// column G_c + i G_c+64, bins 0 and N1/2 taken real), read straight from Y;
// then the c2r, the conjugated N1-point DFT of each column pair onto the
// output rows r < V1: the real part at column c, the imaginary part at c +
// 64, 1/N folded into the store.
template <int N1, int MODE>
__global__ void __launch_bounds__(kTcThreads, 2)
fused1d_inverse_tc(const float2* __restrict__ y,       // (units of this launch, Cout, N1/2+1, 128)
                   const uint32_t* __restrict__ frag,  // fused1d.py: _tc_fragments
                   const float2* __restrict__ fac,     // factors, fused1d.py: _device_consts
                   const float2* __restrict__ tw,      // (N1/2+1, 128)
                   float* __restrict__ out,            // (B, Cout, v_total)
                   int blk0, int v1, int64_t hop, int64_t v_total) {
  using P = Plan<N1>;
  constexpr bool X3 = MODE == 3;
  constexpr int NH = N1 / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* cb = reinterpret_cast<float2*>(smem_raw);
  // unit (block, b), output channel o: Y's plane blockIdx.y * B * Cout + b * Cout + o
  const float2* yp = y + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * P::kPlane;
  for (int i = threadIdx.x; i < N1 * kPairs; i += kTcThreads) {
    const int c = i & (kPairs - 1), k = i >> 6, kk = k <= NH ? k : N1 - k;
    const float2 ga = cmulw_rn<true>(__ldg(yp + kk * kN2 + c), __ldg(tw + kk * kN2 + c));
    const float2 gb =
        cmulw_rn<true>(__ldg(yp + kk * kN2 + c + kPairs), __ldg(tw + kk * kN2 + c + kPairs));
    const float s = k < NH ? 1.f : -1.f;  // bin N1 - k takes the conjugates
    cb[qi(k, c)] = k == 0 || k == NH ? make_float2(ga.x, gb.x)
                                     : make_float2(ga.x - s * gb.y, s * ga.y + gb.x);
  }
  __syncthreads();

  const float scale = 1.f / (float)(N1 * kN2);
  float* orow = out + (int64_t)blockIdx.x * v_total;
  const int64_t base = (int64_t)(blk0 + blockIdx.y) * hop;
  col_dft_tc<N1, X3, true>(
      frag, fac + P::kOffCT, cb, [&](int c, int k) { return cb[qi(k, c)]; },
      [&](int c, int r, float2 v) {
        const int64_t pos = base + (int64_t)r * kN2 + c;
        if (r < v1 && pos < v_total) orow[pos] = v.x * scale;
        if (r < v1 && pos + kPairs < v_total) orow[pos + kPairs] = v.y * scale;
      });
}

template <int N1, int MODE>
cudaError_t launch_tc(const float* x, int64_t l_pad, const float2* ks, const uint32_t* frag,
                      const float2* fac, const float2* tw, float2* d, float2* y, float* out,
                      int batch, int cin, int cout, int groups, int v1, int blk0, int nblk,
                      int64_t v_total, int upb, int ocb, cudaStream_t stream) {
  using T = TcPlan<N1>;
  if (v1 < 1 || v1 > N1 || nblk < 1 || nblk > 65535 || blk0 < 0 || groups < 1 ||
      cin % groups || cout % groups || upb < 1 || ocb < 1 || upb * ocb > kMacPlaneRows)
    return cudaErrorInvalidValue;
  const auto spectra = fused1d_spectra_tc<N1, MODE>;
  const auto mac = fused1d_mac_tc<N1, MODE>;
  const auto inverse = fused1d_inverse_tc<N1, MODE>;
  cudaError_t err = cudaFuncSetAttribute(spectra, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)T::kSpectraSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mac, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)mac_smem_bytes(kMacPlaneRows));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(inverse, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)T::kInverseSmem);
  if (err != cudaSuccess) return err;

  const int64_t hop = (int64_t)v1 * kN2;
  spectra<<<dim3(batch * cin, nblk), kTcThreads, T::kSpectraSmem, stream>>>(
      x, l_pad, hop, frag, fac, tw, d, blk0, batch, cin);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int units = nblk * batch, og = cout / groups;
  const dim3 mac_grid((units + upb - 1) / upb, T::kH, groups * ((og + ocb - 1) / ocb));
  mac<<<mac_grid, kTcThreads, mac_smem_bytes(upb * ocb), stream>>>(d, ks, frag, fac, y, units,
                                                                   cin, cout, groups, upb, ocb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  inverse<<<dim3(batch * cout, nblk), kTcThreads, T::kInverseSmem, stream>>>(
      y, frag, fac, tw, out, blk0, v1, hop, v_total);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_tc_n1(int n1, const float* x, int64_t l_pad, const float2* ks,
                         const uint32_t* frag, const float2* fac, const float2* tw, float2* d,
                         float2* y, float* out, int batch, int cin, int cout, int groups, int v1,
                         int blk0, int nblk, int64_t v_total, int upb, int ocb,
                         cudaStream_t stream) {
#define FUSED1D_TC_LAUNCH(N1)                                                                \
  if (n1 == N1)                                                                              \
    return launch_tc<N1, MODE>(x, l_pad, ks, frag, fac, tw, d, y, out, batch, cin, cout,     \
                               groups, v1, blk0, nblk, v_total, upb, ocb, stream);
  FUSED1D_TC_LAUNCH(16)
  FUSED1D_TC_LAUNCH(32)
  FUSED1D_TC_LAUNCH(64)
#undef FUSED1D_TC_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// Runs overlap-save blocks [blk0, blk0 + nblk) of one convolution.
// x (B, Cin, l_pad) f32; ks (Cout, N1/2+1, Cin/groups, 128) complex; fac the
// factor vector of fused1d.py:_device_consts and tw (N1/2+1, 128) complex;
// d scratch (nblk, B, Cin, N1/2+1, 128) complex; out (B, Cout, v_total) f32.
// Complex arrays are interleaved (re, im) float pairs. Returns
// cudaGetLastError() after the two launches (0 when both were accepted).
extern "C" int fused1d_forward(const void* x, long long l_pad, const void* ks, const void* fac,
                               const void* tw, void* d, void* out, int batch, int cin,
                               int cout, int groups, int n1, int v1, int blk0, int nblk,
                               long long v_total, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* ksc = static_cast<const float2*>(ks);
  const auto* facc = static_cast<const float2*>(fac);
  const auto* twc = static_cast<const float2*>(tw);
  auto* dc = static_cast<float2*>(d);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n1) {
    case 16:
      return launch<16>(xf, l_pad, ksc, facc, twc, dc, of, batch, cin, cout, groups, v1, blk0,
                        nblk, v_total, s);
    case 32:
      return launch<32>(xf, l_pad, ksc, facc, twc, dc, of, batch, cin, cout, groups, v1, blk0,
                        nblk, v_total, s);
    case 64:
      return launch<64>(xf, l_pad, ksc, facc, twc, dc, of, batch, cin, cout, groups, v1, blk0,
                        nblk, v_total, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// fused1d_forward under a tensor-core mode: mode 3 is "bf16x3", 1 is
// "bf16"; frag the fragment buffer of fused1d.py:_tc_fragments(n1); y
// scratch (nblk, B, Cout, n1/2+1, 128) complex for the MAC stage's output;
// upb and ocb the units (block, batch row) and the output channels of a MAC
// block (fused1d.py: _tc_geometry), upb * ocb at most
// fused1d_tc_plane_rows(); the other arguments as fused1d_forward's.
// Returns cudaGetLastError() after the three launches (0 when all were
// accepted).
extern "C" int fused1d_forward_tc(const void* x, long long l_pad, const void* ks,
                                  const void* frag, const void* fac, const void* tw, void* d,
                                  void* y, void* out, int batch, int cin, int cout, int groups,
                                  int n1, int mode, int v1, int blk0, int nblk, long long v_total,
                                  int upb, int ocb, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* ksc = static_cast<const float2*>(ks);
  const auto* fr = static_cast<const uint32_t*>(frag);
  const auto* facc = static_cast<const float2*>(fac);
  const auto* twc = static_cast<const float2*>(tw);
  auto* dc = static_cast<float2*>(d);
  auto* yc = static_cast<float2*>(y);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (mode == 3)
    return launch_tc_n1<3>(n1, xf, l_pad, ksc, fr, facc, twc, dc, yc, of, batch, cin, cout,
                           groups, v1, blk0, nblk, v_total, upb, ocb, s);
  if (mode == 1)
    return launch_tc_n1<1>(n1, xf, l_pad, ksc, fr, facc, twc, dc, yc, of, batch, cin, cout,
                           groups, v1, blk0, nblk, v_total, upb, ocb, s);
  return cudaErrorInvalidValue;
}

// The rows of the tensor-core route's MAC-stage plane, which bound upb *
// ocb (fused1d.py: _TC_PLANE_ROWS; a card test holds the two equal).
extern "C" int fused1d_tc_plane_rows() { return kMacPlaneRows; }

// The CUDA runtime's message for an error code returned above.
extern "C" const char* fused1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
