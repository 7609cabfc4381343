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
// B2's time. Serving several output channels per read of D, tensor cores,
// TMA staging and fusing the two phases are left for later work.
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
// fused2d.py:52-71, whose modes reach every DFT product of the 2D body through
// _dot). A second pair, fused2d_spectra_tc and fused2d_mac_inverse_tc <T1, T2,
// MODE> (entry point fused2d_forward_tc), runs B2's two phases on B2's plan,
// grid, swizzled NB1 x T2 plane, staging and scratch D, with every DFT step a
// bf16 mma.sync product with an FP32 accumulator (bf16_mma.cuh: dft_step),
// as the TPU kernel forms each DFT product from bf16 operands under those
// modes: the W DFT of the packed rows, the one-sided H DFT, the inverse W DFT
// and the H irfft of column pairs, each factored as B2 factors it (16 * 8,
// 16 * 16, 24 * 16; a 24-point step is three whole k-steps of 16, so nothing
// is padded), each step's matrix read as B fragments from the host's
// buffer (fused2d.py: _tc_fragments). Factored and not dense on both axes:
// a dense 128-point step would do 5x the products of 16 * 8, and its
// matrices (hi and lo, forward and conjugated) would take 512 KB where all
// the factored steps' take 28 KB, re-read by every warp. The operands stay FP32 in the plane, and a warp splits them
// into bf16 hi/lo as it loads its tile's A fragments, so that one plane
// serves every mode and fits a block at T1 = 384 (a split plane would need a
// second one to write into). Each step runs in place: a warp loads all of
// its 16 vectors before it stores any output, into the same slots, so a row
// DFT leaves bin m1 + A m2 at column m1 B + m2 (tc_col) and its readers (the
// H DFT, the H irfft) index through that permutation; D keeps B2's natural
// order. The twiddles (rounded as the plain version rounds them, without
// FMA: a bf16 rounding that goes the other way early in a tile spreads
// through its later steps), the split of the packed pairs, the MAC, the
// Hermitian extension and 1/(T1 T2) stay FP32. What bounds this pair is the
// chain each warp runs per tile of 16 vectors (shared-memory loads, the
// products, the stores) between the barriers of the steps, and phase 2's MAC
// re-reading D and the spectra through L2, FP32 in every mode; so each
// step's lanes are placed (tile_rows, stg, the H steps' vector order) for
// their loads and stores to reach 16 distinct bank pairs, where the first
// version's H loaders met 4- and 8-way conflicts through tc_col.

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

// Phase 1 of B5: the window's tile spectra, H first. Writes D as B2's D in
// split planes [dr; di] (tiles of this launch, B * Cin, 2, NB1, T2).
template <int T1, int T2>
__global__ void __launch_bounds__(kThreads, B2Plan<T1, T2>::kMinBlocks)
fused2d_v3_spectra(const float* __restrict__ x,    // (B, Cin, hp, wp)
                   const float2* __restrict__ fac,  // factors, fused2d.py: _device_factors
                   float* __restrict__ d,           // (tiles of this launch, B * Cin, 2, NB1, T2)
                   int hp, int wp, int v1, int v2, int nt2, int tile0) {
  using P = B2Plan<T1, T2>;
  constexpr int A1 = P::kA1, B1 = P::kB1, G = P::kG, N1 = T1 / 2, N2 = T2 / 2;
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
      for (int m2 = 0; m2 < B1; ++m2) {
        const int k1 = m1 + A1 * m2;
        s_p[k1 < N1 ? sw<T2>(k1, q) : sw<T2>(k1 == N1 ? 0 : T1 - k1, q + N2)] = u[m2];
      }
    }
    __syncthreads();  // the staging is read before the next pass overwrites it
  }

  // split each Z into its two columns' one-sided bins, in place:
  // X_q[k] = (Z[k] + conj Z[-k]) / 2, X_q+T2/2[k] = (Z[k] - conj Z[-k]) / 2i;
  // row 0 holds Z[0] and Z[T1/2], where both columns are real
  for (int i = tid; i < N1 * N2; i += kThreads) {
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

// h[n, l] of the folded H inverse, l in [0, T2/2]: row n of column l for
// n < NB1, else row n - NB1 of column T2 - l; columns 0 and T2/2 share their
// slots as the real and imaginary parts of one value (in column 0, then T2/2)
template <int T1, int T2>
__device__ __forceinline__ float2 folded_h(const float2* s_p, int n, int l) {
  constexpr int NB1 = T1 / 2 + 1, N2 = T2 / 2;
  const int c = l == N2 ? 0 : l, m = c == 0 ? N2 : T2 - c;
  const float2 z = n < NB1 ? s_p[sw<T2>(n, c)] : s_p[sw<T2>(n - NB1, m)];
  return c != 0 ? z : make_float2(l == 0 ? z.x : z.y, 0.f);
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
  constexpr int A1 = P::kA1, B1 = P::kB1, A2 = P::kA2, B2 = P::kB2, G = P::kG;
  constexpr int N1 = T1 / 2, N2 = T2 / 2, NB1 = P::kNB1;
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
      const int g = t % G, j2 = t / G, l = c0 + g, m = l == 0 ? N2 : T2 - l;
      float2 v[A1];
#pragma unroll
      for (int j1 = 0; j1 < A1; ++j1) {
        const int k = j1 * B1 + j2, kk = k <= N1 ? k : T1 - k;
        const bool mid = k == 0 || k == N1;
        if (l == 0) {  // S_0 + i S_T2/2; both S are Hermitian
          const float2 a = s_p[sw<T2>(kk, 0)], e = s_p[sw<T2>(kk, N2)];
          v[j1] = mid ? make_float2(a.x, e.x)
                      : k < N1 ? make_float2(a.x - e.y, a.y + e.x)
                               : make_float2(a.x + e.y, e.x - a.y);
        } else if (mid) {
          const float2 a = s_p[sw<T2>(kk, l)], e = s_p[sw<T2>(kk, m)];
          v[j1] = make_float2(0.5f * (a.x + e.x), 0.5f * (a.y - e.y));
        } else if (k < N1) {
          v[j1] = s_p[sw<T2>(kk, l)];
        } else {
          const float2 e = s_p[sw<T2>(kk, m)];
          v[j1] = make_float2(e.x, -e.y);
        }
      }
      short_dft<A1, true>(v, s.ra1);
#pragma unroll
      for (int m1 = 0; m1 < A1; ++m1)
        s.stage[(m1 * B1 + j2) * G + g] =
            m1 == 0 ? v[0] : cmulw<true>(v[m1], s.tw1[m1 * B1 + j2]);
    }
    __syncthreads();
    for (int t = tid; t < G * A1; t += kThreads) {
      const int g = t % G, m1 = t / G, l = c0 + g, m = l == 0 ? N2 : T2 - l;
      float2 u[B1];
#pragma unroll
      for (int j2 = 0; j2 < B1; ++j2) u[j2] = s.stage[(m1 * B1 + j2) * G + g];
      short_dft<B1, true>(u, s.rb1);
#pragma unroll
      for (int m2 = 0; m2 < B1; ++m2) {
        const int n = m1 + A1 * m2;
        if (n < v1) s_p[n < NB1 ? sw<T2>(n, l) : sw<T2>(n - NB1, m)] = u[m2];
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
      for (int j1 = 0; j1 < A2; ++j1) {
        const int c = j1 * B2 + j2, l = c <= N2 ? c : T2 - c;
        const float2 e0 = folded_h<T1, T2>(s_p, r, l);
        const float2 e1 = two ? folded_h<T1, T2>(s_p, r + 1, l) : make_float2(0.f, 0.f);
        v[j1] = c <= N2 ? make_float2(e0.x - e1.y, e0.y + e1.x)   // E0 + i E1
                        : make_float2(e0.x + e1.y, e1.x - e0.y);  // conj(E0) + i conj(E1)
      }
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

// ---- B2's tensor-core pair (the modes "bf16x3" and "bf16") -------------------

constexpr int kWarps = kThreads / 32;

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

// Vector m of a row step's step 2, of NVEC: each whole block of 16 vectors
// keeps its vectors, but lane group g takes the block's vectors 2g and 2g + 1
// (rows r + 2g and r + 2g + 1), so that its 4 elements of 8 rows (columns
// m1 B + t) fall in 16 distinct bank pairs of the swizzled plane. A partial
// last block keeps its order.
template <int NVEC>
__device__ __forceinline__ int tile_rows(int m) {
  if (m >= (NVEC & ~15)) return m;
  return (m & ~15) | ((m & 7) << 1) | ((m >> 3) & 1);
}

// Index of (column c of a pass, element k) in the staging of an H pass: column
// by column, bits 2 and 3 of k swizzled by c + k / 16, so that a lane group
// of step 1 (8 consecutive j2 of one column, 4 m1) and one of step 2 (8
// columns, 4 consecutive j2) each reach 16 distinct bank pairs.
template <int T1>
__device__ __forceinline__ int stg(int c, int k) {
  return c * T1 + (k ^ (((c + (k >> 4)) & 3) << 2));
}

// In-place DFT (INV: conjugated, unscaled) of the NROWS rows of the plane,
// T = A * B, on the tensor cores. Step 1: vector (row, j2) = element j1 at
// column j1 B + j2, its A-point DFT and then the twiddle tw[m1 B + j2] in FP32,
// back at column m1 B + j2. Step 2: vector (row, m1) = element j2 at column
// m1 B + j2, its B-point DFT, back in the same columns: bin m1 + A m2 at
// column m1 B + m2 (tc_col). Both steps leave each vector in its own slots,
// so they need no second plane. Ends with a barrier.
template <int T, int NROWS, bool X3, bool INV>
__device__ __forceinline__ void row_dft_tc(float2* s_p, const uint32_t* __restrict__ frag,
                                           const float2* tw) {
  constexpr int A = split_a(T), B = split_b(T);
  bf16_mma::dft_step<A, X3, kWarps>(
      NROWS * B, frag + bf16_mma::frag_offset(A, INV),
      [&](int m, int j1) { return s_p[sw<T>(m % NROWS, j1 * B + m / NROWS)]; },
      [&](int m, int m1, float2 v) {
        const int j2 = m / NROWS;
        s_p[sw<T>(m % NROWS, m1 * B + j2)] = m1 == 0 ? v : cmulw_rn<INV>(v, tw[m1 * B + j2]);
      });
  __syncthreads();
  bf16_mma::dft_step<B, X3, kWarps>(
      NROWS * A, frag + bf16_mma::frag_offset(B, INV),
      [&](int m, int j2) {
        m = tile_rows<NROWS * A>(m);
        return s_p[sw<T>(m % NROWS, (m / NROWS) * B + j2)];
      },
      [&](int m, int m2, float2 v) {
        m = tile_rows<NROWS * A>(m);
        s_p[sw<T>(m % NROWS, (m / NROWS) * B + m2)] = v;
      });
  __syncthreads();
}

// Phase 1 under a tensor-core mode (MODE 3: "bf16x3", 1: "bf16"):
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

  // W DFT of the packed rows: Z_r[k] = X_2r[k] + i X_2r+1[k], bin k at tc_col(k)
  row_dft_tc<T2, N1, X3, false>(s_p, frag, s.tw2);

  // H DFT of column col of X, col in [1, T2/2), or of X[., 0] + i X[., T2/2]
  // for col = 0, G columns a pass: step 1 splits the W bins k and -k of the
  // packed rows in FP32 as it loads them (as fused2d_spectra), runs the
  // A1-point DFT of each (col, j2) (lanes on j2, so that a load reads one
  // column's rows) and the twiddle into the staging at (col, m1 B1 + j2);
  // step 2 runs the B1-point DFT of each (col, m1) (lanes on columns, so
  // that D's stores are row segments) and writes the bins k1 = m1 + A1 m2
  // to D in natural order
  float2* dout = d + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * P::kPlane;
  for (int c0 = 0; c0 < N2; c0 += G) {
    bf16_mma::dft_step<A1, X3, kWarps>(
        G * B1, frag + bf16_mma::frag_offset(A1, false),
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
        [&](int m, int m1, float2 v) {
          const int j2 = m % B1;
          s.stage[stg<T1>(m / B1, m1 * B1 + j2)] =
              m1 == 0 ? v : cmulw_rn<false>(v, s.tw1[m1 * B1 + j2]);
        });
    __syncthreads();
    bf16_mma::dft_step<B1, X3, kWarps>(
        G * A1, frag + bf16_mma::frag_offset(B1, false),
        [&](int m, int j2) { return s.stage[stg<T1>(m % G, (m / G) * B1 + j2)]; },
        [&](int m, int m2, float2 v) {
          const int col = c0 + m % G, k1 = m / G + A1 * m2;
          if (col == 0) {
            s.packed[k1] = v;
          } else {
            if (k1 <= N1) dout[k1 * T2 + col] = v;
            if (k1 == 0 || k1 >= N1)  // D[-k1, -col] = conj X[k1, col]
              dout[((T1 - k1) % T1) * T2 + T2 - col] = make_float2(v.x, -v.y);
          }
        });
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

// Phase 2 under a tensor-core mode: fused2d_mac_inverse's function, every
// DFT step a bf16 product; the MAC is FP32 as in every mode.
template <int T1, int T2, int MODE>
__global__ void __launch_bounds__(kThreads, B2Plan<T1, T2>::kMinBlocks)
fused2d_mac_inverse_tc(const float2* __restrict__ d,       // (tiles of this launch, B * Cin, NB1, T2)
                       const float2* __restrict__ ks,      // (Cout, Cin/g, NB1, T2), conjugated
                       const uint32_t* __restrict__ frag,  // fused2d.py: _tc_fragments
                       const float2* __restrict__ fac,     // factors, fused2d.py: _device_factors
                       float* __restrict__ out,            // (B, Cout, oh, ow)
                       int batch, int cin, int cout, int groups, int v1, int v2, int nt2,
                       int tile0, int oh, int ow) {
  using P = B2Plan<T1, T2>;
  constexpr bool X3 = MODE == 3;
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

  // inverse W DFT of the NB1 rows in place, sample n at tc_col(n)
  row_dft_tc<T2, P::kNB1, X3, true>(s_p, frag, s.tw2);

  // H irfft of columns 2q and 2q + 1 at once, G pairs a pass: the inverse
  // DFT of c = H_2q + i H_2q+1, H the Hermitian extension of a one-sided
  // column (formed in FP32 as step 1 loads it, as fused2d_mac_inverse), whose
  // real and imaginary parts are the two output columns; step 1 (lanes on
  // the bins of one pair) into the staging with the conjugate twiddle, step 2
  // (lanes on pairs) onto the output rows m1 + A1 m2, of which the V1 valid
  // ones are stored with 1/(T1 T2)
  const float scale = 1.f / (float)(T1 * T2);
  float* oplane = out + ((int64_t)b * cout + o) * oh * ow;
  for (int c0 = 0; c0 < N2; c0 += G) {
    bf16_mma::dft_step<A1, X3, kWarps>(
        G * B1, frag + bf16_mma::frag_offset(A1, true),
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
        [&](int m, int m1, float2 v) {
          const int j2 = m % B1;
          s.stage[stg<T1>(m / B1, m1 * B1 + j2)] =
              m1 == 0 ? v : cmulw_rn<true>(v, s.tw1[m1 * B1 + j2]);
        });
    __syncthreads();
    bf16_mma::dft_step<B1, X3, kWarps>(
        G * A1, frag + bf16_mma::frag_offset(B1, true),
        [&](int m, int j2) { return s.stage[stg<T1>(m % G, (m / G) * B1 + j2)]; },
        [&](int m, int m2, float2 v) {
          const int z = 2 * (c0 + m % G), ox = w0 + z, vr = m / G + A1 * m2, oy = h0 + vr;
          if (vr < v1 && oy < oh) {
            float* row = oplane + (int64_t)oy * ow + ox;
            if (z < v2 && ox < ow) row[0] = v.x * scale;
            if (z + 1 < v2 && ox + 1 < ow) row[1] = v.y * scale;
          }
        });
    __syncthreads();  // the staging is read before the next pass overwrites it
  }
}

template <int T1, int T2, int MODE>
cudaError_t launch_tc(const float* x, const float2* ks, const uint32_t* frag, const float2* fac,
                      float2* d, float* out, int batch, int cin, int cout, int groups, int hp,
                      int wp, int v1, int v2, int nt2, int tile0, int ntile, int oh, int ow,
                      cudaStream_t stream) {
  constexpr size_t smem = B2Plan<T1, T2>::kSmem;
  if (v1 < 1 || v1 > T1 || v2 < 1 || v2 > T2 || nt2 < 1 || ntile < 1 || ntile > 65535 ||
      tile0 < 0 || groups < 1 || cin % groups || cout % groups)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused2d_spectra_tc<T1, T2, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused2d_mac_inverse_tc<T1, T2, MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  fused2d_spectra_tc<T1, T2, MODE><<<dim3(batch * cin, ntile), kThreads, smem, stream>>>(
      x, frag, fac, d, hp, wp, v1, v2, nt2, tile0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused2d_mac_inverse_tc<T1, T2, MODE><<<dim3(batch * cout, ntile), kThreads, smem, stream>>>(
      d, ks, frag, fac, out, batch, cin, cout, groups, v1, v2, nt2, tile0, oh, ow);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_tc_plan(int t1, int t2, const float* x, const float2* ks,
                           const uint32_t* frag, const float2* fac, float2* d, float* out,
                           int batch, int cin, int cout, int groups, int hp, int wp, int v1,
                           int v2, int nt2, int tile0, int ntile, int oh, int ow,
                           cudaStream_t stream) {
#define FUSED2D_TC_LAUNCH(T1, T2)                                                          \
  if (t1 == T1 && t2 == T2)                                                                \
    return launch_tc<T1, T2, MODE>(x, ks, frag, fac, d, out, batch, cin, cout, groups, hp, \
                                   wp, v1, v2, nt2, tile0, ntile, oh, ow, stream);
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
// frag the fragment buffer of fused2d.py:_tc_fragments, the other arguments
// as fused2d_forward's. Returns cudaGetLastError() after the two launches (0
// when both were accepted).
extern "C" int fused2d_forward_tc(const void* x, const void* ks, const void* frag,
                                  const void* fac, void* d, void* out, int batch, int cin,
                                  int cout, int groups, int hp, int wp, int t1, int t2, int mode,
                                  int v1, int v2, int nt2, int tile0, int ntile, int oh, int ow,
                                  void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* ksc = static_cast<const float2*>(ks);
  const auto* fr = static_cast<const uint32_t*>(frag);
  const auto* fc = static_cast<const float2*>(fac);
  auto* dc = static_cast<float2*>(d);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (mode == 3)
    return launch_tc_plan<3>(t1, t2, xf, ksc, fr, fc, dc, of, batch, cin, cout, groups, hp, wp,
                             v1, v2, nt2, tile0, ntile, oh, ow, s);
  if (mode == 1)
    return launch_tc_plan<1>(t1, t2, xf, ksc, fr, fc, dc, of, batch, cin, cout, groups, hp, wp,
                             v1, v2, nt2, tile0, ntile, oh, ow, s);
  return cudaErrorInvalidValue;
}

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
