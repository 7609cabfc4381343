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
// on the "v3" schedule, where re and im are stacked into the rows of REAL
// products. Per tile: one product [fr; fi] (2 NB1 x T1) . window gives
// [hr; hi]; two stacked products of it with wr and wi are recombined into
// dr = hr wr - hi wi and di = hr wi + hi wr; the MAC is B2's; the inverse runs
// H first on the stacked Y = [yr; yi]: zr = [cr | ci] . Y and zi = [-ci | cr] . Y
// on the V1 valid rows only, then out = [zr | zi] . [ur; -ui], one real product
// whose result is the real output. The TPU pads NB1 to a multiple of 8 rows for
// its sublanes; B5 does not. Every DFT is a dense FP32 FMA panel product with
// the thread tile of v3_panel_fma (4 columns a thread in each 128-column group,
// 8 row groups, float4 shared-memory loads); phase 2 runs the inverse in chunks
// of 16 output rows so that [zr | zi] never takes more than 16 x 2 T2 floats
// beside the stacked Y. At the benchmark shapes it does 10-14 GFLOP a call, so
// the FP32 CUDA-core rate bounds it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // a Hopper block's shared memory

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// Rows of an m-row product are computed in n passes of `rows` rows each
// (the last may be shorter), at most rows_max per pass.
struct Passes {
  int n, rows;
};

__device__ __forceinline__ Passes split_rows(int m, int rows_max) {
  const int n = (m + rows_max - 1) / rows_max;
  return {n, (m + n - 1) / n};
}

// ---- Kernel B2: factored DFTs ------------------------------------------------

// The four-step split T = A * B of a DFT length T in {128, 256, 384}
// (fused2d.py: _SPLITS).
__host__ __device__ constexpr int split_a(int t) { return t == 384 ? 24 : 16; }
__host__ __device__ constexpr int split_b(int t) { return t == 128 ? 8 : 16; }
// columns (phase 1) or column pairs (phase 2) of one H pass through the staging
__host__ __device__ constexpr int stage_cols(int t1) { return t1 >= 384 ? 8 : 32; }

// One block's dynamic shared memory, either phase: the NB1 x T2 plane, the
// staging (G x T1), the packed DC/Nyquist column (T1) and the factors (A and
// B roots and the twiddle of each axis), all float2. Past T1 = 384 the plane
// alone, which is already more than a block can hold.
__host__ __device__ constexpr size_t smem_bytes(int t1, int t2) {
  return t1 > 384 ? sizeof(float2) * (size_t)(t1 / 2 + 1) * t2
                  : sizeof(float2) * ((size_t)(t1 / 2 + 1) * t2 + (size_t)stage_cols(t1) * t1 +
                                      t1 + split_a(t1) + split_b(t1) + t1 + split_a(t2) +
                                      split_b(t2) + t2);
}

template <int T1, int T2>
struct B2Plan {
  static constexpr int kA1 = split_a(T1), kB1 = split_b(T1);
  static constexpr int kA2 = split_a(T2), kB2 = split_b(T2);
  static constexpr int kNB1 = T1 / 2 + 1, kG = stage_cols(T1);
  static constexpr int kPlane = kNB1 * T2, kStage = kG * T1;
  static constexpr int kFac = kA1 + kB1 + T1 + kA2 + kB2 + T2;
  static constexpr size_t kSmem = smem_bytes(T1, T2);
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

// Shared memory of a B2 block: plane, staging, packed column, factors.
template <int T1, int T2>
struct B2Smem {
  float2 *plane, *stage, *packed, *ra1, *rb1, *tw1, *ra2, *rb2, *tw2;

  // carves the dynamic shared memory and stages the factors (no barrier)
  __device__ __forceinline__ B2Smem(unsigned char* raw, const float2* __restrict__ fac) {
    using P = B2Plan<T1, T2>;
    plane = reinterpret_cast<float2*>(raw);
    stage = plane + P::kPlane;
    packed = stage + P::kStage;
    ra1 = packed + T1;
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

// ---- Kernel B5: the v3 schedule ----------------------------------------------

constexpr int kV3ColThreads = 32;                        // threads across columns
constexpr int kV3RowGroups = kThreads / kV3ColThreads;   // interleaved row groups

template <int T2>
struct V3Cfg {
  static constexpr int kCG = T2 / 128;     // a thread's columns: 128 g + 4 cl + c, g < kCG
  static constexpr int kKC = 4096 / T2;    // contraction panel
  static constexpr int kRptH = 8 / kCG;    // H forward: rows a thread per pass
  // W forward: row pairs a thread per pass; one at T2 = 256, where four
  // products' float4 panels of 256 columns are in flight at once
  static constexpr int kRptW = kCG == 1 ? 4 : 1;
  static constexpr int kRptI = 2;          // inverse: rows a thread per chunk
  static constexpr int kChunk = kV3RowGroups * kRptI;  // output rows a chunk (16)
  // panels (floats) beside the stacked matrix: phase 1 stages an H-forward
  // row panel and a window panel, or a wr and a wi panel; phase 2 holds the
  // [zr | zi] chunk and either a cz1 and a cz2 row panel or a u2 panel
  static constexpr size_t kPhase1 =
      cmax((size_t)kV3RowGroups * kRptH * kKC + (size_t)kKC * T2, (size_t)2 * kKC * T2);
  static constexpr size_t kPhase2 =
      (size_t)kChunk * 2 * T2 + cmax((size_t)2 * kChunk * kKC, (size_t)kKC * T2);
  static size_t smem(int nb1) {
    return sizeof(float) * ((size_t)2 * nb1 * T2 + cmax(kPhase1, kPhase2));
  }
};

// Number of this thread's interleaved rows rg, rg + 8, ... below nrow.
__device__ __forceinline__ int v3_own_rows(int nrow, int rg) {
  return nrow > rg ? (nrow - rg + kV3RowGroups - 1) / kV3RowGroups : 0;
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

template <int RPT, int CG>
__device__ __forceinline__ void v3_zero(float (&acc)[RPT][CG][4]) {
#pragma unroll
  for (int q = 0; q < RPT; ++q)
#pragma unroll
    for (int g = 0; g < CG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[q][g][c] = 0.f;
}

__device__ __forceinline__ float4 v3_vec(const float (&v)[4]) {
  return make_float4(v[0], v[1], v[2], v[3]);
}

// acc[q][g][c] += sum_{k < kn} A[q][k] B[k][128 g + 4 cl + c] for q < nq, where
// A[q] is the row of this thread's q-th interleaved row: a + q * 8 * lda (a at
// the row of q = 0; a and lda multiples of 4 floats, in shared memory), and B
// is kn rows of T2 = 128 CG floats in shared memory. Four k at a time: one
// float4 of each A row, one float4 of B per k and column group.
template <int RPT, int CG>
__device__ __forceinline__ void v3_panel_fma(float (&acc)[RPT][CG][4], const float* a, int lda,
                                             int nq, const float* b, int kn) {
  constexpr int T2 = CG * 128;
  const float* bc = b + 4 * (threadIdx.x % kV3ColThreads);
  const int kn4 = kn & ~3;
  for (int k = 0; k < kn4; k += 4) {
    float4 bv[4][CG];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int g = 0; g < CG; ++g)
        bv[j][g] = *reinterpret_cast<const float4*>(bc + (k + j) * T2 + 128 * g);
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      if (q < nq) {
        const float4 av = *reinterpret_cast<const float4*>(a + q * kV3RowGroups * lda + k);
#pragma unroll
        for (int g = 0; g < CG; ++g) {
          fma4(acc[q][g], av.x, bv[0][g]);
          fma4(acc[q][g], av.y, bv[1][g]);
          fma4(acc[q][g], av.z, bv[2][g]);
          fma4(acc[q][g], av.w, bv[3][g]);
        }
      }
    }
  }
  for (int k = kn4; k < kn; ++k) {
    float4 bv[CG];
#pragma unroll
    for (int g = 0; g < CG; ++g)
      bv[g] = *reinterpret_cast<const float4*>(bc + k * T2 + 128 * g);
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      if (q < nq) {
        const float av = a[q * kV3RowGroups * lda + k];
#pragma unroll
        for (int g = 0; g < CG; ++g) fma4(acc[q][g], av, bv[g]);
      }
    }
  }
}

// Copies `rows` dense rows of T2 floats (16-byte aligned) into shared memory.
template <int T2>
__device__ __forceinline__ void v3_stage_dense(float* dst, const float* __restrict__ src,
                                               int rows) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* t = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < rows * T2 / 4; i += kThreads) t[i] = __ldg(s + i);
}

// Copies columns [k0, k0 + kn) of `rows` rows of a matrix with row stride ld
// (src at its first row) into a (rows, KC) panel, zeros past kn.
template <int KC>
__device__ __forceinline__ void v3_stage_rows(float* dst, const float* __restrict__ src, int ld,
                                              int rows, int k0, int kn) {
  for (int i = threadIdx.x; i < rows * KC; i += kThreads) {
    const int k = i % KC;
    dst[i] = k < kn ? __ldg(src + (int64_t)(i / KC) * ld + k0 + k) : 0.f;
  }
}

template <int T2>
__global__ void __launch_bounds__(kThreads, T2 == 128 ? 2 : 1)
fused2d_v3_spectra(const float* __restrict__ x,   // (B, Cin, hp, wp)
                   const float* __restrict__ f2,  // (2 nb1, t1): [fr; fi]
                   const float* __restrict__ wr,  // (T2, T2) W DFT, real part
                   const float* __restrict__ wi,  // (T2, T2) imaginary part
                   float* __restrict__ d,         // (tiles of this launch, B * Cin, 2, nb1, T2)
                   int hp, int wp, int t1, int nb1, int v1, int v2, int nt2, int tile0) {
  using C = V3Cfg<T2>;
  constexpr int CG = C::kCG, KC = C::kKC, RH = C::kRptH, RW = C::kRptW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_b = reinterpret_cast<float*>(smem_raw);  // (2 nb1, T2): [hr; hi]
  float* s_p = s_b + (size_t)2 * nb1 * T2;          // panels

  const int tid = threadIdx.x, cl = tid % kV3ColThreads, rg = tid / kV3ColThreads;
  const int tile = tile0 + blockIdx.y;
  const int h0 = (tile / nt2) * v1, w0 = (tile % nt2) * v2;
  const float* xs = x + (int64_t)blockIdx.x * hp * wp;

  // H forward, one stacked product: s_b = f2 (2 nb1 x t1) . A (t1 x T2), A the
  // real window read straight from the signal (zeros past its edge)
  {
    float* s_f = s_p;                               // (8 RH, KC) rows of f2
    float* s_a = s_p + kV3RowGroups * RH * KC;      // (KC, T2) window rows
    const Passes ps = split_rows(2 * nb1, kV3RowGroups * RH);
    for (int p = 0; p < ps.n; ++p) {
      const int row0 = p * ps.rows, nrow = min(ps.rows, 2 * nb1 - row0);
      const int nq = v3_own_rows(nrow, rg);
      float acc[RH][CG][4];
      v3_zero<RH, CG>(acc);
      for (int k0 = 0; k0 < t1; k0 += KC) {
        v3_stage_rows<KC>(s_f, f2 + (int64_t)row0 * t1, t1, nrow, k0, KC);
        for (int i = tid; i < KC * T2; i += kThreads) {
          const int hr = h0 + k0 + i / T2, wc = w0 + i % T2;
          s_a[i] = (hr < hp && wc < wp) ? __ldg(xs + (int64_t)hr * wp + wc) : 0.f;
        }
        __syncthreads();
        v3_panel_fma<RH, CG>(acc, s_f + rg * KC, KC, nq, s_a, KC);
        __syncthreads();  // the panels are consumed before the next ones overwrite them
      }
#pragma unroll
      for (int q = 0; q < RH; ++q) {
        if (q < nq) {
          float* row = s_b + (size_t)(row0 + rg + q * kV3RowGroups) * T2 + 4 * cl;
#pragma unroll
          for (int g = 0; g < CG; ++g)
            *reinterpret_cast<float4*>(row + 128 * g) = v3_vec(acc[q][g]);
        }
      }
    }
  }
  __syncthreads();

  // W forward, two stacked products recombined in registers: for the row
  // pair (r, nb1 + r) of s_b, dr[r] = hr wr - hi wi and di[r] = hr wi + hi wr,
  // written to the scratch as the planes [dr; di]
  float* dout = d + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * 2 * nb1 * T2;
  float* s_wr = s_p;            // (KC, T2) rows of wr
  float* s_wi = s_p + KC * T2;  // (KC, T2) rows of wi
  const Passes ps = split_rows(nb1, kV3RowGroups * RW);
  for (int p = 0; p < ps.n; ++p) {
    const int row0 = p * ps.rows, nrow = min(ps.rows, nb1 - row0);
    const int nq = v3_own_rows(nrow, rg);
    float rr[RW][CG][4], ri[RW][CG][4], ir[RW][CG][4], ii[RW][CG][4];
    v3_zero<RW, CG>(rr);
    v3_zero<RW, CG>(ri);
    v3_zero<RW, CG>(ir);
    v3_zero<RW, CG>(ii);
    const float* top = s_b + (size_t)(row0 + rg) * T2;  // hr rows
    const float* bot = top + (size_t)nb1 * T2;          // hi rows
    for (int k0 = 0; k0 < T2; k0 += KC) {
      v3_stage_dense<T2>(s_wr, wr + (int64_t)k0 * T2, KC);
      v3_stage_dense<T2>(s_wi, wi + (int64_t)k0 * T2, KC);
      __syncthreads();
      v3_panel_fma<RW, CG>(rr, top + k0, T2, nq, s_wr, KC);
      v3_panel_fma<RW, CG>(ri, top + k0, T2, nq, s_wi, KC);
      v3_panel_fma<RW, CG>(ir, bot + k0, T2, nq, s_wr, KC);
      v3_panel_fma<RW, CG>(ii, bot + k0, T2, nq, s_wi, KC);
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < RW; ++q) {
      if (q < nq) {
        float* row = dout + (int64_t)(row0 + rg + q * kV3RowGroups) * T2 + 4 * cl;
#pragma unroll
        for (int g = 0; g < CG; ++g) {
          float dr[4], di[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            dr[c] = rr[q][g][c] - ii[q][g][c];
            di[c] = ri[q][g][c] + ir[q][g][c];
          }
          *reinterpret_cast<float4*>(row + 128 * g) = v3_vec(dr);
          *reinterpret_cast<float4*>(row + (int64_t)nb1 * T2 + 128 * g) = v3_vec(di);
        }
      }
    }
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

template <int T2>
__global__ void __launch_bounds__(kThreads, T2 == 128 ? 2 : 1)
fused2d_v3_mac_inverse(const float* __restrict__ d,    // (tiles of this launch, B * Cin, 2, nb1, T2)
                       const float* __restrict__ ks,   // (Cout, Cin/g, 2, nb1, T2), conjugated
                       const float* __restrict__ cz1,  // (v1, 2 nb1): [cr | ci]
                       const float* __restrict__ cz2,  // (v1, 2 nb1): [-ci | cr]
                       const float* __restrict__ u2,   // (2 T2, T2): [ur; -ui], 1/T2 folded in
                       float* __restrict__ out,        // (B, Cout, oh, ow)
                       int batch, int cin, int cout, int groups, int nb1, int v1, int v2,
                       int nt2, int tile0, int oh, int ow) {
  using C = V3Cfg<T2>;
  constexpr int CG = C::kCG, KC = C::kKC, RI = C::kRptI, R = C::kChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_y = reinterpret_cast<float*>(smem_raw);  // (2 nb1, T2): [yr; yi]
  float* s_z = s_y + (size_t)2 * nb1 * T2;          // (R, 2 T2): [zr | zi]
  float* s_c1 = s_z + R * 2 * T2;                   // (R, KC) rows of cz1
  float* s_c2 = s_c1 + R * KC;                      // (R, KC) rows of cz2
  float* s_u = s_c1;                                // (KC, T2) rows of u2

  const int tid = threadIdx.x, cl = tid % kV3ColThreads, rg = tid / kV3ColThreads;
  const int b = blockIdx.x / cout, o = blockIdx.x % cout;
  const int cpg = cin / groups, g = o / (cout / groups);
  const int tile = tile0 + blockIdx.y;
  const int h0 = (tile / nt2) * v1, w0 = (tile % nt2) * v2;
  const int64_t plane = (int64_t)nb1 * T2;

  // per-bin MAC over this out-channel's group into the stacked Y = [yr; yi]
  const float* dg = d + (((int64_t)blockIdx.y * batch + b) * cin + (int64_t)g * cpg) * 2 * plane;
  const float* ko = ks + (int64_t)o * cpg * 2 * plane;
  for (int i = tid; i < plane / 4; i += kThreads) {
    float4 yr = make_float4(0.f, 0.f, 0.f, 0.f), yi = yr;
    for (int c = 0; c < cpg; ++c) {
      const float4* dc = reinterpret_cast<const float4*>(dg + c * 2 * plane);
      const float4* kc = reinterpret_cast<const float4*>(ko + c * 2 * plane);
      cmac4(yr, yi, __ldg(dc + i), __ldg(dc + plane / 4 + i), __ldg(kc + i),
            __ldg(kc + plane / 4 + i));
    }
    reinterpret_cast<float4*>(s_y)[i] = yr;
    reinterpret_cast<float4*>(s_y + plane)[i] = yi;
  }
  __syncthreads();

  // the inverse in chunks of R valid rows: H first on the stacked Y, then W
  float* oplane = out + ((int64_t)b * cout + o) * oh * ow;
  const int kz = 2 * nb1;
  for (int r0 = 0; r0 < v1; r0 += R) {
    const int nrow = min(R, v1 - r0), nq = v3_own_rows(nrow, rg);
    float zr[RI][CG][4], zi[RI][CG][4];
    v3_zero<RI, CG>(zr);
    v3_zero<RI, CG>(zi);
    for (int k0 = 0; k0 < kz; k0 += KC) {
      const int kn = min(KC, kz - k0);
      v3_stage_rows<KC>(s_c1, cz1 + (int64_t)r0 * kz, kz, nrow, k0, kn);
      v3_stage_rows<KC>(s_c2, cz2 + (int64_t)r0 * kz, kz, nrow, k0, kn);
      __syncthreads();
      v3_panel_fma<RI, CG>(zr, s_c1 + rg * KC, KC, nq, s_y + (size_t)k0 * T2, kn);
      v3_panel_fma<RI, CG>(zi, s_c2 + rg * KC, KC, nq, s_y + (size_t)k0 * T2, kn);
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < RI; ++q) {
      if (q < nq) {
        float* row = s_z + (rg + q * kV3RowGroups) * 2 * T2 + 4 * cl;
#pragma unroll
        for (int gg = 0; gg < CG; ++gg) {
          *reinterpret_cast<float4*>(row + 128 * gg) = v3_vec(zr[q][gg]);
          *reinterpret_cast<float4*>(row + T2 + 128 * gg) = v3_vec(zi[q][gg]);
        }
      }
    }
    __syncthreads();

    // W inverse of the chunk, real output: [zr | zi] (R x 2 T2) . u2 (2 T2 x T2)
    float acc[RI][CG][4];
    v3_zero<RI, CG>(acc);
    for (int k0 = 0; k0 < 2 * T2; k0 += KC) {
      v3_stage_dense<T2>(s_u, u2 + (int64_t)k0 * T2, KC);
      __syncthreads();
      v3_panel_fma<RI, CG>(acc, s_z + rg * 2 * T2 + k0, 2 * T2, nq, s_u, KC);
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < RI; ++q) {
      const int oy = h0 + r0 + rg + q * kV3RowGroups;
      if (q < nq && oy < oh) {
#pragma unroll
        for (int gg = 0; gg < CG; ++gg)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int z = 128 * gg + 4 * cl + c, ox = w0 + z;
            if (z < v2 && ox < ow) oplane[(int64_t)oy * ow + ox] = acc[q][gg][c];
          }
      }
    }
  }
}

template <int T2>
cudaError_t launch_v3(const float* x, const float* ks, const float* f2, const float* wr,
                      const float* wi, const float* u2, const float* cz1, const float* cz2,
                      float* d, float* out, int batch, int cin, int cout, int groups, int hp,
                      int wp, int t1, int v1, int v2, int nt2, int tile0, int ntile, int oh,
                      int ow, cudaStream_t stream) {
  using C = V3Cfg<T2>;
  const int nb1 = t1 / 2 + 1;
  const size_t smem = C::smem(nb1);
  if (t1 < C::kKC || t1 % C::kKC || v1 < 1 || v1 > t1 || v2 < 1 || v2 > T2 || nt2 < 1 ||
      ntile < 1 || ntile > 65535 || tile0 < 0 || groups < 1 || cin % groups ||
      cout % groups || smem > (size_t)kMaxSmem)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused2d_v3_spectra<T2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      fused2d_v3_mac_inverse<T2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  fused2d_v3_spectra<T2><<<dim3(batch * cin, ntile), kThreads, smem, stream>>>(
      x, f2, wr, wi, d, hp, wp, t1, nb1, v1, v2, nt2, tile0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused2d_v3_mac_inverse<T2><<<dim3(batch * cout, ntile), kThreads, smem, stream>>>(
      d, ks, cz1, cz2, u2, out, batch, cin, cout, groups, nb1, v1, v2, nt2, tile0, oh, ow);
  return cudaGetLastError();
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

// B2's dynamic shared memory of one block of either kernel for a (t1, t2)
// tile, or -1 for a T2 it does not take. The host's tile plan mirrors this
// formula (fused2d.py: _smem_bytes); a card test holds the two together.
extern "C" long long fused2d_smem_bytes(int t1, int t2) {
  if ((t2 != 128 && t2 != 256) || t1 < 128 || t1 % 128) return -1;
  return (long long)smem_bytes(t1, t2);
}

// Kernel B5 on tiles [tile0, tile0 + ntile) of one convolution. x (B, Cin,
// hp, wp) f32; ks (Cout, Cin/groups, 2, t1/2+1, t2) the conjugated spectra as
// (re, im) planes; f2 (t1 + 2, t1); wr, wi (t2, t2); u2 (2 t2, t2); cz1, cz2
// (v1, t1 + 2); d scratch (ntile, B, Cin, 2, t1/2+1, t2); out (B, Cout, oh,
// ow) f32, all float32. Returns cudaGetLastError() after the two launches.
extern "C" int fused2d_v3_forward(const void* x, const void* ks, const void* f2, const void* wr,
                                  const void* wi, const void* u2, const void* cz1,
                                  const void* cz2, void* d, void* out, int batch, int cin,
                                  int cout, int groups, int hp, int wp, int t1, int t2, int v1,
                                  int v2, int nt2, int tile0, int ntile, int oh, int ow,
                                  void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* ksf = static_cast<const float*>(ks);
  const auto* f2f = static_cast<const float*>(f2);
  const auto* wrf = static_cast<const float*>(wr);
  const auto* wif = static_cast<const float*>(wi);
  const auto* u2f = static_cast<const float*>(u2);
  const auto* c1f = static_cast<const float*>(cz1);
  const auto* c2f = static_cast<const float*>(cz2);
  auto* df = static_cast<float*>(d);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (t2) {
    case 128:
      return launch_v3<128>(xf, ksf, f2f, wrf, wif, u2f, c1f, c2f, df, of, batch, cin, cout,
                            groups, hp, wp, t1, v1, v2, nt2, tile0, ntile, oh, ow, s);
    case 256:
      return launch_v3<256>(xf, ksf, f2f, wrf, wif, u2f, c1f, c2f, df, of, batch, cin, cout,
                            groups, hp, wp, t1, v1, v2, nt2, tile0, ntile, oh, ow, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// B5's dynamic shared memory of one block of either kernel for a (t1, t2)
// tile, or -1 for a T2 it does not take (fused2d.py: _smem_bytes_v3).
extern "C" long long fused2d_v3_smem_bytes(int t1, int t2) {
  switch (t2) {
    case 128:
      return (long long)V3Cfg<128>::smem(t1 / 2 + 1);
    case 256:
      return (long long)V3Cfg<256>::smem(t1 / 2 + 1);
    default:
      return -1;
  }
}

// The CUDA runtime's message for an error code returned above.
extern "C" const char* fused2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
