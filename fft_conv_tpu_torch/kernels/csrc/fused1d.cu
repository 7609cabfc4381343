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
// of its time. Tensor cores, TMA staging and fusing the two phases are left
// for later work.
//
// Entry point: fused1d_forward (plain C interface, loaded with ctypes). It
// returns cudaGetLastError() after the launches; 0 means both were accepted.

#include <cuda_runtime.h>
#include <stdint.h>

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

// Launches one phase on a grid of rows x nblk blocks, with the block size for
// that grid: kWide where it has no more blocks than the card has SMs.
template <int N1, typename... Params, typename... Args>
cudaError_t launch_phase(void (*narrow)(Params...), void (*wide)(Params...), int rows, int nblk,
                         int sms, cudaStream_t stream, Args... args) {
  const bool w = (int64_t)rows * nblk <= sms;
  auto* kernel = w ? wide : narrow;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Plan<N1>::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(rows, nblk), w ? kWide : kNarrow, Plan<N1>::kSmem, stream>>>(args...);
  return cudaGetLastError();
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
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = launch_phase<N1>(fused1d_spectra<N1, kNarrow>, fused1d_spectra<N1, kWide>,
                         batch * cin, nblk, sms, stream, x, l_pad, hop, fac, tw, d, blk0,
                         batch, cin);
  if (err != cudaSuccess) return err;
  return launch_phase<N1>(fused1d_mac_inverse<N1, kNarrow>, fused1d_mac_inverse<N1, kWide>,
                          batch * cout, nblk, sms, stream, (const float2*)d, ks, fac, tw,
                          out, blk0, batch, cin, cout, groups, v1, hop, v_total);
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

// The CUDA runtime's message for an error code returned above.
extern "C" const char* fused1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
