// Fused 2D overlap-save FFT convolution for Hopper (sm_90a), in FP32.
//
// Replaces the TPU kernel fft_conv_tpu/kernels/fused2d.py:308 (_make_kernel_2d,
// built by _fused2d_call): the valid cross-correlation of a (B, Cin, Hp, Wp)
// signal with a (Cout, Cin/g, K1, K2) kernel, computed on overlap-save tiles
// of T1 x T2 samples (T1 a multiple of 128, T2 in {128, 256}) that overlap by
// K1-1 rows and K2-1 columns. Per tile: the one-sided H DFT (NB1 = T1/2+1
// rows), the full W DFT (T2 x T2), a per-bin grouped complex MAC over the
// group's input channels against the conjugated kernel spectra, the inverse
// W DFT, and the H irfft on the V1 valid rows (DC and Nyquist weighted 1, the
// rest 2, their imaginary rows zeroed). Every product is a dense DFT matrix
// product done here in FP32 FMAs. The host side (tile plan, factor matrices,
// kernel spectra, tile ranges) is in fft_conv_tpu_torch/kernels/fused2d.py.
//
// Partition. The TPU cell holds every input channel's tile spectrum of an
// H-block in its vector memory and loops over all W tiles; one channel's
// spectrum alone is 65 x 128 complex (66.5 KB) and the W DFT matrix 128 KB,
// more than a Hopper block can hold next to each other. So the work is cut
// into two kernels launched back to back on the caller's stream:
//   phase 1, grid (B * Cin, tiles): read one channel's T1 x T2 window
//     straight from the padded signal (zeros past its edge: no padded or
//     windowed copy), run the H then the W DFT, and write the tile spectrum
//     D (NB1, T2) to a scratch buffer (tiles, B * Cin, NB1, T2);
//   phase 2, grid (B * Cout, tiles): MAC over the group's channels of D
//     against the spectra (both read through L2) into shared memory, run the
//     inverse W DFT in place and the H irfft, and store the V1 x V2 valid
//     samples straight into (B, Cout, OH, OW), clipped at the last tile row
//     and column.
// Each block keeps one NB1 x T2 complex matrix in shared memory (66.5 KB at
// T1 = T2 = 128) and streams the factor matrices from global memory in
// panels of KC rows or columns: every block reads the same few hundred KB,
// which stay in L2. The caller runs the tiles in ranges so that D stays
// bounded.
//
// Bound. At the library's 2D benchmark shapes (B=2, 8 -> 8 channels,
// 512 x 512, K in {16, 34}) the kernels move about 37 MB once and do 10-14
// GFLOP, so the bound is the FP32 CUDA-core rate, not HBM. Each thread owns
// T2/64 columns and up to 17 (complex) or 28 (real) interleaved rows of a
// product and keeps their sums in registers; per contraction step it reads
// one shared-memory broadcast per row and one value per column, so a complex
// product does 4 FMAs per row-column pair for about one shared-memory load
// per 8 FMAs. Tensor cores (wgmma), TMA staging and fusing the two phases are
// left for later work.
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
// whose result is the real output (B2 runs the complex W inverse on all NB1
// rows). The TPU pads NB1 to a multiple of 8 rows for its sublanes; B5 does not.
// Same two-kernel partition and bound as B2. Every product is an FP32 FMA
// panel product with the thread tile of v3_panel_fma (4 columns a thread in
// each 128-column group, 8 row groups, float4 shared-memory loads); phase 2
// runs the inverse in chunks of 16 output rows so that [zr | zi] never takes
// more than 16 x 2 T2 floats beside the stacked Y.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColThreads = 64;                     // threads across columns
constexpr int kRowGroups = kThreads / kColThreads;  // interleaved row groups
constexpr int kMaxSmem = 232448;                    // a Hopper block's shared memory

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

template <int T2>
struct Cfg {
  static constexpr int kCW = T2 / kColThreads;     // columns per thread
  static constexpr int kKC = 4096 / T2;            // contraction panel
  static constexpr int kRptC = T2 == 128 ? 17 : 9;   // complex rows per thread per pass
  static constexpr int kRptR = T2 == 128 ? 28 : 14;  // real rows per thread per pass
  static constexpr int kRowsC = kRowGroups * kRptC;
  static constexpr int kRowsR = kRowGroups * kRptR;
  // panels staged per step: H forward (F_H rows + window rows), W forward or
  // inverse (W rows), H inverse (irfft rows)
  static constexpr size_t kStage = cmax(
      (size_t)kRowsC * kKC * sizeof(float2) + (size_t)kKC * T2 * sizeof(float),
      cmax((size_t)kKC * T2 * sizeof(float2), (size_t)kRowsR * kKC * sizeof(float2)));
  static size_t smem(int nb1) { return (size_t)nb1 * T2 * sizeof(float2) + kStage; }
};

// acc += a * b (complex)
__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
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

// Copies `rows` rows of T2 complex values (16-byte aligned) into shared memory.
template <int T2>
__device__ __forceinline__ void stage_rows(float2* dst, const float2* __restrict__ src,
                                           int rows) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* t = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < rows * T2 / 2; i += kThreads) t[i] = __ldg(s + i);
}

// s_m (rows of the current pass) <- s_m . W, W (T2 x T2) complex streamed from
// global memory in panels of KC rows. Rows [row0, row0 + nrow) of s_m are
// read; the result is left in acc.
template <int T2>
__device__ __forceinline__ void square_dft_pass(
    const float2* s_m, float2* s_w, const float2* __restrict__ w, int row0, int nrow,
    float2 (&acc)[Cfg<T2>::kRptC][Cfg<T2>::kCW]) {
  using C = Cfg<T2>;
  constexpr int CW = C::kCW, KC = C::kKC, RPT = C::kRptC;
  const int tid = threadIdx.x, cl = tid % kColThreads, rg = tid / kColThreads;
  const int nq = own_rows(nrow, rg);
#pragma unroll
  for (int q = 0; q < RPT; ++q)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[q][c] = make_float2(0.f, 0.f);
  for (int k0 = 0; k0 < T2; k0 += KC) {
    stage_rows<T2>(s_w, w + (int64_t)k0 * T2, KC);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float2 bv[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) bv[c] = s_w[kk * T2 + cl + c * kColThreads];
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        if (q < nq) {
          const float2 a = s_m[(row0 + rg + q * kRowGroups) * T2 + k0 + kk];
#pragma unroll
          for (int c = 0; c < CW; ++c) cmac(acc[q][c], a, bv[c]);
        }
      }
    }
    __syncthreads();  // the panel is consumed before the next one overwrites it
  }
}

template <int T2>
__global__ void __launch_bounds__(kThreads, 2)
fused2d_spectra(const float* __restrict__ x,    // (B, Cin, hp, wp)
                const float2* __restrict__ fh,  // (nb1, t1) one-sided H DFT rows
                const float2* __restrict__ wf,  // (T2, T2) W DFT
                float2* __restrict__ d,         // (tiles of this launch, B * Cin, nb1, T2)
                int hp, int wp, int t1, int nb1, int v1, int v2, int nt2, int tile0) {
  using C = Cfg<T2>;
  constexpr int CW = C::kCW, KC = C::kKC, RPT = C::kRptC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* s_h = reinterpret_cast<float2*>(smem_raw);            // (nb1, T2)
  float2* s_f = s_h + (size_t)nb1 * T2;                          // (kRowsC, KC) panel
  float* s_a = reinterpret_cast<float*>(s_f + C::kRowsC * KC);   // (KC, T2) window rows
  float2* s_w = s_f;                                             // (KC, T2) W panel

  const int tid = threadIdx.x, cl = tid % kColThreads, rg = tid / kColThreads;
  const int tile = tile0 + blockIdx.y;
  const int h0 = (tile / nt2) * v1, w0 = (tile % nt2) * v2;
  const float* xs = x + (int64_t)blockIdx.x * hp * wp;

  // H forward, one-sided: s_h = F_H (nb1 x t1) . A (t1 x T2), A the real window
  const Passes ps = split_rows(nb1, C::kRowsC);
  for (int p = 0; p < ps.n; ++p) {
    const int row0 = p * ps.rows, nrow = min(ps.rows, nb1 - row0);
    const int nq = own_rows(nrow, rg);
    float2 acc[RPT][CW];
#pragma unroll
    for (int q = 0; q < RPT; ++q)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[q][c] = make_float2(0.f, 0.f);
    for (int t0 = 0; t0 < t1; t0 += KC) {
      for (int i = tid; i < nrow * KC; i += kThreads)
        s_f[i] = __ldg(fh + (int64_t)(row0 + i / KC) * t1 + t0 + i % KC);
      for (int i = tid; i < KC * T2; i += kThreads) {
        const int hr = h0 + t0 + i / T2, wc = w0 + i % T2;
        s_a[i] = (hr < hp && wc < wp) ? __ldg(xs + (int64_t)hr * wp + wc) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        float bv[CW];
#pragma unroll
        for (int c = 0; c < CW; ++c) bv[c] = s_a[kk * T2 + cl + c * kColThreads];
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          if (q < nq) {
            const float2 f = s_f[(rg + q * kRowGroups) * KC + kk];
#pragma unroll
            for (int c = 0; c < CW; ++c) {
              acc[q][c].x = fmaf(f.x, bv[c], acc[q][c].x);
              acc[q][c].y = fmaf(f.y, bv[c], acc[q][c].y);
            }
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      if (q < nq) {
#pragma unroll
        for (int c = 0; c < CW; ++c)
          s_h[(row0 + rg + q * kRowGroups) * T2 + cl + c * kColThreads] = acc[q][c];
      }
    }
  }
  __syncthreads();

  // W forward: D = s_h . W_T2, written to the scratch
  float2* dout = d + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * nb1 * T2;
  for (int p = 0; p < ps.n; ++p) {
    const int row0 = p * ps.rows, nrow = min(ps.rows, nb1 - row0);
    const int nq = own_rows(nrow, rg);
    float2 acc[RPT][CW];
    square_dft_pass<T2>(s_h, s_w, wf, row0, nrow, acc);
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      if (q < nq) {
#pragma unroll
        for (int c = 0; c < CW; ++c)
          dout[(row0 + rg + q * kRowGroups) * T2 + cl + c * kColThreads] = acc[q][c];
      }
    }
  }
}

template <int T2>
__global__ void __launch_bounds__(kThreads, 2)
fused2d_mac_inverse(const float2* __restrict__ d,   // (tiles of this launch, B * Cin, nb1, T2)
                    const float2* __restrict__ ks,  // (Cout, Cin/g, nb1, T2), conjugated
                    const float2* __restrict__ wb,  // (T2, T2) inverse W DFT (1/T2 folded in)
                    const float2* __restrict__ ch,  // (v1, nb1) H irfft rows as (cr, ci) pairs
                    float* __restrict__ out,        // (B, Cout, oh, ow)
                    int batch, int cin, int cout, int groups, int nb1, int v1, int v2,
                    int nt2, int tile0, int oh, int ow) {
  using C = Cfg<T2>;
  constexpr int CW = C::kCW, KC = C::kKC, RPT = C::kRptC, RPTR = C::kRptR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* s_y = reinterpret_cast<float2*>(smem_raw);  // (nb1, T2): Y, then E
  float2* s_w = s_y + (size_t)nb1 * T2;               // (KC, T2) W panel
  float2* s_c = s_w;                                  // (kRowsR, KC) irfft panel

  const int tid = threadIdx.x, cl = tid % kColThreads, rg = tid / kColThreads;
  const int b = blockIdx.x / cout, o = blockIdx.x % cout;
  const int cpg = cin / groups, g = o / (cout / groups);
  const int tile = tile0 + blockIdx.y;
  const int h0 = (tile / nt2) * v1, w0 = (tile % nt2) * v2;
  const int64_t plane = (int64_t)nb1 * T2;

  // per-bin MAC over this out-channel's group: Y = sum_c D[c] * K[o, c]
  const float2* dg = d + (((int64_t)blockIdx.y * batch + b) * cin + (int64_t)g * cpg) * plane;
  const float2* ko = ks + (int64_t)o * cpg * plane;
  for (int i = tid; i < nb1 * T2; i += kThreads) {
    float2 y = make_float2(0.f, 0.f);
    for (int ci = 0; ci < cpg; ++ci) cmac(y, __ldg(dg + ci * plane + i), __ldg(ko + ci * plane + i));
    s_y[i] = y;
  }
  __syncthreads();

  // W inverse, in place: each pass reads and then overwrites its own rows
  {
    const Passes ps = split_rows(nb1, C::kRowsC);
    for (int p = 0; p < ps.n; ++p) {
      const int row0 = p * ps.rows, nrow = min(ps.rows, nb1 - row0);
      const int nq = own_rows(nrow, rg);
      float2 acc[RPT][CW];
      square_dft_pass<T2>(s_y, s_w, wb, row0, nrow, acc);
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        if (q < nq) {
#pragma unroll
          for (int c = 0; c < CW; ++c)
            s_y[(row0 + rg + q * kRowGroups) * T2 + cl + c * kColThreads] = acc[q][c];
        }
      }
    }
  }
  __syncthreads();

  // H irfft on the valid rows: out[v, z] = sum_k cr[v, k] Er[k, z] + ci[v, k] Ei[k, z]
  float* oplane = out + ((int64_t)b * cout + o) * oh * ow;
  const Passes ps = split_rows(v1, C::kRowsR);
  for (int p = 0; p < ps.n; ++p) {
    const int row0 = p * ps.rows, nrow = min(ps.rows, v1 - row0);
    const int nq = own_rows(nrow, rg);
    float acc[RPTR][CW];
#pragma unroll
    for (int q = 0; q < RPTR; ++q)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[q][c] = 0.f;
    for (int k0 = 0; k0 < nb1; k0 += KC) {
      const int kn = min(KC, nb1 - k0);
      for (int i = tid; i < nrow * KC; i += kThreads) {
        const int kk = i % KC;
        s_c[i] = kk < kn ? __ldg(ch + (int64_t)(row0 + i / KC) * nb1 + k0 + kk)
                         : make_float2(0.f, 0.f);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        float2 ev[CW];
#pragma unroll
        for (int c = 0; c < CW; ++c) ev[c] = s_y[(k0 + kk) * T2 + cl + c * kColThreads];
#pragma unroll
        for (int q = 0; q < RPTR; ++q) {
          if (q < nq) {
            const float2 w = s_c[(rg + q * kRowGroups) * KC + kk];
#pragma unroll
            for (int c = 0; c < CW; ++c)
              acc[q][c] = fmaf(w.x, ev[c].x, fmaf(w.y, ev[c].y, acc[q][c]));
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < RPTR; ++q) {
      const int oy = h0 + row0 + rg + q * kRowGroups;
      if (q < nq && oy < oh) {
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const int z = cl + c * kColThreads, ox = w0 + z;
          if (z < v2 && ox < ow) oplane[(int64_t)oy * ow + ox] = acc[q][c];
        }
      }
    }
  }
}

template <int T2>
cudaError_t launch(const float* x, const float2* ks, const float2* fh, const float2* wf,
                   const float2* wb, const float2* ch, float2* d, float* out, int batch,
                   int cin, int cout, int groups, int hp, int wp, int t1, int v1, int v2,
                   int nt2, int tile0, int ntile, int oh, int ow, cudaStream_t stream) {
  using C = Cfg<T2>;
  const int nb1 = t1 / 2 + 1;
  const size_t smem = C::smem(nb1);
  if (t1 < C::kKC || t1 % C::kKC || v1 < 1 || v1 > t1 || v2 < 1 || v2 > T2 || nt2 < 1 ||
      ntile < 1 || ntile > 65535 || tile0 < 0 || groups < 1 || cin % groups ||
      cout % groups || smem > (size_t)kMaxSmem)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused2d_spectra<T2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      fused2d_mac_inverse<T2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  fused2d_spectra<T2><<<dim3(batch * cin, ntile), kThreads, smem, stream>>>(
      x, fh, wf, d, hp, wp, t1, nb1, v1, v2, nt2, tile0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused2d_mac_inverse<T2><<<dim3(batch * cout, ntile), kThreads, smem, stream>>>(
      d, ks, wb, ch, out, batch, cin, cout, groups, nb1, v1, v2, nt2, tile0, oh, ow);
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
// convolution. x (B, Cin, hp, wp) f32; ks (Cout, Cin/groups, t1/2+1, t2);
// fh (t1/2+1, t1); wf and wb (t2, t2); ch (v1, t1/2+1); d scratch (ntile, B,
// Cin, t1/2+1, t2); out (B, Cout, oh, ow) f32. Complex arrays are interleaved
// (re, im) float pairs. Returns cudaGetLastError() after the two launches (0
// when both were accepted).
extern "C" int fused2d_forward(const void* x, const void* ks, const void* fh, const void* wf,
                               const void* wb, const void* ch, void* d, void* out, int batch,
                               int cin, int cout, int groups, int hp, int wp, int t1, int t2,
                               int v1, int v2, int nt2, int tile0, int ntile, int oh, int ow,
                               void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* ksc = static_cast<const float2*>(ks);
  const auto* fhc = static_cast<const float2*>(fh);
  const auto* wfc = static_cast<const float2*>(wf);
  const auto* wbc = static_cast<const float2*>(wb);
  const auto* chc = static_cast<const float2*>(ch);
  auto* dc = static_cast<float2*>(d);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (t2) {
    case 128:
      return launch<128>(xf, ksc, fhc, wfc, wbc, chc, dc, of, batch, cin, cout, groups, hp, wp,
                         t1, v1, v2, nt2, tile0, ntile, oh, ow, s);
    case 256:
      return launch<256>(xf, ksc, fhc, wfc, wbc, chc, dc, of, batch, cin, cout, groups, hp, wp,
                         t1, v1, v2, nt2, tile0, ntile, oh, ow, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block of either kernel for a (t1, t2) tile,
// or -1 for a T2 the kernel does not take. The host's tile plan mirrors this
// formula (fused2d.py: _smem_bytes); a card test holds the two together.
extern "C" long long fused2d_smem_bytes(int t1, int t2) {
  switch (t2) {
    case 128:
      return (long long)Cfg<128>::smem(t1 / 2 + 1);
    case 256:
      return (long long)Cfg<256>::smem(t1 / 2 + 1);
    default:
      return -1;
  }
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
