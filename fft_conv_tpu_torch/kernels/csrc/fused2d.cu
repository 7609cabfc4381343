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

// The CUDA runtime's message for an error code returned above.
extern "C" const char* fused2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
