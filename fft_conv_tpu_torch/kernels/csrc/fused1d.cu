// Fused 1D overlap-save FFT convolution for Hopper (sm_90a), in FP32.
//
// Replaces the TPU kernel fft_conv_tpu/kernels/fused1d.py:291 (_make_kernel,
// built by _fused_call): the valid cross-correlation of each overlap-save
// block of N = N1 * 128 samples (N1 in {16, 32, 64}) through the one-sided
// four-step DFT — forward stage 1 (F_N1) on rows k1 in [0, N1/2], twiddle,
// forward stage 2 (F_128), a per-bin complex MAC over the group's input
// channels against the conjugated scrambled kernel spectra, inverse stage 1
// (iF_128), the conjugate twiddle, and inverse stage 2 with the pair-doubling
// folded into its weights, emitting only the V1 valid rows of each block.
// The host side (factor matrices, spectra, block count) is in
// fft_conv_tpu_torch/kernels/fused1d.py.
//
// Partition. The TPU cell holds the whole batch's block plus several complex
// intermediates in its vector memory at once; a Hopper block has at most
// 227 KB of shared memory, and F_128 alone is 128 KB in complex FP32. So the work is
// cut again, into two kernels launched back to back on the caller's stream:
//   phase 1, grid (B * Cin, blocks): load one channel's N1 x 128 window
//     straight from the (B, Cin, L) signal (reads past L are zeros: no padded
//     copy), run forward stages 1 and 2, and write the one-sided spectrum
//     D (N1/2+1, 128) to a scratch buffer (blocks, B, Cin, N1/2+1, 128);
//   phase 2, grid (B * Cout, blocks): MAC over the group's channels of D
//     against the spectra (both read through L2), keep Y in shared memory,
//     run inverse stage 1, the conjugate twiddle and inverse stage 2, and
//     write the V1 x 128 valid outputs straight into (B, Cout, L - K + 1).
// Shared memory per block is fixed by N alone (at most 82 KB, at N = 8192),
// so batch and channel counts are limited only by the grid. The caller runs
// the overlap-save blocks in ranges so that the scratch D stays bounded.
// F_128 and iF_128 are read from global memory: every block of a launch
// reads the same 128 KB, so it stays in L2 and L1.
//
// Bound. At the library's benchmark shapes (B=2, 8 -> 8 channels,
// L = 32768) the kernels move a few MB and do about a GFLOP, so the bound is
// the FP32 CUDA-core rate, not HBM. Each thread owns one of 128 columns and
// half of the one-sided rows and keeps their complex sums in registers; the
// row operand is one 64-bit shared-memory broadcast per complex multiply-add
// (four FMAs), and the column operand is one load reused across all of the
// thread's rows. Tensor cores (wgmma), TMA staging and fusing the two phases
// are left for later work.
//
// Entry point: fused1d_forward (plain C interface, loaded with ctypes). It
// returns cudaGetLastError() after the launches; 0 means both were accepted.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN2 = 128;       // stage-2 length: one row of the block
constexpr int kThreads = 256;  // two row groups x 128 columns

template <int N1>
struct Shape {
  static constexpr int kH = N1 / 2 + 1;       // one-sided k1 rows
  static constexpr int kRows = (kH + 1) / 2;  // k1 rows of one row group
  // phase 1: F_N1 rows (kH x N1) + C (kH x 128) complex, window (N1 x 128) real
  static constexpr size_t kSmemSpectra =
      (size_t)kH * N1 * sizeof(float2) + (size_t)kH * kN2 * sizeof(float2) +
      (size_t)N1 * kN2 * sizeof(float);
  // phase 2: Y/G (kH x 128) + inverse stage-2 weights (V1 <= N1 rows x kH)
  static constexpr size_t kSmemInverse =
      (size_t)kH * kN2 * sizeof(float2) + (size_t)N1 * kH * sizeof(float2);
};

// acc += a * b (complex)
__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

// Threads 0-127 own k1 rows [0, kRows), threads 128-255 rows [kRows, 2*kRows).
// kH is odd, so the second group has one spare row: it is computed on the
// clamped index kH-1 (same arithmetic, no branch in the inner loops) and
// never stored.
template <int N1>
__global__ void __launch_bounds__(kThreads)
fused1d_spectra(const float* __restrict__ x, int64_t l_pad, int64_t hop,
                const float2* __restrict__ f1,  // (kH, N1) one-sided F_N1 rows
                const float2* __restrict__ tw,  // (kH, 128) twiddle rows
                const float2* __restrict__ f2,  // (128, 128) F_128
                float2* __restrict__ d,         // (blocks of this launch, B, Cin, kH, 128)
                int blk0, int batch, int cin) {
  using S = Shape<N1>;
  constexpr int H = S::kH, R = S::kRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* s_f1 = reinterpret_cast<float2*>(smem_raw);
  float2* s_c = s_f1 + H * N1;
  float* s_a = reinterpret_cast<float*>(s_c + H * kN2);

  const int b = blockIdx.x / cin, c = blockIdx.x % cin, blk = blk0 + blockIdx.y;
  const int tid = threadIdx.x, col = tid & (kN2 - 1), row0 = (tid >> 7) * R;

  // this block's window: samples [blk*hop, blk*hop + N1*128) of one channel
  const float* xs = x + ((int64_t)b * cin + c) * l_pad;
  const int64_t start = (int64_t)blk * hop;
  for (int i = tid; i < N1 * kN2; i += kThreads) {
    const int64_t p = start + i;
    s_a[i] = p < l_pad ? __ldg(xs + p) : 0.f;
  }
  for (int i = tid; i < H * N1; i += kThreads) s_f1[i] = __ldg(f1 + i);
  __syncthreads();

  // forward stage 1 on the one-sided rows: B[k1, col] = sum_j1 F1[k1, j1] A[j1, col]
  float2 acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = make_float2(0.f, 0.f);
  for (int j1 = 0; j1 < N1; ++j1) {
    const float v = s_a[j1 * kN2 + col];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 f = s_f1[min(row0 + r, H - 1) * N1 + j1];
      acc[r].x = fmaf(f.x, v, acc[r].x);
      acc[r].y = fmaf(f.y, v, acc[r].y);
    }
  }
  // twiddle: C = B * tw
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k1 = row0 + r;
    if (k1 < H) {
      const float2 t = __ldg(tw + k1 * kN2 + col);
      s_c[k1 * kN2 + col] = make_float2(acc[r].x * t.x - acc[r].y * t.y,
                                        acc[r].x * t.y + acc[r].y * t.x);
    }
  }
  __syncthreads();

  // forward stage 2: D[k1, col] = sum_j C[k1, j] F2[j, col]
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = make_float2(0.f, 0.f);
  for (int j = 0; j < kN2; ++j) {
    const float2 f = __ldg(f2 + j * kN2 + col);
#pragma unroll
    for (int r = 0; r < R; ++r) cmac(acc[r], s_c[min(row0 + r, H - 1) * kN2 + j], f);
  }
  float2* dout = d + ((int64_t)blockIdx.y * batch * cin + blockIdx.x) * (H * kN2);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k1 = row0 + r;
    if (k1 < H) dout[k1 * kN2 + col] = acc[r];
  }
}

template <int N1>
__global__ void __launch_bounds__(kThreads)
fused1d_mac_inverse(const float2* __restrict__ d,     // (blocks of this launch, B, Cin, kH, 128)
                    const float2* __restrict__ ks,    // (Cout, kH, Cin/g, 128), conjugated
                    const float2* __restrict__ tw,    // (kH, 128)
                    const float2* __restrict__ if2,   // (128, 128) iF_128 (1/128 folded in)
                    const float2* __restrict__ if1w,  // (V1, kH) inverse stage 2, valid rows
                    float* __restrict__ out,          // (B, Cout, v_total)
                    int blk0, int batch, int cin, int cout, int groups, int v1,
                    int64_t hop, int64_t v_total) {
  using S = Shape<N1>;
  constexpr int H = S::kH, R = S::kRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* s_y = reinterpret_cast<float2*>(smem_raw);
  float2* s_w = s_y + H * kN2;

  const int b = blockIdx.x / cout, o = blockIdx.x % cout, blk = blk0 + blockIdx.y;
  const int tid = threadIdx.x, col = tid & (kN2 - 1), row0 = (tid >> 7) * R;
  const int cpg = cin / groups, g = o / (cout / groups);

  // per-bin MAC over this out-channel's group: Y = sum_c D[c] * K[o, c]
  const float2* dg = d + (((int64_t)blockIdx.y * batch + b) * cin + (int64_t)g * cpg) * (H * kN2);
  const float2* ko = ks + (int64_t)o * H * cpg * kN2;
  for (int i = tid; i < H * kN2; i += kThreads) {
    const int k1 = i / kN2, k2 = i % kN2;
    float2 y = make_float2(0.f, 0.f);
    for (int ci = 0; ci < cpg; ++ci) {
      cmac(y, __ldg(dg + (int64_t)ci * (H * kN2) + i),
           __ldg(ko + ((int64_t)k1 * cpg + ci) * kN2 + k2));
    }
    s_y[i] = y;
  }
  for (int i = tid; i < v1 * H; i += kThreads) s_w[i] = __ldg(if1w + i);
  __syncthreads();

  // inverse stage 1: E[k1, col] = sum_k2 Y[k1, k2] iF2[k2, col]
  float2 acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = make_float2(0.f, 0.f);
  for (int k2 = 0; k2 < kN2; ++k2) {
    const float2 f = __ldg(if2 + k2 * kN2 + col);
#pragma unroll
    for (int r = 0; r < R; ++r) cmac(acc[r], s_y[min(row0 + r, H - 1) * kN2 + k2], f);
  }
  __syncthreads();  // every thread is done reading Y before G overwrites it

  // conjugate twiddle: G = E * conj(tw)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k1 = row0 + r;
    if (k1 < H) {
      const float2 t = __ldg(tw + k1 * kN2 + col);
      s_y[k1 * kN2 + col] = make_float2(acc[r].x * t.x + acc[r].y * t.y,
                                        acc[r].y * t.x - acc[r].x * t.y);
    }
  }
  __syncthreads();

  // inverse stage 2, valid rows only: out[r, col] = Re(sum_k1 W[r, k1] G[k1, col])
  float2 gcol[H];
#pragma unroll
  for (int k1 = 0; k1 < H; ++k1) gcol[k1] = s_y[k1 * kN2 + col];
  float* orow = out + ((int64_t)b * cout + o) * v_total;
  for (int r = tid >> 7; r < v1; r += 2) {
    float s = 0.f;
#pragma unroll
    for (int k1 = 0; k1 < H; ++k1) {
      const float2 w = s_w[r * H + k1];
      s = fmaf(w.x, gcol[k1].x, s);
      s = fmaf(-w.y, gcol[k1].y, s);
    }
    const int64_t pos = (int64_t)blk * hop + (int64_t)r * kN2 + col;
    if (pos < v_total) orow[pos] = s;
  }
}

template <int N1>
cudaError_t launch(const float* x, int64_t l_pad, const float2* ks,
                   const float2* f1, const float2* tw, const float2* f2,
                   const float2* if1w, const float2* if2, float2* d, float* out,
                   int batch, int cin, int cout, int groups, int v1, int blk0,
                   int nblk, int64_t v_total, cudaStream_t stream) {
  using S = Shape<N1>;
  if (v1 < 1 || v1 > N1 || nblk < 1 || nblk > 65535 || blk0 < 0) return cudaErrorInvalidValue;
  const int64_t hop = (int64_t)v1 * kN2;
  cudaError_t err = cudaFuncSetAttribute(
      fused1d_spectra<N1>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmemSpectra);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      fused1d_mac_inverse<N1>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmemInverse);
  if (err != cudaSuccess) return err;

  fused1d_spectra<N1><<<dim3(batch * cin, nblk), kThreads, S::kSmemSpectra, stream>>>(
      x, l_pad, hop, f1, tw, f2, d, blk0, batch, cin);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused1d_mac_inverse<N1><<<dim3(batch * cout, nblk), kThreads, S::kSmemInverse, stream>>>(
      d, ks, tw, if2, if1w, out, blk0, batch, cin, cout, groups, v1, hop, v_total);
  return cudaGetLastError();
}

}  // namespace

// Runs overlap-save blocks [blk0, blk0 + nblk) of one convolution.
// x (B, Cin, l_pad) f32; ks (Cout, N1/2+1, Cin/groups, 128) complex;
// f1 (N1/2+1, N1), tw (N1/2+1, 128), f2 and if2 (128, 128), if1w (v1, N1/2+1)
// complex; d scratch (nblk, B, Cin, N1/2+1, 128) complex; out (B, Cout,
// v_total) f32. Complex arrays are interleaved (re, im) float pairs. Returns
// cudaGetLastError() after the two launches (0 when both were accepted).
extern "C" int fused1d_forward(const void* x, long long l_pad, const void* ks,
                               const void* f1, const void* tw, const void* f2,
                               const void* if1w, const void* if2, void* d, void* out,
                               int batch, int cin, int cout, int groups, int n1,
                               int v1, int blk0, int nblk, long long v_total,
                               void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* ksc = static_cast<const float2*>(ks);
  const auto* f1c = static_cast<const float2*>(f1);
  const auto* twc = static_cast<const float2*>(tw);
  const auto* f2c = static_cast<const float2*>(f2);
  const auto* if1c = static_cast<const float2*>(if1w);
  const auto* if2c = static_cast<const float2*>(if2);
  auto* dc = static_cast<float2*>(d);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n1) {
    case 16:
      return launch<16>(xf, l_pad, ksc, f1c, twc, f2c, if1c, if2c, dc, of, batch, cin,
                        cout, groups, v1, blk0, nblk, v_total, s);
    case 32:
      return launch<32>(xf, l_pad, ksc, f1c, twc, f2c, if1c, if2c, dc, of, batch, cin,
                        cout, groups, v1, blk0, nblk, v_total, s);
    case 64:
      return launch<64>(xf, l_pad, ksc, f1c, twc, f2c, if1c, if2c, dc, of, batch, cin,
                        cout, groups, v1, blk0, nblk, v_total, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The CUDA runtime's message for an error code returned above.
extern "C" const char* fused1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
