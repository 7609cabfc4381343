// Fused 3D FFT convolution for Hopper (sm_90a), in FP32: two chains of
// kernels that share their H/W stages.
//
// B3 replaces the TPU kernel fft_conv_tpu/kernels/fused3d.py:735
// (_make_kernel_v4, built by _fused3d_call_v4), the overlap-save-D plan for
// KD <= 9; B4 replaces fft_conv_tpu/kernels/fused3d.py:1233 (_make_kernel_3d,
// built by _fused3d_call), the "tap" plan for KD > 9 and for shapes where the
// v4 plan does not fit. Both compute the valid cross-correlation of a padded
// (B, Cin, D, H, W) signal with a (Cout, Cin/g, KD, KH, KW) kernel. The whole
// volume is transformed along H and W per d-slab: a one-sided H DFT at the
// full H (NBH = H/2+1 rows) and a 64-point W DFT over a block of 64 columns
// (zeros past the signal's edge; wider signals run as overlap-save W blocks,
// the last one clamped to end at the edge). Along D, B3 takes a DFT-16 per
// block of 16 slabs on a hop of 8 (zeros past D), so its MAC over each
// group's input channels against the conjugated kernel spectra is pointwise
// and the inverse DFT-16 keeps the 8 valid d of each block; B4 keeps D in
// the tap domain and correlates along it, Y[o, d] = sum_c sum_u T[c, d + u]
// K[o, c, u], against the conjugated per-tap 2D spectra. Then the inverse W
// DFT and the H irfft (DC and Nyquist weighted 1, the rest 2, their
// imaginary rows zeroed) keep the valid columns and rows. All arithmetic is
// FP32 on CUDA cores. The H DFT, the H irfft, the DFT-16 and the MAC are
// dense products; the W DFT-64 and its inverse are four-step transforms 64 =
// 8 * 8 (fourstep.fft_factor_matrices(8, 8), built in float64 and cast to
// float32 by the host): per row, the 8-point DFT over j1 of x[8 j1 + j2] and
// the twiddle tw[m1, j2], in place in shared memory, then the 8-point DFT
// over j2 onto the bin m1 + 8 m2, in natural order. Each 8-point DFT runs in
// registers as radix-2 butterflies on the roots of unity, so a row costs
// about 1.6 kflop where the dense product cost 32.8. The host side (plans,
// factors, kernel spectra, item ranges) is in
// fft_conv_tpu_torch/kernels/fused3d.py.
//
// Partition. A TPU cell holds a whole volume of every channel in its vector
// memory (90.5 MB at the 64^3 benchmark); one D-block's spectrum of one
// channel is 16 x 33 x 64 complex (270 KB), more than a Hopper block can
// hold. So the work is cut into kernels launched back to back on the
// caller's stream, each handing its result to the next through a scratch
// buffer in device memory (L2 at the benchmark). An "item" is one (batch,
// W-block) pair:
//   1 hw_forward (B3 and B4), grid (items * Cin, D / SB): SB d-slabs read
//     straight from the signal, the one-sided H DFT into shared memory, the
//     factored W DFT (step 1 in place, step 2 stored from registers) into
//     the scratch T (items, Cin, D, NBH, 64);
//   2 d_forward (B3), grid (items * Cin, positions / 256): one thread per
//     (n, z) bin walks D in chunks of 8 slabs; the DFT-16 of block j is the
//     sum of two 8-slab partial DFTs, A[j] + (-1)^f A[j+1], so each slab
//     enters one partial DFT only. Writes S (items, Cin, NBD, 16, NBH, 64);
//   3 mac_d_inverse (B3), grid (items * Cout / OPB, NBD, positions / 256):
//     one thread per bin and OPB output channels of one group streams the 16
//     D-bins, MACs over the group's channels (S and the spectra from L2) and
//     accumulates straight into the 8 valid d of the inverse DFT-16, in
//     registers. Writes Z (items, Cout, OD, NBH, 64);
//   3' tap_mac (B4, in place of 2 and 3), grid (items * Cout / OPB, OD / 8,
//     positions / 256): one thread per bin, OPB output channels of one group
//     and 8 consecutive valid d. For each of the group's channels it walks
//     the KD taps with a window of 8 T values in registers, shifted by one
//     slab a tap, and reads its OPB channels' spectra at that tap through
//     L2; the sums stay in registers (OPB x 8 complex, whatever KD is).
//     Writes Z (items, Cout, OD, NBH, 64);
//   4 hw_inverse (B3 and B4), grid (items * Cout, OD / SB): SB slabs of Z
//     into shared memory, the factored inverse W DFT in place, the H irfft
//     on the valid rows, and the valid (d, h, w) samples stored straight
//     into (B, Cout, OD, OH, OW).
// SB, the slabs a block of phases 1 and 4 holds, is 4 when 4 * NBH * 64
// complex values fit a block's shared memory (67.6 KB at H = 64), else 2 or 1.
// Those rows are swizzled (sw) so that the strided accesses of the W steps,
// a half-warp on 8 columns 8 apart in each of two rows, fall in distinct
// banks; the W factors stay out of shared memory, whose formula is the
// plan's (roots in registers, the twiddle through L1).
//
// Bound. At the library's 3D benchmark (B=2, 8 -> 8 channels, 64^3, K=8) B3's
// call needs about 0.52 GFLOP (FMA = 2; chip_smoke.py: fused3d_work, every
// transform factored where its length splits, the DFT-16s too, no product
// by 1, -1 or +-i, none over zeros past D, none for outputs not stored):
// 0.008 ms at the FP32 CUDA-core rate of 67 TFLOP/s. It must move about 46
// MB (signal 16.8, spectra 17.3, output 11.9): 0.014 ms at 3.35 TB/s, so
// bytes bound it. Done as dense products the same call was 3.7 GFLOP, half
// of them the W DFTs (H DFT 0.55, W DFT 1.11, DFT-16 0.29, MAC 0.28, inverse
// D 0.25, inverse W 0.88, H irfft 0.39).
// The kernels do about 2.0 GFLOP: the H transforms stay dense. B4 at the same
// volume with K=10 needs about 1.34 GFLOP (0.020 ms, the tap MAC 1.19 of it)
// against 38.2 MB to move (0.011 ms); operations bound it. The dense H
// products (phases 1 and 4) are register-tiled: a thread owns one column of
// SB slabs and up to 9 (complex) or 15 (real) rows, and per contraction step
// reads one L1 broadcast per row and one value per slab, about one load per
// 5 FMAs at SB = 4. The MAC phases read
// their operands through L2: B3's about 0.35 GB at the benchmark; B4's the
// spectra once per (item, 8-d chunk), about 0.15 GB at 64^3 K=10, and per
// (tap, channel) one T value and OPB spectra values for 32 complex MACs at
// OPB = 4. Tensor cores (wgmma), TMA staging, a MAC block that serves several
// d-chunks and fusing the phases are left for later work.
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
// Entry points: fused3d_forward (B3), fused3d_tap_forward (B4) and
// fused3d_pack (B6), plain C interfaces loaded with ctypes. Each returns
// cudaGetLastError() after its launches; 0 means all were accepted.

#include <cuda_runtime.h>
#include <stdint.h>

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
template <bool INV>
__device__ __forceinline__ void w_step1(float2* s_r, int nrows, const float2 (&ra)[kWA / 2],
                                        const float2* __restrict__ tw) {
  for (int i = threadIdx.x; i < nrows * kWB; i += kThreads) {
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

__global__ void __launch_bounds__(kThreads)
fused3d_d_forward(const float2* __restrict__ t,   // (items of this launch, Cin, d, nbh, 64)
                  const float2* __restrict__ df,  // (16, 16) DFT-16; rows t < 8 are read
                  float2* __restrict__ s,         // (items of this launch, Cin, nbd, 16, nbh, 64)
                  int d, int nbh, int nbd) {
  __shared__ float2 s_w[kDHop * kDB];
  for (int i = threadIdx.x; i < kDHop * kDB; i += kThreads) s_w[i] = df[i];
  __syncthreads();
  const int npos = nbh * kTW;
  const int pos = blockIdx.y * kThreads + threadIdx.x;
  if (pos >= npos) return;
  const float2* tp = t + (int64_t)blockIdx.x * d * npos + pos;
  float2* sp = s + (int64_t)blockIdx.x * nbd * kDB * npos + pos;

  // A[m] = partial DFT-16 of slabs [8m, 8m + 8); block j = A[j] + (-1)^f A[j+1]
  float2 prev[kDB], cur[kDB];
#pragma unroll
  for (int f = 0; f < kDB; ++f) prev[f] = make_float2(0.f, 0.f);
  for (int m = 0; m <= nbd; ++m) {
#pragma unroll
    for (int f = 0; f < kDB; ++f) cur[f] = make_float2(0.f, 0.f);
#pragma unroll
    for (int tt = 0; tt < kDHop; ++tt) {
      const int dd = m * kDHop + tt;
      if (dd < d) {
        const float2 v = __ldg(tp + (int64_t)dd * npos);
#pragma unroll
        for (int f = 0; f < kDB; ++f) cmac(cur[f], v, s_w[tt * kDB + f]);
      }
    }
    if (m > 0) {
#pragma unroll
      for (int f = 0; f < kDB; ++f) {
        const float2 o = (f & 1) ? make_float2(prev[f].x - cur[f].x, prev[f].y - cur[f].y)
                                 : make_float2(prev[f].x + cur[f].x, prev[f].y + cur[f].y);
        sp[((int64_t)(m - 1) * kDB + f) * npos] = o;
      }
    }
#pragma unroll
    for (int f = 0; f < kDB; ++f) prev[f] = cur[f];
  }
}

template <int OPB>
__global__ void __launch_bounds__(kThreads)
fused3d_mac_d_inverse(const float2* __restrict__ s,   // (items of this launch, Cin, nbd, 16, nbh, 64)
                      const float2* __restrict__ ks,  // (Cout, Cin/g, 16, nbh, 64), conjugated
                      const float2* __restrict__ ei,  // (8, 16) inverse DFT-16 rows, 1/16 folded in
                      float2* __restrict__ z,         // (items of this launch, Cout, od, nbh, 64)
                      int cin, int cout, int groups, int nbh, int nbd, int od) {
  __shared__ float2 s_e[kDHop * kDB];
  for (int i = threadIdx.x; i < kDHop * kDB; i += kThreads) s_e[i] = ei[i];
  __syncthreads();
  const int64_t npos = (int64_t)nbh * kTW;
  const int pos = blockIdx.z * kThreads + threadIdx.x;
  if (pos >= npos) return;
  const int nchunk = cout / OPB;
  const int it = blockIdx.x / nchunk, o0 = (blockIdx.x % nchunk) * OPB;
  const int cpg = cin / groups, g = o0 / (cout / groups);
  const int j = blockIdx.y;
  const float2* sp = s + (((int64_t)it * cin + g * cpg) * nbd + j) * kDB * npos + pos;
  const float2* kp = ks + (int64_t)o0 * cpg * kDB * npos + pos;

  float2 acc[OPB][kDHop];
#pragma unroll
  for (int o = 0; o < OPB; ++o)
#pragma unroll
    for (int q = 0; q < kDHop; ++q) acc[o][q] = make_float2(0.f, 0.f);
  for (int f = 0; f < kDB; ++f) {
    // Y[o] = sum over the group's channels of S[c] * K[o, c] at this D-bin
    float2 y[OPB];
#pragma unroll
    for (int o = 0; o < OPB; ++o) y[o] = make_float2(0.f, 0.f);
    for (int ci = 0; ci < cpg; ++ci) {
      const float2 sv = __ldg(sp + ((int64_t)ci * nbd * kDB + f) * npos);
#pragma unroll
      for (int o = 0; o < OPB; ++o)
        cmac(y[o], sv, __ldg(kp + (((int64_t)o * cpg + ci) * kDB + f) * npos));
    }
    // inverse DFT-16 onto the 8 valid d of the block
#pragma unroll
    for (int q = 0; q < kDHop; ++q) {
      const float2 e = s_e[q * kDB + f];
#pragma unroll
      for (int o = 0; o < OPB; ++o) cmac(acc[o][q], y[o], e);
    }
  }
#pragma unroll
  for (int q = 0; q < kDHop; ++q) {
    const int dd = j * kDHop + q;
    if (dd < od) {
#pragma unroll
      for (int o = 0; o < OPB; ++o)
        z[(((int64_t)it * cout + o0 + o) * od + dd) * npos + pos] = acc[o][q];
    }
  }
}

template <int OPB>
__global__ void __launch_bounds__(kThreads)
fused3d_tap_mac(const float2* __restrict__ t,   // (items of this launch, Cin, d, nbh, 64)
                const float2* __restrict__ ks,  // (Cout, Cin/g, kd, nbh, 64), conjugated
                float2* __restrict__ z,         // (items of this launch, Cout, od, nbh, 64)
                int cin, int cout, int groups, int d, int nbh, int kd, int od) {
  const int64_t npos = (int64_t)nbh * kTW;
  const int pos = blockIdx.z * kThreads + threadIdx.x;
  if (pos >= npos) return;
  const int nchunk = cout / OPB;
  const int it = blockIdx.x / nchunk, o0 = (blockIdx.x % nchunk) * OPB;
  const int cpg = cin / groups, g = o0 / (cout / groups);
  const int d0 = blockIdx.y * kDHop;
  const float2* tp = t + ((int64_t)it * cin + g * cpg) * d * npos + pos;
  const float2* kp = ks + (int64_t)o0 * cpg * kd * npos + pos;

  // Y[o, d0 + q] = sum over the group's channels c and the taps u of
  // T[c, d0 + q + u] * K[o, c, u]; slabs at or past d (only read for q
  // whose d0 + q >= od, which is not stored) count as zeros
  float2 acc[OPB][kDHop];
#pragma unroll
  for (int o = 0; o < OPB; ++o)
#pragma unroll
    for (int q = 0; q < kDHop; ++q) acc[o][q] = make_float2(0.f, 0.f);
  for (int ci = 0; ci < cpg; ++ci) {
    const float2* tc = tp + (int64_t)ci * d * npos;
    // a window of the 8 slabs d0 + u + [0, 8), slid by one slab per tap
    float2 win[kDHop];
#pragma unroll
    for (int q = 0; q < kDHop; ++q)
      win[q] = d0 + q < d ? __ldg(tc + (int64_t)(d0 + q) * npos) : make_float2(0.f, 0.f);
    for (int u = 0; u < kd; ++u) {
#pragma unroll
      for (int o = 0; o < OPB; ++o) {
        const float2 k = __ldg(kp + (((int64_t)o * cpg + ci) * kd + u) * npos);
#pragma unroll
        for (int q = 0; q < kDHop; ++q) cmac(acc[o][q], win[q], k);
      }
      if (u + 1 < kd) {
#pragma unroll
        for (int q = 0; q + 1 < kDHop; ++q) win[q] = win[q + 1];
        const int dn = d0 + kDHop + u;
        win[kDHop - 1] = dn < d ? __ldg(tc + (int64_t)dn * npos) : make_float2(0.f, 0.f);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kDHop; ++q) {
    const int dd = d0 + q;
    if (dd < od) {
#pragma unroll
      for (int o = 0; o < OPB; ++o)
        z[(((int64_t)it * cout + o0 + o) * od + dd) * npos + pos] = acc[o][q];
    }
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

int slabs_per_block(int nbh) {
  if (Cfg<4>::smem(nbh) <= (size_t)kMaxSmem) return 4;
  if (Cfg<2>::smem(nbh) <= (size_t)kMaxSmem) return 2;
  if (Cfg<1>::smem(nbh) <= (size_t)kMaxSmem) return 1;
  return 0;
}

struct Args {
  const float* x;
  const float2 *ks, *fh, *wfac, *df, *ei, *ch;
  float2 *t, *s, *z;
  float* out;
  int cin, cout, groups, d, h, w, od, oh, ow, nbd, kd, nwb, hop, item0, nitem;
  int pp;  // > 0: x is B6's packed layout with pp d-pairs (B3 only)
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

template <int OPB>
cudaError_t launch_mac(const Args& a) {
  const int npos = (a.h / 2 + 1) * kTW;
  fused3d_mac_d_inverse<OPB><<<dim3(a.nitem * a.cout / OPB, a.nbd, (npos + kThreads - 1) / kThreads),
                               kThreads, 0, a.stream>>>(
      a.s, a.ks, a.ei, a.z, a.cin, a.cout, a.groups, a.h / 2 + 1, a.nbd, a.od);
  return cudaGetLastError();
}

template <int OPB>
cudaError_t launch_tap_mac(const Args& a) {
  const int npos = (a.h / 2 + 1) * kTW;
  fused3d_tap_mac<OPB><<<dim3(a.nitem * a.cout / OPB, (a.od + kDHop - 1) / kDHop,
                              (npos + kThreads - 1) / kThreads),
                         kThreads, 0, a.stream>>>(
      a.t, a.ks, a.z, a.cin, a.cout, a.groups, a.d, a.h / 2 + 1, a.kd, a.od);
  return cudaGetLastError();
}

// The checks both chains need: channels and groups, the valid box, the W
// blocks, the item range, and the grid limits of the H/W kernels.
bool hw_args_ok(const Args& a, int sb) {
  const int npos = (a.h / 2 + 1) * kTW;
  return sb != 0 && a.groups >= 1 && a.cin % a.groups == 0 && a.cout % a.groups == 0 &&
         a.d >= 1 && a.od >= 1 && a.od <= a.d && a.oh >= 1 && a.oh <= a.h && a.ow >= 1 &&
         a.ow <= a.w && a.nwb >= 1 && a.hop >= 1 && a.nitem >= 1 && a.item0 >= 0 &&
         (a.d + sb - 1) / sb <= 65535 && (a.od + sb - 1) / sb <= 65535 &&
         (npos + kThreads - 1) / kThreads <= 65535;
}

template <int SB>
cudaError_t launch_hw(const Args& a, bool forward) {
  if (!forward) return launch_hw_inverse<SB>(a);
  return a.pp > 0 ? launch_hw_forward<SB, true>(a) : launch_hw_forward<SB, false>(a);
}

cudaError_t launch_hw_sb(const Args& a, int sb, bool forward) {
  return sb == 4 ? launch_hw<4>(a, forward) : sb == 2 ? launch_hw<2>(a, forward)
                                                      : launch_hw<1>(a, forward);
}

// B3: hw_forward, d_forward, mac_d_inverse, hw_inverse
cudaError_t launch(const Args& a) {
  const int nbh = a.h / 2 + 1, npos = nbh * kTW;
  const int sb = slabs_per_block(nbh);
  if (!hw_args_ok(a, sb) || a.nbd < 1 || kDHop * a.nbd < a.od || a.nbd > 65535 ||
      a.pp < 0 || (a.pp > 0 && 2 * a.pp < a.d))
    return cudaErrorInvalidValue;
  const int opg = a.cout / a.groups;

  cudaError_t err = launch_hw_sb(a, sb, true);
  if (err != cudaSuccess) return err;
  fused3d_d_forward<<<dim3(a.nitem * a.cin, (npos + kThreads - 1) / kThreads), kThreads, 0,
                      a.stream>>>(a.t, a.df, a.s, a.d, nbh, a.nbd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = opg % 4 == 0 ? launch_mac<4>(a) : opg % 2 == 0 ? launch_mac<2>(a) : launch_mac<1>(a);
  if (err != cudaSuccess) return err;
  return launch_hw_sb(a, sb, false);
}

// B4: hw_forward, tap_mac, hw_inverse
cudaError_t launch_tap(const Args& a) {
  const int sb = slabs_per_block(a.h / 2 + 1);
  if (!hw_args_ok(a, sb) || a.kd < 1 || a.od != a.d - a.kd + 1 ||
      (a.od + kDHop - 1) / kDHop > 65535)
    return cudaErrorInvalidValue;
  const int opg = a.cout / a.groups;

  cudaError_t err = launch_hw_sb(a, sb, true);
  if (err != cudaSuccess) return err;
  err = opg % 4 == 0 ? launch_tap_mac<4>(a)
      : opg % 2 == 0 ? launch_tap_mac<2>(a)
                     : launch_tap_mac<1>(a);
  if (err != cudaSuccess) return err;
  return launch_hw_sb(a, sb, false);
}

}  // namespace

// Runs items [item0, item0 + nitem) (item = batch index * nwb + W block) of
// one convolution through B3, the v4 chain. x (B, Cin, d, h, w) f32, or with
// pp > 0 B6's packed layout (B * nwb, h, Cin * pp, 128) f32; ks (Cout,
// Cin/groups, 16, h/2+1, 64); fh (h/2+1, h); wfac the W factors, 8 + 8 + 64
// complex (fused3d.py: _w_factors), which hw_forward reads as they are and
// hw_inverse conjugated; df (16, 16); ei (8, 16); ch (oh, h/2+1); scratch t
// (nitem, Cin, d, h/2+1, 64), s (nitem, Cin, nbd, 16, h/2+1, 64), z (nitem,
// Cout, od, h/2+1, 64);
// out (B, Cout, od, oh, ow) f32. Complex arrays are interleaved (re, im)
// float pairs. W blocks start at min(i * hop, max(w - 64, 0)); with nwb = 1,
// hop is ow. Returns cudaGetLastError() after the four launches (0 when all
// were accepted).
extern "C" int fused3d_forward(const void* x, const void* ks, const void* fh, const void* wfac,
                               const void* df, const void* ei, const void* ch, void* t,
                               void* s, void* z, void* out, int cin, int cout,
                               int groups, int d, int h, int w, int od, int oh, int ow, int nbd,
                               int nwb, int hop, int item0, int nitem, int pp, void* stream) {
  Args a{};
  a.x = static_cast<const float*>(x);
  a.ks = static_cast<const float2*>(ks);
  a.fh = static_cast<const float2*>(fh);
  a.wfac = static_cast<const float2*>(wfac);
  a.df = static_cast<const float2*>(df);
  a.ei = static_cast<const float2*>(ei);
  a.ch = static_cast<const float2*>(ch);
  a.t = static_cast<float2*>(t);
  a.s = static_cast<float2*>(s);
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
  a.stream = static_cast<cudaStream_t>(stream);
  return launch(a);
}

// Runs items [item0, item0 + nitem) of one convolution through B4, the tap
// chain. x (B, Cin, d, h, w) f32; ks (Cout, Cin/groups, kd, h/2+1, 64), the
// conjugated per-tap 2D spectra; fh, wfac and ch as for fused3d_forward;
// scratch t (nitem, Cin, d, h/2+1, 64) and z (nitem, Cout, od, h/2+1, 64),
// od = d - kd + 1; out (B, Cout, od, oh, ow) f32. Returns
// cudaGetLastError() after the three launches (0 when all were accepted).
extern "C" int fused3d_tap_forward(const void* x, const void* ks, const void* fh,
                                   const void* wfac, const void* ch, void* t,
                                   void* z, void* out, int cin, int cout, int groups, int d,
                                   int h, int w, int kd, int od, int oh, int ow, int nwb,
                                   int hop, int item0, int nitem, void* stream) {
  Args a{};
  a.x = static_cast<const float*>(x);
  a.ks = static_cast<const float2*>(ks);
  a.fh = static_cast<const float2*>(fh);
  a.wfac = static_cast<const float2*>(wfac);
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
  a.stream = static_cast<cudaStream_t>(stream);
  return launch_tap(a);
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
