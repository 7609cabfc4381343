// Fused 3D overlap-save-D FFT convolution for Hopper (sm_90a), in FP32.
//
// Replaces the TPU kernel fft_conv_tpu/kernels/fused3d.py:735 (_make_kernel_v4,
// built by _fused3d_call_v4): the valid cross-correlation of a padded
// (B, Cin, D, H, W) signal with a (Cout, Cin/g, KD <= 9, KH, KW) kernel. The
// whole volume is transformed: a one-sided H DFT at the full H (NBH = H/2+1
// rows), a 64-point W DFT over a block of 64 columns (zeros past the signal's
// edge; wider signals run as overlap-save W blocks, the last one clamped to
// end at the edge), and along D a DFT-16 per block of 16 slabs on a hop of 8
// (zeros past D). The MAC over each group's input channels against the
// conjugated kernel spectra is then pointwise; the inverse DFT-16 keeps the 8
// valid d of each block, the inverse W DFT and the H irfft (DC and Nyquist
// weighted 1, the rest 2, their imaginary rows zeroed) the valid columns and
// rows. Every transform is a dense DFT matrix product in FP32 FMAs. The host
// side (plan, factor matrices, kernel spectra, item ranges) is in
// fft_conv_tpu_torch/kernels/fused3d.py.
//
// Partition. A TPU cell holds a whole volume of every channel in its vector
// memory (90.5 MB at the 64^3 benchmark); one D-block's spectrum of one
// channel is 16 x 33 x 64 complex (270 KB), more than a Hopper block can
// hold. So the work is cut into four kernels launched back to back on the
// caller's stream, each handing its result to the next through a scratch
// buffer in device memory (L2 at the benchmark). An "item" is one (batch,
// W-block) pair:
//   1 hw_forward, grid (items * Cin, D / SB): SB d-slabs read straight from
//     the signal, the one-sided H DFT into shared memory, the W DFT into the
//     scratch T (items, Cin, D, NBH, 64);
//   2 d_forward, grid (items * Cin, positions / 256): one thread per (n, z)
//     bin walks D in chunks of 8 slabs; the DFT-16 of block j is the sum of
//     two 8-slab partial DFTs, A[j] + (-1)^f A[j+1], so each slab enters one
//     partial DFT only. Writes S (items, Cin, NBD, 16, NBH, 64);
//   3 mac_d_inverse, grid (items * Cout / OPB, NBD, positions / 256): one
//     thread per bin and OPB output channels of one group streams the 16
//     D-bins, MACs over the group's channels (S and the spectra from L2) and
//     accumulates straight into the 8 valid d of the inverse DFT-16, in
//     registers. Writes Z (items, Cout, OD, NBH, 64);
//   4 hw_inverse, grid (items * Cout, OD / SB): SB slabs of Z into shared
//     memory, the inverse W DFT in place, the H irfft on the valid rows, and
//     the valid (d, h, w) samples stored straight into (B, Cout, OD, OH, OW).
// SB, the slabs a block of phases 1 and 4 holds, is 4 when 4 * NBH * 64
// complex values fit a block's shared memory (67.6 KB at H = 64), else 2 or 1.
//
// Bound. At the library's 3D benchmark (B=2, 8 -> 8 channels, 64^3, K=8) the
// call needs about 3.7 GFLOP of dense products (FMA = 2): H DFT 0.55, W DFT
// 1.11, DFT-16 0.29, MAC 0.28, inverse D 0.25, inverse W on the 57 stored
// columns 0.88, H irfft on the 57 valid rows 0.39: 0.056 ms at the FP32
// CUDA-core rate of 67 TFLOP/s. It must move about 46 MB (signal 16.8, spectra
// 17.3, output 11.9): 0.014 ms at 3.35 TB/s. So operations bound it. The
// dense products (phases 1 and 4, 80% of the work) are register-tiled: a
// thread owns one column of SB slabs and up to 9 (complex) or 15 (real) rows,
// and per contraction step reads one shared-memory or L1 broadcast per row
// and one value per slab, about one load per 5 FMAs at SB = 4. Phases 2 and 3
// are light in flops and read their operands through L2 (about 0.35 GB of L2
// traffic in phase 3 at the benchmark). Tensor cores (wgmma), TMA staging
// and fusing the phases are left for later work.
//
// Entry point: fused3d_forward (plain C interface, loaded with ctypes). It
// returns cudaGetLastError() after the launches; 0 means all were accepted.

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
  // rows a thread owns per pass: complex (H forward, W forward and inverse)
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

__device__ __forceinline__ Item item_geom(int item, int nwb, int hop, int w, int ow) {
  const int wb = item % nwb;
  Item g;
  g.b = item / nwb;
  g.start = min(wb * hop, max(w - kTW, 0));
  g.lo = wb * hop - g.start;
  g.hi = min(hop, ow - g.start);
  return g;
}

template <int SB>
__global__ void __launch_bounds__(kThreads, 2)
fused3d_hw_forward(const float* __restrict__ x,    // (B, Cin, d, h, w)
                   const float2* __restrict__ fh,  // (nbh, h) one-sided H DFT rows
                   const float2* __restrict__ wf,  // (64, 64) W DFT
                   float2* __restrict__ t,         // (items of this launch, Cin, d, nbh, 64)
                   int cin, int d, int h, int w, int ow, int nwb, int hop, int item0) {
  constexpr int RPT = Cfg<SB>::kRpt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* s_a = reinterpret_cast<float2*>(smem_raw);  // (SB, nbh, 64)

  const int nbh = h / 2 + 1;
  const int tid = threadIdx.x, cl = tid % kTW, rg = tid / kTW;
  const int it = blockIdx.x / cin, c = blockIdx.x % cin;
  const Item g = item_geom(item0 + it, nwb, hop, w, ow);
  const int d0 = blockIdx.y * SB, ns = min(SB, d - d0);
  const float* xs = x + (((int64_t)g.b * cin + c) * d + d0) * h * w + g.start + cl;
  const bool col_in = g.start + cl < w;
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
      for (int s = 0; s < SB; ++s)
        xv[s] = (col_in && s < ns) ? __ldg(xs + ((int64_t)s * h + hh) * w) : 0.f;
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
          s_a[((int64_t)s * nbh + row0 + rg + q * kRowGroups) * kTW + cl] = acc[q][s];
      }
    }
  }
  __syncthreads();

  // W forward: T[s] = A[s] . W64, written to the scratch
  float2* tout = t + ((int64_t)blockIdx.x * d + d0) * nbh * kTW;
  for (int p = 0; p < ps.n; ++p) {
    const int row0 = p * ps.rows, nrow = min(ps.rows, nbh - row0);
    const int nq = own_rows(nrow, rg);
    float2 acc[RPT][SB];
#pragma unroll
    for (int q = 0; q < RPT; ++q)
#pragma unroll
      for (int s = 0; s < SB; ++s) acc[q][s] = make_float2(0.f, 0.f);
#pragma unroll 2
    for (int k = 0; k < kTW; ++k) {
      const float2 wv = __ldg(wf + k * kTW + cl);
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        if (q < nq) {
          const int row = row0 + rg + q * kRowGroups;
#pragma unroll
          for (int s = 0; s < SB; ++s) cmac(acc[q][s], s_a[(s * nbh + row) * kTW + k], wv);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      if (q < nq) {
        const int row = row0 + rg + q * kRowGroups;
#pragma unroll
        for (int s = 0; s < SB; ++s)
          if (s < ns) tout[((int64_t)s * nbh + row) * kTW + cl] = acc[q][s];
      }
    }
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

template <int SB>
__global__ void __launch_bounds__(kThreads, 2)
fused3d_hw_inverse(const float2* __restrict__ z,   // (items of this launch, Cout, od, nbh, 64)
                   const float2* __restrict__ wb,  // (64, 64) inverse W DFT (1/64 folded in)
                   const float2* __restrict__ ch,  // (oh, nbh) H irfft rows as (cr, ci) pairs
                   float* __restrict__ out,        // (B, Cout, od, oh, ow)
                   int cout, int h, int w, int od, int oh, int ow, int nwb, int hop, int item0) {
  constexpr int RPT = Cfg<SB>::kRpt, RPTR = Cfg<SB>::kRptR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* s_z = reinterpret_cast<float2*>(smem_raw);  // (SB, nbh, 64): Z, then E

  const int nbh = h / 2 + 1, npos = nbh * kTW;
  const int tid = threadIdx.x, cl = tid % kTW, rg = tid / kTW;
  const int it = blockIdx.x / cout, o = blockIdx.x % cout;
  const Item g = item_geom(item0 + it, nwb, hop, w, ow);
  const int d0 = blockIdx.y * SB, ns = min(SB, od - d0);

  // the block's slabs are contiguous in Z; zeros past od
  const float2* zs = z + ((int64_t)blockIdx.x * od + d0) * npos;
  for (int i = tid; i < SB * npos; i += kThreads)
    s_z[i] = i < ns * npos ? __ldg(zs + i) : make_float2(0.f, 0.f);
  __syncthreads();

  // W inverse, in place: each pass reads and then overwrites its own rows
  const Passes ps = split_rows(nbh, kRowGroups * RPT);
  for (int p = 0; p < ps.n; ++p) {
    const int row0 = p * ps.rows, nrow = min(ps.rows, nbh - row0);
    const int nq = own_rows(nrow, rg);
    float2 acc[RPT][SB];
#pragma unroll
    for (int q = 0; q < RPT; ++q)
#pragma unroll
      for (int s = 0; s < SB; ++s) acc[q][s] = make_float2(0.f, 0.f);
#pragma unroll 2
    for (int k = 0; k < kTW; ++k) {
      const float2 u = __ldg(wb + k * kTW + cl);
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        if (q < nq) {
          const int row = row0 + rg + q * kRowGroups;
#pragma unroll
          for (int s = 0; s < SB; ++s) cmac(acc[q][s], s_z[(s * nbh + row) * kTW + k], u);
        }
      }
    }
    __syncthreads();  // every read of this pass's rows is done
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      if (q < nq) {
        const int row = row0 + rg + q * kRowGroups;
#pragma unroll
        for (int s = 0; s < SB; ++s) s_z[(s * nbh + row) * kTW + cl] = acc[q][s];
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
      for (int s = 0; s < SB; ++s) ev[s] = s_z[(s * nbh + n) * kTW + cl];
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
  const float2 *ks, *fh, *wf, *wb, *df, *ei, *ch;
  float2 *t, *s, *z;
  float* out;
  int cin, cout, groups, d, h, w, od, oh, ow, nbd, nwb, hop, item0, nitem;
  cudaStream_t stream;
};

template <int SB>
cudaError_t launch_hw_forward(const Args& a) {
  const size_t smem = Cfg<SB>::smem(a.h / 2 + 1);
  cudaError_t err = cudaFuncSetAttribute(
      fused3d_hw_forward<SB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused3d_hw_forward<SB><<<dim3(a.nitem * a.cin, (a.d + SB - 1) / SB), kThreads, smem, a.stream>>>(
      a.x, a.fh, a.wf, a.t, a.cin, a.d, a.h, a.w, a.ow, a.nwb, a.hop, a.item0);
  return cudaGetLastError();
}

template <int SB>
cudaError_t launch_hw_inverse(const Args& a) {
  const size_t smem = Cfg<SB>::smem(a.h / 2 + 1);
  cudaError_t err = cudaFuncSetAttribute(
      fused3d_hw_inverse<SB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused3d_hw_inverse<SB><<<dim3(a.nitem * a.cout, (a.od + SB - 1) / SB), kThreads, smem, a.stream>>>(
      a.z, a.wb, a.ch, a.out, a.cout, a.h, a.w, a.od, a.oh, a.ow, a.nwb, a.hop, a.item0);
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

cudaError_t launch(const Args& a) {
  const int nbh = a.h / 2 + 1, npos = nbh * kTW;
  const int sb = slabs_per_block(nbh);
  if (sb == 0 || a.groups < 1 || a.cin % a.groups || a.cout % a.groups || a.d < 1 ||
      a.od < 1 || a.od > a.d || a.oh < 1 || a.oh > a.h || a.ow < 1 || a.ow > a.w ||
      a.nbd < 1 || kDHop * a.nbd < a.od || a.nwb < 1 || a.hop < 1 || a.nitem < 1 ||
      a.item0 < 0 || (a.d + sb - 1) / sb > 65535 || a.nbd > 65535 ||
      (a.od + sb - 1) / sb > 65535 || (npos + kThreads - 1) / kThreads > 65535)
    return cudaErrorInvalidValue;
  const int opg = a.cout / a.groups;

  cudaError_t err = sb == 4 ? launch_hw_forward<4>(a)
                  : sb == 2 ? launch_hw_forward<2>(a)
                            : launch_hw_forward<1>(a);
  if (err != cudaSuccess) return err;
  fused3d_d_forward<<<dim3(a.nitem * a.cin, (npos + kThreads - 1) / kThreads), kThreads, 0,
                      a.stream>>>(a.t, a.df, a.s, a.d, nbh, a.nbd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = opg % 4 == 0 ? launch_mac<4>(a) : opg % 2 == 0 ? launch_mac<2>(a) : launch_mac<1>(a);
  if (err != cudaSuccess) return err;
  return sb == 4 ? launch_hw_inverse<4>(a)
       : sb == 2 ? launch_hw_inverse<2>(a)
                 : launch_hw_inverse<1>(a);
}

}  // namespace

// Runs items [item0, item0 + nitem) (item = batch index * nwb + W block) of
// one convolution. x (B, Cin, d, h, w) f32; ks (Cout, Cin/groups, 16, h/2+1,
// 64); fh (h/2+1, h); wf and wb (64, 64); df (16, 16); ei (8, 16); ch (oh,
// h/2+1); scratch t (nitem, Cin, d, h/2+1, 64), s (nitem, Cin, nbd, 16, h/2+1,
// 64), z (nitem, Cout, od, h/2+1, 64); out (B, Cout, od, oh, ow) f32. Complex
// arrays are interleaved (re, im) float pairs. W blocks start at
// min(i * hop, max(w - 64, 0)); with nwb = 1, hop is ow. Returns
// cudaGetLastError() after the four launches (0 when all were accepted).
extern "C" int fused3d_forward(const void* x, const void* ks, const void* fh, const void* wf,
                               const void* wb, const void* df, const void* ei, const void* ch,
                               void* t, void* s, void* z, void* out, int cin, int cout,
                               int groups, int d, int h, int w, int od, int oh, int ow, int nbd,
                               int nwb, int hop, int item0, int nitem, void* stream) {
  Args a;
  a.x = static_cast<const float*>(x);
  a.ks = static_cast<const float2*>(ks);
  a.fh = static_cast<const float2*>(fh);
  a.wf = static_cast<const float2*>(wf);
  a.wb = static_cast<const float2*>(wb);
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
  a.stream = static_cast<cudaStream_t>(stream);
  return launch(a);
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
