// bf16 tensor-core DFT steps for Hopper (sm_90a): the pieces the fused
// kernels' tensor-core modes share ("bf16x3" and "bf16", the JAX package's
// precision modes of the same names, fft_conv_tpu/kernels/fused1d.py:177).
//
// A complex R-point DFT step is the real (2R x 2R) matrix [[Fr, Fi], [-Fi, Fr]]
// applied to vectors stored as (re, im) pairs. The vectors are the A operand
// of mma.sync m16n8k16, 16 a tile, one complex element a 32-bit register of
// two bf16; the DFT matrix is the B operand, laid out on the host in the order
// of the B fragments (fused1d.py: _b_fragments), so that a lane reads each
// fragment as one 8-byte load through L1. Each lane's pair of accumulators is
// then one complex output. Every operand is split hi = bf16(x), lo =
// bf16(x - hi); "bf16x3" (X3) accumulates lo.hi + hi.lo in one FP32 fragment
// and hi.hi in another, added at the end, "bf16" hi.hi alone.
//
// Included by fused1d.cu, fused2d.cu and fused3d.cu. fused3d.cu runs an
// r-point DFT of any r <= 16 as a step of size step_size(r), the r x r
// matrix in the corner of the larger one: its loads past r read zeros and its
// stores past r are dropped. Its matrices come in a table per call
// (fused3d.py: _tc_fragments_3d), each matrix's block table_words(R) words
// long.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bf16_mma {

// acc += A B for one 16 x 16 A fragment a and one 16 x 8 B fragment b, bf16
// operands, FP32 accumulator.
__device__ __forceinline__ void mma(float (&acc)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// v as one bf16 pair (re, im) in *hi and, under X3, the bf16 pair of what hi
// leaves out in *lo.
template <bool X3>
__device__ __forceinline__ void split(float2 v, uint32_t* hi, uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  if (X3) {
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(v.x - hf.x, v.y - hf.y);
    *lo = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// Words of the fragment buffer (fused2d.py: _tc_fragments) before the R-point
// matrices, for R in (8, 16, 24): each forward then conjugated, each its hi
// then its lo fragments, 2 R^2 words a half.
__host__ __device__ constexpr int frag_offset(int r, bool inv) {
  return (r == 8 ? 0 : r == 16 ? 4 * 2 * 64 : 4 * 2 * (64 + 256)) + (inv ? 2 * 2 * r * r : 0);
}

// The step size of an r-point DFT (r <= 16): whole k-steps of 8 points.
__host__ __device__ constexpr int step_size(int r) { return r <= 8 ? 8 : 16; }

// Words of one R-point matrix's block in a per-call table: the forward
// matrix and then the conjugated one, each its hi and then its lo fragments.
__host__ __device__ constexpr int table_words(int r) { return 4 * 2 * r * r; }

// The B fragment of k-step ks and n-tile nt of one half (hi or lo) of an
// R-point matrix, for this lane (the layout dft_step reads).
template <int R>
__device__ __forceinline__ uint2 b_frag(const uint32_t* __restrict__ half, int ks, int nt,
                                        int lane) {
  return __ldg(reinterpret_cast<const uint2*>(half) + (ks * (R / 4) + nt) * 32 + lane);
}

// One 16-vector tile of a complex R-point DFT step (R a multiple of 8) on the
// tensor cores, run by one warp: vectors m0 + g and m0 + g + 8 of this lane's
// group g, those past nvec zeros and not stored. ld(m, j) gives element j of
// vector m as FP32 (read from shared memory, with any FP32 arithmetic the
// step's input needs), split into bf16 here; st(m, k, value) receives output
// k of vector m. frag points at the step's matrix (hi fragments, then lo).
// The warp loads the tile's A fragments, all R elements of its 16 vectors,
// then runs the n-tiles of 4 outputs NU at a time, each with its own
// accumulators so that their product chains overlap. All of the tile's loads
// are done before any of its stores (__syncwarp), so st may write in place
// over the tile's own inputs. No barrier. FULL: every tile is whole (nvec a
// multiple of 16), so that no vector is checked and no load sits in a branch.
template <int R, bool X3, bool FULL = false, typename LD, typename ST>
__device__ __forceinline__ void dft_tile(int m0, int nvec, const uint32_t* __restrict__ frag,
                                         LD ld, ST st) {
  static_assert(R % 8 == 0, "a DFT step takes whole k-steps of 8 complex elements");
  constexpr int KS = R / 8, NT = R / 4, NU = NT < 4 ? NT : 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* fl = frag + 2 * R * R;
  const int ma = m0 + g, mb = ma + 8;
  const bool live0 = FULL || ma < nvec, live1 = FULL || mb < nvec;
  uint32_t ah[KS][4], al[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int j = ks * 8 + t;
    const float2 zero = make_float2(0.f, 0.f);
    split<X3>(live0 ? ld(ma, j) : zero, &ah[ks][0], &al[ks][0]);
    split<X3>(live1 ? ld(mb, j) : zero, &ah[ks][1], &al[ks][1]);
    split<X3>(live0 ? ld(ma, j + 4) : zero, &ah[ks][2], &al[ks][2]);
    split<X3>(live1 ? ld(mb, j + 4) : zero, &ah[ks][3], &al[ks][3]);
  }
  __syncwarp();
#pragma unroll 1
  for (int nt = 0; nt < NT; nt += NU) {
    float acc[NU][4] = {}, acl[NU][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        if (nt + u < NT) {  // uniform across the warp
          const uint2 bh = b_frag<R>(frag, ks, nt + u, lane);
          if (X3) {
            mma(acl[u], al[ks], bh);
            mma(acl[u], ah[ks], b_frag<R>(fl, ks, nt + u, lane));
          }
          mma(acc[u], ah[ks], bh);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      if (nt + u < NT) {
        if (X3) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[u][e] += acl[u][e];
        }
        const int k = (nt + u) * 4 + t;
        if (live0) st(ma, k, make_float2(acc[u][0], acc[u][1]));
        if (live1) st(mb, k, make_float2(acc[u][2], acc[u][3]));
      }
    }
  }
}

// One complex R-point DFT step of nvec vectors (dft_tile's ld, st and
// frag, FULL), its tiles of 16 vectors dealt to the block's NW warps in turn.
// Only the warp that holds a tile touches its vectors, so st may write in
// place. No barrier.
template <int R, bool X3, int NW, bool FULL = false, typename LD, typename ST>
__device__ __forceinline__ void dft_step(int nvec, const uint32_t* __restrict__ frag, LD ld,
                                         ST st) {
  const int mtiles = (nvec + 15) / 16;
  for (int tile = threadIdx.x >> 5; tile < mtiles; tile += NW)
    dft_tile<R, X3, FULL>(tile * 16, nvec, frag, ld, st);
}

}  // namespace bf16_mma
