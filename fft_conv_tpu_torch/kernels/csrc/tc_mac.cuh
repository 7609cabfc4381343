// The MAC stage that the tensor-core routes of the fused 1D and 2D kernels
// share (fused1d.cu: fused1d_mac_tc, kernel B1 under "bf16x3" and "bf16";
// fused2d.cu: fused2d_mac_tc, kernels B2 and B5 under those modes), and the
// cp.async copies it and those routes stage their data with.
//
// One bin row of a grouped per-bin complex MAC, Y[u, o] = sum_c D[u, c]
// K[o, c] in FP32 in the channels' order, for a block's units u (a unit is
// one overlap-save block or tile of one batch row) and output channels o.
// D's rows of one unit are contiguous by channel and the kernel spectra's
// rows are reached by strides, so the same code serves B2's spectra (Cout,
// Cin/g, NB1, T2) and B1's (Cout, N1/2+1, Cin/g, 128). One read of a D row
// serves every output channel of the block, and one read of a block's
// spectra all of its units. Included by fused1d.cu and fused2d.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc_mac {

// Asynchronous copies into shared memory (cp.async): 16 or 8 bytes, or 4
// bytes of which only the first `bytes` are read (the rest zero-filled);
// copies committed as groups, waited for as all or all but the N newest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc += a * b (complex)
__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

// Index of (row, column) in a swizzled plane of rows of T2 complex values:
// column c ^ (row & 15), so that neighbouring rows fall in distinct banks.
template <int T2>
__device__ __forceinline__ int sw(int r, int c) {
  return r * T2 + (c ^ (r & 15));
}

// The MAC of one bin row by a block of NT threads, into plane rows u * oc +
// o of s_p (swizzled by sw<T2>) for units u < nu and output channels o < oc.
// d: D's row of the block's first unit and the group's first channel, unit
// u's channel c at d + u d_unit + c d_chan; k: the spectra's row of the
// block's first output channel, channel c of output o at k + o k_out + c
// k_chan. Each thread takes one column and, a pass, OJ output channels; a
// chunk of KC input channels at a time it holds their spectra in registers
// (read once a block), while the block streams D's rows unit by unit
// through a ring of NS units in shared memory (16-byte cp.async, NS - 1
// units ahead, a barrier a unit), each value serving the NT / T2 threads of
// its column and their OJ output channels each; the sums stay in the plane
// between chunks. ring holds NS * KC * T2 values. Ends with every copy
// landed and a barrier.
template <int T2, int NT, int OJ, int KC, int NS>
__device__ __forceinline__ void mac_rows(float2* s_p, float2* ring, const float2* __restrict__ d,
                                         int64_t d_unit, int64_t d_chan,
                                         const float2* __restrict__ k, int64_t k_out,
                                         int64_t k_chan, int cpg, int nu, int oc) {
  constexpr int L = NT / T2;
  static_assert(NT % T2 == 0, "a block's threads take whole rows");
  const int tid = threadIdx.x, col = tid % T2, lane = tid / T2;
  const float2* kk = k + col;
  for (int ob = 0; ob < oc; ob += L * OJ) {
    for (int c0 = 0; c0 < cpg; c0 += KC) {
      const int nc = min(KC, cpg - c0);
      // unit u's rows D[u, c0 .. c0 + nc] into ring stage u % NS by the
      // whole block, 16 bytes a copy; one commit group a unit (empty past
      // the block's units)
      auto stage = [&](int u) {
        if (u < nu) {
          const float2* src = d + u * d_unit + c0 * d_chan;
          float2* dst = ring + (u % NS) * KC * T2;
          for (int i = tid; i < nc * T2 / 2; i += NT) {
            const int c = i / (T2 / 2), q = 2 * (i % (T2 / 2));
            cp_async16(dst + c * T2 + q, src + c * d_chan + q);
          }
        }
        cp_async_commit();
      };
#pragma unroll
      for (int u = 0; u < NS - 1; ++u) stage(u);
      float2 kr[OJ][KC];
#pragma unroll
      for (int j = 0; j < OJ; ++j) {
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const int o = ob + lane + L * j;
          kr[j][c] = o < oc && c < nc ? __ldg(kk + o * k_out + (c0 + c) * k_chan)
                                      : make_float2(0.f, 0.f);
        }
      }
      for (int u = 0; u < nu; ++u) {
        cp_async_wait<NS - 2>();  // this thread's copies of unit u have landed
        __syncthreads();  // every thread's have, and stage (u - 1) % NS is read
        stage(u + NS - 1);
        const float2* src = ring + (u % NS) * KC * T2 + col;
        float2 acc[OJ];
#pragma unroll
        for (int j = 0; j < OJ; ++j) {
          const int o = ob + lane + L * j;
          acc[j] = c0 > 0 && o < oc ? s_p[sw<T2>(u * oc + o, col)] : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          if (c < nc) {
            const float2 dv = src[c * T2];
#pragma unroll
            for (int j = 0; j < OJ; ++j) cmac(acc[j], dv, kr[j][c]);
          }
        }
#pragma unroll
        for (int j = 0; j < OJ; ++j) {
          const int o = ob + lane + L * j;
          if (o < oc) s_p[sw<T2>(u * oc + o, col)] = acc[j];
        }
      }
      __syncthreads();  // the ring is read before the next chunk's prologue refills it
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

}  // namespace tc_mac
