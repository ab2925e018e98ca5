// Diagonal phase of a merged run of diagonal gates, shared by the
// fused_diag kernel (diag.cu) and the diag epilogue of the panel kernels
// (panels.cu).
//
// psi[i] *= exp(i theta(i)), theta(i) = sum over Moebius terms (S, coeff)
// of coeff * prod_{q in S} bit_q(i).  The flat index splits as
// row = i >> 7 and lane = i & 127 (as ops/diag_plan.py splits it), and the
// host (ops/diag_kernels.DiagTerms) sorts each term by its lane bits L
// (< 7) and its row bits R (>= 7):
//
//   R empty        -> a 128-entry lane table (the global term too);
//   L, R nonempty  -> one group per distinct L: its row angle is the sum
//   or L empty        of its terms over the row, and it applies where the
//                     lane has every bit of L set (L empty: everywhere).
//
// A tile of rows computes each group's row angle once per row, so an
// element pays one add per group, not one per term.
//
// Angles are 32-bit fixed-point turns (coeff / 2pi * 2^32, rounded once
// per term on the host) summed in uint32 with wraparound: the sum is
// exact mod 2pi however large sum |coeff| grows (129-151 rad for the
// merged runs of qaoa_maxcut(28)), and each term is off by at most
// 7.3e-10 rad.  An element converts its angle to radians once and takes
// the accurate sincospif (no fast-math intrinsic).
//
// Packed operand (uint32 words):
//   [0, 128)              lane table
//   [128, 128 + G)        lmask[g]: the lane bits L of group g
//   then G + 1 words      start[g]: first term of group g (start[G] = T)
//   then T words          rmask[t]: the row bits R of term t (bit q - 7)
//   then T words          coeff[t]: its fixed-point angle
#pragma once

#include <cstdint>

namespace qst {

constexpr int PHASE_LANES = 128;
constexpr int PHASE_GC = 64;  // groups whose row angles are staged at once

struct Phase {
  const uint32_t* words;  // the packed operand, or null: no phase
  int G;                  // groups
  int T;                  // row-side terms
};

// Shared-memory words that phase_angles needs for a tile of `rows` rows.
__host__ __device__ constexpr int phase_scratch_words(int rows) {
  return PHASE_GC * rows + PHASE_GC;
}

// Fixed-point angles of this thread's elements of a tile of J * TSTEP
// rows: the elements (row0 + t * row_step, lane) for t = t0 + TSTEP * j,
// j < J, land in acc[j].  `scratch` holds phase_scratch_words(J * TSTEP)
// words of shared memory.  Every thread of the block must call it; it
// starts and ends with a barrier.
template <int J, int TSTEP>
__device__ void phase_angles(const Phase& ph, unsigned long long row0,
                             unsigned long long row_step, int lane, int t0,
                             uint32_t* scratch, uint32_t (&acc)[J]) {
  constexpr int ROWS = J * TSTEP;
  const uint32_t* lmask = ph.words + PHASE_LANES;
  const uint32_t* start = lmask + ph.G;
  const uint32_t* rmask = start + ph.G + 1;
  const uint32_t* coeff = rmask + ph.T;
  uint32_t* th = scratch;                 // [PHASE_GC][ROWS]
  uint32_t* lm = scratch + PHASE_GC * ROWS;
  const uint32_t a0 = __ldg(ph.words + lane);
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = a0;
  for (int g0 = 0; g0 < ph.G; g0 += PHASE_GC) {
    const int gc = min(PHASE_GC, ph.G - g0);
    __syncthreads();  // the previous chunk (or the caller's data) is consumed
    for (int e = threadIdx.x; e < gc * ROWS; e += blockDim.x) {
      const int g = g0 + e / ROWS;
      const uint32_t row = (uint32_t)(row0 + (unsigned long long)(e % ROWS) * row_step);
      uint32_t a = 0;
      const int k1 = __ldg(start + g + 1);
      for (int k = __ldg(start + g); k < k1; ++k) {
        const uint32_t m = __ldg(rmask + k);
        a += (row & m) == m ? __ldg(coeff + k) : 0u;
      }
      th[e] = a;
    }
    for (int e = threadIdx.x; e < gc; e += blockDim.x) lm[e] = __ldg(lmask + g0 + e);
    __syncthreads();
    for (int g = 0; g < gc; ++g) {
      const uint32_t m = lm[g];
      if (((uint32_t)lane & m) == m) {
#pragma unroll
        for (int j = 0; j < J; ++j) acc[j] += th[g * ROWS + t0 + TSTEP * j];
      }
    }
  }
  __syncthreads();  // scratch is free again
}

// (re, im) *= exp(i * 2pi * a / 2^32).  The signed reading of a is in
// [-2^31, 2^31); its float rounding is off by at most 9.4e-8 rad.
__device__ __forceinline__ void phase_rotate(float& re, float& im, uint32_t a) {
  float s, c;
  sincospif((float)(int32_t)a * 0x1p-31f, &s, &c);
  const float r = re;
  re = fmaf(r, c, -im * s);
  im = fmaf(r, s, im * c);
}

}  // namespace qst
