// Two-qubit gates on the statevector's (re, im) float32 planes, for Hopper
// (sm_90a).
//
//   pair_gate   a 4x4 complex U on index bits lo < hi, out of place:
//               out[i | ho 2^hi | l' 2^lo]
//                   = sum_{h,l} C[ho, l', h, l] in[i | h 2^hi | l 2^lo]
//               with C the reference's _pair_coeffs(U, qa, qb).
//
// Replaces three entries of quantum_simulations_tpu/ops/pallas_kernels.py:
// pair_update_planar (:960; _pair_col_kernel :898, _pair_row_kernel :915),
// mixed_pair_planar (:1138; _mixed_kernel :1107) and mixed_low_pair_planar
// (:1785; _mixed_low_kernel :1692, _mixed_low_vec_kernel :1740).  On the
// TPU they differ in how the two bits fit the (8, 128) tiling: a lane bit
// is folded into four 128 x 128 lane operators run as MXU matmuls, and
// the pair kernel picks a column or a row view by lo.  None of that
// carries over: the lane-operator products would cost 2^n x 256 complex
// multiply-adds, about 6 ms of float32 work at n = 28, to apply a 4x4 gate.
//
// Bound on an H100 SXM: bytes.  Both planes are read and written once,
// 4.3 GB at n = 28, 1.28 ms at 3.35 TB/s, against 4 complex multiply-adds
// an amplitude (~0.1 ms of float32 instructions).  So the design is about the
// loads: a thread owns whole quads (the four amplitudes that differ in
// bits lo and hi) and reads them as float4s, neighbouring threads on
// neighbouring addresses:
//
//   K = 4 (lo >= 2): a thread reads 4 float4s a plane, one per (h, l),
//                    the four components four independent quads;
//   K = 2 (lo < 2 <= hi): 2 float4s a plane, one per h; bit lo lies
//                    inside the float4, which holds two quads;
//   K = 1 (lo = 0, hi = 1): 1 float4 a plane, one quad.
//
// The 16 complex coefficients are a kernel argument (constant bank).
// Every term is computed: for a permutation gate 1 * x + 0 * y is x, so a
// SWAP or CNOT moves floats exactly.
//
// In place (the ALIAS instance, alias.cuh): it also replaces the in-place
// bodies of the TPU, pair_update_planar's _pair_row_inplace_kernel (:944)
// and midpair_planar's _midpair_kernel (:1187, :1221), and the aliased
// calls of the mixed entries.  It is hazard-free because a thread owns
// whole quads: it loads every amplitude of its quads into registers, and
// its stores, which come after all its loads in program order and write
// exactly those addresses, depend on all of them; no other thread touches
// them.  Without __restrict__ the compiler keeps that order.
//
// The entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError(); the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>

#include "alias.cuh"

namespace {

constexpr int NT = 256;

struct Coeffs {
  float re[16];  // (ho, lo_, h, l) = ((ho * 2 + lo_) * 4 + h * 2 + l)
  float im[16];
};

__device__ __forceinline__ long long insert_zero(long long x, int b) {
  return ((x >> b) << (b + 1)) | (x & ((1LL << b) - 1));
}

// The slot of amplitude (h, l) of quad q among the 4K floats a thread
// loaded: float4 number f, component c.
template <int K, int LO>
__device__ __forceinline__ constexpr int slot(int h, int l, int q) {
  if constexpr (K == 4) return (h * 2 + l) * 4 + q;
  else if constexpr (K == 2) return h * 4 + ((l << LO) | (q << (1 - LO)));
  else return h * 2 + l;
}

// lo4 / hi4: the gate bits in float4 units (bit - 2), where they are >= 2.
template <int K, int LO, bool ALIAS>
__global__ void __launch_bounds__(NT)
pair_gate_kernel(typename qst::Io<float4, ALIAS>::In re,
                 typename qst::Io<float4, ALIAS>::In im,
                 typename qst::Io<float4, ALIAS>::Out ore,
                 typename qst::Io<float4, ALIAS>::Out oim,
                 long long threads, int lo4, int hi4, Coeffs c) {
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  if (t >= threads) return;
  long long off[K];
  if constexpr (K == 4) {
    const long long b = insert_zero(insert_zero(t, lo4), hi4);
    off[0] = b;
    off[1] = b + (1LL << lo4);
    off[2] = b + (1LL << hi4);
    off[3] = b + (1LL << hi4) + (1LL << lo4);
  } else if constexpr (K == 2) {
    const long long b = insert_zero(t, hi4);
    off[0] = b;
    off[1] = b + (1LL << hi4);
  } else {
    off[0] = t;
  }
  float xr[4 * K], xi[4 * K], yr[4 * K], yi[4 * K];
#pragma unroll
  for (int f = 0; f < K; ++f) {
    const float4 a = re[off[f]], b = im[off[f]];
    xr[4 * f] = a.x; xr[4 * f + 1] = a.y; xr[4 * f + 2] = a.z; xr[4 * f + 3] = a.w;
    xi[4 * f] = b.x; xi[4 * f + 1] = b.y; xi[4 * f + 2] = b.z; xi[4 * f + 3] = b.w;
  }
#pragma unroll
  for (int q = 0; q < K; ++q) {
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      float ar = 0.f, ai = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = slot<K, LO>(k >> 1, k & 1, q);
        const float cr = c.re[o * 4 + k], ci = c.im[o * 4 + k];
        ar = fmaf(cr, xr[s], ar);
        ar = fmaf(-ci, xi[s], ar);
        ai = fmaf(cr, xi[s], ai);
        ai = fmaf(ci, xr[s], ai);
      }
      const int s = slot<K, LO>(o >> 1, o & 1, q);
      yr[s] = ar;
      yi[s] = ai;
    }
  }
#pragma unroll
  for (int f = 0; f < K; ++f) {
    ore[off[f]] = make_float4(yr[4 * f], yr[4 * f + 1], yr[4 * f + 2], yr[4 * f + 3]);
    oim[off[f]] = make_float4(yi[4 * f], yi[4 * f + 1], yi[4 * f + 2], yi[4 * f + 3]);
  }
}

template <int K, int LO, bool ALIAS>
int launch(const float* re, const float* im, float* ore, float* oim,
           long long n_amps, int lo4, int hi4, const Coeffs& c, void* stream) {
  const long long threads = n_amps / (4 * K);
  const long long blocks = (threads + NT - 1) / NT;
  pair_gate_kernel<K, LO, ALIAS>
      <<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
          (const float4*)re, (const float4*)im, (float4*)ore, (float4*)oim,
          threads, lo4, hi4, c);
  return (int)cudaGetLastError();
}

template <bool ALIAS>
int launch_class(const float* re, const float* im, float* ore, float* oim,
                 long long n_amps, int lo, int hi, const Coeffs& c,
                 void* stream) {
  if (lo >= 2)
    return launch<4, 0, ALIAS>(re, im, ore, oim, n_amps, lo - 2, hi - 2, c, stream);
  if (hi >= 2) {
    if (lo == 0)
      return launch<2, 0, ALIAS>(re, im, ore, oim, n_amps, 0, hi - 2, c, stream);
    return launch<2, 1, ALIAS>(re, im, ore, oim, n_amps, 0, hi - 2, c, stream);
  }
  return launch<1, 0, ALIAS>(re, im, ore, oim, n_amps, 0, 0, c, stream);
}

}  // namespace

extern "C" {

const char* qst_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// n_amps = 2^n >= 4; 0 <= lo < hi < n; coeffs: 16 real parts then 16
// imaginary parts of C in (ho, lo_, h, l) order, on the host.  The planes
// must be 16-byte aligned.  In place when ore == re and oim == im.
int qst_pair_gate(const float* re, const float* im, float* ore, float* oim,
                  long long n_amps, int lo, int hi, const float* coeffs,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int alias = qst::alias_mode(re, im, ore, oim);
  if (alias < 0 || n_amps < 4 || (n_amps & (n_amps - 1)) || lo < 0 ||
      lo >= hi || (1LL << hi) >= n_amps)
    return (int)cudaErrorInvalidValue;
  Coeffs c;
  for (int k = 0; k < 16; ++k) {
    c.re[k] = coeffs[k];
    c.im[k] = coeffs[16 + k];
  }
  if (alias)
    return launch_class<true>(re, im, ore, oim, n_amps, lo, hi, c, stream);
  return launch_class<false>(re, im, ore, oim, n_amps, lo, hi, c, stream);
}

}  // extern "C"
