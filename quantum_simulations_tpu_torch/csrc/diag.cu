// fused_diag: a merged run of diagonal gates in one pass over (re, im)
// float32 planes, for Hopper (sm_90a).
//
//   out[i] = in[i] * exp(i theta(i)),  theta from the packed Moebius terms
//   (phase.cuh).
//
// Replaces fused_diag_planar (quantum_simulations_tpu/ops/pallas_kernels.py
// :1483) and its three Pallas bodies: _fused_diag_matmul_kernel (:1297,
// with _theta_matmul :1269), _fused_diag_kernel (:1309) and
// _fused_diag_small_kernel (:1372).  The TPU builds the angle field of a
// block as one MXU product; here a block of 32 rows x 128 lanes computes
// each group's row angle once per row (phase.cuh) and each element adds
// one angle per group, in fixed-point turns.
//
// Bound on an H100 SXM: bytes.  Both planes are read and written once,
// 4 x 4 B x 2^28 = 4.3 GB at n = 28, 1.28 ms at 3.35 TB/s; the phase
// costs one sincospif and a few adds per element.
//
// In place (the ALIAS instance, alias.cuh): hazard-free because each
// thread loads its 8 elements of each plane into registers before it
// computes their angles, and stores exactly those 8 after; no other thread
// touches them.
//
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError(); the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>

#include "alias.cuh"
#include "phase.cuh"

namespace {

constexpr int NT = 512;
constexpr int TSTEP = NT / qst::PHASE_LANES;  // rows a pass of the block covers
constexpr int J = 8;                          // elements per thread and plane
constexpr int ROWS = J * TSTEP;               // 32 rows of 128 lanes per block

template <bool ALIAS>
__global__ void __launch_bounds__(NT)
fused_diag_kernel(typename qst::Io<float, ALIAS>::In re,
                  typename qst::Io<float, ALIAS>::In im,
                  typename qst::Io<float, ALIAS>::Out ore,
                  typename qst::Io<float, ALIAS>::Out oim,
                  long long N, qst::Phase ph) {
  __shared__ uint32_t scratch[qst::phase_scratch_words(ROWS)];
  const int lane = threadIdx.x % qst::PHASE_LANES;
  const int t0 = threadIdx.x / qst::PHASE_LANES;
  const long long row0 = (long long)blockIdx.x * ROWS;
  float xr[J], xi[J];
  // Loads first, so they are in flight while the angles are computed.
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const long long i = (row0 + t0 + TSTEP * j) * qst::PHASE_LANES + lane;
    xr[j] = i < N ? re[i] : 0.f;
    xi[j] = i < N ? im[i] : 0.f;
  }
  uint32_t acc[J];
  qst::phase_angles<J, TSTEP>(ph, row0, 1, lane, t0, scratch, acc);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const long long i = (row0 + t0 + TSTEP * j) * qst::PHASE_LANES + lane;
    if (i < N) {
      qst::phase_rotate(xr[j], xi[j], acc[j]);
      ore[i] = xr[j];
      oim[i] = xi[j];
    }
  }
}

}  // namespace

extern "C" {

const char* qst_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// N = 2^n amplitudes (any n >= 0); phase: the packed DiagTerms operand
// with G groups and T row-side terms.  In place when ore == re and
// oim == im, else out of place.
int qst_fused_diag(const float* re, const float* im, float* ore, float* oim,
                   long long N, const void* phase, int G, int T, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int alias = qst::alias_mode(re, im, ore, oim);
  if (alias < 0 || phase == nullptr || N < 1) return (int)cudaErrorInvalidValue;
  const qst::Phase ph{(const uint32_t*)phase, G, T};
  const long long per_block = (long long)ROWS * qst::PHASE_LANES;
  const long long blocks = (N + per_block - 1) / per_block;
  cudaStream_t st = (cudaStream_t)stream;
  if (alias)
    fused_diag_kernel<true><<<(unsigned)blocks, NT, 0, st>>>(re, im, ore, oim, N, ph);
  else
    fused_diag_kernel<false><<<(unsigned)blocks, NT, 0, st>>>(re, im, ore, oim, N, ph);
  return (int)cudaGetLastError();
}

}  // extern "C"
