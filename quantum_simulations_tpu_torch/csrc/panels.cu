// Complex panel kernels of the window path, for Hopper (sm_90a).
//
// The statevector is two float32 planes (re, im) of 2^n amplitudes; index
// bit q is qubit q.  A panel W (dim x dim complex, dim = 2^w <= 128) acts
// on the bit window [pos, pos + w):  out[a, i, c] = sum_k W[i, k] x[a, k, c]
// over the view (A, dim, C = 2^pos).  Three kernels:
//
//   lane_panel        pos == 0: the view (R, dim),
//                     out[r, i] = sum_k W[i, k] x[r, k].
//                     Replaces panel_apply_planar / _panel_kernel
//                     (quantum_simulations_tpu/ops/pallas_kernels.py:93,
//                     :137).  ROTATE (its rotate=True, the transposed
//                     store of :116-118): out[i, r] instead, the (dim, R)
//                     flat result, so the pass also rotates the index bits
//                     right by log2(dim) (the rotating-panel schedule's
//                     panel + RotateOp(7) in one pass).  Tile element
//                     (r, i) goes to out[i * R + r0 + r]: for each i a run
//                     of up to 128 contiguous floats, read down a column
//                     of the padded tile (LD = 129: conflict-free).  Out of
//                     place only, as the reference asserts (:202): block b
//                     writes a column slab of every output row, which other
//                     blocks still read.
//   positioned_panel  pos >= 7 (any pos works): the view (A, dim, C).
//                     Replaces positioned_panel_planar (:636) and its
//                     three Pallas bodies: _positioned_row_kernel (:553,
//                     pos 7..9 and the ragged dim < 128 path) and
//                     _positioned_4d_kernel (:605, pos >= 10).
//   dual_panel        the (0, 7) panel pair on the (A, 128, 128) view in
//                     ONE pass, in op order, with an optional straddler
//                     gate on (6, qb in 7..13) before and after.
//                     Replaces dual_panel_planar / _dual_panel_kernel
//                     (:343, :409) with _straddle_plan /
//                     _straddle_prologue (:229, :278).
//
// Bound on an H100 SXM.  One pass over n = 28 moves 2^28 x 16 B = 4.3 GB
// (1.28 ms at 3.35 TB/s) and does 2^28 x dim complex multiply-adds.  By
// Gauss's three real products each needs 6 flop: 2^28 x 772 = 2.1e11 flop
// for dim = 128 (twice that for dual_panel; a CNOT straddler adds none).
// At the 67 TFLOP/s float32 rate outside the tensor cores that is 3.1 ms,
// so every kernel here is bound by operations, not bytes.
//
// What the simple design does about it.  A block of 512 threads owns one
// tile of up to 128 x 128 complex amplitudes in shared memory (two padded
// float planes, 129 KB), read from device memory once and written once.
// The contraction runs over the tile in place: W is staged in chunks of 32
// columns, each thread keeps a 4 x 8 micro-tile of complex sums in
// registers (4 fused multiply-adds per complex product, float32
// throughout: no TF32), so each shared-memory read feeds 5 FMAs on
// average.  dual_panel applies both contractions and the straddler gates
// to the same resident tile, so the pair costs one pass of traffic.
// Making it fast (split-precision wgmma, TMA, a tile ring) is later work.
//
// Diag epilogue (the reference's diag_terms option, pallas_kernels.py
// :171-188, :462-503, :676-682, :725-818).  A 128-wide panel whose tile
// rows are whole state rows of 128 lanes (lane panel, positioned pos >= 7,
// dual) can apply the merged diagonal run that follows it to the resident
// tile after its last contraction (and post-straddler), before the store:
// phase.cuh, with the freed W chunk as scratch.  It adds no traffic.
//
// In place (the capacity tier; alias.cuh).  Each kernel has an ALIAS
// instance, launched when the output planes are the input planes.  It is
// hazard-free because a block owns a disjoint slab of the state (a lane
// panel's 128 rows, a positioned panel's (a, c-tile) column block, a dual
// panel's (128, 128) tile): it reads the whole slab into shared memory,
// the barrier at the top of contract() (dual_panel: the one after the
// load) orders every one of those loads before any thread goes on, and
// the stores come after the last barrier.  Each shared-memory store of
// the load loop consumes its global load, so no load is still in flight
// when the slab is overwritten.
//
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError(); the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>

#include "alias.cuh"
#include "phase.cuh"

namespace {

constexpr int TX = 16;            // threads along the tile's free axis c
constexpr int TY = 32;            // threads along the contracted output axis i
constexpr int NT = TX * TY;       // 512 threads per block
constexpr int TILE = 128;         // tile extent on both axes (max dim)
constexpr int LD = TILE + 1;      // padded row stride: conflict-free columns
constexpr int KC = 32;            // W columns staged per chunk
constexpr int LDW = KC + 1;
constexpr int NJ = TILE / TX;     // output columns per thread
constexpr size_t SMEM_BYTES =
    sizeof(float) * (2 * TILE * LD + 2 * TILE * LDW);  // 165,888 B

struct Smem {
  float* tr;  // tile, real plane   [TILE][LD]
  float* ti;  // tile, imaginary plane
  float* wr;  // W chunk, real      [TILE][LDW]
  float* wi;
};

__device__ __forceinline__ Smem smem_parts() {
  extern __shared__ float smem[];
  return {smem, smem + TILE * LD, smem + 2 * TILE * LD,
          smem + 2 * TILE * LD + TILE * LDW};
}

// tile[i, c] <- sum_k W[i, k] tile[k, c] for i, k < DIM and c < TILE, with
// tile element (k, c) at shared offset k * SK + c * SC.  W is row-major
// dim x dim in device memory.  Every thread of the block must call it.
template <int DIM, int SK, int SC>
__device__ void contract(const float* __restrict__ wr,
                         const float* __restrict__ wi, const Smem& s) {
  constexpr int M = DIM >= TY ? DIM / TY : 1;
  constexpr int KCH = DIM < KC ? DIM : KC;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const bool active = DIM >= TY || ty < DIM;
  float ar[M][NJ], ai[M][NJ];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j) ar[m][j] = ai[m][j] = 0.f;

  for (int k0 = 0; k0 < DIM; k0 += KCH) {
    __syncthreads();  // the previous chunk is consumed
    for (int e = threadIdx.x; e < DIM * KCH; e += NT) {
      const int i = e / KCH, kk = e % KCH;
      s.wr[i * LDW + kk] = wr[i * DIM + k0 + kk];
      s.wi[i * LDW + kk] = wi[i * DIM + k0 + kk];
    }
    __syncthreads();
    if (active) {
#pragma unroll 2
      for (int kk = 0; kk < KCH; ++kk) {
        const int k = k0 + kk;
        float xr[NJ], xi[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int o = k * SK + (tx + TX * j) * SC;
          xr[j] = s.tr[o];
          xi[j] = s.ti[o];
        }
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float a = s.wr[(ty + TY * m) * LDW + kk];
          const float b = s.wi[(ty + TY * m) * LDW + kk];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            ar[m][j] = fmaf(a, xr[j], ar[m][j]);
            ar[m][j] = fmaf(-b, xi[j], ar[m][j]);
            ai[m][j] = fmaf(a, xi[j], ai[m][j]);
            ai[m][j] = fmaf(b, xr[j], ai[m][j]);
          }
        }
      }
    }
  }
  __syncthreads();  // every read of the tile is done: overwrite in place
  if (active) {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int o = (ty + TY * m) * SK + (tx + TX * j) * SC;
        s.tr[o] = ar[m][j];
        s.ti[o] = ai[m][j];
      }
  }
  __syncthreads();
}

// The 2-qubit gate U on (lane bit 6, row bit qb - 7) of a resident
// (128, 128) tile, U in (6, qb) order: basis b = 2 * bit6 + bit_qb.  The
// reference's coefficient planes C_k[p] = U[b(p), b(p) ^ k] depend on p
// only through b(p), so sum_k C_k[p] x[p ^ flip_k] is a 4 x 4 product on
// each orbit {p, p ^ d, p ^ 64, p ^ d ^ 64}; a thread owns whole orbits,
// so the update is in place without a race.  u: Re U (16), then Im U (16).
__device__ void straddle(const float* __restrict__ u, int qb, const Smem& s) {
  const int dbit = qb - 7;
  float ur[16], ui[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    ur[t] = u[t];
    ui[t] = u[16 + t];
  }
  for (int o = threadIdx.x; o < TILE * TILE / 4; o += NT) {
    const int lo = o & 63;      // lane bits 0..5
    const int rest = o >> 6;    // the 6 row bits other than dbit
    const int d = ((rest >> dbit) << (dbit + 1)) | (rest & ((1 << dbit) - 1));
    int off[4];
    float xr[4], xi[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      off[b] = (d | ((b & 1) << dbit)) * LD + (lo | ((b >> 1) << 6));
      xr[b] = s.tr[off[b]];
      xi[b] = s.ti[off[b]];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float yr = 0.f, yi = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        yr = fmaf(ur[4 * b + c], xr[c], yr);
        yr = fmaf(-ui[4 * b + c], xi[c], yr);
        yi = fmaf(ur[4 * b + c], xi[c], yi);
        yi = fmaf(ui[4 * b + c], xr[c], yi);
      }
      s.tr[off[b]] = yr;
      s.ti[off[b]] = yi;
    }
  }
  __syncthreads();
}

// The diag epilogue on a resident 128 x 128 tile: element (t, lane) at
// shared offset t * LD + lane lies in state row row0 + t * row_step.  The W
// chunk is free after the last contraction and holds the phase scratch.
static_assert(qst::phase_scratch_words(TILE) <= 2 * TILE * LDW,
              "the phase scratch must fit the W chunk");

__device__ void diag_epilogue(const qst::Phase& ph, unsigned long long row0,
                              unsigned long long row_step, const Smem& s) {
  constexpr int TSTEP = NT / TILE;
  constexpr int J = TILE / TSTEP;
  const int lane = threadIdx.x % TILE, t0 = threadIdx.x / TILE;
  uint32_t acc[J];
  qst::phase_angles<J, TSTEP>(ph, row0, row_step, lane, t0,
                              reinterpret_cast<uint32_t*>(s.wr), acc);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int o = (t0 + TSTEP * j) * LD + lane;
    qst::phase_rotate(s.tr[o], s.ti[o], acc[j]);
  }
  __syncthreads();
}

// ---- lane_panel: view (R, DIM); tile = 128 rows (c) x DIM lanes (k). ----
template <int DIM, bool ALIAS, bool ROTATE>
__global__ void __launch_bounds__(NT, 1)
lane_panel_kernel(typename qst::Io<float, ALIAS>::In re,
                  typename qst::Io<float, ALIAS>::In im,
                  const float* __restrict__ wr, const float* __restrict__ wi,
                  typename qst::Io<float, ALIAS>::Out ore,
                  typename qst::Io<float, ALIAS>::Out oim,
                  long long rows, qst::Phase ph) {
  static_assert(!(ROTATE && ALIAS), "the rotated store is out of place only");
  const Smem s = smem_parts();
  const long long r0 = (long long)blockIdx.x * TILE;
  const int nr = (int)min((long long)TILE, rows - r0);
  const long long base = r0 * DIM;
  for (int e = threadIdx.x; e < TILE * DIM; e += NT) {
    const int r = e / DIM, k = e % DIM;
    const bool ok = r < nr;
    s.tr[r * LD + k] = ok ? re[base + e] : 0.f;
    s.ti[r * LD + k] = ok ? im[base + e] : 0.f;
  }
  contract<DIM, 1, LD>(wr, wi, s);
  if constexpr (DIM == TILE && !ROTATE) {
    if (ph.words != nullptr) diag_epilogue(ph, r0, 1, s);
  }
  if constexpr (ROTATE) {
    for (int e = threadIdx.x; e < DIM * TILE; e += NT) {
      const int k = e / TILE, r = e % TILE;
      if (r < nr) {
        ore[k * rows + r0 + r] = s.tr[r * LD + k];
        oim[k * rows + r0 + r] = s.ti[r * LD + k];
      }
    }
  } else {
    for (int e = threadIdx.x; e < nr * DIM; e += NT) {
      const int r = e / DIM, k = e % DIM;
      ore[base + e] = s.tr[r * LD + k];
      oim[base + e] = s.ti[r * LD + k];
    }
  }
}

// ---- positioned_panel: view (A, DIM, C); tile = DIM rows (k) x 128 c. ----
template <int DIM, bool ALIAS>
__global__ void __launch_bounds__(NT, 1)
positioned_panel_kernel(typename qst::Io<float, ALIAS>::In re,
                        typename qst::Io<float, ALIAS>::In im,
                        const float* __restrict__ wr,
                        const float* __restrict__ wi,
                        typename qst::Io<float, ALIAS>::Out ore,
                        typename qst::Io<float, ALIAS>::Out oim, long long C,
                        long long tiles_per_a, qst::Phase ph) {
  const Smem s = smem_parts();
  const long long a = blockIdx.x / tiles_per_a;
  const long long c0 = (blockIdx.x % tiles_per_a) * TILE;
  const int nc = (int)min((long long)TILE, C - c0);
  const long long base = a * DIM * C + c0;
  for (int e = threadIdx.x; e < DIM * TILE; e += NT) {
    const int k = e / TILE, c = e % TILE;
    const bool ok = c < nc;
    s.tr[k * LD + c] = ok ? re[base + k * C + c] : 0.f;
    s.ti[k * LD + c] = ok ? im[base + k * C + c] : 0.f;
  }
  contract<DIM, LD, 1>(wr, wi, s);
  if constexpr (DIM == TILE) {  // the host asks for it only with C >= 128
    if (ph.words != nullptr) diag_epilogue(ph, base / TILE, C / TILE, s);
  }
  for (int e = threadIdx.x; e < DIM * TILE; e += NT) {
    const int k = e / TILE, c = e % TILE;
    if (c < nc) {
      ore[base + k * C + c] = s.tr[k * LD + c];
      oim[base + k * C + c] = s.ti[k * LD + c];
    }
  }
}

// ---- dual_panel: view (A, 128, 128) = (a, d = bits 7..13, l = bits 0..6).
// mode 0 ("lane", pos 0) contracts l; mode 1 ("full", pos 7) contracts d.
__device__ __forceinline__ void contract_mode(int mode, const float* wr,
                                              const float* wi, const Smem& s) {
  if (mode == 0)
    contract<TILE, 1, LD>(wr, wi, s);
  else
    contract<TILE, LD, 1>(wr, wi, s);
}

template <bool ALIAS>
__global__ void __launch_bounds__(NT, 1)
dual_panel_kernel(typename qst::Io<float, ALIAS>::In re,
                  typename qst::Io<float, ALIAS>::In im,
                  const float* __restrict__ w1r, const float* __restrict__ w1i,
                  int mode1, const float* __restrict__ w2r,
                  const float* __restrict__ w2i, int mode2,
                  const float* __restrict__ u_pre, int qb_pre,
                  const float* __restrict__ u_post, int qb_post,
                  typename qst::Io<float, ALIAS>::Out ore,
                  typename qst::Io<float, ALIAS>::Out oim, qst::Phase ph) {
  const Smem s = smem_parts();
  const long long base = (long long)blockIdx.x * TILE * TILE;
  for (int e = threadIdx.x; e < TILE * TILE; e += NT) {
    const int d = e / TILE, l = e % TILE;
    s.tr[d * LD + l] = re[base + e];
    s.ti[d * LD + l] = im[base + e];
  }
  __syncthreads();
  if (u_pre != nullptr) straddle(u_pre, qb_pre, s);
  contract_mode(mode1, w1r, w1i, s);
  contract_mode(mode2, w2r, w2i, s);
  if (u_post != nullptr) straddle(u_post, qb_post, s);
  if (ph.words != nullptr) diag_epilogue(ph, (long long)blockIdx.x * TILE, 1, s);
  for (int e = threadIdx.x; e < TILE * TILE; e += NT) {
    const int d = e / TILE, l = e % TILE;
    ore[base + e] = s.tr[d * LD + l];
    oim[base + e] = s.ti[d * LD + l];
  }
}

template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SMEM_BYTES);
}

template <int DIM, bool ALIAS, bool ROTATE>
cudaError_t launch_lane(const float* re, const float* im, const float* wr,
                        const float* wi, float* ore, float* oim,
                        long long rows, const qst::Phase& ph, cudaStream_t st) {
  cudaError_t err = allow_smem(lane_panel_kernel<DIM, ALIAS, ROTATE>);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + TILE - 1) / TILE;
  lane_panel_kernel<DIM, ALIAS, ROTATE>
      <<<(unsigned)blocks, NT, SMEM_BYTES, st>>>(re, im, wr, wi, ore, oim,
                                                 rows, ph);
  return cudaGetLastError();
}

template <int DIM, bool ALIAS>
cudaError_t launch_positioned(const float* re, const float* im,
                              const float* wr, const float* wi, float* ore,
                              float* oim, long long A, long long C,
                              const qst::Phase& ph, cudaStream_t st) {
  cudaError_t err = allow_smem(positioned_panel_kernel<DIM, ALIAS>);
  if (err != cudaSuccess) return err;
  const long long tpa = (C + TILE - 1) / TILE;
  positioned_panel_kernel<DIM, ALIAS>
      <<<(unsigned)(A * tpa), NT, SMEM_BYTES, st>>>(re, im, wr, wi, ore, oim,
                                                     C, tpa, ph);
  return cudaGetLastError();
}

template <bool ALIAS>
cudaError_t launch_dual(const float* re, const float* im, const float* w1r,
                        const float* w1i, int mode1, const float* w2r,
                        const float* w2i, int mode2, const float* u_pre,
                        int qb_pre, const float* u_post, int qb_post,
                        float* ore, float* oim, long long A,
                        const qst::Phase& ph, cudaStream_t st) {
  cudaError_t err = allow_smem(dual_panel_kernel<ALIAS>);
  if (err != cudaSuccess) return err;
  dual_panel_kernel<ALIAS><<<(unsigned)A, NT, SMEM_BYTES, st>>>(
      re, im, w1r, w1i, mode1, w2r, w2i, mode2, u_pre, qb_pre, u_post,
      qb_post, ore, oim, ph);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* qst_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Every entry takes an optional diag epilogue: phase, the packed
// DiagTerms operand (phase.cuh) with G groups and T row-side terms, or
// null.  The lane and positioned panels take it only at dim 128 (and the
// positioned one only with C >= 128): their tile rows must be state rows.
// Every entry runs in place when ore == re and oim == im (the ALIAS
// instance) and refuses planes that alias otherwise.

// dim in {1, 2, 4, ..., 128}; rows = 2^n / dim.  rotate: the transposed
// (dim, rows) store, out of place and without a diag epilogue.  Returns a
// cudaError_t.
int qst_lane_panel(const float* re, const float* im, const float* wr,
                   const float* wi, float* ore, float* oim, long long rows,
                   int dim, int rotate, const void* phase, int G, int T,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int alias = qst::alias_mode(re, im, ore, oim);
  if (alias < 0 || (phase != nullptr && (dim != TILE || rotate)) ||
      (rotate && alias))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const qst::Phase ph{(const uint32_t*)phase, G, T};
  switch (dim) {
#define QST_LANE(D)                                                          \
    case D:                                                                  \
      return (int)(rotate                                                    \
          ? launch_lane<D, false, true>(re, im, wr, wi, ore, oim, rows, ph, st) \
          : alias                                                            \
          ? launch_lane<D, true, false>(re, im, wr, wi, ore, oim, rows, ph, st) \
          : launch_lane<D, false, false>(re, im, wr, wi, ore, oim, rows, ph, st));
    QST_LANE(1) QST_LANE(2) QST_LANE(4) QST_LANE(8)
    QST_LANE(16) QST_LANE(32) QST_LANE(64) QST_LANE(128)
#undef QST_LANE
    default: return (int)cudaErrorInvalidValue;
  }
}

// The view (A, dim, C): C = 2^pos, dim in {1, ..., 128}.
int qst_positioned_panel(const float* re, const float* im, const float* wr,
                         const float* wi, float* ore, float* oim, long long A,
                         int dim, long long C, const void* phase, int G,
                         int T, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int alias = qst::alias_mode(re, im, ore, oim);
  if (alias < 0 || (phase != nullptr && (dim != TILE || C % TILE != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const qst::Phase ph{(const uint32_t*)phase, G, T};
  switch (dim) {
#define QST_POS(D)                                                           \
    case D:                                                                  \
      return (int)(alias                                                     \
          ? launch_positioned<D, true>(re, im, wr, wi, ore, oim, A, C, ph, st) \
          : launch_positioned<D, false>(re, im, wr, wi, ore, oim, A, C, ph, st));
    QST_POS(1) QST_POS(2) QST_POS(4) QST_POS(8)
    QST_POS(16) QST_POS(32) QST_POS(64) QST_POS(128)
#undef QST_POS
    default: return (int)cudaErrorInvalidValue;
  }
}

// The view (A, 128, 128).  mode: 0 = lane (pos 0), 1 = full (pos 7).
// u_pre / u_post: 32 floats (Re U, Im U of the (6, qb) gate) or null.
int qst_dual_panel(const float* re, const float* im, const float* w1r,
                   const float* w1i, int mode1, const float* w2r,
                   const float* w2i, int mode2, const float* u_pre,
                   int qb_pre, const float* u_post, int qb_post, float* ore,
                   float* oim, long long A, const void* phase, int G, int T,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int alias = qst::alias_mode(re, im, ore, oim);
  if (alias < 0) return (int)cudaErrorInvalidValue;
  const qst::Phase ph{(const uint32_t*)phase, G, T};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(alias
      ? launch_dual<true>(re, im, w1r, w1i, mode1, w2r, w2i, mode2, u_pre,
                          qb_pre, u_post, qb_post, ore, oim, A, ph, st)
      : launch_dual<false>(re, im, w1r, w1i, mode1, w2r, w2i, mode2, u_pre,
                           qb_pre, u_post, qb_post, ore, oim, A, ph, st));
}

}  // extern "C"
