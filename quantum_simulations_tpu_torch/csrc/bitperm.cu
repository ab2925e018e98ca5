// Bit permutations of the statevector's index, for Hopper (sm_90a): QFT's
// terminal bit reversal and SWAP networks on (re, im) float32 planes.
//
//   bitperm_swap       out[i] = in[sigma(i)], sigma a permutation of the
//                      bits >= 7 (the row bits of the (2^n / 128, 128)
//                      view).  Replaces bitperm_swap_planar
//                      (quantum_simulations_tpu/ops/pallas_kernels.py
//                      :1989) with _bitperm_swap_kernel (:1977) and
//                      _bitperm_swap_one_kernel (:2147).  The TPU splits
//                      sigma into pairs on the sublane bits 7..9
//                      (exchanged in VMEM) and a grid_map on bits >= 10
//                      (free in the block index maps).  Here both compose
//                      into one map of the row index: out row r = in row
//                      rho(r), so the pass is a row gather, one warp per
//                      row of 128 floats, float4 loads and stores.  The
//                      port also runs MultiSwapOp and lone SWAPs on bits
//                      >= 7 through it (the reference's XLA transposes).
//   bitperm_transpose  lane bit l <-> bit n - 7 + l: on the (128, M, 128)
//                      view, out[x, m, y] = in[y, m, x].  Replaces
//                      bitperm_transpose_planar (:2163) with
//                      _transpose_cross_kernel (:2155).  A block
//                      transposes one 128 x 128 tile of each plane through
//                      padded shared memory; rows are read and written 128
//                      floats at a time.
//   bitperm_cross      lane bit l <-> top bit cross[l]: out[x, m, y] =
//                      in[f(y), m, g(x)].  Replaces bitperm_cross_planar
//                      (:1905) with _bitperm_cross_kernel (:1890), which
//                      runs two 0/1 permutation matmuls a tile on the MXU.
//                      Here it is the transpose above with two 128-entry
//                      tables (built on the host, read into shared memory
//                      once a block): the tile load reads row f(y), the
//                      store reads column g(x).  No arithmetic, so exact.
//
//   bitperm_involution in place: rows r <-> P(r) for an involution P of the
//                      row bits (a product of disjoint bit transpositions).
//                      Replaces bitperm_swap_planar's split_planes mode
//                      (:2126-2132, _bitperm_swap_one_kernel :2147), which
//                      runs the gather one plane at a time and so still
//                      holds a third plane: 32 GiB at n = 33, where the
//                      card has about 15 GiB beside the two planes.  The
//                      kernel launches work for the 2-cycles only: the
//                      host plan (ops/bitperm_kernels.InvolutionPlan)
//                      numbers orbits of P on the outer row bits (a fixed
//                      outer part, or a 2-cycle by its lower member, as a
//                      bit deposit over one range per transposition), and
//                      each unit's pairs span a tile set of 6 row bits
//                      closed under P (the lowest bits with their images),
//                      so the rows in flight are runs of 512-byte rows on
//                      both sides of each pair.  A warp takes 4 pairs and
//                      issues their 16 float4 loads before any store.  The
//                      2-cycles are disjoint, so the pass is race-free with
//                      no temporary; fixed rows are never touched.  The
//                      host factors any permutation of the row bits into
//                      at most two involutions
//                      (ops/bitperm_kernels.involution_factors).  Bound:
//                      the moved rows read and written once, 1.27 ms for
//                      qft28's grid permutation on an H100 SXM; it takes
//                      1.51-1.60 ms there (a warp per 4 consecutive rows,
//                      half of them idle, took 2.16-2.21).
//   tiled_transpose    (rows, cols) -> (cols, rows) of both planes: a bit
//                      rotation (the low log2(cols) bits move to the top),
//                      the rotating-panel schedule's RotateOp.  Replaces
//                      tiled_transpose (:2202) with _transpose_kernel
//                      (:2198).  One block per 128 x 128 tile of one plane
//                      through the padded shared-memory tile of
//                      bitperm_transpose: rows of 128 floats read, columns
//                      written as rows of 128 floats.  Any power-of-two
//                      rows and cols (below n = 16 a rotation step may
//                      leave a dim below 128): a ragged tile is masked.
//                      Out of place only: the output tile (j, i) is not
//                      the input tile (i, j).
//
// Bound on an H100 SXM: bytes.  Both planes are read and written once,
// 4.3 GB at n = 28, 1.28 ms at 3.35 TB/s; there is no arithmetic (the
// involution reads and writes only its non-fixed rows).  All are exact (they only
// move floats).  bitperm_swap is out of place only: a block writes rows it
// did not read.  bitperm_transpose and bitperm_cross also run in place
// (alias.cuh): block m reads the whole slab (*, m, *) of a plane into
// shared memory (the tables f and g are permutations, so its reads and its
// writes cover the same 128 rows of 128 floats), a barrier orders those
// loads before the slab is written, and no two blocks share a slab.
//
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError(); the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>

#include "alias.cuh"

namespace {

constexpr int LANES = 128;
constexpr int MAX_ROW_BITS = 56;

// rho(r): bit b of the input row is bit src[b] of the output row.
struct RowPerm {
  unsigned char src[MAX_ROW_BITS];
  int nbits;
};

// ---- bitperm_swap: 8 warps a block, 4 rows a warp. ----
constexpr int SWAP_NT = 256;
constexpr int SWAP_RPW = 4;
constexpr int SWAP_ROWS = SWAP_NT / 32 * SWAP_RPW;

__device__ __forceinline__ long long gather_row(long long r, const RowPerm& p) {
  long long in = 0;
  for (int b = 0; b < p.nbits; ++b) in |= ((r >> p.src[b]) & 1LL) << b;
  return in;
}

__global__ void __launch_bounds__(SWAP_NT)
bitperm_swap_kernel(const float4* __restrict__ re, const float4* __restrict__ im,
                    float4* __restrict__ ore, float4* __restrict__ oim,
                    long long rows, RowPerm perm) {
  const int lane = threadIdx.x % 32;
  const long long r0 =
      ((long long)blockIdx.x * (SWAP_NT / 32) + threadIdx.x / 32) * SWAP_RPW;
  float4 xr[SWAP_RPW], xi[SWAP_RPW];
#pragma unroll
  for (int k = 0; k < SWAP_RPW; ++k) {
    if (r0 + k < rows) {
      const long long src = gather_row(r0 + k, perm) * (LANES / 4) + lane;
      xr[k] = re[src];
      xi[k] = im[src];
    }
  }
#pragma unroll
  for (int k = 0; k < SWAP_RPW; ++k) {
    if (r0 + k < rows) {
      const long long dst = (r0 + k) * (LANES / 4) + lane;
      ore[dst] = xr[k];
      oim[dst] = xi[k];
    }
  }
}

// ---- bitperm_involution: the 2-cycles of P unit by unit
// (ops/bitperm_kernels.InvolutionPlan).  A unit is an orbit of P on the
// outer row bits: a fixed outer part g (one tile of 2^tb rows, its nfix
// internal 2-cycles) or a 2-cycle g < P(g) (two tiles, 2^tb pairs).  A
// block of 16 warps takes one unit a round, a warp 4 pairs: it issues all
// 16 float4 loads (both rows of each pair, both planes) before any store.
// The tile bits are the lowest row bits with their images, so a unit's
// rows are runs of contiguous 512-byte rows on both sides of its pairs.
constexpr int INV_NT = 512;
constexpr int INV_PPW = 4;                       // pairs a warp, a round
constexpr int INV_ROUND = INV_NT / 32 * INV_PPW;  // 64 pairs: one unit
constexpr int MAX_RANGES = MAX_ROW_BITS / 2 + 1;
constexpr int TILE_BITS = 6;

struct InvPlan {
  unsigned long long start[MAX_RANGES], dep[MAX_RANGES], set[MAX_RANGES];
  long long units;
  int dup_from[MAX_RANGES];
  int nranges, M, tb, nfix;
  unsigned char ob[MAX_ROW_BITS / 2], oc[MAX_ROW_BITS / 2];
  unsigned char tbit[TILE_BITS], tperm[1 << TILE_BITS], fix_lo[1 << (TILE_BITS - 1)];
};

// The bits of v, low first, into the set bits of mask, low first.
__device__ __forceinline__ unsigned long long deposit(unsigned long long v,
                                                      unsigned long long mask) {
  unsigned long long r = 0;
  for (; mask; mask &= mask - 1, v >>= 1)
    if (v & 1) r |= mask & (~mask + 1);
  return r;
}

__device__ __forceinline__ long long tile_row(const InvPlan& p, int q) {
  long long r = 0;
  for (int k = 0; k < p.tb; ++k) r |= (long long)((q >> k) & 1) << p.tbit[k];
  return r;
}

__global__ void __launch_bounds__(INV_NT, 1)
bitperm_involution_kernel(float4* re, float4* im,
                          const __grid_constant__ InvPlan p) {
  // __grid_constant__: indexed in the parameter bank, never copied to
  // local memory; every index is uniform across a warp.
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (long long u = blockIdx.x; u < p.units; u += gridDim.x) {
    int k = 0;
    while (k + 1 < p.nranges && p.start[k + 1] <= (unsigned long long)u) ++k;
    unsigned long long g = p.set[k] | deposit(u - p.start[k], p.dep[k]);
    for (int i = p.dup_from[k]; i < p.M; ++i) g |= ((g >> p.ob[i]) & 1ULL) << p.oc[i];
    unsigned long long pg = g;
    for (int i = 0; i < p.M; ++i)
      if (((g >> p.ob[i]) ^ (g >> p.oc[i])) & 1ULL)
        pg ^= (1ULL << p.ob[i]) | (1ULL << p.oc[i]);
    const bool fixed = k == 0;
    const int count = fixed ? p.nfix : 1 << p.tb;
    for (int s0 = warp * INV_PPW; s0 < count; s0 += INV_ROUND) {
      long long a[INV_PPW], b[INV_PPW];
      float4 ar[INV_PPW], br[INV_PPW], ai[INV_PPW], bi[INV_PPW];
#pragma unroll
      for (int j = 0; j < INV_PPW; ++j) {
        const int s = s0 + j;
        if (s < count) {
          const int q = fixed ? p.fix_lo[s] : s;
          a[j] = (long long)(g | tile_row(p, q)) * (LANES / 4) + lane;
          b[j] = (long long)(pg | tile_row(p, p.tperm[q])) * (LANES / 4) + lane;
          ar[j] = re[a[j]];
          br[j] = re[b[j]];
          ai[j] = im[a[j]];
          bi[j] = im[b[j]];
        }
      }
#pragma unroll
      for (int j = 0; j < INV_PPW; ++j) {
        if (s0 + j < count) {
          re[a[j]] = br[j];
          re[b[j]] = ar[j];
          im[a[j]] = bi[j];
          im[b[j]] = ai[j];
        }
      }
    }
  }
}

// ---- bitperm_transpose / bitperm_cross: one block per m, the planes one
// after the other.  TABLES = false: f and g are the identity.  Three
// blocks fit an SM's shared memory; the register cap of 42 a thread lets
// all three in (the table instance took 60 unbounded: two blocks, 2.67
// against the transpose's 2.11 ms at n = 28 on an H100 SXM).
constexpr int TR_NT = 512;
constexpr int TR_BLOCKS_PER_SM = 3;
constexpr int TR_LD = LANES + 1;  // padded: both passes conflict-free
constexpr size_t TR_SMEM = sizeof(float) * LANES * TR_LD;  // 66,048 B

template <bool TABLES, bool ALIAS>
__global__ void __launch_bounds__(TR_NT, TR_BLOCKS_PER_SM)
tile_cross_kernel(typename qst::Io<float, ALIAS>::In re,
                  typename qst::Io<float, ALIAS>::In im,
                  typename qst::Io<float, ALIAS>::Out ore,
                  typename qst::Io<float, ALIAS>::Out oim,
                  long long M, const unsigned char* __restrict__ fg) {
  extern __shared__ float tile[];  // [y][c], LANES x TR_LD
  __shared__ unsigned char f[LANES], g[LANES];
  if (TABLES && threadIdx.x < 2 * LANES) {
    if (threadIdx.x < LANES) f[threadIdx.x] = fg[threadIdx.x];
    else g[threadIdx.x - LANES] = fg[threadIdx.x];
  }
  __syncthreads();
  const long long m = blockIdx.x;
  for (int p = 0; p < 2; ++p) {
    const typename qst::Io<float, ALIAS>::In x = p ? im : re;
    const typename qst::Io<float, ALIAS>::Out o = p ? oim : ore;
#pragma unroll 8
    for (int e = threadIdx.x; e < LANES * LANES; e += TR_NT) {
      const int y = e / LANES, c = e % LANES;
      const int row = TABLES ? f[y] : y;
      tile[y * TR_LD + c] = x[((long long)row * M + m) * LANES + c];
    }
    __syncthreads();
#pragma unroll 8
    for (int e = threadIdx.x; e < LANES * LANES; e += TR_NT) {
      const int r = e / LANES, y = e % LANES;
      const int col = TABLES ? g[r] : r;
      o[((long long)r * M + m) * LANES + y] = tile[y * TR_LD + col];
    }
    __syncthreads();
  }
}

template <bool TABLES, bool ALIAS>
int launch_tile_cross(const float* re, const float* im, float* ore, float* oim,
                      long long M, const unsigned char* fg, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tile_cross_kernel<TABLES, ALIAS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TR_SMEM);
  if (err != cudaSuccess) return (int)err;
  tile_cross_kernel<TABLES, ALIAS>
      <<<(unsigned)M, TR_NT, TR_SMEM, (cudaStream_t)stream>>>(re, im, ore, oim,
                                                              M, fg);
  return (int)cudaGetLastError();
}

// ---- tiled_transpose: block (t, p) moves tile t of plane p (0: re, 1: im);
// tile t is (t / col_tiles, t % col_tiles) in 128 x 128 units of the input.
__global__ void __launch_bounds__(TR_NT, TR_BLOCKS_PER_SM)
tiled_transpose_kernel(const float* __restrict__ re,
                       const float* __restrict__ im, float* __restrict__ ore,
                       float* __restrict__ oim, long long rows, long long cols,
                       long long col_tiles) {
  extern __shared__ float tile[];  // [y][c], LANES x TR_LD
  const float* __restrict__ x = blockIdx.y ? im : re;
  float* __restrict__ o = blockIdx.y ? oim : ore;
  const long long r0 = (long long)(blockIdx.x / col_tiles) * LANES;
  const long long c0 = (long long)(blockIdx.x % col_tiles) * LANES;
  const int nr = (int)min((long long)LANES, rows - r0);
  const int nc = (int)min((long long)LANES, cols - c0);
#pragma unroll 8
  for (int e = threadIdx.x; e < LANES * LANES; e += TR_NT) {
    const int y = e / LANES, c = e % LANES;
    if (y < nr && c < nc) tile[y * TR_LD + c] = x[(r0 + y) * cols + c0 + c];
  }
  __syncthreads();
#pragma unroll 8
  for (int e = threadIdx.x; e < LANES * LANES; e += TR_NT) {
    const int c = e / LANES, y = e % LANES;
    if (c < nc && y < nr) o[(c0 + c) * rows + r0 + y] = tile[y * TR_LD + c];
  }
}

template <bool TABLES>
int launch_tile(const float* re, const float* im, float* ore, float* oim,
                long long M, const unsigned char* fg, void* stream) {
  const int alias = qst::alias_mode(re, im, ore, oim);
  if (alias < 0) return (int)cudaErrorInvalidValue;
  if (alias)
    return launch_tile_cross<TABLES, true>(re, im, ore, oim, M, fg, stream);
  return launch_tile_cross<TABLES, false>(re, im, ore, oim, M, fg, stream);
}

// The row map of a bit permutation: src[b] for the nbits row bits.
int row_perm(const int* src, int nbits, RowPerm* perm) {
  if (nbits < 0 || nbits > MAX_ROW_BITS) return (int)cudaErrorInvalidValue;
  *perm = RowPerm{};
  perm->nbits = nbits;
  for (int b = 0; b < nbits; ++b) {
    if (src[b] < 0 || src[b] >= nbits) return (int)cudaErrorInvalidValue;
    perm->src[b] = (unsigned char)src[b];
  }
  return 0;
}

}  // namespace

extern "C" {

const char* qst_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// rows = 2^n / 128; src[b] (b < nbits = n - 7): the output row bit that
// input row bit b is read from.  The planes must be 16-byte aligned.
int qst_bitperm_swap(const float* re, const float* im, float* ore, float* oim,
                     long long rows, const int* src, int nbits, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  RowPerm perm;
  if (qst::alias_mode(re, im, ore, oim) != 0 || row_perm(src, nbits, &perm) ||
      rows != (1LL << nbits))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + SWAP_ROWS - 1) / SWAP_ROWS;
  bitperm_swap_kernel<<<(unsigned)blocks, SWAP_NT, 0, (cudaStream_t)stream>>>(
      (const float4*)re, (const float4*)im, (float4*)ore, (float4*)oim, rows,
      perm);
  return (int)cudaGetLastError();
}

// In place: rows = 2^nbits rows of 128 floats; the plan of
// ops/bitperm_kernels.InvolutionPlan: ranges[4 k .. 4 k + 3] = (start,
// dep, set, dup_from) of range k (nranges of them, range 0 the fixed outer
// units), then words = M outer pairs (b, c) sorted by c, the tb tile bits,
// the 2^tb entries of tperm and the nfix entries of fix_lo.  The planes
// must be 16-byte aligned.
int qst_bitperm_involution(float* re, float* im, long long rows, int nbits,
                           const long long* ranges, int nranges,
                           const int* words, int M, int tb, int nfix,
                           long long units, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (re == im || nbits < 0 || nbits > MAX_ROW_BITS || rows != (1LL << nbits) ||
      nranges != M + 1 || M < 0 || M > MAX_ROW_BITS / 2 || tb < 0 ||
      tb > TILE_BITS || tb > nbits || nfix < 0 || nfix > (1 << tb) / 2 ||
      units < 1)
    return (int)cudaErrorInvalidValue;
  InvPlan plan{};
  for (int k = 0; k < nranges; ++k) {
    plan.start[k] = (unsigned long long)ranges[4 * k];
    plan.dep[k] = (unsigned long long)ranges[4 * k + 1];
    plan.set[k] = (unsigned long long)ranges[4 * k + 2];
    plan.dup_from[k] = (int)ranges[4 * k + 3];
  }
  const int* w = words;
  for (int i = 0; i < M; ++i, w += 2) {
    if (w[0] < 0 || w[0] >= w[1] || w[1] >= nbits) return (int)cudaErrorInvalidValue;
    plan.ob[i] = (unsigned char)w[0];
    plan.oc[i] = (unsigned char)w[1];
  }
  for (int k = 0; k < tb; ++k, ++w) {
    if (*w < 0 || *w >= nbits) return (int)cudaErrorInvalidValue;
    plan.tbit[k] = (unsigned char)*w;
  }
  for (int q = 0; q < (1 << tb); ++q, ++w) {
    if (*w < 0 || *w >= (1 << tb)) return (int)cudaErrorInvalidValue;
    plan.tperm[q] = (unsigned char)*w;
  }
  for (int s = 0; s < nfix; ++s, ++w) {
    if (*w < 0 || *w >= (1 << tb)) return (int)cudaErrorInvalidValue;
    plan.fix_lo[s] = (unsigned char)*w;
  }
  plan.units = units;
  plan.nranges = nranges;
  plan.M = M;
  plan.tb = tb;
  plan.nfix = nfix;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bitperm_involution_kernel, INV_NT, 0);
  if (err != cudaSuccess) return (int)err;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long grid = units < cap ? units : cap;
  bitperm_involution_kernel<<<(unsigned)grid, INV_NT, 0, (cudaStream_t)stream>>>(
      (float4*)re, (float4*)im, plan);
  return (int)cudaGetLastError();
}

// The (128, M, 128) view, M = 2^(n - 14).  In place when ore == re and
// oim == im.
int qst_bitperm_transpose(const float* re, const float* im, float* ore,
                          float* oim, long long M, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_tile<false>(re, im, ore, oim, M, nullptr, stream);
}

// fg: the 256 bytes f[128] then g[128], on the device.  In place when
// ore == re and oim == im.
int qst_bitperm_cross(const float* re, const float* im, float* ore, float* oim,
                      long long M, const unsigned char* fg, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (fg == nullptr) return (int)cudaErrorInvalidValue;
  return launch_tile<true>(re, im, ore, oim, M, fg, stream);
}

// Each plane (rows, cols) row-major -> (cols, rows); out of place only.
int qst_tiled_transpose(const float* re, const float* im, float* ore,
                        float* oim, long long rows, long long cols, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (qst::alias_mode(re, im, ore, oim) != 0 || rows < 1 || cols < 1)
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(tiled_transpose_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)TR_SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long col_tiles = (cols + LANES - 1) / LANES;
  const long long tiles = (rows + LANES - 1) / LANES * col_tiles;
  tiled_transpose_kernel<<<dim3((unsigned)tiles, 2), TR_NT, TR_SMEM,
                           (cudaStream_t)stream>>>(re, im, ore, oim, rows,
                                                   cols, col_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
