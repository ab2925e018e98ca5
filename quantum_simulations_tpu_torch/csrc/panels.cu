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
//                     of up to 128 contiguous floats.  Out of place only,
//                     as the reference asserts (:202): block b writes a
//                     column slab of every output row, which other blocks
//                     still read.
//   positioned_panel  pos >= 7 (any pos works): the view (A, dim, C).
//                     Replaces positioned_panel_planar (:636) and its
//                     three Pallas bodies: _positioned_row_kernel (:553,
//                     pos 7..9 and the ragged dim < 128 path) and
//                     _positioned_4d_kernel (:605, pos >= 10).
//   dual_panel        the (0, 7) panel pair on the (A, 128, 128) view in
//                     ONE pass, in op order, with an optional straddler
//                     gate on (6, qb in 7..13) before and after; on the
//                     tensor cores (below).
//                     Replaces dual_panel_planar / _dual_panel_kernel
//                     (:343, :409) with _straddle_plan /
//                     _straddle_prologue (:229, :278).
//
// Bound on an H100 SXM.  One pass over n = 28 moves 2^28 x 16 B = 4.3 GB
// (1.28 ms at 3.35 TB/s) and does 2^28 x dim complex multiply-adds.
//
// Dim 128, lane_panel and positioned_panel: the tensor cores (namespace
// tc).  They replace _panel_kernel (:93, with its rotated store :116-118)
// and _positioned_row_kernel / _positioned_4d_kernel (:553, :605), which
// ran the panel on the TPU's matrix unit at Precision.HIGHEST (:28-40).
// The Hopper counterpart is split TF32: each float32 operand x becomes hi
// = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), a real product is
// a_hi b_hi + a_hi b_lo + a_lo b_hi (lo lo dropped).  Bound: the function
// needs Gauss's three real products a complex multiply-add (the
// reference's form), 2^28 x 128 x 3 x 3 x 2 = 6.2e14 TF32 flop, 1.25 ms at
// 495 TFLOP/s, under the 1.28 ms of bytes: the pass is bound by bytes.
// This kernel takes four real products, as the error budget of the
// four-product form was fixed first (8.2e14 flop, 1.67 ms by its own
// operations); Gauss's form (QST_TC_GAUSS below) held the error but was
// slower on three of four shapes (panel_variants.py): more splits and
// adds for fewer mma.
// The design: mma.sync m16n8k8 (TF32 in, float32 accumulators), fragments
// loaded by the threads from shared memory, so one routine serves the
// lane layout (r, k) and the positioned (k, c); a persistent block per SM
// (256 threads, 8 warps of 64 x 32 outputs, 128 accumulators a thread)
// keeps W in shared memory in fragment order (128 KB, loaded once a
// block, split as it is read) and streams each tile through a two-stage
// cp.async ring in k-chunks of 32, so the next chunk (of this tile or the
// next) loads while this one contracts; each k8 step's products go into
// a fresh mma accumulator that a float32 add folds into the sum, because
// the tensor cores truncate when they accumulate.
//
// dual_panel, both contractions on the tensor cores (namespace tc,
// dual_tc_kernel: 9.4-9.7 ms at n = 28 on an H100 SXM, where the SIMT form
// took 15.0-15.7).  It replaces _dual_panel_kernel (:343), which ran both panels
// of the (A, 128, 128) view on the MXU with the straddlers on the VPU.
// Bound: the two 128-wide contractions need 2 x 18 flop a complex
// multiply-add by Gauss in split TF32, 2^28 x 128 x 36 = 1.24e15 TF32
// flop, 2.50 ms at 495 TFLOP/s at n = 28, over the 1.28 ms of bytes: the
// pass is bound by operations (6.19 ms in float32 on the SIMT units).
// Design: the k8 step of the lane / positioned kernel (k8_mma, the same
// split, four real products, fresh accumulator per step); a persistent
// block per SM (256 threads) keeps the tile (d, l) resident in shared
// memory (2 x 64 KB, unpadded, swizzled so that both fragment patterns and
// the write-back are conflict-free) and streams both W's row-major through
// a two-stage cp.async ring in k-chunks of 32 (W1 then W2, 8 chunks a
// tile; both stay in L2).  A tile: the pre-straddler on the tile (SIMT),
// contraction 1, a write-back into the tile, contraction 2; then the store
// from the accumulators, while the next tile loads slice by slice into the
// slices contraction 2 has consumed; or, with a post-straddler or a diag
// run, a write-back and an out-of-line SIMT epilogue on the tile and its
// store.  The k8 steps of a chunk run as a loop: unrolled
// (QST_TC_DUAL_UNROLL=4) the two modes' code is 4x larger and the pass 10%
// slower (panel_variants.py).
//
// Dims 1..64: the SIMT routine contract() (float32 FMAs, no TF32), bound
// by float32 operations: the loop spends 4 FMAs (8 flop) on a complex
// multiply-add.  A block of 512 threads owns one tile of up to 128 x 128
// complex amplitudes in shared memory (two padded float planes, 129 KB),
// read from device memory once and written once; W is staged in chunks of
// 32 columns, each thread keeps a 4 x 8 micro-tile of complex sums in
// registers, so each shared-memory read feeds 5 FMAs on average.
//
// Diag epilogue (the reference's diag_terms option, pallas_kernels.py
// :171-188, :462-503, :676-682, :725-818).  A 128-wide panel whose tile
// rows are whole state rows of 128 lanes (lane panel, positioned pos >= 7,
// dual) can apply the merged diagonal run that follows it to the tile
// after its last contraction (and post-straddler), before the store:
// phase.cuh's arithmetic, on the accumulators (tc::diag_acc: the lane and
// positioned panels) or on the tile written back (dual_panel, with the
// freed W ring as scratch).  It adds no traffic.
//
// In place (the capacity tier; alias.cuh).  Each kernel has an ALIAS
// instance, launched when the output planes are the input planes.  It is
// hazard-free because a block owns a disjoint slab of the state (a lane
// panel's 128 rows, a positioned panel's (a, c-tile) column block, a dual
// panel's (128, 128) tile) and reads the whole slab before it writes any
// of it.  SIMT: it loads the slab into shared memory, the barrier at the
// top of contract() orders every one of those loads before any thread
// goes on, and the stores come after the last barrier; each shared-memory
// store of the load loop consumes its global load, so no load is still in
// flight when the slab is overwritten.  Tensor cores: the block stores a
// tile only after the last cp.async group of that tile has landed
// (wait_group) and been consumed behind a barrier; the groups still in
// flight belong to its later tiles.
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

// ---- lane_panel: view (R, DIM); tile = 128 rows (c) x DIM lanes (k). ----
template <int DIM, bool ALIAS, bool ROTATE>
__global__ void __launch_bounds__(NT, 1)
lane_panel_kernel(typename qst::Io<float, ALIAS>::In re,
                  typename qst::Io<float, ALIAS>::In im,
                  const float* __restrict__ wr, const float* __restrict__ wi,
                  typename qst::Io<float, ALIAS>::Out ore,
                  typename qst::Io<float, ALIAS>::Out oim,
                  long long rows) {
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
                        long long tiles_per_a) {
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
  for (int e = threadIdx.x; e < DIM * TILE; e += NT) {
    const int k = e / TILE, c = e % TILE;
    if (c < nc) {
      ore[base + k * C + c] = s.tr[k * LD + c];
      oim[base + k * C + c] = s.ti[k * LD + c];
    }
  }
}

// ---- Dim 128 on the tensor cores: lane_panel and positioned_panel. ----
//
// Each tile is one complex GEMM with the output in the input's layout:
// out(r, i) = sum_k X(r, k) W(i, k) for the lane panel, out(c, i) = sum_k
// X(k, c) W(i, k) for the positioned one.  A ring stage holds k-chunk of
// the tile: [128 r][PL] (lane) or [KC k][PP] (positioned).  The pitches
// keep the fragment loads conflict-free: lane (g, t) of a warp reads g *
// PL + t (PL = 36 = 4 mod 32) or t * PP + g (PP = 136 = 8 mod 32).
//
// Measurement variants, each one change to this routine, built only by
// panel_variants.py (-D<name>=1; the package's build sets none):
// QST_TC_NOSTORE skips the tile stores, QST_TC_CHAINED chains every
// product of an output through the tensor cores' accumulator,
// QST_TC_NOSPLIT replaces the split by a bit copy (lo = 0, wrong digits),
// QST_TC_GAUSS takes Gauss's three real products (nine TF32 products a
// complex multiply-add instead of twelve), QST_TC_DUAL_UNROLL = 2 or 4
// unrolls the dual kernel's four k8 steps a chunk by that factor (the
// package keeps them a loop, 1),
// QST_TC_KS_LOOP runs the lane / positioned kernel's four as a loop (the
// package unrolls them).
#ifndef QST_TC_NOSTORE
#define QST_TC_NOSTORE 0
#endif
#ifndef QST_TC_CHAINED
#define QST_TC_CHAINED 0
#endif
#ifndef QST_TC_NOSPLIT
#define QST_TC_NOSPLIT 0
#endif
#ifndef QST_TC_GAUSS
#define QST_TC_GAUSS 0
#endif
#ifndef QST_TC_DUAL_UNROLL
#define QST_TC_DUAL_UNROLL 1
#endif
#ifndef QST_TC_KS_LOOP
#define QST_TC_KS_LOOP 0
#endif

namespace tc {

constexpr int NT = 256;              // 8 warps: 2 along m (64 each), 4 along n (32)
constexpr int KC = 32;               // k per ring stage
constexpr int STAGES = 2;
constexpr int NCHUNK = TILE / KC;
constexpr int PL = KC + 4;           // lane stage: [128 m][KC k]
constexpr int PP = TILE + 8;         // positioned stage: [KC k][128 c]
constexpr int PLANE = TILE * PL > KC * PP ? TILE * PL : KC * PP;
constexpr int STAGE = 2 * PLANE;     // floats: re plane, im plane
constexpr int W_FLOATS = 2 * TILE * TILE;
constexpr int GC = 16;               // diag groups whose row angles are staged at once
constexpr int SCRATCH = GC * TILE + GC;
constexpr size_t SMEM = sizeof(float) * (W_FLOATS + STAGES * STAGE + SCRATCH);
static_assert(SMEM <= 232448, "one block's shared memory on sm_90");

// hi = x rounded to TF32 (nearest, ties away), lo = (x - hi) rounded the
// same way; x - hi is exact in float32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
#if QST_TC_NOSPLIT
  hi = __float_as_uint(x);
  lo = 0u;
#else
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
#endif
}

// d += a b on one m16n8k8 tile, TF32 inputs, float32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b (a zero accumulator).
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One tile of the view.  Lane layout: rows r0 .. r0 + nv of (R, 128), at
// element offset r0 * 128.  Positioned: the (a, c-tile) block, element
// (k, c) at base + k * C + c, nv = min(128, C - c0) columns.
struct Tile {
  long long base;  // element offset of tile element (0, 0)
  long long row0;  // lane layout: r0
  int nv;          // valid rows (lane) or columns (positioned)
};

template <bool POS>
__device__ __forceinline__ Tile tile_at(long long t, long long ext,
                                        long long tpa) {
  if constexpr (POS) {
    const long long a = t / tpa, c0 = (t % tpa) * TILE;
    return {a * TILE * ext + c0, 0, (int)min((long long)TILE, ext - c0)};
  } else {
    const long long r0 = t * TILE;
    return {r0 * TILE, r0, (int)min((long long)TILE, ext - r0)};
  }
}

// Chunk `ch` (k in [ch * KC, ch * KC + KC)) of a tile into a ring stage.
// A full tile on 16-byte aligned planes goes by cp.async (the caller
// commits the group); a ragged or misaligned one by plain loads, zero
// outside the view.
template <bool POS, typename In>
__device__ __forceinline__ void load_chunk(In re, In im, const Tile& tl,
                                           long long C, int ch, float* st,
                                           bool fast) {
  const int k0 = ch * KC;
  if (fast) {
    constexpr int PER_PLANE = POS ? KC * (TILE / 4) : TILE * (KC / 4);
    for (int e = threadIdx.x; e < 2 * PER_PLANE; e += NT) {
      const int p = e / PER_PLANE, r = e % PER_PLANE;
      const float* src = p ? im : re;
      float* dst = st + p * PLANE;
      if constexpr (POS) {
        const int k = r / (TILE / 4), q = r % (TILE / 4);
        cp_async16(dst + k * PP + 4 * q, src + tl.base + (k0 + k) * C + 4 * q);
      } else {
        const int m = r / (KC / 4), q = r % (KC / 4);
        cp_async16(dst + m * PL + 4 * q, src + tl.base + m * TILE + k0 + 4 * q);
      }
    }
  } else {
    for (int e = threadIdx.x; e < 2 * TILE * KC; e += NT) {
      const int p = e / (TILE * KC), r = e % (TILE * KC);
      const float* src = p ? im : re;
      float* dst = st + p * PLANE;
      if constexpr (POS) {
        const int k = r / TILE, c = r % TILE;
        dst[k * PP + c] = c < tl.nv ? src[tl.base + (k0 + k) * C + c] : 0.f;
      } else {
        const int m = r / KC, kk = r % KC;
        dst[m * PL + kk] = m < tl.nv ? src[tl.base + m * TILE + k0 + kk] : 0.f;
      }
    }
  }
}

// The warp's 64 x 32 block of the tile: acc[mi][nj][re / im][c], fragment
// element c of m16 tile mi and n8 tile nj (rows g, g + 8; columns 2t, 2t+1).
typedef float Acc[4][4][2][4];

// acc[mi][nj] += the complex product of one k8 step: re = Ar Br + An Bi,
// im = Ar Bi + Ai Br, with An = -Ai, each real product three TF32 products
// (lo hi and hi lo first, then hi hi).  The tensor cores add into their
// accumulator by truncation, which biases a long sum toward zero (chained
// through all 96 products of an output, panel_variants.py's "chained",
// the error against float64 grows 14-fold).  So the step's
// six products of a part go into a fresh accumulator and its sum is added
// to acc by a float32 add, rounded to nearest: at most two truncations
// touch each hi product.
__device__ __forceinline__ void cmma(float (&dr)[4], float (&di)[4],
                                     const uint32_t (&arh)[4], const uint32_t (&arl)[4],
                                     const uint32_t (&aih)[4], const uint32_t (&ail)[4],
                                     const uint32_t (&anh)[4], const uint32_t (&anl)[4],
                                     const uint32_t (&brh)[2], const uint32_t (&brl)[2],
                                     const uint32_t (&bih)[2], const uint32_t (&bil)[2]) {
#if QST_TC_CHAINED
  float (&tr)[4] = dr;
  float (&ti)[4] = di;
  mma(tr, arl, brh);
#else
  float tr[4], ti[4];
  mma0(tr, arl, brh);
#endif
  mma(tr, arh, brl);
  mma(tr, anl, bih);
  mma(tr, anh, bil);
  mma(tr, arh, brh);
  mma(tr, anh, bih);
#if QST_TC_CHAINED
  mma(ti, arl, bih);
#else
  mma0(ti, arl, bih);
#endif
  mma(ti, arh, bil);
  mma(ti, ail, brh);
  mma(ti, aih, brl);
  mma(ti, arh, bih);
  mma(ti, aih, brh);
#if !QST_TC_CHAINED
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    dr[c] += tr[c];
    di[c] += ti[c];
  }
#endif
}

// The QST_TC_GAUSS variant's step: for P the A side and Q the B side, k1 =
// (Pr + Pi) Qr, k2 = Pr (Qi - Qr), k3 = Pi (Qr + Qi), re = k1 - k3, im =
// k1 + k2 (the reference's _cmul_planes).  as = split(Pr + Pi), bd =
// split(Qi - Qr), bs = split(Qr + Qi).
__device__ __forceinline__ void gauss_mma(float (&dr)[4], float (&di)[4],
                                          const uint32_t (&arh)[4], const uint32_t (&arl)[4],
                                          const uint32_t (&aih)[4], const uint32_t (&ail)[4],
                                          const uint32_t (&ash)[4], const uint32_t (&asl)[4],
                                          const uint32_t (&brh)[2], const uint32_t (&brl)[2],
                                          const uint32_t (&bdh)[2], const uint32_t (&bdl)[2],
                                          const uint32_t (&bsh)[2], const uint32_t (&bsl)[2]) {
  float k1[4], k2[4], k3[4];
  mma0(k1, asl, brh);
  mma(k1, ash, brl);
  mma(k1, ash, brh);
  mma0(k2, arl, bdh);
  mma(k2, arh, bdl);
  mma(k2, arh, bdh);
  mma0(k3, ail, bsh);
  mma(k3, aih, bsl);
  mma(k3, aih, bsh);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    dr[c] += k1[c] - k3[c];
    di[c] += k1[c] + k2[c];
  }
}

// acc += one k8 step of the warp's 64 x 32 block, the step both kernels
// share (lane / positioned and dual).  load_b(nj, br, bi) gives the B
// fragment of n8 tile nj: b0 (k = t, n = g), b1 (k = t + 4, n = g);
// load_a(mi, ar, ai) the A fragment of m16 tile mi: a0 (m = g, k = t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); each as re / im planes.
// The step splits them and runs cmma (or gauss_mma) on every (mi, nj).
template <typename LoadA, typename LoadB>
__device__ __forceinline__ void k8_mma(LoadA load_a, LoadB load_b, Acc& acc) {
  uint32_t brh[4][2], brl[4][2], bih[4][2], bil[4][2];
#if QST_TC_GAUSS
  uint32_t bsh[4][2], bsl[4][2];  // bi holds Qi - Qr, bs Qr + Qi
#endif
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    float br[2], bi[2];
    load_b(nj, br, bi);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      split(br[q], brh[nj][q], brl[nj][q]);
#if QST_TC_GAUSS
      split(bi[q] - br[q], bih[nj][q], bil[nj][q]);
      split(br[q] + bi[q], bsh[nj][q], bsl[nj][q]);
#else
      split(bi[q], bih[nj][q], bil[nj][q]);
#endif
    }
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    uint32_t arh[4], arl[4], aih[4], ail[4], anh[4], anl[4];
    float ar[4], ai[4];
    load_a(mi, ar, ai);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      split(ar[q], arh[q], arl[q]);
      split(ai[q], aih[q], ail[q]);
#if QST_TC_GAUSS  // an holds Pr + Pi
      split(ar[q] + ai[q], anh[q], anl[q]);
#else
      anh[q] = aih[q] ^ 0x80000000u;
      anl[q] = ail[q] ^ 0x80000000u;
#endif
    }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#if QST_TC_GAUSS
      gauss_mma(acc[mi][nj][0], acc[mi][nj][1], arh, arl, aih, ail, anh, anl,
                brh[nj], brl[nj], bih[nj], bil[nj], bsh[nj], bsl[nj]);
#else
      cmma(acc[mi][nj][0], acc[mi][nj][1], arh, arl, aih, ail, anh, anl,
           brh[nj], brl[nj], bih[nj], bil[nj]);
#endif
  }
}

// acc += the chunk's products.  W lies in shared memory in fragment order:
// for k8 step s and n8 tile j, lane l's float4 is (Re W b0, Re W b1, Im W
// b0, Im W b1) of B-fragment (s, j): W[8j + g][8s + t] and [8j + g][8s +
// t + 4].  XA (the positioned panel, the rotated lane panel): X is A (m =
// the free axis), W is B (n = i).  WA (the lane panel): W is A (m = i; the
// A fragment of m16 tile mi is the b0 / b1 pair of n8 tiles 2mi, 2mi + 1),
// X is B (n = r), so the accumulators of a row r hold 8 consecutive i and
// the store writes whole 32-byte sectors of 4 rows.
template <bool POS, bool WA>
__device__ __forceinline__ void chunk_mma(const float* st, const float4* w4,
                                          int ch, Acc& acc, int wm, int wn,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* sr = st;
  const float* si = st + PLANE;
#if QST_TC_KS_LOOP
#pragma unroll 1
#else
#pragma unroll
#endif
  for (int ks = 0; ks < KC / 8; ++ks) {
    const int s = ch * (KC / 8) + ks;
    k8_mma(
        [&](int mi, float (&ar)[4], float (&ai)[4]) {
          if constexpr (WA) {
            const int j = wm * 8 + mi * 2;
            const float4 w0 = w4[(s * (TILE / 8) + j) * 32 + lane];
            const float4 w1 = w4[(s * (TILE / 8) + j + 1) * 32 + lane];
            ar[0] = w0.x, ar[1] = w1.x, ar[2] = w0.y, ar[3] = w1.y;
            ai[0] = w0.z, ai[1] = w1.z, ai[2] = w0.w, ai[3] = w1.w;
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int m = wm * 64 + mi * 16 + g + 8 * (q & 1);
              const int k = ks * 8 + t + 4 * (q >> 1);
              const int o = POS ? k * PP + m : m * PL + k;
              ar[q] = sr[o];
              ai[q] = si[o];
            }
          }
        },
        [&](int nj, float (&br)[2], float (&bi)[2]) {
          if constexpr (WA) {  // X(r, k) with r = n: lane stage [r][k]
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int o = (wn * 32 + nj * 8 + g) * PL + ks * 8 + t + 4 * q;
              br[q] = sr[o];
              bi[q] = si[o];
            }
          } else {
            const float4 w = w4[(s * (TILE / 8) + wn * 4 + nj) * 32 + lane];
            br[0] = w.x, br[1] = w.y, bi[0] = w.z, bi[1] = w.w;
          }
        },
        acc);
  }
}

// Tile element (m, n) of fragment (mi, nj, c).
__device__ __forceinline__ int frag_m(int wm, int mi, int c, int lane) {
  return wm * 64 + mi * 16 + (lane >> 2) + 8 * (c >> 1);
}
__device__ __forceinline__ int frag_n(int wn, int nj, int c, int lane) {
  return wn * 32 + nj * 8 + 2 * (lane & 3) + (c & 1);
}

// The diag epilogue on the accumulators (phase.cuh's arithmetic).  With a
// diag run, tile element (m, n) lies in state row row0 + n * row_step at
// lane m: the positioned panel's (c, i) and the lane panel's (i, r).  Each
// group's row angle is computed once per tile row into shared scratch, GC
// groups at a time; a thread sums its 32 elements of one half (mi pair)
// at a time to keep its registers for the accumulators.
__device__ void diag_acc(const qst::Phase& ph, unsigned long long row0,
                         unsigned long long row_step, uint32_t* scratch,
                         Acc& acc, int wm, int wn, int lane) {
  const uint32_t* lmask = ph.words + qst::PHASE_LANES;
  const uint32_t* start = lmask + ph.G;
  const uint32_t* rmask = start + ph.G + 1;
  const uint32_t* coeff = rmask + ph.T;
  uint32_t* th = scratch;               // [GC][TILE]
  uint32_t* lm = scratch + GC * TILE;
#pragma unroll
  for (int hm = 0; hm < 2; ++hm) {
    uint32_t ang[2][4][4];
#pragma unroll
    for (int li = 0; li < 2; ++li)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ang[li][nj][c] = __ldg(ph.words + frag_m(wm, 2 * hm + li, c, lane));
    for (int g0 = 0; g0 < ph.G; g0 += GC) {
      const int gc = min(GC, ph.G - g0);
      __syncthreads();  // the previous chunk is consumed
      for (int e = threadIdx.x; e < gc * TILE; e += NT) {
        const int gi = g0 + e / TILE;
        const uint32_t row =
            (uint32_t)(row0 + (unsigned long long)(e % TILE) * row_step);
        uint32_t a = 0;
        const int k1 = __ldg(start + gi + 1);
        for (int k = __ldg(start + gi); k < k1; ++k) {
          const uint32_t msk = __ldg(rmask + k);
          a += (row & msk) == msk ? __ldg(coeff + k) : 0u;
        }
        th[e] = a;
      }
      for (int e = threadIdx.x; e < gc; e += NT) lm[e] = __ldg(lmask + g0 + e);
      __syncthreads();
      for (int gi = 0; gi < gc; ++gi) {
        const uint32_t msk = lm[gi];
#pragma unroll
        for (int li = 0; li < 2; ++li)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const uint32_t m = frag_m(wm, 2 * hm + li, c, lane);
              if ((m & msk) == msk)
                ang[li][nj][c] += th[gi * TILE + frag_n(wn, nj, c, lane)];
            }
      }
    }
#pragma unroll
    for (int li = 0; li < 2; ++li)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          qst::phase_rotate(acc[2 * hm + li][nj][0][c], acc[2 * hm + li][nj][1][c],
                            ang[li][nj][c]);
  }
}

// A persistent block per SM walks tiles blockIdx.x, + gridDim.x, ...; its
// jobs are (tile, k-chunk) pairs, loaded STAGES - 1 jobs ahead through the
// ring, so the next tile loads while this one contracts and stores.  W is
// loaded once per block.  In place (ALIAS) it is hazard-free: a block
// touches only its own tiles, and it stores a tile after the last chunk of
// that tile has landed (cp.async.wait_group) and been consumed; the
// chunks in flight then belong to its later tiles.
template <bool POS, bool ALIAS, bool ROTATE>
__global__ void __launch_bounds__(NT, 1)
panel_tc_kernel(typename qst::Io<float, ALIAS>::In re,
                typename qst::Io<float, ALIAS>::In im,
                const float* __restrict__ wr, const float* __restrict__ wi,
                typename qst::Io<float, ALIAS>::Out ore,
                typename qst::Io<float, ALIAS>::Out oim, long long ntiles,
                long long ext, long long tpa, int vec, qst::Phase ph) {
  static_assert(!(ROTATE && (ALIAS || POS)), "the rotated store: lane panel, out of place");
  constexpr bool WA = !POS && !ROTATE;
  extern __shared__ float4 tc_smem[];
  float* const sm = reinterpret_cast<float*>(tc_smem);
  float* const ring = sm + W_FLOATS;
  uint32_t* const scratch = reinterpret_cast<uint32_t*>(ring + STAGES * STAGE);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;

  for (int e = threadIdx.x; e < TILE * TILE; e += NT) {  // W, fragment order
    const int n = e / TILE, k = e % TILE;
    const int s = k >> 3, kk = k & 7;
    float* f = sm + ((s * (TILE / 8) + (n >> 3)) * 32 + (n & 7) * 4 + (kk & 3)) * 4;
    f[kk >> 2] = wr[e];
    f[2 + (kk >> 2)] = wi[e];
  }

  const long long mine = (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long jobs = mine * NCHUNK;
  auto issue = [&](long long j) {
    if (j < jobs) {
      const Tile tl = tile_at<POS>(blockIdx.x + (j / NCHUNK) * gridDim.x, ext, tpa);
      load_chunk<POS>(re, im, tl, ext, (int)(j % NCHUNK),
                      ring + (int)(j % STAGES) * STAGE, vec && tl.nv == TILE);
    }
    cp_async_commit();
  };
#pragma unroll 1
  for (int j = 0; j < STAGES - 1; ++j) issue(j);

  Acc acc;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][nj][0][c] = acc[mi][nj][1][c] = 0.f;

#pragma unroll 1
  for (long long j = 0; j < jobs; ++j) {
    cp_async_wait<STAGES - 2>();  // job j has landed (this thread's copies)
    __syncthreads();              // ... everyone's; stage j - 1 is consumed
    issue(j + STAGES - 1);
    const int ch = (int)(j % NCHUNK);
    chunk_mma<POS, WA>(ring + (int)(j % STAGES) * STAGE,
                       reinterpret_cast<const float4*>(sm), ch, acc, wm, wn, lane);
    if (ch != NCHUNK - 1) continue;

    const long long t = blockIdx.x + (j / NCHUNK) * gridDim.x;
    const Tile tl = tile_at<POS>(t, ext, tpa);
    if constexpr (!ROTATE) {
      if (ph.words != nullptr)
        diag_acc(ph, POS ? tl.base / TILE : tl.row0, POS ? ext / TILE : 1,
                 scratch, acc, wm, wn, lane);
    }
    // Stores from the accumulators.  Element (m, n) goes to o0 + n * S + m:
    // the lane panel's (r = n, i = m), the positioned panel's (c = m,
    // k = n), the rotated store's out[i * R + r] (n = i, m = r).  For fixed
    // c a warp's store writes 4 rows x 8 consecutive m: whole 32-byte
    // sectors.
    const long long o0 = POS || WA ? tl.base : tl.row0;
    const long long S = WA ? TILE : ext;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = frag_m(wm, mi, c, lane), n = frag_n(wn, nj, c, lane);
          // QST_TC_NOSTORE: a test the compiler cannot fold (vec is 0 or 1)
          if ((WA ? n : m) < tl.nv && !(QST_TC_NOSTORE && vec != 7)) {
            const long long o = o0 + n * S + m;
            ore[o] = acc[mi][nj][0][c];
            oim[o] = acc[mi][nj][1][c];
          }
          acc[mi][nj][0][c] = acc[mi][nj][1][c] = 0.f;
        }
  }
  cp_async_wait<0>();
}

template <bool POS, bool ALIAS, bool ROTATE>
cudaError_t launch(const float* re, const float* im, const float* wr,
                   const float* wi, float* ore, float* oim, long long ntiles,
                   long long ext, long long tpa, const qst::Phase& ph,
                   int device, cudaStream_t st) {
  auto kernel = panel_tc_kernel<POS, ALIAS, ROTATE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // cp.async moves 16 bytes: the planes must start on a 16-byte boundary.
  const int vec = ((reinterpret_cast<uintptr_t>(re) | reinterpret_cast<uintptr_t>(im)) & 15) == 0;
  const long long grid = ntiles < sms ? ntiles : sms;
  kernel<<<(unsigned)grid, NT, SMEM, st>>>(re, im, wr, wi, ore, oim, ntiles,
                                           ext, tpa, vec, ph);
  return cudaGetLastError();
}

// ---- dual_panel on the tensor cores: view (A, 128, 128) = (a, d = bits
// 7..13, l = bits 0..6).  Mode 0 (lane, pos 0) contracts l, mode 1 (full,
// pos 7) contracts d.
//
// The tile (d, l) of both planes stays resident in shared memory, unpadded
// and swizzled: element (d, l) at tix(d, l), the column XORed in its bits
// 2..4 by a function of d & 7.  The swizzle keeps each fragment pattern
// conflict-free: mode 0 reads X as B (8 rows g, 4 columns t), mode 1 as A
// (4 rows t, 8 columns g), and the write-back of either mode's output (4
// rows 2t + c, 8 columns g) too.  W streams in k-chunks of 32 through a
// two-stage cp.async ring, row-major [128 i][PW] (PW = 36 = 4 mod 32: its
// fragment loads are conflict-free); mode 0 takes W as A (m = i, X as B
// with n = d), mode 1 as B (n = i, X as A with m = l), so in both modes
// accumulator (m, n) is output element (row n, column m) of the tile and
// a warp's store covers whole 32-byte sectors.  Per tile: the load, the
// pre-straddler, contraction 1, a write-back into the tile, contraction 2
// (the next tile loading, slice by slice, into the k-slices it has
// consumed), then the store from the accumulators; or, with a
// post-straddler or a diag run, a write-back, the out-of-line SIMT
// epilogue on the tile, its store, and the next tile's whole load.
constexpr int PW = KC + 4;
constexpr int WSTAGE = 2 * TILE * PW;             // floats: Re W, Im W chunk
constexpr int TILE_FLOATS = TILE * TILE;
constexpr int DUAL_JOBS = 2 * NCHUNK;             // W chunks a tile
constexpr size_t DUAL_SMEM =
    sizeof(float) * (2 * TILE_FLOATS + STAGES * WSTAGE);  // 204,800 B
static_assert(DUAL_SMEM <= 232448, "one block's shared memory on sm_90");
static_assert(qst::phase_scratch_words(TILE / 2) <= STAGES * WSTAGE,
              "the diag scratch must fit the W ring");

__device__ __forceinline__ int tix(int r, int c) {
  const int v = (((r >> 1 ^ r >> 2) & 1) << 2) | (((r ^ r >> 1) & 1) << 1) |
                ((r >> 2) & 1);
  return r * TILE + (c ^ (v << 2));
}

// acc += chunk ch of the contraction in mode MODE: X from the tile, W from
// ring stage w ([i][PW], Re then Im).
template <int MODE>
__device__ __forceinline__ void dual_chunk(const float* tr, const float* ti,
                                           const float* w, int ch, Acc& acc,
                                           int wm, int wn, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* wr = w;
  const float* wi = w + TILE * PW;
#if QST_TC_DUAL_UNROLL == 4
#pragma unroll
#elif QST_TC_DUAL_UNROLL == 2
#pragma unroll 2
#else
#pragma unroll 1
#endif
  for (int ks = 0; ks < KC / 8; ++ks) {
    const int k0 = ch * KC + ks * 8;  // tile index of the step's first k
    k8_mma(
        [&](int mi, float (&ar)[4], float (&ai)[4]) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int m = wm * 64 + mi * 16 + g + 8 * (q & 1);
            const int k = t + 4 * (q >> 1);
            const int o = MODE ? tix(k0 + k, m) : m * PW + ks * 8 + k;
            ar[q] = MODE ? tr[o] : wr[o];
            ai[q] = MODE ? ti[o] : wi[o];
          }
        },
        [&](int nj, float (&br)[2], float (&bi)[2]) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int n = wn * 32 + nj * 8 + g;
            const int k = t + 4 * q;
            const int o = MODE ? n * PW + ks * 8 + k : tix(n, k0 + k);
            br[q] = MODE ? wr[o] : tr[o];
            bi[q] = MODE ? wi[o] : ti[o];
          }
        },
        acc);
  }
}

// The 2-qubit gate U on (lane bit 6, row bit qb - 7) of the resident tile,
// U in (6, qb) order: basis b = 2 * bit6 + bit_qb.  The reference's
// coefficient planes C_k[p] = U[b(p), b(p) ^ k] depend on p only through
// b(p), so sum_k C_k[p] x[p ^ flip_k] is a 4 x 4 product on each orbit
// {p, p ^ d, p ^ 64, p ^ d ^ 64}; a thread owns whole orbits, so the update
// is in place without a race.  u: Re U (16), then Im U (16).  Float32 on
// the SIMT units; ends with a barrier.
__device__ __noinline__ void straddle(const float* __restrict__ u, int qb,
                                      float* tr, float* ti) {
  const int dbit = qb - 7;
  float ur[16], ui[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    ur[k] = u[k];
    ui[k] = u[16 + k];
  }
  // Two orbits a thread at a time, every load before any product.
  for (int o0 = threadIdx.x; o0 < TILE_FLOATS / 4; o0 += 2 * NT) {
    int off[2][4];
    float xr[2][4], xi[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = o0 + h * NT;
      const int lo = o & 63;      // lane bits 0..5
      const int rest = o >> 6;    // the 6 row bits other than dbit
      const int d = ((rest >> dbit) << (dbit + 1)) | (rest & ((1 << dbit) - 1));
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        off[h][b] = tix(d | ((b & 1) << dbit), lo | ((b >> 1) << 6));
        xr[h][b] = tr[off[h][b]];
        xi[h][b] = ti[off[h][b]];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float yr = 0.f, yi = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          yr = fmaf(ur[4 * b + c], xr[h][c], yr);
          yr = fmaf(-ui[4 * b + c], xi[h][c], yr);
          yi = fmaf(ur[4 * b + c], xi[h][c], yi);
          yi = fmaf(ui[4 * b + c], xr[h][c], yi);
        }
        tr[off[h][b]] = yr;
        ti[off[h][b]] = yi;
      }
  }
  __syncthreads();
}

// The epilogue on the tile written back after contraction 2, on the SIMT
// units: the post-straddler, then the diag run (tile row d lies in state
// row row0 + d; phase_angles in two halves of 64 rows, its scratch in the
// W ring).  Out of line, so that its registers stay out of the
// contractions'.  Ends with a barrier.
__device__ __noinline__ void tile_epilogue(const float* __restrict__ u_post,
                                           int qb_post, qst::Phase ph,
                                           unsigned long long row0,
                                           uint32_t* scratch, float* tr,
                                           float* ti) {
  if (u_post != nullptr) straddle(u_post, qb_post, tr, ti);
  if (ph.words == nullptr) return;
  constexpr int TSTEP = NT / TILE;
  constexpr int J = TILE / 2 / TSTEP;
  const int lane = threadIdx.x % TILE, t0 = threadIdx.x / TILE;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    uint32_t a[J];
    qst::phase_angles<J, TSTEP>(ph, row0 + h * (TILE / 2), 1, lane, t0,
                                scratch, a);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int o = tix(h * (TILE / 2) + t0 + TSTEP * j, lane);
      qst::phase_rotate(tr[o], ti[o], a[j]);
    }
  }
  __syncthreads();
}

// One persistent block per SM walks tiles blockIdx.x, + gridDim.x, ....
// In place (ALIAS) it is hazard-free: a block touches only its own tiles;
// a tile's loads have all landed (cp.async.wait_group 0) and been consumed
// behind a barrier before its first store, and the load in flight during
// a store is the block's next tile.
template <bool ALIAS>
__global__ void __launch_bounds__(NT, 1)
dual_tc_kernel(typename qst::Io<float, ALIAS>::In re,
               typename qst::Io<float, ALIAS>::In im,
               const float* __restrict__ w1r, const float* __restrict__ w1i,
               int mode1, const float* __restrict__ w2r,
               const float* __restrict__ w2i, int mode2,
               const float* __restrict__ u_pre, int qb_pre,
               const float* __restrict__ u_post, int qb_post,
               typename qst::Io<float, ALIAS>::Out ore,
               typename qst::Io<float, ALIAS>::Out oim, long long ntiles,
               int vec, qst::Phase ph) {
  extern __shared__ float4 tc_smem[];
  float* const tr = reinterpret_cast<float*>(tc_smem);
  float* const ti = tr + TILE_FLOATS;
  float* const ring = ti + TILE_FLOATS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const bool epilogue = u_post != nullptr || ph.words != nullptr;

  // Job j of a tile: chunk j % NCHUNK of W1 (j < NCHUNK) or W2, into ring
  // stage j % STAGES.
  auto issue_w = [&](int j) {
    const float* wr = j < NCHUNK ? w1r : w2r;
    const float* wi = j < NCHUNK ? w1i : w2i;
    const int k0 = (j % NCHUNK) * KC;
    float* st = ring + (j % STAGES) * WSTAGE;
    for (int e = threadIdx.x; e < 2 * TILE * KC / 4; e += NT) {
      const int p = e / (TILE * KC / 4), r = e % (TILE * KC / 4);
      const int i = r / (KC / 4), q = r % (KC / 4);
      const float* src = (p ? wi : wr) + i * TILE + k0 + 4 * q;
      float* dst = st + p * TILE * PW + i * PW + 4 * q;
      if (vec) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) dst[c] = src[c];
      }
    }
  };
  // Slice h of tile t along the k axis of mode m (m = 1: rows 32h ..
  // 32h + 31; m = 0: those columns), both planes.
  auto issue_slice = [&](long long t, int h, int m) {
    const long long base = t * TILE_FLOATS;
    for (int e = threadIdx.x; e < 2 * TILE_FLOATS / 16; e += NT) {
      const int p = e / (TILE_FLOATS / 16), r = e % (TILE_FLOATS / 16);
      const int d = m ? h * KC + r / (TILE / 4) : r / (KC / 4);
      const int c = m ? 4 * (r % (TILE / 4)) : h * KC + 4 * (r % (KC / 4));
      const float* src = (p ? im : re) + base + d * TILE + c;
      float* dst = (p ? ti : tr) + tix(d, c);
      if (vec) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) dst[k] = src[k];
      }
    }
  };
  // Accumulator (m, n) <-> tile element (row n, column m).
  auto write_back = [&](Acc& acc) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int o = tix(frag_n(wn, nj, c, lane), frag_m(wm, mi, c, lane));
          tr[o] = acc[mi][nj][0][c];
          ti[o] = acc[mi][nj][1][c];
          acc[mi][nj][0][c] = acc[mi][nj][1][c] = 0.f;
        }
  };
  if ((long long)blockIdx.x < ntiles) {
    for (int h = 0; h < NCHUNK; ++h) issue_slice(blockIdx.x, h, 1);
    issue_w(0);
    cp_async_commit();
  }

#pragma unroll 1
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long base = t * TILE_FLOATS, next = t + gridDim.x;
    // The next tile loads slice by slice into the slices contraction 2 has
    // consumed, unless the epilogue still needs the tile.
    const bool prefetch = next < ntiles && !epilogue;
    cp_async_wait<0>();  // the tile and job 0 (this thread's copies)
    __syncthreads();     // ... everyone's
    if (u_pre != nullptr) straddle(u_pre, qb_pre, tr, ti);
    Acc acc;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mi][nj][0][c] = acc[mi][nj][1][c] = 0.f;
#pragma unroll 1
    for (int j = 0; j < DUAL_JOBS; ++j) {
      if (j > 0) {
        cp_async_wait<0>();  // job j has landed
        __syncthreads();     // ... everyone's; stage (j + 1) % 2 is consumed
      }
      if (j + 1 < DUAL_JOBS) issue_w(j + 1);
      if (prefetch && j > NCHUNK) issue_slice(next, j - NCHUNK - 1, mode2);
      cp_async_commit();
      const float* st = ring + (j % STAGES) * WSTAGE;
      if ((j < NCHUNK ? mode1 : mode2) != 0)
        dual_chunk<1>(tr, ti, st, j % NCHUNK, acc, wm, wn, lane);
      else
        dual_chunk<0>(tr, ti, st, j % NCHUNK, acc, wm, wn, lane);
      if (j == NCHUNK - 1) {
        __syncthreads();  // every read of the tile by contraction 1 is done
        write_back(acc);  // job j + 1's barrier orders it before contraction 2
      }
    }
    __syncthreads();  // every read of the tile and of the ring is done
    if (!epilogue) {
      // The rest of the next tile (its last slice) loads under the store.
      if (next < ntiles) {
        issue_slice(next, NCHUNK - 1, mode2);
        issue_w(0);
        cp_async_commit();
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const long long o = base + frag_n(wn, nj, c, lane) * TILE +
                                frag_m(wm, mi, c, lane);
            ore[o] = acc[mi][nj][0][c];
            oim[o] = acc[mi][nj][1][c];
          }
    } else {
      write_back(acc);
      __syncthreads();
      tile_epilogue(u_post, qb_post, ph, (unsigned long long)t * TILE,
                    reinterpret_cast<uint32_t*>(ring), tr, ti);
      for (int e = threadIdx.x; e < 2 * TILE_FLOATS / 4; e += NT) {
        const int p = e / (TILE_FLOATS / 4), r = e % (TILE_FLOATS / 4);
        const int d = r / (TILE / 4), c = 4 * (r % (TILE / 4));
        const float* src = (p ? ti : tr) + tix(d, c);
        float* dst = (p ? oim : ore) + base + d * TILE + c;
        if (vec) {
          *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) dst[k] = src[k];
        }
      }
      __syncthreads();  // the tile is read out: the next one may land
      if (next < ntiles) {
        for (int h = 0; h < NCHUNK; ++h) issue_slice(next, h, 1);
        issue_w(0);
        cp_async_commit();
      }
    }
  }
  cp_async_wait<0>();
}

template <bool ALIAS>
cudaError_t launch_dual(const float* re, const float* im, const float* w1r,
                        const float* w1i, int mode1, const float* w2r,
                        const float* w2i, int mode2, const float* u_pre,
                        int qb_pre, const float* u_post, int qb_post,
                        float* ore, float* oim, long long ntiles,
                        const qst::Phase& ph, int device, cudaStream_t st) {
  auto kernel = dual_tc_kernel<ALIAS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DUAL_SMEM);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // cp.async moves 16 bytes: every plane must start on a 16-byte boundary.
  const int vec = ((reinterpret_cast<uintptr_t>(re) | reinterpret_cast<uintptr_t>(im) |
                    reinterpret_cast<uintptr_t>(w1r) | reinterpret_cast<uintptr_t>(w1i) |
                    reinterpret_cast<uintptr_t>(w2r) | reinterpret_cast<uintptr_t>(w2i)) &
                   15) == 0;
  const long long grid = ntiles < sms ? ntiles : sms;
  kernel<<<(unsigned)grid, NT, DUAL_SMEM, st>>>(
      re, im, w1r, w1i, mode1, w2r, w2i, mode2, u_pre, qb_pre, u_post, qb_post,
      ore, oim, ntiles, vec, ph);
  return cudaGetLastError();
}

}  // namespace tc

template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SMEM_BYTES);
}

template <int DIM, bool ALIAS, bool ROTATE>
cudaError_t launch_lane(const float* re, const float* im, const float* wr,
                        const float* wi, float* ore, float* oim,
                        long long rows, cudaStream_t st) {
  cudaError_t err = allow_smem(lane_panel_kernel<DIM, ALIAS, ROTATE>);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + TILE - 1) / TILE;
  lane_panel_kernel<DIM, ALIAS, ROTATE>
      <<<(unsigned)blocks, NT, SMEM_BYTES, st>>>(re, im, wr, wi, ore, oim,
                                                 rows);
  return cudaGetLastError();
}

template <int DIM, bool ALIAS>
cudaError_t launch_positioned(const float* re, const float* im,
                              const float* wr, const float* wi, float* ore,
                              float* oim, long long A, long long C,
                              cudaStream_t st) {
  cudaError_t err = allow_smem(positioned_panel_kernel<DIM, ALIAS>);
  if (err != cudaSuccess) return err;
  const long long tpa = (C + TILE - 1) / TILE;
  positioned_panel_kernel<DIM, ALIAS>
      <<<(unsigned)(A * tpa), NT, SMEM_BYTES, st>>>(re, im, wr, wi, ore, oim,
                                                     C, tpa);
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
// (dim, rows) store, out of place and without a diag epilogue.  Dim 128
// runs on the tensor cores, dims 1..64 on the SIMT units.  Returns a
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
  if (dim == TILE) {
    const long long tiles = (rows + TILE - 1) / TILE;
    return (int)(rotate
        ? tc::launch<false, false, true>(re, im, wr, wi, ore, oim, tiles, rows, 1, ph, device, st)
        : alias
        ? tc::launch<false, true, false>(re, im, wr, wi, ore, oim, tiles, rows, 1, ph, device, st)
        : tc::launch<false, false, false>(re, im, wr, wi, ore, oim, tiles, rows, 1, ph, device, st));
  }
  switch (dim) {
#define QST_LANE(D)                                                          \
    case D:                                                                  \
      return (int)(rotate                                                    \
          ? launch_lane<D, false, true>(re, im, wr, wi, ore, oim, rows, st)  \
          : alias                                                            \
          ? launch_lane<D, true, false>(re, im, wr, wi, ore, oim, rows, st)  \
          : launch_lane<D, false, false>(re, im, wr, wi, ore, oim, rows, st));
    QST_LANE(1) QST_LANE(2) QST_LANE(4) QST_LANE(8)
    QST_LANE(16) QST_LANE(32) QST_LANE(64)
#undef QST_LANE
    default: return (int)cudaErrorInvalidValue;
  }
}

// The view (A, dim, C): C = 2^pos, dim in {1, ..., 128}; dim 128 on the
// tensor cores, as above.
int qst_positioned_panel(const float* re, const float* im, const float* wr,
                         const float* wi, float* ore, float* oim, long long A,
                         int dim, long long C, const void* phase, int G, int T,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int alias = qst::alias_mode(re, im, ore, oim);
  if (alias < 0 || (phase != nullptr && (dim != TILE || C % TILE != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const qst::Phase ph{(const uint32_t*)phase, G, T};
  if (dim == TILE) {
    const long long tpa = (C + TILE - 1) / TILE;
    return (int)(alias
        ? tc::launch<true, true, false>(re, im, wr, wi, ore, oim, A * tpa, C, tpa, ph, device, st)
        : tc::launch<true, false, false>(re, im, wr, wi, ore, oim, A * tpa, C, tpa, ph, device, st));
  }
  switch (dim) {
#define QST_POS(D)                                                           \
    case D:                                                                  \
      return (int)(alias                                                     \
          ? launch_positioned<D, true>(re, im, wr, wi, ore, oim, A, C, st)  \
          : launch_positioned<D, false>(re, im, wr, wi, ore, oim, A, C, st));
    QST_POS(1) QST_POS(2) QST_POS(4) QST_POS(8)
    QST_POS(16) QST_POS(32) QST_POS(64)
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
      ? tc::launch_dual<true>(re, im, w1r, w1i, mode1, w2r, w2i, mode2, u_pre,
                              qb_pre, u_post, qb_post, ore, oim, A, ph, device, st)
      : tc::launch_dual<false>(re, im, w1r, w1i, mode1, w2r, w2i, mode2, u_pre,
                               qb_pre, u_post, qb_post, ore, oim, A, ph, device, st));
}

}  // extern "C"
