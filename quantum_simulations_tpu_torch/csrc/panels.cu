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
// tc, panel_tc_kernel).  They replace _panel_kernel (:93, with its rotated
// store :116-118) and _positioned_row_kernel / _positioned_4d_kernel
// (:553, :605), which ran the panel on the TPU's matrix unit at
// Precision.HIGHEST (:28-40).  The Hopper counterpart is split TF32: each
// float32 operand x becomes hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x -
// hi), a real product is a_hi b_hi + a_hi b_lo + a_lo b_hi (lo lo
// dropped), a complex multiply-add four real products, twelve TF32 ones.
// Bound at n = 28: 2^28 x 16 B = 4.3 GB moved, 1.28 ms at 3.35 TB/s; the
// four-product form's 2^28 x 128 x 12 x 2 = 8.2e14 TF32 flop take 1.67 ms
// at 495 TFLOP/s (Gauss's nine would take 1.25), so the pass is bound by
// its tensor-core operations, a little above its bytes.
// Design: Hopper's warpgroup MMA (wgmma.mma_async m64n32k8 .tf32) in one
// persistent block per SM of three warpgroups; blocks walk the tiles
// blockIdx.x, + gridDim.x, ....
// - W is split once per pass, on the host side (ops/panel_kernels.py
//   tc_operand, kept with the schedule's operands): four planes, Re and Im
//   of hi and lo, each laid out as wgmma's K-major B operand without
//   swizzle (per k8 step, 16 groups of 8 rows i, each two 128-byte core
//   matrices of 8 rows by 4 k).  The kernel never splits W.  Its hi planes
//   stay resident in shared memory (128 KB, one bulk copy per block).
// - Producer: one warp streams each tile through a four-stage ring, one
//   k8 step a stage: the step's 128 x 8 slice of the tile (both planes) by
//   cp.async, W's lo planes of the step (8 KB, from L2) by a bulk copy.
//   An mbarrier per stage counts the arrivals and the bytes (full); the
//   consumers release the stage on another (empty).  So the next tile
//   loads while this one contracts, folds and stores.
// - Consumers: two warpgroups, each owns 64 rows m of the tile's free axis
//   (r for the lane panel, c for the positioned one) by all 128 outputs i:
//   128 float32 sums a thread.  A step: each thread loads its A fragments
//   of the stage (X as A from registers, m16 x k8 a warp) and splits them,
//   then for each 32-wide slice of i issues the slice's twelve TF32
//   products as wgmma into a fresh accumulator pair (re, im; scale-d 0 on
//   the first product of each), and folds the previous slice's pair into
//   the float32 sums by a rounded add while this one runs: two fresh pairs
//   in ping-pong.  The tensor cores truncate when they accumulate (chained
//   through all 96 products of an output, the error against float64 grew
//   14-fold under mma.sync), so nothing passes through them beyond one k8
//   step's six products.
// - Operand layout: PTX takes .tf32 operands from shared memory K-major
//   only.  W (i, k) row-major is K-major as B (n = i).  The positioned
//   tile lies (k, c), M-major, so X goes in as A from registers in both
//   layouts, read from the stage ([128 m][12] lane, [8 k][136] positioned:
//   both conflict-free for the fragment pattern).  A ragged or misaligned
//   tile (fewer than 128 valid rows or columns, planes not 16-byte
//   aligned) is loaded by the producer element by element into the same
//   layout, zero outside the view.
// - Stores go from the accumulators: in the lane panel a warp writes 8
//   rows of 8 consecutive i (float2), in the positioned and the rotated
//   store 4 rows of 8 consecutive m: whole 32-byte sectors.
//
// dual_panel, both contractions on the tensor cores (namespace tc,
// dual_tc_kernel: 9.4-9.7 ms at n = 28 on an H100 SXM, where the SIMT form
// took 15.0-15.7).  It replaces _dual_panel_kernel (:343), which ran both panels
// of the (A, 128, 128) view on the MXU with the straddlers on the VPU.
// Bound: the two 128-wide contractions need 2 x 18 flop a complex
// multiply-add by Gauss in split TF32, 2^28 x 128 x 36 = 1.24e15 TF32
// flop, 2.50 ms at 495 TFLOP/s at n = 28, over the 1.28 ms of bytes: the
// pass is bound by operations (6.19 ms in float32 on the SIMT units).
// Design: mma.sync m16n8k8 on fragments loaded from shared memory (k8_mma:
// the same split, four real products, each k8 step's products in a fresh
// accumulator added to the float32 sum by a rounded add); a persistent
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
// phase.cuh's arithmetic, on the float32 sums (tc::diag_acc: the lane and
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
// flight when the slab is overwritten.  panel_tc_kernel: the consumers
// store a tile from their sums only after every ring stage of it has
// landed (its full mbarrier) and been consumed (the wgmma groups that read
// it waited for); the stages the producer fills meanwhile hold the block's
// later tiles.  dual_tc_kernel: the block stores a tile only after the
// last cp.async group of that tile has landed (wait_group) and been
// consumed behind a barrier; the groups still in flight belong to its
// later tiles.
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

// ---- Dim 128 on the tensor cores. ----
//
// Measurement variants of the dual's k8 step, built only by
// panel_variants.py (-D<name>=1; the package's build sets none):
// QST_TC_GAUSS takes Gauss's three real products (nine TF32 products a
// complex multiply-add instead of twelve), QST_TC_DUAL_UNROLL = 2 or 4
// unrolls the dual kernel's four k8 steps a chunk by that factor (the
// package keeps them a loop, 1).
#ifndef QST_TC_GAUSS
#define QST_TC_GAUSS 0
#endif
#ifndef QST_TC_DUAL_UNROLL
#define QST_TC_DUAL_UNROLL 1
#endif

namespace tc {

// hi = x rounded to TF32 (nearest, ties away), lo = (x - hi) rounded the
// same way; x - hi is exact in float32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
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

// ---- lane_panel / positioned_panel: warpgroup MMA (see the head note).
constexpr int PT = 384;              // threads: producer warpgroup, 2 consumer ones
constexpr int CT = 256;              // consumer threads
constexpr int PSTAGES = 4;           // ring stages, one k8 step each
constexpr int KSTEPS = TILE / 8;     // k8 steps a tile
constexpr int XL = 12;               // lane stage [128 m][XL]: rows 12 apart (mod 32)
constexpr int XP = TILE + 8;         // positioned stage [8 k][XP]: rows 8 apart
constexpr int XPLANE = TILE * XL;    // floats of one X plane of a stage (>= 8 * XP)
constexpr int WPLANE = TILE * TILE;  // floats of one plane of the split W
constexpr int WSTEP = TILE * 8;      // floats of one k8 step of a plane
constexpr int PSTAGE = 2 * WSTEP + 2 * XPLANE;  // Re / Im W lo, then Re / Im X
constexpr int GC = 16;               // diag groups whose row angles are staged at once
constexpr int SCRATCH = GC * TILE + GC;
constexpr int FULL_ARRIVALS = 33;    // the producer's 32 lanes + its expect_tx
constexpr size_t PANEL_SMEM =
    sizeof(float) * (2 * WPLANE + PSTAGES * PSTAGE + SCRATCH) +
    sizeof(uint64_t) * (2 * PSTAGES + 1);  // 221,320 B
static_assert(8 * XP <= XPLANE, "the positioned stage fits the lane one");
static_assert((sizeof(float) * (2 * WPLANE + PSTAGES * PSTAGE + SCRATCH)) % 8 == 0,
              "the mbarriers are 8-byte aligned");
static_assert(PANEL_SMEM <= 232448, "one block's shared memory on sm_90");

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mb_init(uint32_t b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mb_arrive(uint32_t b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(b) : "memory");
}
// Arrive and expect `bytes` more of asynchronous copies in this phase.
__device__ __forceinline__ void mb_expect(uint32_t b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
               "r"(bytes)
               : "memory");
}
// Arrive when this thread's cp.async copies so far have landed (counted
// among the barrier's expected arrivals).
__device__ __forceinline__ void mb_arrive_cp_async(uint32_t b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(b)
               : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mb_wait(uint32_t b, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16) from global to shared memory, counted on b.
__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src,
                                          uint32_t bytes, uint32_t b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}
// The 256 consumer threads' own barrier (the producer never joins it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// wgmma's K-major B operand without swizzle at shared address `s`: core
// matrices of 8 rows by 16 bytes, the two k halves of a k8 step 128 bytes
// apart (leading byte offset), groups of 8 rows 256 bytes apart (stride
// byte offset).
__device__ __forceinline__ uint64_t bdesc(uint32_t s) {
  return (uint64_t)((s & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}
// Descriptor units (16 bytes) of the operand offsets used below.
constexpr uint64_t D_SLICE = 32 * 8 * 4 / 16;     // 32 rows i: the next slice
constexpr uint64_t D_STEP = WSTEP * 4 / 16;       // one k8 step of a plane
constexpr uint64_t D_WPLANE = WPLANE * 4 / 16;    // Re hi -> Im hi
constexpr uint64_t D_LOPLANE = WSTEP * 4 / 16;    // Re lo -> Im lo in a stage

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses of d across a wgmma wait.
__device__ __forceinline__ void pin(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = (ACC ? d : 0) + SA * a b on m64n32k8: a the warpgroup's A fragments
// (TF32, 64 x 8), b the 8 x 32 B operand at descriptor `b`, SA = +1 or -1.
// Accumulator element 4 j + c: row g (+ 8 for c >= 2), column 8 j + 2 t
// + (c & 1) of the warp's 16 rows.
template <int SA, int ACC>
__device__ __forceinline__ void wgmma(float (&d)[16], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, %22, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(ACC),
        "n"(SA));
}

// The A fragments of one k8 step, split: hi / lo of Re X and Im X.
struct XFrag {
  uint32_t rh[4], rl[4], ih[4], il[4];
};

// A fresh accumulator pair (re, im) of one 32-wide slice of i.
typedef float Pair[2][16];

// Slice Q of one k8 step into the fresh pair p: re = Xr Wr - Xi Wi, im =
// Xr Wi + Xi Wr, each real product lo hi and hi lo first, then hi hi.
// hi: descriptor of the step's Re W hi (Im W hi D_WPLANE on), lo: of the
// stage's Re W lo (Im W lo D_LOPLANE on).
template <int Q>
__device__ __forceinline__ void slice_mma(Pair& p, const XFrag& x, uint64_t hi,
                                          uint64_t lo) {
  const uint64_t hr = hi + Q * D_SLICE, hm = hr + D_WPLANE;
  const uint64_t lr = lo + Q * D_SLICE, lm = lr + D_LOPLANE;
  wg_fence();
  wgmma<1, 0>(p[0], x.rl, hr);
  wgmma<1, 1>(p[0], x.rh, lr);
  wgmma<-1, 1>(p[0], x.il, hm);
  wgmma<-1, 1>(p[0], x.ih, lm);
  wgmma<1, 1>(p[0], x.rh, hr);
  wgmma<-1, 1>(p[0], x.ih, hm);
  wgmma<1, 0>(p[1], x.rl, hm);
  wgmma<1, 1>(p[1], x.rh, lm);
  wgmma<1, 1>(p[1], x.il, hr);
  wgmma<1, 1>(p[1], x.ih, lr);
  wgmma<1, 1>(p[1], x.rh, hm);
  wgmma<1, 1>(p[1], x.ih, hr);
  wg_commit();
}

// The float32 sums of a consumer thread: acc[j][re / im][c], n8 block j
// of i, accumulator element c (row g + 8 (c >> 1), column 8 j + 2 t +
// (c & 1) of the warp's 16 rows m).
typedef float Sums[16][2][4];

// acc's slice Q += the finished pair p (after a wait for its group).
template <int Q>
__device__ __forceinline__ void fold(Sums& acc, Pair& p) {
  pin(p[0]);
  pin(p[1]);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[4 * Q + j][0][c] += p[0][4 * j + c];
      acc[4 * Q + j][1][c] += p[1][4 * j + c];
    }
}

// k8 step k0 / 8 of a tile into the stage's X planes xs (Re, then Im
// XPLANE on): [m][XL] (lane) or [k][XP] (positioned).  A full tile on
// 16-byte aligned planes goes by cp.async, 16 a lane (the caller arrives
// on the stage's barrier when they land); a ragged or misaligned one by
// plain loads, zero outside the view.  The producer warp's 32 lanes call
// it.
template <bool POS, typename In>
__device__ __forceinline__ void load_x(In re, In im, const Tile& tl,
                                       long long C, int k0, float* xs,
                                       bool fast, int lane) {
  if (fast) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int e = lane + 32 * i;  // 16-byte pieces: 256 a plane
      const int p = e >> 8, r = e & 255;
      const float* src = p ? im : re;
      float* dst = xs + p * XPLANE;
      if constexpr (POS) {
        const int k = r >> 5, q = r & 31;
        cp_async16(dst + k * XP + 4 * q, src + tl.base + (k0 + k) * C + 4 * q);
      } else {
        const int m = r >> 1, h = r & 1;
        cp_async16(dst + m * XL + 4 * h, src + tl.base + m * TILE + k0 + 4 * h);
      }
    }
  } else {
    for (int e = lane; e < 2 * TILE * 8; e += 32) {
      const int p = e / (TILE * 8), r = e % (TILE * 8);
      const float* src = p ? im : re;
      float* dst = xs + p * XPLANE;
      if constexpr (POS) {
        const int k = r / TILE, c = r % TILE;
        dst[k * XP + c] = c < tl.nv ? src[tl.base + (k0 + k) * C + c] : 0.f;
      } else {
        const int m = r / 8, kk = r % 8;
        dst[m * XL + kk] = m < tl.nv ? src[tl.base + m * TILE + k0 + kk] : 0.f;
      }
    }
  }
}

// The diag epilogue on the sums (phase.cuh's arithmetic).  Element (m, n)
// of the tile (m = mb + g + 8 (c >> 1), n = 8 j + 2 t + (c & 1)) lies in
// state row row0 + R * row_step at lane L: the positioned panel's (c = m,
// i = n) at L = m, R = n; the lane panel's (r = m, i = n) at L = n, R = m.
// Each group's row angle is computed once per tile row into shared
// scratch, GC groups at a time; a thread sums half of its elements at a
// time to keep its registers for the sums.  Every consumer thread calls
// it.  Inlined, so that the kernel holds no call beside its wgmma.
template <bool POS>
__device__ __forceinline__ void diag_acc(const qst::Phase& ph, unsigned long long row0,
                         unsigned long long row_step, uint32_t* scratch,
                         Sums& acc, int mb, int lane, int ctid) {
  const uint32_t* lmask = ph.words + qst::PHASE_LANES;
  const uint32_t* start = lmask + ph.G;
  const uint32_t* rmask = start + ph.G + 1;
  const uint32_t* coeff = rmask + ph.T;
  uint32_t* th = scratch;               // [GC][TILE]
  uint32_t* lm = scratch + GC * TILE;
  const int g = lane >> 2, t = lane & 3;
  auto lane_of = [&](int j, int c) {
    return POS ? mb + g + 8 * (c >> 1) : 8 * j + 2 * t + (c & 1);
  };
  auto row_of = [&](int j, int c) {
    return POS ? 8 * j + 2 * t + (c & 1) : mb + g + 8 * (c >> 1);
  };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t ang[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) ang[j][c] = __ldg(ph.words + lane_of(8 * h + j, c));
    for (int g0 = 0; g0 < ph.G; g0 += GC) {
      const int gc = min(GC, ph.G - g0);
      consumers_sync();  // the previous chunk is consumed
      for (int e = ctid; e < gc * TILE; e += CT) {
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
      for (int e = ctid; e < gc; e += CT) lm[e] = __ldg(lmask + g0 + e);
      consumers_sync();
      for (int gi = 0; gi < gc; ++gi) {
        const uint32_t msk = lm[gi];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (((uint32_t)lane_of(8 * h + j, c) & msk) == msk)
              ang[j][c] += th[gi * TILE + row_of(8 * h + j, c)];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        qst::phase_rotate(acc[8 * h + j][0][c], acc[8 * h + j][1][c], ang[j][c]);
  }
}

// One persistent block per SM: warp 0 produces, warps 4..11 (two
// warpgroups) consume; see the head note.  Job j (the block's k8 steps in
// order, tile after tile) fills ring stage j % PSTAGES in round
// j / PSTAGES.  In place (ALIAS) it is hazard-free: a block touches only
// its own tiles, and the consumers store a tile from their sums only
// after every stage of that tile has landed (its full barrier) and been
// consumed (the wgmma groups reading it waited for); the stages the
// producer fills meanwhile hold the block's later tiles.
template <bool POS, bool ALIAS, bool ROTATE>
__global__ void __launch_bounds__(PT, 1)
panel_tc_kernel(typename qst::Io<float, ALIAS>::In re,
                typename qst::Io<float, ALIAS>::In im,
                const float* __restrict__ wtc,
                typename qst::Io<float, ALIAS>::Out ore,
                typename qst::Io<float, ALIAS>::Out oim, long long ntiles,
                long long ext, long long tpa, int vec, qst::Phase ph) {
  static_assert(!(ROTATE && (ALIAS || POS)), "the rotated store: lane panel, out of place");
  extern __shared__ float4 tc_smem[];
  float* const whi = reinterpret_cast<float*>(tc_smem);  // Re W hi, Im W hi
  float* const ring = whi + 2 * WPLANE;
  uint32_t* const scratch = reinterpret_cast<uint32_t*>(ring + PSTAGES * PSTAGE);
  const uint32_t bars = saddr(scratch + SCRATCH);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (PSTAGES + s); };
  const uint32_t wbar = bars + 8 * (2 * PSTAGES);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long mine = (long long)blockIdx.x < ntiles
      ? (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < PSTAGES; ++s) {
      mb_init(full(s), FULL_ARRIVALS);
      mb_init(empty(s), CT);
    }
    mb_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {  // the producer warpgroup: warp 0 loads, 1..3 leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (warp != 0 || mine == 0) return;
    if (lane == 0) {
      mb_expect(wbar, 2 * WPLANE * sizeof(float));
      bulk_load(saddr(whi), wtc, WPLANE * sizeof(float), wbar);
      bulk_load(saddr(whi + WPLANE), wtc + WPLANE, WPLANE * sizeof(float), wbar);
    }
    long long job = 0;
#pragma unroll 1
    for (long long i = 0; i < mine; ++i) {
      const Tile tl = tile_at<POS>(blockIdx.x + i * gridDim.x, ext, tpa);
      const bool fast = vec && tl.nv == TILE;
#pragma unroll 1
      for (int s = 0; s < KSTEPS; ++s, ++job) {
        const int st = (int)(job % PSTAGES);
        mb_wait(empty(st), ((uint32_t)(job / PSTAGES) & 1) ^ 1);
        float* const stage = ring + st * PSTAGE;
        if (lane == 0) {
          mb_expect(full(st), 2 * WSTEP * sizeof(float));
          bulk_load(saddr(stage), wtc + 2 * WPLANE + s * WSTEP,
                    WSTEP * sizeof(float), full(st));
          bulk_load(saddr(stage + WSTEP), wtc + 3 * WPLANE + s * WSTEP,
                    WSTEP * sizeof(float), full(st));
        }
        load_x<POS>(re, im, tl, ext, 8 * s, stage + 2 * WSTEP, fast, lane);
        if (fast)
          mb_arrive_cp_async(full(st));
        else
          mb_arrive(full(st));
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // The consumers.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  if (mine == 0) return;
  const int ctid = threadIdx.x - 128;
  const int mb = 16 * (warp - 4);  // the warp's first row m of the tile
  const int g = lane >> 2, t = lane & 3;
  const uint32_t whi_s = saddr(whi), ring_s = saddr(ring);
  Sums acc;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][0][c] = acc[j][1][c] = 0.f;
  Pair p0, p1;
#pragma unroll
  for (int c = 0; c < 16; ++c) p0[0][c] = p0[1][c] = p1[0][c] = p1[1][c] = 0.f;
  mb_wait(wbar, 0);

  long long job = 0;
#pragma unroll 1
  for (long long i = 0; i < mine; ++i) {
    const Tile tl = tile_at<POS>(blockIdx.x + i * gridDim.x, ext, tpa);
    int prev = 0;
#pragma unroll 1
    for (int s = 0; s < KSTEPS; ++s, ++job) {
      const int st = (int)(job % PSTAGES);
      // The step's A fragments, a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
      // a3 (g + 8, t + 4), Re then Im, read while the previous step's last
      // slice still runs.
      mb_wait(full(st), (uint32_t)(job / PSTAGES) & 1);
      const float* xs = ring + st * PSTAGE + 2 * WSTEP;
      float xf[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = mb + g + 8 * (q & 1), k = t + 4 * (q >> 1);
        const int o = POS ? k * XP + m : m * XL + k;
        xf[q] = xs[o];
        xf[4 + q] = xs[XPLANE + o];
      }
      // That slice is done: its stage is free, its A registers may be
      // overwritten.  The wait is unconditional, so ptxas sees p1
      // complete on every path to its fold below and does not serialize
      // the wgmma.
      wg_wait<0>();
      if (s > 0) mb_arrive(empty(prev));
      XFrag x;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        split(xf[q], x.rh[q], x.rl[q]);
        split(xf[4 + q], x.ih[q], x.il[q]);
      }
      const uint64_t hi = bdesc(whi_s) + s * D_STEP;
      const uint64_t lo = bdesc(ring_s + st * PSTAGE * (int)sizeof(float));
      slice_mma<0>(p0, x, hi, lo);
      if (s > 0) fold<3>(acc, p1);
      slice_mma<1>(p1, x, hi, lo);
      wg_wait<1>();
      fold<0>(acc, p0);
      slice_mma<2>(p0, x, hi, lo);
      wg_wait<1>();
      fold<1>(acc, p1);
      slice_mma<3>(p1, x, hi, lo);
      wg_wait<1>();
      fold<2>(acc, p0);
      prev = st;
    }
    wg_wait<0>();
    mb_arrive(empty(prev));
    fold<3>(acc, p1);

    if constexpr (!ROTATE) {
      if (ph.words != nullptr)
        diag_acc<POS>(ph, POS ? tl.base / TILE : tl.row0, POS ? ext / TILE : 1,
                      scratch, acc, mb, lane, ctid);
    }
    // Stores from the sums: element (m, n) goes to base + m * 128 + n (the
    // lane panel's (r, i)), or to o0 + n * ext + m (the positioned panel's
    // (c, i), the rotated store's out[i * R + r]).
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mb + g + 8 * h, n = 8 * j + 2 * t;
        if (m < tl.nv) {
          const float r0 = acc[j][0][2 * h], r1 = acc[j][0][2 * h + 1];
          const float i0 = acc[j][1][2 * h], i1 = acc[j][1][2 * h + 1];
          if constexpr (POS || ROTATE) {
            const long long o = (POS ? tl.base : tl.row0) + n * ext + m;
            ore[o] = r0;
            oim[o] = i0;
            ore[o + ext] = r1;
            oim[o + ext] = i1;
          } else {
            const long long o = tl.base + m * TILE + n;
            if (vec) {
              *reinterpret_cast<float2*>(ore + o) = make_float2(r0, r1);
              *reinterpret_cast<float2*>(oim + o) = make_float2(i0, i1);
            } else {
              ore[o] = r0;
              ore[o + 1] = r1;
              oim[o] = i0;
              oim[o + 1] = i1;
            }
          }
        }
#pragma unroll
        for (int c = 2 * h; c < 2 * h + 2; ++c) acc[j][0][c] = acc[j][1][c] = 0.f;
      }
  }
}

template <bool POS, bool ALIAS, bool ROTATE>
cudaError_t launch(const float* re, const float* im, const float* wtc,
                   float* ore, float* oim, long long ntiles, long long ext,
                   long long tpa, const qst::Phase& ph, int device,
                   cudaStream_t st) {
  // The split operand is read by bulk copies: 16-byte aligned.
  if (wtc == nullptr || (reinterpret_cast<uintptr_t>(wtc) & 15) != 0)
    return cudaErrorInvalidValue;
  auto kernel = panel_tc_kernel<POS, ALIAS, ROTATE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PANEL_SMEM);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // cp.async moves 16 bytes, the lane panel's stores 8: the planes must
  // start on a 16-byte boundary.
  const int vec = ((reinterpret_cast<uintptr_t>(re) | reinterpret_cast<uintptr_t>(im) |
                    reinterpret_cast<uintptr_t>(ore) | reinterpret_cast<uintptr_t>(oim)) &
                   15) == 0;
  const long long grid = ntiles < sms ? ntiles : sms;
  kernel<<<(unsigned)grid, PT, PANEL_SMEM, st>>>(re, im, wtc, ore, oim, ntiles,
                                                 ext, tpa, vec, ph);
  return cudaGetLastError();
}

// ---- The dual's k8 step: mma.sync m16n8k8, fragments from shared memory.
constexpr int NT = 256;              // 8 warps: 2 along m (64 each), 4 along n (32)
constexpr int KC = 32;               // k per ring stage
constexpr int STAGES = 2;
constexpr int NCHUNK = TILE / KC;

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

// The warp's 64 x 32 block of the tile: acc[mi][nj][re / im][c], fragment
// element c of m16 tile mi and n8 tile nj (rows g, g + 8; columns 2t, 2t+1).
typedef float Acc[4][4][2][4];

// acc[mi][nj] += the complex product of one k8 step: re = Ar Br + An Bi,
// im = Ar Bi + Ai Br, with An = -Ai, each real product three TF32 products
// (lo hi and hi lo first, then hi hi).  The tensor cores add into their
// accumulator by truncation, which biases a long sum toward zero.  So the
// step's six products of a part go into a fresh accumulator and its sum is
// added to acc by a float32 add, rounded to nearest: at most two
// truncations touch each hi product.
__device__ __forceinline__ void cmma(float (&dr)[4], float (&di)[4],
                                     const uint32_t (&arh)[4], const uint32_t (&arl)[4],
                                     const uint32_t (&aih)[4], const uint32_t (&ail)[4],
                                     const uint32_t (&anh)[4], const uint32_t (&anl)[4],
                                     const uint32_t (&brh)[2], const uint32_t (&brl)[2],
                                     const uint32_t (&bih)[2], const uint32_t (&bil)[2]) {
  float tr[4], ti[4];
  mma0(tr, arl, brh);
  mma(tr, arh, brl);
  mma(tr, anl, bih);
  mma(tr, anh, bil);
  mma(tr, arh, brh);
  mma(tr, anh, bih);
  mma0(ti, arl, bih);
  mma(ti, arh, bil);
  mma(ti, ail, brh);
  mma(ti, aih, brl);
  mma(ti, arh, bih);
  mma(ti, aih, brh);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    dr[c] += tr[c];
    di[c] += ti[c];
  }
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

// acc += one k8 step of the warp's 64 x 32 block (the dual's contractions).
// load_b(nj, br, bi) gives the B
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

// Tile element (m, n) of fragment (mi, nj, c).
__device__ __forceinline__ int frag_m(int wm, int mi, int c, int lane) {
  return wm * 64 + mi * 16 + (lane >> 2) + 8 * (c >> 1);
}
__device__ __forceinline__ int frag_n(int wn, int nj, int c, int lane) {
  return wn * 32 + nj * 8 + 2 * (lane & 3) + (c & 1);
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
// runs on the tensor cores from wtc, W's split operand (four planes of 128
// x 128 floats, 16-byte aligned: ops/panel_kernels.tc_operand), dims 1..64
// on the SIMT units from (wr, wi) (wtc unused).  Returns a cudaError_t.
int qst_lane_panel(const float* re, const float* im, const float* wr,
                   const float* wi, const float* wtc, float* ore, float* oim,
                   long long rows, int dim, int rotate, const void* phase,
                   int G, int T, int device, void* stream) {
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
        ? tc::launch<false, false, true>(re, im, wtc, ore, oim, tiles, rows, 1, ph, device, st)
        : alias
        ? tc::launch<false, true, false>(re, im, wtc, ore, oim, tiles, rows, 1, ph, device, st)
        : tc::launch<false, false, false>(re, im, wtc, ore, oim, tiles, rows, 1, ph, device, st));
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
// tensor cores from wtc, as above.
int qst_positioned_panel(const float* re, const float* im, const float* wr,
                         const float* wi, const float* wtc, float* ore,
                         float* oim, long long A, int dim, long long C,
                         const void* phase, int G, int T, int device,
                         void* stream) {
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
        ? tc::launch<true, true, false>(re, im, wtc, ore, oim, A * tpa, C, tpa, ph, device, st)
        : tc::launch<true, false, false>(re, im, wtc, ore, oim, A * tpa, C, tpa, ph, device, st));
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
