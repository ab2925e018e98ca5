// zstring_sum: the expectations of up to 128 Z-strings over a whole state in
// one read, for Hopper (sm_90a).
//
//   S_k = sum_i |psi_i|^2 (-1)^popc(i & m_k),   k < K <= KMAX = 128
//
// Replaces no Pallas kernel: the JAX package's readout is plain jnp
// (quantum_simulations_tpu/ops/sampling.py:45).  Added for the readout, so
// that ops/observables.maxcut_energy reads all its edges, and
// ops/sampling.expectation_z_planar its one string, with one pass.
//
// Bound on an H100 SXM: bytes.  The state is read once, 8 B an amplitude,
// and nothing is written but K sums a block: 2 GiB at n = 28, 0.641 ms at
// 3.35 TB/s.  The work an amplitude costs must not grow with K, so:
//
// * A block of NT = 128 threads takes tiles of 2^13 amplitudes.  Each
//   thread holds 64 of a tile in registers: A amplitudes a 16-byte load (2
//   of a complex64 tensor, "interleaved"; 4 of a float32 plane, "planar")
//   and 64 / A loads at a stride of NT loads.  Index bits of amplitude x of
//   thread t in tile T: bits 0..a-1 the position in the load (A = 2^a),
//   a..a+6 the thread, a+7..12 the load, 13.. the tile.  A mask's parity
//   splits over the three fields: the load and position bits ("register
//   bits", six of them) vary per amplitude, the thread and tile bits are
//   fixed for the thread's 64.
// * The thread takes the Walsh-Hadamard transform of its 64 |psi|^2 over
//   the six register bits in float32, W[s] = sum_x (-1)^popc(x & s) p[x]:
//   six adds an amplitude, whatever K.  Each W[s] is a sum of 64 terms, the
//   most any float32 sum here holds.
// * The 64 W's go to shared memory.  Thread k < K owns mask k: it reads
//   W[s_k] of every thread of the block (s_k = the mask's register bits),
//   signs each by the mask's parity over that thread's bits, sums in
//   float64, and signs the tile's sum by the parity over the tile bits.
// * Each block writes its K sums; zstring_sum_blocks_kernel adds them per
//   mask in block order.  No atomics: a repeated call gives the same bits.
//
// qst_zstring_blocks gives the grid (and so the scratch) for a state's
// size; qst_zstring_sums launches on the given stream, allocates nothing
// (the wrapper gives the per-block scratch) and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;
constexpr int LOG_NT = 7;
constexpr int REG = 64;         // amplitudes a thread holds of a tile
constexpr int TILE_BITS = 13;   // log2(NT * REG)
constexpr int KMAX = NT;        // one mask a thread
constexpr int BLOCKS_PER_SM = 4;
constexpr int LD = NT + 1;      // shared row stride: owners read s_k rows

struct Masks {
  unsigned long long m[KMAX];
};

__device__ __forceinline__ float flip(float w, unsigned parity_bit31) {
  return __int_as_float(__float_as_int(w) ^ parity_bit31);
}

// PLANAR: re and im are contiguous float32 planes.  Else re points at a
// complex64 tensor (re, im interleaved) and im is not read.
template <bool PLANAR>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM)
zstring_sum_kernel(const float* __restrict__ re, const float* __restrict__ im,
                   long long N, Masks masks, int K, double* __restrict__ partial) {
  constexpr int A_BITS = PLANAR ? 2 : 1;
  constexpr int A = 1 << A_BITS;
  constexpr int J = REG / A;  // loads a thread and tile
  __shared__ float W[REG * LD];

  const int t = threadIdx.x;
  // The owner's mask, split into its register, thread and tile bits; the
  // parity of each thread u's bits, one bit a u.
  unsigned long long m = 0;
  int s = 0;
  unsigned lane_par[NT / 32] = {0, 0, 0, 0};
  if (t < K) {
    m = masks.m[t];
    s = (int)(m & (A - 1)) | (int)(((m >> (A_BITS + LOG_NT)) & (J - 1)) << A_BITS);
    const unsigned ml = (unsigned)(m >> A_BITS) & (NT - 1);
#pragma unroll
    for (int u = 0; u < NT; ++u)
      lane_par[u / 32] |= (unsigned)(__popc(u & ml) & 1) << (u % 32);
  }
  double acc = 0.0;

  const long long tiles = (N + (1LL << TILE_BITS) - 1) >> TILE_BITS;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float p[REG];
    const long long q0 = tile * (NT * J) + t;  // this thread's first load
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const long long q = q0 + (long long)j * NT;
      const long long i0 = q * A;  // its first amplitude
      if constexpr (PLANAR) {
        if (i0 + A <= N) {
          const float4 a = __ldcs(reinterpret_cast<const float4*>(re) + q);
          const float4 b = __ldcs(reinterpret_cast<const float4*>(im) + q);
          p[A * j + 0] = fmaf(b.x, b.x, a.x * a.x);
          p[A * j + 1] = fmaf(b.y, b.y, a.y * a.y);
          p[A * j + 2] = fmaf(b.z, b.z, a.z * a.z);
          p[A * j + 3] = fmaf(b.w, b.w, a.w * a.w);
        } else {
#pragma unroll
          for (int e = 0; e < A; ++e)
            p[A * j + e] = i0 + e < N ? fmaf(im[i0 + e], im[i0 + e],
                                             re[i0 + e] * re[i0 + e])
                                      : 0.f;
        }
      } else {
        if (i0 + A <= N) {
          const float4 v = __ldcs(reinterpret_cast<const float4*>(re) + q);
          p[A * j + 0] = fmaf(v.y, v.y, v.x * v.x);
          p[A * j + 1] = fmaf(v.w, v.w, v.z * v.z);
        } else if (i0 < N) {
          const float2 v = reinterpret_cast<const float2*>(re)[i0];
          p[A * j + 0] = fmaf(v.y, v.y, v.x * v.x);
          p[A * j + 1] = 0.f;
        } else {
          p[A * j + 0] = 0.f;
          p[A * j + 1] = 0.f;
        }
      }
    }
    // Walsh-Hadamard transform over the six register bits, in registers.
#pragma unroll
    for (int b = 1; b < REG; b <<= 1) {
#pragma unroll
      for (int x = 0; x < REG; ++x) {
        if (!(x & b)) {
          const float u = p[x], v = p[x | b];
          p[x] = u + v;
          p[x | b] = u - v;
        }
      }
    }
    __syncthreads();  // the last tile's owners are done with W
#pragma unroll
    for (int x = 0; x < REG; ++x) W[x * LD + t] = p[x];
    __syncthreads();
    if (t < K) {
      const float* w = W + s * LD;
      double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
#pragma unroll
      for (int u = 0; u < NT; u += 4) {
        const unsigned bits = lane_par[u / 32] >> (u % 32);
        a0 += (double)flip(w[u + 0], (bits & 1u) << 31);
        a1 += (double)flip(w[u + 1], (bits & 2u) << 30);
        a2 += (double)flip(w[u + 2], (bits & 4u) << 29);
        a3 += (double)flip(w[u + 3], (bits & 8u) << 28);
      }
      const double sum = (a0 + a1) + (a2 + a3);
      const unsigned long long base = (unsigned long long)tile << TILE_BITS;
      acc += (__popcll(base & m) & 1) ? -sum : sum;
    }
  }
  if (t < K) partial[(long long)blockIdx.x * K + t] = acc;
}

// out[k] = sum over the blocks b, in order, of partial[b * K + k].
__global__ void __launch_bounds__(KMAX)
zstring_sum_blocks_kernel(const double* __restrict__ partial, int blocks, int K,
                          double* __restrict__ out) {
  const int k = threadIdx.x;
  if (k >= K) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b) s += partial[(long long)b * K + k];
  out[k] = s;
}

}  // namespace

extern "C" {

const char* qst_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The grid for N amplitudes: one block a tile, at most BLOCKS_PER_SM a
// multiprocessor.  Fixed for a device and a size, so the order in which
// the sums are added is too.  qst_zstring_sums takes blocks * K doubles of
// scratch.
int qst_zstring_blocks(long long N, int* blocks, int device) {
  if (N < 1 || blocks == nullptr) return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (N + (1LL << TILE_BITS) - 1) >> TILE_BITS;
  const long long most = (long long)BLOCKS_PER_SM * sms;
  *blocks = (int)(tiles < most ? tiles : most);
  return 0;
}

// The K <= 128 sums S_k of the N amplitudes into out[K] (float64), through
// partial[blocks * K] (float64 scratch).  planar: re and im are contiguous
// float32 planes; else re is a complex64 tensor's data and im is ignored.
// Loads are 16 bytes: re (and im) must start on a 16-byte boundary.
int qst_zstring_sums(const float* re, const float* im, int planar, long long N,
                     const unsigned long long* masks, int K, double* partial,
                     int blocks, double* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N < 1 || K < 1 || K > KMAX || blocks < 1 || masks == nullptr)
    return (int)cudaErrorInvalidValue;
  Masks mk;
  for (int k = 0; k < KMAX; ++k) mk.m[k] = k < K ? masks[k] : 0ULL;
  cudaStream_t st = (cudaStream_t)stream;
  if (planar)
    zstring_sum_kernel<true><<<(unsigned)blocks, NT, 0, st>>>(re, im, N, mk, K, partial);
  else
    zstring_sum_kernel<false><<<(unsigned)blocks, NT, 0, st>>>(re, im, N, mk, K, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  zstring_sum_blocks_kernel<<<1, KMAX, 0, st>>>(partial, blocks, K, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
