// Native host-side statevector kernels (C++17 + OpenMP).
//
// Role: the CPU performance tier of the framework — the fast oracle for
// large-n verification and the host-side compute path of the out-of-core
// runner (stripes can be processed on the host while the TPU works on
// others).  Fills the slot the reference implements with its C++
// OpenMP/AVX-512 engine (hisvsim_repo/state_vector.hpp, basic_gates.hpp,
// loop.hpp) — re-designed as a small flat-buffer kernel library: strided
// complex pair/quad updates that the compiler auto-vectorizes, exposed
// through a plain C ABI for ctypes (no pybind11 in this image).
//
// Layout: amplitudes are interleaved re,im pairs (numpy complex64 /
// complex128 buffers passed by pointer).  Qubit indexing is little-endian
// (qubit q = bit q of the amplitude index), matching the circuit contract.
//
// Build: see build.py (g++ -O3 -march=native -fopenmp -shared -fPIC).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <complex>

#if defined(__linux__)
#include <sys/mman.h>
#endif

#if defined(_OPENMP)
#include <omp.h>
#endif

using u64 = std::uint64_t;

namespace {

template <typename T>
inline void pair_update(std::complex<T>* psi, u64 i0, u64 i1,
                        const std::complex<double>* U) {
    const std::complex<T> a = psi[i0];
    const std::complex<T> b = psi[i1];
    psi[i0] = std::complex<T>(
        static_cast<T>(U[0].real() * a.real() - U[0].imag() * a.imag()
                     + U[1].real() * b.real() - U[1].imag() * b.imag()),
        static_cast<T>(U[0].real() * a.imag() + U[0].imag() * a.real()
                     + U[1].real() * b.imag() + U[1].imag() * b.real()));
    psi[i1] = std::complex<T>(
        static_cast<T>(U[2].real() * a.real() - U[2].imag() * a.imag()
                     + U[3].real() * b.real() - U[3].imag() * b.imag()),
        static_cast<T>(U[2].real() * a.imag() + U[2].imag() * a.real()
                     + U[3].real() * b.imag() + U[3].imag() * b.real()));
}

// Generic 1q gate: strided pair loop, collapse(2) across blocks/offsets.
template <typename T>
void apply_1q(std::complex<T>* psi, u64 n_amps, int q,
              const std::complex<double>* U) {
    const u64 step = u64(1) << q;
    const u64 block = step << 1;
    const u64 n_blocks = n_amps / block;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (long long bi = 0; bi < (long long)n_blocks; ++bi) {
        const u64 base = u64(bi) * block;
        for (u64 off = 0; off < step; ++off) {
            pair_update(psi, base + off, base + off + step, U);
        }
    }
}

template <typename T>
inline std::complex<T> row4(const std::complex<double>* U, int r,
                            const std::complex<T>& v0, const std::complex<T>& v1,
                            const std::complex<T>& v2, const std::complex<T>& v3) {
    double re = 0.0, im = 0.0;
    const std::complex<T>* vs[4] = {&v0, &v1, &v2, &v3};
    for (int c = 0; c < 4; ++c) {
        const std::complex<double>& u = U[4 * r + c];
        const double vr = vs[c]->real(), vi = vs[c]->imag();
        re += u.real() * vr - u.imag() * vi;
        im += u.real() * vi + u.imag() * vr;
    }
    return std::complex<T>(static_cast<T>(re), static_cast<T>(im));
}

// Generic 2q gate (big-endian subspace: row = 2*b_qa + b_qb).
template <typename T>
void apply_2q(std::complex<T>* psi, u64 n_amps, int qa, int qb,
              const std::complex<double>* U) {
    const u64 ma = u64(1) << qa;
    const u64 mb = u64(1) << qb;
    const u64 n_iter = n_amps >> 2;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (long long it = 0; it < (long long)n_iter; ++it) {
        // Expand iteration index into an amplitude index with bits qa,qb = 0.
        u64 i = (u64)it;
        const int lo = qa < qb ? qa : qb;
        const int hi = qa < qb ? qb : qa;
        u64 base = i & ((u64(1) << lo) - 1);
        i >>= lo;
        base |= (i & ((u64(1) << (hi - lo - 1)) - 1)) << (lo + 1);
        i >>= (hi - lo - 1);
        base |= i << (hi + 1);
        const u64 i00 = base;
        const u64 i01 = base | mb;
        const u64 i10 = base | ma;
        const u64 i11 = base | ma | mb;
        const std::complex<T> v0 = psi[i00], v1 = psi[i01];
        const std::complex<T> v2 = psi[i10], v3 = psi[i11];
        psi[i00] = row4(U, 0, v0, v1, v2, v3);
        psi[i01] = row4(U, 1, v0, v1, v2, v3);
        psi[i10] = row4(U, 2, v0, v1, v2, v3);
        psi[i11] = row4(U, 3, v0, v1, v2, v3);
    }
}

// Diagonal gate fast path: multiply each amplitude by d[pattern].
template <typename T>
void apply_diag(std::complex<T>* psi, u64 n_amps, const int* qubits, int m,
                const std::complex<double>* d) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (long long i = 0; i < (long long)n_amps; ++i) {
        int pat = 0;
        for (int j = 0; j < m; ++j) {
            pat |= (int)((u64(i) >> qubits[j]) & 1) << (m - 1 - j);
        }
        const std::complex<double>& u = d[pat];
        const double ar = psi[i].real(), ai = psi[i].imag();
        psi[i] = std::complex<T>(static_cast<T>(u.real() * ar - u.imag() * ai),
                                 static_cast<T>(u.real() * ai + u.imag() * ar));
    }
}

// Marginal probability P(bit q == 1): one parallel strided reduction.
// Measurement parity with the reference's state_vector measure path
// (hisvsim_repo/state_vector.hpp:829-897).
template <typename T>
double prob_qubit(const std::complex<T>* psi, u64 n_amps, int q) {
    const u64 step = u64(1) << q;
    const u64 block = step << 1;
    const u64 n_blocks = n_amps / block;
    double acc = 0.0;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) reduction(+ : acc)
#endif
    for (long long bi = 0; bi < (long long)n_blocks; ++bi) {
        const u64 base = u64(bi) * block + step;
        for (u64 off = 0; off < step; ++off) {
            const std::complex<T>& v = psi[base + off];
            acc += (double)v.real() * v.real() + (double)v.imag() * v.imag();
        }
    }
    return acc;
}

// Collapse onto bit q == outcome and rescale by `scale` (caller passes
// 1/sqrt(p_outcome)); zeroes the discarded half in the same pass.
template <typename T>
void project_qubit(std::complex<T>* psi, u64 n_amps, int q, int outcome,
                   double scale) {
    const u64 step = u64(1) << q;
    const u64 block = step << 1;
    const u64 n_blocks = n_amps / block;
    const T s = static_cast<T>(scale);
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (long long bi = 0; bi < (long long)n_blocks; ++bi) {
        const u64 keep_base = u64(bi) * block + (outcome ? step : 0);
        const u64 kill_base = u64(bi) * block + (outcome ? 0 : step);
        for (u64 off = 0; off < step; ++off) {
            psi[keep_base + off] *= s;
            psi[kill_base + off] = std::complex<T>(0, 0);
        }
    }
}

// Deterministic 64-bit RNG (splitmix64): seeded measurement must give
// the same outcome bits on every platform/thread count, since the
// per-qubit probability reductions are the only parallel part.
inline u64 splitmix64(u64& s) {
    u64 z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
}

// Sequential multi-qubit measurement with collapse: for each qubit in
// order, reduce P(bit==1), draw u ~ U[0,1) from the seeded stream,
// project + rescale in place.  Returns the outcome bits packed with
// outcome of qubits[j] at bit j.  Parity with the reference's
// measure-with-RNG path (hisvsim_repo/state_vector.hpp:829-1003),
// which draws per-qubit uniforms and collapses the same way.
template <typename T>
u64 measure(std::complex<T>* psi, u64 n_amps, const int* qubits, int m,
            u64 seed) {
    u64 s = seed;
    u64 out = 0;
    for (int j = 0; j < m; ++j) {
        const int q = qubits[j];
        const double p1 = prob_qubit(psi, n_amps, q);
        const double u = (double)(splitmix64(s) >> 11) * 0x1.0p-53;
        const int outcome = (u < p1) ? 1 : 0;
        const double p = outcome ? p1 : 1.0 - p1;
        const double scale = p > 0.0 ? 1.0 / std::sqrt(p) : 0.0;
        project_qubit(psi, n_amps, q, outcome, scale);
        out |= (u64)outcome << j;
    }
    return out;
}

// Max elementwise |a - b| — the state-comparison primitive
// (reference: state_equal, hisvsim_repo/state_vector.hpp:1003).
template <typename T>
double state_max_diff(const std::complex<T>* a, const std::complex<T>* b,
                      u64 n_amps) {
    double mx = 0.0;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) reduction(max : mx)
#endif
    for (long long i = 0; i < (long long)n_amps; ++i) {
        const double dr = (double)a[i].real() - (double)b[i].real();
        const double di = (double)a[i].imag() - (double)b[i].imag();
        const double d = std::sqrt(dr * dr + di * di);
        if (d > mx) mx = d;
    }
    return mx;
}

template <typename T>
double norm2(const std::complex<T>* psi, u64 n_amps) {
    double acc = 0.0;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) reduction(+ : acc)
#endif
    for (long long i = 0; i < (long long)n_amps; ++i) {
        acc += (double)psi[i].real() * psi[i].real()
             + (double)psi[i].imag() * psi[i].imag();
    }
    return acc;
}

}  // namespace

extern "C" {

void qst_set_threads(int n) {
#if defined(_OPENMP)
    omp_set_num_threads(n);
#else
    (void)n;
#endif
}

int qst_num_threads() {
#if defined(_OPENMP)
    return omp_get_max_threads();
#else
    return 1;
#endif
}

void qst_apply_1q_c64(void* psi, u64 n, int q, const void* U) {
    apply_1q(reinterpret_cast<std::complex<float>*>(psi), n, q,
             reinterpret_cast<const std::complex<double>*>(U));
}
void qst_apply_1q_c128(void* psi, u64 n, int q, const void* U) {
    apply_1q(reinterpret_cast<std::complex<double>*>(psi), n, q,
             reinterpret_cast<const std::complex<double>*>(U));
}
void qst_apply_2q_c64(void* psi, u64 n, int qa, int qb, const void* U) {
    apply_2q(reinterpret_cast<std::complex<float>*>(psi), n, qa, qb,
             reinterpret_cast<const std::complex<double>*>(U));
}
void qst_apply_2q_c128(void* psi, u64 n, int qa, int qb, const void* U) {
    apply_2q(reinterpret_cast<std::complex<double>*>(psi), n, qa, qb,
             reinterpret_cast<const std::complex<double>*>(U));
}
void qst_apply_diag_c64(void* psi, u64 n, const int* qubits, int m, const void* d) {
    apply_diag(reinterpret_cast<std::complex<float>*>(psi), n, qubits, m,
               reinterpret_cast<const std::complex<double>*>(d));
}
void qst_apply_diag_c128(void* psi, u64 n, const int* qubits, int m, const void* d) {
    apply_diag(reinterpret_cast<std::complex<double>*>(psi), n, qubits, m,
               reinterpret_cast<const std::complex<double>*>(d));
}
double qst_prob_qubit_c64(const void* psi, u64 n, int q) {
    return prob_qubit(reinterpret_cast<const std::complex<float>*>(psi), n, q);
}
double qst_prob_qubit_c128(const void* psi, u64 n, int q) {
    return prob_qubit(reinterpret_cast<const std::complex<double>*>(psi), n, q);
}
void qst_project_qubit_c64(void* psi, u64 n, int q, int outcome, double scale) {
    project_qubit(reinterpret_cast<std::complex<float>*>(psi), n, q, outcome,
                  scale);
}
void qst_project_qubit_c128(void* psi, u64 n, int q, int outcome, double scale) {
    project_qubit(reinterpret_cast<std::complex<double>*>(psi), n, q, outcome,
                  scale);
}
double qst_norm2_c64(const void* psi, u64 n) {
    return norm2(reinterpret_cast<const std::complex<float>*>(psi), n);
}
double qst_norm2_c128(const void* psi, u64 n) {
    return norm2(reinterpret_cast<const std::complex<double>*>(psi), n);
}
u64 qst_measure_c64(void* psi, u64 n, const int* qubits, int m, u64 seed) {
    return measure(reinterpret_cast<std::complex<float>*>(psi), n, qubits, m,
                   seed);
}
u64 qst_measure_c128(void* psi, u64 n, const int* qubits, int m, u64 seed) {
    return measure(reinterpret_cast<std::complex<double>*>(psi), n, qubits, m,
                   seed);
}
double qst_state_max_diff_c64(const void* a, const void* b, u64 n) {
    return state_max_diff(reinterpret_cast<const std::complex<float>*>(a),
                          reinterpret_cast<const std::complex<float>*>(b), n);
}
double qst_state_max_diff_c128(const void* a, const void* b, u64 n) {
    return state_max_diff(reinterpret_cast<const std::complex<double>*>(a),
                          reinterpret_cast<const std::complex<double>*>(b), n);
}

// NUMA-aware state allocation.  The reference interleaves its state
// buffer across sockets with numa_alloc_interleaved
// (hisvsim_repo/state_vector.hpp:104); the portable equivalent is
// anonymous mmap + page-strided first-touch from ALL OpenMP threads in
// the same schedule(static) order the gate loops use: under Linux's
// default first-touch policy each page lands on the touching thread's
// node, so the strided pair loops read mostly node-local memory on
// multi-socket hosts.  Falls back to plain mmap touch (single thread)
// without OpenMP, and to malloc off Linux.
void* qst_alloc_state(u64 bytes) {
    if (bytes == 0) return nullptr;
#if defined(__linux__)
    void* p = mmap(nullptr, bytes, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED) return nullptr;
    const u64 page = 4096;
    const u64 n_pages = (bytes + page - 1) / page;
    volatile char* c = reinterpret_cast<volatile char*>(p);
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (long long i = 0; i < (long long)n_pages; ++i) {
        c[u64(i) * page] = 0;  // materialize page on the touching node
    }
    return p;
#else
    return std::calloc(bytes, 1);
#endif
}

void qst_free_state(void* p, u64 bytes) {
    if (p == nullptr) return;
#if defined(__linux__)
    munmap(p, bytes);
#else
    (void)bytes;
    std::free(p);
#endif
}

}  // extern "C"
