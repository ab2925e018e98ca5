// Pointer types of the state planes for the out-of-place and the in-place
// instance of a kernel, shared by panels.cu, pair.cu, diag.cu and bitperm.cu.
//
// Out of place, every plane pointer is __restrict__: the compiler may keep
// loads in the read-only path and order them freely against the stores.
// In place (the capacity tier, the counterpart of the TPU kernels'
// input_output_aliases), the kernel gets out == in, and passing one buffer
// through two __restrict__ pointers is undefined behaviour: the compiler
// could move a store ahead of a load of the same address.  So the ALIAS
// instance drops __restrict__ on the aliased pairs, and each kernel says in
// a comment why its body is hazard-free when they alias: every load of a
// block's (or a thread's) footprint completes before the first store to it,
// and no two blocks (threads) share a footprint.
#pragma once

namespace qst {

template <typename T, bool ALIAS>
struct Io {
  typedef const T* __restrict__ In;
  typedef T* __restrict__ Out;
};

template <typename T>
struct Io<T, true> {
  typedef const T* In;
  typedef T* Out;
};

// 1: in place (out == in for both planes); 0: out of place; -1: planes
// that alias otherwise (one pair only, or re onto im), which no kernel
// takes.
inline int alias_mode(const void* re, const void* im, const void* ore,
                      const void* oim) {
  if (ore == re && oim == im) return 1;
  if (ore == re || ore == im || oim == re || oim == im) return -1;
  return 0;
}

}  // namespace qst
