// The hash the open-addressing kernels share: splitmix64 and the double-hash
// chain it defines.  hash_insert.cu lays chains down with it and
// hash_probe.cu walks them, so both include this one definition (the host
// side's is trino_tpu_torch/ops/hashing.py, bit-identical).  Row key k walks
// idx_p = (h0 + p * step) & (C - 1), h0 = splitmix64(k), step =
// splitmix64(h0) | 1 (odd, so a power-of-two table is covered).
//
// ops/cuda_kernels.py keys each built library by its source and every header
// it includes, so an edit here rebuilds both.

#pragma once

#include <stdint.h>

namespace trino {

constexpr unsigned long long kEmptyKey = 0x7FFFFFFFFFFFFFFFull;

__device__ __forceinline__ unsigned long long splitmix64(unsigned long long x) {
    x += 0x9E3779B97F4A7C15ull;
    x ^= x >> 30;
    x *= 0xBF58476D1CE4E5B9ull;
    x ^= x >> 27;
    x *= 0x94D049BB133111EBull;
    return x ^ (x >> 31);
}

// the first slot and the odd step of key's chain
__device__ __forceinline__ void probe_chain(unsigned long long key, unsigned long long& h0,
                                            unsigned long long& step) {
    h0 = splitmix64(key);
    step = splitmix64(h0) | 1ull;
}

}  // namespace trino
