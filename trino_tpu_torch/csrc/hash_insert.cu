// Open-addressing hash insert with double hashing, in place, one thread per
// row, runs of equal keys in a warp deduplicated before they walk.
//
// Replaces: trino_tpu/ops/pallas_kernels.py hash_insert (the TPU claim loop
// that carries the whole table through VMEM and gathers by one-hot compares).
//
// Contract (hashagg._probe_insert): table is [C+1] int64, C a power of two,
// word C a sink that is never written; EMPTY = int64 max.  Row i probes
// idx_p = (h0 + p * step) & (C-1), h0 = splitmix64(key), step =
// splitmix64(h0) | 1, for p < max_probes (csrc/hashing.cuh, which
// hash_probe.cu shares, so the probe walks the chains laid down here).  A
// slot holding the key places the row there; an EMPTY slot is claimed with a
// 64-bit atomicCAS, and the row is placed when the old word was EMPTY or
// already its own key.  Rows with
// valid = 0 get slot = C and placed = 1; rows that exhaust max_probes get
// slot = C and placed = 0.  The kernel writes the caller's table: the
// wrapper's functional form hands it a copy.
//
// What bounds it on an H100: memory latency, not bandwidth or arithmetic.
// Each probe round is one dependent 8-byte load (plus at most one CAS) at a
// random address; the row's keys and outputs stream coalesced.  Tables up to
// ~6M slots (48 MB) stay resident in the 50 MB L2, so the random traffic is
// L2 latency.  The design keeps as many independent rows in flight as the
// card holds (one thread per row, no shared memory, few registers), so the
// scheduler hides each thread's chain of dependent loads behind other warps.
// Rows with equal keys arrive together on the main path (the lineitem rows
// of one order are adjacent, and l_orderkey leads the hash group-bys), so a
// warp's valid lanes form runs of equal keys (each lane compares its key with
// the previous valid lane's, by one ballot and one shuffle): only the first
// lane of each run walks the chain and claims, and the rest of the run takes
// its slot and placed flag by shuffle.  That removes repeated walks of one
// chain and the same-address CAS storms between them.  __match_any_sync
// would also group equal keys that are not adjacent, but it cost 50 % more
// kernel time on uniform keys on an H100 (PERF.md); runs cost uniform
// keys almost nothing.
// Slots only ever go from EMPTY to a key inside a launch, so a stale read of
// EMPTY is harmless: the CAS returns the word that is really there.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hashing.cuh"

namespace {

constexpr unsigned long long kEmpty = trino::kEmptyKey;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hash_insert_kernel(unsigned long long* __restrict__ table,
                   const unsigned long long* __restrict__ packed,
                   const unsigned char* __restrict__ valid, long long n,
                   unsigned long long mask, long long capacity, int max_probes,
                   int* __restrict__ slot, unsigned char* __restrict__ placed) {
    // every lane of the warp takes part in the warp operations: no early exit
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const bool in = i < n;
    const bool live = in && valid[i];
    const unsigned long long key = live ? packed[i] : kEmpty;
    // runs of equal keys among the warp's valid lanes; each run's first
    // lane is its leader
    const unsigned lives = __ballot_sync(kFull, live);
    const unsigned before = lives & ((1u << lane) - 1u);
    const unsigned long long prev = __shfl_sync(kFull, key, before ? 31 - __clz(before) : lane);
    const unsigned starts = __ballot_sync(kFull, live && (before == 0 || prev != key));
    const int leader = live ? 31 - __clz(starts & (kFull >> (31 - lane))) : lane;

    int s = (int)capacity;
    int ok = live ? 0 : 1;
    if (live && leader == lane) {
        unsigned long long h0, step;
        trino::probe_chain(key, h0, step);
        for (int p = 0; p < max_probes; ++p) {
            const unsigned long long idx = (h0 + (unsigned long long)p * step) & mask;
            unsigned long long cur = __ldcg(table + idx);
            if (cur == kEmpty) {
                cur = atomicCAS(table + idx, kEmpty, key);
                if (cur == kEmpty) cur = key;  // this thread claimed the slot
            }
            if (cur == key) {
                s = (int)idx;
                ok = 1;
                break;
            }
        }
    }
    s = __shfl_sync(kFull, s, leader);
    ok = __shfl_sync(kFull, ok, leader);
    if (in) {
        slot[i] = s;
        placed[i] = (unsigned char)ok;
    }
}

}  // namespace

extern "C" int trino_hash_insert(void* table, const void* packed, const void* valid,
                                 long long n, long long capacity, int max_probes,
                                 void* slot, void* placed, void* stream) {
    if (n > 0) {
        const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
        hash_insert_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            (unsigned long long*)table, (const unsigned long long*)packed,
            (const unsigned char*)valid, n, (unsigned long long)(capacity - 1), capacity,
            max_probes, (int*)slot, (unsigned char*)placed);
    }
    return (int)cudaGetLastError();
}
