// Open-addressing hash probe, one thread per row, hashing in registers and
// walking the chain with gathers.
//
// Replaces: trino_tpu/ops/pallas_kernels.py hash_probe (the TPU's gather-free
// all-pairs form, which compares every row with every slot because Mosaic
// cannot gather; here a row reads only its own chain).
//
// Contract (bit-identical to the XLA loop of hashjoin.probe): table is the
// [C] slice of a build table; row i walks idx_p = (h0 + p * step) & (C-1)
// for p < max_probes, with h0 and step computed here from the row's key by
// csrc/hashing.cuh (the chains hash_insert.cu lays down), and stops at the
// first slot holding its key (returns the payload at idx, matched = 1) or
// the first EMPTY slot (returns 0, matched = 0).  Invalid rows return 0,
// matched = 0 and read no key.  The payload is vals[idx] ([C] int32), or,
// with vals == nullptr, idx itself (the multi-match layout's probe_slots).
//
// What bounds it on an H100: memory latency, and what the rows cost the L2.
// Each round is one dependent 8-byte load at a random slot (plus one 4-byte
// payload load on a hit); a row's key, mask and outputs stream coalesced.  A
// join table of a few million slots (32 MB at C = 4M) fits the 50 MB L2
// beside its payload, so rounds cost L2 latency as long as the streaming
// traffic does not evict the table.  The design:
//   - hashing in registers: the caller once computed h0 and step in ~25
//     eager int64 launches and the kernel read 16 more bytes a row; the
//     splitmix64 pair is ~20 integer instructions a row here;
//   - the per-row inputs are loaded, and the outputs stored, with
//     evict-first hints (__ldcs / __stcs), so they pass through the L2
//     without displacing table lines that other chains re-read; table and
//     payload words use the default policy through the read-only path;
//   - an invalid row loads only its mask byte;
//   - one thread per row, no shared memory and few registers keep the most
//     chains in flight; chains are short (tables are built at load <= 1/4),
//     so most rows finish in one or two rounds;
//   - slot mode reads no payload array, so probe_slots needs no C-long iota.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hashing.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kSlotPayload>
__global__ void __launch_bounds__(kThreads)
hash_probe_kernel(const unsigned long long* __restrict__ table, const int* __restrict__ vals,
                  const unsigned long long* __restrict__ packed,
                  const unsigned char* __restrict__ valid, long long n,
                  unsigned long long mask, int max_probes, int* __restrict__ out_val,
                  unsigned char* __restrict__ matched) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    int val = 0;
    unsigned char hit = 0;
    if (__ldcs(valid + i)) {
        const unsigned long long key = __ldcs(packed + i);
        unsigned long long h0, step;
        trino::probe_chain(key, h0, step);
        for (int p = 0; p < max_probes; ++p) {
            const unsigned long long idx = (h0 + (unsigned long long)p * step) & mask;
            const unsigned long long cur = __ldg(table + idx);
            if (cur == key) {
                val = kSlotPayload ? (int)idx : __ldg(vals + idx);
                hit = 1;
                break;
            }
            if (cur == trino::kEmptyKey) break;
        }
    }
    __stcs(out_val + i, val);
    __stcs(matched + i, hit);
}

}  // namespace

// out_val: [n] int32 payloads; matched: [n] bytes.
extern "C" int trino_hash_probe(const void* table, const void* vals, const void* packed,
                                const void* valid, long long n, long long capacity,
                                int max_probes, void* out_val, void* matched, void* stream) {
    if (n > 0) {
        const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
        const auto* t = (const unsigned long long*)table;
        const auto* k = (const unsigned long long*)packed;
        const auto* v = (const unsigned char*)valid;
        const unsigned long long mask = (unsigned long long)(capacity - 1);
        auto* o = (int*)out_val;
        auto* m = (unsigned char*)matched;
        if (vals == nullptr)
            hash_probe_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
                t, nullptr, k, v, n, mask, max_probes, o, m);
        else
            hash_probe_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
                t, (const int*)vals, k, v, n, mask, max_probes, o, m);
    }
    return (int)cudaGetLastError();
}
