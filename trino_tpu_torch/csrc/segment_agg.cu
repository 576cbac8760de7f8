// Fused segment aggregation: per slot, the count of live rows and the float32
// sum of each value column, in one pass over the rows.
//
// Replaces: trino_tpu/ops/pallas_kernels.py fused_segment_agg (the TPU form
// builds a [block, n_slots] one-hot per row block and multiplies it with the
// [block, k] values on the MXU, carrying the sums across the sequential grid
// in VMEM).
//
// Contract (the reference's): slot [n] int32, valid [n] bool, k value columns
// [n] float32, n_slots <= 128.  counts[s] = number of valid rows with
// slot == s (int32, exact); sums[j][s] = float32 sum of column j over those
// rows.  Rows whose slot lies outside [0, n_slots) contribute nothing (a
// one-hot row with no hot lane).  k = 0 computes counts only.  Any n.
//
// What bounds it on an H100: memory bandwidth.  Each row is read once
// (4 + 1 + 4k bytes) and the outputs are n_slots * (k + 1) words; the adds
// are a few per byte.  A one-hot product on the tensor cores would run in
// TF32 and break the float32 contract, so the design is plain adds:
//   - a grid of at most two blocks per SM walks the rows grid-stride, each
//     thread adding its live rows into the block's [n_slots, k] float32 sums
//     and [n_slots] int32 counts in shared memory (shared-memory atomics);
//   - at the end each block adds its partials to the zero-filled outputs in
//     device memory with one global atomic per nonzero slot and column.
// With few slots (Q1's group-by has 8) the shared atomics of a warp collide
// on the same words and serialise: that, not memory, is the first thing a
// later version should remove (per-warp copies, or warp-level reduction by
// slot).  Float32 atomics add in a run-dependent order, so sums agree with a
// float64 reference within float32 rounding, not bit for bit.  More than
// kMaxCols value columns run as several launches over column chunks; the
// first chunk also counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 128;
constexpr int kMaxCols = 32;

struct ValueColumns {
    const float* col[kMaxCols];
};

__global__ void segment_agg_kernel(const int* __restrict__ slot,
                                   const unsigned char* __restrict__ valid,
                                   ValueColumns vals, int k, long long n, int n_slots,
                                   int do_counts, int* __restrict__ counts,
                                   float* __restrict__ sums) {
    __shared__ int scount[kMaxSlots];
    __shared__ float ssum[kMaxSlots * kMaxCols];
    for (int i = threadIdx.x; i < n_slots * k; i += blockDim.x) ssum[i] = 0.0f;
    for (int i = threadIdx.x; i < n_slots; i += blockDim.x) scount[i] = 0;
    __syncthreads();

    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        if (!valid[i]) continue;
        const int s = __ldg(slot + i);
        if (s < 0 || s >= n_slots) continue;
        if (do_counts) atomicAdd(&scount[s], 1);
        for (int j = 0; j < k; ++j) atomicAdd(&ssum[s * k + j], __ldg(vals.col[j] + i));
    }
    __syncthreads();

    if (do_counts) {
        for (int s = threadIdx.x; s < n_slots; s += blockDim.x)
            if (scount[s] != 0) atomicAdd(&counts[s], scount[s]);
    }
    // sums is [k, n_slots] (one row per value column)
    for (int i = threadIdx.x; i < n_slots * k; i += blockDim.x) {
        const float v = ssum[i];
        if (v != 0.0f) atomicAdd(&sums[(long long)(i % k) * n_slots + i / k], v);
    }
}

int sm_count() {
    static int count = 0;
    if (count == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
        if (count <= 0) count = 1;
    }
    return count;
}

}  // namespace

// cols: host array of k device pointers to float32 [n] columns; counts [n_slots]
// int32 and sums [k, n_slots] float32 arrive zero-filled.
extern "C" int trino_segment_agg(const void* slot, const void* valid, const void* const* cols,
                                 int k, long long n, int n_slots, void* counts, void* sums,
                                 void* stream) {
    if (n_slots < 1 || n_slots > kMaxSlots || k < 0) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        long long want = (n + kThreads * 4 - 1) / (kThreads * 4);
        const long long cap = 2LL * sm_count();
        const unsigned blocks = (unsigned)(want < cap ? (want > 0 ? want : 1) : cap);
        int first = 0;
        do {
            const int chunk = (k - first) < kMaxCols ? (k - first) : kMaxCols;
            ValueColumns v{};
            for (int j = 0; j < chunk; ++j) v.col[j] = (const float*)cols[first + j];
            segment_agg_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
                (const int*)slot, (const unsigned char*)valid, v, chunk, n, n_slots,
                first == 0 ? 1 : 0, (int*)counts,
                (float*)sums + (long long)first * n_slots);
            const cudaError_t err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
            first += chunk;
        } while (first < k);
    }
    return (int)cudaGetLastError();
}
