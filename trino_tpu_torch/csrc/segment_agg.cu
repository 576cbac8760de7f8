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
// one-hot row with no hot lane).  k = 0 computes counts only.  Any n, and
// inputs at any 4-byte offset (a column may be a slice).
//
// What bounds it on an H100: memory bandwidth.  Each row is read once
// (4 + 1 + 4k bytes) and the outputs are n_slots * (k + 1) words; the adds
// are a few per byte.  A one-hot product on the tensor cores would run in
// TF32 and break the float32 contract, so the design is plain float32 adds,
// and it keeps them off shared-memory atomics, which serialise when a
// block's 256 threads add into Q1's 8 slots:
//   (a) registers, when S * (k + 1) <= 64 accumulators, S = n_slots rounded
//       up to a power of two >= 8 (Q1's 8 slots x 5): each thread keeps its
//       counts and sums in registers and adds every row by an unrolled
//       compare-and-select over the S slots (the TPU kernel's one-hot
//       product, as selects and adds), templated on S and k so nothing
//       spills.  At the end: a warp-shuffle reduction, one shared atomic per
//       warp per entry, one global atomic per block per entry;
//   (b) otherwise (up to 128 slots; more than 32 columns run as several
//       launches over column chunks, the first also counting): shared-memory
//       atomics into per-warp copies of the block's partial sums (as many
//       copies as fit in 48 KB), merged once per block into one global
//       atomic per entry, so only lanes of one warp collide.
// Both tiers read four rows a thread with 16-byte loads (int4 slots, uchar4
// mask, float4 per column), streamed with evict-first hints; rows before the
// first aligned group and after the last run scalar, and inputs whose
// offsets disagree run scalar throughout.  The grid is sized by occupancy to
// fill the card.  The wrapper hands one buffer (counts, then sums) that the
// C entry zeroes with one memset.  Float32 atomics add in a run-dependent
// order, so sums agree with a float64 reference within float32 rounding,
// not bit for bit; counts are exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 128;
constexpr int kMaxCols = 32;
constexpr int kRegAccumulators = 64;   // tier (a): S * (k + 1) <= this
constexpr int kMinRegSlots = 8;        // tier (a)'s smallest S
constexpr int kSmemBudget = 48 * 1024;  // tier (b)'s per-warp copies, per block
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Args {
    const int* slot;
    const unsigned char* valid;
    const float* col[kMaxCols];
    long long n;
    int k;          // value columns of this launch
    int n_slots;
    int head;       // rows before the first aligned group of four, -1: all scalar
    int do_counts;  // tier (b): the first column chunk counts
    int* counts;    // [n_slots]
    float* sums;    // [k, n_slots], this launch's columns
};

__device__ __forceinline__ float lane_of(const float4& f, int r) {
    return r == 0 ? f.x : r == 1 ? f.y : r == 2 ? f.z : f.w;
}

__device__ __forceinline__ int lane_of(const int4& f, int r) {
    return r == 0 ? f.x : r == 1 ? f.y : r == 2 ? f.z : f.w;
}

__device__ __forceinline__ unsigned char lane_of(const uchar4& f, int r) {
    return r == 0 ? f.x : r == 1 ? f.y : r == 2 ? f.z : f.w;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
    return x;
}

// rows [0, head) and [head + 4 * groups, n) of the vector path, or -1 / 0
struct Rows {
    long long head, groups, tail0;
};

__device__ __forceinline__ Rows split_rows(const Args& a) {
    Rows r;
    r.head = a.head < 0 ? 0 : (a.head < a.n ? a.head : a.n);
    r.groups = a.head < 0 ? 0 : (a.n - r.head) / 4;
    r.tail0 = r.head + 4 * r.groups;
    return r;
}

// ------------------------------------------------------------ tier (a)
template <int S, int K>
struct RegAcc {
    static constexpr int KK = K > 0 ? K : 1;
    int cnt[S];
    float sum[S][KK];

    __device__ __forceinline__ void zero() {
#pragma unroll
        for (int t = 0; t < S; ++t) {
            cnt[t] = 0;
#pragma unroll
            for (int j = 0; j < KK; ++j) sum[t][j] = 0.0f;
        }
    }

    // s: the row's slot, or -1 for a dead row; v: its K values
    __device__ __forceinline__ void add(int s, const float (&v)[KK]) {
#pragma unroll
        for (int t = 0; t < S; ++t) {
            const bool m = s == t;
            cnt[t] += m;
#pragma unroll
            for (int j = 0; j < K; ++j) sum[t][j] += m ? v[j] : 0.0f;
        }
    }
};

template <int S, int K>
__global__ void __launch_bounds__(kThreads) segment_agg_regs(const Args a) {
    using Acc = RegAcc<S, K>;
    constexpr int KK = Acc::KK;
    __shared__ int scnt[S];
    __shared__ float ssum[S * KK];
    for (int e = threadIdx.x; e < S; e += kThreads) scnt[e] = 0;
    for (int e = threadIdx.x; e < S * KK; e += kThreads) ssum[e] = 0.0f;

    Acc acc;
    acc.zero();
    const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long nthreads = (long long)gridDim.x * kThreads;
    auto row = [&](long long i) {
        float v[KK];
#pragma unroll
        for (int j = 0; j < K; ++j) v[j] = __ldcs(a.col[j] + i);
        acc.add(__ldcs(a.valid + i) ? __ldcs(a.slot + i) : -1, v);
    };
    const Rows rows = split_rows(a);
    if (a.head < 0) {
        for (long long i = gid; i < a.n; i += nthreads) row(i);
    } else {
        if (gid < rows.head) row(gid);
        if (gid < a.n - rows.tail0) row(rows.tail0 + gid);
        for (long long g = gid; g < rows.groups; g += nthreads) {
            const long long i = rows.head + 4 * g;
            const int4 s4 = __ldcs((const int4*)(a.slot + i));
            const uchar4 m4 = __ldcs((const uchar4*)(a.valid + i));
            float4 f[KK];
#pragma unroll
            for (int j = 0; j < K; ++j) f[j] = __ldcs((const float4*)(a.col[j] + i));
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                float v[KK];
#pragma unroll
                for (int j = 0; j < K; ++j) v[j] = lane_of(f[j], r);
                acc.add(lane_of(m4, r) ? lane_of(s4, r) : -1, v);
            }
        }
    }
    __syncthreads();  // the shared partials are zeroed

    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int t = 0; t < S; ++t) {
        if (t >= a.n_slots) break;  // uniform: every lane takes part in the shuffles
        const int c = __reduce_add_sync(kFull, acc.cnt[t]);
        if (lane == 0 && c != 0) atomicAdd(&scnt[t], c);
#pragma unroll
        for (int j = 0; j < K; ++j) {
            const float x = warp_sum(acc.sum[t][j]);
            if (lane == 0 && x != 0.0f) atomicAdd(&ssum[t * KK + j], x);
        }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < a.n_slots * (K + 1); e += kThreads) {
        if (e < a.n_slots) {
            if (scnt[e] != 0) atomicAdd(a.counts + e, scnt[e]);
        } else {
            const int j = (e - a.n_slots) / a.n_slots, t = (e - a.n_slots) % a.n_slots;
            const float x = ssum[t * KK + j];
            if (x != 0.0f) atomicAdd(a.sums + (long long)j * a.n_slots + t, x);
        }
    }
}

// ------------------------------------------------------------ tier (b)
__global__ void __launch_bounds__(kThreads) segment_agg_smem(const Args a, int copies) {
    // copies x [n_slots counts | k x n_slots sums]
    extern __shared__ int smem[];
    const int words = a.n_slots * (a.k + 1);
    for (int e = threadIdx.x; e < copies * words; e += kThreads) smem[e] = 0;
    __syncthreads();
    int* cnt = smem + (threadIdx.x / 32 % copies) * words;
    float* sum = (float*)(cnt + a.n_slots);
    const unsigned n_slots = (unsigned)a.n_slots;

    const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long nthreads = (long long)gridDim.x * kThreads;
    auto row = [&](long long i) {
        const int s = __ldcs(a.slot + i);
        if (!__ldcs(a.valid + i) || (unsigned)s >= n_slots) return;
        if (a.do_counts) atomicAdd(cnt + s, 1);
        for (int j = 0; j < a.k; ++j) atomicAdd(sum + j * a.n_slots + s, __ldcs(a.col[j] + i));
    };
    const Rows rows = split_rows(a);
    if (a.head < 0) {
        for (long long i = gid; i < a.n; i += nthreads) row(i);
    } else {
        if (gid < rows.head) row(gid);
        if (gid < a.n - rows.tail0) row(rows.tail0 + gid);
        for (long long g = gid; g < rows.groups; g += nthreads) {
            const long long i = rows.head + 4 * g;
            const int4 s4 = __ldcs((const int4*)(a.slot + i));
            const uchar4 m4 = __ldcs((const uchar4*)(a.valid + i));
            int s[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                s[r] = lane_of(s4, r);
                if (!lane_of(m4, r) || (unsigned)s[r] >= n_slots) s[r] = -1;
                if (a.do_counts && s[r] >= 0) atomicAdd(cnt + s[r], 1);
            }
#pragma unroll 4
            for (int j = 0; j < a.k; ++j) {
                const float4 f = __ldcs((const float4*)(a.col[j] + i));
                float* sj = sum + j * a.n_slots;
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    if (s[r] >= 0) atomicAdd(sj + s[r], lane_of(f, r));
            }
        }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < words; e += kThreads) {
        if (e < a.n_slots) {
            if (!a.do_counts) continue;
            int c = 0;
            for (int cp = 0; cp < copies; ++cp) c += smem[cp * words + e];
            if (c != 0) atomicAdd(a.counts + e, c);
        } else {
            float x = 0.0f;
            for (int cp = 0; cp < copies; ++cp) x += ((const float*)smem)[cp * words + e];
            if (x != 0.0f) atomicAdd(a.sums + (e - a.n_slots), x);
        }
    }
}

// ------------------------------------------------------------ launch
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

// blocks for `work` items (groups of four rows, or rows): at most what the
// card holds at once (per_sm blocks on every SM), at least one
unsigned grid(long long work, int per_sm) {
    const long long want = (work + kThreads - 1) / kThreads;
    const long long cap = (long long)(per_sm > 0 ? per_sm : 1) * sm_count();
    return (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
}

// the grid-stride items: groups of four rows (the head and tail rows go to
// the first threads of the grid, which has at least one block), or rows
long long work_of(const Args& a) {
    return a.head < 0 ? a.n : (a.n - (a.head < a.n ? a.head : a.n)) / 4;
}

template <int S, int K>
cudaError_t launch_regs(const Args& a, cudaStream_t stream) {
    static int per_sm = 0;
    if (per_sm == 0)
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segment_agg_regs<S, K>,
                                                      kThreads, 0);
    segment_agg_regs<S, K><<<grid(work_of(a), per_sm), kThreads, 0, stream>>>(a);
    return cudaGetLastError();
}

// the instantiation for this k: K runs down from the tier's largest
template <int S, int K>
cudaError_t dispatch_regs(const Args& a, cudaStream_t stream) {
    if (a.k == K) return launch_regs<S, K>(a, stream);
    if constexpr (K > 0) return dispatch_regs<S, K - 1>(a, stream);
    return cudaErrorInvalidValue;
}

cudaError_t launch_smem(const Args& a, cudaStream_t stream) {
    const int words = a.n_slots * (a.k + 1);
    int copies = kSmemBudget / (words * 4);
    copies = copies < 1 ? 1 : (copies > kWarps ? kWarps : copies);
    const size_t bytes = (size_t)copies * words * 4;
    // the occupancy query costs host time: keep the last answer (a stale or
    // torn one only sizes the grid-stride grid differently)
    static size_t last_bytes = 0;
    static int per_sm = 0;
    if (bytes != last_bytes || per_sm == 0) {
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segment_agg_smem, kThreads,
                                                      bytes);
        last_bytes = bytes;
    }
    segment_agg_smem<<<grid(work_of(a), per_sm), kThreads, bytes, stream>>>(a, copies);
    return cudaGetLastError();
}

// rows before the first row at which the slots and every column sit on a
// 16-byte boundary and the mask on a 4-byte one, or -1 if no row does
int vector_head(const void* slot, const void* valid, const void* const* cols, int k) {
    const uintptr_t s = (uintptr_t)slot;
    if (s % 4) return -1;
    const int head = (int)((16 - s % 16) % 16) / 4;
    for (int j = 0; j < k; ++j) {
        const uintptr_t c = (uintptr_t)cols[j];
        if (c % 4 || (int)((16 - c % 16) % 16) / 4 != head) return -1;
    }
    return ((uintptr_t)valid + head) % 4 ? -1 : head;
}

}  // namespace

// cols: host array of k device pointers to float32 [n] columns; out: one
// buffer of n_slots int32 counts followed by k x n_slots float32 sums, zeroed
// here.
extern "C" int trino_segment_agg(const void* slot, const void* valid, const void* const* cols,
                                 int k, long long n, int n_slots, void* out, void* stream) {
    if (n_slots < 1 || n_slots > kMaxSlots || k < 0) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n_slots * (k + 1) * 4, st);
    if (err != cudaSuccess || n == 0) return (int)err;
    Args a{};
    a.slot = (const int*)slot;
    a.valid = (const unsigned char*)valid;
    a.n = n;
    a.n_slots = n_slots;
    a.head = vector_head(slot, valid, cols, k);
    a.counts = (int*)out;
    int S = kMinRegSlots;
    while (S < n_slots) S *= 2;
    if (S * (k + 1) <= kRegAccumulators) {
        for (int j = 0; j < k; ++j) a.col[j] = (const float*)cols[j];
        a.k = k;
        a.do_counts = 1;
        a.sums = (float*)out + n_slots;
        switch (S) {
            case 8: return (int)dispatch_regs<8, kRegAccumulators / 8 - 1>(a, st);
            case 16: return (int)dispatch_regs<16, kRegAccumulators / 16 - 1>(a, st);
            case 32: return (int)dispatch_regs<32, kRegAccumulators / 32 - 1>(a, st);
            default: return (int)dispatch_regs<64, 0>(a, st);
        }
    }
    int first = 0;
    do {
        const int chunk = (k - first) < kMaxCols ? (k - first) : kMaxCols;
        for (int j = 0; j < chunk; ++j) a.col[j] = (const float*)cols[first + j];
        a.k = chunk;
        a.do_counts = first == 0;
        a.head = vector_head(slot, valid, cols + first, chunk);
        a.sums = (float*)out + n_slots + (long long)first * n_slots;
        err = launch_smem(a, st);
        if (err != cudaSuccess) return (int)err;
        first += chunk;
    } while (first < k);
    return (int)cudaGetLastError();
}
