// Order-preserving compaction: the live rows of n-row columns move to the
// front of out_len-row outputs.
//
// Replaces: trino_tpu/ops/pallas_kernels.py compact_rows_matrix and its
// wrapper compact_columns (the TPU form that moves every column as 16-bit
// limbs through one-hot matrix products on the MXU).
//
// Contract (arrays.compact_rows, byte-identical to the XLA cumsum-scatter):
// live row r goes to position (number of live rows before r); positions at or
// past out_len are dropped; the tail [total, out_len) is zero; total = number
// of live rows, including dropped ones.  Each column moves in its own width
// (1, 2, 4 or 8 bytes).  The outputs arrive uninitialised.
//
// What bounds it on an H100: memory bandwidth.  The least it can move is the
// mask once, the sectors of the kept rows, and each output once.  The design
// moves about that in one launch (per 16 columns) after one memset of a
// small scratch; no output is filled twice and the host never reads total.
// compact_kernel is a single-pass scan with decoupled look-back (Merrill and
// Garland):
//   - each block takes the next tile of 4096 rows from an atomic counter (so
//     it never waits on a tile no running block holds), reads its 4096 mask
//     bytes once as one 16-byte load per thread, and ranks the rows with
//     popcounts and a shuffle scan;
//   - it publishes its tile aggregate, then its inclusive prefix, as one
//     64-bit status word (2-bit flag + 62-bit count), and finds its own
//     prefix by reading up to 32 predecessors' words per step with one warp;
//   - it scatters every column (up to 16 per launch) itself, row-striped so
//     each load is coalesced, only live kept rows loaded, 16 loads in flight
//     per thread, and each warp's live rows landing as one run; a later
//     launch for columns 17+ reads the prefixes the first one stored;
//   - when no tile is left, every block waits for the last tile's prefix
//     (the total) and zeroes its share of [total, out_len), 16 bytes a
//     store.  The grid is at most what the card holds at once, so the
//     blocks spread over the whole card for the tail as for the tiles.
// The scratch (tile status words, the tile counter, total) is one int64
// tensor of ceil(n / 4096) + 2 words, cleared by one cudaMemsetAsync.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;  // rows per thread: one 16-byte mask load
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 16;
constexpr unsigned kFull = 0xFFFFFFFFu;

// tile status word: flag in the top two bits, live count below
constexpr unsigned long long kFlagAggregate = 1ull << 62;
constexpr unsigned long long kFlagPrefix = 2ull << 62;
constexpr unsigned long long kCountMask = (1ull << 62) - 1;

struct Columns {
    const void* src[kMaxCols];
    void* dst[kMaxCols];
    int width[kMaxCols];
    int count;
};

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
    return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
    *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// 16 mask bits of rows [row, row + 16): one 16-byte load where the tile is
// whole and the address aligned, byte loads at the ragged end.
__device__ __forceinline__ unsigned mask_bits(const unsigned char* __restrict__ valid,
                                              long long row, long long n) {
    unsigned bits = 0;
    if (row + kItems <= n && (reinterpret_cast<uintptr_t>(valid + row) & 15) == 0) {
        const uint4 v = *reinterpret_cast<const uint4*>(valid + row);
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const unsigned nz = __vcmpne4(w[j], 0u);  // 0xff in each nonzero byte
            bits |= ((nz & 1u) | ((nz >> 7) & 2u) | ((nz >> 14) & 4u) | ((nz >> 21) & 8u))
                    << (4 * j);
        }
    } else {
        for (int j = 0; j < kItems; ++j)
            if (row + j < n && valid[row + j]) bits |= 1u << j;
    }
    return bits;
}

// Striped scatter of one column: step j moves row row0 + 256 j + tid to
// base + local[j] (local[j] < 0: not moved).  All 16 loads are issued before
// the stores, so each thread keeps 16 independent loads in flight.
template <typename T>
__device__ __forceinline__ void scatter_column(const void* src_, void* dst_, long long row0,
                                               long long base, const int (&local)[kItems]) {
    const T* __restrict__ src = static_cast<const T*>(src_) + row0 + threadIdx.x;
    T* __restrict__ dst = static_cast<T*>(dst_) + base;
    T v[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j)
        if (local[j] >= 0) v[j] = src[j * kThreads];
#pragma unroll
    for (int j = 0; j < kItems; ++j)
        if (local[j] >= 0) dst[local[j]] = v[j];
}

// Zero bytes [lo, hi) of buf: single bytes up to the first 16-byte boundary
// and after the last, 16-byte stores between.
__device__ __forceinline__ void zero_bytes(unsigned char* buf, long long lo, long long hi,
                                           long long t, long long stride) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(buf);
    long long mlo = (long long)(((a + lo + 15) & ~(uintptr_t)15) - a);
    long long mhi = (long long)(((a + hi) & ~(uintptr_t)15) - a);
    if (mhi <= mlo) mlo = mhi = hi;  // no whole 16-byte word inside
    for (long long b = lo + t; b < mlo; b += stride) buf[b] = 0;
    uint4* mid = reinterpret_cast<uint4*>(buf + mlo);
    const long long words = (mhi - mlo) / 16;
    for (long long q = t; q < words; q += stride) mid[q] = make_uint4(0u, 0u, 0u, 0u);
    for (long long b = mhi + t; b < hi; b += stride) buf[b] = 0;
}

// One launch per chunk of up to 16 columns.  Each block loops over tiles:
// chunk 0 takes them from the counter, scans (look-back) and writes total
// from the last tile; a later chunk walks them by blockIdx and reads the
// prefixes chunk 0 stored.  Then every block waits for the last tile's
// prefix (the total) and zeroes its share of the tail.  The wait never
// deadlocks, whatever the grid: a block only ever waits on tiles that
// running blocks hold, and a block not yet scheduled holds none.
__global__ void __launch_bounds__(kThreads)
compact_kernel(const unsigned char* __restrict__ valid, long long n, long long out_len,
               Columns cols, unsigned long long* status, unsigned long long* counter,
               long long* total, long long ntiles, int chunk) {
    __shared__ unsigned short s_bits[kThreads];
    __shared__ int s_excl[kThreads];
    __shared__ int s_warp[kWarps];
    __shared__ long long s_tile, s_base;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    for (long long step = 0;; ++step) {
        if (tid == 0)
            s_tile = chunk == 0 ? (long long)atomicAdd(counter, 1ull)
                                : (long long)blockIdx.x + step * gridDim.x;
        __syncthreads();
        const long long tile = s_tile;
        if (tile >= ntiles) break;
        const long long row0 = tile * kTile;

        // rank: blocked layout, thread tid owns rows [row0 + 16 tid, +16)
        const unsigned bits = mask_bits(valid, row0 + (long long)tid * kItems, n);
        const int cnt = __popc(bits);
        int incl = cnt;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(kFull, incl, d);
            if (lane >= d) incl += y;
        }
        if (lane == 31) s_warp[warp] = incl;
        __syncthreads();
        if (warp == 0) {
            const int w = lane < kWarps ? s_warp[lane] : 0;
            int wi = w;
#pragma unroll
            for (int d = 1; d < kWarps; d <<= 1) {
                const int y = __shfl_up_sync(kFull, wi, d);
                if (lane >= d) wi += y;
            }
            if (lane < kWarps) s_warp[lane] = wi - w;  // exclusive over warps
            const int agg = __shfl_sync(kFull, wi, kWarps - 1);  // the tile's live count

            long long base = 0;
            if (chunk != 0) {
                base = (long long)(load_status(status + tile) & kCountMask) - agg;
            } else if (tile == 0) {
                if (lane == 0) store_status(status, kFlagPrefix | (unsigned long long)agg);
            } else {
                if (lane == 0)
                    store_status(status + tile, kFlagAggregate | (unsigned long long)agg);
                // decoupled look-back: lane l reads tile (look - l); sum back to
                // the nearest published inclusive prefix
                long long look = tile - 1;
                while (true) {
                    const long long idx = look - lane;
                    const unsigned long long s =
                        idx >= 0 ? load_status(status + idx) : kFlagPrefix;
                    if (__any_sync(kFull, (s >> 62) == 0)) continue;  // not yet out
                    const unsigned pmask = __ballot_sync(kFull, (s >> 62) == 2);
                    const int stop = pmask ? __ffs(pmask) - 1 : 31;
                    long long v = lane <= stop ? (long long)(s & kCountMask) : 0;
#pragma unroll
                    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
                    base += v;
                    if (pmask) break;
                    look -= 32;
                }
                if (lane == 0)
                    store_status(status + tile, kFlagPrefix | (unsigned long long)(base + agg));
            }
            if (lane == 0) {
                s_base = base;
                if (chunk == 0 && tile == ntiles - 1) *total = base + agg;
            }
        }
        __syncthreads();
        s_bits[tid] = (unsigned short)bits;
        s_excl[tid] = s_warp[warp] + incl - cnt;
        __syncthreads();
        const long long base = s_base;

        // striped layout: step j moves row row0 + 256 j + tid, owned in the
        // blocked layout by thread 16 j + tid / 16 at bit tid % 16
        const int b = tid % kItems;
        const long long room = out_len - base;
        int local[kItems];
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
            const int owner = j * (kThreads / kItems) + tid / kItems;
            const unsigned m = s_bits[owner];
            const int r = s_excl[owner] + __popc(m & ((1u << b) - 1u));
            local[j] = ((m >> b) & 1u) && r < room ? r : -1;
        }
        for (int c = 0; c < cols.count; ++c) {
            switch (cols.width[c]) {
                case 1: scatter_column<uint8_t>(cols.src[c], cols.dst[c], row0, base, local); break;
                case 2: scatter_column<uint16_t>(cols.src[c], cols.dst[c], row0, base, local); break;
                case 4: scatter_column<uint32_t>(cols.src[c], cols.dst[c], row0, base, local); break;
                default: scatter_column<uint64_t>(cols.src[c], cols.dst[c], row0, base, local); break;
            }
        }
        __syncthreads();  // shared memory is reused by the next tile
    }

    // the tail [total, out_len): total is the last tile's inclusive prefix
    __shared__ long long s_total;
    if (tid == 0) {
        unsigned long long s = kFlagPrefix;  // no tiles: total 0
        if (ntiles > 0)
            while (((s = load_status(status + ntiles - 1)) >> 62) != 2) __nanosleep(64);
        s_total = (long long)(s & kCountMask);
    }
    __syncthreads();
    const long long start = s_total < out_len ? s_total : out_len;
    const long long t = (long long)blockIdx.x * kThreads + tid;
    const long long stride = (long long)gridDim.x * kThreads;
    for (int c = 0; c < cols.count; ++c) {
        const long long w = cols.width[c];
        zero_bytes(static_cast<unsigned char*>(cols.dst[c]), start * w, out_len * w, t, stride);
    }
}

}  // namespace

namespace {

// Blocks of compact_kernel the card holds at once (cached per device).
int resident_blocks() {
    static int cached[64] = {0};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
    if (cached[dev] == 0) {
        int sms = 0, per_sm = 0;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, compact_kernel, kThreads, 0);
        cached[dev] = sms * per_sm > 0 ? sms * per_sm : 132;
    }
    return cached[dev];
}

}  // namespace

// scratch: ceil(n / 4096) + 2 int64 words (tile status, tile counter, total);
// total = scratch + ceil(n / 4096) + 1.  srcs/dsts/widths are host arrays of
// ncols entries.  One memset, then one launch per 16 columns.
extern "C" int trino_compact_rows(const void* valid, long long n, long long out_len,
                                  int ncols, const void* const* srcs, void* const* dsts,
                                  const int* widths, void* scratch, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n < 0 || out_len < 0 || ncols <= 0) return (int)cudaErrorInvalidValue;
    const long long ntiles = (n + kTile - 1) / kTile;
    unsigned long long* status = (unsigned long long*)scratch;
    unsigned long long* counter = status + ntiles;
    long long* total = (long long*)(status + ntiles + 1);
    cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)(ntiles + 2) * 8, s);
    if (err != cudaSuccess) return (int)err;
    int max_width = 1;
    for (int c = 0; c < ncols; ++c) max_width = widths[c] > max_width ? widths[c] : max_width;
    // enough blocks for the tiles, or for the tail at four 16-byte stores a
    // thread, and no more than the card holds at once
    const long long tail_units = (out_len * max_width + 16LL * kThreads * 4 - 1)
                                 / (16LL * kThreads * 4);
    long long grid = ntiles > tail_units ? ntiles : tail_units;
    const long long resident = resident_blocks();
    grid = grid < 1 ? 1 : grid > resident ? resident : grid;
    for (int c0 = 0; c0 < ncols; c0 += kMaxCols) {
        Columns cols;
        cols.count = ncols - c0 < kMaxCols ? ncols - c0 : kMaxCols;
        for (int c = 0; c < cols.count; ++c) {
            cols.src[c] = srcs[c0 + c];
            cols.dst[c] = dsts[c0 + c];
            cols.width[c] = widths[c0 + c];
        }
        compact_kernel<<<(unsigned)grid, kThreads, 0, s>>>(
            (const unsigned char*)valid, n, out_len, cols, status, counter, total, ntiles,
            c0 / kMaxCols);
    }
    return (int)cudaGetLastError();
}
