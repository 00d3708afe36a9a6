// Global exclusive scan of the per-tile digit counts, stage 2 of the
// counting engine's pass, for NVIDIA Hopper (sm_90a): the reference's
// `prefixSumExclusiveInplace` (kernel.cu:136-204).
//
// Replaces no TPU kernel: the JAX package gives this stage to XLA's cumsum
// over the bucket-major counters (`exclusive_scan_bucket_major`,
// tinyhipradixsort_tpu/ops/histogram.py:91). It computes what
// `bucket_offsets_reference` in tinyhipradixsort_torch/ops/histogram.py
// computes, bit for bit; it is not the reference's chained single-block
// scan carried over.
//
// What it computes. `counts` is stage 1's (rows, tiles, 2**width) int32,
// tile-major as the histogram kernel writes it, width 1-8. For row r, tile
// t and bucket b:
//     out[r][t][b] = r * tiles * tile + sum(total[r][b'] for b' < b)
//                    + sum(counts[r][t'][b] for t' < t),
// total[r][b] being bucket b's count over the row: each row's flat
// exclusive scan in the reference's bucket-major counter order (bucket *
// tiles + tile, kernel.cu:97), plus the row's start, but written in the
// tile-major layout that rank_scatter.cu reads, so no transposed copy is
// made on either side. The output is int32 or int64; sums are taken in 64
// bits (a bucket's count over a row passes 2**31 past 2**31 keys).
//
// What bounds it. Every count is read once and every offset written once:
// at 2**28 keys, tile 2048 and width 8, 2**17 x 256 counts, 134 MB read and
// 134 MB (int32) or 268 MB (int64) written, 0.080 ms or 0.120 ms at 3.35
// TB/s on an H100 SXM. One add an element: bytes set the bound.
//
// The design: reduce, scan, then walk again, all in the tile-major layout.
// A row's tiles are cut into chunks of THRS_SCAN_CHUNK tiles (a chunk
// never crosses a row). Thread (chunk, b) owns the column of bucket b in
// its chunk, so a warp reads and writes 32 neighbouring buckets of one
// tile, 128 contiguous bytes; digits narrower than 8 bits put 256 / 2**width
// chunks in a block. A thread keeps THRS_SCAN_UNROLL loads in flight.
//   1. chunk_sum_kernel: each column's sum, into an int64 scratch
//      (rows, chunks, 2**width).
//   2. column_scan_kernel: one block per row and group of buckets turns
//      those sums, in place, into each chunk's exclusive prefix over the
//      row's earlier chunks, and writes each bucket's row total.
//   3. chunk_write_kernel: each block scans the row totals over the lower
//      buckets in shared memory; each thread starts from the row's start
//      plus that scan plus its chunk's prefix, and walks its column again,
//      writing the running offset and adding each count.
// The counts are read twice, so the design's own floor at 2**28 is 0.120
// ms (int32). A row of one chunk (tiles <= THRS_SCAN_CHUNK) takes step 3
// alone: the thread sums its column first, and no scratch is used.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (done at first use by ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define THRS_SCAN_THREADS 256        // threads of steps 1 and 3
#define THRS_SCAN_CHUNK 128          // tiles a chunk
#define THRS_SCAN_COL_THREADS 1024   // threads of step 2
#define THRS_SCAN_COL_BUCKETS 16     // buckets a block of step 2, at most
#define THRS_SCAN_MAX_WIDTH 8
#define THRS_SCAN_UNROLL 8

struct ScanParams {
    long long rows;
    long long tiles;   // tiles a row
    long long chunks;  // chunks a row
    long long tile;    // elements a tile
    int width;
};

// The column a thread of steps 1 and 3 owns.
struct Column {
    long long chunk;  // r * chunks + g
    long long row;
    long long t0;     // its first tile in the row
    long long len;    // its tiles (0 past the last chunk)
    int bucket;
    bool valid;
};

__device__ __forceinline__ Column column_of(const ScanParams& p) {
    Column c;
    c.bucket = threadIdx.x & ((1 << p.width) - 1);
    c.chunk = (long long)blockIdx.x * (THRS_SCAN_THREADS >> p.width) +
              (threadIdx.x >> p.width);
    c.valid = c.chunk < p.rows * p.chunks;
    c.row = c.chunk / p.chunks;
    c.t0 = (c.chunk % p.chunks) * THRS_SCAN_CHUNK;
    long long end = c.t0 + THRS_SCAN_CHUNK;
    if (end > p.tiles) end = p.tiles;
    c.len = c.valid ? end - c.t0 : 0;
    return c;
}

// The sum of `len` counts `stride` apart.
__device__ __forceinline__ long long column_sum(const int* __restrict__ c,
                                                long long stride,
                                                long long len) {
    long long s = 0;
    long long i = 0;
    for (; i + THRS_SCAN_UNROLL <= len; i += THRS_SCAN_UNROLL) {
        int v[THRS_SCAN_UNROLL];
#pragma unroll
        for (int k = 0; k < THRS_SCAN_UNROLL; ++k) v[k] = __ldg(c + (i + k) * stride);
#pragma unroll
        for (int k = 0; k < THRS_SCAN_UNROLL; ++k) s += v[k];
    }
    for (; i < len; ++i) s += __ldg(c + i * stride);
    return s;
}

// Writes `run` plus the counts before each of `len` places `stride` apart.
template <typename Idx>
__device__ __forceinline__ void column_write(const int* __restrict__ c,
                                             Idx* __restrict__ o,
                                             long long stride, long long len,
                                             long long run) {
    long long i = 0;
    for (; i + THRS_SCAN_UNROLL <= len; i += THRS_SCAN_UNROLL) {
        int v[THRS_SCAN_UNROLL];
#pragma unroll
        for (int k = 0; k < THRS_SCAN_UNROLL; ++k) v[k] = __ldg(c + (i + k) * stride);
#pragma unroll
        for (int k = 0; k < THRS_SCAN_UNROLL; ++k) {
            o[(i + k) * stride] = (Idx)run;
            run += v[k];
        }
    }
    for (; i < len; ++i) {
        const int v = __ldg(c + i * stride);
        o[i * stride] = (Idx)run;
        run += v;
    }
}

// Step 1: sums[chunk][b] = the sum of the chunk's column of bucket b.
__global__ void __launch_bounds__(THRS_SCAN_THREADS)
chunk_sum_kernel(const int* __restrict__ counts, ScanParams p,
                 long long* __restrict__ sums) {
    const Column c = column_of(p);
    if (!c.valid) return;
    const long long nb = 1ll << p.width;
    sums[c.chunk * nb + c.bucket] = column_sum(
        counts + (c.row * p.tiles + c.t0) * nb + c.bucket, nb, c.len);
}

// Step 2: in each row, sums[g][b] becomes the sum of sums[g'][b] for
// g' < g, and totals[b] the sum over every g. Thread (lane, b) of the block
// takes a run of consecutive chunks; the lanes' sums are scanned in shared
// memory.
__global__ void __launch_bounds__(THRS_SCAN_COL_THREADS)
column_scan_kernel(long long* __restrict__ sums,
                   long long* __restrict__ totals, ScanParams p) {
    __shared__ long long part[THRS_SCAN_COL_THREADS];
    const int nb = 1 << p.width;
    const int bb = nb < THRS_SCAN_COL_BUCKETS ? nb : THRS_SCAN_COL_BUCKETS;
    const int lanes = THRS_SCAN_COL_THREADS / bb;
    const int groups = nb / bb;
    const long long row = blockIdx.x / groups;
    const int b = (int)(blockIdx.x % groups) * bb + (int)threadIdx.x % bb;
    const int lane = (int)threadIdx.x / bb;
    const long long per = (p.chunks + lanes - 1) / lanes;
    long long g0 = lane * per;
    long long g1 = g0 + per;
    if (g0 > p.chunks) g0 = p.chunks;
    if (g1 > p.chunks) g1 = p.chunks;
    long long* col = sums + row * p.chunks * nb + b;
    long long s = 0;
    for (long long g = g0; g < g1; ++g) s += col[g * nb];
    part[threadIdx.x] = s;
    for (int d = 1; d < lanes; d <<= 1) {
        __syncthreads();
        const long long v = lane >= d ? part[threadIdx.x - d * bb] : 0;
        __syncthreads();
        part[threadIdx.x] += v;
    }
    long long run = part[threadIdx.x] - s;
    if (lane == lanes - 1) totals[row * nb + b] = part[threadIdx.x];
    for (long long g = g0; g < g1; ++g) {
        const long long v = col[g * nb];
        col[g * nb] = run;
        run += v;
    }
}

// Step 3 (and, with kWhole, the whole scan of rows of one chunk).
template <typename Idx, bool kWhole>
__global__ void __launch_bounds__(THRS_SCAN_THREADS)
chunk_write_kernel(const int* __restrict__ counts, ScanParams p,
                   const long long* __restrict__ prefix,
                   const long long* __restrict__ totals,
                   Idx* __restrict__ out) {
    __shared__ long long scan[THRS_SCAN_THREADS];
    const Column c = column_of(p);
    const long long nb = 1ll << p.width;
    const long long at = (c.row * p.tiles + c.t0) * nb + c.bucket;
    long long total = 0;  // bucket b's count over the row
    if (c.valid) {
        total = kWhole ? column_sum(counts + at, nb, c.len)
                       : totals[c.row * nb + c.bucket];
    }
    // inclusive scan of the totals over the buckets, among the nb threads
    // of each chunk of the block
    scan[threadIdx.x] = total;
    for (int d = 1; d < nb; d <<= 1) {
        __syncthreads();
        const long long v = c.bucket >= d ? scan[threadIdx.x - d] : 0;
        __syncthreads();
        scan[threadIdx.x] += v;
    }
    if (!c.valid) return;
    long long run = c.row * p.tiles * p.tile + scan[threadIdx.x] - total;
    if (!kWhole) run += prefix[c.chunk * nb + c.bucket];
    column_write<Idx>(counts + at, out + at, nb, c.len, run);
}

static long long chunks_of(long long tiles) {
    return (tiles + THRS_SCAN_CHUNK - 1) / THRS_SCAN_CHUNK;
}

// The int64 words of scratch that thrs_bucket_scan needs for `rows` rows of
// `tiles` tiles at `width`: none when a row is one chunk.
extern "C" long long thrs_bucket_scan_scratch(long long rows, long long tiles,
                                              int width) {
    if (rows < 1 || tiles < 1 || width < 1 || width > THRS_SCAN_MAX_WIDTH) {
        return 0;
    }
    const long long chunks = chunks_of(tiles);
    return chunks > 1 ? rows * (chunks + 1) * (1ll << width) : 0;
}

template <typename Idx>
static int launch(const int* counts, const ScanParams& p, long long blocks,
                  long long col_blocks, void* out, long long* scratch,
                  cudaStream_t s) {
    Idx* o = static_cast<Idx*>(out);
    if (p.chunks == 1) {
        chunk_write_kernel<Idx, true><<<(unsigned int)blocks,
                                         THRS_SCAN_THREADS, 0, s>>>(
            counts, p, nullptr, nullptr, o);
        return (int)cudaGetLastError();
    }
    long long* sums = scratch;
    long long* totals = scratch + p.rows * p.chunks * (1ll << p.width);
    chunk_sum_kernel<<<(unsigned int)blocks, THRS_SCAN_THREADS, 0, s>>>(
        counts, p, sums);
    int err = (int)cudaGetLastError();
    if (err) return err;
    column_scan_kernel<<<(unsigned int)col_blocks, THRS_SCAN_COL_THREADS, 0,
                         s>>>(sums, totals, p);
    err = (int)cudaGetLastError();
    if (err) return err;
    chunk_write_kernel<Idx, false><<<(unsigned int)blocks, THRS_SCAN_THREADS,
                                      0, s>>>(counts, p, sums, totals, o);
    return (int)cudaGetLastError();
}

// Scans the device array `counts` of rows * tiles * 2**width int32 (width
// 1-8; tiles of `tile` elements) into `out`, as many offsets of
// `idx_bytes` (4 or 8) bytes, on `stream`. `scratch` holds
// thrs_bucket_scan_scratch(rows, tiles, width) int64 words of device
// memory (null when that is 0). With 4-byte offsets the caller guarantees
// rows * tiles * tile < 2**31. Returns a cudaError_t as int: each launch is
// checked with cudaGetLastError(); a fault while a kernel runs shows at the
// next synchronisation.
extern "C" int thrs_bucket_scan(const int* counts, long long rows,
                                long long tiles, int width, long long tile,
                                void* out, int idx_bytes, long long* scratch,
                                void* stream) {
    if (counts == nullptr || out == nullptr || rows < 1 || tiles < 1 ||
        width < 1 || width > THRS_SCAN_MAX_WIDTH || tile < 1 ||
        (idx_bytes != 4 && idx_bytes != 8) ||
        (thrs_bucket_scan_scratch(rows, tiles, width) > 0 &&
         scratch == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    ScanParams p;
    p.rows = rows;
    p.tiles = tiles;
    p.chunks = chunks_of(tiles);
    p.tile = tile;
    p.width = width;
    const long long per_block = THRS_SCAN_THREADS >> width;
    const long long blocks = (rows * p.chunks + per_block - 1) / per_block;
    const int nb = 1 << width;
    const long long col_blocks =
        rows * (nb / (nb < THRS_SCAN_COL_BUCKETS ? nb : THRS_SCAN_COL_BUCKETS));
    if (blocks > 0x7FFFFFFFll || col_blocks > 0x7FFFFFFFll) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return idx_bytes == 4
               ? launch<int>(counts, p, blocks, col_blocks, out, scratch, s)
               : launch<long long>(counts, p, blocks, col_blocks, out,
                                   scratch, s);
}
