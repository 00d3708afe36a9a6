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
// The design. An offset needs the row's totals of every lower bucket, so
// nothing can be written before the whole row is counted. A row's tiles are
// cut into runs of `run` tiles (a run never crosses a row), and stage 1
// (thrs_digit_histogram_runs in digit_histogram.cu) writes each run's
// column sums, sums[r][g][b], beside the counts. Then:
//   1. run_scan_kernel: one block per row and group of buckets turns those
//      sums, in place, into each run's inclusive prefix over the row's runs,
//      so the last run's entry is the row's total.
//   2. run_write_kernel: thread (run, b) owns the column of bucket b in its
//      run, so a warp reads and writes 32 neighbouring buckets of one tile,
//      128 contiguous bytes; digits narrower than 8 bits put 256 / 2**width
//      runs in a block. Each block scans the row totals over the lower
//      buckets in shared memory; each thread starts from the row's start
//      plus that scan plus the previous run's prefix, and walks its column
//      once, THRS_SCAN_UNROLL loads in flight, writing the running offset
//      and adding each count.
// The counts are read once. A row of one run takes step 2 alone.
// Called without stage 1's sums, the scan makes them itself first
// (run_sum_kernel, a walk over the counts into an int64 scratch), or, for
// rows of one run, step 2 sums its column before it walks it: the counts
// are then read twice.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (done at first use by ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define THRS_SCAN_THREADS 256        // threads of the walks
#define THRS_SCAN_COL_THREADS 1024   // threads of the run scan
#define THRS_SCAN_COL_BUCKETS 16     // buckets a block of the run scan, at most
#define THRS_SCAN_MAX_WIDTH 8
#define THRS_SCAN_UNROLL 8

typedef unsigned long long u64;  // sums wrap, so a scan of scanned sums is defined

struct ScanParams {
    long long rows;
    long long tiles;  // tiles a row
    long long run;    // tiles a run
    long long runs;   // runs a row
    long long tile;   // elements a tile
    int width;
};

// The column a thread of the walks owns.
struct Column {
    long long chunk;  // its run over all rows: r * runs + g
    long long row;
    long long g;      // its run in the row
    long long t0;     // its first tile in the row
    long long len;    // its tiles (0 past the last run)
    int bucket;
    bool valid;
};

__device__ __forceinline__ Column column_of(const ScanParams& p) {
    Column c;
    c.bucket = threadIdx.x & ((1 << p.width) - 1);
    c.chunk = (long long)blockIdx.x * (THRS_SCAN_THREADS >> p.width) +
              (threadIdx.x >> p.width);
    c.valid = c.chunk < p.rows * p.runs;
    c.row = c.chunk / p.runs;
    c.g = c.chunk % p.runs;
    c.t0 = c.g * p.run;
    long long end = c.t0 + p.run;
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
                                             u64 run) {
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

// Without stage 1's sums: sums[chunk][b] = the sum of the run's column of
// bucket b.
__global__ void __launch_bounds__(THRS_SCAN_THREADS)
run_sum_kernel(const int* __restrict__ counts, ScanParams p,
               long long* __restrict__ sums) {
    const Column c = column_of(p);
    if (!c.valid) return;
    const long long nb = 1ll << p.width;
    sums[c.chunk * nb + c.bucket] = column_sum(
        counts + (c.row * p.tiles + c.t0) * nb + c.bucket, nb, c.len);
}

// Step 1: in each row, sums[g][b] becomes the sum of sums[g'][b] for
// g' <= g. Thread (lane, b) of the block takes a range of consecutive runs;
// the lanes' sums are scanned in shared memory.
__global__ void __launch_bounds__(THRS_SCAN_COL_THREADS)
run_scan_kernel(u64* __restrict__ sums, ScanParams p) {
    __shared__ u64 part[THRS_SCAN_COL_THREADS];
    const int nb = 1 << p.width;
    const int bb = nb < THRS_SCAN_COL_BUCKETS ? nb : THRS_SCAN_COL_BUCKETS;
    const int lanes = THRS_SCAN_COL_THREADS / bb;
    const int groups = nb / bb;
    const long long row = blockIdx.x / groups;
    const int b = (int)(blockIdx.x % groups) * bb + (int)threadIdx.x % bb;
    const int lane = (int)threadIdx.x / bb;
    const long long per = (p.runs + lanes - 1) / lanes;
    long long g0 = lane * per;
    long long g1 = g0 + per;
    if (g0 > p.runs) g0 = p.runs;
    if (g1 > p.runs) g1 = p.runs;
    u64* col = sums + row * p.runs * nb + b;
    u64 s = 0;
    for (long long g = g0; g < g1; ++g) s += col[g * nb];
    part[threadIdx.x] = s;
    for (int d = 1; d < lanes; d <<= 1) {
        __syncthreads();
        const u64 v = lane >= d ? part[threadIdx.x - d * bb] : 0;
        __syncthreads();
        part[threadIdx.x] += v;
    }
    u64 run = part[threadIdx.x] - s;
    for (long long g = g0; g < g1; ++g) {
        run += col[g * nb];
        col[g * nb] = run;
    }
}

// Step 2. With kWhole (no sums, rows of one run), each thread sums its
// column first; else `incl` holds each run's inclusive prefix (step 1's
// output, or stage 1's sums untouched when a row is one run).
template <typename Idx, bool kWhole>
__global__ void __launch_bounds__(THRS_SCAN_THREADS)
run_write_kernel(const int* __restrict__ counts, ScanParams p,
                 const u64* __restrict__ incl, Idx* __restrict__ out) {
    __shared__ u64 scan[THRS_SCAN_THREADS];
    const Column c = column_of(p);
    const long long nb = 1ll << p.width;
    const long long at = (c.row * p.tiles + c.t0) * nb + c.bucket;
    u64 total = 0;   // bucket b's count over the row
    u64 before = 0;  // bucket b's count in the row's earlier runs
    if (c.valid) {
        if (kWhole) {
            total = (u64)column_sum(counts + at, nb, c.len);
        } else {
            const u64* row = incl + c.row * p.runs * nb + c.bucket;
            total = __ldg(row + (p.runs - 1) * nb);
            if (c.g > 0) before = __ldg(row + (c.g - 1) * nb);
        }
    }
    // inclusive scan of the totals over the buckets, among the nb threads
    // of each run of the block
    scan[threadIdx.x] = total;
    for (int d = 1; d < nb; d <<= 1) {
        __syncthreads();
        const u64 v = c.bucket >= d ? scan[threadIdx.x - d] : 0;
        __syncthreads();
        scan[threadIdx.x] += v;
    }
    if (!c.valid) return;
    const u64 run = (u64)(c.row * p.tiles * p.tile) + scan[threadIdx.x] -
                    total + before;
    column_write<Idx>(counts + at, out + at, nb, c.len, run);
}

static long long runs_of(long long tiles, long long run) {
    return (tiles + run - 1) / run;
}

// The int64 words of scratch that thrs_bucket_scan needs without stage 1's
// sums for `rows` rows of `tiles` tiles in runs of `run` at `width`: none
// when a row is one run.
extern "C" long long thrs_bucket_scan_scratch(long long rows, long long tiles,
                                              long long run, int width) {
    if (rows < 1 || tiles < 1 || run < 1 || width < 1 ||
        width > THRS_SCAN_MAX_WIDTH) {
        return 0;
    }
    const long long runs = runs_of(tiles, run);
    return runs > 1 ? rows * runs * (1ll << width) : 0;
}

template <typename Idx>
static int launch(const int* counts, const ScanParams& p, long long blocks,
                  long long col_blocks, void* out, long long* sums,
                  bool have_sums, cudaStream_t s) {
    Idx* o = static_cast<Idx*>(out);
    if (!have_sums && p.runs == 1) {
        run_write_kernel<Idx, true><<<(unsigned int)blocks,
                                       THRS_SCAN_THREADS, 0, s>>>(
            counts, p, nullptr, o);
        return (int)cudaGetLastError();
    }
    int err;
    if (!have_sums) {
        run_sum_kernel<<<(unsigned int)blocks, THRS_SCAN_THREADS, 0, s>>>(
            counts, p, sums);
        err = (int)cudaGetLastError();
        if (err) return err;
    }
    u64* incl = reinterpret_cast<u64*>(sums);
    if (p.runs > 1) {
        run_scan_kernel<<<(unsigned int)col_blocks, THRS_SCAN_COL_THREADS, 0,
                          s>>>(incl, p);
        err = (int)cudaGetLastError();
        if (err) return err;
    }
    run_write_kernel<Idx, false><<<(unsigned int)blocks, THRS_SCAN_THREADS, 0,
                                    s>>>(counts, p, incl, o);
    return (int)cudaGetLastError();
}

// Scans the device array `counts` of rows * tiles * 2**width int32 (width
// 1-8; tiles of `tile` elements, in runs of `run` tiles) into `out`, as
// many offsets of `idx_bytes` (4 or 8) bytes, on `stream`. `sums` holds
// rows * ceil(tiles / run) * 2**width int64 words of device memory: with
// `have_sums`, stage 1's run sums (thrs_digit_histogram_runs), which are
// scanned in place (their contents afterwards are each run's inclusive
// prefix); without, thrs_bucket_scan_scratch(rows, tiles, run, width)
// words of scratch (null when that is 0). With 4-byte offsets the caller
// guarantees rows * tiles * tile < 2**31. Launches at most two kernels
// with the sums (one when a row is one run). Returns a cudaError_t as int:
// each launch is checked with cudaGetLastError(); a fault while a kernel
// runs shows at the next synchronisation.
extern "C" int thrs_bucket_scan(const int* counts, long long rows,
                                long long tiles, int width, long long tile,
                                long long run, void* out, int idx_bytes,
                                long long* sums, int have_sums,
                                void* stream) {
    if (counts == nullptr || out == nullptr || rows < 1 || tiles < 1 ||
        width < 1 || width > THRS_SCAN_MAX_WIDTH || tile < 1 || run < 1 ||
        (idx_bytes != 4 && idx_bytes != 8) ||
        ((have_sums || thrs_bucket_scan_scratch(rows, tiles, run, width) > 0)
         && sums == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    ScanParams p;
    p.rows = rows;
    p.tiles = tiles;
    p.run = run < tiles ? run : tiles;
    p.runs = runs_of(tiles, p.run);
    p.tile = tile;
    p.width = width;
    const long long per_block = THRS_SCAN_THREADS >> width;
    const long long blocks = (rows * p.runs + per_block - 1) / per_block;
    const int nb = 1 << width;
    const long long col_blocks =
        rows * (nb / (nb < THRS_SCAN_COL_BUCKETS ? nb : THRS_SCAN_COL_BUCKETS));
    if (blocks > 0x7FFFFFFFll || col_blocks > 0x7FFFFFFFll) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return idx_bytes == 4
               ? launch<int>(counts, p, blocks, col_blocks, out, sums,
                             have_sums != 0, s)
               : launch<long long>(counts, p, blocks, col_blocks, out, sums,
                                   have_sums != 0, s);
}
