// Per-tile digit histogram, the reference `blockCount`, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_hist_kernel` (launched by
// `digit_histogram`) in tinyhipradixsort_tpu/ops/histogram.py. It computes
// what `digit_histogram_reference` in
// tinyhipradixsort_torch/ops/histogram.py computes; it is not the Pallas
// kernel carried over block by block (the TPU has no atomics, so that kernel
// sums bucket-chunked compares; Hopper has the shared-memory atomics the
// reference, kernel.cu:73-103, uses).
//
// What it computes. `bits` holds n words (u32, or u64 first shifted right by
// `shift`); the digit of a word is (word >> shift) & (2**width - 1). Tile t
// covers elements [t * tile, (t + 1) * tile); out[t][d] counts the digits d
// of its elements. Elements past n count as all-ones words, whose digit is
// 2**width - 1 for every window: the pad is never materialized, its count
// goes straight into the last tile's top bucket.
//
// What bounds it. Every word is read once and every bin written once:
// n * 4 (or 8) + T * 2**width * 4 bytes against ~3.35 TB/s on an H100 SXM
// (2**28 u32 words: 1.074 GB, ~0.32 ms). The design answers that with
// 16-byte loads (tiles are multiples of 128 elements) and bins kept in
// shared memory: a CTA counts up to CHUNK elements of one tile with
// shared-memory atomics and writes its row once. Tiles longer than CHUNK
// (up to 2**22 elements) are shared by several CTAs, which merge with
// global atomics. Widths whose bins do not fit the static budget take
// global atomics for every element. Integer atomics make the result
// deterministic.
//
// Run sums (thrs_digit_histogram_runs, for the counting engine). Besides
// the per-tile counts, stage 2 of a counting pass needs each row's bucket
// totals before it can write any offset. So this entry also writes, for
// every run of at most `run` consecutive tiles of a row (a run never
// crosses a row), the column sums run_sums[row][run][d] in int64: stage 2
// then reads the counts once (csrc/bucket_scan.cu). A run is counted by one
// thread block cluster of up to 8 CTAs; each CTA counts a contiguous part
// of the run's elements into one bin row per tile it touches (no barrier
// between tiles, so its loads stay in flight), the cluster merges the rows
// of a tile split between CTAs and the CTAs' column sums through
// distributed shared memory, and the run's sums are written once: no global
// atomics and no memset, for every tile from 1024 to 2**22 elements. The
// added writes are 8 bytes a bucket a run, 2/run of the counts' bytes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (done at first use by ops/cuda_lib.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define THRS_HIST_THREADS 256
#define THRS_HIST_CHUNK 16384       // elements one CTA counts at most
#define THRS_HIST_SMEM_MAX_WIDTH 13  // 2**13 int32 bins = 32 KB of shared memory
#define THRS_HIST_RUN_BLOCK 16384   // elements a CTA of the runs kernel counts, at least
#define THRS_HIST_MAX_CLUSTER 8     // CTAs a run (a portable cluster size)
#define THRS_HIST_RUN_MAX_WIDTH 8   // one bucket a thread when a run is merged
#define THRS_HIST_MIN_RUN_TILE 1024 // so a CTA keeps at most ~19 bin rows
#define THRS_HIST_LOADS 2           // 16-byte loads a thread has in flight
#define THRS_HIST_RUN_BLOCKS_PER_SM 8  // 2048 threads: at most 32 registers

// 16 bytes of words: 4 u32 or 2 u64.
template <typename Word>
struct Vec;
template <>
struct Vec<uint32_t> {
    using type = uint4;
    static constexpr int n = 4;
    __device__ static uint32_t get(const uint4& v, int i) {
        return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
    }
};
template <>
struct Vec<unsigned long long> {
    using type = ulonglong2;
    static constexpr int n = 2;
    __device__ static unsigned long long get(const ulonglong2& v, int i) {
        return i == 0 ? v.x : v.y;
    }
};

struct HistParams {
    long long n;          // words
    long long tile;       // elements per tile (multiple of 128)
    long long num_tiles;  // T
    long long chunk;      // elements per CTA (multiple of 128)
    int splits;           // CTAs per tile
    int shift;
    int width;
    int vec;              // 1 when `bits` is 16-byte aligned
};

// Calls count(digit) for every real element of this CTA's chunk.
template <typename Word, typename F>
__device__ __forceinline__ void for_each_digit(const Word* __restrict__ bits,
                                               const HistParams& p,
                                               long long begin, long long end,
                                               F count) {
    const unsigned long long mask =
        p.width >= 64 ? ~0ull : ((1ull << p.width) - 1ull);
    using V = Vec<Word>;
    long long i = begin;
    if (p.vec) {
        // begin is a multiple of 128 elements, so of V::n, and aligned
        const long long nvec = (end - begin) / V::n;
        const typename V::type* vb =
            reinterpret_cast<const typename V::type*>(bits + begin);
        for (long long v = threadIdx.x; v < nvec; v += blockDim.x) {
            const typename V::type w = vb[v];
#pragma unroll
            for (int k = 0; k < V::n; ++k) {
                count((unsigned int)(((unsigned long long)V::get(w, k) >>
                                      p.shift) & mask));
            }
        }
        i = begin + nvec * V::n;
    }
    for (long long e = i + threadIdx.x; e < end; e += blockDim.x) {
        count((unsigned int)(((unsigned long long)bits[e] >> p.shift) & mask));
    }
}

__device__ __forceinline__ void chunk_range(const HistParams& p,
                                            long long* tile_id,
                                            long long* begin,
                                            long long* end, int* part) {
    *tile_id = blockIdx.x / p.splits;
    *part = blockIdx.x % p.splits;
    const long long tile_begin = *tile_id * p.tile;
    *begin = tile_begin + *part * p.chunk;
    long long e = *begin + p.chunk;
    if (e > tile_begin + p.tile) e = tile_begin + p.tile;
    if (e > p.n) e = p.n;
    *end = e;
}

// Bins in shared memory; one row store per CTA (or global atomics when the
// tile is split over several CTAs).
template <typename Word>
__global__ void __launch_bounds__(THRS_HIST_THREADS)
digit_histogram_smem_kernel(const Word* __restrict__ bits, HistParams p,
                            int* __restrict__ out) {
    __shared__ int bins[1 << THRS_HIST_SMEM_MAX_WIDTH];
    const int nb = 1 << p.width;
    long long tile_id, begin, end;
    int part;
    chunk_range(p, &tile_id, &begin, &end, &part);
    for (int b = threadIdx.x; b < nb; b += blockDim.x) bins[b] = 0;
    __syncthreads();
    if (threadIdx.x == 0 && part == 0 && tile_id == p.num_tiles - 1) {
        // the all-ones pad of the tail, never materialized
        atomicAdd(&bins[nb - 1], (int)(p.num_tiles * p.tile - p.n));
    }
    if (begin < end) {
        for_each_digit<Word>(bits, p, begin, end,
                             [&](unsigned int d) { atomicAdd(&bins[d], 1); });
    }
    __syncthreads();
    int* row = out + tile_id * nb;
    if (p.splits == 1) {
        for (int b = threadIdx.x; b < nb; b += blockDim.x) row[b] = bins[b];
    } else {
        for (int b = threadIdx.x; b < nb; b += blockDim.x) {
            if (bins[b] != 0) atomicAdd(&row[b], bins[b]);
        }
    }
}

// Wide digits: every element adds to its bin in device memory (zeroed first).
template <typename Word>
__global__ void __launch_bounds__(THRS_HIST_THREADS)
digit_histogram_global_kernel(const Word* __restrict__ bits, HistParams p,
                              int* __restrict__ out) {
    const long long nb = 1ll << p.width;
    long long tile_id, begin, end;
    int part;
    chunk_range(p, &tile_id, &begin, &end, &part);
    int* row = out + tile_id * nb;
    if (threadIdx.x == 0 && part == 0 && tile_id == p.num_tiles - 1) {
        atomicAdd(&row[nb - 1], (int)(p.num_tiles * p.tile - p.n));
    }
    if (begin < end) {
        for_each_digit<Word>(bits, p, begin, end,
                             [&](unsigned int d) { atomicAdd(&row[d], 1); });
    }
}

// Offsets inside a run are 32-bit: a run holds at most 128 tiles of 2**22
// elements, 2**29.
struct RunParams {
    long long n;            // words
    long long num_tiles;    // T = rows * tiles
    unsigned int tile;      // elements per tile (multiple of 128, >= 1024)
    unsigned int tiles;     // tiles a row
    unsigned int run;       // tiles a run
    unsigned int runs;      // runs a row
    unsigned int part;      // elements a CTA of a full run (multiple of 128)
    unsigned int cluster;   // CTAs a run
    int local_tiles;        // bin rows a CTA keeps
    int shift;
    int width;
    int vec;                // 1 when `bits` is 16-byte aligned
};

// The elements of a run (or of its short last run) that each CTA counts.
__host__ __device__ __forceinline__ unsigned int run_part(unsigned int span,
                                                          unsigned int cluster) {
    const unsigned int part = (span + cluster - 1) / cluster;
    return (part + 127) & ~127u;
}

// Adds the digits of the `len` words at `seg` (within one tile, so len <=
// 2**22) to `bins`, THRS_HIST_LOADS 16-byte loads in flight a thread; seg
// is a multiple of 128 elements past a 16-byte aligned `bits` when `vec`.
template <typename Word>
__device__ __forceinline__ void count_segment(const Word* __restrict__ seg,
                                              int len, int shift,
                                              unsigned int mask, int vec,
                                              int* bins) {
    using V = Vec<Word>;
    int i = 0;
    if (vec) {
        const int nvec = len / V::n;
        const typename V::type* vb =
            reinterpret_cast<const typename V::type*>(seg);
        for (int v0 = threadIdx.x; v0 < nvec;
             v0 += THRS_HIST_LOADS * THRS_HIST_THREADS) {
            typename V::type w[THRS_HIST_LOADS];
#pragma unroll
            for (int u = 0; u < THRS_HIST_LOADS; ++u) {
                const int v = v0 + u * THRS_HIST_THREADS;
                if (v < nvec) w[u] = vb[v];
            }
#pragma unroll
            for (int u = 0; u < THRS_HIST_LOADS; ++u) {
                if (v0 + u * THRS_HIST_THREADS < nvec) {
#pragma unroll
                    for (int k = 0; k < V::n; ++k) {
                        atomicAdd(&bins[(unsigned int)((unsigned long long)
                                                           V::get(w[u], k) >>
                                                       shift) & mask],
                                  1);
                    }
                }
            }
        }
        i = nvec * V::n;
    }
    for (int e = i + threadIdx.x; e < len; e += blockDim.x) {
        atomicAdd(&bins[(unsigned int)((unsigned long long)seg[e] >> shift) &
                        mask],
                  1);
    }
}

// Counts and run sums: cluster g is run g (row g / runs); its CTA k counts
// the run's elements [k * part, (k + 1) * part), each tile it touches into
// its own bin row. Then the CTA where a tile starts adds the rows of the
// CTAs its tile reaches into, writes the tile's counts and sums them into
// its column; CTA 0 adds the columns of the cluster and writes the run's
// sums.
template <typename Word>
__global__ void __launch_bounds__(THRS_HIST_THREADS,
                                  THRS_HIST_RUN_BLOCKS_PER_SM)
digit_histogram_runs_kernel(const Word* __restrict__ bits, RunParams p,
                            int* __restrict__ out,
                            long long* __restrict__ run_sums) {
    extern __shared__ long long smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int nb = 1 << p.width;
    long long* col = smem;                             // nb column sums
    int* bins = reinterpret_cast<int*>(smem + nb);     // local_tiles x nb
    const unsigned int k = cluster.block_rank();
    const unsigned int g = blockIdx.x / p.cluster;
    const unsigned int row = g / p.runs;
    const unsigned int j = g - row * p.runs;
    const long long first = (long long)row * p.tiles + (long long)j * p.run;
    const unsigned int len = min(p.run, p.tiles - j * p.run);  // its tiles
    const unsigned int span = len * p.tile;
    const unsigned int part =
        len == p.run ? p.part : run_part(span, p.cluster);
    const unsigned int lo = min(k * part, span);
    const unsigned int hi = min(lo + part, span);
    const unsigned int lt0 = lo / p.tile;  // the first tile it touches
    const Word* run_bits = bits + first * p.tile;
    // the all-ones pad past n is never read
    const long long left = p.n - first * p.tile;
    const unsigned int end = left < (long long)hi ? (unsigned int)left : hi;
    const unsigned int mask = (1u << p.width) - 1u;
    for (int i = threadIdx.x; i < p.local_tiles * nb; i += blockDim.x) {
        bins[i] = 0;
    }
    __syncthreads();
    for (unsigned int t = lt0; t * p.tile < end; ++t) {
        const unsigned int e0 = max(t * p.tile, lo);
        const unsigned int e1 = min((t + 1) * p.tile, end);
        if (e0 < e1) {
            count_segment<Word>(run_bits + e0, (int)(e1 - e0), p.shift, mask,
                                p.vec, bins + (t - lt0) * nb);
        }
    }
    cluster.sync();  // every CTA's bins are complete
    const int b = threadIdx.x;  // its bucket (nb <= THRS_HIST_THREADS)
    if (b < nb) {
        long long c = 0;
        for (unsigned int t = (lo + p.tile - 1) / p.tile; t * p.tile < hi;
             ++t) {
            // tile t starts here; CTAs k..kl hold its elements
            const unsigned int kl = ((t + 1) * p.tile - 1) / part;
            int v = bins[(t - lt0) * nb + b];
            for (unsigned int q = k + 1; q <= kl; ++q) {
                const int* rb = cluster.map_shared_rank(bins, q);
                v += rb[(t - q * part / p.tile) * nb + b];
            }
            if (first + t == p.num_tiles - 1 && b == nb - 1) {
                // the all-ones pad of the tail, never materialized
                v += (int)(p.num_tiles * p.tile - p.n);
            }
            out[(first + t) * nb + b] = v;
            c += v;
        }
        col[b] = c;
    }
    cluster.sync();  // every CTA's column is complete
    if (k == 0 && b < nb) {
        long long s = 0;
        for (unsigned int q = 0; q < p.cluster; ++q) {
            s += cluster.map_shared_rank(col, q)[b];
        }
        run_sums[(long long)g * nb + b] = s;
    }
    cluster.sync();  // CTA 0 has read the others' shared memory
}

template <typename Word>
static int launch_runs(const void* bits, const RunParams& p, long long blocks,
                       int* out, long long* run_sums, cudaStream_t stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned int)blocks);
    cfg.blockDim = dim3(THRS_HIST_THREADS);
    cfg.dynamicSmemBytes = ((size_t)1 << p.width) *
                           (sizeof(long long) + p.local_tiles * sizeof(int));
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, digit_histogram_runs_kernel<Word>,
                           static_cast<const Word*>(bits), p, out, run_sums);
    if (err != cudaSuccess) {
        return (int)err;
    }
    return (int)cudaGetLastError();
}

template <typename Word>
static int launch(const void* bits, const HistParams& p, long long blocks,
                  int* out, cudaStream_t stream) {
    const Word* b = static_cast<const Word*>(bits);
    if (p.width <= THRS_HIST_SMEM_MAX_WIDTH) {
        digit_histogram_smem_kernel<Word>
            <<<(unsigned int)blocks, THRS_HIST_THREADS, 0, stream>>>(b, p, out);
    } else {
        digit_histogram_global_kernel<Word>
            <<<(unsigned int)blocks, THRS_HIST_THREADS, 0, stream>>>(b, p, out);
    }
    return (int)cudaGetLastError();
}

// Counts the digits of `n` words of `word_bytes` (4 or 8) bytes at `bits`
// into `out`, a device array of `num_tiles * 2**width` int32, on `stream`.
// `tile` is a multiple of 128 and num_tiles = max(ceil(n / tile), 1). For
// 8-byte words the window is [shift, shift + width) of the 64-bit word with
// width <= 32; for 4-byte words shift + width <= 32. Returns a cudaError_t as
// int: the launch is checked with cudaGetLastError(); a fault while the
// kernel runs shows at the next synchronisation.
extern "C" int thrs_digit_histogram(const void* bits, int word_bytes,
                                    long long n, int shift, int width,
                                    long long tile, long long num_tiles,
                                    int* out, void* stream) {
    const int nbits = word_bytes * 8;
    if ((word_bytes != 4 && word_bytes != 8) || n < 0 || tile < 128 ||
        (tile & 127) != 0 || width < 1 || width > 32 || shift < 0 ||
        shift >= nbits || (word_bytes == 4 && shift + width > 32) ||
        num_tiles != (n > 0 ? (n + tile - 1) / tile : 1)) {
        return (int)cudaErrorInvalidValue;
    }
    HistParams p;
    p.n = n;
    p.tile = tile;
    p.num_tiles = num_tiles;
    p.chunk = tile < THRS_HIST_CHUNK ? tile : THRS_HIST_CHUNK;
    p.splits = (int)((tile + p.chunk - 1) / p.chunk);
    p.shift = shift;
    p.width = width;
    p.vec = (reinterpret_cast<uintptr_t>(bits) & 15) == 0;
    const long long blocks = num_tiles * p.splits;
    if (blocks > 0x7FFFFFFFll) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (p.splits > 1 || width > THRS_HIST_SMEM_MAX_WIDTH) {
        // bins merged with global atomics start from zero
        const cudaError_t err = cudaMemsetAsync(
            out, 0, (size_t)num_tiles * ((size_t)1 << width) * sizeof(int), s);
        if (err != cudaSuccess) {
            return (int)err;
        }
    }
    return word_bytes == 4
               ? launch<uint32_t>(bits, p, blocks, out, s)
               : launch<unsigned long long>(bits, p, blocks, out, s);
}

// As thrs_digit_histogram (tile >= 1024, width 1-8), for num_tiles /
// tiles_per_row rows of tiles_per_row tiles, and also writes `run_sums`, a
// device array of rows * ceil(tiles_per_row / run) * 2**width int64: the
// sum of each bucket's counts over each run of `run` consecutive tiles of
// a row (the last run of a row may be shorter), the tail's pad included.
extern "C" int thrs_digit_histogram_runs(const void* bits, int word_bytes,
                                         long long n, int shift, int width,
                                         long long tile, long long num_tiles,
                                         long long tiles_per_row,
                                         long long run, int* out,
                                         long long* run_sums, void* stream) {
    const int nbits = word_bytes * 8;
    if ((word_bytes != 4 && word_bytes != 8) || n < 0 ||
        tile < THRS_HIST_MIN_RUN_TILE || (tile & 127) != 0 || width < 1 ||
        width > THRS_HIST_RUN_MAX_WIDTH || shift < 0 || shift >= nbits ||
        (word_bytes == 4 && shift + width > 32) ||
        num_tiles != (n > 0 ? (n + tile - 1) / tile : 1) ||
        tiles_per_row < 1 || num_tiles % tiles_per_row != 0 || run < 1 ||
        out == nullptr || run_sums == nullptr) {
        return (int)cudaErrorInvalidValue;
    }
    if (run > tiles_per_row) run = tiles_per_row;
    const long long span = run * tile;  // a full run's elements
    if (span > (1ll << 29) || num_tiles > 0xFFFFFFFFll) {
        return (int)cudaErrorInvalidValue;
    }
    RunParams p;
    p.n = n;
    p.num_tiles = num_tiles;
    p.tile = (unsigned int)tile;
    p.tiles = (unsigned int)tiles_per_row;
    p.run = (unsigned int)run;
    p.runs = (unsigned int)((tiles_per_row + run - 1) / run);
    const long long want =
        (span + THRS_HIST_RUN_BLOCK - 1) / THRS_HIST_RUN_BLOCK;
    p.cluster = (unsigned int)(want < THRS_HIST_MAX_CLUSTER
                                   ? want : THRS_HIST_MAX_CLUSTER);
    p.part = run_part((unsigned int)span, p.cluster);
    // a range of `part` elements touches at most this many tiles
    p.local_tiles = (int)((p.part - 2 + tile) / tile + 1);
    p.shift = shift;
    p.width = width;
    p.vec = (reinterpret_cast<uintptr_t>(bits) & 15) == 0;
    const long long blocks = num_tiles / tiles_per_row * p.runs * p.cluster;
    if (blocks > 0x7FFFFFFFll ||
        ((size_t)1 << width) * (sizeof(long long) +
                                p.local_tiles * sizeof(int)) > 48 * 1024) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return word_bytes == 4
               ? launch_runs<uint32_t>(bits, p, blocks, out, run_sums, s)
               : launch_runs<unsigned long long>(bits, p, blocks, out,
                                                 run_sums, s);
}
