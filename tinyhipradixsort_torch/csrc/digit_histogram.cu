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
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (done at first use by ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define THRS_HIST_THREADS 256
#define THRS_HIST_CHUNK 16384       // elements one CTA counts at most
#define THRS_HIST_SMEM_MAX_WIDTH 13  // 2**13 int32 bins = 32 KB of shared memory

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
