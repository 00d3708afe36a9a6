// Stable rank within a tile and scatter, stage 3 of the counting engine's
// pass (the reference's `reorderKey`, kernel.cu:206-429), for NVIDIA Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package writes this stage in jnp, as a
// one-hot cumulative sum under `lax.map`
// (tinyhipradixsort_tpu/ops/counting_engine.py:35-59), because the TPU has
// no shared-memory atomics, warp ballots or vectorized scatter. Hopper has
// them, so this kernel ranks as the reference does. It computes what
// `rank_scatter_reference` in tinyhipradixsort_torch/ops/counting_engine.py
// computes, bit for bit.
//
// What it computes. `bits` holds n words (u32 or u64), whole tiles of
// `tile`; the digit of a word is (word >> shift) & (2**width - 1), width
// 1-8. Element i of tile t with digit d goes to
//     dest = base[t][d] + (elements of tile t before i with digit d),
// where `base` is the (n / tile, 2**width) output of stage 2 (the
// bucket-major exclusive scan, row offsets added). The kernel writes
// bits_out[dest] = bits[i] and src[dest] = i: `src` is the inverse
// permutation (out = x[src]) in int32 or int64.
//
// What bounds it. Every word is read once and written once, `base` is read
// once and `src` written once: at 2**28 u32 words, tile 2048 and width 8,
// 1.074 + 0.134 + 1.074 + 1.074 = 3.355 GB, 1.00 ms at 3.35 TB/s on an H100
// SXM (u64 words: 5.5 GB, 1.64 ms). The ranking is some 30 integer
// operations an element, about half that time, so bytes set the bound.
//
// The design. One block per tile walks its tile in order, in chunks of
// CHUNK = 2048 words (the reference's block), and carries 2**width running
// counters from chunk to chunk, so any tile works. In a chunk, warp w takes
// the 256 consecutive words [256 w, 256 w + 256) in 8 rounds of 32, each
// lane one word (coalesced loads, all of a chunk's issued before the
// ranking, so a block waits for memory once a chunk). A word's peers in its round are the
// lanes with the same digit, found with `width` ballots over the digit's
// bits (the reference's software match mask, kernel.cu:293-345). Its rank
// in the warp is the popcount of its lower-lane peers plus the warp's
// counter of that digit in shared memory, which the highest peer then
// advances: each digit has one writer a round, so no atomics, and the rank
// follows the words' order (an atomicAdd rank would not be stable). After
// the rounds, an exclusive scan of each digit's counters over the warps
// and one of the chunk's digit counts over the digits give every word its
// slot in the chunk's sorted order. The words (and their offsets) are
// placed there in shared memory; then thread j writes slot j to
//     base[t][d] + running[d] + (j - chunk_start[d]),
// so the writes cluster by digit, in runs, as the reference's step (e)
// does, in place of one random store a word.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (done at first use by ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define THRS_RS_THREADS 256
#define THRS_RS_WARPS (THRS_RS_THREADS / 32)
#define THRS_RS_ROUNDS 8  // rounds of 32 words per warp and chunk
#define THRS_RS_CHUNK (THRS_RS_THREADS * THRS_RS_ROUNDS)  // 2048 words
#define THRS_RS_MAX_WIDTH 8
#define THRS_RS_BUCKETS (1 << THRS_RS_MAX_WIDTH)

template <typename Word, typename Idx>
__global__ void __launch_bounds__(THRS_RS_THREADS)
rank_scatter_kernel(const Word* __restrict__ bits,
                    const Idx* __restrict__ base, long long tile, int shift,
                    int width, Word* __restrict__ bits_out,
                    Idx* __restrict__ src) {
    __shared__ Word s_keys[THRS_RS_CHUNK];            // the chunk, sorted
    __shared__ unsigned short s_off[THRS_RS_CHUNK];   // ... offsets in it
    __shared__ int s_warp[THRS_RS_WARPS][THRS_RS_BUCKETS];
    __shared__ int s_start[THRS_RS_BUCKETS];  // chunk's exclusive digit scan
    __shared__ Idx s_dest[THRS_RS_BUCKETS];   // output of slot 0 per digit
    __shared__ int s_wsum[THRS_RS_WARPS];

    const int nb = 1 << width;
    const Word mask = (Word)(nb - 1);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const unsigned below = (1u << lane) - 1u;
    const long long tile_begin = (long long)blockIdx.x * tile;
    // thread d < nb owns digit d: its base and its running count
    const Idx my_base =
        threadIdx.x < nb ? base[(long long)blockIdx.x * nb + threadIdx.x] : 0;
    int run = 0;
    for (long long c0 = 0; c0 < tile; c0 += THRS_RS_CHUNK) {
        const long long left = tile - c0;
        const int m = left < THRS_RS_CHUNK ? (int)left : THRS_RS_CHUNK;
        const int first = warp * (THRS_RS_ROUNDS * 32) + lane;
        // every load of the chunk in flight at once
        Word key[THRS_RS_ROUNDS];
        const Word* in = bits + tile_begin + c0;
#pragma unroll
        for (int r = 0; r < THRS_RS_ROUNDS; ++r) {
            const int e = first + r * 32;
            key[r] = e < m ? in[e] : (Word)0;
        }
        if (threadIdx.x < nb) {
#pragma unroll
            for (int w = 0; w < THRS_RS_WARPS; ++w) s_warp[w][threadIdx.x] = 0;
        }
        __syncthreads();

        // (a) rank of each word among its digit's words in its warp
        int rank[THRS_RS_ROUNDS];
#pragma unroll
        for (int r = 0; r < THRS_RS_ROUNDS; ++r) {
            const bool valid = first + r * 32 < m;
            const unsigned d = (unsigned)((key[r] >> shift) & mask);
            unsigned peers = __ballot_sync(0xffffffffu, valid);
#pragma unroll
            for (int b = 0; b < THRS_RS_MAX_WIDTH; ++b) {
                if (b < width) {
                    const bool set = (d >> b) & 1u;
                    const unsigned v = __ballot_sync(0xffffffffu, set);
                    peers &= set ? v : ~v;
                }
            }
            const int before = valid ? s_warp[warp][d] : 0;
            __syncwarp();
            if (valid && (peers >> lane) == 1u) {  // the highest peer
                s_warp[warp][d] = before + __popc(peers);
            }
            __syncwarp();
            rank[r] = before + __popc(peers & below);
        }
        __syncthreads();

        // (b) per digit: exclusive scan over the warps, and the chunk's count
        int cnt = 0;
        if (threadIdx.x < nb) {
#pragma unroll
            for (int w = 0; w < THRS_RS_WARPS; ++w) {
                const int v = s_warp[w][threadIdx.x];
                s_warp[w][threadIdx.x] = cnt;
                cnt += v;
            }
        }
        // (c) exclusive scan of the counts over the digits (nb <= threads)
        int inc = cnt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, inc, o);
            if (lane >= o) inc += v;
        }
        if (lane == 31) s_wsum[warp] = inc;
        __syncthreads();
        int start = inc - cnt;
        for (int w = 0; w < warp; ++w) start += s_wsum[w];
        if (threadIdx.x < nb) {
            s_start[threadIdx.x] = start;
            s_dest[threadIdx.x] = my_base + (Idx)(run - start);
            run += cnt;
        }
        __syncthreads();

        // (d) each word to its slot in the chunk's sorted order
#pragma unroll
        for (int r = 0; r < THRS_RS_ROUNDS; ++r) {
            const int e = first + r * 32;
            if (e < m) {
                const unsigned d = (unsigned)((key[r] >> shift) & mask);
                const int slot = s_start[d] + s_warp[warp][d] + rank[r];
                s_keys[slot] = key[r];
                s_off[slot] = (unsigned short)e;
            }
        }
        __syncthreads();

        // (e) slot j to its digit's run in the output: slot 0 of digit d
        // goes to base[t][d] plus the digit's count in the earlier chunks
        for (int j = threadIdx.x; j < m; j += THRS_RS_THREADS) {
            const Word k = s_keys[j];
            const Idx dest = s_dest[(unsigned)((k >> shift) & mask)] + j;
            bits_out[dest] = k;
            src[dest] = (Idx)(tile_begin + c0 + s_off[j]);
        }
        __syncthreads();
    }
}

template <typename Word, typename Idx>
static int launch(const void* bits, long long num_tiles, long long tile,
                  int shift, int width, const void* base, void* bits_out,
                  void* src, cudaStream_t stream) {
    rank_scatter_kernel<Word, Idx>
        <<<(unsigned int)num_tiles, THRS_RS_THREADS, 0, stream>>>(
            static_cast<const Word*>(bits), static_cast<const Idx*>(base),
            tile, shift, width, static_cast<Word*>(bits_out),
            static_cast<Idx*>(src));
    return (int)cudaGetLastError();
}

// Ranks and scatters `n` words of `word_bytes` (4 or 8) bytes at `bits`,
// whole tiles of `tile`, by the digit [shift, shift + width) (width 1-8),
// into `bits_out` (n words) and `src` (n indices of `idx_bytes`, 4 or 8),
// with `base` the device array of (n / tile) * 2**width offsets of
// `idx_bytes` each, on `stream`. Returns a cudaError_t as int: the launch is
// checked with cudaGetLastError(); a fault while the kernel runs shows at
// the next synchronisation.
extern "C" int thrs_rank_scatter(const void* bits, int word_bytes,
                                 long long n, int shift, int width,
                                 long long tile, const void* base,
                                 int idx_bytes, void* bits_out, void* src,
                                 void* stream) {
    const int nbits = word_bytes * 8;
    if ((word_bytes != 4 && word_bytes != 8) ||
        (idx_bytes != 4 && idx_bytes != 8) || n < 0 || tile < 1 ||
        n % tile != 0 || width < 1 || width > THRS_RS_MAX_WIDTH ||
        shift < 0 || shift + width > nbits ||
        (idx_bytes == 4 && n > 0x80000000ll) ||
        n / tile > 0x7FFFFFFFll) {
        return (int)cudaErrorInvalidValue;
    }
    if (n == 0) {
        return (int)cudaSuccess;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long T = n / tile;
    if (word_bytes == 4) {
        return idx_bytes == 4
                   ? launch<uint32_t, int>(bits, T, tile, shift, width, base,
                                           bits_out, src, s)
                   : launch<uint32_t, long long>(bits, T, tile, shift, width,
                                                 base, bits_out, src, s);
    }
    return idx_bytes == 4
               ? launch<unsigned long long, int>(bits, T, tile, shift, width,
                                                 base, bits_out, src, s)
               : launch<unsigned long long, long long>(
                     bits, T, tile, shift, width, base, bits_out, src, s);
}
