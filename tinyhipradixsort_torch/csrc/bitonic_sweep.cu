// One sweep of a bitonic sorting network over tuples of 32-bit words, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `make_sweep_kernel` (launched by
// `run_sweep`) in tinyhipradixsort_tpu/ops/bitonic_engine.py. It computes
// what `run_sweep_reference` in tinyhipradixsort_torch/ops/bitonic_engine.py
// computes; it is not the Pallas kernel carried over block by block.
//
// What a sweep is. The words are `nwords` arrays of equal length. A tuple
// is the element of every word at one index; tuples order lexicographically
// as unsigned on the first `ncmp` words, and the other words ride along.
// The sweep's tile covers the index bits [0, c) and [j_lo, j_lo + g): one
// block (CTA) owns the 2**g runs of 2**c contiguous elements at
//     a * 2**(j_lo+g) + e * 2**j_lo + b * 2**c,   e in [0, 2**g),
// for its (a, b). Each substage (k, j) compare-exchanges element i with
// partner i ^ 2**j (bit j lies in the tile), ascending iff bit k of i is 0
// or k is the sweep's `forced_asc` stage.
//
// What bounds it. A sweep reads and writes every word once: 2 * nwords * 4
// bytes per element of device memory, against ~3.35 TB/s on an H100 SXM.
// The design answers that by running many substages per round trip: the
// tile is loaded once into shared memory (up to ~200 KB of the 227 KB a
// block may use), every substage of the sweep runs there with a
// __syncthreads() between substages, and the tile is stored once. A local
// sweep at 2**15 one-word elements runs 120 substages per round trip.
// Shared-memory bandwidth and the per-substage barrier bound the local
// sweeps; wgmma, TMA and register-resident sorts are later work.
//
// Ties: a pair is swapped only when it is strictly out of order, so tied
// tuples never swap and every word of a tuple moves as a unit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (done at first use by ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define THRS_MAX_WORDS 56       // 2**10 elements * 4 B * 56 words fits 227 KB
#define THRS_MAX_SUBSTAGES 120  // a 2**15 tile holds 15 * 16 / 2 substages
#define THRS_MAX_SMEM 232448    // bytes of shared memory a block may opt into

struct SweepParams {
    uint32_t* words[THRS_MAX_WORDS];
    int nwords;
    int ncmp;
    int c;           // low chunk bits
    int g;           // high group bits
    int j_lo;        // global index bit of the first group bit (>= c)
    int forced_asc;  // stage k whose substages are always ascending; -1: none
    int nsub;
    unsigned char sub_k[THRS_MAX_SUBSTAGES];   // stage k (direction bit)
    unsigned char sub_fb[THRS_MAX_SUBSTAGES];  // tile-local bit of j
};

// Global element index of tile element t of block (a, b). 64-bit: padded
// sorts reach 2**32 elements.
__device__ __forceinline__ unsigned long long global_index(
        const SweepParams& p, unsigned long long a, unsigned long long b,
        unsigned int t) {
    const unsigned long long e = t >> p.c;
    const unsigned long long r = t & ((1u << p.c) - 1u);
    return (a << (p.j_lo + p.g)) | (e << p.j_lo) | (b << p.c) | r;
}

__global__ void bitonic_sweep_kernel(const SweepParams p) {
    extern __shared__ uint32_t tile_words[];  // word-major: [w][t]
    const unsigned int tile = 1u << (p.c + p.g);
    const unsigned int b_bits = p.j_lo - p.c;
    const unsigned long long bid = blockIdx.x;
    const unsigned long long b = bid & ((1ull << b_bits) - 1ull);
    const unsigned long long a = bid >> b_bits;

    for (unsigned int t = threadIdx.x; t < tile; t += blockDim.x) {
        const unsigned long long gi = global_index(p, a, b, t);
        for (int w = 0; w < p.nwords; ++w) {
            tile_words[w * tile + t] = p.words[w][gi];
        }
    }
    __syncthreads();

    const unsigned int half = tile >> 1;
    for (int s = 0; s < p.nsub; ++s) {
        const int k = p.sub_k[s];
        const unsigned int fb = p.sub_fb[s];
        const bool forced = (k == p.forced_asc);
        for (unsigned int q = threadIdx.x; q < half; q += blockDim.x) {
            // q with a zero inserted at bit fb: the pair's lower element
            const unsigned int lo =
                ((q >> fb) << (fb + 1)) | (q & ((1u << fb) - 1u));
            const unsigned int hi = lo | (1u << fb);
            const bool asc =
                forced || ((global_index(p, a, b, lo) >> k) & 1ull) == 0ull;
            int order = 0;  // -1: lo < hi, 1: lo > hi, 0: tie
            for (int w = 0; w < p.ncmp; ++w) {
                const uint32_t x = tile_words[w * tile + lo];
                const uint32_t y = tile_words[w * tile + hi];
                if (x != y) {
                    order = x < y ? -1 : 1;
                    break;
                }
            }
            if (asc ? order > 0 : order < 0) {
                for (int w = 0; w < p.nwords; ++w) {
                    const uint32_t x = tile_words[w * tile + lo];
                    tile_words[w * tile + lo] = tile_words[w * tile + hi];
                    tile_words[w * tile + hi] = x;
                }
            }
        }
        __syncthreads();
    }

    for (unsigned int t = threadIdx.x; t < tile; t += blockDim.x) {
        const unsigned long long gi = global_index(p, a, b, t);
        for (int w = 0; w < p.nwords; ++w) {
            p.words[w][gi] = tile_words[w * tile + t];
        }
    }
}

// Runs one sweep in place on `nwords` device arrays of `total` uint32 each
// (`total` a multiple of 2**(j_lo+g)), on `stream`. `sub_k`/`sub_fb` are
// host arrays of `nsub` substages. Returns a cudaError_t as int: the launch
// is checked with cudaGetLastError(); a fault while the kernel runs shows at
// the next synchronisation.
extern "C" int thrs_bitonic_sweep(void* const* words, int nwords, int ncmp,
                                  int c, int g, int j_lo, long long total,
                                  int forced_asc, const int* sub_k,
                                  const int* sub_fb, int nsub, void* stream) {
    if (nwords < 1 || nwords > THRS_MAX_WORDS || ncmp < 1 || ncmp > nwords ||
        nsub < 0 || nsub > THRS_MAX_SUBSTAGES || c < 0 || g < 0 ||
        j_lo < c || c + g < 1 || c + g > 15 || total <= 0 ||
        (total & ((1ll << (j_lo + g)) - 1)) != 0) {
        return (int)cudaErrorInvalidValue;
    }
    SweepParams p;
    for (int w = 0; w < nwords; ++w) {
        p.words[w] = static_cast<uint32_t*>(words[w]);
    }
    p.nwords = nwords;
    p.ncmp = ncmp;
    p.c = c;
    p.g = g;
    p.j_lo = j_lo;
    p.forced_asc = forced_asc;
    p.nsub = nsub;
    for (int s = 0; s < nsub; ++s) {
        p.sub_k[s] = (unsigned char)sub_k[s];
        p.sub_fb[s] = (unsigned char)sub_fb[s];
    }
    const int tile = 1 << (c + g);
    const size_t smem = (size_t)nwords * tile * sizeof(uint32_t);
    if (smem > THRS_MAX_SMEM) {
        return (int)cudaErrorInvalidValue;
    }
    const long long blocks = total >> (c + g);
    if (blocks > 0x7FFFFFFFll) {
        return (int)cudaErrorInvalidValue;
    }
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            bitonic_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) {
            return (int)err;
        }
    }
    const int threads = tile / 2 < 1024 ? tile / 2 : 1024;
    bitonic_sweep_kernel<<<(unsigned int)blocks, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(p);
    return (int)cudaGetLastError();
}
