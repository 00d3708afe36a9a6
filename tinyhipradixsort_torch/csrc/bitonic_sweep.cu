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
// or k is the sweep's `forced_asc` stage. Ties: a pair is swapped only when
// it is strictly out of order, so tied tuples never swap and every word of
// a tuple moves as a unit.
//
// What bounds it on an H100 SXM. A sweep reads and writes every word once:
// 2 * nwords * 4 bytes per element at 3.35 TB/s (0.641 ms for 2**28 one-word
// elements). Its compare work is two integer operations (min and max, or a
// compare and a select) per compare word per pair per substage, at 64 lanes
// per SM: 132 * 64 * 1.98 GHz = 16.7e12 a second. The first local sweep of
// 2**28 one-word keys (120 substages) needs 1.93 ms of that, more than its
// bytes; every other sweep is bound by its bytes. What the earlier body
// (below, `sweep_shared`) spent beyond that: every substage read and wrote
// the whole tile in shared memory and ended in a barrier, each pair rebuilt
// its 64-bit index to find its direction, and 1024 threads covered a 2**15
// tile; its time followed the substage count (~0.3 ms per substage per 2**28
// elements), not the bytes.
//
// Design (tuples of at most 8 words, `sweep_registers<NW>`). Each thread
// holds E elements of the tile in registers, v[NW][E]:
//     NW  1   2   3   4   5   6   7   8
//     E   64  32  32  16  16  16  8   8     (E * NW <= 96 data registers)
// so a block has tile / E threads: 512 at every planned tile (2**15, 2**14,
// 2**13 elements for 1, 3, 5 words), which lets ptxas give up to 128
// registers a thread (__launch_bounds__(512, 1)); ptxas reports no spills
// for any NW. At any moment r = log2 E of the tile's T index bits select the
// register slot and the other T - r bits come from the thread index, the
// lowest of them on the lanes. A substage whose bit is a register bit is a
// compare-exchange between two registers of one thread: no shared memory,
// no barrier. The host cuts the substages into runs, each a maximal stretch
// whose distinct bits number at most r: a thread holds the partners of only
// r bits, so a run cannot be longer. A run's register bits are its substage
// bits, completed with the highest free tile bits. Between runs the tile
// goes through shared memory once (store, barrier, load: a transpose), so a
// barrier serves a run of substages, not one. At 2**15 one-word tiles the
// first local sweep is 18 runs for 120 substages, a later local sweep 3 runs
// for 15, a cross sweep with g <= 8 one or two.
//
// Shared memory: the tile, nwords * 4 * 2**T bytes (as in the earlier body:
// 128, 192 and 160 KB for 1, 3 and 5 words), word-major, with the 5-bit
// groups of the index XOR-folded into the bank (t ^ ((t >> 5) ^ (t >> 10))
// & 31), so the lanes of a warp, which differ in the five lowest
// non-register bits, mostly hit distinct banks whichever bits the registers
// hold. Measured (chip_smoke.py phase 6, with and without it): without it
// the first local sweep of 2**28 keys takes 2.8x as long.
//
// Direction: the per-stage complement of the TPU kernel. At the start of a
// stage k, the compare words of every element whose index bit k is 1 are
// complemented (reversing unsigned order), every substage then runs
// ascending (for one word: umin/umax), and the complement is undone when
// the stage ends. Bit k of an element's position does not change within
// stage k (partners differ in a bit j < k), so the state survives
// transposes. The host says, per stage and run, whether bit k is a register
// bit, a thread-index bit or a bit of the block's base index; nothing is
// computed per pair.
//
// Global memory: the block copies its tile between device memory and
// shared memory in the canonical order (each warp reads and writes
// contiguous runs of 2**c words), and each thread takes its elements from
// shared memory into the first run's layout; the store mirrors it. That is
// the load form of the local sweeps (whose first run holds the low bits)
// and, because a thread that walked its device addresses with all its words
// live needed more than 128 registers, of the cross sweeps too: one shared
// memory pass each way, against loads straight into registers.
//
// Tuples of 9 to 56 words (rare: pytrees of payloads) take
// `sweep_shared`, the earlier body, unchanged. The choice is made on the
// host before the launch, from `nwords` alone. A sweep of at most 8 words
// that the register body cannot hold (a tile below E or above 512 * E
// elements, or a block spanning 2**32 elements or more) is refused:
// the planner makes none (tiles of 2**10 elements and up, capped for 7
// words by `_tile_bits_for`; fewer than 2**32 elements).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (done at first use by ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define THRS_MAX_WORDS 56       // 2**10 elements * 4 B * 56 words fits 227 KB
#define THRS_MAX_SUBSTAGES 120  // a 2**15 tile holds 15 * 16 / 2 substages
#define THRS_MAX_SMEM 232448    // bytes of shared memory a block may opt into
#define THRS_REG_WORDS 8        // widest tuple held in registers
#define THRS_THREADS 512        // threads of a register block at planned tiles

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
    // register body only, one word per substage (see plan_runs): the
    // register bit of sub_fb, whether a run starts there, and the direction
    // descriptors of the stage that ends and of the stage that starts
    unsigned int sub_op[THRS_MAX_SUBSTAGES];
    unsigned short sub_mask[THRS_MAX_SUBSTAGES];  // tile bits in registers
    unsigned int end_undo;
};

// kinds of direction descriptor: where an element's direction bit lies in
// the layout of the run (none: the stage is ascending or forced so)
enum { DIR_NONE = 0, DIR_REGISTER = 1, DIR_THREAD = 2, DIR_BLOCK = 3 };
#define OP_RUN 8u  // sub_op: a run starts at this substage

// ---------------------------------------------------------------------------
// Tuples of 9 to 56 words: the tile in shared memory
// ---------------------------------------------------------------------------

// Global element index of tile element t of block (a, b). 64-bit: padded
// sorts reach 2**32 elements.
__device__ __forceinline__ unsigned long long global_index(
        const SweepParams& p, unsigned long long a, unsigned long long b,
        unsigned int t) {
    const unsigned long long e = t >> p.c;
    const unsigned long long r = t & ((1u << p.c) - 1u);
    return (a << (p.j_lo + p.g)) | (e << p.j_lo) | (b << p.c) | r;
}

__global__ void sweep_shared(const SweepParams p) {
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

// ---------------------------------------------------------------------------
// Tuples of 1 to 8 words: the tile in registers
// ---------------------------------------------------------------------------

// log2 of the elements a thread holds, for NW words
__host__ __device__ constexpr int reg_bits(int nw) {
    return nw == 1 ? 6 : nw <= 3 ? 5 : nw <= 6 ? 4 : 3;
}

// bank swizzle of tile index t (a bijection on [0, 2**15))
__device__ __forceinline__ unsigned int swizzle(unsigned int t) {
    return t ^ (((t >> 5) ^ (t >> 10)) & 31u);
}

// P[i]: the tile bit (as a value) that register bit i stands for
template <int R>
__device__ __forceinline__ void register_bits(unsigned int mask,
                                              unsigned int (&P)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
        P[i] = mask & (0u - mask);
        mask ^= P[i];
    }
}

// tile index of slot 0 of this thread: the thread index with a zero bit
// inserted at each register bit P[i] (in ascending order)
template <int R>
__device__ __forceinline__ unsigned int thread_base(
        const unsigned int (&P)[R]) {
    unsigned int x = threadIdx.x;
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const unsigned int low = x & (P[i] - 1u);
        x = ((x ^ low) << 1) | low;
    }
    return x;
}

// The slots are visited in Gray-code order: slot s ^ (s >> 1) at step s,
// so consecutive slots differ in one register bit, low_bit(s). A slot's
// shared-memory index (swizzle included) and its global index are linear
// over XOR in its bits, so each address is the last one XOR one value.
__host__ __device__ constexpr int low_bit(int s) {
    int i = 0;
    while (!((s >> i) & 1)) {
        ++i;
    }
    return i;
}

// Store (TO_SHARED) or load the tile held in the layout whose register
// bits are `mask` to or from shared memory.
template <int NW, int R, bool TO_SHARED>
__device__ __forceinline__ void shared_copy(uint32_t (&v)[NW][1 << R],
                                            uint32_t* sm,
                                            const SweepParams& p,
                                            unsigned int mask) {
    constexpr int E = 1 << R;
    const unsigned int tile = 1u << (p.c + p.g);
    unsigned int Q[R];
    register_bits<R>(mask, Q);
    unsigned int at = swizzle(thread_base<R>(Q));
#pragma unroll
    for (int i = 0; i < R; ++i) {
        Q[i] = swizzle(Q[i]);
    }
#pragma unroll
    for (int s = 0; s < E; ++s) {
        if (s) {
            at ^= Q[low_bit(s)];
        }
#pragma unroll
        for (int w = 0; w < NW; ++w) {
            if constexpr (TO_SHARED) {
                sm[w * tile + at] = v[w][s ^ (s >> 1)];
            } else {
                v[w][s ^ (s >> 1)] = sm[w * tile + at];
            }
        }
    }
}

// Move the tile from the layout whose register bits are `from` into the
// one whose register bits are `to`, through shared memory.
template <int NW, int R>
__device__ __forceinline__ void transpose(uint32_t (&v)[NW][1 << R],
                                          uint32_t* sm, const SweepParams& p,
                                          unsigned int from, unsigned int to) {
    __syncthreads();  // every thread is done reading the last transpose
    shared_copy<NW, R, true>(v, sm, p, from);
    __syncthreads();
    shared_copy<NW, R, false>(v, sm, p, to);
}

// global index of the first element of this block's tile
__device__ __forceinline__ unsigned long long block_base(
        const SweepParams& p) {
    const unsigned int b_bits = p.j_lo - p.c;
    const unsigned long long bid = blockIdx.x;
    return ((bid >> b_bits) << (p.j_lo + p.g)) |
           ((bid & ((1ull << b_bits) - 1ull)) << p.c);
}

// Copy the tile from device memory to shared memory (STORE false) or back,
// in the canonical layout, R register bits at a time: slot s of thread tid
// is tile element t = tid + s * 2**(T - R), at shared index swizzle(t). A
// slot's global index is the thread's slot 0 plus a 32-bit offset (a block
// spans < 2**32 elements), so a word needs one 64-bit pointer and a slot a
// 32-bit XOR for each index.
template <int NW, int R, bool STORE>
__device__ __forceinline__ void global_copy(uint32_t* sm,
                                            const SweepParams& p) {
    constexpr int E = 1 << R;
    const int tshift = p.c + p.g - R;
    const unsigned int tile = 1u << (p.c + p.g);
    unsigned int D[R];  // global index offset of slot bit i
    unsigned int S[R];  // shared index offset of slot bit i
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int tb = tshift + i;
        D[i] = 1u << (tb < p.c ? tb : p.j_lo + (tb - p.c));
        S[i] = swizzle(1u << tb);
    }
    const unsigned int tid = threadIdx.x;
    const unsigned long long g0 = block_base(p) |
        ((unsigned long long)(tid >> p.c) << p.j_lo) |
        (tid & ((1u << p.c) - 1u));
#pragma unroll
    for (int w = 0; w < NW; ++w) {
        uint32_t* const base = p.words[w] + g0;
        uint32_t* const row = sm + w * tile;
        unsigned int off = 0, at = swizzle(tid);
#pragma unroll
        for (int s = 0; s < E; ++s) {
            if (s) {
                off ^= D[low_bit(s)];
                at ^= S[low_bit(s)];
            }
            if constexpr (STORE) {
                base[off] = row[at];
            } else {
                row[at] = base[off];
            }
        }
    }
}

// complement the compare words of the slots whose register bit ri is 1
template <int NW, int R, int RI = 0>
__device__ __forceinline__ void complement_bit(uint32_t (&v)[NW][1 << R],
                                               int ri, int ncmp) {
    if constexpr (RI < R) {
        if (ri != RI) {
            complement_bit<NW, R, RI + 1>(v, ri, ncmp);
            return;
        }
#pragma unroll
        for (int s = 0; s < (1 << R); ++s) {
#pragma unroll
            for (int w = 0; w < NW; ++w) {
                if ((s & (1 << RI)) && w < ncmp) {
                    v[w][s] = ~v[w][s];
                }
            }
        }
    }
}

// XOR-complement the compare words of every element whose direction bit
// is 1. `desc` says where that bit lies: register bit, bit of the thread
// index, or bit of the global index of the block's tile.
template <int NW, int R>
__device__ __forceinline__ void direction(uint32_t (&v)[NW][1 << R],
                                          const SweepParams& p,
                                          unsigned int desc) {
    const unsigned int kind = desc >> 6, bit = desc & 63u;
    if (kind == DIR_NONE) {
        return;
    }
    if (kind == DIR_REGISTER) {
        complement_bit<NW, R>(v, bit, p.ncmp);
        return;
    }
    const unsigned int m =
        kind == DIR_THREAD
            ? 0u - ((threadIdx.x >> bit) & 1u)
            : 0u - (unsigned int)((block_base(p) >> bit) & 1ull);
#pragma unroll
    for (int s = 0; s < (1 << R); ++s) {
#pragma unroll
        for (int w = 0; w < NW; ++w) {
            if (w < p.ncmp) {
                v[w][s] ^= m;
            }
        }
    }
}

// Ascending compare-exchange of every slot pair that differs in register
// bit RI, on the first NC words; a pair swaps only when strictly out of
// order.
template <int NW, int R, int RI, int NC>
__device__ __forceinline__ void compare_exchange(uint32_t (&v)[NW][1 << R]) {
    constexpr int E = 1 << R;
    constexpr int d = 1 << RI;
#pragma unroll
    for (int s = 0; s < E; ++s) {
        if (s & d) {
            continue;
        }
        if constexpr (NW == 1) {
            const uint32_t x = v[0][s], y = v[0][s + d];
            v[0][s] = min(x, y);
            v[0][s + d] = max(x, y);
        } else {
            bool lt = false;  // tuple s + d < tuple s
#pragma unroll
            for (int w = NC - 1; w >= 0; --w) {
                const uint32_t x = v[w][s], y = v[w][s + d];
                lt = y < x || (y == x && lt);
            }
            // an XOR swap updates both words in place: selects leave the
            // pair in other registers, which the loop then moves back
            const uint32_t m = 0u - (uint32_t)lt;
#pragma unroll
            for (int w = 0; w < NW; ++w) {
                const uint32_t t = (v[w][s] ^ v[w][s + d]) & m;
                v[w][s] ^= t;
                v[w][s + d] ^= t;
            }
        }
    }
}

// compare_exchange at the run-time register bit ri and compare word count
// ncmp: every register index must stay a compile-time constant, or v goes
// to local memory, and a constant word count keeps the compare chain free
// of guards (with them, 3-word tuples spilled)
template <int NW, int R, int RI = 0, int NC = 1>
__device__ __forceinline__ void compare_exchange_at(uint32_t (&v)[NW][1 << R],
                                                    int ri, int ncmp) {
    if constexpr (RI < R && NC <= NW) {
        if (ri != RI) {
            compare_exchange_at<NW, R, RI + 1, NC>(v, ri, ncmp);
        } else if (ncmp != NC) {
            compare_exchange_at<NW, R, RI, NC + 1>(v, ri, ncmp);
        } else {
            compare_exchange<NW, R, RI, NC>(v);
        }
    }
}

template <int NW>
__global__ void __launch_bounds__(THRS_THREADS, 1)
sweep_registers(const SweepParams p) {
    constexpr int R = reg_bits(NW);
    constexpr int E = 1 << R;
    extern __shared__ uint32_t sm[];  // word-major [w][swizzle(t)]

    // device memory -> shared memory -> the first run's layout (see the
    // header for why the load goes through shared memory)
    uint32_t v[NW][E];
    global_copy<NW, R, false>(sm, p);
    __syncthreads();
    shared_copy<NW, R, false>(v, sm, p, p.sub_mask[0]);
    // Besides v, only the substage counter stays live across substages:
    // each substage's work is one word of p, and the layouts, the tile size
    // and the block's base index are read from p where they are needed
    // (kept live, they made ptxas spill at the 128-register limit)
    for (int s = 0; s < p.nsub; ++s) {
        const unsigned int op = p.sub_op[s];
        if (op & OP_RUN) {
            transpose<NW, R>(v, sm, p, p.sub_mask[s - 1], p.sub_mask[s]);
        }
        direction<NW, R>(v, p, (op >> 8) & 255u);
        direction<NW, R>(v, p, op >> 16);
        compare_exchange_at<NW, R>(v, op & 7u, p.ncmp);
    }
    direction<NW, R>(v, p, p.end_undo);
    __syncthreads();
    const int last = p.nsub ? p.nsub - 1 : 0;
    shared_copy<NW, R, true>(v, sm, p, p.sub_mask[last]);
    __syncthreads();
    global_copy<NW, R, true>(sm, p);
}

// Where the direction bit of stage k (-1: none) lies in the layout whose
// register bits are `mask`, as a descriptor for direction().
static unsigned char direction_of(const SweepParams& p, int k,
                                  unsigned int mask) {
    if (k < 0 || k == p.forced_asc) {
        return DIR_NONE;
    }
    int tb;  // tile bit of global index bit k
    if (k < p.c) {
        tb = k;
    } else if (k >= p.j_lo && k < p.j_lo + p.g) {
        tb = p.c + (k - p.j_lo);
    } else {
        return (unsigned char)(DIR_BLOCK << 6 | k);
    }
    const unsigned int below = (1u << tb) - 1u;
    if (mask & (1u << tb)) {
        return (unsigned char)(DIR_REGISTER << 6 |
                               __builtin_popcount(mask & below));
    }
    const unsigned int free = ((1u << (p.c + p.g)) - 1u) & ~mask;
    return (unsigned char)(DIR_THREAD << 6 | __builtin_popcount(free & below));
}

// Cut the substages into runs of at most r distinct tile bits and give each
// run its register bits: its own, completed with the highest free bits.
// Then give each substage its register bit and the direction descriptors
// of a stage that ends and a stage that starts before it, in its run's
// layout.
static void plan_runs(SweepParams& p, int r) {
    const int T = p.c + p.g;
    unsigned int bits = 0;
    int first = 0;  // first substage of the open run
    for (int s = 0; s <= p.nsub; ++s) {
        const unsigned int fb = s < p.nsub ? 1u << p.sub_fb[s] : 0u;
        if (s == p.nsub ? s > 0
                        : !(bits & fb) && __builtin_popcount(bits) == r) {
            for (int t = T - 1; __builtin_popcount(bits) < r; --t) {
                bits |= 1u << t;
            }
            for (; first < s; ++first) {
                p.sub_mask[first] = (unsigned short)bits;
            }
            bits = 0;
        }
        bits |= fb;
    }
    if (p.nsub == 0) {  // the kernel still loads and stores the tile
        const unsigned int all = (1u << T) - 1u;
        p.sub_mask[0] = (unsigned short)(all & ~(all >> r));
    }
    int prev_k = -1;
    for (int s = 0; s < p.nsub; ++s) {
        const unsigned int m = p.sub_mask[s];
        const int k = p.sub_k[s];
        unsigned int op = __builtin_popcount(m & ((1u << p.sub_fb[s]) - 1u));
        if (s && m != p.sub_mask[s - 1]) {
            op |= OP_RUN;
        }
        if (k != prev_k) {
            op |= (unsigned int)direction_of(p, prev_k, m) << 8 |
                  (unsigned int)direction_of(p, k, m) << 16;
        }
        p.sub_op[s] = op;
        prev_k = k;
    }
    p.end_undo =
        direction_of(p, prev_k, p.nsub ? p.sub_mask[p.nsub - 1] : 0u);
}

template <typename Kernel>
static cudaError_t launch(Kernel kernel, const SweepParams& p,
                          long long blocks, int threads, size_t smem,
                          cudaStream_t stream) {
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) {
            return err;
        }
    }
    kernel<<<(unsigned int)blocks, threads, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int NW>
static cudaError_t launch_registers(SweepParams& p, long long blocks,
                                    size_t smem, cudaStream_t stream) {
    plan_runs(p, reg_bits(NW));
    const int threads = (1 << (p.c + p.g)) >> reg_bits(NW);
    return launch(sweep_registers<NW>, p, blocks, threads, smem, stream);
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
        if (sub_k[s] < 0 || sub_k[s] > 63 || sub_fb[s] < 0 ||
            sub_fb[s] >= c + g) {
            return (int)cudaErrorInvalidValue;
        }
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
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (nwords <= THRS_REG_WORDS) {
        if (c + g < reg_bits(nwords) ||
            (tile >> reg_bits(nwords)) > THRS_THREADS || j_lo + g > 32) {
            return (int)cudaErrorInvalidValue;
        }
        switch (nwords) {
            case 1: return (int)launch_registers<1>(p, blocks, smem, st);
            case 2: return (int)launch_registers<2>(p, blocks, smem, st);
            case 3: return (int)launch_registers<3>(p, blocks, smem, st);
            case 4: return (int)launch_registers<4>(p, blocks, smem, st);
            case 5: return (int)launch_registers<5>(p, blocks, smem, st);
            case 6: return (int)launch_registers<6>(p, blocks, smem, st);
            case 7: return (int)launch_registers<7>(p, blocks, smem, st);
            default: return (int)launch_registers<8>(p, blocks, smem, st);
        }
    }
    const int threads = tile / 2 < 1024 ? tile / 2 : 1024;
    return (int)launch(sweep_shared, p, blocks, threads, smem, st);
}
