// Stable rank within a tile and scatter, stage 3 of the counting engine's
// pass, for NVIDIA Hopper (sm_90a): the reference's `reorderKey` and
// `reorderKeyPair` (kernel.cu:206-429), which move the key bits and, in the
// same kernel, up to four payload rows to the same destinations.
//
// Replaces no TPU kernel: the JAX package writes this stage in jnp, as a
// one-hot cumulative sum under `lax.map` followed by gathers of every array
// by the inverse permutation (tinyhipradixsort_tpu/ops/counting_engine.py:
// 35-59), because the TPU has no shared-memory atomics, warp ballots or
// vectorized scatter. Hopper has them, so this kernel ranks as the
// reference does. It computes what `rank_scatter_reference` in
// tinyhipradixsort_torch/ops/counting_engine.py computes, bit for bit.
//
// What it computes. `bits` holds n words (u32 or u64), `rows` rows of whole
// tiles of `tile`; the digit of a word is (word >> shift) & (2**width - 1),
// width 1-8. Element i of tile t with digit d goes to
//     dest = base[t][d] + (elements of tile t before i with digit d),
// where `base` is the (n / tile, 2**width) output of stage 2 (each row's
// bucket-major exclusive scan, the row's start added). The kernel writes
// bits_out[dest] = bits[i], src[dest] = i when `src` is asked for (the
// inverse permutation, out = x[src], in int32 or int64), and
// payload_out[k][dest] = payload_in[k][i] for each payload: rows of 1, 2,
// 4, 8 or 16 bytes.
//
// What bounds it. Every word and every payload row is read once and
// written once, `base` is read once and `src` written once if it is asked
// for. The counting sort_keys pass at 2**28 u32 (tile 2048, width 8, the
// bits alone) moves 1.074 x 2 + 0.134 = 2.282 GB, 0.681 ms at 3.35 TB/s
// on an H100 SXM; the sort_pairs pass (one 4-byte payload) 4.429 GB, 1.32
// ms; bits + src 3.355 GB, 1.00 ms. The ranking is some 30 integer
// operations a word, 0.48 ms at 2**28: bytes set the bound.
//
// The design. Every output stream is scattered in runs: the words of one
// digit that a chunk sends to consecutive places. A run that ends inside a
// 32-byte sector leaves it partly written, and an H100 pays for each such
// sector unless L2 merges it with the neighbouring chunk's half before it
// is evicted; measured on an H100, the cost of a stream follows its runs
// more than its bytes (PERF.md). So the kernel makes runs long, and has
// the chunks that share sectors written close together in time:
// - a chunk is 32 KB of words (8192 u32, 4096 u64), so a digit's run is
//   about 128 bytes at width 8 (2048-word chunks gave 32-byte runs). Where
//   a tile is shorter, a chunk takes several consecutive tiles of one row:
//   inside a row stage 2's scan gives base[t+1][d] = base[t][d] +
//   count[t][d], so ranking them together from base[t0] gives the same
//   destinations. A chunk never crosses a row. Where a tile is longer, the
//   block walks it chunk by chunk and carries a running count a digit;
// - blocks are persistent (512 threads) and take segments (a chunk's
//   tiles, or one long tile) in order from a counter, so the blocks at work
//   hold neighbouring segments, whose runs of a digit meet;
// - two blocks run on each SM where both fit, each on its own chunk. A
//   chunk passes through phases with a barrier between them: the ranking
//   (16 dependent rounds a warp through shared memory), the scans over the
//   warps and over the digits, the offsets, and the writes. With one block
//   on an SM, memory waited through all but the writes: a chunk took 8.1 us
//   on an H100 against the 2.6 us that an SM's share of the card's
//   bandwidth needs for its 64 KB. Two blocks a SM, in different phases,
//   overlap one's barriers and ranking with the other's stores: 6.1 us a
//   chunk a SM, the sort_keys pass at 2**28 2.00 -> 1.52 ms (PERF.md). The
//   kernel is bounded to 64 registers a thread (`__launch_bounds__(512,
//   2)`; ptxas spills nothing), and the bits alone take about 107 KB of
//   shared memory a block, of the SM's 228 KB. The launch takes the blocks
//   a SM from the occupancy of the shared memory it asks for: a staged
//   payload leaves room for one block, which measured faster than two
//   reading the payload from L2 (2.57-2.67 against 4.14-4.35 ms for the
//   sort_pairs pass). A warp-specialised ring in one block (8 warps ranking
//   chunk i+1 while 8 write chunk i) took 1.95-2.08 ms on the bits alone;
// - each block has the next chunk's words in flight while it ranks
//   (`cp.async` into the other half of a double buffer in dynamic shared
//   memory), and the next chunk's payload rows are asked of L2
//   (`cp.async.bulk.prefetch.L2`). The chunk's payload rows are copied into
//   shared memory (`cp.async`, coalesced) while the block ranks, as many
//   payloads as fit THRS_RS_STAGE_BYTES; the others are read from L2;
// - once a chunk's runs are known, L2 is asked for the lines at both ends
//   of each run in every stream (`prefetch.global.L2`), the sectors a run
//   shares with its neighbours, before the chunk is written.
// In a chunk, warp w ranks its consecutive words in rounds of 32, a lane a
// word. A word's peers in its round (the lanes with its digit) are the
// bits that each lane ORs into the warp's mask of its digit in shared
// memory (the reference matches with `width` ballots, kernel.cu:293-345;
// the mask takes two shared-memory operations a word in place of eight
// ballots, and measured faster than both the ballots and
// __match_any_sync). Its rank in the warp is the popcount of its
// lower-lane peers plus the warp's count of that digit, which the highest
// peer then advances (and clears the mask): a digit has one writer a
// round, and the rank follows the words' order (an atomicAdd rank would
// not be stable). Exclusive scans of each digit's counts over the warps
// and of the chunk's counts over the digits give each warp its first slot
// of each digit in the chunk's sorted order (the digit's start folded into
// the warp's count, so a word's slot is one shared load and its rank),
// where the word's offset in the chunk is placed. Then
// thread j writes slot j of each stream to
//     base[t0][d] + running[d] + (j - chunk_start[d]),
// the word from the buffer, src from its offset, each payload row through
// its offset from shared memory or L2 (16-byte rows as one vector load and
// store).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (done at first use by ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define THRS_RS_THREADS 512
#define THRS_RS_WARPS (THRS_RS_THREADS / 32)
#define THRS_RS_CHUNK_BYTES 32768  // a chunk of words: 8192 u32, 4096 u64
#define THRS_RS_MAX_WIDTH 8
#define THRS_RS_BUCKETS (1 << THRS_RS_MAX_WIDTH)
#define THRS_RS_MAX_PAYLOADS 4

// one payload as the C interface takes it: rows of `row_bytes` (1, 2, 4, 8
// or 16) bytes at `src`, moved to `dst`
struct thrs_rs_payload {
    const void* src;
    void* dst;
    long long row_bytes;
};

struct Payloads {
    thrs_rs_payload p[THRS_RS_MAX_PAYLOADS];
    // where each payload's rows of the chunk are staged in shared memory
    // (bytes after Smem), or -1: read from L2
    int stage[THRS_RS_MAX_PAYLOADS];
    int count;
};

// payload bytes of a chunk that a block stages in shared memory, at most
#define THRS_RS_STAGE_BYTES (96 * 1024)

template <typename Word>
struct Chunk {
    static constexpr int WORDS = THRS_RS_CHUNK_BYTES / (int)sizeof(Word);
    static constexpr int ROUNDS = WORDS / THRS_RS_THREADS;  // per warp
};

template <typename Word, typename Idx>
struct __align__(16) Smem {  // the staged rows follow it
    Word in[2][Chunk<Word>::WORDS];  // this chunk and the next, in flight
    Idx base[2][THRS_RS_BUCKETS];    // their segments' base rows
    unsigned match[THRS_RS_WARPS][THRS_RS_BUCKETS];  // a round's peers
    // a digit's count in each warp; then the warp's first slot of it
    unsigned short warp_cnt[THRS_RS_WARPS][THRS_RS_BUCKETS];
    Idx dest[THRS_RS_BUCKETS];  // output of slot 0 per digit, minus start
    int wsum[THRS_RS_WARPS];
    int ticket;  // the block's segment after the one it fetches
    unsigned short off[Chunk<Word>::WORDS];  // offsets, in sorted order
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// one 4- or 8-byte element
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* smem, const T* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(sizeof(T))
                 : "memory");
}

// waits for every group but the newest n
template <int n>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p, unsigned bytes) {
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p),
                 "r"(bytes)
                 : "memory");
}

// L2 is asked for the lines that hold element `lo` and element `hi` of
// `out` (rows of `rb` bytes): the ends of a digit's run, whose sectors the
// run shares with the neighbouring chunks' runs. Asked for before the
// chunk is written, they are in L2 when the partial writes come (measured
// faster where a call writes three streams or more; PERF.md).
__device__ __forceinline__ void prefetch_ends(const void* out, long long rb,
                                              long long lo, long long hi) {
    const char* o = static_cast<const char*>(out);
    asm volatile("prefetch.global.L2 [%0];" ::"l"(o + lo * rb));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(o + hi * rb));
}

// a block's unit of work: `len` words of one row from tile `t0` on (one
// tile walked in chunks, or several tiles that fit one chunk)
struct Segment {
    long long t0;
    long long len;
};

__device__ __forceinline__ Segment segment(int s, int tiles_per_row,
                                           int per_seg, int segs_per_row,
                                           long long tile) {
    const int r = s / segs_per_row;
    const int t = (s - r * segs_per_row) * per_seg;
    const int nt = min(per_seg, tiles_per_row - t);
    return {(long long)r * tiles_per_row + t, (long long)nt * tile};
}

// the chunk of `m` words at `from` into `to`, 16 bytes a copy (m is a
// multiple of 128 and both addresses are 16-byte aligned)
template <typename Word>
__device__ __forceinline__ void load_chunk(Word* to, const Word* from,
                                           int m) {
    const int pieces = m * (int)sizeof(Word) / 16;
    for (int p = threadIdx.x; p < pieces; p += THRS_RS_THREADS) {
        cp_async16(reinterpret_cast<char*>(to) + 16 * p,
                   reinterpret_cast<const char*>(from) + 16 * p);
    }
}

// thread q < count asks L2 for payload q's rows of the m words at `at`
__device__ __forceinline__ void prefetch_rows(const Payloads& pl,
                                             long long at, int m) {
#pragma unroll
    for (int q = 0; q < THRS_RS_MAX_PAYLOADS; ++q) {
        if (q < pl.count && (int)threadIdx.x == q) {
            const thrs_rs_payload& p = pl.p[q];
            prefetch_l2(static_cast<const char*>(p.src) + at * p.row_bytes,
                        (unsigned)(m * p.row_bytes));
        }
    }
}

// the staged payloads' rows of the chunk of m words at `at` into their
// places after Smem (m rows: a multiple of 16 bytes)
__device__ __forceinline__ void stage_rows(const Payloads& pl,
                                           unsigned char* stage, long long at,
                                           int m) {
#pragma unroll
    for (int q = 0; q < THRS_RS_MAX_PAYLOADS; ++q) {
        if (q < pl.count && pl.stage[q] >= 0) {
            const int rb = (int)pl.p[q].row_bytes;
            const char* from = static_cast<const char*>(pl.p[q].src) + at * rb;
            for (int i = threadIdx.x; i < m * rb / 16;
                 i += THRS_RS_THREADS) {
                cp_async16(stage + pl.stage[q] + 16 * i, from + 16 * i);
            }
        }
    }
}

// slot j's payload row (read through its offset in the chunk, from the
// rows staged in shared memory or from L2) to its destination, for every
// slot of the chunk
template <typename Row, typename Word, typename Idx>
__device__ __forceinline__ void move_rows(const thrs_rs_payload& p,
                                          const Row* staged, long long at,
                                          int m, const Smem<Word, Idx>& sm,
                                          const Word* in, int shift,
                                          Word mask) {
    const Row* from = static_cast<const Row*>(p.src) + at;
    Row* to = static_cast<Row*>(p.dst);
#pragma unroll(sizeof(Row) == 16 ? 2 : 4)
    for (int j = threadIdx.x; j < m; j += THRS_RS_THREADS) {
        const int e = sm.off[j];
        const Idx dest = sm.dest[(unsigned)((in[e] >> shift) & mask)] + j;
        to[dest] = staged != nullptr ? staged[e] : __ldg(from + e);
    }
}

// the chunk at word `at` of m words into buffer `b`, its payload rows
// asked of L2, and, when it starts a segment at tile t0, the segment's base
// row; the caller commits the group
template <typename Word, typename Idx>
__device__ __forceinline__ void fetch(Smem<Word, Idx>& sm, int b,
                                      const Word* bits, const Idx* base,
                                      const Payloads& pl, long long at, int m,
                                      bool first, long long t0, int nb) {
    load_chunk(sm.in[b], bits + at, m);
    prefetch_rows(pl, at, m);
    if (first && (int)threadIdx.x < nb) {
        cp_async_elem(&sm.base[b][threadIdx.x], base + t0 * nb + threadIdx.x);
    }
}

template <typename Word, typename Idx>
__global__ void __launch_bounds__(THRS_RS_THREADS, 2)
rank_scatter_kernel(const Word* __restrict__ bits,
                    const Idx* __restrict__ base, long long tile,
                    int tiles_per_row, int per_seg, int segs_per_row,
                    int nseg, int shift, int width,
                    Word* __restrict__ bits_out, Idx* __restrict__ src,
                    const Payloads pl, int* __restrict__ tickets) {
    constexpr int CHUNK = Chunk<Word>::WORDS;
    constexpr int ROUNDS = Chunk<Word>::ROUNDS;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem<Word, Idx>& sm = *reinterpret_cast<Smem<Word, Idx>*>(smem_raw);
    unsigned char* stage = smem_raw + sizeof(Smem<Word, Idx>);

    const int nb = 1 << width;
    const Word mask = (Word)(nb - 1);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const unsigned below = (1u << lane) - 1u;

    for (int i = tid; i < THRS_RS_WARPS * THRS_RS_BUCKETS;
         i += THRS_RS_THREADS) {
        (&sm.match[0][0])[i] = 0u;  // each round's highest peer clears it
    }
    int s = blockIdx.x;  // the segment, and the chunk k of it
    int k = 0;
    {
        const Segment cur =
            segment(s, tiles_per_row, per_seg, segs_per_row, tile);
        fetch(sm, 0, bits, base, pl, cur.t0 * tile,
              (int)min((long long)CHUNK, cur.len), true, cur.t0, nb);
    }
    cp_async_commit();
    // Segments after the first are handed out in order from `tickets`, so
    // the blocks at work hold neighbouring segments, whose runs of a digit
    // meet in the output: both halves of a sector they share are written
    // close together in time, while L2 holds it.
    if (tid == 0) sm.ticket = (int)gridDim.x + atomicAdd(tickets, 1);
    __syncthreads();
    int after = sm.ticket;  // the block's segment after s
    // thread d < nb owns digit d: base[t0][d] plus the digit's count in the
    // segment's earlier chunks
    Idx acc = 0;
    for (int step = 0;; ++step) {
        const Segment cur =
            segment(s, tiles_per_row, per_seg, segs_per_row, tile);
        const long long c0 = (long long)k * CHUNK;
        const int m = (int)min((long long)CHUNK, cur.len - c0);
        const int b = step & 1;
        const Word* in = sm.in[b];
        // this chunk's staged payload rows (asked of L2 a step ago), waited
        // for only after the ranking
        stage_rows(pl, stage, cur.t0 * tile + c0, m);
        cp_async_commit();
        // the next chunk: the rest of this segment, or the block's next one
        const bool same = c0 + CHUNK < cur.len;
        const int ns = same ? s : after;
        const bool more = ns < nseg;
        if (more) {
            const Segment nxt =
                same ? cur
                     : segment(ns, tiles_per_row, per_seg, segs_per_row, tile);
            const long long nc0 = same ? c0 + CHUNK : 0;
            fetch(sm, b ^ 1, bits, base, pl, nxt.t0 * tile + nc0,
                  (int)min((long long)CHUNK, nxt.len - nc0), !same, nxt.t0,
                  nb);
        }
        cp_async_commit();
        const bool draw = more && !same;  // ns is a new segment: the next
        if (draw && tid == 0) {
            sm.ticket = (int)gridDim.x + atomicAdd(tickets, 1);
        }
        if (tid < nb) {
#pragma unroll
            for (int w = 0; w < THRS_RS_WARPS; ++w) sm.warp_cnt[w][tid] = 0;
        }
        cp_async_wait<2>();  // this chunk's words (fetched a step ago)
        __syncthreads();
        if (draw) after = sm.ticket;

        // (a) rank of each word among its digit's words in its warp
        const int first = warp * (ROUNDS * 32) + lane;
        // ranks are below a warp's words (512): two a register
        unsigned rank2[ROUNDS / 2];
#pragma unroll
        for (int r = 0; r < ROUNDS; ++r) {
            const int e = first + r * 32;
            const bool valid = e < m;
            const unsigned d =
                valid ? (unsigned)((in[e] >> shift) & mask) : 0u;
            if (valid) atomicOr(&sm.match[warp][d], 1u << lane);
            __syncwarp();
            const unsigned peers = valid ? sm.match[warp][d] : 0u;
            const int before = valid ? sm.warp_cnt[warp][d] : 0;
            __syncwarp();
            if (valid && (peers >> lane) == 1u) {  // the highest peer
                sm.warp_cnt[warp][d] =
                    (unsigned short)(before + __popc(peers));
                sm.match[warp][d] = 0u;
            }
            __syncwarp();
            const unsigned rank = before + __popc(peers & below);
            rank2[r / 2] = r % 2 ? rank2[r / 2] | (rank << 16) : rank;
        }
        __syncthreads();

        // (b) per digit: exclusive scan over the warps, and the chunk's count
        int cnt = 0;
        if (tid < nb) {
#pragma unroll
            for (int w = 0; w < THRS_RS_WARPS; ++w) {
                const int v = sm.warp_cnt[w][tid];
                sm.warp_cnt[w][tid] = (unsigned short)cnt;
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
        if (lane == 31) sm.wsum[warp] = inc;
        __syncthreads();
        int start = inc - cnt;
        for (int w = 0; w < warp; ++w) start += sm.wsum[w];
        if (tid < nb) {
            if (k == 0) acc = sm.base[b][tid];
#pragma unroll
            for (int w = 0; w < THRS_RS_WARPS; ++w) {
                sm.warp_cnt[w][tid] =
                    (unsigned short)(sm.warp_cnt[w][tid] + start);
            }
            sm.dest[tid] = acc - (Idx)start;
            if (cnt > 0) {
                const long long lo = (long long)acc, hi = lo + cnt - 1;
                prefetch_ends(bits_out, sizeof(Word), lo, hi);
                if (src != nullptr) prefetch_ends(src, sizeof(Idx), lo, hi);
#pragma unroll
                for (int q = 0; q < THRS_RS_MAX_PAYLOADS; ++q) {
                    if (q < pl.count) {
                        prefetch_ends(pl.p[q].dst, pl.p[q].row_bytes, lo, hi);
                    }
                }
            }
            acc += (Idx)cnt;
        }
        __syncthreads();

        // (d) each word's offset to its slot in the chunk's sorted order
#pragma unroll
        for (int r = 0; r < ROUNDS; ++r) {
            const int e = first + r * 32;
            if (e < m) {
                const unsigned d = (unsigned)((in[e] >> shift) & mask);
                const int rank = (rank2[r / 2] >> (16 * (r % 2))) & 0xFFFFu;
                const int slot = sm.warp_cnt[warp][d] + rank;
                sm.off[slot] = (unsigned short)e;
            }
        }
        cp_async_wait<1>();  // this chunk's staged payload rows
        __syncthreads();

        // the chunk's first word (recomputed: a register less through the
        // ranking)
        const long long at =
            segment(s, tiles_per_row, per_seg, segs_per_row, tile).t0 * tile +
            (long long)k * CHUNK;
        // (e) slot j to its digit's run in the output: slot 0 of digit d
        // goes to base[t0][d] plus the digit's count in the earlier chunks
        for (int j = tid; j < m; j += THRS_RS_THREADS) {
            const int e = sm.off[j];
            const Word k = in[e];
            const Idx dest = sm.dest[(unsigned)((k >> shift) & mask)] + j;
            bits_out[dest] = k;
            if (src != nullptr) src[dest] = (Idx)(at + e);
        }
#pragma unroll
        for (int q = 0; q < THRS_RS_MAX_PAYLOADS; ++q) {
            if (q >= pl.count) break;
            const thrs_rs_payload& p = pl.p[q];
            const unsigned char* staged =
                pl.stage[q] >= 0 ? stage + pl.stage[q] : nullptr;
            switch (p.row_bytes) {
#define THRS_RS_MOVE(Row)                                                     \
    move_rows<Row>(p, reinterpret_cast<const Row*>(staged), at, m, sm, in,   \
                   shift, mask)
                case 1: THRS_RS_MOVE(uint8_t); break;
                case 2: THRS_RS_MOVE(uint16_t); break;
                case 4: THRS_RS_MOVE(uint32_t); break;
                case 8: THRS_RS_MOVE(uint2); break;
                default: THRS_RS_MOVE(uint4); break;
#undef THRS_RS_MOVE
            }
        }
        __syncthreads();
        if (!more) break;
        if (same) {
            ++k;
        } else {
            s = ns;
            k = 0;
        }
    }
}

// dynamic shared memory with `staged` payload bytes a word
template <typename Word, typename Idx>
static int smem_bytes(int staged) {
    return (int)sizeof(Smem<Word, Idx>) + staged * Chunk<Word>::WORDS;
}

#define THRS_RS_MAX_DEVICES 64

// staged payload bytes a word, at most (u64 words: 4096 a chunk)
#define THRS_RS_MAX_STAGED (THRS_RS_STAGE_BYTES / 4096)

// the blocks of the instantiation that one SM of device `dev` holds with
// `staged` payload bytes a word in shared memory, as shared memory and
// registers allow (0 where it cannot be read); the kernel's largest shared
// memory, and the carveout that gives shared memory the most of the SM,
// are set once per device
template <typename Word, typename Idx>
static int blocks_per_sm(int dev, int staged) {
    static int cache[THRS_RS_MAX_DEVICES][THRS_RS_MAX_STAGED + 1];
    static bool set[THRS_RS_MAX_DEVICES];
    if (dev < 0 || dev >= THRS_RS_MAX_DEVICES || staged < 0 ||
        staged > THRS_RS_MAX_STAGED) {
        return 0;
    }
    if (cache[dev][staged] == 0) {
        if (!set[dev]) {
            if (cudaFuncSetAttribute(
                    rank_scatter_kernel<Word, Idx>,
                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                    (int)sizeof(Smem<Word, Idx>) + THRS_RS_STAGE_BYTES) !=
                    cudaSuccess ||
                cudaFuncSetAttribute(
                    rank_scatter_kernel<Word, Idx>,
                    cudaFuncAttributePreferredSharedMemoryCarveout,
                    (int)cudaSharedmemCarveoutMaxShared) != cudaSuccess) {
                return 0;
            }
            set[dev] = true;
        }
        int blocks = 0;
        if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, rank_scatter_kernel<Word, Idx>, THRS_RS_THREADS,
                smem_bytes<Word, Idx>(staged)) != cudaSuccess) {
            return 0;
        }
        cache[dev][staged] = blocks;
    }
    return cache[dev][staged];
}

// the payloads' rows of a chunk are staged in shared memory, in order,
// while they fit THRS_RS_STAGE_BYTES (pl.stage); the others are read from
// L2. Returns the staged bytes a word.
template <typename Word>
static int stage(Payloads& pl) {
    int staged = 0;
    for (int q = 0; q < pl.count; ++q) {
        const int rb = (int)pl.p[q].row_bytes;
        pl.stage[q] = -1;
        if ((staged + rb) * Chunk<Word>::WORDS <= THRS_RS_STAGE_BYTES) {
            pl.stage[q] = staged * Chunk<Word>::WORDS;
            staged += rb;
        }
    }
    return staged;
}

// A call's schedule: its blocks a SM and its grid, one block a segment (a
// chunk's tiles of one row, or one longer tile) while the card holds them
// all at once, with what the kernel is told of its segments
struct Plan {
    int per_sm, grid;
    long long tiles_per_row, per_seg, segs_per_row, nseg;
};

// `p` for a call over `n` words in `rows` rows of tiles of `tile` with
// `staged` payload bytes a word; returns a cudaError_t as int
template <typename Word, typename Idx>
static int plan(long long n, long long rows, long long tile, int staged,
                Plan& p) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
        const int err = (int)cudaGetLastError();
        return err ? err : (int)cudaErrorInvalidDevice;
    }
    // as many blocks a SM as stay resident: two where no payload is staged
    p.per_sm = blocks_per_sm<Word, Idx>(dev, staged);
    if (p.per_sm == 0) {
        const int err = (int)cudaGetLastError();
        return err ? err : (int)cudaErrorInvalidConfiguration;
    }
    const long long resident = (long long)p.per_sm * sms;
    // tiles a segment holds, segments a row, segments in all
    p.tiles_per_row = n / tile / rows;
    p.per_seg = tile >= Chunk<Word>::WORDS ? 1 : Chunk<Word>::WORDS / tile;
    p.segs_per_row = (p.tiles_per_row + p.per_seg - 1) / p.per_seg;
    p.nseg = rows * p.segs_per_row;
    p.grid = (int)(p.nseg < resident ? p.nseg : resident);
    return (int)cudaSuccess;
}

template <typename Word, typename Idx>
static int launch(const void* bits, long long n, long long rows,
                  long long tile, int shift, int width, const void* base,
                  void* bits_out, void* src, Payloads pl, int* tickets,
                  cudaStream_t stream) {
    const int staged = stage<Word>(pl);  // bytes a word
    Plan p;
    const int err = plan<Word, Idx>(n, rows, tile, staged, p);
    if (err != (int)cudaSuccess) return err;
    rank_scatter_kernel<Word, Idx>
        <<<p.grid, THRS_RS_THREADS, smem_bytes<Word, Idx>(staged), stream>>>(
            static_cast<const Word*>(bits), static_cast<const Idx*>(base),
            tile, (int)p.tiles_per_row, (int)p.per_seg, (int)p.segs_per_row,
            (int)p.nseg, shift, width, static_cast<Word*>(bits_out),
            static_cast<Idx*>(src), pl, tickets);
    return (int)cudaGetLastError();
}

// Ranks and scatters `n` words of `word_bytes` (4 or 8) bytes at `bits`,
// `rows` rows of whole tiles of `tile` (a multiple of 128), by the digit
// [shift, shift + width) (width 1-8), into `bits_out` (n words), `src` (n
// indices of `idx_bytes`, 4 or 8; not written when it is null) and the
// `num_payloads` (at most 4) payloads of `payloads` (rows of 1, 2, 4, 8 or
// 16 bytes), with `base` the device array of (n / tile) * 2**width offsets
// of `idx_bytes` each, on `stream`. Every array starts at a 16-byte
// boundary. Returns a cudaError_t as int: the launch is checked with
// cudaGetLastError(); a fault while the kernel runs shows at the next
// synchronisation.
extern "C" int thrs_rank_scatter(const void* bits, int word_bytes,
                                 long long n, long long rows, int shift,
                                 int width, long long tile, const void* base,
                                 int idx_bytes, void* bits_out, void* src,
                                 const thrs_rs_payload* payloads,
                                 int num_payloads, void* stream,
                                 int* tickets) {
    const int nbits = word_bytes * 8;
    if ((word_bytes != 4 && word_bytes != 8) ||
        (idx_bytes != 4 && idx_bytes != 8) || n < 0 || tile < 128 ||
        tile % 128 != 0 || rows < 1 || n % (rows * tile) != 0 ||
        width < 1 || width > THRS_RS_MAX_WIDTH || shift < 0 ||
        shift + width > nbits || (idx_bytes == 4 && n > 0x80000000ll) ||
        n / tile > 0x7FFFFFFFll || num_payloads < 0 ||
        num_payloads > THRS_RS_MAX_PAYLOADS ||
        reinterpret_cast<uintptr_t>(bits) % 16 != 0 || tickets == nullptr) {
        return (int)cudaErrorInvalidValue;
    }
    Payloads pl = {};
    pl.count = num_payloads;
    for (int q = 0; q < num_payloads; ++q) {
        const long long b = payloads[q].row_bytes;
        if ((b != 1 && b != 2 && b != 4 && b != 8 && b != 16) ||
            reinterpret_cast<uintptr_t>(payloads[q].src) % 16 != 0 ||
            reinterpret_cast<uintptr_t>(payloads[q].dst) % 16 != 0) {
            return (int)cudaErrorInvalidValue;
        }
        pl.p[q] = payloads[q];
    }
    if (n == 0) {
        return (int)cudaSuccess;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (word_bytes == 4) {
        return idx_bytes == 4
                   ? launch<uint32_t, int>(bits, n, rows, tile, shift, width,
                                           base, bits_out, src, pl, tickets, s)
                   : launch<uint32_t, long long>(bits, n, rows, tile, shift,
                                                 width, base, bits_out, src,
                                                 pl, tickets, s);
    }
    return idx_bytes == 4
               ? launch<unsigned long long, int>(bits, n, rows, tile, shift,
                                                 width, base, bits_out, src,
                                                 pl, tickets, s)
               : launch<unsigned long long, long long>(
                     bits, n, rows, tile, shift, width, base, bits_out, src,
                     pl, tickets, s);
}

// The schedule of a call of thrs_rank_scatter on the current device over
// `n` words of `word_bytes` (4 or 8) bytes in `rows` rows of whole tiles of
// `tile`, with indices of `idx_bytes` (4 or 8) and the `num_payloads` (at
// most 4) payloads whose rows are `row_bytes` bytes each (1, 2, 4, 8 or
// 16): returns the blocks each SM runs at once (the payloads a block
// stages set its shared memory) and writes the call's blocks to `grid`.
// Returns 0 where an argument is not taken or the occupancy cannot be read.
extern "C" int thrs_rank_scatter_per_sm(int word_bytes, int idx_bytes,
                                        const long long* row_bytes,
                                        int num_payloads, long long n,
                                        long long rows, long long tile,
                                        long long* grid) {
    if ((word_bytes != 4 && word_bytes != 8) ||
        (idx_bytes != 4 && idx_bytes != 8) || num_payloads < 0 ||
        num_payloads > THRS_RS_MAX_PAYLOADS ||
        (num_payloads > 0 && row_bytes == nullptr) || n < 0 || rows < 1 ||
        tile < 1 || n % (rows * tile) != 0 || grid == nullptr) {
        return 0;
    }
    Payloads pl = {};
    pl.count = num_payloads;
    for (int q = 0; q < num_payloads; ++q) {
        const long long b = row_bytes[q];
        if (b != 1 && b != 2 && b != 4 && b != 8 && b != 16) return 0;
        pl.p[q].row_bytes = b;
    }
    Plan p;
    int err;
    if (word_bytes == 4) {
        const int staged = stage<uint32_t>(pl);
        err = idx_bytes == 4
                  ? plan<uint32_t, int>(n, rows, tile, staged, p)
                  : plan<uint32_t, long long>(n, rows, tile, staged, p);
    } else {
        const int staged = stage<unsigned long long>(pl);
        err = idx_bytes == 4
                  ? plan<unsigned long long, int>(n, rows, tile, staged, p)
                  : plan<unsigned long long, long long>(n, rows, tile,
                                                        staged, p);
    }
    if (err != (int)cudaSuccess) return 0;
    *grid = p.grid;
    return p.per_sm;
}
