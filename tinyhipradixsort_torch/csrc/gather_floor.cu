// Dynamic-load floor probe for NVIDIA Hopper (sm_90a): a checksum of
// per-element dynamic loads from shared memory.
//
// Replaces the Pallas TPU kernel `gather_kernel` in tools/gather_floor.py.
// It computes what `gather_checksum_reference` in
// tinyhipradixsort_torch/tools/gather_floor.py computes:
//     out = sum over o in [0, rounds), i in [0, m) of
//           src[(idx[i] + o) & (m - 1)]   (mod 2**32),
// with m a power of two and idx any m words. The TPU kernel runs the loop as
// one scalar program from SMEM. Addition mod 2**32 is order-free, so here
// the (o, i) loads are dealt out in whatever order suits the card: every
// (o, i) pair is still one dynamic shared-memory load of a word whose
// address depends on idx[i].
//
// What bounds it. It reads 8 * m bytes of device memory and writes 4, so
// its bytes are negligible; the work is m * rounds dynamic loads from
// shared memory and their sum. Hopper's shared memory has 32 banks of 4
// bytes and serves one wavefront (one word from each bank) per clock per
// SM, so 32 conflict-free loads a clock per SM: 132 x 32 x 1.98e9 =
// 8.36e12 loads/s, the bound. Beside each load the integer pipe (64 lanes
// a clock per SM, 16.7e12/s) computes the address (idx[i] + o) & (m - 1),
// an add and a mask, and half of a three-input add into the sum: about
// 2.5 operations a load, which caps this design at 25.6 loads a clock per
// SM (6.7e12/s), 80% of the wavefront rate.
//
// The design. Were each thread to take its own elements and walk over the
// rounds, a warp would load 32 random words per instruction: with 32 banks
// the fullest bank then holds about 3.5 of them, so a warp instruction
// costs about 4.5 wavefronts (about 7 loads a clock per SM). Instead the
// 32 lanes of a warp take one element i and 32 consecutive rounds: lane l
// loads src[(idx[i] + o0 + l) & (m - 1)]. For m >= 32 those are 32 consecutive
// words mod m, one in each bank; for m < 32 the lanes that wrap read the
// same word, which the hardware broadcasts. Each warp instruction is one
// wavefront for any idx and any m. idx[i] is one broadcast load per warp,
// reused over K groups of 32 rounds (a span of 32 * K rounds: lane l takes
// o0 + l, o0 + l + 32, ...), so index loads are 1/K of the gathers and the
// K gathers of a span are independent loads in flight.
//
// The grid is resident: as many blocks as fit at once, at most
// THRS_GATHER_BLOCKS_PER_SM on each SM, each filling the two tables into
// shared memory once (16-byte loads where the pointers allow) and then
// walking a contiguous share of the (element, span) units, element-major,
// so a warp reads a new idx[i] only when its share moves to the next
// element. The host takes K from the shape (the largest of 16, 8, 4, 2, 1
// that leaves every resident warp at least 8 units); the SM count and the
// occupancy at each K and table size are looked up at a device's first
// call and kept, so a later call is the memset and the launch. Rounds past
// the last full span take a masked tail that adds nothing. A warp-shuffle
// sum, a block sum and one atomicAdd per block finish it into `out`, which
// the host zeroes first.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (done at first use by ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define THRS_GATHER_THREADS 512
#define THRS_GATHER_WARPS (THRS_GATHER_THREADS / 32)
#define THRS_GATHER_BLOCKS_PER_SM 2
#define THRS_GATHER_LOG_MAX_M 14
#define THRS_GATHER_MAX_M (1 << THRS_GATHER_LOG_MAX_M)  // two tables: 128 KB
#define THRS_GATHER_MAX_DEVICES 64  // devices whose look-ups are kept
#define THRS_GATHER_MIN_UNITS 8  // units per resident warp that set K

template <int K>
__global__ void
__launch_bounds__(THRS_GATHER_THREADS, THRS_GATHER_BLOCKS_PER_SM)
gather_floor_kernel(const uint32_t* __restrict__ idx,
                    const uint32_t* __restrict__ src, int m, long long rounds,
                    int vec, unsigned long long units,
                    uint32_t* __restrict__ out) {
    extern __shared__ __align__(16) uint32_t tables[];  // src[m], then idx[m]
    uint32_t* s_src = tables;
    uint32_t* s_idx = tables + m;
    if (vec) {  // 16-byte loads: both pointers are 16-byte aligned, m % 4 == 0
        const uint4* g_src = reinterpret_cast<const uint4*>(src);
        const uint4* g_idx = reinterpret_cast<const uint4*>(idx);
        for (int v = threadIdx.x; v < (m >> 2); v += THRS_GATHER_THREADS) {
            reinterpret_cast<uint4*>(s_src)[v] = __ldg(g_src + v);
            reinterpret_cast<uint4*>(s_idx)[v] = __ldg(g_idx + v);
        }
    } else {
        for (int v = threadIdx.x; v < m; v += THRS_GATHER_THREADS) {
            s_src[v] = src[v];
            s_idx[v] = idx[v];
        }
    }
    __syncthreads();

    const uint32_t lane = threadIdx.x & 31u;
    // this warp's contiguous share [u, end) of the m * spans units
    const unsigned long long warps =
        (unsigned long long)gridDim.x * THRS_GATHER_WARPS;
    const unsigned long long w =
        (unsigned long long)blockIdx.x * THRS_GATHER_WARPS + (threadIdx.x >> 5);
    const unsigned long long per = units / warps, extra = units % warps;
    unsigned long long u = w * per + (w < extra ? w : extra);
    const unsigned long long end = u + per + (w < extra ? 1ull : 0ull);

    const long long span = 32ll * K;
    const unsigned long long spans =
        (unsigned long long)((rounds + span - 1) / span);
    const unsigned long long full = (unsigned long long)(rounds / span);
    // rounds in the last span when it is not full (< span)
    const uint32_t tail = (uint32_t)(rounds - (long long)full * span);
    // byte offsets into s_src: (word & (m - 1)) * 4 == (word * 4) & mask4
    const uint32_t mask4 = ((uint32_t)m - 1u) << 2;
    const char* s_src_bytes = reinterpret_cast<const char*>(s_src);
    uint32_t acc = 0;
    if (u < end) {
        unsigned long long i = u / spans;
        unsigned long long s = u - i * spans;
        while (u < end) {
            unsigned long long n = spans - s;  // spans of element i in share
            if (n > end - u) n = end - u;
            const uint32_t idx_i = s_idx[i];  // one broadcast load
            uint32_t b4 = (idx_i + (uint32_t)(s * (unsigned long long)span)
                           + lane) << 2;
            const unsigned long long nf =
                s + n <= full ? n : (s < full ? full - s : 0ull);
            for (unsigned long long t = 0; t < nf; ++t) {
#pragma unroll
                for (int j = 0; j < K; ++j) {
                    acc += *reinterpret_cast<const uint32_t*>(
                        s_src_bytes + ((b4 + 128u * j) & mask4));
                }
                b4 += 128u * K;
            }
            if (nf < n) {  // the last span: rounds past `rounds` add 0
#pragma unroll
                for (int j = 0; j < K; ++j) {
                    if (lane + 32u * j < tail) {
                        acc += *reinterpret_cast<const uint32_t*>(
                            s_src_bytes + ((b4 + 128u * j) & mask4));
                    }
                }
            }
            u += n;
            ++i;
            s = 0;
        }
    }

    // block reduction: warps, then the warp sums
    for (int d = 16; d > 0; d >>= 1) {
        acc += __shfl_down_sync(0xffffffffu, acc, d);
    }
    __shared__ uint32_t warp_sums[THRS_GATHER_WARPS];
    const int warp = threadIdx.x >> 5;
    if (lane == 0) warp_sums[warp] = acc;
    __syncthreads();
    if (warp == 0) {
        acc = lane < THRS_GATHER_WARPS ? warp_sums[lane] : 0u;
        for (int d = 16; d > 0; d >>= 1) {
            acc += __shfl_down_sync(0xffffffffu, acc, d);
        }
        if (lane == 0) atomicAdd(out, acc);
    }
}

// One launch with spans of 32 * K rounds: a resident grid (the occupancy at
// this table size, at most THRS_GATHER_BLOCKS_PER_SM blocks per SM), cut to
// the units there are. The occupancy is looked up at the first launch on
// device `dev` at this K and table size, and kept.
template <int K>
static cudaError_t launch(const uint32_t* idx, const uint32_t* src, int m,
                          long long rounds, int vec, int dev, int sms,
                          uint32_t* out, cudaStream_t s) {
    static int per_sm_of[THRS_GATHER_MAX_DEVICES][THRS_GATHER_LOG_MAX_M + 1];
    const size_t smem = 2 * (size_t)m * sizeof(uint32_t);
    int& per_sm = per_sm_of[dev][__builtin_ctz((unsigned)m)];
    if (per_sm == 0) {
        // the largest tables any call uses, so one setting serves every m
        cudaError_t err = cudaFuncSetAttribute(
            gather_floor_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)(2 * THRS_GATHER_MAX_M * sizeof(uint32_t)));
        if (err != cudaSuccess) return err;
        int n = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, gather_floor_kernel<K>, THRS_GATHER_THREADS, smem);
        if (err != cudaSuccess) return err;
        if (n < 1) return cudaErrorInvalidConfiguration;
        per_sm = n < THRS_GATHER_BLOCKS_PER_SM ? n : THRS_GATHER_BLOCKS_PER_SM;
    }
    const long long span = 32ll * K;
    const unsigned long long units =
        (unsigned long long)m *
        (unsigned long long)((rounds + span - 1) / span);
    unsigned long long blocks = (unsigned long long)sms * per_sm;
    const unsigned long long needed =
        (units + THRS_GATHER_WARPS - 1) / THRS_GATHER_WARPS;
    if (blocks > needed) blocks = needed;
    gather_floor_kernel<K>
        <<<(unsigned int)blocks, THRS_GATHER_THREADS, smem, s>>>(
            idx, src, m, rounds, vec, units, out);
    return cudaGetLastError();
}

// Checksum of `rounds` passes over `m` (a power of two, <= 2**14) elements:
// `idx` and `src` are device arrays of m 32-bit words, `out` one device word
// (zeroed here). Runs on `stream`; returns a cudaError_t as int, the launch
// checked with cudaGetLastError().
extern "C" int thrs_gather_floor(const void* idx, const void* src, int m,
                                 long long rounds, void* out, void* stream) {
    if (m < 1 || m > THRS_GATHER_MAX_M || (m & (m - 1)) != 0 || rounds < 0 ||
        rounds > (1ll << 62) / m) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess || rounds == 0) {
        return (int)err;
    }
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= THRS_GATHER_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    static int sms_of[THRS_GATHER_MAX_DEVICES];  // looked up once a device
    int& sms = sms_of[dev];
    if (sms == 0) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
        if (err != cudaSuccess) return (int)err;
    }
    // K: the longest span that still leaves each resident warp
    // THRS_GATHER_MIN_UNITS units of work
    const unsigned long long want = (unsigned long long)THRS_GATHER_MIN_UNITS *
                                    sms * THRS_GATHER_BLOCKS_PER_SM *
                                    THRS_GATHER_WARPS;
    int k = 16;
    while (k > 1 && (unsigned long long)m *
                            (unsigned long long)((rounds + 32ll * k - 1) /
                                                 (32ll * k)) < want) {
        k >>= 1;
    }
    const int vec = (m % 4 == 0) &&
                    (((uintptr_t)idx | (uintptr_t)src) % 16 == 0);
    const uint32_t* i32 = static_cast<const uint32_t*>(idx);
    const uint32_t* s32 = static_cast<const uint32_t*>(src);
    uint32_t* o32 = static_cast<uint32_t*>(out);
#define THRS_GATHER_LAUNCH(K) \
    launch<K>(i32, s32, m, rounds, vec, dev, sms, o32, s)
    switch (k) {
        case 16: err = THRS_GATHER_LAUNCH(16); break;
        case 8: err = THRS_GATHER_LAUNCH(8); break;
        case 4: err = THRS_GATHER_LAUNCH(4); break;
        case 2: err = THRS_GATHER_LAUNCH(2); break;
        default: err = THRS_GATHER_LAUNCH(1); break;
    }
#undef THRS_GATHER_LAUNCH
    return (int)err;
}
