// Dynamic-load floor probe for NVIDIA Hopper (sm_90a): a checksum of
// per-element dynamic loads from shared memory.
//
// Replaces the Pallas TPU kernel `gather_kernel` in tools/gather_floor.py.
// It computes what `gather_checksum_reference` in
// tinyhipradixsort_torch/tools/gather_floor.py computes:
//     out = sum over o in [0, rounds), i in [0, m) of
//           src[(idx[i] + o) & (m - 1)]   (mod 2**32),
// with m a power of two. The TPU kernel runs the loop as one scalar program
// from SMEM; here every CTA copies the two m-element tables into shared
// memory, takes a range of rounds, and each thread folds its share of the
// (o, i) loads into a 32-bit sum; a block reduction and one global atomic
// add finish it. Addition mod 2**32 is order-free, so the result is the TPU
// kernel's checksum whatever the split.
//
// What bounds it. It reads 8 * m bytes of device memory and writes 4; the
// work is m * rounds dependent shared-memory loads (an index load, then the
// dynamic load it addresses) and adds. The probe measures the rate of those
// dynamic loads: the per-element cost of a gather whose table is on chip.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (done at first use by ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define THRS_GATHER_THREADS 256
#define THRS_GATHER_MAX_M 16384  // two tables of 2**14 words: 128 KB
#define THRS_GATHER_CTAS 1056    // 8 CTAs on each of 132 SMs

__global__ void __launch_bounds__(THRS_GATHER_THREADS)
gather_floor_kernel(const uint32_t* __restrict__ idx,
                    const uint32_t* __restrict__ src, int m,
                    long long rounds, long long rounds_per_cta,
                    uint32_t* __restrict__ out) {
    extern __shared__ uint32_t tables[];  // idx[m], then src[m]
    uint32_t* s_idx = tables;
    uint32_t* s_src = tables + m;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
        s_idx[i] = idx[i];
        s_src[i] = src[i];
    }
    __syncthreads();
    const uint32_t mask = (uint32_t)m - 1u;
    const long long o0 = blockIdx.x * rounds_per_cta;
    long long o1 = o0 + rounds_per_cta;
    if (o1 > rounds) o1 = rounds;
    uint32_t acc = 0;
    for (long long o = o0; o < o1; ++o) {
        const uint32_t off = (uint32_t)o;
        for (int i = threadIdx.x; i < m; i += blockDim.x) {
            acc += s_src[(s_idx[i] + off) & mask];
        }
    }
    // block reduction: warps, then the warp sums
    for (int d = 16; d > 0; d >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, d);
    __shared__ uint32_t warp_sums[THRS_GATHER_THREADS / 32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) warp_sums[warp] = acc;
    __syncthreads();
    if (warp == 0) {
        acc = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0u;
        for (int d = 16; d > 0; d >>= 1) {
            acc += __shfl_down_sync(0xffffffffu, acc, d);
        }
        if (lane == 0) atomicAdd(out, acc);
    }
}

// Checksum of `rounds` passes over `m` (a power of two, <= 2**14) elements:
// `idx` and `src` are device arrays of m 32-bit words, `out` one device word
// (zeroed here). Runs on `stream`; returns a cudaError_t as int, the launch
// checked with cudaGetLastError().
extern "C" int thrs_gather_floor(const void* idx, const void* src, int m,
                                 long long rounds, void* out, void* stream) {
    if (m < 1 || m > THRS_GATHER_MAX_M || (m & (m - 1)) != 0 || rounds < 0) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess || rounds == 0) {
        return (int)err;
    }
    const long long per_cta =
        (rounds + THRS_GATHER_CTAS - 1) / THRS_GATHER_CTAS;
    const long long blocks = (rounds + per_cta - 1) / per_cta;
    const size_t smem = 2 * (size_t)m * sizeof(uint32_t);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(gather_floor_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) {
            return (int)err;
        }
    }
    gather_floor_kernel<<<(unsigned int)blocks, THRS_GATHER_THREADS, smem, s>>>(
        static_cast<const uint32_t*>(idx), static_cast<const uint32_t*>(src),
        m, rounds, per_cta, static_cast<uint32_t*>(out));
    return (int)cudaGetLastError();
}
