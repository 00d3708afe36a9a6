// Bucketed-scatter floor probe for NVIDIA Hopper (sm_90a): ragged runs of a
// partition pass copied to their destinations in device memory.
//
// Replaces the Pallas TPU kernel `scatter_kernel` in
// tools/partition_dma_floor.py. It computes what
// `partition_scatter_reference` in
// tinyhipradixsort_torch/tools/partition_dma_floor.py computes: `src` is t
// tiles of 256 runs of r 32-bit words; run b of tile ti goes to run slot
// offs[ti][b] of `out`:
//     out[offs[ti][b] * r + k] = src[(ti * 256 + b) * r + k],  k in [0, r).
// The TPU kernel issues one dynamic-offset DMA per run with a window of
// copies in flight; here one CTA copies one run, with coalesced 16-byte
// loads and stores when r is a multiple of 4 and both buffers are 16-byte
// aligned (4-byte words otherwise). TMA or cp.async.bulk is later work.
// A run slot outside [0, t * 256) is skipped, never written.
//
// What bounds it. Every word is read once and written once:
// 2 * t * 256 * r * 4 bytes against ~3.35 TB/s on an H100 SXM (2**28 words:
// 2.147 GB, ~0.64 ms). The probe measures how close a bucketed scatter with
// data-dependent destinations comes to that.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (done at first use by ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define THRS_SCATTER_BUCKETS 256
#define THRS_SCATTER_THREADS 256

// One CTA per run; `units` Word-sized units per run.
template <typename Word>
__global__ void __launch_bounds__(THRS_SCATTER_THREADS)
partition_scatter_kernel(const Word* __restrict__ src,
                         const int* __restrict__ offs,
                         Word* __restrict__ out, long long nruns,
                         long long units) {
    const long long run = blockIdx.x;
    const int dst = offs[run];
    if (dst < 0 || dst >= nruns) return;
    const Word* s = src + run * units;
    Word* d = out + (long long)dst * units;
    for (long long k = threadIdx.x; k < units; k += blockDim.x) d[k] = s[k];
}

// Scatters `t` tiles of 256 runs of `r` 32-bit words from `src` to `out`
// (device arrays of t * 256 * r words) by the run slots `offs` (a device
// array of t * 256 int32), on `stream`. Returns a cudaError_t as int, the
// launch checked with cudaGetLastError().
extern "C" int thrs_partition_scatter(const void* src, const void* offs,
                                      void* out, long long t, long long r,
                                      void* stream) {
    const long long nruns = t * THRS_SCATTER_BUCKETS;
    if (t < 0 || r < 1 || nruns > 0x7FFFFFFFll) {
        return (int)cudaErrorInvalidValue;
    }
    if (nruns == 0) {
        return (int)cudaSuccess;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = (r % 4) == 0 &&
                     ((reinterpret_cast<uintptr_t>(src) |
                       reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    const long long units = vec ? r / 4 : r;
    const int threads = units < THRS_SCATTER_THREADS
                            ? (int)((units + 31) / 32 * 32)
                            : THRS_SCATTER_THREADS;
    const int* o = static_cast<const int*>(offs);
    if (vec) {
        partition_scatter_kernel<uint4><<<(unsigned int)nruns, threads, 0, s>>>(
            static_cast<const uint4*>(src), o, static_cast<uint4*>(out), nruns,
            units);
    } else {
        partition_scatter_kernel<uint32_t>
            <<<(unsigned int)nruns, threads, 0, s>>>(
                static_cast<const uint32_t*>(src), o,
                static_cast<uint32_t*>(out), nruns, units);
    }
    return (int)cudaGetLastError();
}
