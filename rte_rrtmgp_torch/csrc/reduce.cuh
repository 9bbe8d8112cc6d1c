// Per-level g-point sums shared by the LW and SW sweep kernels.
//
// A block is one column; its threads are the g-points of the chunk.  After
// each level every warp reduces its values with shuffles and lane 0 stores
// the warp's partial in shared memory (no block barrier inside the sweep).
// At the end the partials of each level are summed over the warps in a
// fixed order and written once.

#pragma once

#include <cuda_runtime.h>

namespace rrtmgp {

__device__ __forceinline__ float warp_sum(float v)
{
    for (int o = 16; o > 0; o >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// part: shared [nq][nwarp][nlev]; stores quantity q's warp partial at lev.
__device__ __forceinline__ void level_partial(float* part, int q, int nwarp,
                                              int nlev, int lev, float v)
{
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0)
        part[(q * nwarp + (threadIdx.x >> 5)) * nlev + lev] = v;
}

// Sums the warp partials of nq quantities and writes out[q][col*nlev + lev].
__device__ __forceinline__ void write_levels(const float* part, int nq,
                                             int nwarp, int nlev, long long col,
                                             float* const* out)
{
    __syncthreads();
    for (int lev = threadIdx.x; lev < nlev; lev += blockDim.x) {
        for (int q = 0; q < nq; ++q) {
            float s = 0.0f;
            for (int w = 0; w < nwarp; ++w)
                s += part[(q * nwarp + w) * nlev + lev];
            out[q][col * nlev + lev] = s;
        }
    }
}

// Threads per block for G g-points: whole warps.
inline int block_threads(int G) { return ((G + 31) / 32) * 32; }

// Dynamic shared memory of nq quantities' partials, raising the kernel's
// limit above the 48 KB default when needed.
template <typename K>
inline cudaError_t partial_smem(K kernel, int nq, int G, int nlev,
                                size_t* bytes)
{
    *bytes = sizeof(float) * (size_t)nq * (block_threads(G) / 32) * nlev;
    if (*bytes > 48 * 1024)
        return cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
    return cudaSuccess;
}

}  // namespace rrtmgp
