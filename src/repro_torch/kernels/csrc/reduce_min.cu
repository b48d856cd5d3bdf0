// Kernel B2: block (min, argmin) reduction, the paper's Thrust reduceMin.
//
// Replaces repro/kernels/reduce_min.py::_argmin_kernel (the Pallas TPU
// kernel behind block_argmin_pallas) and the jnp.argmin tail of
// argmin_reduce.  Pass 1: one CTA per tile of `blk` values writes the
// tile's (min, first index).  Pass 2: one CTA reduces the tile pairs.  Two
// passes rather than one launch with atomics, because a tie must go to the
// lowest index deterministically.  Pairs are compared in the lexicographic
// order (value, index); NaN orders before every number, as jnp.argmin and
// numpy return the first NaN.  The kernel masks the ragged last tile
// itself, so any n >= 1 goes through it.
//
// What bounds it on the H100: bytes, one read of the n values at
// 3.35 TB/s.  At the main path's n = 16385 it is launch latency instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace sa {

__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
    const bool na = isnan(va), nb = isnan(vb);
    if (na != nb) return na;
    if (na) return ia < ib;
    return va < vb || (va == vb && ia < ib);
}

__device__ __forceinline__ float load_f(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int i) {
    return __bfloat162float(p[i]);  // exact
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);  // exact: v came from a bf16
}

// Reduce every thread's (v, i) to thread 0 of the CTA (blockDim <= 1024).
__device__ __forceinline__ void block_best(float& v, int& i) {
    __shared__ float sv[32];
    __shared__ int si[32];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, m);
        const int oi = __shfl_xor_sync(0xffffffffu, i, m);
        if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) { sv[warp] = v; si[warp] = i; }
    __syncthreads();
    if (warp == 0) {
        const int n_warps = (blockDim.x + 31) >> 5;
        v = lane < n_warps ? sv[lane] : __int_as_float(0x7f800000);
        i = lane < n_warps ? si[lane] : INT_MAX;
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, v, m);
            const int oi = __shfl_xor_sync(0xffffffffu, i, m);
            if (better(ov, oi, v, i)) { v = ov; i = oi; }
        }
    }
}

template <typename T>
__global__ void tile_argmin_kernel(const T* __restrict__ f, int n, int blk,
                                   float* __restrict__ tile_min,
                                   int* __restrict__ tile_idx) {
    const int start = blockIdx.x * blk;
    const int end = min(start + blk, n);
    float v = __int_as_float(0x7f800000);  // +inf
    int i = INT_MAX;
    for (int j = start + threadIdx.x; j < end; j += blockDim.x) {
        const float fj = load_f(f, j);
        if (better(fj, j, v, i)) { v = fj; i = j; }
    }
    block_best(v, i);
    if (threadIdx.x == 0) {
        tile_min[blockIdx.x] = v;
        tile_idx[blockIdx.x] = i;
    }
}

template <typename T>
__global__ void tail_argmin_kernel(const float* __restrict__ tile_min,
                                   const int* __restrict__ tile_idx,
                                   int n_tiles, T* __restrict__ out_val,
                                   int* __restrict__ out_idx) {
    float v = __int_as_float(0x7f800000);
    int i = INT_MAX;
    for (int t = threadIdx.x; t < n_tiles; t += blockDim.x)
        if (better(tile_min[t], tile_idx[t], v, i)) { v = tile_min[t]; i = tile_idx[t]; }
    block_best(v, i);
    if (threadIdx.x == 0) {
        store_f(out_val, v);
        *out_idx = i;
    }
}

template <typename T>
int launch(const void* f, int n, int blk, float* tile_min, int* tile_idx,
           void* out_val, int* out_idx, cudaStream_t st) {
    const int n_tiles = (n + blk - 1) / blk;
    tile_argmin_kernel<T><<<n_tiles, 256, 0, st>>>(
        static_cast<const T*>(f), n, blk, tile_min, tile_idx);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    tail_argmin_kernel<T><<<1, 1024, 0, st>>>(
        tile_min, tile_idx, n_tiles, static_cast<T*>(out_val), out_idx);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace sa

// dtype: 0 float32, 1 bfloat16.  tile_min/tile_idx: scratch of
// ceil(n / blk) entries.  out_val has the input's dtype.
extern "C" int sa_argmin_reduce(const void* f, int dtype, int n, int blk,
                                float* tile_min, int* tile_idx, void* out_val,
                                int* out_idx, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 1)
        return sa::launch<__nv_bfloat16>(f, n, blk, tile_min, tile_idx,
                                         out_val, out_idx, st);
    return sa::launch<float>(f, n, blk, tile_min, tile_idx, out_val, out_idx,
                             st);
}
