// Kernel B2: (min, first argmin) of a 1-D float32 or bf16 vector, the
// paper's Thrust reduceMin, in one launch.
//
// Replaces repro/kernels/reduce_min.py::_argmin_kernel (the Pallas TPU
// kernel behind block_argmin_pallas) and the jnp.argmin tail of
// argmin_reduce.  Pairs are compared in the lexicographic order (value,
// index), with NaN before every number, as jnp.argmin and numpy return the
// first NaN; since that order is total, the result is the same whatever
// order the threads and CTAs finish in, and ties go to the lowest index.
//
// What bounds it on the H100: bytes, one read of the n values at
// 3.35 TB/s, is 0.02 us at the main path's n = 16385; there the cost is
// the launch itself.  So every reduction is one launch, whatever n:
//   - n <= one_cta_max: one CTA of up to 1024 threads reads the vector
//     with 16-byte loads (4 floats or 8 bf16 a load, four loads in flight
//     a thread) and block_best folds the threads' pairs;
//   - above it, a grid of CTAs each folds a contiguous range into its tile
//     pair in scratch, and the last CTA to finish (a __threadfence and an
//     atomic ticket) folds the tile pairs and writes the result; it resets
//     the ticket to 0, so the next call, or a replay of a captured CUDA
//     graph, finds it so.
// A start address that is not 16-byte aligned (a slice of a larger
// tensor) is peeled: the elements before the first aligned address and
// the ragged tail go through scalar loads in the same kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cstdint>

namespace sa {

constexpr int GRID_THREADS = 512;
constexpr int UNROLL = 4;        // 16-byte loads in flight per thread

__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
    const bool na = isnan(va), nb = isnan(vb);
    if (na != nb) return na;
    if (na) return ia < ib;
    return va < vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void fold(float fv, int fi, float& v, int& i) {
    if (better(fv, fi, v, i)) { v = fv; i = fi; }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);  // exact
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);  // exact: v came from a bf16
}

// Fold the elements of one 16-byte vector, the first at index `base`: 4
// floats, or 8 bf16 (the low half of each 32-bit word first; a bf16 is
// the top half of the float it widens to, exactly).
__device__ __forceinline__ void fold_vec(const float*, const uint4& r,
                                         int base, float& v, int& i) {
    fold(__uint_as_float(r.x), base, v, i);
    fold(__uint_as_float(r.y), base + 1, v, i);
    fold(__uint_as_float(r.z), base + 2, v, i);
    fold(__uint_as_float(r.w), base + 3, v, i);
}
__device__ __forceinline__ void fold_vec(const __nv_bfloat16*, const uint4& r,
                                         int base, float& v, int& i) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        fold(__uint_as_float(w[k] << 16), base + 2 * k, v, i);
        fold(__uint_as_float(w[k] & 0xffff0000u), base + 2 * k + 1, v, i);
    }
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

// f[0, head) precedes the first 16-byte aligned address; n_vec vectors
// follow; the tail f[head + n_vec * VEC, n) is shorter than a vector.
// scratch: the ticket, then `cap` tile values and `cap` tile indices.
template <typename T>
__global__ void argmin_kernel(const T* __restrict__ f, int n, int head,
                              int n_vec, int* __restrict__ scratch, int cap,
                              T* __restrict__ out_val,
                              int* __restrict__ out_idx) {
    constexpr int VEC = 16 / sizeof(T);
    const int G = gridDim.x, b = blockIdx.x, bd = blockDim.x;
    float v = __int_as_float(0x7f800000);  // +inf
    int i = INT_MAX;

    if (b == 0) {  // the scalar head and tail
        const int tail0 = head + n_vec * VEC;
        const int t = threadIdx.x;
        if (t < head) fold(to_f(f[t]), t, v, i);
        if (tail0 + t < n) fold(to_f(f[tail0 + t]), tail0 + t, v, i);
    }
    const uint4* body = reinterpret_cast<const uint4*>(f + head);
    const int per = (n_vec + G - 1) / G;
    const int end = min(n_vec, (b + 1) * per);
    int k = b * per + threadIdx.x;
    for (; k + (UNROLL - 1) * bd < end; k += UNROLL * bd) {
        uint4 r[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) r[u] = body[k + u * bd];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            fold_vec(f, r[u], head + (k + u * bd) * VEC, v, i);
    }
    for (; k < end; k += bd) fold_vec(f, body[k], head + k * VEC, v, i);
    block_best(v, i);

    if (G == 1) {
        if (threadIdx.x == 0) {
            store_f(out_val, v);
            *out_idx = i;
        }
        return;
    }
    int* ticket = scratch;
    float* tile_val = reinterpret_cast<float*>(scratch + 1);
    int* tile_idx = scratch + 1 + cap;
    __shared__ bool last;
    if (threadIdx.x == 0) {
        tile_val[b] = v;
        tile_idx[b] = i;
        __threadfence();  // the pair is visible before the ticket is taken
        last = atomicAdd(ticket, 1) == G - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    v = __int_as_float(0x7f800000);
    i = INT_MAX;
    for (int t = threadIdx.x; t < G; t += bd)
        fold(__ldcg(tile_val + t), __ldcg(tile_idx + t), v, i);
    block_best(v, i);
    if (threadIdx.x == 0) {
        store_f(out_val, v);
        *out_idx = i;
        *ticket = 0;
    }
}

template <typename T>
int launch(const void* fp, int n, int one_cta_max, int* scratch, int cap,
           void* out_val, int* out_idx, cudaStream_t st) {
    constexpr int VEC = 16 / sizeof(T);
    const T* f = static_cast<const T*>(fp);
    const uintptr_t mis = reinterpret_cast<uintptr_t>(f) & 15u;
    const int head = std::min(n, static_cast<int>(((16u - mis) & 15u) / sizeof(T)));
    const int n_vec = (n - head) / VEC;
    int grid = 1, threads;
    if (n <= one_cta_max) {
        // One CTA; at least as many threads as the scalar head and tail.
        threads = std::min(1024, (std::max(n_vec, VEC) + 31) / 32 * 32);
    } else {
        threads = GRID_THREADS;
        const int per_cta = GRID_THREADS * UNROLL;
        grid = std::min(cap, std::max(2, (n_vec + per_cta - 1) / per_cta));
    }
    argmin_kernel<T><<<grid, threads, 0, st>>>(
        f, n, head, n_vec, scratch, cap, static_cast<T*>(out_val), out_idx);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace sa

// dtype: 0 float32, 1 bfloat16.  n >= 1.  scratch: 1 + 2 * cap int32
// (cap >= 2 tile pairs, the grid's largest size), the first (the ticket)
// zero before the first call; the kernel leaves it zero.  out_val has the
// input's dtype.
extern "C" int sa_argmin_reduce(const void* f, int dtype, int n,
                                int one_cta_max, int* scratch, int cap,
                                void* out_val, int* out_idx, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 1)
        return sa::launch<__nv_bfloat16>(f, n, one_cta_max, scratch, cap,
                                         out_val, out_idx, st);
    return sa::launch<float>(f, n, one_cta_max, scratch, cap, out_val,
                             out_idx, st);
}
