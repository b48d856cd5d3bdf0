// Kernel B1: the fused Metropolis sweep (the paper's Listing 2/4 body).
//
// Replaces repro/kernels/metropolis_sweep.py::_sweep_kernel (the Pallas TPU
// kernel behind metropolis_sweep_pallas).  One launch advances every chain
// by n_steps Metropolis steps at a fixed temperature; it computes what the
// Pallas kernel computes, not how: there the grid walks chain blocks in
// VMEM, here each chain is a thread (delta) or a warp (full).
//
// Per-block controls, one entry per block of `blk` chains (a serving slot):
// kid, seed, step0, T, chain_base and live.  A NULL pointer means the
// scalar value beside it applies to every block (chain_base NULL: b * blk;
// live NULL: every block live).  t_chain, when given, replaces the block
// temperature chain by chain.  Chain c of block b draws from stream
// (seed[b], chain_base[b] + c, step0[b] + i), so a chain's trajectory does
// not depend on where it was packed.
//
// What bounds it on the H100:
//   delta - integer issue: two threefry2x32 (20 rounds each) per proposal
//           against O(1) float math; x is read and written once per sweep.
//   full  - the dim transcendentals of each proposal's re-evaluation.
// Design: delta runs one thread per chain with the accumulators S, logP and
// sgnP in registers, so only the proposed coordinate is read per step.
// full runs one warp per chain: lanes stride the coordinates (coalesced
// reads of the row) and a __shfl_xor butterfly sums them, which leaves the
// same total in every lane.  First known limit: at 16384 chains the delta
// variant has 16384 threads, about 124 per SM, far below the 2048 an SM can
// hold, so integer latency is not hidden.
#include <cuda_runtime.h>
#include <cstdint>

#include "objective_math.cuh"
#include "rng.cuh"

namespace sa {

struct SweepControls {
    const int* kid;
    int kid_s;
    const uint32_t* seed;
    uint32_t seed_s;
    const uint32_t* step0;
    uint32_t step0_s;
    const float* T;
    float T_s;
    const uint32_t* chain_base;
    const int* live;
    const float* t_chain;
};

struct ChainSetup {
    int kid;
    uint32_t seed, step0, cidx;
    float T, lo, width;
    bool live;
};

__device__ __forceinline__ ChainSetup setup(const SweepControls& c, int chain,
                                            int blk) {
    ChainSetup s;
    const int b = chain / blk;
    const uint32_t lane = static_cast<uint32_t>(chain - b * blk);
    s.kid = c.kid ? c.kid[b] : c.kid_s;
    s.seed = c.seed ? c.seed[b] : c.seed_s;
    s.step0 = c.step0 ? c.step0[b] : c.step0_s;
    s.T = c.t_chain ? c.t_chain[chain] : (c.T ? c.T[b] : c.T_s);
    s.cidx = (c.chain_base ? c.chain_base[b]
                           : static_cast<uint32_t>(b) * static_cast<uint32_t>(blk))
             + lane;
    s.live = c.live ? (c.live[b] != 0) : true;
    float hi;
    box(s.kid, s.lo, hi);
    s.width = hi - s.lo;
    return s;
}

// One proposal: coordinate d and its new value lo + u * (hi - lo), rounded
// once as a fused multiply-add.  The JAX oracle computes it so (XLA
// contracts it into an FMA) and so does the plain version (ref.proposal);
// the explicit intrinsic makes it independent of -fmad, so the only float
// that enters the state is bit-equal on all three.
__device__ __forceinline__ void propose(const ChainSetup& s, int i, int dim,
                                        int& d, float& newval, float& uacc) {
    uint32_t rbits;
    float uval;
    draws3(s.seed, s.cidx, s.step0 + static_cast<uint32_t>(i), rbits, uval,
           uacc);
    d = static_cast<int>(rbits % static_cast<uint32_t>(dim));
    newval = __fmaf_rn(uval, s.width, s.lo);
}

__device__ __forceinline__ bool accept(float uacc, float f0, float f1,
                                       float T) {
    return uacc <= expf(clip80(-(f1 - f0) / T));
}

__global__ void sweep_delta_kernel(const float* __restrict__ x_in,
                                   float* __restrict__ x_out,
                                   float* __restrict__ f_out,
                                   SweepControls c, int chains, int dim,
                                   int blk, int n_steps) {
    // The CTA's rows are contiguous: copy them coalesced, then each thread
    // owns its row of x_out.
    const int first = blockIdx.x * blockDim.x;
    const int rows = min(static_cast<int>(blockDim.x), chains - first);
    const size_t base = static_cast<size_t>(first) * dim;
    for (size_t j = threadIdx.x; j < static_cast<size_t>(rows) * dim;
         j += blockDim.x)
        x_out[base + j] = x_in[base + j];
    __syncthreads();
    const int chain = first + threadIdx.x;
    if (chain >= chains) return;

    const ChainSetup s = setup(c, chain, blk);
    const float* xr = x_in + static_cast<size_t>(chain) * dim;
    float* xo = x_out + static_cast<size_t>(chain) * dim;

    float S0 = 0.0f, S1 = 0.0f, logP = 0.0f, sgnP = 1.0f;
    for (int i = 0; i < dim; ++i) {
        float s0, s1, p;
        term(s.kid, xr[i], static_cast<float>(i), s0, s1, p);
        S0 += s0;
        S1 += s1;
        logP += log_mag(p);
        sgnP *= sign_of(p);
    }
    float fx = combine(s.kid, S0, S1, logP, sgnP, dim);

    for (int i = 0; i < n_steps; ++i) {
        int d;
        float newval, uacc;
        propose(s, i, dim, d, newval, uacc);
        const float xi_old = xo[d];
        const float df = static_cast<float>(d);
        float so0, so1, po, sn0, sn1, pn;
        term(s.kid, xi_old, df, so0, so1, po);
        term(s.kid, newval, df, sn0, sn1, pn);
        const float S0n = S0 - so0 + sn0;
        const float S1n = S1 - so1 + sn1;
        const float logPn = logP - log_mag(po) + log_mag(pn);
        const float sgnPn = sgnP * (sign_of(po) * sign_of(pn));
        const float f1 = combine(s.kid, S0n, S1n, logPn, sgnPn, dim);
        if (s.live && accept(uacc, fx, f1, s.T)) {
            xo[d] = newval;
            fx = f1;
            S0 = S0n;
            S1 = S1n;
            logP = logPn;
            sgnP = sgnPn;
        }
    }
    f_out[chain] = fx;
}

// Sum of the lanes' partials, left identical in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

__device__ __forceinline__ float warp_prod(float v) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v *= __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

// f of row xo with coordinate d replaced by newval (d < 0: no replacement).
__device__ __forceinline__ float warp_full_eval(int kid, const float* xo,
                                                int dim, int lane, int d,
                                                float newval) {
    float a = 0.0f, b = 0.0f, p = 1.0f;
    for (int j = lane; j < dim; j += 32)
        full_term(kid, j == d ? newval : xo[j], j, a, b, p);
    return full_finish(kid, warp_sum(a), warp_sum(b), warp_prod(p), dim);
}

constexpr int FULL_WARPS = 4;

__global__ void sweep_full_kernel(const float* __restrict__ x_in,
                                  float* __restrict__ x_out,
                                  float* __restrict__ f_out, SweepControls c,
                                  int chains, int dim, int blk, int n_steps) {
    const int lane = threadIdx.x & 31;
    const int chain = blockIdx.x * FULL_WARPS + (threadIdx.x >> 5);
    if (chain >= chains) return;  // whole warps only
    const ChainSetup s = setup(c, chain, blk);
    const float* xr = x_in + static_cast<size_t>(chain) * dim;
    float* xo = x_out + static_cast<size_t>(chain) * dim;
    for (int j = lane; j < dim; j += 32) xo[j] = xr[j];
    __syncwarp();

    float fx = warp_full_eval(s.kid, xo, dim, lane, -1, 0.0f);
    for (int i = 0; i < n_steps; ++i) {
        int d;
        float newval, uacc;
        propose(s, i, dim, d, newval, uacc);
        const float f1 = warp_full_eval(s.kid, xo, dim, lane, d, newval);
        // Every lane holds the same f1, so every lane takes the same branch.
        if (s.live && accept(uacc, fx, f1, s.T)) {
            if ((d & 31) == lane) xo[d] = newval;
            fx = f1;
        }
        __syncwarp();
    }
    if (lane == 0) f_out[chain] = fx;
}

}  // namespace sa

extern "C" int sa_metropolis_sweep(
    const float* x_in, float* x_out, float* f_out, const int* kid, int kid_s,
    const uint32_t* seed, uint32_t seed_s, const uint32_t* step0,
    uint32_t step0_s, const float* T, float T_s, const uint32_t* chain_base,
    const int* live, const float* t_chain, int chains, int dim, int blk,
    int n_steps, int variant, void* stream) {
    const sa::SweepControls c{kid, kid_s, seed, seed_s, step0, step0_s,
                              T, T_s, chain_base, live, t_chain};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (chains <= 0) return 0;
    if (variant == 0) {
        // 64 threads a CTA spreads 16384 chains over 256 CTAs, so every SM
        // gets work.
        const int threads = 64;
        const int grid = (chains + threads - 1) / threads;
        sa::sweep_delta_kernel<<<grid, threads, 0, st>>>(
            x_in, x_out, f_out, c, chains, dim, blk, n_steps);
    } else {
        const int grid = (chains + sa::FULL_WARPS - 1) / sa::FULL_WARPS;
        sa::sweep_full_kernel<<<grid, 32 * sa::FULL_WARPS, 0, st>>>(
            x_in, x_out, f_out, c, chains, dim, blk, n_steps);
    }
    return static_cast<int>(cudaGetLastError());
}
