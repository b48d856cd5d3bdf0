// Kernel B1: the fused Metropolis sweep (the paper's Listing 2/4 body).
//
// Replaces repro/kernels/metropolis_sweep.py::_sweep_kernel (the Pallas TPU
// kernel behind metropolis_sweep_pallas).  One launch advances every chain
// by n_steps Metropolis steps at a fixed temperature; it computes what the
// Pallas kernel computes, not how: there the grid walks chain blocks in
// VMEM, here a CTA owns 32 chains (delta) or a warp owns one (full).
//
// Per-block controls, one entry per block of `blk` chains (a serving slot):
// kid, seed, step0, T, chain_base and live.  A NULL pointer means the
// scalar value beside it applies to every block (chain_base NULL: b * blk;
// live NULL: every block live).  t_chain, when given, replaces the block
// temperature chain by chain.  Chain c of block b draws from stream
// (seed[b], chain_base[b] + c, step0[b] + i), so a chain's trajectory does
// not depend on where it was packed.
//
// What bounds the delta variant on the H100: bytes, x read once and
// written once (67 MB at the main path's 16384 x 512: 0.020 ms at
// 3.35 TB/s), ahead of the two threefry2x32 per proposal.  A chain's walk
// is serial, so one thread per chain leaves the card idle (16384 threads
// are 4 warps per SM) and puts every draw and transcendental on the
// serial path.  The design (sweep_delta_kernel):
//   - a CTA of 8 warps owns 32 consecutive chains, whose rows are one
//     contiguous range: read once in 16-byte vectors and written once to
//     x_out by the same threads (rows that are not 16-byte aligned, or
//     dim % 4 != 0, take 4-byte loads of the same coordinates); cp.async
//     keeps a warp's next row segment in flight while its lanes evaluate
//     the current one;
//   - the initial evaluation runs a warp per row: lane l sums the terms of
//     coordinates 128 g + 4 l + j in that order and a butterfly adds the
//     lanes, so the order depends on dim alone, never on where a chain
//     sits; kids whose product factor is 1 skip log_mag and sign_of;
//   - what a step needs that does not depend on the walk (the draws, the
//     coordinate, the proposed value and its term) is staged in shared
//     memory by all 256 threads, STAGE steps at a time, with the term of
//     the coordinate's value at the chunk's start and the chunk's latest
//     earlier step that drew the same coordinate;
//   - warp 0, one lane per chain, then walks the chunk: the accumulator
//     arithmetic, combine and the accept test, in the order of the plain
//     version, so the trajectory is the one a serial recomputation gives,
//     bit for bit.  The objective is a template argument of the walk and
//     the next step's inputs are read ahead.  An accepted value goes to
//     x_out; a later step on the same coordinate reads the term the walk
//     left for it.
// What is left: the 33 serial steps of each walk (about 500 SM cycles
// each, with the other seven warps waiting) and the staging, which runs
// after the rows have streamed through, not beside them.
// The full variant keeps its design: one warp per chain, lanes striding the
// coordinates of each re-evaluation (coalesced), a __shfl_xor butterfly
// leaving the same total in every lane; the dim transcendentals of each
// proposal bound it.
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

constexpr int DELTA_ROWS = 32;      // chains per CTA: one walking lane each
constexpr int DELTA_THREADS = 256;
constexpr int DELTA_WARPS = DELTA_THREADS / 32;
constexpr int STAGE = 16;           // steps staged per chunk
constexpr int SEG_Q = 128;          // a row segment: 128 16-byte vectors, 512 floats

// A coordinate's contribution as the walk uses it: s0, then a1 (Ackley:
// s1; Griewank: log_mag(p)) and a2 (Griewank: sign_of(p); else 1).
struct Contrib {
    float s0, a1, a2;
};

__device__ __forceinline__ Contrib contrib(int kid, float xi, int d) {
    float s0, s1, p;
    term(kid, xi, static_cast<float>(d), s0, s1, p);
    if (kid == KID_GRIEWANK) return {s0, log_mag(p), sign_of(p)};
    return {s0, kid == KID_ACKLEY ? s1 : 0.0f, 1.0f};
}

// One staged chunk, per step and chain: the draws and the proposal's
// contribution (n*); src, the latest earlier step of the chunk that drew
// the same coordinate (the step itself if none); a*, for a step that is
// its own src the contribution of the coordinate's value at the chunk's
// start, and once the walk has passed a step, the contribution of the
// value the step left.
struct StageArrays {
    int d[STAGE][DELTA_ROWS], src[STAGE][DELTA_ROWS];
    float newval[STAGE][DELTA_ROWS], uacc[STAGE][DELTA_ROWS];
    float n0[STAGE][DELTA_ROWS], n1[STAGE][DELTA_ROWS], n2[STAGE][DELTA_ROWS];
    float a0[STAGE][DELTA_ROWS], a1[STAGE][DELTA_ROWS], a2[STAGE][DELTA_ROWS];
};

struct DeltaShared {
    // Per chain of the CTA.
    ChainSetup cs[DELTA_ROWS];
    float S0[DELTA_ROWS], S1[DELTA_ROWS], logP[DELTA_ROWS], sgnP[DELTA_ROWS];
    union {
        // The initial pass: each warp's two row segments in flight.
        float4 seg[DELTA_WARPS][2][SEG_Q];
        StageArrays st;  // the steps
    };
};

// 16-byte copies from global to shared memory that hold no registers
// while in flight (cp.async, L2 only); each lane reads back only what it
// copied, so a lane's own wait orders them.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior() {  // all but the newest group
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Fold coordinate c of a row into a lane's partial sums.
__device__ __forceinline__ void fold_coord(int kid, float xi, int c, float& s0,
                                           float& s1, float& lp, float& sg) {
    float t0, t1, p;
    term(kid, xi, static_cast<float>(c), t0, t1, p);
    s0 += t0;
    if (kid == KID_ACKLEY) s1 += t1;
    if (kid == KID_GRIEWANK) {
        lp += log_mag(p);
        sg *= sign_of(p);
    }
}

// Add the lanes' partial sums of row r (a butterfly: the same total in
// every lane) and keep them for the walk.
__device__ __forceinline__ void finish_row(DeltaShared& sh, int r, int kid,
                                           int lane, float s0, float s1,
                                           float lp, float sg) {
    s0 = warp_sum(s0);
    if (kid == KID_ACKLEY) s1 = warp_sum(s1);
    if (kid == KID_GRIEWANK) {
        lp = warp_sum(lp);
        sg = warp_prod(sg);
    }
    if (lane == 0) {
        sh.S0[r] = s0;
        sh.S1[r] = s1;
        sh.logP[r] = lp;
        sh.sgnP[r] = sg;
    }
}

// All threads stage steps [c0, c0 + cnt) of the CTA's live chains,
// step-major so that a warp stages one step of the 32 chains.
__device__ __forceinline__ void stage_chunk(DeltaShared& sh, const float* x_out,
                                            int first, int rows, int dim,
                                            int c0, int cnt) {
    StageArrays& b = sh.st;
    for (int it = static_cast<int>(threadIdx.x); it < cnt * DELTA_ROWS;
         it += DELTA_THREADS) {
        const int s = it / DELTA_ROWS, r = it % DELTA_ROWS;
        if (r >= rows || !sh.cs[r].live) continue;
        int d;
        float newval, uacc;
        propose(sh.cs[r], c0 + s, dim, d, newval, uacc);
        const Contrib n = contrib(sh.cs[r].kid, newval, d);
        b.d[s][r] = d;
        b.newval[s][r] = newval;
        b.uacc[s][r] = uacc;
        b.n0[s][r] = n.s0;
        b.n1[s][r] = n.a1;
        b.n2[s][r] = n.a2;
    }
    __syncthreads();
    for (int it = static_cast<int>(threadIdx.x); it < cnt * DELTA_ROWS;
         it += DELTA_THREADS) {
        const int s = it / DELTA_ROWS, r = it % DELTA_ROWS;
        if (r >= rows || !sh.cs[r].live) continue;
        const int d = b.d[s][r];
        int src = s;
        for (int k = s - 1; k >= 0; --k)
            if (b.d[k][r] == d) { src = k; break; }
        b.src[s][r] = src;
        if (src == s) {
            const Contrib a = contrib(
                sh.cs[r].kid, x_out[static_cast<size_t>(first + r) * dim + d], d);
            b.a0[s][r] = a.s0;
            b.a1[s][r] = a.a1;
            b.a2[s][r] = a.a2;
        }
    }
}

// Walk a staged chunk: lane r, chain r of the CTA, carries its
// accumulators.  The objective is a template argument, so each step is
// straight-line code, and the next step's staged inputs are read before
// this step's decision: only the arithmetic of the plain version, in its
// order, is left on the serial path.
template <int KID>
__device__ __forceinline__ void walk_kid(StageArrays& b, int r, int cnt,
                                           float T, int dim, float* xrow,
                                           float& S0, float& S1, float& logP,
                                           float& sgnP, float& fx) {
    int src = b.src[0][r];
    float a0 = b.a0[src][r], a1 = b.a1[src][r], a2 = b.a2[src][r];
    for (int s = 0; s < cnt; ++s) {
        const float n0 = b.n0[s][r], n1 = b.n1[s][r], n2 = b.n2[s][r];
        const float u = b.uacc[s][r];
        // The next step's contribution before it, unless this step is the
        // one that sets it.
        int src_nx = s;
        float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;
        if (s + 1 < cnt) {
            src_nx = b.src[s + 1][r];
            if (src_nx != s) {
                p0 = b.a0[src_nx][r];
                p1 = b.a1[src_nx][r];
                p2 = b.a2[src_nx][r];
            }
        }
        const float S0n = S0 - a0 + n0;
        const float S1n = KID == KID_ACKLEY ? S1 - a1 + n1 : S1;
        const float logPn = KID == KID_GRIEWANK ? logP - a1 + n1 : logP;
        const float sgnPn = KID == KID_GRIEWANK ? sgnP * (a2 * n2) : sgnP;
        const float f1 = combine(KID, S0n, S1n, logPn, sgnPn, dim);
        const bool acc = accept(u, fx, f1, T);
        if (acc) {
            xrow[b.d[s][r]] = b.newval[s][r];
            fx = f1;
            S0 = S0n;
            S1 = S1n;
            logP = logPn;
            sgnP = sgnPn;
        }
        const float l0 = acc ? n0 : a0, l1 = acc ? n1 : a1, l2 = acc ? n2 : a2;
        b.a0[s][r] = l0;
        b.a1[s][r] = l1;
        b.a2[s][r] = l2;
        if (src_nx == s) {
            a0 = l0;
            a1 = l1;
            a2 = l2;
        } else {
            a0 = p0;
            a1 = p1;
            a2 = p2;
        }
    }
}

__device__ __forceinline__ void walk_chunk(int kid, StageArrays& b, int r,
                                           int cnt, float T, int dim,
                                           float* xrow, float& S0, float& S1,
                                           float& logP, float& sgnP,
                                           float& fx) {
    switch (kid) {
        case KID_RASTRIGIN:
            walk_kid<KID_RASTRIGIN>(b, r, cnt, T, dim, xrow, S0, S1, logP, sgnP, fx);
            break;
        case KID_ACKLEY:
            walk_kid<KID_ACKLEY>(b, r, cnt, T, dim, xrow, S0, S1, logP, sgnP, fx);
            break;
        case KID_GRIEWANK:
            walk_kid<KID_GRIEWANK>(b, r, cnt, T, dim, xrow, S0, S1, logP, sgnP, fx);
            break;
        case KID_EXPONENTIAL:
            walk_kid<KID_EXPONENTIAL>(b, r, cnt, T, dim, xrow, S0, S1, logP, sgnP, fx);
            break;
        case KID_SALOMON:
            walk_kid<KID_SALOMON>(b, r, cnt, T, dim, xrow, S0, S1, logP, sgnP, fx);
            break;
        default:
            walk_kid<KID_SCHWEFEL>(b, r, cnt, T, dim, xrow, S0, S1, logP, sgnP, fx);
            break;
    }
}

__global__ void __launch_bounds__(DELTA_THREADS, 4)
sweep_delta_kernel(const float* __restrict__ x_in, float* x_out,
                   float* __restrict__ f_out, SweepControls c, int chains,
                   int dim, int blk, int n_steps) {
    __shared__ DeltaShared sh;
    const int first = blockIdx.x * DELTA_ROWS;
    const int rows = min(DELTA_ROWS, chains - first);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (static_cast<int>(threadIdx.x) < rows)
        sh.cs[threadIdx.x] = setup(c, first + threadIdx.x, blk);
    __syncthreads();

    // Copy the rows to x_out and sum each row's terms, a warp per row.
    const bool vec = (dim & 3) == 0 &&
                     ((reinterpret_cast<uintptr_t>(x_in) |
                       reinterpret_cast<uintptr_t>(x_out)) & 15u) == 0;
    float s0 = 0.0f, s1 = 0.0f, lp = 0.0f, sg = 1.0f;
    if (vec) {
        // The warp's rows, segment by segment, the next segment's copy in
        // flight while the lanes evaluate this one.
        const int nq = dim >> 2, nseg = (nq + SEG_Q - 1) / SEG_Q;
        const int items =
            warp < rows ? (rows - warp + DELTA_WARPS - 1) / DELTA_WARPS * nseg : 0;
        auto issue = [&](int k) {
            const int r = warp + (k / nseg) * DELTA_WARPS, q0 = (k % nseg) * SEG_Q;
            const float4* src = reinterpret_cast<const float4*>(
                                    x_in + static_cast<size_t>(first + r) * dim) + q0;
            for (int q = lane; q < min(SEG_Q, nq - q0); q += 32)
                cp_async16(&sh.seg[warp][k & 1][q], src + q);
            cp_async_commit();
        };
        if (items > 0) issue(0);
        for (int k = 0; k < items; ++k) {
            if (k + 1 < items) issue(k + 1);
            else cp_async_commit();  // an empty group: the wait below stays the same
            cp_async_wait_prior();
            const int r = warp + (k / nseg) * DELTA_WARPS, g = k % nseg, q0 = g * SEG_Q;
            const int kid = sh.cs[r].kid;
            float4* xo = reinterpret_cast<float4*>(
                             x_out + static_cast<size_t>(first + r) * dim) + q0;
            for (int q = lane; q < min(SEG_Q, nq - q0); q += 32) {
                const float4 v = sh.seg[warp][k & 1][q];
                xo[q] = v;
                const int cc = 4 * (q0 + q);
                fold_coord(kid, v.x, cc, s0, s1, lp, sg);
                fold_coord(kid, v.y, cc + 1, s0, s1, lp, sg);
                fold_coord(kid, v.z, cc + 2, s0, s1, lp, sg);
                fold_coord(kid, v.w, cc + 3, s0, s1, lp, sg);
            }
            if (g == nseg - 1) {
                finish_row(sh, r, kid, lane, s0, s1, lp, sg);
                s0 = s1 = lp = 0.0f;
                sg = 1.0f;
            }
        }
    } else {
        // The same coordinates per lane in the same order, 4 bytes a load.
        for (int r = warp; r < rows; r += DELTA_WARPS) {
            const int kid = sh.cs[r].kid;
            const size_t off = static_cast<size_t>(first + r) * dim;
            for (int q = lane; 4 * q < dim; q += 32) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int cc = 4 * q + j;
                    if (cc < dim) {
                        const float xi = x_in[off + cc];
                        x_out[off + cc] = xi;
                        fold_coord(kid, xi, cc, s0, s1, lp, sg);
                    }
                }
            }
            finish_row(sh, r, kid, lane, s0, s1, lp, sg);
            s0 = s1 = lp = 0.0f;
            sg = 1.0f;
        }
    }
    __syncthreads();

    // Warp 0 walks, lane r carrying chain r's accumulators in registers;
    // all eight warps stage each chunk before its walk.
    float S0 = 0.0f, S1 = 0.0f, logP = 0.0f, sgnP = 1.0f, fx = 0.0f;
    int kid_w = 0;
    bool walks = false;
    if (warp == 0 && lane < rows) {
        kid_w = sh.cs[lane].kid;
        S0 = sh.S0[lane];
        S1 = sh.S1[lane];
        logP = sh.logP[lane];
        sgnP = sh.sgnP[lane];
        fx = combine(kid_w, S0, S1, logP, sgnP, dim);
        walks = sh.cs[lane].live;
    }
    for (int c0 = 0; c0 < n_steps; c0 += STAGE) {
        const int cnt = min(STAGE, n_steps - c0);
        stage_chunk(sh, x_out, first, rows, dim, c0, cnt);
        __syncthreads();
        if (walks)
            walk_chunk(kid_w, sh.st, lane, cnt, sh.cs[lane].T, dim,
                       x_out + static_cast<size_t>(first + lane) * dim, S0, S1,
                       logP, sgnP, fx);
        __syncthreads();
    }
    if (warp == 0 && lane < rows) f_out[first + lane] = fx;
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
        // 16384 chains make 512 CTAs: four on each SM, one wave.
        const int grid = (chains + sa::DELTA_ROWS - 1) / sa::DELTA_ROWS;
        sa::sweep_delta_kernel<<<grid, sa::DELTA_THREADS, 0, st>>>(
            x_in, x_out, f_out, c, chains, dim, blk, n_steps);
    } else {
        const int grid = (chains + sa::FULL_WARPS - 1) / sa::FULL_WARPS;
        sa::sweep_full_kernel<<<grid, 32 * sa::FULL_WARPS, 0, st>>>(
            x_in, x_out, f_out, c, chains, dim, blk, n_steps);
    }
    return static_cast<int>(cudaGetLastError());
}
