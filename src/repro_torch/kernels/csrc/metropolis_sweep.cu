// Kernel B1: the fused Metropolis sweep (the paper's Listing 2/4 body).
//
// Replaces repro/kernels/metropolis_sweep.py::_sweep_kernel (the Pallas TPU
// kernel behind metropolis_sweep_pallas).  One launch advances every chain
// by n_steps Metropolis steps at a fixed temperature; it computes what the
// Pallas kernel computes, not how: there the grid walks chain blocks in
// VMEM, here a CTA owns up to 32 (delta) or 16 (full) chains and one lane
// walks each.
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
// What bounds the full variant on the H100: operations, the initial
// evaluation's one term per coordinate (a Schwefel term is about 105 SASS
// instructions, counted by chip_smoke.py: 0.026 ms for 16384 x 512 at
// 3.35e13 lane-instructions/s), ahead of the same bytes (0.020 ms).  A
// re-evaluation of all dim terms per proposal (a warp per chain, the first
// design) spent dim sinf/sqrtf per step where one coordinate changed.  The design
// (sweep_full_kernel) returns the bits of that re-evaluation without its
// work:
//   - a CTA of 8 warps owns up to 16 consecutive chains (four CTAs on an
//     SM, so that one CTA's walk overlaps another's loads); their rows come
//     in once by cp.async into shared memory while all threads stage the
//     first chunk of draws, proposals and proposal terms;
//   - a warp per row copies it to x_out, replaces each x_j in shared
//     memory by its term (the term cache: x sin sqrt|x| for Schwefel, the
//     cosines in a second cache for Ackley and Griewank), folds lane l's
//     coordinates l, l + 32, ... in order and keeps the lane partials and
//     the partial sums of the __shfl_xor butterfly, so the order is fixed
//     by dim alone;
//   - warp 0, one lane per chain, walks: a step re-folds the ceil(dim/32)
//     cached terms of lane d % 32 with the proposal's term, then the five
//     tree nodes above it, and applies the accept test; an accepted step
//     writes its term, its path and its x.
// What is left: the rows' load and their evaluation run one after the
// other within a CTA, and the walk (one warp of eight) leaves the SM to
// the other CTAs.
// Rows whose cache does not fit in shared memory (dim above about 48k, or
// 24k with two caches) take sweep_full_wide_kernel, a warp per chain that
// re-evaluates every term in the same order: the same bits, slower.
#include <cuda_runtime.h>
#include <cstdint>

#include "objective_math.cuh"
#include "rng.cuh"
#include "smem.cuh"

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

// ------------------------------------------------------------ full variant
//
// A proposal changes one coordinate, so every other coordinate's terms
// are those of an unchanged x_j: they are computed once, in the initial
// pass, and kept per chain in shared memory (the term cache).  The sum
// keeps the order of a warp-wide re-evaluation: lane l folds coordinates
// l, l + 32, ... in order, then a __shfl_xor butterfly adds the 32 lane
// partials.  The butterfly's nodes are kept too (the tree), so a step that
// changes coordinate d re-folds only the partial of lane d % 32 from its
// cached terms and then the five nodes above it.

constexpr int FULL_ROWS = 16;        // most chains per CTA: one walking lane each
constexpr int FULL_THREADS = 256;
constexpr int FULL_WARPS = FULL_THREADS / 32;
constexpr int FULL_STAGE = 32;       // steps staged per chunk
constexpr int TREE_NODES = 62;       // 32 lane partials, then 16, 8, 4 and 2 sums

struct FullShared {
    ChainSetup cs[FULL_ROWS];
    float f[FULL_ROWS];
    // The butterfly of accumulators a and b, node-major so that the
    // walking lanes (one row each) hit distinct banks.
    float tree[2][TREE_NODES][FULL_ROWS];
    // One staged chunk, per step and row: the draws and the proposal's terms.
    int d[FULL_STAGE][FULL_ROWS];
    float newval[FULL_STAGE][FULL_ROWS], uacc[FULL_STAGE][FULL_ROWS];
    float na[FULL_STAGE][FULL_ROWS], nb[FULL_STAGE][FULL_ROWS];
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
                 : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The butterfly of a warp's lane partials v, leaving its nodes in
// tree[.][r] and returning the total (the same in every lane).
__device__ __forceinline__ float tree_build(float (*tree)[FULL_ROWS], int r,
                                            int lane, float v, bool prod) {
    tree[lane][r] = v;
    int base = 32;
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, v, m);
        v = prod ? v * o : v + o;
        if (m > 1 && lane < m) tree[base + lane][r] = v;
        base += m;
    }
    return v;
}

// The total with leaf o set to v: the five nodes above it, each the sum
// (product) of the new node below and its cached sibling.  path[L] is the
// new value of the level-L node on the way.
template <bool PROD>
__device__ __forceinline__ float tree_path(const float (*tree)[FULL_ROWS],
                                           int r, int o, float v,
                                           float (&path)[5]) {
    int base = 0, pos = o;
#pragma unroll
    for (int L = 0, half = 16; L < 5; ++L, half >>= 1) {
        path[L] = v;
        const float sib = tree[base + (pos ^ half)][r];
        v = PROD ? v * sib : v + sib;
        base += 2 * half;
        pos &= half - 1;
    }
    return v;
}

__device__ __forceinline__ void tree_store(float (*tree)[FULL_ROWS], int r,
                                           int o, const float (&path)[5]) {
    int base = 0, pos = o;
#pragma unroll
    for (int L = 0, half = 16; L < 5; ++L, half >>= 1) {
        tree[base + pos][r] = path[L];
        base += 2 * half;
        pos &= half - 1;
    }
}

// All threads stage steps [c0, c0 + cnt) of the CTA's live rows.
__device__ __forceinline__ void full_stage(FullShared& sh, int rows, int dim,
                                           int c0, int cnt) {
    for (int it = static_cast<int>(threadIdx.x); it < cnt * FULL_ROWS;
         it += FULL_THREADS) {
        const int s = it / FULL_ROWS, r = it % FULL_ROWS;
        if (r >= rows || !sh.cs[r].live) continue;
        int d;
        float newval, uacc, ta, tb;
        propose(sh.cs[r], c0 + s, dim, d, newval, uacc);
        full_terms(sh.cs[r].kid, newval, d, ta, tb);
        sh.d[s][r] = d;
        sh.newval[s][r] = newval;
        sh.uacc[s][r] = uacc;
        sh.na[s][r] = ta;
        sh.nb[s][r] = tb;
    }
}

// Lane r walks a staged chunk of row r: re-fold the changed lane partial
// from the cached terms, then the tree, then the accept test.  An accepted
// step writes its terms and its path into the caches and its value to x.
template <int KID>
__device__ __forceinline__ void full_walk_kid(FullShared& sh, float* ca,
                                              float* cb, int r, int cnt,
                                              float T, int dim, float* xrow,
                                              float& fx) {
    constexpr bool B = KID == KID_ACKLEY || KID == KID_GRIEWANK;
    constexpr bool PROD = KID == KID_GRIEWANK;
    for (int s = 0; s < cnt; ++s) {
        const int d = sh.d[s][r];
        const float na = sh.na[s][r], nb = B ? sh.nb[s][r] : 0.0f;
        const float u = sh.uacc[s][r];
        const int o = d & 31, k = d >> 5, terms = (dim - o + 31) >> 5;
        float a = 0.0f, b = PROD ? 1.0f : 0.0f;
        // Unrolled so that the cached terms' loads are issued together;
        // only the adds stay in order.
#pragma unroll 8
        for (int kk = 0; kk < terms; ++kk) {
            a += kk == k ? na : ca[o + 32 * kk];
            if (B) {
                const float t = kk == k ? nb : cb[o + 32 * kk];
                b = PROD ? b * t : b + t;
            }
        }
        float pa[5], pb[5];
        const float A = tree_path<false>(sh.tree[0], r, o, a, pa);
        const float Bt = B ? tree_path<PROD>(sh.tree[1], r, o, b, pb) : 0.0f;
        const float f1 = full_finish(KID, A, Bt, dim);
        if (accept(u, fx, f1, T)) {
            ca[d] = na;
            tree_store(sh.tree[0], r, o, pa);
            if (B) {
                cb[d] = nb;
                tree_store(sh.tree[1], r, o, pb);
            }
            xrow[d] = sh.newval[s][r];
            fx = f1;
        }
    }
}

__device__ __forceinline__ void full_walk(int kid, FullShared& sh, float* ca,
                                          float* cb, int r, int cnt, float T,
                                          int dim, float* xrow, float& fx) {
    switch (kid) {
        case KID_RASTRIGIN:
            full_walk_kid<KID_RASTRIGIN>(sh, ca, cb, r, cnt, T, dim, xrow, fx);
            break;
        case KID_ACKLEY:
            full_walk_kid<KID_ACKLEY>(sh, ca, cb, r, cnt, T, dim, xrow, fx);
            break;
        case KID_GRIEWANK:
            full_walk_kid<KID_GRIEWANK>(sh, ca, cb, r, cnt, T, dim, xrow, fx);
            break;
        case KID_EXPONENTIAL:
            full_walk_kid<KID_EXPONENTIAL>(sh, ca, cb, r, cnt, T, dim, xrow, fx);
            break;
        case KID_SALOMON:
            full_walk_kid<KID_SALOMON>(sh, ca, cb, r, cnt, T, dim, xrow, fx);
            break;
        default:
            full_walk_kid<KID_SCHWEFEL>(sh, ca, cb, r, cnt, T, dim, xrow, fx);
            break;
    }
}

// A CTA owns `rpc` (<= 16) consecutive chains.  Dynamic shared memory holds
// their term caches: rpc rows of dim a-terms, then, with two_caches, rpc
// rows of b-terms (Ackley's and Griewank's cosines).
__global__ void __launch_bounds__(FULL_THREADS, 4)
sweep_full_kernel(const float* __restrict__ x_in, float* x_out,
                  float* __restrict__ f_out, SweepControls c, int chains,
                  int dim, int blk, int n_steps, int rpc, int two_caches) {
    extern __shared__ float4 cache4[];
    __shared__ FullShared sh;
    float* cache_a = reinterpret_cast<float*>(cache4);
    float* cache_b = two_caches ? cache_a + static_cast<size_t>(rpc) * dim : nullptr;
    const int first = blockIdx.x * rpc;
    const int rows = min(rpc, chains - first);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (static_cast<int>(threadIdx.x) < rows)
        sh.cs[threadIdx.x] = setup(c, first + threadIdx.x, blk);

    // The rows are one contiguous range: copy it into the a-cache, in
    // 16-byte pieces where rows are 16-byte aligned, and stage the first
    // chunk while it arrives (the draws do not depend on x).
    const float* src = x_in + static_cast<size_t>(first) * dim;
    const int total = rows * dim;
    if ((dim & 3) == 0 && (reinterpret_cast<uintptr_t>(x_in) & 15u) == 0) {
        for (int q = threadIdx.x; q < total / 4; q += FULL_THREADS)
            cp_async16(cache_a + 4 * q, src + 4 * q);
    } else {
        for (int e = threadIdx.x; e < total; e += FULL_THREADS)
            cp_async4(cache_a + e, src + e);
    }
    cp_async_commit();
    __syncthreads();
    full_stage(sh, rows, dim, 0, min(FULL_STAGE, n_steps));
    cp_async_wait_all();
    __syncthreads();

    // A warp per row: x to x_out, the terms into the caches in place, lane
    // l folding coordinates l, l + 32, ... in order, then the butterfly.
    for (int r = warp; r < rows; r += FULL_WARPS) {
        const int kid = sh.cs[r].kid;
        float* xa = cache_a + static_cast<size_t>(r) * dim;
        float* xb = two_caches ? cache_b + static_cast<size_t>(r) * dim : nullptr;
        float* xo = x_out + static_cast<size_t>(first + r) * dim;
        float a = 0.0f, b = b_init(kid);
        for (int j = lane; j < dim; j += 32) {
            const float xj = xa[j];
            xo[j] = xj;
            float ta, tb;
            full_terms(kid, xj, j, ta, tb);
            xa[j] = ta;
            a += ta;
            if (has_b(kid)) {
                xb[j] = tb;
                b = fold_b(kid, b, tb);
            }
        }
        a = tree_build(sh.tree[0], r, lane, a, false);
        if (has_b(kid)) b = tree_build(sh.tree[1], r, lane, b, kid == KID_GRIEWANK);
        if (lane == 0) sh.f[r] = full_finish(kid, a, b, dim);
    }
    __syncthreads();

    // Warp 0 walks, lane r carrying row r's f; all warps stage each later
    // chunk before its walk.
    const bool walks = warp == 0 && lane < rows && sh.cs[lane].live;
    float fx = (warp == 0 && lane < rows) ? sh.f[lane] : 0.0f;
    for (int c0 = 0; c0 < n_steps; c0 += FULL_STAGE) {
        const int cnt = min(FULL_STAGE, n_steps - c0);
        if (c0 > 0) {
            full_stage(sh, rows, dim, c0, cnt);
            __syncthreads();
        }
        if (walks)
            full_walk(sh.cs[lane].kid, sh, cache_a + static_cast<size_t>(lane) * dim,
                      two_caches ? cache_b + static_cast<size_t>(lane) * dim : nullptr,
                      lane, cnt, sh.cs[lane].T, dim,
                      x_out + static_cast<size_t>(first + lane) * dim, fx);
        __syncthreads();
    }
    if (warp == 0 && lane < rows) f_out[first + lane] = fx;
}

// Rows whose term cache does not fit in shared memory: a warp per chain
// re-evaluates all dim terms of every proposal, lanes striding the
// coordinates in the same order, so the result is the same bits.
__device__ __forceinline__ float warp_full_eval(int kid, const float* xo,
                                                int dim, int lane, int d,
                                                float newval) {
    float a = 0.0f, b = b_init(kid);
    for (int j = lane; j < dim; j += 32)
        full_term(kid, j == d ? newval : xo[j], j, a, b);
    a = warp_sum(a);
    if (has_b(kid)) b = kid == KID_GRIEWANK ? warp_prod(b) : warp_sum(b);
    return full_finish(kid, a, b, dim);
}

constexpr int WIDE_WARPS = 4;

__global__ void sweep_full_wide_kernel(const float* __restrict__ x_in,
                                       float* __restrict__ x_out,
                                       float* __restrict__ f_out,
                                       SweepControls c, int chains, int dim,
                                       int blk, int n_steps) {
    const int lane = threadIdx.x & 31;
    const int chain = blockIdx.x * WIDE_WARPS + (threadIdx.x >> 5);
    if (chain >= chains) return;  // whole warps only
    const ChainSetup s = setup(c, chain, blk);
    const float* xr = x_in + static_cast<size_t>(chain) * dim;
    float* xo = x_out + static_cast<size_t>(chain) * dim;
    for (int j = lane; j < dim; j += 32) xo[j] = xr[j];
    __syncwarp();

    float fx = warp_full_eval(s.kid, xo, dim, lane, -1, 0.0f);
    for (int i = 0; s.live && i < n_steps; ++i) {
        int d;
        float newval, uacc;
        propose(s, i, dim, d, newval, uacc);
        const float f1 = warp_full_eval(s.kid, xo, dim, lane, d, newval);
        // Every lane holds the same f1, so every lane takes the same branch.
        if (accept(uacc, fx, f1, s.T)) {
            if ((d & 31) == lane) xo[d] = newval;
            fx = f1;
        }
        __syncwarp();
    }
    if (lane == 0) f_out[chain] = fx;
}

// Shared memory a full-variant CTA can hold, static and dynamic, and the
// share of it the term caches take when four CTAs share an SM.
constexpr size_t SMEM_BLOCK_MAX = 232448;
constexpr size_t FULL_CACHE_BUDGET = 32 * 1024;

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
        // Rows per CTA: 16 where their caches fit the budget, fewer for
        // wide rows.  The b-cache is needed by Ackley and Griewank only; a
        // per-block kid array may hold them.
        const bool two = kid != nullptr || kid_s == sa::KID_ACKLEY ||
                         kid_s == sa::KID_GRIEWANK;
        const size_t row_bytes = static_cast<size_t>(dim) * 4 * (two ? 2 : 1);
        int rpc = sa::FULL_ROWS;
        while (rpc > 1 && rpc * row_bytes > sa::FULL_CACHE_BUDGET) rpc >>= 1;
        const size_t shmem = rpc * row_bytes;
        if (shmem + sizeof(sa::FullShared) <= sa::SMEM_BLOCK_MAX) {
            static sa::SmemOptIn opt_in;
            const cudaError_t e = opt_in.allow(sa::sweep_full_kernel,
                                               shmem + sizeof(sa::FullShared), shmem);
            if (e != cudaSuccess) return static_cast<int>(e);
            const int grid = (chains + rpc - 1) / rpc;
            sa::sweep_full_kernel<<<grid, sa::FULL_THREADS, shmem, st>>>(
                x_in, x_out, f_out, c, chains, dim, blk, n_steps, rpc, two);
        } else {
            const int grid = (chains + sa::WIDE_WARPS - 1) / sa::WIDE_WARPS;
            sa::sweep_full_wide_kernel<<<grid, 32 * sa::WIDE_WARPS, 0, st>>>(
                x_in, x_out, f_out, c, chains, dim, blk, n_steps);
        }
    }
    return static_cast<int>(cudaGetLastError());
}
