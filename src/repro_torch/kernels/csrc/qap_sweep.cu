// Kernel B3: the pairwise-exchange QAP sweep (permutation family).
//
// Replaces repro/kernels/qap_sweep.py::_qap_kernel (the Pallas TPU kernel
// behind qap_sweep_pallas).  One launch advances every chain, an int32
// permutation p of n locations, by n_steps pairwise-exchange Metropolis
// moves at its block's temperature.  It computes what the Pallas kernel
// computes, not how: there the grid walks chain blocks in VMEM and gathers
// through one-hot matmuls; here each chain is a group of lanes that
// gathers by index from shared memory.
//
// Per block of `blk` chains (a serving slot): its own flow and distance
// matrices F, D (each packed (n_blocks * n, n), or one (n, n) for every
// block; f_per_block and d_per_block say which, matrix by matrix)
// and the controls T, seed, step0, chain_base and live.  A NULL control
// pointer means the scalar beside it applies to every block (chain_base
// NULL: b * blk; live NULL: every block live).  Chain c of block b draws
// from stream (seed[b], chain_base[b] + c, step0[b] + s), as B1 does.
//
// Exactness: F and D hold small integers, so every product and partial sum
// below is an integer under 2^24 and float32 arithmetic on them is exact in
// any order.  The initial cost, the carried f and the plain version
// (ref.qap_sweep_ref) therefore agree bit for bit; only expf, in the accept
// test, may differ from PyTorch's exp by an ulp.
//
// What bounds it on the H100: integer instructions, two threefry2x32 (20
// rounds each) per move, ahead of the O(n) delta's ~10 n float32
// operations and the n * 4 bytes of state read and written once per sweep.
// A thread per chain left the card nearly empty (phase 8's group of 32768
// chains made 128 CTAs of 8 warps) with every draw and every dependent
// shared-memory gather of the delta on one thread's serial path.  The
// design:
//   - a CTA serves one block (a serving slot), so F and D (2 n^2 floats)
//     and the controls are its own, staged once;
//   - each chain is a group of g lanes (g = 1, 2, 4 or 8: at most four of
//     its n locations per lane), so 256 threads serve 256 / g chains and
//     phase 8's 32768 chains make 512 CTAs, about four on each SM; the
//     O(n^2) initial cost and each move's O(n) delta are split over the
//     group by location and folded with __shfl_xor, and every lane of the
//     group sees the same delta and takes the same accept branch;
//   - the draws do not depend on p: all threads of the CTA stage (i, j,
//     u_accept) of every chain for a chunk of steps in shared memory, so
//     only the gathers, the delta and the accept test stay serial;
//   - for n <= 16 the CTA tabulates the F and D differences a move
//     multiplies (below), a third of the gathers per location;
//   - permutations live in shared memory, a row per chain, copied in and
//     out coalesced; chains beyond the block's end in its last CTA walk an
//     identity permutation and are not written back.
// What is left: the moves themselves, about two thirds of the time at
// phase 8's shape.  The likeliest cause, not measured (no profiler of
// the card's counters): the eight chains of a warp gather rows chosen by
// their own draws, so their loads meet in the same banks and a move costs
// several times the shared-memory wavefronts its bytes need.
// A dead block skips its moves: its p passes through and its f is the
// recomputed cost of that p.
#include <cuda_runtime.h>
#include <cstdint>

#include "rng.cuh"
#include "smem.cuh"

namespace sa {

constexpr int QAP_MAX_N = 32;
constexpr int QAP_TABLE_MAX_N = 16;    // largest n whose difference tables fit
constexpr int QAP_THREADS = 256;
constexpr int QAP_STAGE_ITEMS = 1024;  // staged (chain, step) draws per chunk

// Lanes per chain: each holds at most four of the n locations.
inline int qap_group(int n) { return n <= 4 ? 1 : n <= 8 ? 2 : n <= 16 ? 4 : 8; }

struct QapControls {
    const float* T;
    float T_s;
    const uint32_t* seed;
    uint32_t seed_s;
    const uint32_t* step0;
    uint32_t step0_s;
    const uint32_t* chain_base;
    const int* live;
};

// Sum over the aligned group of g lanes, left in every lane of it.
__device__ __forceinline__ float group_sum(float v, int g) {
    for (int m = g >> 1; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

// Shared memory of a CTA, in floats: F and D, with TABLE the difference
// tables (2 n^3 float2), the permutations and the staged draws.
inline size_t qap_smem_floats(int n, int cpc, int stage, bool table) {
    const size_t nn = static_cast<size_t>(n) * n;
    return 2 * nn + (table ? 4 * nn * n : 0) + static_cast<size_t>(cpc) * n
           + 2 * static_cast<size_t>(stage) * cpc;
}

// With TABLE (n <= QAP_TABLE_MAX_N) the CTA first tabulates the
// differences a move multiplies, per (i, j, k) for F and per (a, b, y)
// for D:
//   dF[i][j][k] = (F[i][k] - F[j][k], F[k][i] - F[k][j])
//   dD[a][b][y] = (D[b][y] - D[a][y], D[y][b] - D[y][a])
// so that location k of a move costs p[k] and two 8-byte loads instead of
// p[k] and eight 4-byte gathers.  Entries are small integers, so the
// differences and products are the same numbers either way.
template <bool TABLE>
__global__ void __launch_bounds__(QAP_THREADS)
qap_sweep_kernel(const int* __restrict__ p_in, int* __restrict__ p_out,
                 float* __restrict__ f_out, const float* __restrict__ F,
                 const float* __restrict__ D, int f_per_block, int d_per_block,
                 QapControls c, int n, int blk, int n_steps, int g, int stage) {
    extern __shared__ float4 smem4[];
    const int threads = blockDim.x, cpc = threads / g;  // chains per CTA
    const int nn = n * n;
    float* Fs = reinterpret_cast<float*>(smem4);
    float* Ds = Fs + nn;
    float2* dF = reinterpret_cast<float2*>(Ds + nn);    // TABLE only
    float2* dD = dF + nn * n;
    int* ps = reinterpret_cast<int*>(Ds + nn + (TABLE ? 4 * nn * n : 0));  // (cpc, n)
    int* s_ij = ps + cpc * n;                           // (stage, cpc): i | j << 8
    float* s_u = reinterpret_cast<float*>(s_ij + stage * cpc);
    const int b = blockIdx.x;
    const size_t f_off = f_per_block ? static_cast<size_t>(b) * nn : 0;
    const size_t d_off = d_per_block ? static_cast<size_t>(b) * nn : 0;
    for (int e = threadIdx.x; e < nn; e += threads) {
        Fs[e] = F[f_off + e];
        Ds[e] = D[d_off + e];
    }
    // This CTA's chains are rows [first, first + rows) of p, contiguous.
    const int lane0 = blockIdx.y * cpc;
    const int rows = min(cpc, blk - lane0);
    const size_t first = static_cast<size_t>(b) * blk + lane0;
    const int* pin = p_in + first * n;
    for (int e = threadIdx.x; e < cpc * n; e += threads)
        ps[e] = e < rows * n ? pin[e] : e % n;
    const float T = c.T ? c.T[b] : c.T_s;
    const uint32_t seed = c.seed ? c.seed[b] : c.seed_s;
    const uint32_t step0 = c.step0 ? c.step0[b] : c.step0_s;
    const uint32_t cidx0 =
        (c.chain_base ? c.chain_base[b]
                      : static_cast<uint32_t>(b) * static_cast<uint32_t>(blk))
        + static_cast<uint32_t>(lane0);
    const bool live = c.live ? (c.live[b] != 0) : true;
    __syncthreads();
    if (TABLE && live) {
        for (int e = threadIdx.x; e < nn * n; e += threads) {
            const int x = e / nn, y = (e / n) % n, k = e % n;
            dF[e] = make_float2(Fs[x * n + k] - Fs[y * n + k],
                                Fs[k * n + x] - Fs[k * n + y]);
            dD[e] = make_float2(Ds[y * n + k] - Ds[x * n + k],
                                Ds[k * n + y] - Ds[k * n + x]);
        }
    }

    const int ch = threadIdx.x / g, lg = threadIdx.x % g;
    int* pr = ps + ch * n;
    float fx = 0.0f;
    for (int u = lg; u < n; u += g) {
        const float* Du = Ds + pr[u] * n;
        for (int v = 0; v < n; ++v) fx += Fs[u * n + v] * Du[pr[v]];
    }
    fx = group_sum(fx, g);

    for (int c0 = 0; live && c0 < n_steps; c0 += stage) {
        const int cnt = min(stage, n_steps - c0);
        __syncthreads();  // the tables are built, the previous chunk is read
        // Unrolled: the threefry chains of several items interleave.
#pragma unroll 4
        for (int it = threadIdx.x; it < cnt * cpc; it += threads) {
            const int s = it / cpc, r = it % cpc;
            uint32_t rbits;
            float uval, uacc;
            draws3(seed, cidx0 + static_cast<uint32_t>(r),
                   step0 + static_cast<uint32_t>(c0 + s), rbits, uval, uacc);
            const int i = static_cast<int>(rbits % static_cast<uint32_t>(n));
            const int j = min(static_cast<int>(uval * static_cast<float>(n)),
                              n - 1);
            s_ij[it] = i | (j << 8);
            s_u[it] = uacc;
        }
        __syncthreads();
        for (int s = 0; s < cnt; ++s) {
            const int ij = s_ij[s * cpc + ch];
            const float uacc = s_u[s * cpc + ch];
            const int i = ij & 255, j = ij >> 8;
            const int a = pr[i];
            const int bj = pr[j];
            float sum = 0.0f;
            if (TABLE) {
                const float2* fr = dF + (i * n + j) * n;
                const float2* dr = dD + (a * n + bj) * n;
                for (int k = lg; k < n; k += g) {
                    if (k == i || k == j) continue;
                    const float2 fk = fr[k], dk = dr[pr[k]];
                    sum += fk.x * dk.x;
                    sum += fk.y * dk.y;
                }
            } else {
                const float* Fi = Fs + i * n;
                const float* Fj = Fs + j * n;
                const float* Da = Ds + a * n;
                const float* Db = Ds + bj * n;
                for (int k = lg; k < n; k += g) {
                    if (k == i || k == j) continue;
                    const int pk = pr[k];
                    const float* Dk = Ds + pk * n;
                    sum += (Fi[k] - Fj[k]) * (Db[pk] - Da[pk]);
                    sum += (Fs[k * n + i] - Fs[k * n + j]) * (Dk[bj] - Dk[a]);
                }
            }
            // The two terms of i and j themselves, on the group's first
            // lanes: every partial sum is an integer, so where they are
            // added does not change the total.
            if (lg == 0)
                sum += (Fs[i * n + i] - Fs[j * n + j]) * (Ds[bj * n + bj] - Ds[a * n + a]);
            if (lg == (g > 1 ? 1 : 0))
                sum += (Fs[i * n + j] - Fs[j * n + i]) * (Ds[bj * n + a] - Ds[a * n + bj]);
            const float delta = group_sum(sum, g);
            __syncwarp();  // every lane has read p before it changes
            // IEEE division and the accurate expf: the library is built
            // without fast math.
            if (uacc <= expf(fminf(fmaxf(-delta / T, -80.0f), 80.0f))) {
                if (lg == 0) {
                    pr[i] = bj;
                    pr[j] = a;
                }
                fx += delta;
            }
            __syncwarp();
        }
    }
    if (lg == 0 && ch < rows) f_out[first + ch] = fx;
    __syncthreads();
    int* pout = p_out + first * n;
    for (int e = threadIdx.x; e < rows * n; e += threads) pout[e] = ps[e];
}

}  // namespace sa

extern "C" int sa_qap_max_n() { return sa::QAP_MAX_N; }

extern "C" int sa_qap_sweep(const int* p_in, int* p_out, float* f_out,
                            const float* F, const float* D, int f_per_block,
                            int d_per_block, const float* T, float T_s,
                            const uint32_t* seed, uint32_t seed_s,
                            const uint32_t* step0,
                            uint32_t step0_s, const uint32_t* chain_base,
                            const int* live, int chains, int n, int blk,
                            int n_steps, void* stream) {
    if (n < 1 || n > sa::QAP_MAX_N || blk < 1 || chains % blk)
        return static_cast<int>(cudaErrorInvalidValue);
    if (chains == 0) return 0;
    const sa::QapControls c{T, T_s, seed, seed_s, step0, step0_s, chain_base,
                            live};
    // Whole warps, at most QAP_THREADS lanes a CTA; a block of more chains
    // spreads over gridDim.y CTAs, each staging its own copy of F and D.
    const int g = sa::qap_group(n);
    const int threads = min(sa::QAP_THREADS, (blk * g + 31) / 32 * 32);
    const int cpc = threads / g;
    const int stage = max(1, min(n_steps, sa::QAP_STAGE_ITEMS / cpc));
    const dim3 grid(chains / blk, (blk + cpc - 1) / cpc);
    const bool table = n <= sa::QAP_TABLE_MAX_N;
    const size_t shmem = sa::qap_smem_floats(n, cpc, stage, table) * 4;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (table) {
        static sa::SmemOptIn opt_in;
        const cudaError_t e = opt_in.allow(sa::qap_sweep_kernel<true>, shmem, shmem);
        if (e != cudaSuccess) return static_cast<int>(e);
        sa::qap_sweep_kernel<true><<<grid, threads, shmem, st>>>(
            p_in, p_out, f_out, F, D, f_per_block, d_per_block, c, n, blk,
            n_steps, g, stage);
    } else {
        sa::qap_sweep_kernel<false><<<grid, threads, shmem, st>>>(
            p_in, p_out, f_out, F, D, f_per_block, d_per_block, c, n, blk,
            n_steps, g, stage);
    }
    return static_cast<int>(cudaGetLastError());
}
