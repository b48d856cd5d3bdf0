// Kernel B3: the pairwise-exchange QAP sweep (permutation family).
//
// Replaces repro/kernels/qap_sweep.py::_qap_kernel (the Pallas TPU kernel
// behind qap_sweep_pallas).  One launch advances every chain, an int32
// permutation p of n locations, by n_steps pairwise-exchange Metropolis
// moves at its block's temperature.  It computes what the Pallas kernel
// computes, not how: there the grid walks chain blocks in VMEM and gathers
// through one-hot matmuls; here each chain is a thread that gathers by
// index from shared memory.
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
// What bounds it on the H100: integer instructions.  Each move is two
// threefry2x32 (20 rounds each) plus an O(n) delta of about 10 n float32
// operations, against n * 4 bytes of state read and written once per
// sweep.  Design: F and D (2 n^2 floats) are staged once per CTA in shared
// memory; each thread owns one chain and keeps its permutation in shared
// memory, transposed (location k of thread t at k * threads + t) so the
// threads of a warp hit distinct banks.  The CTA's rows of p are copied in
// and out coalesced.  A dead block skips its moves: its p passes through and
// its f is the recomputed cost of that p.
#include <cuda_runtime.h>
#include <cstdint>

#include "rng.cuh"

namespace sa {

constexpr int QAP_MAX_N = 32;
constexpr int QAP_THREADS = 256;

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

__global__ void qap_sweep_kernel(const int* __restrict__ p_in,
                                 int* __restrict__ p_out,
                                 float* __restrict__ f_out,
                                 const float* __restrict__ F,
                                 const float* __restrict__ D,
                                 int f_per_block, int d_per_block,
                                 QapControls c, int n, int blk, int n_steps) {
    extern __shared__ float smem[];
    float* Fs = smem;
    float* Ds = smem + n * n;
    int* ps = reinterpret_cast<int*>(smem + 2 * n * n);
    const int ts = blockDim.x;  // stride between locations in ps
    const int b = blockIdx.x;
    const int nn = n * n;
    const size_t f_off = f_per_block ? static_cast<size_t>(b) * nn : 0;
    const size_t d_off = d_per_block ? static_cast<size_t>(b) * nn : 0;
    for (int e = threadIdx.x; e < nn; e += ts) {
        Fs[e] = F[f_off + e];
        Ds[e] = D[d_off + e];
    }
    // This CTA's chains are rows [first, first + rows) of p, contiguous.
    const int lane0 = blockIdx.y * ts;
    const int rows = min(ts, blk - lane0);
    const size_t first = static_cast<size_t>(b) * blk + lane0;
    const int* pin = p_in + first * n;
    for (int e = threadIdx.x; e < rows * n; e += ts)
        ps[(e % n) * ts + e / n] = pin[e];
    __syncthreads();

    const int t = threadIdx.x;
    if (t < rows) {
        int* pr = ps + t;
        const int lane = lane0 + t;
        const float T = c.T ? c.T[b] : c.T_s;
        const uint32_t seed = c.seed ? c.seed[b] : c.seed_s;
        const uint32_t step0 = c.step0 ? c.step0[b] : c.step0_s;
        const uint32_t cidx =
            (c.chain_base ? c.chain_base[b]
                          : static_cast<uint32_t>(b) * static_cast<uint32_t>(blk))
            + static_cast<uint32_t>(lane);
        const bool live = c.live ? (c.live[b] != 0) : true;

        float fx = 0.0f;
        for (int u = 0; u < n; ++u) {
            const float* Du = Ds + pr[u * ts] * n;
            for (int v = 0; v < n; ++v) fx += Fs[u * n + v] * Du[pr[v * ts]];
        }
        for (int s = 0; live && s < n_steps; ++s) {
            uint32_t rbits;
            float uval, uacc;
            draws3(seed, cidx, step0 + static_cast<uint32_t>(s), rbits, uval,
                   uacc);
            const int i = static_cast<int>(rbits % static_cast<uint32_t>(n));
            const int j = min(static_cast<int>(uval * static_cast<float>(n)),
                              n - 1);
            const int a = pr[i * ts];
            const int bj = pr[j * ts];
            const float* Fi = Fs + i * n;
            const float* Fj = Fs + j * n;
            const float* Da = Ds + a * n;
            const float* Db = Ds + bj * n;
            float sum = 0.0f;
            for (int k = 0; k < n; ++k) {
                if (k == i || k == j) continue;
                const int pk = pr[k * ts];
                const float* Dk = Ds + pk * n;
                sum += (Fi[k] - Fj[k]) * (Db[pk] - Da[pk]);
                sum += (Fs[k * n + i] - Fs[k * n + j]) * (Dk[bj] - Dk[a]);
            }
            const float diag = (Fi[i] - Fj[j]) * (Db[bj] - Da[a]);
            const float cross = (Fi[j] - Fj[i]) * (Db[a] - Da[bj]);
            const float delta = sum + diag + cross;
            // IEEE division and the accurate expf: the library is built
            // without fast math.
            if (uacc <= expf(fminf(fmaxf(-delta / T, -80.0f), 80.0f))) {
                pr[i * ts] = bj;
                pr[j * ts] = a;
                fx += delta;
            }
        }
        f_out[first + t] = fx;
    }
    __syncthreads();
    int* pout = p_out + first * n;
    for (int e = threadIdx.x; e < rows * n; e += ts)
        pout[e] = ps[(e % n) * ts + e / n];
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
    // Whole warps, at most QAP_THREADS chains a CTA; a block of more chains
    // spreads over gridDim.y CTAs, each staging its own copy of F and D.
    const int threads = min(sa::QAP_THREADS, (blk + 31) / 32 * 32);
    const dim3 grid(chains / blk, (blk + threads - 1) / threads);
    const size_t shmem = (2 * n * n + static_cast<size_t>(n) * threads) * 4;
    sa::qap_sweep_kernel<<<grid, threads, shmem,
                           static_cast<cudaStream_t>(stream)>>>(
        p_in, p_out, f_out, F, D, f_per_block, d_per_block, c, n, blk,
        n_steps);
    return static_cast<int>(cudaGetLastError());
}
