// Per-objective math of the sweep kernel, as device functions.
//
// Replaces repro/kernels/objective_math.py (the six registry kids, BOX,
// term/init_acc/combine/full_eval).  kid is a runtime value: the caller
// switches on it once per chain, and since kid is uniform across a serving
// slot the branch costs nothing.  One binary serves every objective.
//
// Each expression follows the operation order of ../objective_math.py.  The
// library is built without fast math and with FMA contraction off
// (-fmad=false), so products and sums round as PyTorch's separate
// elementwise ops do.  Schwefel's sinf(sqrtf|x|) takes arguments up to
// sqrt(512) ~ 22.6, where __sinf's error grows: the IEEE sinf is needed.
#pragma once
#include <cstdint>

namespace sa {

enum Kid : int {
    KID_SCHWEFEL = 0,
    KID_RASTRIGIN = 1,
    KID_ACKLEY = 2,
    KID_GRIEWANK = 3,
    KID_EXPONENTIAL = 4,
    KID_SALOMON = 5,
    N_KIDS = 6,
};

constexpr float TWO_PI = 6.2831854820251465f;  // float32(2) * float32(pi)
constexpr float E_F32 = 2.7182817459106445f;   // float32(e)
constexpr float TINY = 1e-30f;

// Box per kid; width is hi - lo rounded to float32, as in the reference.
__device__ __forceinline__ void box(int kid, float& lo, float& hi) {
    switch (kid) {
        case KID_RASTRIGIN: lo = -5.12f; hi = 5.12f; break;
        case KID_ACKLEY: lo = -30.0f; hi = 30.0f; break;
        case KID_GRIEWANK: lo = -600.0f; hi = 600.0f; break;
        case KID_EXPONENTIAL: lo = -1.0f; hi = 1.0f; break;
        case KID_SALOMON: lo = -100.0f; hi = 100.0f; break;
        default: lo = -512.0f; hi = 512.0f; break;
    }
}

// clamp(v, min=lo) that lets NaN through, as torch.clamp / jnp.maximum do.
__device__ __forceinline__ float clamp_min(float v, float lo) {
    return v < lo ? lo : v;
}

__device__ __forceinline__ float clip80(float v) {
    return v < -80.0f ? -80.0f : (v > 80.0f ? 80.0f : v);
}

// Per-coordinate contributions for the delta variant: sums s0, s1 and the
// product factor p of coordinate index d.
__device__ __forceinline__ void term(int kid, float xi, float d, float& s0,
                                     float& s1, float& p) {
    s1 = 0.0f;
    p = 1.0f;
    switch (kid) {
        case KID_RASTRIGIN: s0 = xi * xi - 10.0f * cosf(TWO_PI * xi); break;
        case KID_ACKLEY: s0 = xi * xi; s1 = cosf(TWO_PI * xi); break;
        case KID_GRIEWANK:
            s0 = xi * xi / 4000.0f;
            p = cosf(xi / sqrtf(d + 1.0f));
            break;
        case KID_EXPONENTIAL:
        case KID_SALOMON: s0 = xi * xi; break;
        default: s0 = xi * sinf(sqrtf(fabsf(xi))); break;
    }
}

__device__ __forceinline__ float log_mag(float p) {
    return logf(clamp_min(fabsf(p), TINY));
}

__device__ __forceinline__ float sign_of(float p) {
    return p < 0.0f ? -1.0f : 1.0f;
}

// Accumulators -> objective value.
__device__ __forceinline__ float combine(int kid, float S0, float S1,
                                         float logP, float sgnP, int dim) {
    const float n = static_cast<float>(dim);
    switch (kid) {
        case KID_RASTRIGIN: return 10.0f * n + S0;
        case KID_ACKLEY:
            return -20.0f * expf(-0.2f * sqrtf(S0 / n)) - expf(S1 / n) + 20.0f
                   + E_F32;
        case KID_GRIEWANK: return 1.0f + S0 - sgnP * expf(logP);
        case KID_EXPONENTIAL: return -expf(-0.5f * S0);
        case KID_SALOMON: {
            const float r = sqrtf(S0);
            return 1.0f - cosf(TWO_PI * r) + 0.1f * r;
        }
        default: return -S0 / n;
    }
}

// Full evaluation, split so that coordinates can be summed by any number
// of threads: full_terms gives coordinate i's terms, ta for the sum a and
// tb for the second accumulator (Ackley: the sum b of cosines; Griewank:
// the product p of cosines; other kids have none); fold_b folds tb into it;
// full_finish maps the folded totals to f.  Griewank's full form divides
// the sum of squares by 4000 once and multiplies the cosines directly, as
// the reference does.
__device__ __forceinline__ bool has_b(int kid) {
    return kid == KID_ACKLEY || kid == KID_GRIEWANK;
}

__device__ __forceinline__ float b_init(int kid) {
    return kid == KID_GRIEWANK ? 1.0f : 0.0f;
}

__device__ __forceinline__ float fold_b(int kid, float acc, float tb) {
    return kid == KID_GRIEWANK ? acc * tb : acc + tb;
}

__device__ __forceinline__ void full_terms(int kid, float xi, int i, float& ta,
                                           float& tb) {
    tb = 0.0f;
    switch (kid) {
        case KID_RASTRIGIN: ta = xi * xi - 10.0f * cosf(TWO_PI * xi); break;
        case KID_ACKLEY: ta = xi * xi; tb = cosf(TWO_PI * xi); break;
        case KID_GRIEWANK:
            ta = xi * xi;
            tb = cosf(xi / sqrtf(static_cast<float>(i) + 1.0f));
            break;
        case KID_EXPONENTIAL:
        case KID_SALOMON: ta = xi * xi; break;
        default: ta = xi * sinf(sqrtf(fabsf(xi))); break;
    }
}

// (a, b) after the terms of one more coordinate; b is Griewank's p.
__device__ __forceinline__ void full_term(int kid, float xi, int i, float& a,
                                          float& b) {
    float ta, tb;
    full_terms(kid, xi, i, ta, tb);
    a += ta;
    if (has_b(kid)) b = fold_b(kid, b, tb);
}

__device__ __forceinline__ float full_finish(int kid, float a, float b,
                                             int dim) {
    const float n = static_cast<float>(dim);
    switch (kid) {
        case KID_GRIEWANK: return 1.0f + a / 4000.0f - b;
        case KID_RASTRIGIN:
        case KID_ACKLEY:
        case KID_EXPONENTIAL:
        case KID_SALOMON: return combine(kid, a, b, 0.0f, 1.0f, dim);
        default: return -a / n;
    }
}

}  // namespace sa
