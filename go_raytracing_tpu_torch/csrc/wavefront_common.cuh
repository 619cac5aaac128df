// Device functions shared by the tracing kernels (wavefront.cu) and the
// pathwise reverse sweep (wavefront_grad_pathwise.cu).
//
// The pathwise reverse sweep stashes no branch outcome of a bounce but the
// shadow ray's: it recomputes the random draws from the ray's counter and
// takes the Schlick / total-internal-reflection decision and the firefly
// clamp again from the stashed direction, normal and IOR.  The two kernels
// are separate compilations, so every formula both evaluate lives here, in
// one inlined function each: with -fmad=false (ops/_build.py) the same
// operations on the same bits round alike in both, and both take the same
// branch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wf {

constexpr float EPS_HIT = 1e-3f;
constexpr float FIREFLY = 20.0f;
constexpr float TWO_PI = 6.283185307179586f;
constexpr float INV_PI = 0.3183098861837907f;
constexpr float F24 = 5.9604644775390625e-08f;  // 2^-24

// RNG purposes (core/rng.py)
constexpr uint32_t SCATTER_U = 5;
constexpr uint32_t FRESNEL = 7;
constexpr uint32_t LIGHT_PICK = 8;
constexpr uint32_t LIGHT_U = 9;

// Mask bits of the pathwise stash's row 2 (ops/cuda_wavefront.py: PW_*)
constexpr int PW_EMIT = 1;
constexpr int PW_ALIVE_NEXT = 2;
constexpr int PW_LIT = 4;
constexpr int PW_BLK_A = 8;
constexpr int PW_FRONT = 16;
constexpr int PW_METAL = 32;
constexpr int PW_DIELECTRIC = 64;
constexpr int PW_HIT = 128;
constexpr int PW_USE_MIS = 256;
constexpr int PW_VOLUME = 1024;
constexpr int PW_VOL_SHIFT = 11;
constexpr int PW_F_ROWS = 19;
constexpr int SLOT_NONE = -3;
constexpr int MSLOT_NONE = -9;

struct U3 {
    float x, y, z;
};

// PCG3D counter hash -> three uniforms in [0, 1) (core/rng.py).
__device__ __forceinline__ U3 uniform3(uint32_t stream, uint32_t seed,
                                       uint32_t bounce, uint32_t purpose) {
    uint32_t x = stream ^ (seed * 0x9E3779B9u);
    uint32_t y = (bounce * 0x85EBCA6Bu) ^ seed;
    uint32_t z = purpose * 0xC2B2AE35u + 0x27D4EB2Fu;
    x = x * 1664525u + 1013904223u;
    y = y * 1664525u + 1013904223u;
    z = z * 1664525u + 1013904223u;
    x += y * z;
    y += z * x;
    z += x * y;
    x ^= x >> 16;
    y ^= y >> 16;
    z ^= z >> 16;
    x += y * z;
    y += z * x;
    z += x * y;
    U3 r;
    r.x = (float)(x >> 8) * F24;
    r.y = (float)(y >> 8) * F24;
    r.z = (float)(z >> 8) * F24;
    return r;
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// The bounce's scatter draw: a uniform direction on the unit sphere.
__device__ __forceinline__ void unit_sphere_draw(uint32_t sid, uint32_t seed,
                                                 uint32_t bounce, float ru[3]) {
    const U3 su = uniform3(sid, seed, bounce, SCATTER_U);
    const float zr = 1.0f - 2.0f * su.x;
    const float phi = TWO_PI * su.y;
    const float rrr = sqrtf(fmaxf(1.0f - zr * zr, 0.0f));
    ru[0] = rrr * cosf(phi);
    ru[1] = rrr * sinf(phi);
    ru[2] = zr;
}

// Dielectric: the unit incoming direction and the reflect-or-refract
// decision.  `ior` is already floored at 1e-3.
struct Fresnel {
    float ud[3];
    float dlen, udn, cos_t, ri;
    bool do_refl;
};

__device__ __forceinline__ Fresnel fresnel(const float d[3], const float nrm[3],
                                           float ior, bool front, float ufr) {
    Fresnel F;
    F.ri = front ? 1.0f / ior : ior;
    F.dlen = sqrtf(fmaxf(dot3(d, d), 1e-20f));
#pragma unroll
    for (int c = 0; c < 3; ++c) F.ud[c] = d[c] / F.dlen;
    F.udn = dot3(F.ud, nrm);
    F.cos_t = fminf(-F.udn, 1.0f);
    const float sin_t = sqrtf(fmaxf(1.0f - F.cos_t * F.cos_t, 0.0f));
    const bool cannot = F.ri * sin_t > 1.0f;
    float r0s = (1.0f - F.ri) / (1.0f + F.ri);
    r0s = r0s * r0s;
    const float omc = fmaxf(1.0f - F.cos_t, 0.0f);
    const float omc2 = omc * omc;
    const float schl = r0s + (1.0f - r0s) * omc2 * omc2 * omc;
    F.do_refl = cannot || schl > ufr;
    return F;
}

// Refraction of the unit direction: perp = (ud + n cos_t) ri and the
// parallel part's length (negative), floored like the JAX kernel's.
__device__ __forceinline__ float refract_parts(const Fresnel& F,
                                               const float nrm[3], float perp[3],
                                               float& xv) {
#pragma unroll
    for (int c = 0; c < 3; ++c) perp[c] = (F.ud[c] + nrm[c] * F.cos_t) * F.ri;
    xv = 1.0f - dot3(perp, perp);
    return -sqrtf(fmaxf(fabsf(xv), 1e-20f));
}

// Next-event estimation toward one quad light, first half: the picked light,
// the sampled point's direction and the two cosines.  `L` points at the
// light's column of the light table (row stride lc).
struct LightDir {
    const float* L;
    float tl[3], ld[3];
    float tl2, dist, cos_th, zlc, cos_l;
};

__device__ __forceinline__ LightDir light_dir(const float* lt, int n_lights, int lc,
                                              uint32_t sid, uint32_t seed,
                                              uint32_t bounce, const float p[3],
                                              const float nrm[3]) {
    LightDir S;
    const float up = uniform3(sid, seed, bounce, LIGHT_PICK).x;
    const int li = (int)fminf(floorf(up * (float)n_lights), (float)(n_lights - 1));
    const U3 uab = uniform3(sid, seed, bounce, LIGHT_U);
    S.L = lt + li;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float lp = S.L[c * lc] + uab.x * S.L[(3 + c) * lc] +
                         uab.y * S.L[(6 + c) * lc];
        S.tl[c] = lp - p[c];
    }
    S.tl2 = dot3(S.tl, S.tl);
    S.dist = sqrtf(fmaxf(S.tl2, 1e-20f));
#pragma unroll
    for (int c = 0; c < 3; ++c) S.ld[c] = S.tl[c] / S.dist;
    S.cos_th = dot3(nrm, S.ld);
    S.zlc = -(S.L[9 * lc] * S.ld[0] + S.L[10 * lc] * S.ld[1] +
              S.L[11 * lc] * S.ld[2]);
    S.cos_l = fabsf(S.zlc);
    return S;
}

// Second half: pdfs, balance-heuristic weight and the scale of the
// contribution.  The floors (1e-20 under s2 and under pdf_l + pdf_b, 1e-12
// under pdf_l) are the ones the reverse sweep differentiates against.
struct NeeScale {
    float s2v, s2, pdf_l, qv, pdf_b, rv, scale;
};

__device__ __forceinline__ NeeScale nee_scale(const LightDir& S, int lc,
                                              int n_lights) {
    NeeScale N;
    N.s2v = S.cos_l * S.L[12 * lc];
    N.s2 = fmaxf(N.s2v, 1e-20f);
    N.pdf_l = (S.dist * S.dist) / N.s2;
    N.qv = fmaxf(N.pdf_l, 1e-12f);
    N.pdf_b = fmaxf(S.cos_th, 0.0f) * INV_PI;
    N.rv = fmaxf(N.pdf_l + N.pdf_b, 1e-20f);
    const float weight = N.pdf_l / N.rv;
    N.scale = S.cos_th / N.qv * weight * (float)n_lights;
    return N;
}

}  // namespace wf
