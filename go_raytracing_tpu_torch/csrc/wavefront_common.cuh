// Device functions shared by the tracing kernels (wavefront.cu) and the
// pathwise reverse sweep (wavefront_grad_pathwise.cu): the counter hash, the
// random draws, the marble texture and its gradient, the Fresnel decision,
// the light sample.
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

constexpr float BIG = 3.0e38f;
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
constexpr int PW_BLK_H = 512;
constexpr int PW_VOLUME = 1024;
constexpr int PW_VOL_SHIFT = 11;
constexpr int PW_MARBLE = 8192;
// Float rows of a pathwise stash bounce: 19, and a 20th (the winner's marble
// scale) in a scene with marble textures.
constexpr int PW_F_ROWS = 19;
constexpr int PW_F_ROWS_MARBLE = 20;
// The fused kernel's own stash (wavefront_grad_fused.cu) in a scene with
// marble: the 19 rows and the winner's dmarble/dp (3), which its forward
// takes from the one evaluation of the marble and its gradient a hit.
constexpr int PW_F_ROWS_FUSED_MARBLE = 22;
constexpr int SLOT_NONE = -3;
constexpr int MSLOT_NONE = -9;

struct U3 {
    float x, y, z;
};

// PCG3D hash of three words (core/rng.py: _pcg3d), in place.
__device__ __forceinline__ void pcg3d(uint32_t& x, uint32_t& y, uint32_t& z) {
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
}

// PCG3D counter hash -> three uniforms in [0, 1) (core/rng.py).
__device__ __forceinline__ U3 uniform3(uint32_t stream, uint32_t seed,
                                       uint32_t bounce, uint32_t purpose) {
    uint32_t x = stream ^ (seed * 0x9E3779B9u);
    uint32_t y = (bounce * 0x85EBCA6Bu) ^ seed;
    uint32_t z = purpose * 0xC2B2AE35u + 0x27D4EB2Fu;
    pcg3d(x, y, z);
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

// Marble texture (materials/textures.py: marble), the operations of its
// torch version in the same order: 0.5 * (1 + sin(scale * z + 10 * |fBm|))
// over 7 octaves of gradient noise at p * scale, each a plain trilinear
// blend of the 8 lattice corners' gradient . offset.  A corner's gradient is
// the PCG3D hash of its integer coordinates read as a cube sample, normalized
// by 1 / sqrt(...) (a division, not rsqrtf: the torch version divides).  The
// lattice coordinate is floor(p) converted with saturation
// (__float2int_rd), as the torch version's _floor_i32 and XLA convert.
__device__ __forceinline__ void lattice_grad(int i, int j, int k, float g[3]) {
    uint32_t x = (uint32_t)i, y = (uint32_t)j, z = (uint32_t)k;
    pcg3d(x, y, z);
    const float gx = 2.0f * ((float)(x >> 8) * F24) - 1.0f;
    const float gy = 2.0f * ((float)(y >> 8) * F24) - 1.0f;
    const float gz = 2.0f * ((float)(z >> 8) * F24) - 1.0f;
    const float ginv = 1.0f / sqrtf(fmaxf(gx * gx + gy * gy + gz * gz, 1e-12f));
    g[0] = gx * ginv;
    g[1] = gy * ginv;
    g[2] = gz * ginv;
}

__device__ __forceinline__ float noise_corner(int i, int j, int k, float u, float v,
                                              float w) {
    float g[3];
    lattice_grad(i, j, k, g);
    return g[0] * u + g[1] * v + g[2] * w;
}

__device__ __forceinline__ float noise1(float px, float py, float pz) {
    const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
    const float u = px - fx, v = py - fy, w = pz - fz;
    const int i = __float2int_rd(px), j = __float2int_rd(py), k = __float2int_rd(pz);
    float acc = 0.0f;
#pragma unroll
    for (int di = 0; di < 2; ++di) {
#pragma unroll
        for (int dj = 0; dj < 2; ++dj) {
#pragma unroll
            for (int dk = 0; dk < 2; ++dk) {
                const float dot = noise_corner(i + di, j + dj, k + dk, u - (float)di,
                                               v - (float)dj, w - (float)dk);
                const float wu = di ? u : 1.0f - u;
                const float wv = dj ? v : 1.0f - v;
                const float ww = dk ? w : 1.0f - w;
                acc = acc + wu * wv * ww * dot;
            }
        }
    }
    return acc;
}

__device__ __forceinline__ float marble(const float p[3], float scale) {
    float px = p[0] * scale, py = p[1] * scale, pz = p[2] * scale;
    float acc = 0.0f, weight = 1.0f;
    for (int oct = 0; oct < 7; ++oct) {
        acc = acc + weight * noise1(px, py, pz);
        weight *= 0.5f;
        px = px * 2.0f;
        py = py * 2.0f;
        pz = pz * 2.0f;
    }
    return 0.5f * (1.0f + sinf(scale * p[2] + 10.0f * fabsf(acc)));
}

// The marble (GRAD: and its gradient in p, materials/textures.py:
// marble_grad: 0.5 cos(arg) (10 sign(turb) sum_o w_o s 2^o grad noise
// + s z_hat), arg = s z + 10 |turb|, sign(0) = 0 as in the JAX kernel) of
// the lanes of a warp that need one, in turns across the warp: called by
// all 32 lanes together.  One lane a ray pays a whole evaluation (56
// lattice corners in one dependent chain) wherever one lane of its warp
// hits marble, while the others wait; here the warp takes the points of the
// lanes that need one one at a time: lane L < 28 evaluates corners 2 (L % 4)
// and 2 (L % 4) + 1 of octave L / 4, lane o < 7 adds octave o's eight corner
// terms in marble's corner order, and the octaves are added in order.  Every
// term is the same operations on the same bits as in marble (p * scale *
// 2^o is exact: a power of two), added in the same order, so the value is
// marble's bit for bit; the gradient takes each corner's term by the product
// rule over its weights (the lattice cell held fixed) and sums the terms
// over corners, then octaves, in the torch version's order.  Measured on the
// H100, the turns beat one lane a ray in B5a even where 30 of 32 lanes need
// a marble (PERF.md), so B5a and B4's forwards take it for the value (B4
// with dmarble/dp) and B5b for dmarble/dp at every bounce.  The brute
// forward and resumable kernels, whose warps start full of marble points
// (perlin: every hit), take it where few lanes need one and one lane a ray
// otherwise (trace_ray's MARBLE_TURNS; the turns read about twice one
// lane's time on full warps there, PERF.md).
template <bool GRAD>
__device__ __forceinline__ float marble_warp(bool need, const float p[3],
                                             float scale, float grad[3],
                                             int lane) {
    constexpr unsigned ALL = 0xFFFFFFFFu;
    unsigned todo = __ballot_sync(ALL, need);
    float val = 0.0f;
    const int oct = lane >> 2;      // this lane's octave (lanes 28-31: none)
    const int j0 = 2 * (lane & 3);  // its first corner of the octave
    const float f_oct = (float)(1 << (oct < 7 ? oct : 0));
    while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const float px = __shfl_sync(ALL, p[0] * scale, src);
        const float py = __shfl_sync(ALL, p[1] * scale, src);
        const float pz = __shfl_sync(ALL, p[2] * scale, src);
        // this lane's two corner terms (and, GRAD, their gradient terms)
        float t[2] = {0.0f, 0.0f}, tg[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
        if (lane < 28) {
            const float x = px * f_oct, y = py * f_oct, z = pz * f_oct;
            const float fx = floorf(x), fy = floorf(y), fz = floorf(z);
            const float u = x - fx, v = y - fy, w = z - fz;
            const int i = __float2int_rd(x), j = __float2int_rd(y), k = __float2int_rd(z);
#pragma unroll
            for (int s = 0; s < 2; ++s) {
                const int c = j0 + s;
                const int di = c >> 2, dj = (c >> 1) & 1, dk = c & 1;
                float g[3];
                lattice_grad(i + di, j + dj, k + dk, g);
                const float dot = g[0] * (u - (float)di) + g[1] * (v - (float)dj) +
                                  g[2] * (w - (float)dk);
                const float wu = di ? u : 1.0f - u;
                const float wv = dj ? v : 1.0f - v;
                const float ww = dk ? w : 1.0f - w;
                t[s] = wu * wv * ww * dot;
                if constexpr (GRAD) {
                    const float su = di ? 1.0f : -1.0f;
                    const float sv = dj ? 1.0f : -1.0f;
                    const float sw = dk ? 1.0f : -1.0f;
                    tg[s][0] = su * wv * ww * dot + wu * wv * ww * g[0];
                    tg[s][1] = wu * sv * ww * dot + wu * wv * ww * g[1];
                    tg[s][2] = wu * wv * sw * dot + wu * wv * ww * g[2];
                }
            }
        }
        // lane o < 7: octave o's noise (and gradient), its corners in order
        float nv = 0.0f, nd[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const int from = 4 * lane + (c >> 1);  // lanes >= 7 read a dummy
            nv = nv + __shfl_sync(ALL, t[c & 1], from);
            if constexpr (GRAD) {
#pragma unroll
                for (int q = 0; q < 3; ++q)
                    nd[q] = nd[q] + __shfl_sync(ALL, tg[c & 1][q], from);
            }
        }
        // the octaves in order (every lane; lane src keeps its own)
        float acc = 0.0f, weight = 1.0f, osc = scale;
        float da[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int o = 0; o < 7; ++o) {
            acc = acc + weight * __shfl_sync(ALL, nv, o);
            if constexpr (GRAD) {
#pragma unroll
                for (int q = 0; q < 3; ++q)
                    da[q] = da[q] + weight * osc * __shfl_sync(ALL, nd[q], o);
            }
            weight *= 0.5f;
            osc = osc * 2.0f;
        }
        if (lane == src) {
            if constexpr (GRAD) {
                const float arg = scale * p[2] + 10.0f * fabsf(acc);
                const float sgn = acc > 0.0f ? 1.0f : (acc < 0.0f ? -1.0f : 0.0f);
                const float half_cos = 0.5f * cosf(arg);
                const float ten_sgn = 10.0f * sgn;
                grad[0] = half_cos * (ten_sgn * da[0]);
                grad[1] = half_cos * (ten_sgn * da[1]);
                grad[2] = half_cos * (ten_sgn * da[2] + scale);
                val = 0.5f * (1.0f + sinf(arg));
            } else {
                val = 0.5f * (1.0f + sinf(scale * p[2] + 10.0f * fabsf(acc)));
            }
        }
    }
    return val;
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
