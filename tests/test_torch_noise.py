"""PyTorch port vs the JAX package: marble noise textures (ROADMAP.md A13),
forward.

The noise functions of ``materials/textures`` against the JAX package's on
points drawn with numpy (negative lattice coordinates among them, and
coordinates past the int32 range); the ``perlin`` scene built by both
packages; and ``perlin`` at 24 px, 2 spp, depth 4 rendered by the port's
two routes (the megakernel's plain version and the standard integrator)
against one compiled JAX render (its standard integrator).

Tolerances.  The hash is integer work; a lattice gradient's normalization
1 / sqrt(.) may round one ulp apart (XLA rewrites it as a reciprocal square
root on the CPU; atol 1.2e-7, one ulp at 1).  The noise is a sum of 8
products a point; XLA fuses multiply-adds on the CPU and PyTorch does not,
so the noise and the turbulence may differ by a few float32 ulp (atol 1e-6
and 1e-5); the marble adds XLA's and PyTorch's own sine (atol 1e-5).  The
pictures: rtol 1e-3 / atol 2e-3, the image tolerance of the other port
tests.  The port's two routes run the same torch function for the marble
and give the same radiance to 1e-6 a ray.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import go_raytracing_tpu as grt
import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu.core.vec3 import V3 as JV3
from go_raytracing_tpu.materials import textures as jtex
from go_raytracing_tpu_torch import convert
from go_raytracing_tpu_torch.core.vec3 import V3
from go_raytracing_tpu_torch.integrator import wavefront as twf
from go_raytracing_tpu_torch.materials import textures as ttex
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from test_torch_helpers import scene_tree

torch.set_num_threads(2)

SEED = 3
IMAGE_TOL = dict(rtol=1e-3, atol=2e-3)


def _points(n=600, seed=0):
    """[n, 3] float32 points: most within +-40 (negative lattice cells half
    the time), some within a cell of the origin, and six past the int32
    range, where the lattice coordinate saturates."""
    r = np.random.default_rng(seed)
    p = r.uniform(-40.0, 40.0, (n, 3))
    p[: n // 4] = r.uniform(-1.5, 1.5, (n // 4, 3))
    p[-6:, 0] = [3e9, -3e9, 1e12, -1e12, 2.5e9, -2.2e9]
    return p.astype(np.float32)


def _both(fn_name, p):
    """(the JAX package's value, the port's) of a noise function at p."""
    jp, tp = jnp.asarray(p), torch.from_numpy(p)
    if fn_name == "lattice_grad":
        ijk = np.floor(p / 3.0).clip(-2e9, 2e9).astype(np.int32)
        j = jtex._lattice_grad(*(jnp.asarray(ijk[:, c]) for c in range(3)))
        t = ttex._lattice_grad(*(torch.from_numpy(ijk[:, c]) for c in range(3)))
        return np.stack([np.asarray(a) for a in j]), torch.stack(t).numpy()
    if fn_name in ("perlin_noise", "perlin_turb"):
        return (np.asarray(getattr(jtex, fn_name)(jp)),
                getattr(ttex, fn_name)(tp).numpy())
    jv = JV3(jp[:, 0], jp[:, 1], jp[:, 2])
    tv = V3(tp[:, 0], tp[:, 1], tp[:, 2])
    if fn_name in ("perlin_noise_soa", "perlin_turb_soa"):
        return (np.asarray(getattr(jtex, fn_name)(jv)),
                getattr(ttex, fn_name)(tv).numpy())
    # evaluate: a solid, a checker and two marbles of other scales, dealt out
    b_j, b_t = grt.SceneBuilder(), grtt.SceneBuilder()
    for b in (b_j, b_t):
        for tex in (b.solid((0.2, 0.4, 0.6)), b.checker(0.5, (0.1, 0.1, 0.1), (0.9, 0.8, 0.7)),
                    b.noise(4.0), b.noise(0.25)):
            b.sphere((0, 0, 0), 1.0, b.lambertian(tex))
    js, ts = b_j.build(), b_t.build(device="cpu")
    tex_id = np.arange(p.shape[0]) % 4
    uv = np.zeros(p.shape[0], np.float32)
    j = jtex.evaluate(js.textures, jnp.asarray(tex_id), jnp.asarray(uv),
                      jnp.asarray(uv), jv, has_noise=True, has_image=False)
    t = ttex.evaluate(ts.textures, torch.from_numpy(tex_id), torch.from_numpy(uv),
                      torch.from_numpy(uv), tv, has_noise=True)
    assert ts.has_noise and js.has_noise
    return np.stack([np.asarray(a) for a in j]), torch.stack(list(t)).numpy()


@pytest.mark.parametrize("fn_name, atol", [
    ("lattice_grad", 1.2e-7), ("perlin_noise", 1e-6), ("perlin_noise_soa", 1e-6),
    ("perlin_turb", 1e-5), ("perlin_turb_soa", 1e-5), ("evaluate", 1e-5),
])
def test_noise_functions_match_jax(fn_name, atol):
    """Each noise function of the port against the JAX package's on the same
    points (tolerances in the module docstring)."""
    p = _points()
    j, t = _both(fn_name, p)
    assert j.shape == t.shape and np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=0.0, atol=atol)
    if fn_name == "evaluate":
        marble = t[:, 2::4]
        assert ((marble >= 0.0) & (marble <= 1.0)).all() and marble.std() > 0.1
        np.testing.assert_array_equal(t[:, 0::4], np.array([[0.2], [0.4], [0.6]],
                                                           np.float32).repeat(150, 1))


def test_perlin_scene_matches_the_jax_builder():
    """``load_scene("perlin")`` builds on the CPU the JAX package's scene (a
    marble sphere and a marble ground plane, scale 4, white colour rows) and
    camera (600x337 at 16:9, 100 spp, depth 50); ``convert`` carries it
    across."""
    js, jcam = grt.load_scene("perlin")
    ts, tcam = grtt.load_scene("perlin", device="cpu")
    carried = convert.scene_from_numpy(scene_tree(js), "cpu")
    assert ts.has_noise and carried.has_noise and not ts.has_checker
    for a, b in ((ts.textures, carried.textures), (ts.materials, carried.materials),
                 (ts.spheres, carried.spheres), (ts.planar, carried.planar)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), f.name
    assert ts.textures.kind.tolist() == [ttex.TEX_NOISE]
    assert ts.textures.noise_scale.tolist() == [4.0]
    assert ts.textures.color.tolist() == [[1.0, 1.0, 1.0]]
    assert (tcam.image_width, tcam.image_height, tcam.samples_per_pixel,
            tcam.max_depth) == (jcam.image_width, jcam.image_height, 100, 50) == \
        (600, 337, 100, 50)
    assert cw.applicable(ts) and twf.choose_mega_mode(ts, tcam, 1 << 22, False) == "split"


@pytest.fixture(scope="module")
def perlin_small():
    """perlin at 24 px, 2 spp, depth 4 in both packages, and the JAX
    package's linear image through its (compiled) standard integrator."""
    js, jcam = grt.load_scene("perlin")
    jcam = dataclasses.replace(jcam, image_width=24, samples_per_pixel=2, max_depth=4)
    ts, tcam = grtt.load_scene("perlin", device="cpu")
    tcam = dataclasses.replace(tcam, image_width=24, samples_per_pixel=2, max_depth=4)
    j_img = np.asarray(grt.render(js, jcam, seed=SEED, mega_mode="off")) / 2
    return ts, tcam, j_img


@pytest.mark.parametrize("mode", ["single", "off"])
def test_perlin_render_matches_jax(perlin_small, mode):
    """The port's megakernel route (its plain version on the CPU) and its
    standard integrator against the JAX render, and against each other."""
    ts, tcam, j_img = perlin_small
    img = grtt.render(ts, tcam, seed=SEED, device="cpu", mega_mode=mode).numpy() / 2
    assert img.shape == j_img.shape == (13, 24, 3) and np.isfinite(img).all()
    assert 0.2 < float(img.mean()) and img.std() > 0.05
    np.testing.assert_allclose(img, j_img, **IMAGE_TOL)
    other = grtt.render(ts, tcam, seed=SEED, device="cpu",
                        mega_mode="off" if mode == "single" else "single").numpy() / 2
    np.testing.assert_allclose(img, other, rtol=0.0, atol=1e-6)
