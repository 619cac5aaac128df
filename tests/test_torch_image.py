"""PyTorch port vs the JAX package: image textures (CPU, small images).

The atlas the builder makes, the texels ``textures.evaluate`` reads, and the
forward render in the megakernel mode 'image' (the megakernel on the scene
with its image made white, times each camera ray's texel), held against
the JAX package's 'image' picture, whose megakernel runs in Pallas
interpret mode (``INTERPRET = True``, restored afterwards), and against the
port's own standard integrator.  One JAX render in this file."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import go_raytracing_tpu as grt
import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu.core.vec3 import V3 as JV3
from go_raytracing_tpu.integrator import wavefront as jwf
from go_raytracing_tpu.materials import textures as jtex
from go_raytracing_tpu.ops import pallas_wavefront as jmega
from go_raytracing_tpu_torch import convert
from go_raytracing_tpu_torch.core.vec3 import V3
from go_raytracing_tpu_torch.integrator import wavefront as twf
from go_raytracing_tpu_torch.materials import textures as ttex
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from go_raytracing_tpu_torch.utils import cli as tcli
from test_torch_helpers import (IMAGE_SPHERE_CAM, build_image_sphere, port_and_jax,
                                scene_tree, seeded_atlas)

torch.set_num_threads(2)

IMAGE_TOL = dict(rtol=1e-3, atol=2e-3)


def _build_images(pkg, **build_kwargs):
    """Three images of different sizes (a 1x1 among them) in one atlas, a
    checker and a solid texture between them, each on a quad."""
    b = pkg.SceneBuilder()
    ims = [seeded_atlas(5, 7, seed=1), seeded_atlas(1, 1, seed=2), seeded_atlas(3, 9, seed=3)]
    mats = [b.lambertian(b.image(ims[0])),
            b.lambertian(b.checker(0.5, (0.1, 0.2, 0.3), (0.8, 0.7, 0.6))),
            b.lambertian(b.image(ims[1])), b.lambertian((0.4, 0.5, 0.6)),
            b.lambertian(b.image(ims[2]))]
    for j, m in enumerate(mats):
        b.quad((j, 0, 0), (1, 0, 0), (0, 1, 0), m)
    return b.build(**build_kwargs)


@pytest.mark.parametrize("with_images", [True, False])
def test_builder_and_convert_give_the_jax_packages_atlas(with_images):
    """The port's builder and ``convert`` of the JAX package's scene give
    the JAX package's kinds, image ids, atlas and atlas sizes, exactly: the
    images padded into one [I, Hmax, Wmax, 3] atlas, each in its top-left
    corner.  Without images the atlas is the one black texel."""
    def no_images(pkg, **build_kwargs):
        b = pkg.SceneBuilder()
        b.sphere((0, 0, 0), 1.0, b.lambertian((0.5, 0.5, 0.5)))
        return b.build(**build_kwargs)

    build = _build_images if with_images else no_images
    js = build(grt)
    built = build(grtt, device="cpu")
    carried = convert.scene_from_numpy(scene_tree(js), "cpu")
    for ts in (built, carried):
        assert ts.has_image == js.has_image == with_images
        for f in ("kind", "image_id", "atlas", "atlas_wh"):
            np.testing.assert_array_equal(getattr(ts.textures, f).numpy(),
                                          np.asarray(getattr(js.textures, f)), err_msg=f)
    if with_images:
        assert tuple(built.textures.atlas.shape) == (3, 5, 9, 3)
        assert built.textures.atlas_wh.tolist() == [[7, 5], [1, 1], [9, 3]]
        assert (built.textures.atlas[1, 1:] == 0).all()


def test_image_from_a_file_matches_the_jax_loader(tmp_path):
    """``SceneBuilder.image(path)`` loads through ``io/images.load_ldr``
    (the reference's sqrt quirk) and ``io/assets.find_asset``: the JAX
    package's texels from the same PNG."""
    from PIL import Image

    px = (np.random.default_rng(4).uniform(0, 255, (6, 10, 3))).astype(np.uint8)
    path = str(tmp_path / "tiny.png")
    Image.fromarray(px).save(path)
    jb, tb = grt.SceneBuilder(), grtt.SceneBuilder()
    jb.lambertian(jb.image(path))
    tb.lambertian(tb.image(path))
    t_atlas = tb.build(device="cpu").textures.atlas.numpy()
    np.testing.assert_array_equal(t_atlas, np.asarray(jb.build().textures.atlas))
    np.testing.assert_allclose(t_atlas[0], np.sqrt(px / np.float32(255.0)), rtol=1e-6)


def test_evaluate_reads_the_jax_packages_texels():
    """The image branch of ``textures.evaluate`` against the JAX package's,
    texel for texel (exact): u and v outside [0, 1], at 0 and 1 and on
    texel edges, every texture of a scene with three images of different
    sizes, a checker and a solid."""
    js = _build_images(grt)
    ts = convert.scene_from_numpy(scene_tree(js), "cpu")
    rng = np.random.default_rng(5)
    n = 4096
    tex_id = rng.integers(0, ts.textures.kind.shape[0], n).astype(np.int32)
    u = rng.uniform(-0.3, 1.3, n).astype(np.float32)
    v = rng.uniform(-0.3, 1.3, n).astype(np.float32)
    edges = np.array([0.0, 1.0, 1 / 7, 2 / 7, 1 / 3, 1 / 9, 0.5, 1e-8, 1 - 1e-7], np.float32)
    u[:81], v[:81] = np.repeat(edges, 9), np.tile(edges, 9)
    p = rng.uniform(-2, 2, (3, n)).astype(np.float32)
    got = ttex.evaluate(ts.textures, torch.from_numpy(tex_id), torch.from_numpy(u),
                        torch.from_numpy(v), V3(*(torch.from_numpy(c) for c in p)),
                        has_image=True)
    ref = jax.jit(lambda pack, i, a, b, q: jtex.evaluate(
        pack, i, a, b, JV3(*q), has_noise=False, has_image=True))(js.textures, tex_id, u, v, p)
    for c in range(3):
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(ref[c]))
    kinds = ts.textures.kind.numpy()[tex_id]
    assert (kinds == ttex.TEX_IMAGE).sum() > n // 2


@pytest.fixture(scope="module")
def earth_like():
    """A sphere of radius 2 textured by a seeded 16x32 atlas (the earth
    scene's class) at 24x24, 2 spp, depth 6, in both packages; the JAX
    package's picture through its 'image' mode, its megakernel in Pallas
    interpret mode."""
    atlas = seeded_atlas(16, 32, seed=6)
    js, jcam, ts, tcam = port_and_jax(
        lambda pkg: build_image_sphere(pkg, atlas),
        dict(IMAGE_SPHERE_CAM, image_width=24, samples_per_pixel=2, max_depth=6))
    old = jmega.INTERPRET
    jmega.INTERPRET = True
    try:
        assert jwf.choose_mega_mode(js, jcam, 24 * 24 * 2, False) == "image"
        j_fb = np.asarray(grt.render(js, jcam, seed=3))
    finally:
        jmega.INTERPRET = old
    return dict(ts=ts, tcam=tcam, j_fb=j_fb)


def test_image_mode_matches_the_jax_packages_image_mode(earth_like):
    """The port's 'image' picture (the plain version of the megakernel on
    the white scene, times the texel of the sphere closest-hit kernel's
    plain version) against the JAX package's: fewer than 0.5 % of pixels
    outside rtol 1e-3 / atol 2e-3."""
    c = earth_like
    ts, tcam = c["ts"], c["tcam"]
    assert twf.image_prefactor_ok(ts)
    assert twf.choose_mega_mode(ts, tcam, 24 * 24 * 2, False) == "image"
    before = cw.LAUNCHES
    got = grtt.render(ts, tcam, seed=3, device="cpu").numpy()
    assert cw.LAUNCHES == before    # plain versions on the CPU: no launch
    assert got.shape == c["j_fb"].shape == (24, 24, 3)
    assert np.isfinite(got).all() and c["j_fb"].mean() > 0.05
    bad = ~np.isclose(got, c["j_fb"], **IMAGE_TOL).all(axis=-1)
    assert bad.mean() < 0.005, bad.mean()


def test_image_mode_equals_the_standard_integrator(earth_like):
    """The factorization is exact: the 'image' picture against the port's
    standard integrator, which reads the atlas at every hit, under 0.5 % of
    pixels outside rtol 1e-3 / atol 2e-3.  ``record=True`` takes the
    standard integrator and gives the same radiance."""
    c = earth_like
    ts, tcam = c["ts"], c["tcam"]
    img = grtt.render(ts, tcam, seed=3, device="cpu")
    std = grtt.render(ts, tcam, seed=3, device="cpu", mega_mode="off")
    bad = ~np.isclose(img.numpy(), std.numpy(), **IMAGE_TOL).all(axis=-1)
    assert bad.mean() < 0.005, bad.mean()
    ids = torch.arange(300)
    o, d, tm = grtt.camera.generate_rays(tcam, ids % 24, ids // 24, ids, 3)
    rad = twf.trace(ts, tcam, o, d, tm, ids, 3)
    rad_rec, dec = twf.trace(ts, tcam, o, d, tm, ids, 3, record=True)
    np.testing.assert_allclose(torch.stack(list(rad_rec)).numpy(),
                               torch.stack(list(rad)).numpy(), rtol=1e-5, atol=1e-6)
    assert dec.which.shape == (tcam.max_depth, 300)
    assert (dec.which[0] == twf.HIT_SPHERE).any()


def test_choose_mega_mode_takes_image_before_split(earth_like):
    """As in the JAX package: 'image' whatever the depth and chunk (the
    earth scene at depth 50 stays on one phase), 'off' for a
    differentiable trace, and a second sphere leaves the gate."""
    ts, tcam = earth_like["ts"], earth_like["tcam"]
    deep = dataclasses.replace(tcam, max_depth=50)
    assert twf.choose_mega_mode(ts, deep, cw.SPLIT_R_MIN * 4, False) == "image"
    assert twf.choose_mega_mode(ts, deep, cw.SPLIT_R_MIN * 4, True) == "off"
    assert not cw.applicable(ts)
    b = grtt.SceneBuilder()
    b.sphere((0, 0, 0), 2.0, b.lambertian(b.image(seeded_atlas(4, 4))))
    b.sphere((0, -102, 0), 100.0, b.lambertian((0.5, 0.5, 0.5)))
    two = b.build(device="cpu")
    assert not twf.image_prefactor_ok(two)
    assert twf.choose_mega_mode(two, tcam, 1024, False) == "off"


def test_earth_scene_raises_for_its_missing_asset(tmp_path, monkeypatch):
    """``earth`` needs ``earthmap.jpg``, which is not in the repository: the
    port raises ``FileNotFoundError`` naming it, as the JAX package does,
    from ``load_scene`` and from the CLI.  Given an array, the scene is
    built with the JAX package's camera."""
    monkeypatch.chdir(tmp_path)
    for call in (lambda: grtt.load_scene("earth", device="cpu"),
                 lambda: grt.load_scene("earth"),
                 lambda: tcli.main(["-scene", "earth", "-device", "cpu",
                                    "-out", str(tmp_path / "e.png")])):
        with pytest.raises(FileNotFoundError, match="earthmap.jpg"):
            call()
    scene, cam = grtt.load_scene("earth", device="cpu", image=seeded_atlas(2, 4))
    assert twf.image_prefactor_ok(scene)
    assert (cam.image_width, cam.samples_per_pixel, cam.max_depth) == (800, 100, 50)
    assert cam.look_from == (0, 0, 12) and cam.vfov == 20
