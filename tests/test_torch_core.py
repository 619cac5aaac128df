"""PyTorch port vs the JAX package: RNG, camera rays, film (CPU).

Inputs are made from a seed with numpy and handed to both packages."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracing_tpu import camera as jcamera
from go_raytracing_tpu.core import film as jfilm
from go_raytracing_tpu.core import rng as jrng
from go_raytracing_tpu.core.vec3 import V3 as JV3
from go_raytracing_tpu_torch import camera as tcamera
from go_raytracing_tpu_torch import convert
from go_raytracing_tpu_torch.core import film as tfilm
from go_raytracing_tpu_torch.core import rng as trng
from go_raytracing_tpu_torch.core import vec as tvec
from go_raytracing_tpu_torch.core.vec3 import V3

torch.set_num_threads(2)


@pytest.mark.parametrize("case", range(6))
def test_uniform3_bit_equal(case):
    """The hash is integer arithmetic and the float step is exact in
    float32, so the uniforms must be EQUAL, not close."""
    rng = np.random.default_rng(100 + case)
    seed = int(rng.integers(0, 2 ** 32))
    bounce = int(rng.integers(0, 60))
    purpose = int(rng.integers(0, 200))
    stream = rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64)
    stream[:4] = [0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]  # sign-bit edge
    ref = jrng.uniform3(seed, jnp.asarray(stream.astype(np.uint32)), bounce, purpose)
    as_i64 = torch.from_numpy(stream.astype(np.int64))
    as_i32 = torch.from_numpy(stream.astype(np.uint32).view(np.int32))
    for s in (as_i64, as_i32):
        got = trng.uniform3(seed, s, bounce, purpose)
        for g, r in zip(got, ref):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_uniform3_tensor_bounce_and_samplers():
    stream = torch.arange(256)
    b = torch.full((256,), 3)
    a1 = trng.uniform3(7, stream, b, trng.LIGHT_U)
    a2 = trng.uniform3(7, stream, 3, trng.LIGHT_U)
    for x, y in zip(a1, a2):
        assert torch.equal(x, y)
    u1, u2 = trng.uniform2(7, stream, 0, trng.SCATTER_U)
    v = trng.unit_vector_from_uniforms(u1, u2)
    jv = jrng.unit_vector_from_uniforms(jnp.asarray(u1.numpy()), jnp.asarray(u2.numpy()))
    # sin/cos come from different math libraries: a few ulp
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-6)
    dx, dy = trng.in_unit_disk_from_uniforms(u1, u2)
    assert float((dx * dx + dy * dy).max()) <= 1.0 + 1e-6


CAMERAS = {
    "fast": dict(image_width=32, aspect_ratio=16 / 9, vfov=20.0,
                 look_from=(13, 2, 3), look_at=(0, 0, 0), focus_dist=10.0),
    "defocus": dict(image_width=32, aspect_ratio=16 / 9, vfov=20.0,
                    look_from=(13, 2, 3), look_at=(0, 0, 0), focus_dist=10.0,
                    defocus_angle=0.6),
    "motion": dict(image_width=32, aspect_ratio=1.0, vfov=40.0,
                   look_from=(0, 1, 8), look_at=(0, 0, 0), focus_dist=8.0,
                   defocus_angle=0.4, look_from2=(1, 1.5, 8),
                   look_at2=(0.2, 0, 0), camera_motion=True),
    "free": dict(image_width=32, aspect_ratio=1.0, vfov=60.0,
                 look_from=(1, 2, 3), forward=(0.0, -0.6, -0.8),
                 vup=(0.0, 1.0, 0.0), free_camera=True, focus_dist=5.0),
}


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_generate_rays_matches_jax(name):
    """Directions have length ~focus_dist (5-10), where one float32 ulp is
    ~1e-6; the slow path chains ~10 ops, so atol 1e-5 leaves a few ulp of
    room."""
    jcam = jcamera.Camera(**CAMERAS[name])
    tcam = convert.camera_from_dict(dataclasses.asdict(jcam))
    assert dataclasses.asdict(tcam) == dataclasses.asdict(jcam)
    rng = np.random.default_rng(5)
    n = 2048
    px = rng.integers(0, jcam.image_width, n).astype(np.int32)
    py = rng.integers(0, jcam.image_height, n).astype(np.int32)
    stream = rng.integers(0, 2 ** 32, n, dtype=np.uint64)
    jo, jd, jt = jcamera.generate_rays(
        jcam, jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(stream.astype(np.uint32)), 11)
    to, td, tt = tcamera.generate_rays(
        tcam, torch.from_numpy(px), torch.from_numpy(py),
        torch.from_numpy(stream.astype(np.int64)), 11)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))  # pure RNG
    for a, b in zip(list(to) + list(td), list(jo) + list(jd)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def test_camera_builders_and_presets():
    for name in ("quick_preview", "standard_quality", "high_quality"):
        assert dataclasses.asdict(getattr(tcamera, name)()) == \
            dataclasses.asdict(getattr(jcamera, name)())
    t = (tcamera.Camera().set_resolution(64, 2.0).set_quality(3, 4)
         .set_position((1, 2, 3), (0, 0, 0), (0, 1, 0)).set_lens(30, 0.1, 2.0)
         .set_motion((1, 2, 4), (0, 0, 1)).set_background((0.1, 0.2, 0.3))
         .enable_sky_gradient().enable_free_camera((0, 0, 1), (0, 0, -2), (0, 2, 0)))
    j = (jcamera.Camera().set_resolution(64, 2.0).set_quality(3, 4)
         .set_position((1, 2, 3), (0, 0, 0), (0, 1, 0)).set_lens(30, 0.1, 2.0)
         .set_motion((1, 2, 4), (0, 0, 1)).set_background((0.1, 0.2, 0.3))
         .enable_sky_gradient().enable_free_camera((0, 0, 1), (0, 0, -2), (0, 2, 0)))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.image_height == j.image_height == 32


def test_film_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    accum = (rng.random((12, 16, 3)).astype(np.float32) * 6.0)
    accum[0, 0] = 0.0
    accum[0, 1] = -1.0
    jt = jfilm.tonemap(jnp.asarray(accum), 4)
    tt = tfilm.tonemap(torch.from_numpy(accum), 4)
    # divide, sqrt, clamp: each correctly rounded in both -> equal
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-7, rtol=0)
    assert float(tt.max()) <= np.float32(0.999) and float(tt.min()) >= 0.0
    u8 = tfilm.to_uint8(tt)
    assert u8.dtype == np.uint8
    assert np.abs(u8.astype(int) - jfilm.to_uint8(jt).astype(int)).max() <= 1
    path = tmp_path / "f.png"
    tfilm.write_png(str(path), u8)
    np.testing.assert_array_equal(jfilm.read_png(str(path)), u8)
    np.testing.assert_array_equal(tfilm.read_png(str(path)), u8)


def test_v3_and_vec_match_jax():
    rng = np.random.default_rng(9)
    a = rng.normal(size=(64, 3)).astype(np.float32)
    b = rng.normal(size=(64, 3)).astype(np.float32)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    a[0] = 0.0
    ta, tb = V3.from_rows(torch.from_numpy(a)), V3.from_rows(torch.from_numpy(b))
    ja, jb = JV3.from_rows(jnp.asarray(a)), JV3.from_rows(jnp.asarray(b))
    ua = ta.unit()
    pairs = [
        (ta.dot(tb), ja.dot(jb)), (ta.cross(tb).rows(), ja.cross(jb).rows()),
        (ua.rows(), ja.unit().rows()), (ta.reflect(tb).rows(), ja.reflect(jb).rows()),
        (ua.refract(tb, 0.7).rows(), ja.unit().refract(jb, 0.7).rows()),
        (ta.at(tb, 2.0).rows(), ja.at(jb, 2.0).rows()),
        (ta.near_zero(), ja.near_zero()), (ta.max_comp(), ja.max_comp()),
    ]
    # single float32 ops in a different association: a few ulp of O(1) values
    for t, j in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-6, rtol=1e-6)
    np.testing.assert_allclose(
        tvec.reflect(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        ta.reflect(tb).rows().numpy(), atol=2e-6)
    assert tvec.EPS_HIT == 1e-3
