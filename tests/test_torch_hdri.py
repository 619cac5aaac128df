"""PyTorch port vs the JAX package: the environment modules (``io/hdr``,
``io/assets``, ``lights/hdri``, ``core/segsum``) and, end to end, the
phantom-HDRI rule of the miss shader through ``render_grad``.

Inputs are made from numpy seeds.  The alias tables are built by the same
NumPy code in both packages and must be equal bit for bit; what runs in
float32 on each side (directions, texel fetches, pdfs, sums) is compared at
rtol 1e-5 (transcendentals may round differently in their last bit), a
texel index where the footprint's position lands within an ulp of a texel
edge may differ.  The file makes one JAX gradient call (``render_grad`` of
the mini-HDRI scene with the phantom rule on), cached; the other phantom
value is in tests/test_torch_env_render.py."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import go_raytracing_tpu as grt
import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu.core import segsum as jsegsum
from go_raytracing_tpu.core.vec3 import V3 as JV3
from go_raytracing_tpu.io import hdr as jhdr
from go_raytracing_tpu.lights import hdri as jhdri
from go_raytracing_tpu_torch import convert
from go_raytracing_tpu_torch.core import segsum
from go_raytracing_tpu_torch.core.vec3 import V3
from go_raytracing_tpu_torch.io import assets, hdr
from go_raytracing_tpu_torch.lights import hdri
from go_raytracing_tpu_torch.render import grad as tgrad
from test_torch_helpers import (MINI_HDRI_CAM, build_mini_hdri, grads_to_numpy,
                                mini_env, scene_tree)

torch.set_num_threads(2)


def _rgbe(h, w, seed):
    rng = np.random.default_rng(seed)
    rgbe = rng.integers(0, 255, size=(h, w, 4), dtype=np.uint8)
    rgbe[..., 3] = rng.integers(120, 140, size=(h, w))
    rgbe[0, :2, 3] = 0          # exponent 0: black
    return rgbe


def _write_hdr(path, rgbe, rle):
    h, w = rgbe.shape[:2]
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        if not rle:
            f.write(rgbe.tobytes())
            return
        for y in range(h):
            f.write(bytes([2, 2, w >> 8, w & 255]))
            for comp in range(4):
                row = rgbe[y, :, comp]
                # a run of the first value over 3 pixels, then literals
                f.write(bytes([128 + 3, int(row[0])]))
                f.write(bytes([w - 3]) + row[3:].tobytes())


@pytest.mark.parametrize("rle", [False, True])
def test_rgbe_loader_reads_what_the_jax_loader_reads(tmp_path, rle):
    rgbe = _rgbe(3, 10, 2)
    if rle:
        rgbe[:, 1:3] = rgbe[:, :1]   # the run
    path = str(tmp_path / "t.hdr")
    _write_hdr(path, rgbe, rle)
    got = hdr.load_hdr(path)
    np.testing.assert_array_equal(got, jhdr.load_hdr(path))
    e = rgbe[..., 3].astype(np.int32)
    want = (rgbe[..., :3] + 0.5) * np.ldexp(1.0, e - 136)[..., None]
    want[e == 0] = 0
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-6)
    # an environment can be built from the file's path
    b = grtt.SceneBuilder()
    b.set_environment(path)
    b.sphere((0, 0, 0), 1.0, b.lambertian((0.5, 0.5, 0.5)))
    np.testing.assert_array_equal(b.build(device="cpu").env.data.numpy(), got)


def test_find_asset(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "assets" / "hdri").mkdir(parents=True)
    (tmp_path / "assets" / "hdri" / "sky.hdr").write_bytes(b"#?")
    assert assets.find_asset("assets/hdri/sky.hdr", "hdri") == "assets/hdri/sky.hdr"
    assert assets.find_asset("sky.hdr", "hdri") == "assets/hdri/sky.hdr"
    with pytest.raises(FileNotFoundError, match="gone.hdr"):
        assets.find_asset("assets/hdri/gone.hdr", "hdri")


def test_hdri_test_scene_raises_for_its_missing_asset():
    """ROADMAP.md C1: the asset is not in the repository; both builders
    raise ``FileNotFoundError`` naming it."""
    for load in (lambda: grt.load_scene("hdri-test"),
                 lambda: grtt.load_scene("hdri-test", device="cpu")):
        with pytest.raises(FileNotFoundError, match="abandoned_hall_01_1k.hdr"):
            load()


def _data(case):
    rng = np.random.default_rng(11)
    if case == "noise":
        return rng.uniform(0.0, 5.0, (6, 10, 3)).astype(np.float32), 33.0
    if case == "sun":
        data = rng.uniform(0.01, 0.2, (16, 32, 3)).astype(np.float32)
        data[3:5, 20:23] = 40.0
        return data, 0.0
    return np.zeros((4, 8, 3), np.float32), 0.0      # no power at all


@pytest.mark.parametrize("case", ["noise", "sun", "black"])
def test_alias_tables_are_the_jax_packages(case):
    data, rot = _data(case)
    t = hdri.build_environment(data, rot)
    j = jhdri.build_environment(data, rot)
    for name in hdri.Environment._fields:
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@functools.lru_cache(maxsize=None)
def _envs():
    data, rot = _data("sun")
    return hdri.build_environment(data, rot), jhdri.build_environment(data, rot)


def _dirs(n=2048, seed=5):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:128, 0] *= 0.01          # poles and the seam
    d[:128, 2] *= 0.01
    d[128:256, 1] *= 0.01
    return d


def _v3(d):
    return V3(*(torch.from_numpy(np.ascontiguousarray(d[:, i])) for i in range(3)))


def _jv3(d):
    import jax.numpy as jnp
    return JV3(*(jnp.asarray(d[:, i]) for i in range(3)))


def _np(v):
    return np.stack([np.asarray(c) for c in v])


def test_sampling_matches_jax():
    """sample_direction_soa (direction, emission, pdf), the alias pick's
    texel, and pdf_soa of the sampled directions."""
    import jax.numpy as jnp

    t, j = _envs()
    rng = np.random.default_rng(3)
    xi = rng.uniform(size=(2, 4096)).astype(np.float32)
    xt = [torch.from_numpy(x) for x in xi]
    xj = [jnp.asarray(x) for x in xi]
    td, te, tp = hdri.sample_direction_soa(t, *xt)
    jd, je, jp = jhdri.sample_direction_soa(j, *xj)
    np.testing.assert_allclose(_np(td), _np(jd), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(_np(te), _np(je))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5)
    jy, jx = jhdri._alias_pick(j, *xj)
    np.testing.assert_array_equal(hdri.texel_ids(t, *xt).numpy(),
                                  np.asarray(jy) * 32 + np.asarray(jx))
    # the sun (6 of 512 texels) draws most samples
    assert float((te.x > 10).float().mean()) > 0.5
    np.testing.assert_allclose(hdri.pdf_soa(t, td).numpy(),
                               np.asarray(jhdri.pdf_soa(j, jd)), rtol=1e-5)
    # the [R, 3] forms are the SoA forms
    d3, e3, p3 = hdri.sample_direction(t, *xt)
    np.testing.assert_array_equal(d3.numpy(), _np(td).T)
    np.testing.assert_array_equal(e3.numpy(), _np(te).T)
    np.testing.assert_array_equal(p3.numpy(), tp.numpy())


def test_miss_shader_matches_jax():
    """miss_footprint and sample_soa against the JAX package's, and the
    [R, 3] forms (direction_to_uv, sample, pdf) against the SoA forms."""
    t, j = _envs()
    d = _dirs()
    fx, fy, base = hdri.miss_footprint(t, _v3(d))
    jfx, jfy, jbase = jhdri.miss_footprint(j, _jv3(d))
    same = base.numpy() == np.asarray(jbase)
    assert same.mean() > 0.998
    np.testing.assert_allclose(fx.numpy()[same], np.asarray(jfx)[same], atol=1e-5)
    np.testing.assert_allclose(fy.numpy()[same], np.asarray(jfy)[same], atol=1e-5)
    col = hdri.sample_soa(t, _v3(d))
    np.testing.assert_allclose(_np(col)[:, same], _np(jhdri.sample_soa(j, _jv3(d)))[:, same],
                               rtol=1e-5, atol=1e-5)
    dt = torch.from_numpy(d)
    np.testing.assert_allclose(hdri.sample(t, dt).numpy(), _np(col).T, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(hdri.pdf(t, dt).numpy(), hdri.pdf_soa(t, _v3(d)).numpy())
    u, v = hdri.direction_to_uv(t, dt)
    back = hdri.uv_to_direction(t, u, v)
    unit = dt / torch.linalg.norm(dt, dim=1, keepdim=True)
    assert float((back - unit).abs().max()) < 1e-3


def test_miss_texel_grad_matches_jax_and_autograd():
    """The texel gradient written out (sorted per-texel sums, the quad
    table's transpose) against the JAX package's, and against
    ``torch.autograd`` of the port's own miss shader."""
    t, j = _envs()
    d = _dirs()
    rng = np.random.default_rng(9)
    lam = rng.normal(size=(3, d.shape[0])).astype(np.float32)
    lam[:, ::7] = 0.0
    got = hdri.miss_texel_grad(t, _v3(d), V3(*(torch.from_numpy(x) for x in lam)))
    import jax.numpy as jnp
    want = np.asarray(jhdri.miss_texel_grad(j, _jv3(d), JV3(*(jnp.asarray(x) for x in lam))))
    big = np.abs(want).max()
    assert big > 0
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5 * big)
    data = t.data.clone().requires_grad_()
    col = hdri.sample_soa(t._replace(data=data), _v3(d))
    sum((c * torch.from_numpy(x)).sum() for c, x in zip(col, lam)).backward()
    np.testing.assert_allclose(data.grad.numpy(), got.numpy(), atol=1e-6 * big)
    # the quad table's transpose is that of autograd
    q = torch.from_numpy(rng.normal(size=(16 * 32, 12)).astype(np.float32))
    x = t.data.clone().requires_grad_()
    (hdri.quad_table(x) * q).sum().backward()
    np.testing.assert_allclose(hdri.quad_table_transpose(q, 16, 32).numpy(),
                               x.grad.numpy(), rtol=1e-6, atol=1e-6)


def test_segment_sums_match_jax_and_drop_negative_ids():
    """rows_segment_sum against the JAX package's on ids in range, and
    (ROADMAP.md C2) ids below 0 or past the last bin are dropped: the
    result is ``np.add.at`` over the ids in range."""
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 300, size=5000).astype(np.int32)
    ids[:800] = 42
    rows = rng.normal(size=(5000, 5)).astype(np.float32)
    import jax.numpy as jnp
    want = np.asarray(jsegsum.rows_segment_sum(jnp.asarray(ids), jnp.asarray(rows), 300))
    got = segsum.rows_segment_sum(torch.from_numpy(ids), torch.from_numpy(rows), 300)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())
    bad = ids.copy()
    bad[::9] = -1 - (np.arange(bad[::9].size) % 3)
    bad[1::11] = 300 + np.arange(bad[1::11].size) % 4
    ref = np.zeros((300, 5), np.float64)
    keep = (bad >= 0) & (bad < 300)
    np.add.at(ref, bad[keep], rows[keep].astype(np.float64))
    got = segsum.rows_segment_sum(torch.from_numpy(bad), torch.from_numpy(rows), 300)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max())
    # the factored form expands after the sort
    cols = segsum.cols_segment_sum_factored(
        torch.from_numpy(bad), [torch.from_numpy(rows[:, 0])],
        lambda a: [a, 2.0 * a], 300)
    np.testing.assert_allclose(cols.numpy(), np.stack([ref[:, 0], 2 * ref[:, 0]], 1),
                               atol=1e-5 * np.abs(ref).max())


def test_environment_crosses_over_and_is_a_parameter():
    """The JAX scene's environment reaches the port through
    ``convert.scene_from_numpy`` bit for bit; ``env_data`` is a trainable
    parameter, and ``apply_params`` swaps the texels only."""
    js = build_mini_hdri(grt)
    ts = convert.scene_from_numpy(scene_tree(js), "cpu")
    own = build_mini_hdri(grtt, device="cpu")
    for name in hdri.Environment._fields:
        np.testing.assert_array_equal(getattr(ts.env, name).numpy(),
                                      np.asarray(getattr(js.env, name)), err_msg=name)
        np.testing.assert_array_equal(getattr(ts.env, name).numpy(),
                                      getattr(own.env, name).numpy(), err_msg=name)
    params = grtt.trainable_params(ts)
    assert params["env_data"] is ts.env.data
    swapped = grtt.apply_params(ts, dict(params, env_data=ts.env.data * 2.0))
    assert torch.equal(swapped.env.data, ts.env.data * 2.0)
    assert swapped.env.alias_idx is ts.env.alias_idx
    np.testing.assert_array_equal(ts.env.data.numpy(), mini_env())


@functools.lru_cache(maxsize=None)
def _phantom_grads():
    import jax.numpy as jnp
    from go_raytracing_tpu import camera as jcamera
    from go_raytracing_tpu.render.grad import render_grad as jrender_grad

    fields = dict(MINI_HDRI_CAM, phantom_hdri=True)
    js = build_mini_hdri(grt)
    ts = convert.scene_from_numpy(scene_tree(js), "cpu")
    target = np.random.default_rng(6).uniform(0.1, 0.6, (16, 16, 3)).astype(np.float32)
    j_loss, j_g = jrender_grad(js, jcamera.Camera(**fields), jnp.asarray(target), seed=0)
    tcam = grtt.Camera(**fields)
    t_loss, t_g = grtt.render_grad(ts, tcam, torch.from_numpy(target), seed=0,
                                   device="cpu")
    return (float(j_loss), grads_to_numpy(j_g), float(t_loss), grads_to_numpy(t_g),
            ts, tcam, target)


def test_render_grad_with_the_phantom_rule_matches_jax():
    """``render_grad`` of the mini-HDRI scene (no light: the pathwise
    two-phase tier, with the environment's miss rows) with the phantom rule
    on (camera rays that miss see black), against the JAX package's (its
    replay tier on the CPU): the loss at rtol 1e-5, every gradient at rtol
    5e-3 / atol 1e-4 of its largest entry (the JAX package's own tolerance
    for its environment gradient kernel)."""
    j_loss, j_g, t_loss, t_g, ts, tcam, target = _phantom_grads()
    assert tgrad.grad_tier(ts, tcam.max_depth) == "pathwise"
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    for k in ("color", "even_color", "odd_color", "fuzz", "ior", "env_data"):
        big = np.abs(j_g[k]).max()
        assert big > 1e-6, k
        np.testing.assert_allclose(t_g[k], j_g[k], rtol=5e-3, atol=1e-4 * big, err_msg=k)
    # the rule is what it says: camera rays that miss add nothing
    fb = grtt.render(ts, tcam, seed=0, device="cpu")
    off = grtt.render(ts, dataclasses.replace(tcam, phantom_hdri=False), seed=0,
                      device="cpu")
    assert float((off - fb).min()) >= 0.0 and float((off - fb).max()) > 0.0
    np.testing.assert_allclose(t_loss, float(((fb / 4 - torch.from_numpy(target)) ** 2).mean()),
                               rtol=1e-5)
