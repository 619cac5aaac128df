"""PyTorch port vs the JAX package: the forward wavefront megakernel.

On the CPU the port's wrapper runs the kernel's plain PyTorch version; the
JAX side runs the Pallas kernel itself in interpret mode.  The CUDA kernel
can only run on a GPU: its tests are in tests/test_torch_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import go_raytracing_tpu as grt
import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu import camera as jcamera
from go_raytracing_tpu.ops import pallas_wavefront as jmega
from go_raytracing_tpu_torch import camera as tcamera
from go_raytracing_tpu_torch import convert
from go_raytracing_tpu_torch.core.vec3 import V3
from go_raytracing_tpu_torch.integrator import wavefront as twf
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from test_torch_helpers import MIXED_CAM, build_mixed, scene_tree

torch.set_num_threads(2)


def _rays(cam, n, seed, device="cpu"):
    ids = torch.arange(n, dtype=torch.int64, device=device)
    px = ids % cam.image_width
    py = (ids // cam.image_width) % cam.image_height
    o, d, tm = tcamera.generate_rays(cam, px, py, ids, seed)
    return o, d, tm, ids


def test_plain_version_matches_interpret_pallas_kernel():
    """Mixed scene, 1024 rays, depth 4.  Same RNG bits and the same
    formulas, but XLA and PyTorch round sums of products differently (fused
    multiply-adds, association), and an ulp can flip a discrete decision
    (an edge hit, a Schlick draw, a volume accept): such a ray then differs
    wholly.  So: per ray, fewer than 1 % outside rtol/atol 1e-4, and on
    the agreeing rays the miss flags are equal."""
    js = build_mixed(grt)
    jcam = jcamera.Camera(**MIXED_CAM)
    ts = convert.scene_from_numpy(scene_tree(js), "cpu")
    tcam = convert.camera_from_dict(dataclasses.asdict(jcam))
    n, seed = 1024, 2
    o, d, tm, ids = _rays(tcam, n, seed)

    def to_j(v):
        return grt.core.vec3.V3(*(jnp.asarray(c.numpy()) for c in v))

    jmega.INTERPRET = True
    try:
        assert jmega.applicable(js)
        ref = jmega.trace_megakernel(
            js, jcam, to_j(o), to_j(d), jnp.asarray(tm.numpy()),
            jnp.asarray(ids.numpy().astype(np.uint32)), seed)
        ref = jax.tree_util.tree_map(np.asarray, ref)
    finally:
        jmega.INTERPRET = False
    j_rows = np.stack(list(ref[0]) + list(ref[1]) + list(ref[2]))

    before = cw.LAUNCHES
    rad, m_dir, m_tp, flags = cw.trace_megakernel(ts, tcam, o, d, tm, ids, seed)
    assert cw.LAUNCHES == before  # CPU tensors: plain version, no launch
    t_rows = torch.stack(list(rad) + list(m_dir) + list(m_tp)).numpy()
    flags = flags.numpy()

    assert np.isfinite(t_rows).all()
    assert j_rows[:3].sum() > 0
    bad = ~np.isclose(t_rows, j_rows, rtol=1e-4, atol=1e-4).all(axis=0)
    assert bad.mean() < 0.01, bad.mean()
    good = ~bad
    np.testing.assert_array_equal((flags & cw.FLAG_MISSED != 0)[good], ref[3][good])
    np.testing.assert_array_equal((flags & cw.FLAG_PRIMARY != 0)[good], ref[4][good])
    # every path exercised: misses, primary misses, survivors
    assert (flags & cw.FLAG_MISSED).any() and (flags & cw.FLAG_ALIVE).any()


def test_flag_word_and_depth_semantics():
    ts, cam = grtt.load_scene("simple", device="cpu")
    cam = dataclasses.replace(cam, image_width=16, max_depth=3)
    o, d, tm, ids = _rays(cam, 256, 1)
    rad, m_dir, m_tp, flags = cw.trace_megakernel(ts, cam, o, d, tm, ids, 1)
    missed = (flags & cw.FLAG_MISSED) != 0
    alive = (flags & cw.FLAG_ALIVE) != 0
    primary = (flags & cw.FLAG_PRIMARY) != 0
    assert not (missed & alive).any()          # a miss ends the path
    assert (primary <= missed).all()           # primary implies missed
    # no light in this scene: radiance comes from the miss shader only
    assert float(torch.stack(list(rad)).abs().max()) == 0.0
    # missed rays carry a direction and a throughput in [0, 1]
    assert (torch.stack(list(m_dir)).abs().sum(0)[missed] > 0).all()
    mt = torch.stack(list(m_tp))[:, missed]
    assert (mt >= 0).all() and (mt <= 1).all() and (mt.sum(0) > 0).all()
    # depth 1: every ray either missed on the primary segment or is cut
    cam1 = dataclasses.replace(cam, max_depth=1)
    _, _, _, f1 = cw.trace_megakernel(ts, cam1, o, d, tm, ids, 1)
    assert (((f1 & cw.FLAG_MISSED) != 0) == ((f1 & cw.FLAG_PRIMARY) != 0)).all()


def test_stream_above_2_31_and_dtype():
    """The stream id is an unsigned 32-bit counter whatever the dtype."""
    ts, cam = grtt.load_scene("quads", device="cpu")
    cam = dataclasses.replace(cam, image_width=8, max_depth=3)
    o, d, tm, _ = _rays(cam, 64, 0)
    big = torch.arange(64, dtype=torch.int64) + (2 ** 32 - 32)  # crosses 2^31.. wraps at 2^32
    i32 = cw.stream_to_i32(big)
    assert i32.dtype == torch.int32
    assert torch.equal(i32.to(torch.int64) & 0xFFFFFFFF, big & 0xFFFFFFFF)
    a = cw.trace_megakernel(ts, cam, o, d, tm, big, 5)
    b = cw.trace_megakernel(ts, cam, o, d, tm, i32, 5)
    for x, y in zip(list(a[0]) + [a[3]], list(b[0]) + [b[3]]):
        assert torch.equal(x, y)


def test_trace_gates():
    ts, cam = grtt.load_scene("cornell", device="cpu")
    cam = dataclasses.replace(cam, image_width=8)
    o, d, tm, ids = _rays(cam, 64, 0)
    assert twf.choose_mega_mode(ts, cam, 64, False) == "single"
    assert twf.choose_mega_mode(ts, cam, 64, True) == "off"
    with pytest.raises(NotImplementedError, match="gather integrator"):
        twf.trace(ts, cam, o, d, tm, ids, 0, differentiable=True)
    outside = dataclasses.replace(ts, has_noise=True)
    assert twf.choose_mega_mode(outside, cam, 64, False) == "off"
    with pytest.raises(NotImplementedError):
        twf.trace(outside, cam, o, d, tm, ids, 0)
    with pytest.raises(NotImplementedError):
        cw.trace_megakernel(outside, cam, o, d, tm, ids, 0)
    # [R, 3] inputs are accepted and give the same radiance as V3 inputs
    r1 = twf.trace(ts, cam, o, d, tm, ids, 0)
    r2, stats = twf.trace(ts, cam, o.rows(), d.rows(), tm, ids, 0, with_stats=True)
    assert stats == dict(mesh_overflow=0)
    assert torch.equal(r1.rows(), r2.rows())


def test_miss_shader_flat_and_sky():
    ts, cam = grtt.load_scene("quads", device="cpu")
    d = V3.from_rows(torch.tensor([[0.0, 2.0, 0.0], [0.0, -1.0, 0.0], [3.0, 0.0, 4.0]]))
    prim = torch.zeros(3, dtype=torch.bool)
    sky = twf._miss_radiance(ts, cam, d, prim).rows()
    np.testing.assert_allclose(
        sky.numpy(), [[0.5, 0.7, 1.0], [1.0, 1.0, 1.0], [0.75, 0.85, 1.0]], atol=1e-6)
    flat_cam = dataclasses.replace(cam, use_sky_gradient=False, background=(0.1, 0.2, 0.3))
    flat = twf._miss_radiance(ts, flat_cam, d, prim).rows()
    np.testing.assert_allclose(flat.numpy(), [[0.1, 0.2, 0.3]] * 3, atol=1e-7)
