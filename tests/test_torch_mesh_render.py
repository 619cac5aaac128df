"""PyTorch port vs the JAX package: ``cornell-lucy`` through the standard
integrator, forward and ``torch.autograd`` against ``jax.grad``.

The scene is ``cornell-lucy`` at ``mesh_detail=(12, 10)`` (216 triangles,
3 instances).  The JAX package renders with its Pallas kernels in interpret
mode (``pallas_intersect.INTERPRET`` and ``pallas_mesh.INTERPRET``, restored
afterwards); the port runs the kernels' plain versions, since the tensors
lie on the CPU.  A mesh scene takes the gather route in both packages.

Tolerance of the image: the integrator tests' rtol 1e-3 / atol 2e-3, met
by all but at most 1 % of the pixel values.  XLA contracts multiply-adds
into fused ones on the CPU and PyTorch does not, so a mesh hit's ``t``
differs in its last bits between the packages (tests/test_torch_mesh_kernels.py)
and, rarely, a path then takes another branch and changes its pixel
wholly.  Gradients: within 2e-3 of each key's largest entry, as in
tests/test_torch_integrator_grad.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import go_raytracing_tpu as grt
import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu.ops import pallas_intersect as jpk
from go_raytracing_tpu.ops import pallas_mesh as jpm
from go_raytracing_tpu.parallel import sharding as jsharding
from go_raytracing_tpu_torch.integrator import wavefront as twf
from go_raytracing_tpu_torch.ops import cuda_mesh as cm
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from test_torch_helpers import LUCY_CAM, build_lucy, grads_to_numpy, port_and_jax

torch.set_num_threads(2)

SEED = 3
IMAGE_TOL = dict(rtol=1e-3, atol=2e-3)


class _Interpret:
    """The JAX package's closest-hit and mesh kernels in interpret mode."""

    def __enter__(self):
        self.old = jpk.INTERPRET, jpm.INTERPRET
        jpk.INTERPRET = jpm.INTERPRET = True

    def __exit__(self, *exc):
        jpk.INTERPRET, jpm.INTERPRET = self.old


@pytest.fixture(scope="module")
def forward():
    js, jcam, ts, tcam = port_and_jax(build_lucy, LUCY_CAM)
    spp = jcam.samples_per_pixel
    with _Interpret():
        j_img = np.asarray(grt.render(js, jcam, seed=SEED)) / spp
    stats = grtt.RenderStats()
    before = cm.LAUNCHES_SWEEP, cm.LAUNCHES_STREAM
    t_img = grtt.render(ts, tcam, seed=SEED, device="cpu", stats=stats).numpy() / spp
    assert (cm.LAUNCHES_SWEEP, cm.LAUNCHES_STREAM) == before   # CPU: no launch
    return dict(ts=ts, tcam=tcam, j_img=j_img, t_img=t_img, stats=stats)


def test_render_matches_jax(forward):
    c = forward
    assert not cw.applicable(c["ts"])              # meshes: the standard integrator
    assert not twf.attr_path_ok(c["ts"], False)    # and its gather route
    assert c["stats"].mesh_overflow == 0
    t_img, j_img = c["t_img"], c["j_img"]
    assert np.isfinite(t_img).all() and j_img.mean() > 0.05
    off = ~np.isclose(t_img, j_img, **IMAGE_TOL)
    assert off.mean() <= 0.01, off.mean()
    assert np.abs(t_img - j_img).mean() < 2e-4


def test_mesh_is_in_the_picture(forward):
    """The statues change the picture: the same box without them differs."""
    c = forward
    bare = build_lucy(grtt, n_instances=0, device="cpu")
    assert not bare.meshes
    img = grtt.render(bare, c["tcam"], seed=SEED, device="cpu").numpy() / 2
    assert np.abs(img - c["t_img"]).max() > 0.1


def test_colour_gradients_match_jax_grad():
    """``torch.autograd`` through ``render(differentiable=True)`` against
    ``jax.grad`` through the JAX render, 8x8 pixels, 1 spp, depth 2: the
    statue's colour (texture 4) gets a gradient through the mesh record."""
    js, jcam, ts, tcam = port_and_jax(
        build_lucy, dict(LUCY_CAM, image_width=8, samples_per_pixel=1, max_depth=2))
    target = np.random.default_rng(0).uniform(0.1, 0.5, (8, 8, 3)).astype(np.float32)

    def j_loss(params):
        fb = grt.render(jsharding.apply_params(js, params), jcam, seed=SEED,
                        differentiable=True)
        return jnp.mean((fb - jnp.asarray(target)) ** 2)

    with _Interpret():
        j_l, j_g = jax.value_and_grad(j_loss)(jsharding.trainable_params(js))
    params = {k: v.clone().requires_grad_()
              for k, v in grtt.trainable_params(ts).items()}
    fb = grtt.render(grtt.apply_params(ts, params), tcam, seed=SEED, device="cpu",
                     differentiable=True)
    loss = torch.mean((fb - torch.from_numpy(target)) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_l), rtol=1e-4)
    t_g = grads_to_numpy({k: (torch.zeros_like(v) if v.grad is None else v.grad)
                          for k, v in params.items()})
    j_g = grads_to_numpy(j_g)
    for k, g in t_g.items():
        assert np.isfinite(g).all(), k
    ref = j_g["color"]
    big = np.abs(ref).max()
    assert np.abs(t_g["color"] - ref).max() <= 2e-3 * big
    statue = int(ts.meshes[0].inst_mat[0])
    tex_id = int(ts.materials.tex[statue])
    assert np.abs(t_g["color"][tex_id]).min() > 1e-4 * big


def test_mesh_scene_refuses_what_is_not_ported():
    ts = build_lucy(grtt, device="cpu")
    cam = grtt.Camera(**dict(LUCY_CAM, image_width=4, samples_per_pixel=1))
    with pytest.raises(NotImplementedError, match="A18"):
        grtt.render_grad(ts, cam, torch.zeros(4, 4, 3), device="cpu")
    with pytest.raises(NotImplementedError, match="megakernel"):
        grtt.render(ts, cam, device="cpu", mega_mode="single")
