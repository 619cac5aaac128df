"""PyTorch port vs the JAX package: ``render_grad`` on the replay tier for
a mesh scene, ``cornell-lucy`` at ``mesh_detail=(12, 10)`` (216 triangles x
3 instances), 16 px, 2 spp, depth 3.

Both packages route it to their replay tier (meshes are outside every
gradient kernel's gate) and record on the standard integrator; the JAX
package's mesh and closest-hit kernels run in interpret mode, the port's
plain versions run because the tensors lie on the CPU.  Loss rtol 1e-5;
every gradient key rtol 2e-3 and atol 2e-4 of its largest entry
(tests/test_replay.py's tolerances).  One JAX gradient is compiled, in a
module fixture; the record of the mesh scene is then held against the JAX
package's through the program its ``render_grad`` compiled
(tests/test_torch_replay.py says how records are compared).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu.ops import pallas_intersect as jpk
from go_raytracing_tpu.ops import pallas_mesh as jpm
from go_raytracing_tpu.ops import pallas_wavefront as jmega
from go_raytracing_tpu.render import grad as jgrad
from go_raytracing_tpu.render import renderer as jrenderer
from go_raytracing_tpu_torch.core.vec3 import V3
from go_raytracing_tpu_torch.integrator import wavefront as twf
from go_raytracing_tpu_torch.render import grad as tgrad
from test_torch_helpers import LUCY_CAM, build_lucy, grads_to_numpy, port_and_jax
from test_torch_replay import _canonical, check_record_shares, held_bytes

torch.set_num_threads(2)

SEED = 2
CAM = dict(LUCY_CAM, max_depth=3)


def jax_route_is_replay(js, depth):
    """The JAX package's ``render_grad`` takes its replay tier: no kernel
    tier's gate holds (read with its megakernel enabled, as on a TPU)."""
    from go_raytracing_tpu.integrator import wavefront as jwf

    old = jmega.INTERPRET
    jmega.INTERPRET = True
    try:
        return not (jmega.grad_applicable(js, depth)
                    or jmega.grad_pathwise_applicable(js, depth)
                    or jwf.image_prefactor_ok(js))
    finally:
        jmega.INTERPRET = old


def jax_first_chunk(js, jcam, seed):
    """What the JAX package's ``render_grad`` takes as its first replay
    chunk: (chunk size, camera, rays o, d, tm, stream ids, pixel, valid) as
    its ``_chunk_rays`` gives them, and the same rays as the port's tensors
    (o, d, tm, ids, pixel, valid)."""
    spp, depth = jcam.samples_per_pixel, jcam.max_depth
    _, _, n_virt = jrenderer.ray_layout(jcam.image_width, jcam.image_height,
                                        jrenderer.scene_tiled(js))
    total = n_virt * spp
    chunk = max(jrenderer.pick_chunk_size(js) // 2, 1024)
    chunk = min(chunk, max(1024, -(-total // 1024) * 1024))
    j = jgrad._chunk_rays(js, jcam, jnp.uint32(0), seed, spp=spp, chunk=chunk,
                          max_depth=depth)

    def t(a):
        return torch.from_numpy(np.asarray(a).copy())

    cam2, o, d, tm, ids, pixel, valid = j
    port = (V3(*(t(c) for c in o)), V3(*(t(c) for c in d)), t(tm),
            t(ids).long(), t(pixel).long(), t(valid))
    return chunk, j, port


def check_against_jax(t_loss, t_g, j_loss, j_g):
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    t_g, j_g = grads_to_numpy(t_g), grads_to_numpy(j_g)
    assert set(t_g) == set(j_g)
    for k, ref in j_g.items():
        assert np.isfinite(t_g[k]).all(), k
        scale = max(np.abs(ref).max(), 1e-8)
        np.testing.assert_allclose(t_g[k], ref, rtol=2e-3, atol=2e-4 * scale,
                                   err_msg=k)


@pytest.fixture(scope="module")
def lucy():
    js, jcam, ts, tcam = port_and_jax(build_lucy, CAM)
    rng = np.random.default_rng(SEED)
    target = (rng.random((jcam.image_height, jcam.image_width, 3)) * 0.5).astype(np.float32)
    old = jpk.INTERPRET, jpm.INTERPRET
    jpk.INTERPRET = jpm.INTERPRET = True
    try:
        j_loss, j_g = jgrad.render_grad(js, jcam, target, seed=SEED)
        # the record of its first chunk, by the program render_grad compiled
        chunk, j_rays, t_rays = jax_first_chunk(js, jcam, SEED)
        mode = jgrad._record_mega_mode(js, jcam, chunk, jcam.max_depth)
        _, j_dec = jgrad._record_chunk(
            js, jcam, jnp.zeros((jcam.image_width * jcam.image_height, 3), jnp.float32),
            jnp.uint32(0), SEED, spp=jcam.samples_per_pixel, chunk=chunk,
            max_depth=jcam.max_depth, mega_mode=mode)
    finally:
        jpk.INTERPRET, jpm.INTERPRET = old
    stats = grtt.RenderStats()
    t_loss, t_g = grtt.render_grad(ts, tcam, torch.from_numpy(target), seed=SEED,
                                   device="cpu", stats=stats)
    return (js, ts, tcam, target, (t_loss, t_g, stats), (float(j_loss), j_g),
            (t_rays, _canonical(js, j_dec)))


def test_standard_record_of_a_mesh_scene_matches_the_jax_package(lucy):
    """The standard integrator's record of a mesh scene (the mesh kernels'
    plain versions here, the JAX package's mesh kernels in interpret mode)."""
    _, ts, tcam, _, _, _, ((o, d, tm, ids, _, _), j_dec) = lucy
    _, dec = twf.trace(ts, tcam, o, d, tm, ids, SEED, mega_mode="off", record=True)
    check_record_shares("cornell-lucy", dec, j_dec)
    assert int((dec.which >= twf.HIT_MESH_BASE).sum()) >= 20   # statues recorded
    # a mesh scene's record keeps the instance ids too: 10 B a ray-bounce
    charged = tm.shape[0] * tgrad.dec_bytes_per_ray(ts, tcam.max_depth)
    assert twf.decision_bytes(ts) == 10
    assert charged <= held_bytes(dec) <= charged + 1


def test_render_grad_replay_matches_the_jax_package(lucy):
    js, ts, tcam, _, (t_loss, t_g, stats), (j_loss, j_g), _ = lucy
    assert tgrad.grad_tier(ts, tcam.max_depth) == "replay"
    assert jax_route_is_replay(js, tcam.max_depth)
    assert stats.chunks == 1
    check_against_jax(t_loss, t_g, j_loss, j_g)
    statue = int(ts.materials.tex[int(ts.meshes[0].inst_mat[0])])
    assert float(t_g["color"][statue].abs().min()) > 0.0


def test_render_grad_replay_records_again_over_budget(lucy):
    """``dec_budget=0``: pass A keeps no record and pass B records each
    chunk again; the same loss and gradients, chunk by chunk."""
    _, ts, tcam, target, (t_loss, t_g, _), _, _ = lucy
    stats = grtt.RenderStats()
    loss, g = grtt.render_grad(ts, tcam, torch.from_numpy(target), seed=SEED,
                               device="cpu", dec_budget=0, chunk=1024, stats=stats)
    assert stats.chunks == 2
    np.testing.assert_allclose(float(loss), float(t_loss), rtol=1e-6)
    for k, v in t_g.items():
        np.testing.assert_allclose(g[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6 * max(float(v.abs().max()), 1e-8),
                                   err_msg=k)


def test_render_grad_replay_matches_autograd_and_render(lucy):
    """The loss is that of ``render``'s picture, and the colour gradients
    are those of ``torch.autograd`` through ``render(differentiable=True)``
    (colours do not reach the hit distance)."""
    _, ts, tcam, target, (t_loss, t_g, _), _, _ = lucy
    spp = tcam.samples_per_pixel
    fb = grtt.render(ts, tcam, seed=SEED, device="cpu")
    target = torch.from_numpy(target)
    np.testing.assert_allclose(float(t_loss), float(torch.mean((fb / spp - target) ** 2)),
                               rtol=1e-5)
    colour = ts.textures.color.clone().requires_grad_()
    params = dict(grtt.trainable_params(ts), color=colour)
    fb = grtt.render(grtt.apply_params(ts, params), tcam, seed=SEED, device="cpu",
                     differentiable=True)
    torch.mean((fb / spp - target) ** 2).backward()
    big = float(t_g["color"].abs().max())
    assert float((colour.grad - t_g["color"]).abs().max()) <= 2e-3 * big
