"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests carry the ``cuda`` marker and skip, with a reason, on a machine
without a CUDA device (a CUDA kernel has no CPU or interpret mode).  This
file imports the port only, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu_torch import camera as tcamera
from go_raytracing_tpu_torch.core.vec3 import V3
from go_raytracing_tpu_torch.geometry import mesh_bvh
from go_raytracing_tpu_torch.integrator import wavefront
from go_raytracing_tpu_torch.io import obj as tobj
from go_raytracing_tpu_torch.ops import cuda_intersect as ck
from go_raytracing_tpu_torch.ops import cuda_mesh as cm
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from go_raytracing_tpu_torch.utils import stream_micro as sm
from test_torch_helpers import (CORNELL_IMAGE_CAM, CULL_CASES, ENV_NEE_CAM, FOG_ROOM_CAM,
                                IMAGE_SPHERE_CAM, LUCY_CAM, MANY_TEXTURES_CAM, MARBLE_CAM,
                                MINI_HDRI_CAM, MIXED_CAM, NOISE_GLOSSY_CAM,
                                build_cornell_image, build_env_nee, build_fog_room,
                                build_image_sphere, build_lucy, build_many_textures,
                                build_marble, build_mini_hdri, build_mixed, build_noise_glossy,
                                build_random_prims, build_sphere_cloud, cull_case,
                                lengths_in_turn, lucy_instances, marble_lane_stash, mesh_rays,
                                mini_env, random_rays, seeded_atlas)


def _rays(cam, n, seed, device):
    ids = torch.arange(n, dtype=torch.int64, device=device)
    px = ids % cam.image_width
    py = (ids // cam.image_width) % cam.image_height
    o, d, tm = tcamera.generate_rays(cam, px, py, ids, seed)
    return o, d, tm, ids


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", ["mixed", "cornell", "random-700"])
def test_cuda_kernel_matches_plain_version(scene_name):
    """On a GPU: the hand-written kernel against its plain version, per
    ray.  nvcc contracts a*b+c into fused multiply-adds and PyTorch's
    elementwise kernels do not, so a small share of rays may take another
    branch: fewer than 0.5 % outside rtol/atol 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    if scene_name == "mixed":
        scene = build_mixed(grtt, device="cuda")
        cam = tcamera.Camera(**MIXED_CAM)
    elif scene_name == "cornell":
        scene, cam = grtt.load_scene("cornell", device="cuda")
    else:
        # 64 KB of tables: read from device memory, not shared memory
        scene, cam = grtt.load_scene("random", device="cuda", grid=(-14, 14, -14, 14))
        assert cw.build_tables(scene).st.numel() * 4 > 48 * 1024
        cam = dataclasses.replace(cam, max_depth=4)
    cam = dataclasses.replace(cam, image_width=64, aspect_ratio=1.0)
    n = 64 * 64 * (1 if scene_name == "random-700" else 4)  # plain version: 716 spheres
    o, d, tm, ids = _rays(cam, n, 3, "cuda")
    before = cw.LAUNCHES
    k = cw.trace_megakernel(scene, cam, o, d, tm, ids, 3)
    torch.cuda.synchronize()
    assert cw.LAUNCHES == before + 1
    p = cw.trace_megakernel_plain(scene, cam, o, d, tm, ids, 3)
    kr = torch.stack(list(k[0]) + list(k[1]) + list(k[2]))
    pr = torch.stack(list(p[0]) + list(p[1]) + list(p[2]))
    bad = ~(torch.isclose(kr, pr, rtol=1e-3, atol=1e-3).all(dim=0) & (k[3] == p[3]))
    assert float(bad.float().mean()) < 0.005


@pytest.mark.cuda
def test_cuda_render_goes_through_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene, cam = grtt.load_scene("cornell")  # no device given: the GPU
    assert scene.device.type == "cuda"
    cam = dataclasses.replace(cam, image_width=64, samples_per_pixel=4)
    stats = grtt.RenderStats()
    before = cw.LAUNCHES
    img = grtt.render_image(scene, cam, seed=1, stats=stats)
    assert img.is_cuda and cw.LAUNCHES == before + stats.chunks
    cpu_scene, _ = grtt.load_scene("cornell", device="cpu")
    ref = grtt.render_image(cpu_scene, cam, seed=1, device="cpu")
    # same streams on both devices; an ulp flips a few rays of 16384
    assert float((img.cpu() - ref).abs().mean()) < 0.01 * float(ref.mean())


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene, cam = grtt.load_scene("quads")
    cam = dataclasses.replace(cam, image_width=8)
    o, d, tm, ids = _rays(cam, 64, 0, "cuda")
    tb = cw.build_tables(scene)
    with pytest.raises(ValueError):
        cw._wavefront_fwd_cuda(tb, o, d, tm.double(), cw.stream_to_i32(ids), 0, 3)
    with pytest.raises(ValueError):
        cw._wavefront_fwd_cuda(tb, o, d, tm, ids, 0, 3)  # int64 stream
    with pytest.raises(ValueError):
        cw._wavefront_fwd_cuda(tb, o, d, tm[::2], cw.stream_to_i32(ids), 0, 3)
    # the culled sweep's tables: on the rays' device, of their own shapes
    cloud = cw.build_tables(build_sphere_cloud(grtt, device="cuda"))
    for bad in (cloud._replace(grp_box=cloud.grp_box.cpu()),
                cloud._replace(grp_start=cloud.grp_start[:-1].contiguous())):
        with pytest.raises(ValueError):
            cw._wavefront_fwd_cuda(bad, o, d, tm, cw.stream_to_i32(ids), 0, 3)


def _grad_scene(name):
    if name == "cornell":
        scene, cam = grtt.load_scene("cornell", device="cuda")
        return scene, dataclasses.replace(cam, image_width=64, aspect_ratio=1.0,
                                          samples_per_pixel=4)
    # checker floor, lambertian spheres, quad light, fog box, sky gradient
    b = grtt.SceneBuilder()
    b.plane((0, 0, 0), (0, 1, 0),
            b.lambertian(b.checker(0.7, (0.2, 0.3, 0.1), (0.9, 0.9, 0.8))))
    b.sphere((0, 1, -1), 0.8, b.lambertian((0.2, 0.5, 0.8)))
    b.sphere((-1.8, 0.8, 0), 0.7, b.lambertian((0.7, 0.2, 0.2)))
    b.add_light(b.quad((-1, 4, -1), (2, 0, 0), (0, 0, 2),
                       b.diffuse_light((120, 112, 104))))
    b.volume_box((-3, 0, -3), (3, 3, 3), 0.05, (0.8, 0.9, 1.0))
    cam = tcamera.Camera(image_width=64, aspect_ratio=1.0, samples_per_pixel=4,
                         max_depth=4, look_from=(0, 2, 5), look_at=(0, 0.8, 0),
                         vfov=45.0, use_sky_gradient=True)
    return b.build(device="cuda"), cam


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", ["cornell", "checker-sky"])
def test_cuda_grad_kernels_match_plain_versions(scene_name):
    """On a GPU: the stash-writing forward and the reverse sweep against
    their plain versions.  The forward is built without fused multiply-add
    contraction like the forward kernel, so radiance and stash agree per
    ray (fewer than 0.5 % of rays outside rtol/atol 1e-3).  The reverse
    kernel sums in float32 in a fixed tree, its plain version in float64:
    rtol 1e-4 of the largest entry, on the same stash."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene, cam = _grad_scene(scene_name)
    assert cw.grad_applicable(scene, cam.max_depth)
    n = 64 * 64 * 4
    o, d, tm, ids = _rays(cam, n, 3, "cuda")
    tb = cw.build_tables(scene)
    args = (tb, o, d, tm, cw.stream_to_i32(ids), 3, cam.max_depth,
            cw.miss_config(cam))
    before = cw.LAUNCHES_GRAD_FWD, cw.LAUNCHES_GRAD_REV
    k = cw.wavefront_grad_fwd(*args)
    torch.cuda.synchronize()
    p = cw._wavefront_grad_fwd_plain(*args)
    good = (torch.isclose(k[0], p[0], rtol=1e-3, atol=1e-3).all(dim=0)
            & (k[1] == p[1])
            & torch.isclose(k[2], p[2], rtol=1e-3, atol=1e-3).all(dim=0)
            & torch.isclose(k[3], p[3], rtol=1e-3, atol=1e-3).all(dim=(0, 1))
            & (k[4] == p[4]).all(dim=(0, 1)))
    assert float((~good).float().mean()) < 0.005
    f_rows, _ = cw.wavefront_fwd(*args[:-1])
    assert torch.equal(f_rows, k[0])  # one bounce loop, two instantiations

    g3 = torch.rand((3, n), device="cuda", generator=torch.Generator("cuda").manual_seed(0)) * 1e-3
    n_tex = int(scene.textures.color.shape[0])
    gk = cw.wavefront_grad_rev(k[3], k[4], g3, k[2], n_tex)
    torch.cuda.synchronize()
    assert (cw.LAUNCHES_GRAD_FWD, cw.LAUNCHES_GRAD_REV) == (before[0] + 1, before[1] + 1)
    gp = cw._wavefront_grad_rev_plain(k[3], k[4], g3, k[2], n_tex)
    assert float(gp.abs().max()) > 1e-4
    assert float((gk - gp).abs().max()) <= 1e-4 * float(gp.abs().max())
    # the same launch again gives the same bits: no atomics on device memory
    assert torch.equal(gk, cw.wavefront_grad_rev(k[3], k[4], g3, k[2], n_tex))


@pytest.mark.cuda
def test_cuda_render_grad_goes_through_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene, cam = grtt.load_scene("cornell")
    cam = dataclasses.replace(cam, image_width=32, aspect_ratio=1.0,
                              samples_per_pixel=4)
    target = grtt.render(scene, cam, seed=1) / 4 * 0.8
    stats = grtt.RenderStats()
    before = cw.LAUNCHES_GRAD_FWD, cw.LAUNCHES_GRAD_REV
    loss, grads = grtt.render_grad(scene, cam, target, seed=1, chunk=2048,
                                   stats=stats)
    assert stats.chunks == 2
    assert (cw.LAUNCHES_GRAD_FWD, cw.LAUNCHES_GRAD_REV) == (before[0] + 2, before[1] + 2)
    assert loss.is_cuda and all(g.is_cuda for g in grads.values())
    cpu_scene, _ = grtt.load_scene("cornell", device="cpu")
    ref_loss, ref = grtt.render_grad(cpu_scene, cam, target.cpu(), seed=1,
                                     chunk=2048, device="cpu")
    # same streams on both devices; an ulp flips a few rays of 4096
    assert abs(float(loss) - float(ref_loss)) < 0.02 * float(ref_loss)
    big = float(ref["color"].abs().max())
    assert float((grads["color"].cpu() - ref["color"]).abs().max()) < 0.05 * big


def _path_lengths(tb, o, d, tm, sid, seed, depth):
    """The bounces each ray enters: 1 + the forward's rays still alive after
    1, ..., depth - 1 bounces."""
    length = torch.ones_like(tm, dtype=torch.int64)
    for k in range(1, depth):
        _, flags = cw.wavefront_fwd(tb, o, d, tm, sid, seed, k)
        length += (flags & cw.FLAG_ALIVE) != 0
    return length


def _in_turns(idx, o, d, tm, ids):
    return (V3(*(c[idx].contiguous() for c in o)), V3(*(c[idx].contiguous() for c in d)),
            tm[idx].contiguous(), ids[idx].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name, n, order", [
    ("cornell", 16384, "render"), ("cornell", 16384, "lengths-in-turn"), ("cornell", 33, "render"),
    ("cornell-smoke", 4097, "lengths-in-turn"), ("checker-sky", 16384, "lengths-in-turn"),
    ("marble", 4096, "lengths-in-turn")])
def test_cuda_grad_forward_bit_for_bit(scene_name, n, order):
    """On a GPU: the product-chain gradient forward (B2) against its plain
    version bit for bit: radiance, flags, miss colour and every float and
    int stash row (the inert rows of the bounces a ray never entered among
    them).  In the render's order and with the rays in turns of path length
    (the lanes of a warp end at every bounce), at a ray count off a block's,
    in the Cornell box (a box of fog), cornell-smoke (two), the checker and
    sky scene (fog, firefly clamp) and a marble scene (marble winners take
    the null slot)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    if scene_name == "marble":
        scene = build_marble(grtt, device="cuda")
        cam = dataclasses.replace(tcamera.Camera(**MARBLE_CAM), image_width=64, max_depth=5)
    elif scene_name == "cornell-smoke":
        scene, cam = grtt.load_scene("cornell-smoke", device="cuda")
        cam = dataclasses.replace(cam, image_width=64, aspect_ratio=1.0, samples_per_pixel=4,
                                  max_depth=5)
    else:
        scene, cam = _grad_scene(scene_name)
    assert cw.grad_applicable(scene, cam.max_depth)
    depth = cam.max_depth
    tb = cw.build_tables(scene)
    o, d, tm, ids = _rays(cam, n, 5, "cuda")
    if order == "lengths-in-turn":
        length = _path_lengths(tb, o, d, tm, cw.stream_to_i32(ids), 5, depth)
        o, d, tm, ids = _in_turns(lengths_in_turn(length, depth), o, d, tm, ids)
    args = (tb, o, d, tm, cw.stream_to_i32(ids), 5, depth, cw.miss_config(cam))
    k = cw.wavefront_grad_fwd(*args)
    torch.cuda.synchronize()
    p = cw._wavefront_grad_fwd_plain(*args)
    for a, b in zip(k, p):
        assert a.shape == b.shape and torch.equal(a, b)
    if order == "lengths-in-turn":
        first = _path_lengths(*args[:6], depth)[:32]
        assert int(first.min()) == 1 and int(first.max()) == depth


@pytest.mark.cuda
def test_cuda_grad_wrappers_reject_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    r, depth = 64, 3
    sf = torch.zeros((depth, 12, r), device="cuda")
    si = torch.zeros((depth, 3, r), dtype=torch.int32, device="cuda")
    g3 = torch.zeros((3, r), device="cuda")
    with pytest.raises(ValueError):
        cw.wavefront_grad_rev(sf, si, g3, g3, cw.GRAD_MAX_TEX + 1)
    with pytest.raises(ValueError):
        cw.wavefront_grad_rev(sf, si.long(), g3, g3, 4)
    with pytest.raises(ValueError):
        cw.wavefront_grad_rev(sf, si, g3[:, ::2], g3, 4)


def _pathwise_scene(name):
    if name == "cornell-glossy":
        scene, cam = grtt.load_scene("cornell-glossy", device="cuda")
        return scene, dataclasses.replace(cam, image_width=64, aspect_ratio=1.0,
                                          samples_per_pixel=4, max_depth=5)
    if name == "noise-glossy":
        # a marble floor seen directly and through metal and glass
        return build_noise_glossy(grtt, device="cuda"), dataclasses.replace(
            tcamera.Camera(**NOISE_GLOSSY_CAM), image_width=64, max_depth=5)
    # checker plane, metal, glass, a moving sphere, quad light, fog box
    return build_mixed(grtt, device="cuda"), dataclasses.replace(
        tcamera.Camera(**MIXED_CAM), image_width=64, use_sky_gradient=True)


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", ["cornell-glossy", "mixed-sky", "noise-glossy"])
def test_cuda_pathwise_kernels_match_plain_versions(scene_name):
    """On a GPU: the pathwise stash-writing forward and the pathwise reverse
    sweep against their plain versions.  The forward agrees per ray (fewer
    than 0.5 % of rays outside rtol/atol 1e-3) and its radiance is the
    forward kernel's bit for bit; without marble every output is the plain
    version's bit for bit.  The reverse kernel sums in float32 in a
    fixed tree, its plain version in float64: each key within 1e-4 of its
    largest entry, on the same stash, and the same bits on every launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene, cam = _pathwise_scene(scene_name)
    assert cw.grad_pathwise_applicable(scene, cam.max_depth)
    assert not cw.grad_applicable(scene, cam.max_depth)
    n = 64 * 64 * 4
    o, d, tm, ids = _rays(cam, n, 3, "cuda")
    sid = cw.stream_to_i32(ids)
    tb = cw.build_tables(scene)
    args = (tb, o, d, tm, sid, 3, cam.max_depth, cw.miss_config(cam))
    before = (cw.LAUNCHES_GRAD_FWD_PATHWISE, cw.LAUNCHES_GRAD_REV_PATHWISE,
              cw.LAUNCHES_GRAD_FWD, cw.LAUNCHES_GRAD_REV)
    k = cw.wavefront_grad_fwd(*args, pathwise=True)
    torch.cuda.synchronize()
    p = cw._wavefront_grad_fwd_plain(*args, pathwise=True)
    assert k[3].shape == (cam.max_depth, cw.pathwise_stash_rows(tb), n)
    # a marble scene stashes the winner's scale (row 19) and marks the row
    marble = bool((k[4][:, 2] & cw.PW_MARBLE).any())
    assert marble == scene.has_noise == (k[3].shape[1] == cw.PW_STASH_F_ROWS_MARBLE)
    good = (torch.isclose(k[0], p[0], rtol=1e-3, atol=1e-3).all(dim=0)
            & (k[1] == p[1])
            & torch.isclose(k[2], p[2], rtol=1e-3, atol=1e-3).all(dim=0)
            & torch.isclose(k[3], p[3], rtol=1e-3, atol=1e-3).all(dim=(0, 1))
            & (k[4] == p[4]).all(dim=(0, 1)))
    assert float((~good).float().mean()) < 0.005
    if not marble:   # B5a <2>: the plain version's bits
        for a, b in zip(k, p):
            assert torch.equal(a, b)
    f_rows, _ = cw.wavefront_fwd(*args[:-1])
    assert torch.equal(f_rows, k[0])  # one bounce loop, three instantiations

    g3 = torch.rand((3, n), device="cuda", generator=torch.Generator("cuda").manual_seed(0)) * 1e-3
    n_tex = int(scene.textures.color.shape[0])
    n_mat = int(scene.materials.kind.shape[0])
    rev_args = (tb, k[3], k[4], g3, k[2], sid, 3, bool(cam.use_sky_gradient),
                n_tex, n_mat)
    gk = cw.wavefront_grad_rev_pathwise(*rev_args)
    torch.cuda.synchronize()
    # CUDA tensors launch the pathwise kernels and nothing else
    assert (cw.LAUNCHES_GRAD_FWD_PATHWISE, cw.LAUNCHES_GRAD_REV_PATHWISE,
            cw.LAUNCHES_GRAD_FWD, cw.LAUNCHES_GRAD_REV) == (
                before[0] + 1, before[1] + 1, before[2], before[3])
    gp = cw._wavefront_grad_rev_pathwise_plain(*rev_args)
    for a, b in zip(gk, gp):
        assert torch.isfinite(a).all() and float(b.abs().max()) > 1e-5
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    kinds = scene.materials.kind
    assert bool((gk[1][kinds != 1] == 0).all()) and bool((gk[2][kinds != 2] == 0).all())
    # the same launch again gives the same bits: no atomics on device memory
    for a, b in zip(gk, cw.wavefront_grad_rev_pathwise(*rev_args)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n, depth, order", [
    (1, 5, "render"), (33, 5, "render"), (4097, 3, "shuffled"), (16384, 1, "render"),
    (16384, 5, "render"), (16384, 5, "shuffled")])
def test_cuda_pathwise_forward_compacts_paths_bit_for_bit(n, depth, order):
    """On a GPU: the pathwise gradient forward without marble (B5a <2>) runs
    tiles of 128 rays a bounce at a time, moving the rays still alive to a
    block's first slots after each bounce and writing each bounce's stash
    rows from shared memory.  On cornell-glossy, whose paths end at 1 to
    ``depth`` bounces (out through the open front, at the light, metal
    scattered under its surface), in the render's order and shuffled (the
    lanes of a warp end at different bounces) and at ray counts off the
    tile's 128: the radiance, flags, miss colour and every float and int
    stash row (the inert rows of the bounces a ray never entered among them)
    equal the plain version's bit for bit, and the paths did end at
    different bounces."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene, cam = _pathwise_scene("cornell-glossy")
    o, d, tm, ids = _rays(dataclasses.replace(cam, max_depth=depth), n, 5, "cuda")
    if order == "shuffled":
        perm = torch.randperm(n, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
        o, d = (V3(*(c[perm].contiguous() for c in v)) for v in (o, d))
        tm, ids = tm[perm].contiguous(), ids[perm].contiguous()
    args = (cw.build_tables(scene), o, d, tm, cw.stream_to_i32(ids), 5, depth,
            cw.miss_config(cam))
    k = cw.wavefront_grad_fwd(*args, pathwise=True)
    torch.cuda.synchronize()
    p = cw._wavefront_grad_fwd_plain(*args, pathwise=True)
    for a, b in zip(k, p):
        assert a.shape == b.shape and torch.equal(a, b)
    entered = ((k[4][:, 2] & (cw.PW_HIT | cw.PW_LIT)) != 0).sum(dim=0)
    if n > 1000 and depth > 1:
        assert entered.unique().numel() == depth


@pytest.mark.cuda
@pytest.mark.parametrize("n_spheres", [200, 330])
def test_cuda_pathwise_forward_with_tables_beside_its_rows(n_spheres):
    """On a GPU: B5a <2> keeps a scene's tables in shared memory beside its
    rows of a bounce only while both fit the 48 KB a block gets unasked (200
    spheres: 18 KB of tables); past that (330 spheres: 30 KB) the tables stay
    in device memory.  Either way every output equals the plain version's
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene = build_sphere_cloud(grtt, n_spheres=n_spheres, device="cuda")
    assert cw.grad_pathwise_applicable(scene, 5)
    tb = cw.build_tables(scene)
    table_bytes = 4 * sum(t.numel() for t in (tb.pt, tb.st, tb.vt, tb.lt))
    rows_bytes = (cw.PW_STASH_F_ROWS + cw.PW_STASH_I_ROWS + 16) * 128 * 4 + 16
    assert (table_bytes + rows_bytes <= 48 * 1024) == (n_spheres == 200)
    cam = tcamera.Camera(image_width=64, aspect_ratio=1.0, samples_per_pixel=4, max_depth=5,
                         look_from=(0, 6, 12), look_at=(0, 0.5, 0), vfov=45.0)
    o, d, tm, ids = _rays(cam, 64 * 64 * 4, 6, "cuda")
    args = (tb, o, d, tm, cw.stream_to_i32(ids), 6, 5, cw.miss_config(cam))
    k = cw.wavefront_grad_fwd(*args, pathwise=True)
    torch.cuda.synchronize()
    p = cw._wavefront_grad_fwd_plain(*args, pathwise=True)
    for a, b in zip(k, p):
        assert a.shape == b.shape and torch.equal(a, b)
    assert bool((k[4][:, 2] & cw.PW_METAL).any()) and bool((k[4][:, 2] & cw.PW_DIELECTRIC).any())


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name, miss_mode, lane_sums", [
    ("cornell-glossy", cw.MISS_FLAT, True), ("mixed-sky", cw.MISS_SKY, True),
    ("hdri", cw.MISS_STREAM, True), ("many-textures", cw.MISS_SKY, False)])
def test_cuda_pathwise_reverse_tiles_on_lanes_ending_at_every_depth(scene_name, miss_mode,
                                                                    lane_sums):
    """On a GPU: the pathwise reverse sweep without marble (B5b <19>) sorts
    each tile of 128 rays by path length and sums a column of accumulators a
    lane where they fit (else a row a warp).  On rays in turns of path
    length (the lanes of every warp end at every depth, so the sort has
    work), with the flat background, the sky and an environment's miss rows
    (the cotangent of the miss direction as a row), and on both routes:
    each key within 1e-4 of its plain version's largest entry, and the same
    bits on two launches.  The order itself (``lengths_in_turn``) is a
    permutation whose head takes the lengths in turns, and the plain sweep
    gives the render order's sums on it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    if scene_name == "hdri":
        scene = build_mini_hdri(grtt, device="cuda")
        cam = dataclasses.replace(tcamera.Camera(**MINI_HDRI_CAM), image_width=64)
    elif scene_name == "many-textures":
        scene = build_many_textures(grtt, device="cuda")
        cam = dataclasses.replace(tcamera.Camera(**MANY_TEXTURES_CAM), image_width=64)
    else:
        scene, cam = _pathwise_scene(scene_name)
    depth, n = cam.max_depth, 16384
    n_tex = int(scene.textures.color.shape[0])
    n_mat = int(scene.materials.kind.shape[0])
    assert cw.pathwise_rev_lane_sums(9 * n_tex + 2 * n_mat) == lane_sums
    tb = cw.build_tables(scene)
    o, d, tm, ids = _rays(cam, n, 7, "cuda")
    sid = cw.stream_to_i32(ids)
    g3 = torch.rand((3, n), device="cuda", generator=torch.Generator("cuda").manual_seed(2)) * 1e-3
    _, carry = cw.grad_fwd_stash(scene, cam, o, d, tm, sid, 7, pathwise=True)
    if miss_mode == cw.MISS_STREAM:
        mc, lmd, _ = cw._env_miss_terms(scene, cam, carry[3], g3, want_lmd=True)
    else:
        mc, lmd = carry[0], None
        assert int(cw.miss_config(cam)[0]) == miss_mode
    sf, si = carry[1], carry[2]
    length = ((si[:, 2] & (cw.PW_HIT | cw.PW_LIT)) != 0).sum(dim=0)
    idx = lengths_in_turn(length, depth)
    assert torch.equal(torch.sort(idx).values, torch.arange(n, device=idx.device))
    assert length[idx[:2 * depth]].tolist() == list(range(1, depth + 1)) * 2
    assert int(length[idx[:32]].min()) == 1 and int(length[idx[:32]].max()) == depth
    rev = (tb, sf[:, :, idx].contiguous(), si[:, :, idx].contiguous(), g3[:, idx].contiguous(),
           mc[:, idx].contiguous(), sid[idx].contiguous(), 7, miss_mode, n_tex, n_mat,
           None if lmd is None else lmd[:, idx].contiguous())
    before = cw.LAUNCHES_GRAD_REV_PATHWISE
    gk, gk2 = cw.wavefront_grad_rev_pathwise(*rev), cw.wavefront_grad_rev_pathwise(*rev)
    assert cw.LAUNCHES_GRAD_REV_PATHWISE == before + 2
    gp = cw._wavefront_grad_rev_pathwise_plain(*rev)
    in_order = cw._wavefront_grad_rev_pathwise_plain(tb, sf, si, g3, mc, sid, 7, miss_mode,
                                                     n_tex, n_mat, lmd)
    for a, a2, b, c in zip(gk, gk2, gp, in_order):
        assert torch.equal(a, a2)
        assert torch.isfinite(a).all() and float(b.abs().max()) > 1e-5
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
        assert float((b - c).abs().max()) <= 1e-6 * float(c.abs().max())


@pytest.mark.cuda
def test_cuda_render_grad_goes_through_the_pathwise_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene, cam = grtt.load_scene("cornell-glossy")
    cam = dataclasses.replace(cam, image_width=32, aspect_ratio=1.0,
                              samples_per_pixel=4)
    target = grtt.render(scene, cam, seed=1) / 4 * 0.8
    stats = grtt.RenderStats()
    before = (cw.LAUNCHES_GRAD_FWD_PATHWISE, cw.LAUNCHES_GRAD_REV_PATHWISE,
              cw.LAUNCHES_GRAD_FWD, cw.LAUNCHES_GRAD_REV)
    loss, grads = grtt.render_grad(scene, cam, target, seed=1, chunk=2048,
                                   stats=stats)
    assert stats.chunks == 2
    assert (cw.LAUNCHES_GRAD_FWD_PATHWISE, cw.LAUNCHES_GRAD_REV_PATHWISE,
            cw.LAUNCHES_GRAD_FWD, cw.LAUNCHES_GRAD_REV) == (
                before[0] + 2, before[1] + 2, before[2], before[3])
    assert loss.is_cuda and all(g.is_cuda for g in grads.values())
    cpu_scene, _ = grtt.load_scene("cornell-glossy", device="cpu")
    ref_loss, ref = grtt.render_grad(cpu_scene, cam, target.cpu(), seed=1,
                                     chunk=2048, device="cpu")
    # same streams on both devices; an ulp flips a few rays of 4096
    assert abs(float(loss) - float(ref_loss)) < 0.02 * float(ref_loss)
    for key in ("color", "fuzz", "ior"):
        big = float(ref[key].abs().max())
        assert big > 0
        assert float((grads[key].cpu() - ref[key]).abs().max()) < 0.05 * big, key


@pytest.mark.cuda
def test_cuda_pathwise_wrappers_reject_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene = build_mixed(grtt, device="cuda")
    tb = cw.build_tables(scene)
    r, depth = 64, 3
    sf = torch.zeros((depth, cw.PW_STASH_F_ROWS, r), device="cuda")
    si = torch.zeros((depth, 3, r), dtype=torch.int32, device="cuda")
    g3 = torch.zeros((3, r), device="cuda")
    sid = torch.zeros(r, dtype=torch.int32, device="cuda")
    ok = cw.wavefront_grad_rev_pathwise(tb, sf, si, g3, g3, sid, 0, False, 7, 7)
    assert all(float(t.abs().max()) == 0.0 for t in ok)   # inert rows add nothing
    with pytest.raises(ValueError):     # a product-chain stash
        cw.wavefront_grad_rev_pathwise(tb, sf[:, :12].contiguous(), si, g3, g3,
                                       sid, 0, False, 7, 7)
    with pytest.raises(ValueError):     # over the accumulator
        cw.wavefront_grad_rev_pathwise(tb, sf, si, g3, g3, sid, 0, False, 170, 8)
    with pytest.raises(ValueError):
        cw.wavefront_grad_rev_pathwise(tb, sf, si, g3, g3, sid.cpu(), 0, False, 7, 7)


@pytest.mark.cuda
@pytest.mark.parametrize("t_max_kind", ["big", "halved", "minus-one-on-a-third"])
def test_cuda_intersect_kernels_match_plain_versions(t_max_kind):
    """On a GPU: the four closest-hit kernels against their plain versions,
    on 200 spheres (three in ten moving; two tiles of the kernel's staging)
    and all four planar kinds, with a checker texture (n_attr 17 and 19).
    Built without fused multiply-add contraction, a kernel repeats its plain
    version's rounding: hit, index, t and every attribute row are equal on
    every ray."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene = build_random_prims(grtt, n_spheres=200, device="cuda")
    assert scene.has_checker
    o, d, tm = (torch.from_numpy(a).cuda() for a in random_rays(20000, 5))
    o, d = V3.from_rows(o), V3.from_rows(d)
    big = torch.full_like(tm, ck.BIG)
    sgeo, pgeo = ck.sphere_table(scene.spheres), ck.planar_table(scene.planar)
    scon = ck._material_consts(scene.materials, scene.textures, scene.spheres.mat)
    pcon = ck._material_consts(scene.materials, scene.textures, scene.planar.mat)

    def t_max_for(t, hit):
        if t_max_kind == "big":
            return big
        if t_max_kind == "halved":
            return torch.where(hit, t * 0.5, big)
        third = torch.arange(t.shape[0], device="cuda") % 3 == 0
        return torch.where(third, -1.0, big)

    before = (ck.LAUNCHES_PLANAR, ck.LAUNCHES_SPHERE, ck.LAUNCHES_PLANAR_ATTRS,
              ck.LAUNCHES_SPHERE_ATTRS)
    t0, _, h0 = ck.sphere_closest_table(sgeo, o, d, tm, big)
    t1, _, h1 = ck.planar_closest_table(pgeo, o, d, big)
    ts, tp = t_max_for(t0, h0), t_max_for(t1, h1)
    cases = [
        (ck.sphere_closest_table(sgeo, o, d, tm, ts),
         ck._sphere_closest_plain(sgeo, list(o), list(d), tm, ts, 1e-3)),
        (ck.planar_closest_table(pgeo, o, d, tp),
         ck._planar_closest_plain(pgeo, list(o), list(d), tp, 1e-3)),
        (ck.sphere_closest_attrs_table(sgeo, scon, o, d, tm, ts, n_attr=17),
         ck._sphere_closest_attrs_plain(sgeo, scon, list(o), list(d), tm, ts, 1e-3, 17)),
        (ck.planar_closest_attrs_table(pgeo, pcon, o, d, tp, n_attr=19),
         ck._planar_closest_attrs_plain(pgeo, pcon, list(o), list(d), tp, 1e-3, 19)),
    ]
    torch.cuda.synchronize()
    assert (ck.LAUNCHES_PLANAR, ck.LAUNCHES_SPHERE, ck.LAUNCHES_PLANAR_ATTRS,
            ck.LAUNCHES_SPHERE_ATTRS) == (before[0] + 2, before[1] + 2,
                                          before[2] + 1, before[3] + 1)
    for k, p in cases:
        assert k[2].dtype == torch.bool and k[1].dtype == torch.int32
        assert 0.05 < float(k[2].float().mean()) < 0.99 or t_max_kind == "halved"
        for a, b in zip(k, p):
            assert a.shape == b.shape and torch.equal(a, b)
    if t_max_kind == "halved":
        # a ray cut at half its nearest hit's distance hits nothing
        assert not bool(cases[0][0][2][h0].any()) and not bool(cases[1][0][2][h1].any())
    if t_max_kind == "minus-one-on-a-third":
        third = torch.arange(tm.shape[0], device="cuda") % 3 == 0
        for k, _ in cases:
            assert not bool(k[2][third].any())
            assert bool((k[0][third] == ck.BIG).all()) and bool((k[1][third] == 0).all())
            if len(k) == 4:
                assert bool((k[3][:, third] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", ["mixed", "fog-room"])
def test_cuda_standard_integrator_goes_through_the_kernels(scene_name):
    """On a GPU: ``mega_mode="off"`` launches the attribute kernels for the
    hit and the closest-hit kernels for the shadow ray, ``differentiable=True``
    only the latter pair, and both give the picture the CPU gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    build, cam_fields = ((build_mixed, MIXED_CAM) if scene_name == "mixed"
                         else (build_fog_room, FOG_ROOM_CAM))
    scene = build(grtt, device="cuda")
    cam = dataclasses.replace(tcamera.Camera(**cam_fields), image_width=32)

    def counts():
        return (ck.LAUNCHES_PLANAR, ck.LAUNCHES_SPHERE,
                ck.LAUNCHES_PLANAR_ATTRS, ck.LAUNCHES_SPHERE_ATTRS)

    c0 = counts()
    fast = grtt.render_image(scene, cam, seed=2, mega_mode="off")
    c1 = counts()
    gather = grtt.render_image(scene, cam, seed=2, differentiable=True)
    c2 = counts()
    depth = cam.max_depth
    assert all(0 < b - a <= depth for a, b in zip(c0, c1))
    assert c2[2:] == c1[2:] and all(b - a in (depth, 2 * depth)
                                    for a, b in zip(c1[:2], c2[:2]))
    assert fast.is_cuda and torch.isfinite(fast).all()
    torch.testing.assert_close(fast, gather, rtol=1e-3, atol=2e-3)
    cpu = grtt.render_image(build(grtt, device="cpu"), cam, seed=2,
                            mega_mode="off", device="cpu")
    # same streams on both devices; an ulp flips a few rays of 4096
    assert float((fast.cpu() - cpu).abs().mean()) < 0.01 * float(cpu.mean())


@pytest.mark.cuda
def test_cuda_autograd_matches_render_grad():
    """On a GPU: colour gradients by ``torch.autograd`` through
    ``render(differentiable=True)`` against ``render_grad``'s product tier,
    two independent routes to the same derivative."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene, cam = grtt.load_scene("cornell")
    cam = dataclasses.replace(cam, image_width=32, aspect_ratio=1.0,
                              samples_per_pixel=4)
    target = grtt.render(scene, cam, seed=1) / 4 * 0.8
    loss_k, g_k = grtt.render_grad(scene, cam, target, seed=0)
    params = {k: v.clone().requires_grad_()
              for k, v in grtt.trainable_params(scene).items()}
    fb = grtt.render(grtt.apply_params(scene, params), cam, seed=0,
                     differentiable=True)
    assert fb.requires_grad
    loss = torch.mean((fb / 4 - target) ** 2)
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_k)) < 1e-4 * float(loss_k)
    big = float(g_k["color"].abs().max())
    assert big > 0 and all(torch.isfinite(p.grad).all() for p in params.values()
                           if p.grad is not None)
    assert float((params["color"].grad - g_k["color"]).abs().max()) < 2e-3 * big


@pytest.mark.cuda
def test_cuda_intersect_wrappers_reject_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene = build_random_prims(grtt, n_spheres=4, device="cuda")
    o, d, tm = (torch.from_numpy(a).cuda() for a in random_rays(64, 5))
    o, d = V3.from_rows(o), V3.from_rows(d)
    big = torch.full_like(tm, ck.BIG)
    pgeo = ck.planar_table(scene.planar)
    with pytest.raises(ValueError):     # a sphere table
        ck.planar_closest_table(ck.sphere_table(scene.spheres), o, d, big)
    with pytest.raises(ValueError):     # a table on the CPU
        ck.planar_closest_table(pgeo.cpu(), o, d, big)
    with pytest.raises(ValueError):     # too few rays' worth of t_max
        ck.planar_closest_table(pgeo, o, d, big[:32])
    with pytest.raises(ValueError):
        ck.planar_closest_attrs_table(
            pgeo, ck._material_consts(scene.materials, scene.textures,
                                      scene.planar.mat), o, d, big, n_attr=11)


def _planar_prims(n, seed=0):
    """``n`` planar primitives of the four kinds in turn (quad, triangle,
    circle, plane) under four materials, a checker among them; the first a
    quad in the plane y = 0, and from the ninth on every fifth an exact copy
    of an earlier one, so that rays meet equal t and the earlier must win.
    Returns (geometry table, constants table, indices that have a copy)."""
    r = np.random.default_rng(seed)
    b = grtt.SceneBuilder()
    mats = [b.lambertian((0.9, 0.5, 0.1)),
            b.lambertian(b.checker(0.7, (0.2, 0.3, 0.1), (0.9, 0.9, 0.8))),
            b.metal((0.8, 0.6, 0.2), 0.25), b.dielectric(1.5)]
    specs, copied = [("quad", ((-2, 0, -2), (4, 0, 0), (0, 0, 4)))], set()
    for i in range(1, n):
        if i >= 8 and i % 5 == 0:
            copied.add(i // 2)
            specs.append(specs[i // 2])
        elif i % 4 == 0:
            specs.append(("quad", (r.normal(size=3) * 3, r.normal(size=3) * 2,
                                   r.normal(size=3) * 2)))
        elif i % 4 == 1:
            specs.append(("triangle", tuple(r.normal(size=3) * 3 for _ in range(3))))
        elif i % 4 == 2:
            specs.append(("circle", (r.normal(size=3) * 3, r.normal(size=3),
                                     r.uniform(0.5, 2.0))))
        else:
            specs.append(("plane", (r.normal(size=3) * 6, r.normal(size=3))))
    for i, (kind, args) in enumerate(specs):
        getattr(b, kind)(*args, mats[i % 4])
    scene = b.build(device="cuda")
    return (ck.planar_table(scene.planar),
            ck._material_consts(scene.materials, scene.textures, scene.planar.mat),
            torch.tensor(sorted(copied), dtype=torch.int32, device="cuda"))


def _planar_rays(n, seed):
    """``random_rays``, every fifth origin moved into the first quad's plane
    (y = 0, inside the quad): there the numerator is exactly 0."""
    o, d, _ = random_rays(n, seed)
    r = np.random.default_rng(seed)
    o[::5] = np.stack([r.uniform(-1.5, 1.5, o[::5].shape[0]),
                       np.zeros(o[::5].shape[0]),
                       r.uniform(-1.5, 1.5, o[::5].shape[0])], axis=1)
    o, d = _cuda_rays(o, d)
    return o, d


def _planar_equal_plain(geo, con, o, d, t_max, t_min):
    """B7a and B8p (12, 19 and 20 rows) against their plain versions, every
    output bit for bit.  Returns B7a's (t, idx, hit)."""
    t_min32 = float(np.float32(t_min))
    before = (ck.LAUNCHES_PLANAR, ck.LAUNCHES_PLANAR_ATTRS)
    k = ck.planar_closest_table(geo, o, d, t_max, t_min=t_min)
    p = ck._planar_closest_plain(geo, list(o), list(d), t_max, t_min32)
    for a, b in zip(k, p):
        assert a.shape == b.shape and torch.equal(a, b)
    for n_attr in (12, 19, 20):
        ka = ck.planar_closest_attrs_table(geo, con, o, d, t_max, t_min=t_min, n_attr=n_attr)
        pa = ck._planar_closest_attrs_plain(geo, con, list(o), list(d), t_max, t_min32,
                                            n_attr)
        for a, b in zip(ka, pa):
            assert a.shape == b.shape and torch.equal(a, b)
        assert all(torch.equal(a, b) for a, b in zip(ka[:3], k))
    torch.cuda.synchronize()
    assert (ck.LAUNCHES_PLANAR, ck.LAUNCHES_PLANAR_ATTRS) == (before[0] + 1, before[1] + 3)
    return k


def _dead(n, layout):
    i = torch.arange(n, device="cuda")
    if layout == "all":
        return i >= 0
    share, how = layout.split("_")
    q = int(share) // 25
    return (i % 4) < q if how == "spread" else ((i // 1024) % 4) < q


@pytest.mark.cuda
@pytest.mark.parametrize("t_min", [1e-3, 0.0])
@pytest.mark.parametrize("n_prims", [1, 18, 128, 129, 300])
def test_cuda_planar_kernels_bit_for_bit_at_table_sizes(n_prims, t_min):
    """On a GPU: tables of one primitive, Cornell's 18, a staged tile of 128,
    one over and 300 (three tiles), all four kinds, exact copies (equal t: the
    first wins) and rays starting in a quad's plane (numerator 0: at t_min = 0
    the quad is hit at t = 0, at 1e-3 it is not); t_min 1e-3 takes the sign
    gate, 0 the route without it; t_max BIG, cut at half the nearest hit, and
    -1 on half the rays.  B7a and B8p with 12, 19 and 20 rows equal their plain
    versions on every output, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip(_NO_CARD)
    geo, con, copied = _planar_prims(n_prims, seed=n_prims)
    o, d = _planar_rays(4096, 21)
    big = torch.full((4096,), ck.BIG, device="cuda")
    t, idx, hit = _planar_equal_plain(geo, con, o, d, big, t_min)
    assert bool(hit.any())
    on_plane = torch.arange(4096, device="cuda") % 5 == 0
    at_zero = hit & (t == 0.0) & (idx == 0)
    assert bool(at_zero[on_plane].any()) == (t_min == 0.0)
    if n_prims >= 18:
        assert bool(torch.isin(idx[hit], copied).any())
    _planar_equal_plain(geo, con, o, d, torch.where(hit, t * 0.5, big), t_min)
    _planar_equal_plain(geo, con, o, d, torch.where(_dead(4096, "50_spread"), -1.0, big),
                        t_min)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["all", "25_spread", "50_spread", "75_spread",
                                    "25_runs", "50_runs", "75_runs"])
def test_cuda_planar_kernels_bit_for_bit_on_dead_lanes(layout):
    """On a GPU: t_max = -1 on every ray, and on 25, 50 and 75 % of them spread
    evenly and in contiguous runs of 1,024 (the live rays a block moves to its
    first slots), on Cornell's 18 primitives, at both t_min: every output the
    plain version's bits, and a dead ray a miss."""
    if not torch.cuda.is_available():
        pytest.skip(_NO_CARD)
    geo, con, _ = _planar_prims(18, seed=3)
    o, d = _planar_rays(8192, 22)
    dead = _dead(8192, layout)
    t_max = torch.where(dead, -1.0, torch.full((8192,), ck.BIG, device="cuda"))
    for t_min in (1e-3, 0.0):
        t, idx, hit = _planar_equal_plain(geo, con, o, d, t_max, t_min)
        assert not bool(hit[dead].any()) and bool((t[dead] == ck.BIG).all())
        assert bool((idx[dead] == 0).all()) and (layout == "all" or bool(hit.any()))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 255, 257, 1000])
def test_cuda_planar_kernels_at_ragged_ray_counts(n):
    """On a GPU: ray counts that do not fill a warp or a block's run of 256
    rays, with every third ray dead: both planar kernels equal their plain
    versions on every output."""
    if not torch.cuda.is_available():
        pytest.skip(_NO_CARD)
    geo, con, _ = _planar_prims(18, seed=4)
    o, d = _planar_rays(n, 23)
    big = torch.full((n,), ck.BIG, device="cuda")
    third = torch.arange(n, device="cuda") % 3 == 1
    for t_min in (1e-3, 0.0):
        _planar_equal_plain(geo, con, o, d, big, t_min)
        _planar_equal_plain(geo, con, o, d, torch.where(third, -1.0, big), t_min)


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kernel", ["sweep", "stream"])
def test_cuda_mesh_kernels_match_plain_versions(kernel, any_hit):
    """On a GPU: ``mesh_sweep`` on the 3,744-triangle statue and
    ``mesh_stream`` on a 17,440-triangle one, 10 instances each, against
    their plain versions on 16,384 rays, for t_max BIG, cut at a random
    share of the hit distance, and -1 on every third ray.  Built without
    fused multiply-add contraction, a kernel repeats its plain version's
    rounding: hit, t, tri and inst are equal on every ray (in any-hit mode
    only hit means anything)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    detail = (48, 40) if kernel == "sweep" else (80, 110)
    proto = mesh_bvh.build_proto(*tobj.lucy_standin(*detail), lucy_instances(10),
                                 torch.device("cuda"))
    assert cm.kernel_ok(proto) == (kernel == "sweep") != cm.stream_ok(proto)
    fn = cm.intersect_mesh_kernel if kernel == "sweep" else cm.intersect_mesh_stream
    o, d = (V3.from_rows(torch.from_numpy(a).cuda()) for a in mesh_rays(16384, 4))
    big = torch.full((16384,), ck.BIG, device="cuda")
    t0, _, _, h0, _ = fn(proto, o, d, 1e-3, big)
    scale = torch.rand(16384, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    third = torch.arange(16384, device="cuda") % 3 == 0
    for t_max in (big, torch.where(h0, t0 * (0.5 + scale), big),
                  torch.where(third, -1.0, big)):
        before = cm.LAUNCHES_SWEEP, cm.LAUNCHES_STREAM
        k = fn(proto, o, d, 1e-3, t_max, any_hit=any_hit)
        torch.cuda.synchronize()
        after = cm.LAUNCHES_SWEEP, cm.LAUNCHES_STREAM
        assert after[0 if kernel == "sweep" else 1] == before[0 if kernel == "sweep" else 1] + 1
        p = cm.plain(kernel, proto, o, d, 1e-3, t_max, any_hit=any_hit)
        assert k[4] == 0 and k[3].dtype == torch.bool
        assert torch.equal(k[3], p[3])
        assert 0.05 < float(k[3].float().mean()) < 0.95
        if not any_hit:
            for a, b in zip(k[:3], p[:3]):
                assert torch.equal(a, b)
    assert not bool(k[3][third].any())


# ---- the edges of mesh_stream's warp-wide tile sweep and of the sphere sweep's
# rays blocked in registers: each case equals the plain version bit for bit ----

_NO_CARD = "needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode"


@functools.lru_cache(maxsize=None)
def _stream_proto():
    """The 17,440-triangle statue, 10 instances: mesh_stream's tables."""
    proto = mesh_bvh.build_proto(*tobj.lucy_standin(80, 110), lucy_instances(10),
                                 torch.device("cuda"))
    assert cm.stream_ok(proto)
    return proto


def _stream_equals_plain(proto, o, d, t_max, any_hit=False):
    """mesh_stream against its plain version: hit, and (closest hit) the bits
    of t, tri and inst, on every ray.  Returns the kernel's outputs."""
    k = cm.intersect_mesh_stream(proto, o, d, 1e-3, t_max, any_hit=any_hit)
    torch.cuda.synchronize()
    p = cm.plain("stream", proto, o, d, 1e-3, t_max, any_hit=any_hit)
    assert torch.equal(k[3], p[3])
    if not any_hit:
        assert torch.equal(k[0].view(torch.int32), p[0].view(torch.int32))
        assert torch.equal(k[1], p[1]) and torch.equal(k[2], p[2])
    return k


def _spheres_equal_plain(scene, o, d, tm, t_max):
    """Both sphere kernels (alone, and with the winner's attributes) against
    their plain versions: hit, index, the bits of t and every attribute row.
    Returns the attribute kernel's outputs."""
    sgeo = ck.sphere_table(scene.spheres)
    scon = ck._material_consts(scene.materials, scene.textures, scene.spheres.mat)
    n_attr = ck.SPHERE_ATTRS + (ck.CHECKER_EXTRA if scene.has_checker else 0)
    ol, dl = list(o), list(d)
    pairs = [(ck.sphere_closest_table(sgeo, o, d, tm, t_max),
              ck._sphere_closest_plain(sgeo, ol, dl, tm, t_max, 1e-3)),
             (ck.sphere_closest_attrs_table(sgeo, scon, o, d, tm, t_max, n_attr=n_attr),
              ck._sphere_closest_attrs_plain(sgeo, scon, ol, dl, tm, t_max, 1e-3, n_attr))]
    torch.cuda.synchronize()
    for k, p in pairs:
        assert torch.equal(k[0].view(torch.int32), p[0].view(torch.int32))
        for a, b in zip(k[1:], p[1:]):
            assert a.shape == b.shape and torch.equal(a, b)
    return pairs[1][0]


def _cuda_rays(o, d, *rest):
    return (V3.from_rows(torch.from_numpy(o).cuda()), V3.from_rows(torch.from_numpy(d).cuda()),
            *(torch.from_numpy(a).cuda() for a in rest))


def _sweep_equals_plain(proto, o, d, t_max, any_hit=False):
    """mesh_sweep against its plain version: hit and the bits of t, tri and
    inst on every ray (any hit too: the first hit in the ladder's order).
    Returns the kernel's outputs."""
    k = cm.intersect_mesh_kernel(proto, o, d, 1e-3, t_max, any_hit=any_hit)
    torch.cuda.synchronize()
    p = cm.plain("sweep", proto, o, d, 1e-3, t_max, any_hit=any_hit)
    assert torch.equal(k[3], p[3])
    assert torch.equal(k[0].view(torch.int32), p[0].view(torch.int32))
    assert torch.equal(k[1], p[1]) and torch.equal(k[2], p[2])
    return k


def _floor(g):
    """A g x g grid of unit quads on y = 0, two triangles each (a diagonal
    edge shared): (vertices, triangles)."""
    xs, zs = np.meshgrid(np.arange(g + 1, dtype=np.float64), np.arange(g + 1, dtype=np.float64),
                         indexing="ij")
    verts = np.stack([xs.ravel(), np.zeros(xs.size), zs.ravel()], 1)
    a = (np.arange(g)[:, None] * (g + 1) + np.arange(g)[None, :]).ravel()
    return verts, np.concatenate([np.stack([a, a + 1, a + g + 2], 1),
                                  np.stack([a, a + g + 2, a + g + 1], 1)])


def _at(y):
    m = np.eye(4)
    m[1, 3] = y
    return (m, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("coherent", [False, True])
def test_cuda_mesh_sweep_breaks_equal_t_ties_by_instance_and_leaf_order(coherent):
    """On a GPU: a floor of 7,200 triangles in two instances at the same
    place and a third below, so every hit is a tie at equal t between two
    instances, and half the rays aimed at the diagonal edge two coplanar
    triangles of a quad share: the earlier instance and, at equal t, the
    first triangle in leaf order win, as in the plain version, closest and
    any hit.  Coherent: each warp's rays aimed at one small patch (the warp
    walks a tile one lane a ray); else scattered (the warp tests its rays'
    leaves in pairs)."""
    if not torch.cuda.is_available():
        pytest.skip(_NO_CARD)
    g = 60
    proto = mesh_bvh.build_proto(*_floor(g), [_at(-1.0), _at(0.0), _at(0.0)],
                                 torch.device("cuda"))
    assert cm.kernel_ok(proto) and proto.n_tris == 2 * g * g
    r = np.random.default_rng(11)
    n = 4096
    if coherent:
        centre = np.repeat(r.uniform(6, g - 6, size=(n // 32, 2)), 32, axis=0)
        xz = centre + r.normal(size=(n, 2)) * 0.7
    else:
        xz = r.uniform(4, g - 4, size=(n, 2))
    # every other ray through the shared diagonal of its quad
    diag = np.arange(n) % 2 == 0
    xz[diag, 1] = np.floor(xz[diag, 1]) + (xz[diag, 0] - np.floor(xz[diag, 0]))
    o = np.stack([xz[:, 0], np.full(n, 10.0), xz[:, 1]], 1) + r.normal(size=(n, 3)) * [2, 0, 2]
    d = np.stack([xz[:, 0], np.zeros(n), xz[:, 1]], 1) - o
    o, d = _cuda_rays(o.astype(np.float32), d.astype(np.float32))
    big = torch.full((n,), ck.BIG, device="cuda")
    k = _sweep_equals_plain(proto, o, d, big)
    _sweep_equals_plain(proto, o, d, big, any_hit=True)
    # instance 2 repeats instance 1's arithmetic: it never wins the tie (a
    # ray through a shared edge may miss both in float32 and hit instance 0,
    # and the plain version says so too)
    assert float(k[3].float().mean()) > 0.99 and not bool((k[2][k[3]] == 2).any())
    assert float((k[2][k[3]] == 1).float().mean()) > 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 4097])
def test_cuda_mesh_sweep_mixed_warps_and_ragged_counts(n):
    """On a GPU: the 3,744-triangle statue, 10 instances, unsorted rays
    (lanes of a warp in different instances and leaves), sorted as the
    integrator sorts them, and with every third ray dead, at ray counts off
    the warp's 32: closest and any hit equal the plain version's bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip(_NO_CARD)
    proto = mesh_bvh.build_proto(*tobj.lucy_standin(48, 40), lucy_instances(10),
                                 torch.device("cuda"))
    o, d = _cuda_rays(*mesh_rays(n, 12))
    big = torch.full((n,), ck.BIG, device="cuda")
    dead = torch.where(torch.arange(n, device="cuda") % 3 == 0, -1.0, big)
    key = wavefront._mesh_sort_key(proto, o, d, 1e-3, big)[1]
    order = torch.argsort(key, stable=True)
    so, sd = (V3(*(c[order].contiguous() for c in v)) for v in (o, d))
    for rays in ((o, d), (so, sd)):
        for t_max in (big, dead):
            for any_hit in (False, True):
                _sweep_equals_plain(proto, *rays, t_max, any_hit)


@pytest.mark.cuda
def test_cuda_mesh_sweep_at_the_top_of_its_range():
    """On a GPU: a floor of 16,200 triangles, near the sweep's 16,384, in two
    instances: 8 coarse segments, whose boxes and the warps' scratch take a
    block past the 48 KB of shared memory it gets unasked.  Closest and any
    hit equal the plain version's bit for bit on scattered rays and on rays
    in coherent warps."""
    if not torch.cuda.is_available():
        pytest.skip(_NO_CARD)
    g = 90
    proto = mesh_bvh.build_proto(*_floor(g), [_at(0.0), _at(-1.0)], torch.device("cuda"))
    assert cm.kernel_ok(proto) and proto.n_tris == 2 * g * g and proto.k_n_coarse == 8
    assert cm.sweep_occupancy(proto)[2] > 48 * 1024
    r = np.random.default_rng(13)
    n = 4096
    centre = np.repeat(r.uniform(5, g - 5, size=(n // 64, 2)), 32, axis=0)
    xz = np.concatenate([centre + r.normal(size=(n // 2, 2)) * 0.7,
                         r.uniform(2, g - 2, size=(n // 2, 2))])
    o = np.stack([xz[:, 0], np.full(n, 8.0), xz[:, 1]], 1) + r.normal(size=(n, 3)) * [3, 0, 3]
    d = np.stack([xz[:, 0], np.zeros(n), xz[:, 1]], 1) - o
    o, d = _cuda_rays(o.astype(np.float32), d.astype(np.float32))
    big = torch.full((n,), ck.BIG, device="cuda")
    k = _sweep_equals_plain(proto, o, d, big)
    _sweep_equals_plain(proto, o, d, big, any_hit=True)
    assert float(k[3].float().mean()) > 0.99


@pytest.mark.cuda
def test_cuda_mesh_stream_warp_over_disjoint_slots_and_instances():
    """On a GPU: unsorted rays, lane j of every warp aimed at statue j % 10
    at a height of its own, so the lanes of a warp enter different
    instances and different slots; the warp sweeps the union of their slots
    and each lane counts only its own: closest and any hit equal the plain
    version's."""
    if not torch.cuda.is_available():
        pytest.skip(_NO_CARD)
    from go_raytracing_tpu_torch.scenes.builders import LUCY_POSITIONS

    proto = _stream_proto()
    r = np.random.default_rng(7)
    n = 32 * 16
    lane = np.arange(n) % 32
    o = np.array([278.0, 278.0, -800.0]) + r.normal(size=(n, 3))
    centres = np.array([p for p, _ in LUCY_POSITIONS], np.float64)[lane % 10]
    tgt = centres + np.stack([r.normal(size=n) * 8, 20 + lane * 7.0, r.normal(size=n) * 8], 1)
    o, d = _cuda_rays(o.astype(np.float32), (tgt - o).astype(np.float32))
    big = torch.full((n,), ck.BIG, device="cuda")
    k = _stream_equals_plain(proto, o, d, big)
    _stream_equals_plain(proto, o, d, big, any_hit=True)
    first = k[2][:32][k[3][:32]]
    assert float(k[3].float().mean()) > 0.3 and first.unique().numel() >= 4


@pytest.mark.cuda
def test_cuda_mesh_stream_breaks_equal_t_ties_by_id_and_instance():
    """On a GPU: a floor of 16,900 triangles, every one of them twice (the
    same rows, two leaf-order ids), in two instances at the same place and
    a third below: every hit is a tie at equal t between two ids and two
    instances.  The lowest id and the earlier instance win, as in the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip(_NO_CARD)
    g = 65
    xs, zs = np.meshgrid(np.arange(g + 1, dtype=np.float64), np.arange(g + 1, dtype=np.float64),
                         indexing="ij")
    verts = np.stack([xs.ravel(), np.zeros(xs.size), zs.ravel()], 1)
    a = (np.arange(g)[:, None] * (g + 1) + np.arange(g)[None, :]).ravel()
    quads = np.concatenate([np.stack([a, a + 1, a + g + 2], 1), np.stack([a, a + g + 2, a + g + 1], 1)])
    tris = np.concatenate([quads, quads])
    assert len(tris) > cm.MAX_KERNEL_TRIS

    def at(y):
        m = np.eye(4)
        m[1, 3] = y
        return (m, 0)

    proto = mesh_bvh.build_proto(verts, tris, [at(-1.0), at(0.0), at(0.0)], torch.device("cuda"))
    assert cm.stream_ok(proto)
    r = np.random.default_rng(8)
    n = 4096
    o = np.stack([r.uniform(4, g - 4, n), np.full(n, 10.0), r.uniform(4, g - 4, n)], 1)
    d = np.stack([r.normal(size=n) * 0.05, -np.ones(n), r.normal(size=n) * 0.05], 1)
    o, d = _cuda_rays(o.astype(np.float32), d.astype(np.float32))
    k = _stream_equals_plain(proto, o, d, torch.full((n,), ck.BIG, device="cuda"))
    # a ray through a shared edge may miss both triangles in float32: the
    # plain version says so too
    assert float(k[3].float().mean()) > 0.99 and bool((k[2][k[3]] == 1).all())


@pytest.mark.cuda
def test_cuda_mesh_stream_any_hit_below_the_nearest_hit():
    """On a GPU: any-hit rays whose t_max is the nearest hit's t (accepted
    t < t_max, so none is left) or its half hit nothing, and those cut at
    1.5 times it hit as the plain version says."""
    if not torch.cuda.is_available():
        pytest.skip(_NO_CARD)
    proto = _stream_proto()
    o, d = _cuda_rays(*mesh_rays(8192, 9))
    big = torch.full((8192,), ck.BIG, device="cuda")
    t0, _, _, h0, _ = cm.intersect_mesh_stream(proto, o, d, 1e-3, big)
    assert float(h0.float().mean()) > 0.3
    for scale in (1.0, 0.5, 1.5):
        k = _stream_equals_plain(proto, o, d, torch.where(h0, t0 * scale, big), any_hit=True)
        if scale <= 1.0:
            assert not bool(k[3][h0].any())


@pytest.mark.cuda
def test_cuda_mesh_stream_and_sphere_kernels_skip_dead_warps():
    """On a GPU: t_max = -1 on whole warps, on a whole block of each kernel
    and on every third ray elsewhere: those rays are written as misses (t
    BIG, ids 0, attributes 0), the others as the plain versions say."""
    if not torch.cuda.is_available():
        pytest.skip(_NO_CARD)
    n = 4096
    dead = torch.zeros(n, dtype=torch.bool, device="cuda")
    dead[0:32] = dead[96:160] = dead[1024:1536] = True
    dead[2048:] = torch.arange(n - 2048, device="cuda") % 3 == 0
    proto = _stream_proto()
    o, d = _cuda_rays(*mesh_rays(n, 10))
    t_max = torch.where(dead, -1.0, torch.full((n,), ck.BIG, device="cuda"))
    for any_hit in (False, True):
        k = _stream_equals_plain(proto, o, d, t_max, any_hit=any_hit)
        assert not bool(k[3][dead].any()) and bool(k[3][~dead].any())
        assert bool((k[0][dead] == ck.BIG).all()) and bool((k[1][dead] == 0).all())
    scene = build_random_prims(grtt, n_spheres=363, n_planar=False, device="cuda")
    so, sd, tm = _cuda_rays(*random_rays(n, 11))
    k = _spheres_equal_plain(scene, so, sd, tm, t_max)
    assert not bool(k[2][dead].any()) and bool(k[2][~dead].any())
    assert bool((k[3][:, dead] == 0).all()) and bool((k[0][dead] == ck.BIG).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 127, 129, 511, 513])
def test_cuda_mesh_stream_and_sphere_kernels_at_ragged_ray_counts(n):
    """On a GPU: ray counts that do not fill a warp, a block of mesh_stream
    (128 rays) or a block of the sphere kernels (4 rays a thread, 512):
    every ray equals the plain versions, closest and any hit."""
    if not torch.cuda.is_available():
        pytest.skip(_NO_CARD)
    o, d = _cuda_rays(*mesh_rays(n, 12))
    big = torch.full((n,), ck.BIG, device="cuda")
    _stream_equals_plain(_stream_proto(), o, d, big)
    _stream_equals_plain(_stream_proto(), o, d, big, any_hit=True)
    scene = build_random_prims(grtt, n_spheres=129, n_planar=False, device="cuda")
    _spheres_equal_plain(scene, *_cuda_rays(*random_rays(n, 13)), big)


@pytest.mark.cuda
@pytest.mark.parametrize("n_spheres", [1, 127, 128, 129, 363])
def test_cuda_sphere_kernels_at_table_edges(n_spheres):
    """On a GPU: sphere tables of one entry, one short of a staged tile of
    128, a tile, one over and ``random``'s 363 (three tiles), three in ten
    spheres moving, rays at times 0 and 1 in turn: both sphere kernels equal
    their plain versions on every ray, with t_max BIG and cut at half the
    nearest hit."""
    if not torch.cuda.is_available():
        pytest.skip(_NO_CARD)
    scene = build_random_prims(grtt, n_spheres=n_spheres, n_planar=False, seed=n_spheres,
                               device="cuda")
    o, d, tm = random_rays(2048, 14)
    tm = (np.arange(2048) % 2).astype(np.float32)
    o, d, tm = _cuda_rays(o, d, tm)
    big = torch.full_like(tm, ck.BIG)
    k = _spheres_equal_plain(scene, o, d, tm, big)
    assert bool(k[2].any())
    _spheres_equal_plain(scene, o, d, tm, torch.where(k[2], k[0] * 0.5, big))


@pytest.mark.cuda
def test_cuda_mesh_render_matches_cpu():
    """On a GPU: ``cornell-lucy`` (216 triangles, 3 instances) renders
    through ``mesh_sweep`` (closest hit and shadow rays), with no overflow,
    and gives the picture the CPU gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    cam = dataclasses.replace(tcamera.Camera(**LUCY_CAM), image_width=32,
                              samples_per_pixel=4)
    stats = grtt.RenderStats()
    before = cm.LAUNCHES_SWEEP
    img = grtt.render_image(build_lucy(grtt), cam, seed=2, stats=stats)
    assert img.is_cuda and torch.isfinite(img).all()
    assert cm.LAUNCHES_SWEEP - before >= cam.max_depth and stats.mesh_overflow == 0
    cpu = grtt.render_image(build_lucy(grtt, device="cpu"), cam, seed=2, device="cpu")
    assert float((img.cpu() - cpu).abs().mean()) < 0.01 * float(cpu.mean())


@pytest.mark.cuda
def test_cuda_mesh_wrappers_reject_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    proto = mesh_bvh.build_proto(*tobj.lucy_standin(12, 10), lucy_instances(2),
                                 torch.device("cuda"))
    o, d = (V3.from_rows(torch.from_numpy(a).cuda()) for a in mesh_rays(64))
    big = torch.full((64,), ck.BIG, device="cuda")
    with pytest.raises(ValueError):     # tables on the CPU
        cpu = dataclasses.replace(proto, k_tri=proto.k_tri.cpu())
        cm.intersect_mesh_kernel(cpu, o, d, 1e-3, big)
    with pytest.raises(ValueError):     # too few rays' worth of t_max
        cm.intersect_mesh_kernel(proto, o, d, 1e-3, big[:32])


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", ["mixed", "cornell", "random-700"])
def test_cuda_record_kernel_matches_plain_version(scene_name):
    """On a GPU: the record kernel (B6) against its plain version, and its
    radiance against the forward kernel's (B1): the same bits, and the same
    decisions on every ray-bounce (both built without fused multiply-adds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    if scene_name == "mixed":
        scene = build_mixed(grtt, device="cuda")
        cam = tcamera.Camera(**MIXED_CAM)
    elif scene_name == "cornell":
        scene, cam = grtt.load_scene("cornell", device="cuda")
    else:
        scene, cam = grtt.load_scene("random", device="cuda", grid=(-14, 14, -14, 14))
        cam = dataclasses.replace(cam, max_depth=4)
    cam = dataclasses.replace(cam, image_width=64, aspect_ratio=1.0)
    n = 64 * 64 * (1 if scene_name == "random-700" else 4)
    o, d, tm, ids = _rays(cam, n, 5, "cuda")
    tb = cw.build_tables(scene)
    args = (tb, o, d, tm, cw.stream_to_i32(ids), 5, cam.max_depth)
    before = cw.LAUNCHES_RECORD
    out, flags, code, idx = cw.wavefront_record(*args)
    torch.cuda.synchronize()
    assert cw.LAUNCHES_RECORD == before + 1
    f_out, f_flags = cw.wavefront_fwd(*args)
    assert torch.equal(out, f_out) and torch.equal(flags, f_flags)
    p_out, p_flags, p_code, p_idx = cw._wavefront_record_plain(*args)
    assert torch.equal(code, p_code) and torch.equal(idx, p_idx)
    assert float((out - p_out).abs().max()) == 0.0 and torch.equal(flags, p_flags)
    # and the standard integrator records the same outcomes, but for ties
    from go_raytracing_tpu_torch.integrator import wavefront as twf

    which, widx, blk_a, _ = cw.unpack_record(code, idx)
    _, dec = twf.trace(scene, cam, o, d, tm, ids, 5, mega_mode="off", record=True)
    for a, b in ((which, dec.which), (widx, dec.idx), (blk_a, dec.blk_a)):
        assert float((a == b).float().mean()) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("name, kernel", [
    pytest.param(name, kernel, id=name if kernel == "record" else f"{name}-{kernel}")
    for kernel in ("record", "fwd", "resume") for name in CULL_CASES])
def test_cuda_record_kernel_culled_sweep_matches_plain_version(name, kernel):
    """The culled sphere sweep (64 spheres and more; 63: the brute sweep) of
    B6 (``record``), B1 (``fwd``) and B11 (``resume``: bounces [0, 2), then
    [2, 3) of the state it left) against their plain versions, whose sweep
    is the brute one in table order: every output the same bits (B6's code
    and index bytes, radiance and flags the forward kernel's), on rays aimed
    at the segment and group boxes' corners and edges and along the axes,
    with duplicated spheres swept in either order, moving spheres, a ground
    sphere and shadow rays; at the set's ray count and at 1, 31 and 33
    rays."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    _, tb, o, d, tm, ids = cull_case(grtt, cw, name, "cuda")
    assert (tb.n_seg > 0) == (name != "63")
    sid = cw.stream_to_i32(ids)
    for n in (tm.shape[0], 1, 31, 33):
        args = (tb, V3(*(c[:n].contiguous() for c in o)), V3(*(c[:n].contiguous() for c in d)),
                tm[:n].contiguous(), sid[:n].contiguous(), 5, 3)
        if kernel == "resume":
            flat = cw._start_state(*args[1:5])
            before = cw.LAUNCHES_RESUME
            k1 = cw.wavefront_resume(tb, flat, 5, 0, 2)
            state = cw._resumed_state(flat, k1)
            k2 = cw.wavefront_resume(tb, state, 5, 2, 3)
            torch.cuda.synchronize()
            assert cw.LAUNCHES_RESUME == before + 2
            for k, p in ((k1, cw._wavefront_resume_plain(tb, flat, 5, 0, 2)),
                         (k2, cw._wavefront_resume_plain(tb, state, 5, 2, 3))):
                assert all(torch.equal(a, b) for a, b in zip(k, p))
            continue
        if kernel == "fwd":
            before = cw.LAUNCHES
            k = cw.wavefront_fwd(*args)
            torch.cuda.synchronize()
            assert cw.LAUNCHES == before + 1
            assert all(torch.equal(a, b) for a, b in zip(k, cw._wavefront_fwd_plain(*args)))
            continue
        before = cw.LAUNCHES_RECORD
        k = cw.wavefront_record(*args)
        torch.cuda.synchronize()
        assert cw.LAUNCHES_RECORD == before + 1
        for a, b in zip(k, cw._wavefront_record_plain(*args)):
            assert torch.equal(a, b)
        f_out, f_flags = cw.wavefront_fwd(*args)
        assert torch.equal(k[0], f_out) and torch.equal(k[1], f_flags)
        if n == tm.shape[0]:
            assert float(((k[2] & cw.DEC_KIND_MASK) == 1).float().mean()) > 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("depth, pattern", [(1, "warps"), (5, "warps"), (50, "warps"),
                                            (50, "ends")])
def test_cuda_pathwise_reverse_takes_the_marble_in_turns(depth, pattern):
    """B5b with marble (<20>): each bounce's dmarble/dp in turns across the
    warp, against its plain version within 1e-4 of each key's largest entry
    and the same bits on two launches, with warps of 0, 1 and 32 marble
    lanes, or marble at each ray's first and last bounce, at depth 1, 5 and
    50, on 2 x 2,048 + 37 rays (neither a multiple of 32 nor of a block's
    2,048)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene = build_noise_glossy(grtt, device="cuda")
    cam = dataclasses.replace(tcamera.Camera(**NOISE_GLOSSY_CAM), image_width=64,
                              max_depth=depth)
    n = 2 * 2048 + 37
    o, d, tm, ids = _rays(cam, n, 3, "cuda")
    sid = cw.stream_to_i32(ids)
    tb = cw.build_tables(scene)
    k = cw.wavefront_grad_fwd(tb, o, d, tm, sid, 3, depth, cw.miss_config(cam), pathwise=True)
    assert k[3].shape[1] == cw.PW_STASH_F_ROWS_MARBLE
    si = marble_lane_stash(k[4], pattern, cw.PW_MARBLE)
    lanes = ((si[0, 2] & cw.PW_MARBLE) != 0)[: n // 32 * 32].reshape(-1, 32).sum(dim=1)
    if pattern == "warps":
        assert {0, 1, 32} <= set(lanes.tolist())
    g3 = torch.rand((3, n), device="cuda", generator=torch.Generator("cuda").manual_seed(0)) * 1e-3
    rev = (tb, k[3], si, g3, k[2], sid, 3, bool(cam.use_sky_gradient),
           int(scene.textures.color.shape[0]), int(scene.materials.kind.shape[0]))
    before = cw.LAUNCHES_GRAD_REV_PATHWISE
    gk, gk2 = cw.wavefront_grad_rev_pathwise(*rev), cw.wavefront_grad_rev_pathwise(*rev)
    torch.cuda.synchronize()
    assert cw.LAUNCHES_GRAD_REV_PATHWISE == before + 2
    gp = cw._wavefront_grad_rev_pathwise_plain(*rev)
    assert float(gp[0].abs().max()) > 0.0
    for a, b, c in zip(gk, gk2, gp):
        assert torch.equal(a, b)
        assert float((a - c).abs().max()) <= 1e-4 * max(float(c.abs().max()), 1e-30)


@pytest.mark.cuda
def test_cuda_gradients_have_the_same_bits_every_run():
    """C7 on a GPU: two ``torch.autograd`` backward passes, and two replay
    ``render_grad`` calls, give identical bits; the row-sum kernel equals
    its plain version to float32 rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    from go_raytracing_tpu_torch.ops import cuda_rows

    scene, cam = grtt.load_scene("cornell")
    cam = dataclasses.replace(cam, image_width=32, aspect_ratio=1.0,
                              samples_per_pixel=4)
    target = grtt.render(scene, cam, seed=1) / 4 * 0.8

    def autograd():
        params = {k: v.clone().requires_grad_()
                  for k, v in grtt.trainable_params(scene).items()}
        fb = grtt.render(grtt.apply_params(scene, params), cam, seed=0,
                         differentiable=True)
        torch.mean((fb / 4 - target) ** 2).backward()
        return params["color"].grad

    before = cuda_rows.LAUNCHES_ROW_SUMS
    a, b = autograd(), autograd()
    assert cuda_rows.LAUNCHES_ROW_SUMS > before and torch.equal(a, b)
    lucy = build_lucy(grtt, device="cuda")
    lcam = tcamera.Camera(**LUCY_CAM)
    lt = torch.zeros((lcam.image_height, lcam.image_width, 3), device="cuda")
    (l1, g1), (l2, g2) = (grtt.render_grad(lucy, lcam, lt, seed=2) for _ in range(2))
    assert float(l1) == float(l2)
    assert all(torch.equal(g1[k], g2[k]) for k in g1)
    g = torch.randn((100000, 3), device="cuda")
    i = torch.randint(0, 7, (100000,), device="cuda")
    k = cuda_rows.row_sums(g, i, 7)
    p = cuda_rows._row_sums_plain(g, i, 7)
    assert float((k - p).abs().max()) <= 1e-5 * float(p.abs().max())
    assert torch.equal(k, cuda_rows.row_sums(g, i, 7))


@pytest.mark.cuda
def test_cuda_render_grad_replay_goes_through_the_record_kernel():
    """On a GPU: ``render_grad`` of a scene inside the megakernel's gate and
    outside both gradient kernel tiers records each chunk once with the
    record kernel, and matches the same call on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    from go_raytracing_tpu_torch.render import grad as tgrad

    scene, cam = grtt.load_scene("random", grid=(-7, 7, -7, 7))
    cam = dataclasses.replace(cam, image_width=32, aspect_ratio=1.0,
                              samples_per_pixel=2, max_depth=3)
    assert tgrad.grad_tier(scene, 3) == "replay"
    target = torch.full((32, 32, 3), 0.3, device="cuda")
    stats = grtt.RenderStats()
    before = cw.LAUNCHES_RECORD
    loss, g = grtt.render_grad(scene, cam, target, seed=1, stats=stats)
    assert cw.LAUNCHES_RECORD == before + stats.chunks
    cpu_scene, _ = grtt.load_scene("random", grid=(-7, 7, -7, 7), device="cpu")
    ref_loss, ref = grtt.render_grad(cpu_scene, cam, target.cpu(), seed=1, device="cpu")
    assert abs(float(loss) - float(ref_loss)) <= 1e-4 * float(ref_loss)
    for k in ref:
        big = max(float(ref[k].abs().max()), 1e-12)
        assert float((g[k].cpu() - ref[k]).abs().max()) <= 2e-3 * big, k


# -----------------------------------------------------------------------------
# Environments: HDRI NEE in the forward and record kernels, the pathwise
# reverse's environment miss rows, the fused kernel, the per-texel sums
# -----------------------------------------------------------------------------

def _env_case(name, width=64, spp=4):
    build, fields = ((build_env_nee, ENV_NEE_CAM) if name == "env-nee"
                     else (build_mini_hdri, MINI_HDRI_CAM))
    scene = build(grtt, device="cuda")
    cam = dataclasses.replace(tcamera.Camera(**fields), image_width=width,
                              samples_per_pixel=spp)
    o, d, tm, ids = _rays(cam, width * width * spp, 3, "cuda")
    return scene, cam, (o, d, tm, cw.stream_to_i32(ids))


@pytest.mark.cuda
def test_cuda_hdri_rows_in_forward_and_record_kernels():
    """HDRI NEE (B1 and B6 with the 7 rows a bounce): each kernel equals its
    plain version on every ray (radiance, flags, record), the record's
    radiance is the forward's, and the environment's shadow bit is set."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene, cam, (o, d, tm, sid) = _env_case("env-nee")
    tb = cw.build_tables(scene)
    hdri = cw.hdri_rows_for(scene, sid, 3, cam.max_depth)
    args = (tb, o, d, tm, sid, 3, cam.max_depth)
    out, flags = cw.wavefront_fwd(*args, hdri)
    p_out, p_flags = cw._wavefront_fwd_plain(*args, hdri)
    assert torch.equal(flags, p_flags) and float((out - p_out).abs().max()) == 0.0
    plain_no_hdri, _ = cw.wavefront_fwd(*args)
    assert float((out[:3] - plain_no_hdri[:3]).abs().max()) > 0   # the rows count
    r_out, r_flags, code, idx = cw.wavefront_record(*args, hdri)
    assert torch.equal(r_out, out) and torch.equal(r_flags, flags)
    _, _, p_code, p_idx = cw._wavefront_record_plain(*args, hdri)
    assert torch.equal(code, p_code) and torch.equal(idx, p_idx)
    assert bool(((code & cw.DEC_BLK_H) != 0).any())


@pytest.mark.cuda
def test_cuda_pathwise_stream_branch_matches_plain_version():
    """Under an environment (no light): the pathwise forward leaves the miss
    term out (miss mode MISS_STREAM), and the reverse kernel with the miss
    colour and the miss direction's cotangent as rows equals its plain
    version within 1e-4 of each key's largest entry, with the same bits on
    two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene, cam, (o, d, tm, sid) = _env_case("mini-hdri")
    rad, carry = cw.grad_fwd_stash(scene, cam, o, d, tm, sid, 3, pathwise=True)
    g3 = torch.rand((3, sid.shape[0]), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0)) * 1e-3
    mc, lmd, _ = cw._env_miss_terms(scene, cam, carry[3], g3, want_lmd=True)
    n_tex = int(scene.textures.color.shape[0])
    n_mat = int(scene.materials.kind.shape[0])
    args = (cw.build_tables(scene), carry[1], carry[2], g3, mc, sid, 3,
            cw.MISS_STREAM, n_tex, n_mat, lmd)
    before = cw.LAUNCHES_GRAD_REV_PATHWISE
    gk = cw.wavefront_grad_rev_pathwise(*args)
    assert cw.LAUNCHES_GRAD_REV_PATHWISE == before + 1
    gp = cw._wavefront_grad_rev_pathwise_plain(*args)
    for a, b in zip(gk, gp):
        assert float(b.abs().max()) > 1e-6
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    for a, b in zip(gk, cw.wavefront_grad_rev_pathwise(*args)):
        assert torch.equal(a, b)
    # the direction's cotangent reaches fuzz and ior: without it they move
    no_lmd = cw._wavefront_grad_rev_pathwise_plain(*args[:7], cw.MISS_FLAT, n_tex, n_mat)
    assert float((no_lmd[1] - gp[1]).abs().max()) > 0


def _fused_against_plain(depth=None, width=64):
    """B4 on the environment + light scene against the forward kernel and
    its plain version (see the tests below)."""
    scene, cam, (o, d, tm, sid) = _env_case("env-nee", width=width)
    depth = cam.max_depth if depth is None else depth
    tb = cw.build_tables(scene)
    hdri = cw.hdri_rows_for(scene, sid, 3, depth)
    out, flags = cw.wavefront_fwd(tb, o, d, tm, sid, 3, depth, hdri)
    g3 = torch.rand((3, sid.shape[0]), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1)) * 1e-3
    mc, lmd, _ = cw._env_miss_terms(scene, cam, cw._env_carry(scene, out, flags),
                                    g3, want_lmd=True)
    env_rows = torch.cat([mc, lmd]).contiguous()
    n_tex = int(scene.textures.color.shape[0])
    n_mat = int(scene.materials.kind.shape[0])
    args = (tb, o, d, tm, sid, 3, depth, g3, (cw.MISS_STREAM, (0.0, 0.0, 0.0)),
            env_rows, hdri, n_tex, n_mat)
    before = cw.LAUNCHES_GRAD_FUSED
    k = cw.wavefront_grad_fused(*args)
    assert cw.LAUNCHES_GRAD_FUSED == before + 1
    want = torch.stack([out[c] + out[6 + c] * mc[c] for c in range(3)])
    assert torch.equal(k[0], want)
    p = cw._wavefront_grad_fused_plain(*args)
    assert torch.equal(k[0], p[0])
    for a, b in zip(k[1:4], p[1:4]):
        assert float(b.abs().max()) > 1e-6
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    assert float(p[4].abs().max()) > 0
    assert float((k[4] - p[4]).abs().max()) <= 1e-6 * float(p[4].abs().max())
    for a, b in zip(k, cw.wavefront_grad_fused(*args)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_fused_kernel_matches_plain_version():
    """The fused kernel (B4) on the environment + light scene: radiance bit
    for bit the forward kernel's with the same HDRI rows plus the miss term,
    the sums within 1e-4 of each key's largest entry of the plain version's,
    the texel cotangent rows (eout) within float32 rounding, and the same
    bits on two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    _fused_against_plain()


@pytest.mark.cuda
def test_cuda_fused_kernel_with_marble_matches_plain_version():
    """B4 on the noise + glossy scene under an environment with its quad
    light: the marble evaluated once a hit (with its derivative, in turns
    across the warp) and dmarble/dp in the local stash, read by the reverse
    sweep; the sums within 1e-4 of each key's largest entry, the radiance
    the plain version's bits, the same bits on two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene = build_noise_glossy(grtt, env=mini_env(), device="cuda")
    cam = dataclasses.replace(tcamera.Camera(**NOISE_GLOSSY_CAM), image_width=64,
                              max_depth=5)
    assert cw.grad_fused_applicable(scene, cam.max_depth) and scene.has_noise
    o, d, tm, ids = _rays(cam, 64 * 64 * 4, 3, "cuda")
    sid = cw.stream_to_i32(ids)
    tb = cw.build_tables(scene)
    hdri = cw.hdri_rows_for(scene, sid, 3, cam.max_depth)
    out, flags = cw.wavefront_fwd(tb, o, d, tm, sid, 3, cam.max_depth, hdri)
    g3 = torch.rand((3, sid.shape[0]), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1)) * 1e-3
    mc, lmd, _ = cw._env_miss_terms(scene, cam, cw._env_carry(scene, out, flags),
                                    g3, want_lmd=True)
    args = (tb, o, d, tm, sid, 3, cam.max_depth, g3, (cw.MISS_STREAM, (0.0, 0.0, 0.0)),
            torch.cat([mc, lmd]).contiguous(), hdri,
            int(scene.textures.color.shape[0]), int(scene.materials.kind.shape[0]))
    before = cw.LAUNCHES_GRAD_FUSED
    k = cw.wavefront_grad_fused(*args)
    assert cw.LAUNCHES_GRAD_FUSED == before + 1
    p = cw._wavefront_grad_fused_plain(*args)
    assert torch.equal(k[0], p[0])
    for a, b in zip(k[1:4], p[1:4]):
        assert float(b.abs().max()) > 1e-6
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    assert float((k[4] - p[4]).abs().max()) <= 1e-6 * float(p[4].abs().max())
    for a, b in zip(k, cw.wavefront_grad_fused(*args)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(sm.VARIANTS))
def test_cuda_probe_matches_plain_version(variant):
    """The tile-sweep probe (B10's sweep alone) on the card equals its plain
    version, t and id, at 8 blocks x 96 sweeps (the bit scan: 96 of them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    rays, tri = sm.probe_inputs(8, "cuda")
    before = sm.LAUNCHES
    t, ids = sm.stream_micro(rays, tri, 96, variant)
    assert sm.LAUNCHES == before + 1
    pt, pids = sm._stream_micro_plain(rays, tri, 96, variant)
    assert torch.equal(t, pt) and torch.equal(ids, pids)
    assert int((ids >= 0).sum()) >= 10


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks, n_sweeps", [(7, 77), (13, 45), (1, 31)])
@pytest.mark.parametrize("variant", list(sm.VARIANTS))
def test_cuda_probe_odd_sizes_match_plain_version(variant, n_blocks, n_sweeps):
    """The probe at odd block counts and at sweep counts that are not
    multiples of 32 (the bit scan then visits 32 * (n // 32) slots, none at
    31, and the staging ring runs past the last slot): t and id equal to
    the plain version's, the same bits on a second launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    rays, tri = sm.probe_inputs(n_blocks, "cuda")
    t, ids = sm.stream_micro(rays, tri, n_sweeps, variant)
    pt, pids = sm._stream_micro_plain(rays, tri, n_sweeps, variant)
    assert torch.equal(t, pt) and torch.equal(ids, pids)
    t2, ids2 = sm.stream_micro(rays, tri, n_sweeps, variant)
    assert torch.equal(t, t2) and torch.equal(ids, ids2)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(sm.VARIANTS))
def test_cuda_probe_extreme_magnitudes_match_plain_version(variant):
    """The probe where a test's a = e1 . (d x e2) reaches 2^126 and past
    (positions scaled by 6e12, directions by 4e12; a few NaN directions):
    there the kernel's division leaves its fast path, and the outputs must
    still be the plain version's bits, hits with such an a among them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    rays, tri = sm.probe_inputs(4, "cuda")
    rays[:, 0:3] *= 6e12
    rays[:, 3:6] *= 4e12
    rays[:, 6] = 3e38
    rays[1, 3, 2, :7] = float("nan")
    tri[:, 0:9] *= 6e12
    d, e1, e2 = rays[:, 3:6], tri[0, 3:6], tri[0, 6:9]
    a = (e1[0] * (d[1] * e2[2] - d[2] * e2[1]) + e1[1] * (d[2] * e2[0] - d[0] * e2[2])
         + e1[2] * (d[0] * e2[1] - d[1] * e2[0]))
    assert int(((a.abs() >= 2.0 ** 126) & torch.isfinite(a)).sum()) > 10
    assert int(torch.isinf(a).sum()) > 10
    t, ids = sm.stream_micro(rays, tri, 64, variant)
    pt, pids = sm._stream_micro_plain(rays, tri, 64, variant)
    assert torch.equal(t, pt) and torch.equal(ids, pids)
    assert int((ids >= 0).sum()) >= 10


@pytest.mark.cuda
def test_cuda_fused_kernel_matches_plain_version_past_depth_16():
    """The same at depth 20, 16x16 at 4 spp: the fused tier serves
    environment + light scenes to FUSED_MAX_DEPTH (50), past the two-phase
    tiers' 16."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    _fused_against_plain(depth=20, width=16)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mini-hdri", "env-nee"])
def test_cuda_render_grad_of_environments(name):
    """``render_grad`` of an environment scene on a GPU: the pathwise
    two-phase tier (no light) or the fused tier (with one), through their
    kernels, the per-texel sums through their kernel, the CPU's numbers
    within 2e-3 of each key's largest entry, and the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    from go_raytracing_tpu_torch.ops import cuda_rows
    from go_raytracing_tpu_torch.render import grad as tgrad

    scene, cam, _ = _env_case(name, width=32, spp=2)
    tier = tgrad.grad_tier(scene, cam.max_depth)
    assert tier == ("fused" if name == "env-nee" else "pathwise")
    target = torch.full((32, 32, 3), 0.3, device="cuda")
    before = (cw.LAUNCHES_GRAD_FUSED, cw.LAUNCHES_GRAD_REV_PATHWISE,
              cuda_rows.LAUNCHES_SEGMENT_SUMS)
    loss, g = grtt.render_grad(scene, cam, target, seed=1)
    after = (cw.LAUNCHES_GRAD_FUSED, cw.LAUNCHES_GRAD_REV_PATHWISE,
             cuda_rows.LAUNCHES_SEGMENT_SUMS)
    assert after[0] - before[0] == (1 if tier == "fused" else 0)
    assert after[1] - before[1] == (0 if tier == "fused" else 1)
    assert after[2] > before[2]
    loss2, g2 = grtt.render_grad(scene, cam, target, seed=1)
    assert float(loss) == float(loss2)
    assert all(torch.equal(g[k], g2[k]) for k in g)
    cpu_scene = (build_env_nee if name == "env-nee" else build_mini_hdri)(
        grtt, device="cpu")
    ref_loss, ref = grtt.render_grad(cpu_scene, cam, target.cpu(), seed=1, device="cpu")
    assert abs(float(loss) - float(ref_loss)) <= 1e-4 * float(ref_loss)
    for k in ("color", "fuzz", "ior", "env_data"):
        big = float(ref[k].abs().max())
        assert big > 0, k
        assert float((g[k].cpu() - ref[k]).abs().max()) <= 2e-3 * big, k


@pytest.mark.cuda
def test_cuda_segment_sums_match_plain_version():
    """The sorted per-key sums (``cuda_rows.sorted_segment_sums``, the sums
    of an environment's texel cotangents): the float64 plain version's
    numbers to float32 rounding, ids outside [0, n) dropped, same bits
    twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    from go_raytracing_tpu_torch.core import segsum
    from go_raytracing_tpu_torch.ops import cuda_rows

    gen = torch.Generator("cuda").manual_seed(2)
    ids = torch.randint(-5, 5000, (200000,), device="cuda", generator=gen)
    ids[:50000] = 17          # one key with a long run
    vals = torch.randn((200000, 12), device="cuda", generator=gen)
    k = segsum.rows_segment_sum(ids, vals, 4096)
    keep = (ids >= 0) & (ids < 4096)
    p = torch.zeros((4096, 12), dtype=torch.float64, device="cuda")
    p.index_add_(0, ids[keep], vals[keep].double())
    assert float((k.double() - p).abs().max()) <= 1e-5 * float(p.abs().max())
    assert torch.equal(k, segsum.rows_segment_sum(ids, vals, 4096))
    sid, perm = torch.sort(ids, stable=True)
    cols = vals[perm].t().contiguous()
    before = cuda_rows.LAUNCHES_SEGMENT_SUMS
    kk = cuda_rows.sorted_segment_sums(sid, cols, 4096)
    # one launch a level of spans: 200,000 rows, 391 spans, 2, then 1
    assert cuda_rows.LAUNCHES_SEGMENT_SUMS == before + 3
    pp = cuda_rows._sorted_segment_sums_plain(sid, cols, 4096)
    assert float((kk - pp).abs().max()) <= 1e-5 * float(pp.abs().max())


def _segment_case(name, gen):
    """(ids, columns [C, *ids.shape], n_keys) of the segment-sum cases."""
    if name == "skewed":          # one key holds most rows, every other few
        ids = torch.randint(0, 70000, (3_000_000,), device="cuda", generator=gen)
        ids[torch.rand(3_000_000, device="cuda", generator=gen) < 0.8] = 4321
        return ids, torch.randn((3, 3_000_000), device="cuda", generator=gen), 70000
    if name == "long_run":        # a key whose run crosses about 2,000 spans
        ids = torch.randint(-7, 9000, (1_500_000,), device="cuda", generator=gen)
        ids[200_000:1_250_000] = 8999
        vals = torch.randn((1_500_000, 12), device="cuda", generator=gen).t()
        vals[:, ::5] = 0.0
        return ids, vals, 9000
    if name == "all_dropped":     # every id out of range or every row zero
        ids = torch.randint(0, 100, (50_000,), device="cuda", generator=gen)
        ids[::2] = -1
        vals = torch.randn((1, 50_000), device="cuda", generator=gen)
        vals[:, 1::2] = 0.0
        return ids, vals, 100
    if name == "one_key":
        ids = torch.zeros(700_000, dtype=torch.int32, device="cuda")
        ids[::3] = 1
        return ids, torch.randn((3, 700_000), device="cuda", generator=gen), 1
    # "layers": [D, 3, R] columns taken as a strided view, as the fused
    # tier's eout rows are, with int64 ids [D, R]
    rows = torch.randn((6, 3, 400_000), device="cuda", generator=gen)
    rows[:, :, 1::3] = -0.0
    ids = torch.randint(0, 524288, (6, 400_000), device="cuda", generator=gen)
    return ids, rows.transpose(0, 1), 524288


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["skewed", "long_run", "all_dropped", "one_key", "layers"])
def test_cuda_segment_pipeline_matches_plain_version(name):
    """``core/segsum.cols_segment_sum`` through its kernels (the kept rows,
    the span sums a level at a time): within 1e-6 of the float64 plain
    version's largest entry, the same bits on two calls, and the kept rows
    those of the plain compaction."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    from go_raytracing_tpu_torch.core import segsum
    from go_raytracing_tpu_torch.ops import cuda_rows

    gen = torch.Generator("cuda").manual_seed(3)
    ids, cols, n_keys = _segment_case(name, gen)
    before = (cuda_rows.LAUNCHES_SEGMENT_KEEP, cuda_rows.LAUNCHES_SEGMENT_SUMS)
    k = segsum.cols_segment_sum(ids, cols, n_keys)
    keep = (cuda_rows.LAUNCHES_SEGMENT_KEEP - before[0],
            cuda_rows.LAUNCHES_SEGMENT_SUMS - before[1])
    assert keep[0] == (1 if name == "all_dropped" else 2)
    assert (keep[1] == 0) == (name == "all_dropped")
    flat_ids = ids.reshape(-1).long()
    flat = cols.reshape(cols.shape[0], -1)
    ok = (flat_ids >= 0) & (flat_ids < n_keys)
    p = torch.zeros((n_keys, cols.shape[0]), dtype=torch.float64, device="cuda")
    p.index_add_(0, flat_ids[ok], flat[:, ok].t().double())
    big = max(float(p.abs().max()), 1e-30)
    assert float((k.double() - p).abs().max()) <= 1e-6 * big
    assert torch.equal(k, segsum.cols_segment_sum(ids, cols, n_keys))
    kid, krow = cuda_rows.segment_keep(ids, cols, n_keys)
    pid, prow = cuda_rows._segment_keep_plain(ids, cols, n_keys)
    assert torch.equal(kid, pid) and torch.equal(krow, prow)
    if name == "all_dropped":
        assert kid.numel() == 0 and float(k.abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_segment_factored_and_rows_match_plain_version():
    """The factored form (5 columns gathered into key order, expanded to
    12, rows whose cotangent is zero skipped) and ``take_rows_sorted``'s
    backward pass against their CPU routes' numbers, the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    from go_raytracing_tpu_torch.core import segsum

    gen = torch.Generator("cuda").manual_seed(4)
    n = 900_000
    ids = torch.randint(0, 5000, (n,), device="cuda", generator=gen)
    fx, fy = (torch.rand(n, device="cuda", generator=gen) for _ in range(2))
    lam = torch.randn((3, n), device="cuda", generator=gen)
    lam[:, torch.rand(n, device="cuda", generator=gen) < 0.9] = 0.0

    def expand(fx_, fy_, *l3):
        return [w * ch for w in (fx_ * fy_, 1.0 - fx_) for ch in l3]

    def run(dev):
        return segsum.cols_segment_sum_factored(
            ids.to(dev), (fx.to(dev), fy.to(dev), *lam.to(dev)), expand, 5000,
            zero_cols=tuple(lam.to(dev)))

    k = run("cuda")
    ref = run("cpu")
    assert float((k.cpu() - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    assert torch.equal(k, run("cuda"))
    table = torch.randn((5000, 12), device="cuda", generator=gen).requires_grad_()
    g = torch.randn((n, 12), device="cuda", generator=gen)
    (segsum.take_rows_sorted(table, ids) * g).sum().backward()
    want = torch.zeros((5000, 12), dtype=torch.float64, device="cuda")
    want.index_add_(0, ids, g.double())
    assert float((table.grad.double() - want).abs().max()) <= 1e-6 * float(want.abs().max())


# -----------------------------------------------------------------------------
# Marble textures in the tracing kernels; the resumable kernel (B11) and the
# megakernel's two-phase modes
# -----------------------------------------------------------------------------

def _per_ray_mismatch(a_rows, a_flags, b_rows, b_flags):
    """Share of rays outside rtol / atol 1e-3 on any row, or with another
    flag word."""
    good = (torch.isclose(a_rows, b_rows, rtol=1e-3, atol=1e-3).all(dim=0)
            & (a_flags == b_flags))
    return 1.0 - float(good.float().mean())


def _resume_case(name, width=64, spp=4, depth=8):
    if name == "marble":
        scene = build_marble(grtt, device="cuda")
        cam = tcamera.Camera(**MARBLE_CAM)
    elif name == "env-nee":
        scene = build_env_nee(grtt, device="cuda")
        cam = tcamera.Camera(**ENV_NEE_CAM)
    else:
        scene, cam = grtt.load_scene("cornell-smoke", device="cuda")
    cam = dataclasses.replace(cam, image_width=width, aspect_ratio=1.0,
                              samples_per_pixel=spp, max_depth=depth)
    o, d, tm, ids = _rays(cam, width * width * spp, 4, "cuda")
    return scene, cam, (o, d, tm, cw.stream_to_i32(ids))


@pytest.mark.cuda
def test_cuda_marble_in_forward_record_and_product_kernels():
    """Marble textures in B1, B6 and B2: B1 against its plain version per
    ray (fewer than 0.5 % of rays outside 1e-3, the gate of every tracing
    kernel; the marble's sine is the card's sinf in both), B6 and B2 give
    B1's radiance bit for bit and B6 its plain version's record."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene, cam, (o, d, tm, sid) = _resume_case("marble", depth=4)
    assert scene.has_noise and cw.applicable(scene)
    args = (cw.build_tables(scene), o, d, tm, sid, 4, cam.max_depth)
    out, flags = cw.wavefront_fwd(*args)
    p_out, p_flags = cw._wavefront_fwd_plain(*args)
    assert _per_ray_mismatch(out, flags, p_out, p_flags) < 0.005
    r_out, r_flags, code, idx = cw.wavefront_record(*args)
    assert torch.equal(r_out, out) and torch.equal(r_flags, flags)
    _, _, p_code, p_idx = cw._wavefront_record_plain(*args)
    assert torch.equal(code, p_code) and torch.equal(idx, p_idx)
    g_out, g_flags = cw.wavefront_grad_fwd(*args, cw.miss_config(cam))[:2]
    assert torch.equal(g_out, out) and torch.equal(g_flags, flags)


@pytest.mark.cuda
def test_cuda_render_grad_of_marble_on_the_product_tier():
    """``render_grad`` of the noise + solid scene runs the product-chain
    kernels on the card and matches the same call on the CPU (plain
    versions) within 2e-3 of each key's largest entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    from go_raytracing_tpu_torch.render import grad as tgrad

    scene = build_marble(grtt, device="cuda")
    cam = dataclasses.replace(tcamera.Camera(**MARBLE_CAM), image_width=32)
    assert tgrad.grad_tier(scene, cam.max_depth) == "product"
    target = torch.full((32, 32, 3), 0.3, device="cuda")
    before = (cw.LAUNCHES_GRAD_FWD, cw.LAUNCHES_GRAD_REV)
    loss, g = grtt.render_grad(scene, cam, target, seed=1)
    assert cw.LAUNCHES_GRAD_FWD > before[0] and cw.LAUNCHES_GRAD_REV > before[1]
    ref_loss, ref = grtt.render_grad(build_marble(grtt, device="cpu"), cam,
                                     target.cpu(), seed=1, device="cpu")
    assert abs(float(loss) - float(ref_loss)) <= 1e-4 * float(ref_loss)
    for k in ref:
        big = max(float(ref[k].abs().max()), 1e-12)
        assert float((g[k].cpu() - ref[k]).abs().max()) <= 2e-3 * big, k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["marble", "cornell-smoke", "env-nee"])
def test_cuda_resume_kernel_matches_plain_version(name):
    """B11, both launches of an explicit split (bounces [0, 4), the
    survivors sorted, then [4, 8)), against its plain version on the same
    state: all 19 outputs, bit for bit (marble: the per-ray gate); and the
    split's radiance, flags and miss rows are the forward kernel's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene, cam, (o, d, tm, sid) = _resume_case(name)
    tb = cw.build_tables(scene)

    def rows(s, b0, b1):
        return (cw.hdri_rows_for(scene, s, 4, b1, b_start=b0)
                if cw.uses_hdri_nee(scene) else None)

    def same(k, p):
        kr = torch.stack([a.view(torch.float32) for a in k])
        pr = torch.stack([a.view(torch.float32) for a in p])
        if name == "marble":
            assert _per_ray_mismatch(kr, k[9], pr, p[9]) < 0.005
        else:
            assert torch.equal(kr, pr)

    flat = cw._start_state(o, d, tm, sid)
    before = cw.LAUNCHES_RESUME
    k1 = cw.wavefront_resume(tb, flat, 4, 0, 4, rows(flat[7], 0, 4))
    same(k1, cw._wavefront_resume_plain(tb, flat, 4, 0, 4, rows(flat[7], 0, 4)))
    flat2, _ = cw._phase_state_sort(cw._resumed_state(flat, k1),
                                    (k1[9] & cw.FLAG_ALIVE) != 0)
    k2 = cw.wavefront_resume(tb, flat2, 4, 4, 8, rows(flat2[7], 4, 8))
    same(k2, cw._wavefront_resume_plain(tb, flat2, 4, 4, 8, rows(flat2[7], 4, 8)))
    torch.cuda.synchronize()
    assert cw.LAUNCHES_RESUME == before + 2
    single = cw.trace_megakernel(scene, cam, o, d, tm, sid, 4)
    split = cw.trace_megakernel(scene, cam, o, d, tm, sid, 4, split=True)
    assert all(torch.equal(torch.stack(list(a)) if isinstance(a, tuple) else a,
                           torch.stack(list(b)) if isinstance(b, tuple) else b)
               for a, b in zip(single, split))


@pytest.mark.cuda
def test_cuda_split_and_compact_renders_equal_single(monkeypatch):
    """``render_image`` of perlin (no light) picks 'split' once the
    thresholds are met, launches B11 twice a chunk and no forward kernel,
    and gives the single-phase picture bit for bit; so does 'compact'."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    from go_raytracing_tpu_torch.integrator import wavefront as twf

    scene, cam = grtt.load_scene("perlin")
    cam = dataclasses.replace(cam, image_width=96, samples_per_pixel=4, max_depth=12)
    single = grtt.render_image(scene, cam, seed=2, mega_mode="single")
    monkeypatch.setattr(cw, "SPLIT_DEPTH_MIN", 8)
    monkeypatch.setattr(cw, "SPLIT_R_MIN", 1024)
    assert twf.choose_mega_mode(scene, cam, 4096, False) == "split"
    stats = grtt.RenderStats()
    before = (cw.LAUNCHES, cw.LAUNCHES_RESUME)
    split = grtt.render_image(scene, cam, seed=2, stats=stats)
    assert (cw.LAUNCHES, cw.LAUNCHES_RESUME) == (before[0], before[1] + 2 * stats.chunks)
    assert torch.equal(split, single)
    assert torch.equal(grtt.render_image(scene, cam, seed=2, mega_mode="compact"), single)


# ---- B1 and B11 below 64 spheres (the brute sweep) as redesigned.  Each
# case is held to the plain version bit for bit: every output row and the
# flag word, on ray sets in the render's order and in turns of path length
# (the lanes of a warp end at every depth), at ray counts off a warp's and a
# block's, in scenes with volumes, HDRI rows, an environment without them,
# and marble at depth 50.

def _brute_case(name, n, depth, seed=6):
    if name in ("cornell", "cornell-smoke"):
        scene, cam = grtt.load_scene(name, device="cuda")
        cam = dataclasses.replace(cam, aspect_ratio=1.0, samples_per_pixel=4)
    else:
        build, fields = {"mixed": (build_mixed, MIXED_CAM),
                         "env-nee": (build_env_nee, ENV_NEE_CAM),
                         "mini-hdri": (build_mini_hdri, MINI_HDRI_CAM),
                         "marble": (build_marble, MARBLE_CAM)}[name]
        scene, cam = build(grtt, device="cuda"), tcamera.Camera(**fields)
    cam = dataclasses.replace(cam, image_width=64, max_depth=depth)
    tb = cw.build_tables(scene)
    # the brute sweep, in the instantiation of a scene with marble or without
    assert cw.brute_route(tb) == ("marble" if name == "marble" else "brute")
    o, d, tm, ids = _rays(cam, n, seed, "cuda")
    return scene, cam, tb, (o, d, tm, cw.stream_to_i32(ids))


def _hdri_rows(scene, sid, seed, b1, b0=0):
    return cw.hdri_rows_for(scene, sid, seed, b1, b_start=b0) if cw.uses_hdri_nee(scene) else None


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name, n, depth, order", [
    ("cornell", 16384, 5, "render"), ("cornell", 16384, 5, "lengths-in-turn"),
    ("cornell", 33, 5, "render"), ("cornell-smoke", 4097, 5, "lengths-in-turn"),
    ("mixed", 16384, 4, "lengths-in-turn"), ("env-nee", 16384, 4, "lengths-in-turn"),
    ("mini-hdri", 4096, 5, "render"), ("marble", 4096, 50, "render")])
def test_cuda_forward_brute_bit_for_bit(scene_name, n, depth, order):
    """On a GPU: B1 below 64 spheres against its plain version bit for bit
    (radiance, miss direction and throughput, flag word), with the HDRI
    rows where the scene samples the environment (env-nee)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene, cam, tb, (o, d, tm, sid) = _brute_case(scene_name, n, depth)
    if order == "lengths-in-turn":
        length = _path_lengths(tb, o, d, tm, sid, 6, depth)
        o, d, tm, sid = _in_turns(lengths_in_turn(length, depth), o, d, tm, sid)
        first = _path_lengths(tb, o, d, tm, sid, 6, depth)[:32]
        assert int(first.min()) == 1 and int(first.max()) == depth
    rows = _hdri_rows(scene, sid, 6, depth)
    assert (rows is not None) == (scene_name == "env-nee")
    args = (tb, o, d, tm, sid, 6, depth, rows)
    before = cw.LAUNCHES
    out, flags = cw.wavefront_fwd(*args)
    torch.cuda.synchronize()
    assert cw.LAUNCHES == before + 1
    p_out, p_flags = cw._wavefront_fwd_plain(*args)
    assert torch.equal(out, p_out) and torch.equal(flags, p_flags)


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name, n, depth, order", [
    ("cornell", 16384, 12, "lengths-in-turn"), ("cornell-smoke", 4097, 8, "render"),
    ("mixed", 33, 8, "render"), ("env-nee", 4096, 8, "render"),
    ("marble", 16384, 50, "render")])
def test_cuda_resume_brute_bit_for_bit(scene_name, n, depth, order):
    """On a GPU: B11 below 64 spheres, both launches of an explicit split
    (bounces [0, 4), the survivors sorted, then the rest), against its plain
    version bit for bit on all 19 outputs; in turns of path length the
    first warp of phase 2 holds rays that end at every later bounce and dead
    ones; the split's outputs are one forward launch's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene, cam, tb, (o, d, tm, sid) = _brute_case(scene_name, n, depth)
    k_at = cw.SPLIT_AT

    def same(state, b0, b1):
        rows = _hdri_rows(scene, state[7], 6, b1, b0)
        k = cw.wavefront_resume(tb, state, 6, b0, b1, rows)
        p = cw._wavefront_resume_plain(tb, state, 6, b0, b1, rows)
        assert all(torch.equal(a, b) for a, b in zip(k, p))
        return k

    flat = cw._start_state(o, d, tm, sid)
    before = cw.LAUNCHES_RESUME
    k1 = same(flat, 0, k_at)
    flat2, _ = cw._phase_state_sort(cw._resumed_state(flat, k1), (k1[9] & cw.FLAG_ALIVE) != 0)
    if order == "lengths-in-turn":
        # the bounces each state still enters, plus one: 1 for a dead ray
        left = torch.ones_like(flat2[6], dtype=torch.int64)
        st = flat2
        for b in range(k_at, depth):
            left += (st[14] & cw.FLAG_ALIVE) != 0
            st = cw._resumed_state(st, cw.wavefront_resume(tb, st, 6, b, b + 1))
        idx = lengths_in_turn(left, depth - k_at + 1)
        flat2 = tuple(a[idx].contiguous() for a in flat2)
        assert sorted(left[idx][:32].unique().tolist()) == list(range(1, depth - k_at + 2))
    same(flat2, k_at, depth)
    torch.cuda.synchronize()
    assert cw.LAUNCHES_RESUME >= before + 2
    single = cw.trace_megakernel(scene, cam, o, d, tm, sid, 6)
    split = cw.trace_megakernel(scene, cam, o, d, tm, sid, 6, split=True)
    assert all(torch.equal(torch.stack(list(a)) if isinstance(a, tuple) else a,
                           torch.stack(list(b)) if isinstance(b, tuple) else b)
               for a, b in zip(single, split))


# ---- B5a and B4 as redesigned: the marble in turns across the warp, whole
# warps in the bounce loop, B4's blocks of 128 rays and its stash of entered
# bounces only.  Each case is held to the plain version: B5a's outputs and
# stash and B4's radiance equal (a zero's sign aside: the kernel writes +0
# where the plain version's masked rows give -0), B4's sums within 1e-4 of
# each key's largest entry and its eout rows within 1e-6, and two launches
# give the same bits.

def _marble_edge_scene(env):
    """The noise + glossy scene with a metal sphere and a glass sphere of
    marble (scale 4) besides; under ``env`` with its quad light (B4), or
    without (B5a).  The builder gives glass a white texture, so the marble
    glass is added by hand: its hits evaluate the marble, and their mask has
    no PW_MARBLE bit (a dielectric's albedo never enters)."""
    from go_raytracing_tpu_torch.materials import tables as mats

    b = grtt.SceneBuilder()
    b.quad((-6, 0, -6), (12, 0, 0), (0, 0, 12), b.lambertian(b.noise(0.4)))
    b.quad((-6, 0, -6), (0, 8, 0), (12, 0, 0), b.lambertian((0.6, 0.65, 0.7)))
    b.add_light(b.quad((-1.5, 7.9, -1.5), (3, 0, 0), (0, 0, 3),
                       b.diffuse_light((13.0, 12.0, 11.0))))
    b.sphere((-1.8, 1.2, 0.0), 1.2, b.metal((0.8, 0.6, 0.2), 0.2))
    b.sphere((0.8, 1.0, 1.2), 1.0, b.dielectric(1.5))
    b.sphere((2.5, 0.8, -1.0), 0.8, b.metal(b.noise(4.0), 0.1))
    b._mat.append((mats.MAT_DIELECTRIC, b.noise(4.0), 0.0, 1.5))
    b.sphere((-3.2, 0.7, 2.2), 0.7, len(b._mat) - 1)
    if env is not None:
        b.set_environment(env)
    return b.build(device="cuda"), len(b._mat) - 1


def _frame_rays(cam, n, seed):
    """Camera rays of ``n`` pixels drawn across the frame (sample 0)."""
    w, h = cam.image_width, cam.image_height
    pix = torch.randperm(w * h, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(seed))[:n]
    o, d, tm = tcamera.generate_rays(cam, pix % w, pix // w, pix, seed)
    return (V3(*(c.contiguous() for c in o)), V3(*(c.contiguous() for c in d)),
            tm.contiguous(), cw.stream_to_i32(pix))


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _b5a_equals_plain(scene, cam, rays, depth):
    """B5a against its plain version: every output and stash word; returns
    the stash's int rows."""
    tb = cw.build_tables(scene)
    args = (tb, *rays, 3, depth, cw.miss_config(cam))
    before = cw.LAUNCHES_GRAD_FWD_PATHWISE
    k = cw.wavefront_grad_fwd(*args, pathwise=True)
    assert cw.LAUNCHES_GRAD_FWD_PATHWISE == before + 1
    assert k[3].shape[1] == cw.PW_STASH_F_ROWS_MARBLE
    p = cw._wavefront_grad_fwd_plain(*args, pathwise=True)
    for i in (1, 3, 4):   # flags, stash rows, stash words
        assert torch.equal(k[i], p[i])
    assert torch.equal(k[0][:3], p[0][:3])   # radiance
    for a, b in ((k[0][3:], p[0][3:]), (k[2], p[2])):   # miss records, miss colour
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)
    for a, b in zip(k, cw.wavefront_grad_fwd(*args, pathwise=True)):
        assert torch.equal(_bits(a), _bits(b))
    return k[4]


def _b4_equals_plain(scene, cam, rays, depth):
    """B4 against its plain version (radiance bits, sums, eout, two
    launches); returns the pathwise stash's int rows of the same rays."""
    tb = cw.build_tables(scene)
    o, d, tm, sid = rays
    hdri = cw.hdri_rows_for(scene, sid, 3, depth)
    out, flags = cw.wavefront_fwd(tb, o, d, tm, sid, 3, depth, hdri)
    g3 = torch.rand((3, sid.shape[0]), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1)) * 1e-3
    mc, lmd, _ = cw._env_miss_terms(scene, cam, cw._env_carry(scene, out, flags),
                                    g3, want_lmd=True)
    miss = (cw.MISS_STREAM, (0.0, 0.0, 0.0))
    args = (tb, o, d, tm, sid, 3, depth, g3, miss, torch.cat([mc, lmd]).contiguous(),
            hdri, int(scene.textures.color.shape[0]), int(scene.materials.kind.shape[0]))
    before = cw.LAUNCHES_GRAD_FUSED
    k = cw.wavefront_grad_fused(*args)
    assert cw.LAUNCHES_GRAD_FUSED == before + 1
    p = cw._wavefront_grad_fused_plain(*args)
    assert torch.equal(k[0], p[0])
    for a, b in zip(k[1:4], p[1:4]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    assert float((k[4] - p[4]).abs().max()) <= 1e-6 * float(p[4].abs().max())
    for a, b in zip(k, cw.wavefront_grad_fused(*args)):
        assert torch.equal(_bits(a), _bits(b))
    return cw._wavefront_grad_fwd_plain(tb, *rays, 3, depth, miss, pathwise=True)[4]


def _edge_case(fused):
    scene, glass = _marble_edge_scene(mini_env() if fused else None)
    cam = dataclasses.replace(tcamera.Camera(**NOISE_GLOSSY_CAM), image_width=64)
    return scene, cam, glass, _b4_equals_plain if fused else _b5a_equals_plain


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 127, 129])
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_b5a_and_b4_at_ragged_ray_counts(fused, n):
    """Ray counts around a warp and around B4's block of 128 rays (and B5a's
    blocks of 128 threads): the lanes past the count take the marble's turns
    with no ray and write nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene, cam, _, check = _edge_case(fused)
    check(scene, cam, _frame_rays(cam, n, 5), 5)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 10, 20, 50])
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_b5a_and_b4_at_depths(fused, depth):
    """Depth 1 to B4's cap of 50: B4's stash holds the bounces entered and
    its sweep starts at the warp's deepest."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene, cam, _, check = _edge_case(fused)
    mk = check(scene, cam, _frame_rays(cam, 2048, 6), depth)[:, 2]
    assert bool(((mk[0] & cw.PW_MARBLE) != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_b5a_and_b4_marble_at_first_and_last_bounce(fused):
    """Marble winners at bounce 0 and at the last bounce (depth 3), on the
    floor, on a metal sphere and on a glass sphere of marble (its mask
    without PW_MARBLE)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene, cam, glass, check = _edge_case(fused)
    si = check(scene, cam, _frame_rays(cam, 4096, 7), 3)
    mk = si[:, 2]
    marble = (mk & cw.PW_MARBLE) != 0
    assert bool(marble[0].any()) and bool(marble[2].any())
    assert bool((marble & ((mk & cw.PW_METAL) != 0)).any())
    glass_hits = (si[:, 1] == glass) & ((mk & cw.PW_HIT) != 0)
    assert bool(glass_hits.any()) and not bool((marble & glass_hits).any())


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_b5a_and_b4_warps_of_all_one_and_no_marble_lanes(fused):
    """Three warps built by hand from the camera's origin: 32 rays onto the
    marble floor, 31 onto the back wall with one onto the floor, and 32 into
    the sky, which all die at bounce 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    scene, cam, _, check = _edge_case(fused)
    x = torch.linspace(-3.0, 3.0, 32, device="cuda")
    floor = torch.stack([x, torch.full_like(x, -3.0), torch.full_like(x, -5.0)])
    wall = torch.stack([x, torch.full_like(x, 3.0), torch.full_like(x, -15.0)])
    wall[:, 17] = floor[:, 17]
    sky = torch.stack([x * 0.1, torch.ones_like(x), torch.full_like(x, 0.5)])
    d = torch.cat([floor, wall, sky], dim=1)
    n = d.shape[1]
    o = [torch.full((n,), float(v), device="cuda") for v in cam.look_from]
    rays = (V3(*o), V3(*(c.contiguous() for c in d)), torch.zeros(n, device="cuda"),
            cw.stream_to_i32(torch.arange(n, device="cuda")))
    mk = check(scene, cam, rays, 4)[:, 2]
    first = ((mk[0] & cw.PW_MARBLE) != 0).reshape(3, 32).sum(dim=1).tolist()
    assert first == [32, 1, 0]
    assert bool(((mk[0, 64:] & cw.PW_LIT) != 0).all()) and not bool(mk[1:, 64:].any())


# -----------------------------------------------------------------------------
# Image textures: the 'image' route, the image tier, the replay tier
# -----------------------------------------------------------------------------

def _image_sphere(device, atlas=None, **cam_fields):
    atlas = seeded_atlas(32, 64, seed=3) if atlas is None else atlas
    return (build_image_sphere(grtt, atlas, device=device),
            tcamera.Camera(**{**IMAGE_SPHERE_CAM, **cam_fields}))


@pytest.mark.cuda
def test_cuda_image_route_matches_the_plain_route_on_the_cpu():
    """On a GPU: the 'image' route launches the forward kernel once a chunk
    on the white scene and the sphere closest-hit kernel for the camera
    rays' texels, and its picture is the CPU's plain route's: under 0.5 % of
    pixels outside rtol 1e-3 / atol 2e-3.  It equals the card's standard
    integrator's picture to the same gate."""
    if not torch.cuda.is_available():
        pytest.skip(_NO_CARD)
    scene, cam = _image_sphere("cuda", image_width=64, samples_per_pixel=4, max_depth=10)
    assert wavefront.choose_mega_mode(scene, cam, 64 * 64 * 4, False) == "image"
    stats = grtt.RenderStats()
    b1, sph = cw.LAUNCHES, ck.LAUNCHES_SPHERE
    img = grtt.render(scene, cam, seed=2, stats=stats)
    torch.cuda.synchronize()
    assert cw.LAUNCHES - b1 == stats.chunks and ck.LAUNCHES_SPHERE - sph == stats.chunks
    cpu, _ = _image_sphere("cpu")
    ref = grtt.render(cpu, cam, seed=2, device="cpu")
    std = grtt.render(scene, cam, seed=2, mega_mode="off")
    for other in (ref, std.cpu()):
        bad = ~torch.isclose(img.cpu(), other, rtol=1e-3, atol=2e-3).all(dim=-1)
        assert float(bad.float().mean()) < 0.005
    assert float(img.mean()) > 0.05


@pytest.mark.cuda
def test_cuda_image_tier_matches_the_plain_path_with_the_same_bits():
    """On a GPU: ``render_grad`` on the image tier launches the product-chain
    kernels on the white scene once a chunk each and the per-texel sums;
    loss to rtol 1e-5 and every gradient within 2e-3 of its largest entry of
    the same call on the CPU; two calls give the same bits; the over-budget
    route (``stash_budget=0``) the same loss and gradients (rtol 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip(_NO_CARD)
    from go_raytracing_tpu_torch.ops import cuda_rows
    from go_raytracing_tpu_torch.render import grad as tgrad

    scene, cam = _image_sphere("cuda", image_width=48, samples_per_pixel=4, max_depth=5)
    cpu, _ = _image_sphere("cpu")
    assert tgrad.grad_tier(scene, cam.max_depth) == "image"
    target = grtt.render(cpu, cam, seed=9, device="cpu") / 4 * 0.8
    stats = grtt.RenderStats()
    counters = ("LAUNCHES_GRAD_FWD", "LAUNCHES_GRAD_REV")
    before = [getattr(cw, c) for c in counters] + [cuda_rows.LAUNCHES_SEGMENT_KEEP,
                                                    cuda_rows.LAUNCHES_SEGMENT_SUMS]
    loss, g = grtt.render_grad(scene, cam, target.cuda(), seed=0, stats=stats)
    after = [getattr(cw, c) for c in counters] + [cuda_rows.LAUNCHES_SEGMENT_KEEP,
                                                   cuda_rows.LAUNCHES_SEGMENT_SUMS]
    # the per-texel sums once a chunk: the kept rows' two kernels, then the
    # span sums a launch a level, at least one
    assert [a - b for a, b in zip(after[:3], before[:3])] == [stats.chunks, stats.chunks,
                                                              2 * stats.chunks]
    assert after[3] - before[3] >= stats.chunks
    ref_loss, ref = grtt.render_grad(cpu, cam, target, seed=0, device="cpu")
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * float(ref_loss)
    for k in ref:
        big = max(float(ref[k].abs().max()), 1e-12)
        assert float((g[k].cpu() - ref[k]).abs().max()) <= 2e-3 * big, k
    assert float(g["atlas"].abs().max()) > 0
    loss2, g2 = grtt.render_grad(scene, cam, target.cuda(), seed=0)
    assert float(loss2) == float(loss) and all(torch.equal(g[k], g2[k]) for k in g)
    loss0, g0 = grtt.render_grad(scene, cam, target.cuda(), seed=0, stash_budget=0)
    assert abs(float(loss0) - float(loss)) <= 1e-5 * float(loss)
    for k in g:
        torch.testing.assert_close(g0[k], g[k], rtol=1e-5, atol=1e-9)


@pytest.mark.cuda
def test_cuda_image_replay_and_autograd_reach_the_atlas_with_the_same_bits():
    """On a GPU: the Cornell box with a picture on its back wall (outside
    the image tier) through the replay tier twice (the same bits) and
    through ``render(differentiable=True)`` + ``backward`` twice (the same
    bits), each against the CPU's replay within 2e-3 of the largest
    entry."""
    if not torch.cuda.is_available():
        pytest.skip(_NO_CARD)
    atlas = seeded_atlas(24, 40, seed=8)
    scene = build_cornell_image(grtt, atlas, device="cuda")
    cpu = build_cornell_image(grtt, atlas, device="cpu")
    cam = tcamera.Camera(**{**CORNELL_IMAGE_CAM, "image_width": 32})
    target = torch.full((32, 32, 3), 0.3)
    (l1, g1), (l2, g2) = (grtt.render_grad(scene, cam, target.cuda(), seed=1)
                          for _ in range(2))
    assert float(l1) == float(l2) and torch.equal(g1["atlas"], g2["atlas"])

    def autograd():
        params = {k: v.clone().requires_grad_()
                  for k, v in grtt.trainable_params(scene).items()}
        fb = grtt.render(grtt.apply_params(scene, params), cam, seed=1, differentiable=True)
        torch.mean((fb / 2 - target.cuda()) ** 2).backward()
        return params["atlas"].grad

    a1, a2 = autograd(), autograd()
    assert torch.equal(a1, a2)
    ref_loss, ref = grtt.render_grad(cpu, cam, target, seed=1, device="cpu")
    big = float(ref["atlas"].abs().max())
    assert big > 0 and abs(float(l1) - float(ref_loss)) <= 1e-4 * float(ref_loss)
    for got in (g1["atlas"], a1):
        assert float((got.cpu() - ref["atlas"]).abs().max()) <= 2e-3 * big


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one-texel", "odd-sizes", "two-images-padded"])
def test_cuda_image_texels_at_atlas_edges(case):
    """On a GPU: ``textures.evaluate`` reads the CPU's texels exactly for an
    atlas of one texel, of odd sizes, and of two images of different sizes
    padded in one atlas, at u and v across and outside [0, 1]; a render of
    a scene with them matches the CPU's picture."""
    if not torch.cuda.is_available():
        pytest.skip(_NO_CARD)
    from go_raytracing_tpu_torch.materials import textures as ttex

    images = {"one-texel": [seeded_atlas(1, 1, seed=1)],
              "odd-sizes": [seeded_atlas(7, 13, seed=2)],
              "two-images-padded": [seeded_atlas(5, 9, seed=3), seeded_atlas(11, 3, seed=4)]}[case]

    def build(device):
        b = grtt.SceneBuilder()
        for j, im in enumerate(images):
            b.sphere((2.2 * j - 1.1 * (len(images) - 1), 0, 0), 1.0,
                     b.lambertian(b.image(im)))
        return b.build(device=device)

    scene, cpu = build("cuda"), build("cpu")
    n = 20000
    gen = torch.Generator().manual_seed(5)
    tex_id = torch.randint(0, cpu.textures.kind.shape[0], (n,), generator=gen)
    u, v = (torch.rand((2, n), generator=gen) * 1.4 - 0.2).unbind(0)
    p = V3(*torch.rand((3, n), generator=gen))
    ref = ttex.evaluate(cpu.textures, tex_id, u, v, p, has_image=True)
    got = ttex.evaluate(scene.textures, tex_id.cuda(), u.cuda(), v.cuda(),
                        V3(*(c.cuda() for c in p)), has_image=True)
    for c in range(3):
        assert torch.equal(got[c].cpu(), ref[c])
    cam = tcamera.Camera(**{**IMAGE_SPHERE_CAM, "image_width": 32, "samples_per_pixel": 2})
    img = grtt.render(scene, cam, seed=3)
    ref_img = grtt.render(cpu, cam, seed=3, device="cpu")
    bad = ~torch.isclose(img.cpu(), ref_img, rtol=1e-3, atol=2e-3).all(dim=-1)
    assert float(bad.float().mean()) < 0.005


@pytest.mark.cuda
def test_cuda_sharded_one_rank_render_and_render_grad_are_the_single_device_bits():
    """A one-rank mesh without a process group on the GPU: ``render_sharded``
    gives ``render``'s bits and ``render_grad(mesh=...)`` ``render_grad``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    from go_raytracing_tpu_torch.parallel import sharding

    scene, cam = grtt.load_scene("cornell", device="cuda")
    cam = dataclasses.replace(cam, image_width=64, aspect_ratio=1.0, samples_per_pixel=8,
                              max_depth=5)
    mesh = sharding.make_mesh()
    assert mesh.device == torch.device("cuda", 0) and mesh.group is None
    fb = grtt.render(scene, cam, seed=3)
    assert torch.equal(sharding.render_sharded(scene, cam, mesh, 3, spp=8), fb)
    target = fb / 8 * 0.8
    loss, grads = grtt.render_grad(scene, cam, target, seed=0, stash_budget=1 << 28)
    loss_m, grads_m = grtt.render_grad(scene, cam, target, seed=0, mesh=mesh,
                                       stash_budget=1 << 28)
    assert torch.equal(loss, loss_m)
    for k in grads:
        assert torch.equal(grads[k], grads_m[k]), k


@pytest.mark.cuda
def test_cuda_two_gloo_ranks_on_one_card_match_one_process():
    """Two spawned ranks on the same GPU, joined by gloo over CUDA tensors:
    ``render_sharded`` within 1e-5 of one process's render a sample, and
    ``render_grad(mesh=...)`` of the pathwise tier within the CPU tests'
    tolerances, the same bits on both ranks, every rank launching kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    from go_raytracing_tpu_torch.parallel import launch
    from go_raytracing_tpu_torch.scenes.builders import load_scene

    fields = dict(image_width=64, aspect_ratio=1.0, samples_per_pixel=8, max_depth=5)
    scene, cam = grtt.load_scene("cornell-glossy", device="cuda")
    cam = dataclasses.replace(cam, **fields)
    fb = grtt.render(scene, cam, seed=0)
    target = (fb / 8 * 0.8).cpu().numpy()
    loss, grads = grtt.render_grad(scene, cam, target, seed=0)
    spec = (load_scene, dict(name="cornell-glossy"))
    cases = [("render_sharded", spec, fields, dict(spp=8), 1),
             ("render_grad", spec, fields, dict(target=target, seed=0,
                                                stash_budget=1 << 28), 1)]
    ranks = launch.run_ranks(launch.run_cases, 2, (cases, "cuda"), device="cuda",
                             backend="gloo", timeout=240.0)
    for r in ranks:
        np.testing.assert_allclose(r[0][0]["out"] / 8, fb.cpu().numpy() / 8,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(r[0][0]["out"], ranks[0][0][0]["out"])
        got_loss, got = r[1][0]["out"]
        np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
        for k, v in grads.items():
            np.testing.assert_allclose(got[k], v.cpu().numpy(), rtol=2e-4, atol=1e-9,
                                       err_msg=k)
            np.testing.assert_array_equal(got[k], ranks[0][1][0]["out"][1][k])
        assert r[0][0]["launches"].get("cuda_wavefront.LAUNCHES", 0) > 0
        assert r[1][0]["launches"].get("cuda_wavefront.LAUNCHES_GRAD_REV_PATHWISE", 0) > 0


@pytest.mark.cuda
def test_cuda_checkpoint_resume_profiler_and_memory_report(tmp_path):
    """On the GPU: a render resumed from a checkpoint is the one-shot
    render's bits; the profiler's CUDA-event timers and trace, and the
    memory report's device line."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    from go_raytracing_tpu_torch.render import checkpoint
    from go_raytracing_tpu_torch.utils import profiler

    scene, cam = grtt.load_scene("cornell", device="cuda")
    cam = dataclasses.replace(cam, image_width=64, aspect_ratio=1.0, samples_per_pixel=7,
                              max_depth=5)
    path = str(tmp_path / "c.npz")
    checkpoint.render_with_checkpoints(scene, cam, path, spp=3, seed=1, spp_per_checkpoint=2)
    prof = profiler.Profiler(trace_dir=str(tmp_path / "trace"))
    prof.start()
    with prof.time("resume"):
        acc = checkpoint.render_with_checkpoints(scene, cam, path, spp=7, seed=1,
                                                 spp_per_checkpoint=2)
    prof.stop()
    assert torch.equal(acc, grtt.render(scene, cam, spp=7, seed=1))
    assert prof.timers["resume"].count == 1 and prof.timers["resume"].total > 0
    assert list((tmp_path / "trace").glob("*.json"))
    rep = profiler.memory_report()
    assert "cuda:0: in_use=" in rep and "Live device arrays" in rep
