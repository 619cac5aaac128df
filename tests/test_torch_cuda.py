"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests carry the ``cuda`` marker and skip, with a reason, on a machine
without a CUDA device (a CUDA kernel has no CPU or interpret mode).  This
file imports the port only, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses

import pytest
import torch

import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu_torch import camera as tcamera
from go_raytracing_tpu_torch.core.vec3 import V3
from go_raytracing_tpu_torch.geometry import mesh_bvh
from go_raytracing_tpu_torch.io import obj as tobj
from go_raytracing_tpu_torch.ops import cuda_intersect as ck
from go_raytracing_tpu_torch.ops import cuda_mesh as cm
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from go_raytracing_tpu_torch.utils import stream_micro as sm
from test_torch_helpers import (ENV_NEE_CAM, FOG_ROOM_CAM, LUCY_CAM, MARBLE_CAM,
                                MINI_HDRI_CAM, MIXED_CAM, NOISE_GLOSSY_CAM,
                                build_env_nee, build_fog_room, build_lucy,
                                build_marble, build_mini_hdri, build_mixed,
                                build_noise_glossy, build_random_prims,
                                lucy_instances, mesh_rays, mini_env, random_rays)


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
    forward kernel's bit for bit.  The reverse kernel sums in float32 in a
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
    light: the marble's scale in the local stash and dmarble/dp in the
    reverse sweep; the sums within 1e-4 of each key's largest entry, the
    radiance the plain version's bits, the same bits on two launches."""
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
    assert cuda_rows.LAUNCHES_SEGMENT_SUMS == before + 1
    pp = cuda_rows._sorted_segment_sums_plain(sid, cols, 4096)
    assert float((kk - pp).abs().max()) <= 1e-5 * float(pp.abs().max())


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
