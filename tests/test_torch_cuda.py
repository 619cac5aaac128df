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
from test_torch_helpers import (FOG_ROOM_CAM, LUCY_CAM, MIXED_CAM, build_fog_room,
                                build_lucy, build_mixed, build_random_prims,
                                lucy_instances, mesh_rays, random_rays)


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
    # checker plane, metal, glass, a moving sphere, quad light, fog box
    return build_mixed(grtt, device="cuda"), dataclasses.replace(
        tcamera.Camera(**MIXED_CAM), image_width=64, use_sky_gradient=True)


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", ["cornell-glossy", "mixed-sky"])
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
    assert k[3].shape == (cam.max_depth, cw.PW_STASH_F_ROWS, n)
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
