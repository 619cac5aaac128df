"""The port's CUDA kernel against its plain PyTorch version, on a GPU.

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
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from test_torch_helpers import MIXED_CAM, build_mixed


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
