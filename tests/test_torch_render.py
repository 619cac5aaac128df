"""PyTorch port vs the JAX package: the forward render as a whole, and the
renderer's own invariants (CPU, small images)."""

import dataclasses

import numpy as np
import pytest
import torch

import go_raytracing_tpu as grt
import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu.render import renderer as jrender
from go_raytracing_tpu_torch.render import renderer as trender
from go_raytracing_tpu_torch.utils import cli as tcli

torch.set_num_threads(2)


def _small(cam, width=24, spp=2):
    return dataclasses.replace(cam, image_width=width, samples_per_pixel=spp)


def test_cornell_render_matches_jax():
    """The slice as a whole: Cornell at 24x24, 2 spp, depth 5, same seed,
    in both packages.  On the CPU the JAX package renders through its
    standard integrator, the port through the megakernel's plain version;
    both use the same RNG streams, so the images agree ray for ray except
    where an ulp flips a discrete decision.  Mean absolute difference of
    the accumulators under 1 % of their mean, and fewer than 1 % of pixels
    outside rtol 1e-3 / atol 2e-3 (the tolerance the JAX package's own
    megakernel-vs-integrator test uses)."""
    js, jcam = grt.load_scene("cornell")
    ts, tcam = grtt.load_scene("cornell", device="cpu")
    jcam, tcam = _small(jcam), _small(tcam)
    assert tcam.max_depth == 5
    ref = np.asarray(grt.render(js, jcam, seed=4))
    stats = grtt.RenderStats()
    got = grtt.render(ts, tcam, seed=4, device="cpu", stats=stats).numpy()
    assert got.shape == ref.shape == (24, 24, 3)
    assert np.isfinite(got).all() and ref.mean() > 0.01
    assert np.abs(got - ref).mean() < 0.01 * ref.mean()
    bad = ~np.isclose(got, ref, rtol=1e-3, atol=2e-3).all(axis=-1)
    assert bad.mean() < 0.01, bad.mean()
    assert stats.rays_traced == 24 * 24 * 2 and stats.chunks == 1
    assert stats.mesh_overflow == 0 and stats.wall_seconds > 0


def test_chunk_size_does_not_change_the_image():
    ts, cam = grtt.load_scene("cornell-smoke", device="cpu")
    cam = _small(cam, 16, 3)
    one = grtt.render(ts, cam, seed=1, device="cpu")
    stats = grtt.RenderStats()
    # one sample per chunk: the same sums in the same order -> equal
    per_sample = grtt.render(ts, cam, seed=1, chunk=256, device="cpu", stats=stats)
    assert stats.chunks == 3
    assert torch.equal(one, per_sample)
    # unaligned chunks go through the scatter-add, a pixel once a chunk:
    # its samples again added in order
    ragged = grtt.render(ts, cam, seed=1, chunk=100, device="cpu")
    assert torch.equal(ragged, one)


def test_sample_offset_resumption_equals_one_shot():
    ts, cam = grtt.load_scene("simple", device="cpu")
    cam = _small(cam, 16, 4)
    one = grtt.render(ts, cam, seed=2, device="cpu")
    first = grtt.render(ts, cam, spp=1, seed=2, device="cpu")
    kept = first.clone()
    rest = grtt.render(ts, cam, spp=3, sample_offset=1, accum=first, seed=2,
                       device="cpu")
    assert torch.equal(first, kept)  # the caller's buffer is left alone
    # the samples are added one at a time in both: the same bits
    assert torch.equal(rest, one)


def test_tiled_layout_covers_every_pixel_once():
    w, h = 40, 33
    tx, ty, n_virt = trender.ray_layout(w, h, True)
    assert (tx, ty, n_virt) == (2, 2, 4096)
    px, py, ok = trender._id_to_pixel(torch.arange(n_virt), w, h, True)
    pix = (py * w + px)[ok]
    assert pix.numel() == w * h and torch.equal(pix.sort().values, torch.arange(w * h))
    assert trender.ray_layout(w, h, False) == (0, 0, w * h)
    ts, _ = grtt.load_scene("random", device="cpu")
    assert trender.scene_tiled(ts)  # 363 spheres >= 64
    assert jrender.scene_tiled(grt.load_scene("random")[0])
    assert not trender.scene_tiled(grtt.load_scene("cornell", device="cpu")[0])


def test_tiled_render_runs_and_pick_chunk_size():
    ts, cam = grtt.load_scene("random", device="cpu")
    cam = dataclasses.replace(_small(cam, 16, 1), max_depth=2)
    img = grtt.render_image(ts, cam, seed=0, device="cpu")
    assert img.shape == (9, 16, 3) and torch.isfinite(img).all()
    assert float(img.mean()) > 0.05
    chunk = trender.pick_chunk_size(ts)
    assert chunk == 1 << 22 and chunk % 1024 == 0


def test_progressive_schedule():
    ts, cam = grtt.load_scene("quads", device="cpu")
    cam = dataclasses.replace(_small(cam, 16, 4), max_depth=4)
    seen = []
    passes = list(grtt.render_progressive(
        ts, cam, seed=0, device="cpu", callback=lambda n, im: seen.append(n)))
    assert [n for n, _ in passes] == list(trender.PROGRESSIVE_PASSES) == seen
    final = grtt.render_image(ts, cam, seed=0, device="cpu")
    assert torch.equal(passes[-1][1], final)
    preview = grtt.render_image(ts, cam, spp=1, max_depth=3, seed=0, device="cpu")
    assert torch.equal(passes[0][1], preview)


def test_cli_writes_png(tmp_path, capsys):
    out = tmp_path / "cli.png"
    tcli.main(["-scene", "cornell", "-spp", "1", "-width", "16", "-depth", "3",
               "-device", "cpu", "-out", str(out)])
    img = grtt.film.read_png(str(out))
    assert img.shape == (16, 16, 3) and img.max() > 0
    assert "on cpu" in capsys.readouterr().out
    with pytest.raises(KeyError):
        tcli.main(["-scene", "not-a-scene", "-device", "cpu"])


def test_cli_default_scene_is_the_jax_clis(tmp_path):
    """With no ``-scene`` the port's CLI renders ``hdri-test``, as the JAX
    package's does; its asset is missing here (ROADMAP C1), so both raise
    FileNotFoundError naming it before any rendering."""
    from go_raytracing_tpu.utils import cli as jcli

    out = str(tmp_path / "default.png")
    for main in (tcli.main, jcli.main):
        with pytest.raises(FileNotFoundError, match="abandoned_hall_01_1k.hdr"):
            main(["-spp", "1", "-width", "8", "-out", out])


def test_render_without_device_raises_and_names_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    ts, cam = grtt.load_scene("quads", device="cpu")
    cam = _small(cam, 8, 1)
    for fn in (grtt.render, grtt.render_image):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(ts, cam)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(grtt.render_progressive(ts, cam))
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["-scene", "quads", "-spp", "1", "-width", "8"])
