"""The culled sphere sweep of the forward, record and resumable kernels
(B1, B6, B11; scenes of ``SPH_CULL_MIN`` spheres and more), on the CPU: its
segment and group tables, and its counting mirror (``_sphere_sweep_culled``,
``culled_sweep_counts``) against the brute sweep in table order, the
specification, which the kernels' plain versions keep.  The mirror must give
the brute sweep's t (bit for bit), winner and scene index on every ray:
seeded rays through a small ``random``, exact ties (duplicated spheres, swept
in reversed order: the lower index wins), rays aimed at segment and group
box corners and edges and along the axes, moving spheres, a radius-1000
ground sphere, and 63 / 64 / 65 spheres; and on the ``CULL_CASES`` sets the
two-level sweep the one-level sweep's winners (every segment in one group
under an infinite box).  The GPU side (the kernels against their plain
versions on the same sets) is in tests/test_torch_cuda.py; the port's records
of a small ``random`` against the JAX package's are held by
tests/test_torch_replay_megakernel.py, whose replay reads them.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu_torch import camera as tcamera
from go_raytracing_tpu_torch.core.vec3 import V3
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from test_torch_helpers import (CULL_CASES, build_sphere_cloud, cull_case, cull_rays,
                                culled_boxes, reverse_within_segments)

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _small_random():
    return grtt.load_scene("random", grid=(-5, 5, -5, 5), device="cpu")


SCENES = {
    "random": lambda: _small_random()[0],
    "cloud": lambda: build_sphere_cloud(grtt, device="cpu"),
    "ground_sphere": lambda: build_sphere_cloud(grtt, ground_sphere=True, device="cpu"),
    "64": lambda: build_sphere_cloud(grtt, n_spheres=64, seed=2, device="cpu"),
    "65": lambda: build_sphere_cloud(grtt, n_spheres=65, seed=3, device="cpu"),
}


@functools.lru_cache(maxsize=None)
def _scene(name):
    return SCENES[name]()


@functools.lru_cache(maxsize=None)
def _tables(name):
    tb = cw.build_tables(_scene(name))
    assert tb.n_sphere >= cw.SPH_CULL_MIN and tb.n_seg > 0
    return tb


def _rays(tb, seed=0):
    o, d, tm = cull_rays(culled_boxes(tb.seg_box, tb.grp_box), n_random=64, seed=seed)
    return (V3(*torch.from_numpy(o).T.contiguous()), V3(*torch.from_numpy(d).T.contiguous()),
            torch.from_numpy(tm))


@pytest.mark.parametrize("name", list(SCENES))
def test_segments_hold_every_sphere_once(name):
    tb = _tables(name)
    order, start = tb.seg_order.long(), tb.seg_start.long()
    assert sorted(order.tolist()) == list(range(tb.n_sphere))
    sizes = start[1:] - start[:-1]
    assert start[0] == 0 and start[-1] == tb.n_sphere and bool((sizes > 0).all())
    assert int(sizes.max()) <= cw.SPH_SEG and tb.seg_box.shape == (6, tb.n_seg)
    assert tb.seg_c > 0.0 and tb.seg_inv_r > 0.0
    # the groups: every segment once, in order, SEG_GROUP at most (the large
    # spheres' segments one group)
    gstart = tb.grp_start.long()
    gsizes = gstart[1:] - gstart[:-1]
    n_large = int(torch.isinf(tb.seg_box[0]).sum())
    assert gstart[0] == 0 and gstart[-1] == tb.n_seg and bool((gsizes > 0).all())
    assert int(gsizes[int(n_large > 0):].max()) <= cw.SEG_GROUP
    assert tb.grp_box.shape == (6, tb.n_grp) and (n_large == 0 or int(gsizes[0]) == n_large)


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("level", ["segment", "group"])
def test_every_sphere_lies_inside_its_box(name, level):
    """In its segment's box and in its group's, at tm 0 and 1; a large
    sphere's boxes are infinite (always swept), and the ray's padding only
    grows a box."""
    scene = _scene(name)
    tb = _tables(name)
    s = scene.spheres
    seg_of = torch.repeat_interleave(torch.arange(tb.n_seg),
                                     (tb.seg_start[1:] - tb.seg_start[:-1]).long())
    seg_of_sphere = torch.empty_like(seg_of)
    seg_of_sphere[tb.seg_order.long()] = seg_of
    box = tb.seg_box
    if level == "group":
        grp_of = torch.repeat_interleave(torch.arange(tb.n_grp),
                                         (tb.grp_start[1:] - tb.grp_start[:-1]).long())
        seg_of_sphere, box = grp_of[seg_of_sphere], tb.grp_box
    lo, hi = box[:3, seg_of_sphere].T, box[3:, seg_of_sphere].T
    for tm in (0.0, 1.0):
        c = s.center + tm * s.velocity
        assert bool((lo <= c - s.radius[:, None]).all() and (c + s.radius[:, None] <= hi).all())
    large = s.radius > cw.SEG_LARGE * s.radius.median()
    assert bool(torch.isinf(lo[large]).all()) and bool(torch.isfinite(lo[~large]).all())
    assert int(large.sum()) == (1 if name == "ground_sphere" else 0)
    if name == "ground_sphere":   # the large sphere leads, in a segment and group of its own
        assert int(tb.seg_start[1]) == 1 and bool(large[int(tb.seg_order[0])])
        assert int(tb.grp_start[1]) == 1


def test_below_cull_min_the_brute_sweep():
    tb = cw.build_tables(build_sphere_cloud(grtt, n_spheres=63, seed=1, device="cpu"))
    assert tb.n_seg == 0 and tb.seg_box is None
    o, d, tm = _rays(_tables("64"))
    with pytest.raises(ValueError, match="no segments"):
        cw.culled_sweep_counts(cw._wavefront_fwd_plain, tb, o, d, tm,
                               torch.arange(tm.shape[0], dtype=torch.int32), 0, 2)


def _t_init(n, seed):
    """Where the sphere sweep starts: BIG (no planar hit), a planar hit at
    some distance, or 0 (a dead lane)."""
    r = np.random.default_rng(seed)
    t = np.where(r.random(n) < 0.6, cw.BIG, r.uniform(0.5, 15.0, n)).astype(np.float32)
    t[r.random(n) < 0.05] = 0.0
    return torch.from_numpy(t)


def _one_level(tb):
    """The same segments in one group under an infinite box: the one-level
    sweep (every segment box tested by every ray)."""
    inf = torch.full((6, 1), float("inf"))
    inf[:3] = -inf[:3]
    return tb._replace(grp_start=torch.tensor([0, tb.n_seg], dtype=torch.int32),
                       grp_box=inf, n_grp=1)


@pytest.mark.parametrize("name, order", [(name, "spatial") for name in SCENES]
                         + [("cloud", "reversed"), ("ground_sphere", "reversed")]
                         + [(name, "one_level") for name in CULL_CASES if name != "63"])
def test_culled_sweep_gives_the_brute_winner(name, order):
    """Closest hit at the rays' own times and any hit at time 0 (the shadow
    sweep): t's bits, kind and scene index are the brute sweep's.  With each
    segment swept in reversed order a duplicated sphere's later copy comes
    first: the lower index still wins.  ``one_level``: on the set of
    ``cull_case`` (rays at segment and group boxes), the one-level sweep's
    winners too, with the same sphere tests and no more segment box tests
    in two levels."""
    if order == "one_level":
        _, tb, o, d, tm, _ = cull_case(grtt, cw, name, "cpu", n_random=16)
    else:
        tb = _tables(name)
        if order == "reversed":
            tb = tb._replace(seg_order=reverse_within_segments(tb.seg_order, tb.seg_start))
        o, d, tm = _rays(tb, seed=len(name))
    n = tm.shape[0]
    zero_i = torch.zeros(n, dtype=torch.int32)
    t0 = _t_init(n, seed=7)
    counts = dict.fromkeys(cw.SWEEP_COUNTS, 0)
    want = cw._sphere_sweep(tb, o, d, tm, t0, zero_i, zero_i)
    got = cw._sphere_sweep_culled(tb, o, d, tm, t0, zero_i, zero_i, counts, "closest")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    hits = int((want[1] == 1).sum())
    assert hits > n // 10
    assert 0 < counts["closest_sphere_tests"] < int((t0 > cw.EPS_HIT).sum()) * tb.n_sphere
    any_want = cw._sphere_sweep(tb, o, d, torch.zeros(n), t0, zero_i, zero_i)[1] > 0
    any_got = cw._sphere_sweep_culled(tb, o, d, torch.zeros(n), t0, zero_i, zero_i, counts,
                                      "shadow", any_hit=True)[1] > 0
    assert torch.equal(any_got, any_want)
    if order == "one_level":
        one = dict.fromkeys(cw.SWEEP_COUNTS, 0)
        got1 = cw._sphere_sweep_culled(_one_level(tb), o, d, tm, t0, zero_i, zero_i, one,
                                       "closest")
        for a, b in zip(got1, want):
            assert torch.equal(a, b)
        assert one["closest_sphere_tests"] == counts["closest_sphere_tests"]
        assert counts["closest_box_tests"] <= one["closest_box_tests"]


def test_duplicates_tie_to_the_lower_index():
    """A ray aimed at a duplicated sphere's centre hits both copies at the
    same t, in either sweep order: the lower index wins."""
    scene = _scene("cloud")
    tb = _tables("cloud")
    n = tb.n_sphere
    c = scene.spheres.center[:4]            # spheres 0-3 and their copies n-4..n-1
    assert torch.equal(c, scene.spheres.center[n - 4:])
    o = V3(*(c + torch.tensor([0.0, 20.0, 0.5])).T.contiguous())
    d = V3(*torch.tensor([[0.0, -1.0, -0.02]] * 4).T.contiguous())
    tm = torch.zeros(4)
    zero_i = torch.zeros(4, dtype=torch.int32)
    want = cw._sphere_sweep(tb, o, d, tm, torch.full((4,), cw.BIG), zero_i, zero_i)
    for order in (tb.seg_order, reverse_within_segments(tb.seg_order, tb.seg_start)):
        got = cw._sphere_sweep_culled(tb._replace(seg_order=order), o, d, tm,
                                      torch.full((4,), cw.BIG), zero_i, zero_i,
                                      dict.fromkeys(cw.SWEEP_COUNTS, 0), "closest")
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert bool((want[1] == 1).all()) and bool((want[2] < 4).all())


@pytest.mark.parametrize("name, mode", [
    pytest.param(name, mode, id=name if mode == "record" else f"{name}-{mode}")
    for mode in ("record", "forward", "resume") for name in ("random", "cloud")])
def test_record_with_the_culled_sweep_is_the_plain_record(name, mode):
    """The plain version of each kernel that sweeps culled, with the culled
    sweep mirrored (what the kernel runs), against the plain version
    (brute): the record (B6) and the forward (B1) at depth 2, and the
    resumable kernel (B11) over bounces [0, 2) and then [2, 5) of the state
    the first launch left: radiance, flags, record and state the same bits;
    the sweep needs fewer sphere tests than the brute sweep's.  The
    wrappers launch the kernels' culled instantiations for these tables."""
    tb = _tables(name)
    assert cw.brute_route(tb) == "culled"
    if name == "random":
        _, cam = _small_random()
        cam = dataclasses.replace(cam, image_width=16, aspect_ratio=1.0)
        ids = torch.arange(16 * 16)
        o, d, tm = tcamera.generate_rays(cam, ids % 16, ids // 16, ids, 5)
    else:
        o, d, tm = _rays(tb, seed=3)
        ids = torch.arange(tm.shape[0])
    sid = cw.stream_to_i32(ids)

    def mirrored(plain, *args):
        want = plain(tb, *args)
        got, counts = cw.culled_sweep_counts(plain, tb, *args)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        ray_bounces = counts["closest_group_box_tests"] // tb.n_grp
        assert 0 < counts["closest_sphere_tests"] < ray_bounces * tb.n_sphere
        assert counts["closest_sphere_tests"] <= counts["closest_warp_sphere_tests"]
        assert counts["closest_box_tests"] <= counts["closest_warp_box_tests"]
        if name == "cloud":   # a quad light: shadow sweeps, culled too
            assert counts["shadow_group_box_tests"] > 0
        return want

    if mode == "resume":   # five bounces: the first 256 rays
        o, d = V3(*(c[:256] for c in o)), V3(*(c[:256] for c in d))
        flat = cw._start_state(o, d, tm[:256], sid[:256])
        out = mirrored(cw._wavefront_resume_plain, flat, 5, 0, 2)
        mirrored(cw._wavefront_resume_plain, cw._resumed_state(flat, out), 5, 2, 5)
    else:
        plain = cw._wavefront_record_plain if mode == "record" else cw._wavefront_fwd_plain
        mirrored(plain, o, d, tm, sid, 5, 2)
