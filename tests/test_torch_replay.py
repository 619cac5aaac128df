"""PyTorch port vs the JAX package: the replay tier's record and replay.

``trace(record=True)`` returns the discrete outcome of every bounce's sweeps
(``Decisions``), from the standard integrator or from the megakernel's
record kernel (B6, here its plain version: the tensors lie on the CPU);
``trace(decisions=...)`` replays them under ``torch.autograd`` without a
sweep.  Inputs: 768 camera rays of a 32-pixel camera, 2 samples, depth 4,
made from one seed in both packages.

Records.  A ray that did not enter a bounce alive reads "no hit" in the
port's records.  The JAX package's standard record keeps there what its
masked loop computed (a dead lane's free flight may still pick a medium), so
its record is brought to the port's form first, by the lanes' liveness
replayed from the record itself (``_canonical``; the scenes compared hold no
metal, so a hit kills a ray exactly when it is a light's).  Ties between
equally distant primitives may break differently between sweep orders, and
a mesh hit's distance differs in its last bits between the packages (XLA
fuses multiply-adds on the CPU): a ray's records may part at some bounce,
and the ray then follows another path.  Each field must agree on at least
99.9 % of the ray-bounces compared, every bounce of a ray up to the first
where its records part; the measured shares are printed (``pytest -s``).

The replay's gradients against the JAX package's are held in
tests/test_torch_replay_megakernel.py, and the mesh scene's record in
tests/test_torch_replay_render.py, where the JAX package's ``render_grad``
has compiled what they need; no JAX gradient is compiled here.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import go_raytracing_tpu as grt
import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu.camera import generate_rays as j_generate_rays
from go_raytracing_tpu.integrator import wavefront as jwf
from go_raytracing_tpu.ops import pallas_wavefront as jmega
from go_raytracing_tpu_torch import camera as tcamera
from go_raytracing_tpu_torch.core.vec3 import V3
from go_raytracing_tpu_torch.integrator import wavefront as twf
from go_raytracing_tpu_torch.materials import textures as ttex
from go_raytracing_tpu_torch.ops import cuda_rows
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from go_raytracing_tpu_torch.render import renderer as trenderer
from test_torch_helpers import port_and_jax

torch.set_num_threads(2)

SEED = 3
N_RAYS = 768
MIN_SHARE = 0.999
FIELDS = ("which", "idx", "aux", "blk_a", "blk_h")


def _cam_fields(name):
    _, cam = grt.load_scene(name)
    return dict(dataclasses.asdict(cam), image_width=32, aspect_ratio=1.0,
                samples_per_pixel=2, max_depth=4)


def _rays(jcam, tcam):
    """The same camera rays in both packages: (JAX o, d, tm, stream; port
    o, d, tm, stream)."""
    js = jnp.arange(N_RAYS, dtype=jnp.uint32)
    w, h = jcam.image_width, jcam.image_height
    jo, jd, jtm = j_generate_rays(jcam, (js % w).astype(jnp.int32),
                                  ((js // w) % h).astype(jnp.int32), js, SEED)
    ts = torch.arange(N_RAYS, dtype=torch.int64)
    to, td, ttm = tcamera.generate_rays(tcam, ts % w, (ts // w) % h, ts, SEED)
    return (jo, jd, jtm, js), (to, td, ttm, ts)


def _material_of_winner(scene, which, idx, aux):
    """Material id of each recorded winner ([D, R] numpy); -1 for no hit."""
    mat = np.full(which.shape, -1, np.int64)
    tables = {twf.HIT_SPHERE: scene.spheres.mat, twf.HIT_PLANAR: scene.planar.mat,
              twf.HIT_VOLUME: scene.volumes.mat}
    for kind, tab in tables.items():
        tab = np.asarray(tab)
        sel = which == kind
        if sel.any():
            mat[sel] = tab[np.clip(idx[sel], 0, len(tab) - 1)]
    for mi, proto in enumerate(scene.meshes):
        sel = which == twf.HIT_MESH_BASE + mi
        mat[sel] = np.asarray(proto.inst_mat)[aux[sel]]
    return mat


def _canonical(scene, dec):
    """A record (either package's, as numpy) with every ray-bounce that the
    ray did not enter alive set to no hit, idx 0, aux 0, not blocked."""
    kinds = np.asarray(scene.materials.kind)
    assert not (kinds == 1).any(), "liveness replay needs a scene without metal"
    d = {f: np.array(getattr(dec, f)) for f in FIELDS}
    alive = np.ones(d["which"].shape[1], bool)
    for b in range(d["which"].shape[0]):
        hit = alive & (d["which"][b] != twf.HIT_NONE)
        for f in FIELDS:
            d[f][b] = np.where(hit, d[f][b], 0)
        mat = _material_of_winner(scene, d["which"][b:b + 1], d["idx"][b:b + 1],
                                  d["aux"][b:b + 1])[0]
        alive = hit & (kinds[np.clip(mat, 0, None)] != 3)   # a light ends the path
    return d


def _shares(a, b):
    """Share of ray-bounces on which each field of two records agrees.  A
    ray whose records part at some bounce follows another path from there
    on, so its later bounces are not compared: a share counts where the
    records part, not what follows from it."""
    same = {f: np.asarray(a[f]) == np.asarray(b[f]) for f in FIELDS}
    all_same = np.logical_and.reduce([same[f] for f in FIELDS])
    # compared: every bounce up to and including the first that differs
    compared = np.ones_like(all_same)
    compared[1:] = np.logical_and.accumulate(all_same[:-1], axis=0)
    return {f: float(same[f][compared].mean()) for f in FIELDS}


def _to_numpy(dec):
    return {f: np.asarray(getattr(dec, f)) for f in FIELDS}


@pytest.fixture(scope="module")
def records():
    """Cornell and cornell-smoke (box fog) recorded by the standard
    integrators of both packages."""
    out = {}
    for name in ("cornell", "cornell-smoke"):
        js, jcam, ts, tcam = port_and_jax(lambda pkg: pkg.load_scene(name)[0],
                                          _cam_fields(name))
        jr, tr = _rays(jcam, tcam)
        _, j_dec = jwf.trace(js, jcam, *jr, 0, differentiable=False, record=True,
                             mega_mode="off")
        out[name] = (js, jcam, jr, ts, tcam, tr, _canonical(js, j_dec))
    return out


def test_standard_record_keeps_the_radiance():
    """The standard integrator's record is the trace itself: the same bits
    as ``trace()`` without recording, and [D, R] decisions."""
    _, jcam, ts, tcam = port_and_jax(lambda pkg: pkg.load_scene("cornell")[0],
                                     _cam_fields("cornell"))
    _, (o, d, tm, ids) = _rays(jcam, tcam)
    plain = twf.trace(ts, tcam, o, d, tm, ids, 0, mega_mode="off")
    rad, dec = twf.trace(ts, tcam, o, d, tm, ids, 0, mega_mode="off", record=True)
    assert torch.equal(plain.rows(), rad.rows())
    for f, dtype in zip(FIELDS, (torch.uint8,) + (torch.int32,) * 2 + (torch.bool,) * 2):
        assert getattr(dec, f).shape == (tcam.max_depth, N_RAYS)
        assert getattr(dec, f).dtype == dtype
    assert not dec.blk_h.any()
    # the two routes of the standard integrator record the same outcomes
    _, dec2 = twf.trace(ts, tcam, o, d, tm, ids, 0, mega_mode="off", record=True,
                        differentiable=True)
    for f in FIELDS:
        assert torch.equal(getattr(dec, f), getattr(dec2, f)), f


def held_bytes(dec):
    """Bytes the tensors of a record hold (a broadcast field holds one
    element)."""
    return sum(getattr(dec, f).untyped_storage().nbytes() for f in FIELDS)


@pytest.mark.parametrize("mega_mode", ["single", "off"])
def test_records_hold_what_the_budget_charges(mega_mode):
    """Both recorders keep ``decision_bytes`` a ray-bounce (6 B without
    meshes: which, idx, blk_a), which is what ``render_grad``'s
    ``dec_budget`` test charges; fields that are 0 everywhere (aux without
    meshes, blk_h) are one element each."""
    from go_raytracing_tpu_torch.render import grad as tgrad

    ts, tcam = grtt.load_scene("cornell", device="cpu")
    tcam = dataclasses.replace(tcam, max_depth=3)
    r = 256
    ids = torch.arange(r)
    o, d, tm = tcamera.generate_rays(tcam, ids % 16, ids // 16, ids, SEED)
    _, dec = twf.trace(ts, tcam, o, d, tm, ids, SEED, mega_mode=mega_mode, record=True)
    charged = r * tgrad.dec_bytes_per_ray(ts, tcam.max_depth)
    assert twf.decision_bytes(ts) == 6
    assert charged <= held_bytes(dec) <= charged + 8
    assert dec.aux.stride() == (0, 0) and dec.blk_h.stride() == (0, 0)


def check_record_shares(name, dec, j_dec):
    """The port's record against the JAX package's (brought to the port's
    form), field by field."""
    shares = _shares(_to_numpy(dec), j_dec)
    print(f"\n{name}: share of ray-bounces equal to the JAX record {shares}")
    assert min(shares.values()) >= MIN_SHARE, shares
    assert (j_dec["which"] != twf.HIT_NONE).mean() > 0.1    # the record is not empty


@pytest.mark.parametrize("name", ["cornell", "cornell-smoke"])
def test_standard_record_matches_the_jax_package(name, records):
    _, _, _, ts, tcam, (o, d, tm, ids), j_dec = records[name]
    _, dec = twf.trace(ts, tcam, o, d, tm, ids, 0, mega_mode="off", record=True)
    check_record_shares(name, dec, j_dec)


def test_record_kernel_plain_version(records):
    """B6's plain version: its radiance and flags are B1's plain version's
    bits; its decisions equal the JAX megakernel's record (Pallas, interpret
    mode) and the port's standard record on >= 99.9 % of ray-bounces."""
    js, jcam, jr, ts, tcam, (o, d, tm, ids), _ = records["cornell"]
    tb = cw.build_tables(ts)
    args = (tb, o, d, tm, cw.stream_to_i32(ids), 0, tcam.max_depth)
    f_out, f_flags = cw._wavefront_fwd_plain(*args)
    r_out, r_flags, code, idx = cw.wavefront_record(*args)
    assert torch.equal(r_out, f_out) and torch.equal(r_flags, f_flags)
    assert code.dtype == torch.uint8 and tuple(code.shape) == (tcam.max_depth, N_RAYS)

    _, dec_m = twf.trace(ts, tcam, o, d, tm, ids, 0, mega_mode="single",
                         record=True)
    _, dec_s = twf.trace(ts, tcam, o, d, tm, ids, 0, mega_mode="off", record=True)
    old = jmega.INTERPRET
    jmega.INTERPRET = True
    try:
        assert jmega.applicable(js)
        _, j_dec = jwf.trace(js, jcam, *jr, 0, differentiable=False,
                             record=True, mega_mode="single")
    finally:
        jmega.INTERPRET = old
    port = _to_numpy(dec_m)
    vs_jax = _shares(port, _canonical(js, j_dec))
    vs_std = _shares(port, _to_numpy(dec_s))
    print(f"\nrecord kernel (plain): equal to the JAX kernel's {vs_jax}, "
          f"to the standard record {vs_std}")
    assert min(vs_jax.values()) >= MIN_SHARE, vs_jax
    assert min(vs_std.values()) >= MIN_SHARE, vs_std
    assert not dec_m.aux.any() and dec_m.blk_a.any()


def test_replay_equals_the_recorded_radiance_outside_the_jax_package():
    """Round and polyhedral fog (the JAX package's replay solves only box
    media's entry): the replay's radiance is the record's."""
    from test_torch_helpers import FOG_ROOM_CAM, build_fog_room

    ts = build_fog_room(grtt, device="cpu")
    tcam = grtt.Camera(**dict(FOG_ROOM_CAM, image_width=16, max_depth=3))
    ids = torch.arange(512)
    o, d, tm = tcamera.generate_rays(tcam, ids % 16, (ids // 16) % 16, ids, SEED)
    rad, dec = twf.trace(ts, tcam, o, d, tm, ids, 0, record=True)
    assert (dec.which == twf.HIT_VOLUME).sum() > 10
    rep = twf.trace(ts, tcam, o, d, tm, ids, 0, decisions=dec)
    torch.testing.assert_close(rep.rows().detach(), rad.rows(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cols", [1, 3])
def test_take_rows_sums_in_a_fixed_order(cols):
    """C7: ``take_rows``' gradient equals ``index_select``'s (float32
    rounding: the plain version adds in float64) and has the same bits on
    every backward pass."""
    rng = np.random.default_rng(7)
    shape = (9, cols) if cols > 1 else (9,)
    table = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 8, size=20000))    # row 8 unused
    g = torch.from_numpy(rng.normal(size=(20000,) + shape[1:]).astype(np.float32))
    outs = []
    for _ in range(2):
        t = table.clone().requires_grad_()
        (got,) = torch.autograd.grad(ttex.take_rows(t, idx), t, g)
        outs.append(got)
    t = table.clone().requires_grad_()
    (ref,) = torch.autograd.grad(torch.index_select(t, 0, idx), t, g)
    torch.testing.assert_close(outs[0], ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
    assert torch.equal(outs[0], outs[1])
    assert float(outs[0][8].abs().max()) == 0.0
    # without a gradient to take, take_rows is index_select itself
    assert ttex.take_rows(table, idx).grad_fn is None
    torch.testing.assert_close(cuda_rows.row_sums(g, idx, 9), outs[0])


def _checker_statues():
    """Two statues and a floor under one checker texture, a quad light."""
    from go_raytracing_tpu_torch.geometry.scene import Affine
    from go_raytracing_tpu_torch.io import obj

    b = grtt.SceneBuilder()
    chk = b.lambertian(b.checker(7.0, (0.2, 0.3, 0.1), (0.9, 0.9, 0.8)))
    b.quad((0, 0, 0), (555, 0, 0), (0, 0, 555), chk)
    b.add_light(b.quad((213, 554, 227), (130, 0, 0), (0, 0, 105),
                       b.diffuse_light((15, 14, 13))))
    proto = b.mesh(*obj.lucy_standin(12, 10))
    for pos, rot in (((150, 0, 150), 30), ((400, 0, 150), -20)):
        b.mesh_instance(proto, chk, Affine.trs(scale=(0.15, 0.15, 0.15),
                                               rotation_deg=(0, rot, 0), position=pos))
    cam = grtt.Camera(image_width=64, aspect_ratio=1.0, samples_per_pixel=4, max_depth=3,
                      look_from=(278, 278, -800), look_at=(278, 278, 0), vfov=40.0)
    return b.build(device="cpu"), cam, ([50, 1, 50], [500, 300, 500])


def _checker_fog():
    """A checker floor, and a round and a box fog whose colour is the same
    fine checker, under a quad light."""
    b = grtt.SceneBuilder()
    chk = b.checker(0.37, (0.2, 0.3, 0.1), (0.9, 0.9, 0.8))
    b.quad((-5, 0, -5), (10, 0, 0), (0, 0, 10), b.lambertian(chk))
    b.add_light(b.quad((-1.5, 7.9, -1.5), (3, 0, 0), (0, 0, 3),
                       b.diffuse_light((13, 12, 11))))
    b.volume_sphere((0.0, 2.0, -1.0), 2.0, 0.35, chk)
    b.volume_box((1, 0, -3), (3, 2, -1), 0.5, chk)
    cam = grtt.Camera(image_width=64, aspect_ratio=1.0, samples_per_pixel=4, max_depth=3,
                      look_from=(0, 3, 9), look_at=(0, 1.5, 0), vfov=45.0)
    return b.build(device="cpu"), cam, ([-4, 0.2, -4], [4, 6, 4])


def replay_distance_parity(scene, o, d, seed=0):
    """For the mesh hits and the volume entries of one sweep: (winners,
    replayed distances that differ from the sweep's in any bit, texture
    reads at the hit point that differ).  The replay recomputes a winner's
    distance (``_winner_t``); a checker's parity flips where the hit point
    moves by an ulp."""
    from go_raytracing_tpu_torch.integrator.wavefront import HIT_MESH_BASE, HIT_VOLUME

    r = o.x.shape[0]
    tm, stream = torch.zeros(r), torch.arange(r)
    t, which, idx, aux, _ = twf.closest_hit(scene, o, d, tm, 1e-3,
                                            torch.full((r,), 3e38), seed, stream, 0)
    t_rep = twf._winner_t(scene, o, d, tm, 1e-3, which, idx, aux, seed, stream, 0)
    reads = []
    for dist in (t, t_rep):
        p, _, _, u, v, mat = twf.extract_record(scene, o, d, tm, dist, which, idx, aux)
        reads.append(torch.stack(list(ttex.evaluate(
            scene.textures, scene.materials.tex[mat.long()], u, v, p))))
    read_differs = (reads[0] != reads[1]).any(dim=0)
    out = {}
    for name, won in (("mesh", which >= HIT_MESH_BASE), ("volume", which == HIT_VOLUME)):
        out[name] = (int(won.sum()), int((won & (t != t_rep)).sum()),
                     int((won & read_differs).sum()))
    return out


@pytest.mark.parametrize("build, kind", [(_checker_statues, "mesh"),
                                         (_checker_fog, "volume")])
def test_replay_distance_of_mesh_hits_and_volume_entries_is_the_sweeps(build, kind):
    """The replay's distance of a mesh hit (Moller-Trumbore in the
    instance's space) and of a volume entry (free flight from the entry
    point) is the sweep's to the bit, so every checker read after such a
    hit is the record's: on the camera rays of a 64-pixel, 4-sample frame
    and on 16,384 rays from inside the scene in random directions."""
    scene, cam, (lo, hi) = build()
    spp = cam.samples_per_pixel
    _, o, d, _, _, _, _ = trenderer._chunk_rays(scene, cam, 0, 0, spp=spp,
                                                chunk=64 * 64 * spp, max_depth=3,
                                                device="cpu")
    rng = np.random.default_rng(1)
    inside = (rng.uniform(lo, hi, size=(16384, 3)).T.astype(np.float32),
              rng.normal(size=(3, 16384)).astype(np.float32))
    for rays in ((o, d), tuple(V3(*torch.from_numpy(a.copy())) for a in inside)):
        won, t_differs, read_differs = replay_distance_parity(scene, *rays)[kind]
        assert won > 500, won
        assert (t_differs, read_differs) == (0, 0)


def test_replay_distance_of_a_box_fog_is_the_megakernels():
    """Box fog lies inside the megakernel's gate, so the record kernel (B6)
    takes its distance: the replay's free flight is its plain version's
    (``cuda_wavefront._volume_scatter``, the kernel's arithmetic) to the bit
    on every entry of 16,384 rays from inside the scene."""
    b = grtt.SceneBuilder()
    chk = b.checker(0.37, (0.2, 0.3, 0.1), (0.9, 0.9, 0.8))
    b.quad((-5, 0, -5), (10, 0, 0), (0, 0, 10), b.lambertian(chk))
    b.add_light(b.quad((-1.5, 7.9, -1.5), (3, 0, 0), (0, 0, 3),
                       b.diffuse_light((13, 12, 11))))
    b.volume_box((-2, 0, -3), (2, 3, 1), 0.5, chk)
    b.volume_box((1, 0, -3), (3, 2, -1), 0.9, chk)
    scene = b.build(device="cpu")
    assert cw.applicable(scene)
    tb = cw.build_tables(scene)
    rng = np.random.default_rng(2)
    n = 16384
    o = V3(*torch.from_numpy(rng.uniform([-4, 0.2, -4], [4, 6, 4], (n, 3))
                             .T.astype(np.float32).copy()))
    d = V3(*torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32)))
    stream, tm = torch.arange(n), torch.zeros(n)
    u = twf._volume_uniforms(0, stream, 0, twf.PURPOSE_VOL_MAIN, scene.n_volumes)
    for vi in range(scene.n_volumes):
        entered, t_kernel = cw._volume_scatter(tb, list(o), list(d),
                                               torch.full((n,), 1e30), vi, u[:, vi])
        idx = torch.full((n,), vi, dtype=torch.int32)
        t_rep = twf._winner_t(scene, o, d, tm, 1e-3,
                              torch.full((n,), twf.HIT_VOLUME, dtype=torch.int32), idx,
                              torch.zeros_like(idx), 0, stream, 0)
        assert int(entered.sum()) > 500
        assert torch.equal(t_kernel[entered], t_rep[entered])
