"""PyTorch port vs the JAX package: the resumable megakernel (B11) and the
megakernel's two-phase modes, 'split' and 'compact'.

* The plain version of the resumable kernel against the JAX package's
  ``_call_resume`` (Pallas, interpret mode) on 512 rays of the mixed scene:
  the same carried state (the port's bounces [0, 2)) in, bounces [2, 5)
  run, all 19 outputs compared.  Flag words equal on every ray; the float
  rows within rtol / atol 1e-4 on 99 % of rays (XLA fuses multiply-adds on
  the CPU, PyTorch does not, so an ulp may flip a discrete decision and
  change a ray wholly; none did when this was written).
* ``_phase_state_sort`` and ``_compact_partition`` against the JAX
  package's on a state drawn with numpy: the same permutation and the same
  moved rows, bit for bit.
* ``trace(mega_mode="split" | "compact")`` against ``"single"`` with the
  split thresholds lowered (as tests/test_pallas.py does for the JAX
  package): 'split' bit for bit; 'compact' bit for bit where no light adds
  radiance (perlin), and within 2 ulp a ray where both of its phases add
  some (its phase-2 radiance starts at zero and is added to phase 1's, as
  in the JAX package).  A record is single-phase whatever the mode.
* ``choose_mega_mode`` against the JAX package's on a table of scenes,
  depths and ray counts (pure Python).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import go_raytracing_tpu as grt
import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu import camera as jcamera
from go_raytracing_tpu.integrator import wavefront as jwf
from go_raytracing_tpu.ops import pallas_wavefront as jmega
from go_raytracing_tpu_torch import camera as tcamera
from go_raytracing_tpu_torch import convert
from go_raytracing_tpu_torch.integrator import wavefront as twf
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from test_torch_helpers import (ENV_NEE_CAM, FOG_ROOM_CAM, MARBLE_CAM, MINI_HDRI_CAM,
                                MIXED_CAM, build_env_nee, build_fog_room,
                                build_marble, build_mini_hdri, build_mixed,
                                scene_tree)

torch.set_num_threads(2)


def _rays(cam, n, seed):
    ids = torch.arange(n, dtype=torch.int64)
    px = ids % cam.image_width
    py = (ids // cam.image_width) % cam.image_height
    o, d, tm = tcamera.generate_rays(cam, px, py, ids, seed)
    return o, d, tm, ids


def test_plain_resume_matches_jax_call_resume():
    js = build_mixed(grt)
    jcam = jcamera.Camera(**MIXED_CAM)
    ts = convert.scene_from_numpy(scene_tree(js), "cpu")
    tcam = convert.camera_from_dict(dataclasses.asdict(jcam))
    seed = 2
    o, d, tm, ids = _rays(tcam, 512, seed)
    tb = cw.build_tables(ts)
    flat = cw._start_state(o, d, tm, ids)
    flat2 = cw._resumed_state(flat, cw.wavefront_resume(tb, flat, seed, 0, 2))
    port = [a.numpy() for a in cw.wavefront_resume(tb, flat2, seed, 2, 5)]
    # the same as one loop over [0, 5)
    one, one_flags = cw._wavefront_fwd_plain(tb, o, d, tm, flat[7], seed, 5)
    assert np.array_equal(np.stack(port[0:9]), one.numpy())
    assert np.array_equal(port[9], one_flags.numpy())

    (pt, st, sb, vt, lt, n_planar, n_sphere, n_sph_seg, n_vol,
     n_lights) = jmega.build_tables(js, sph_seg=jmega.SPH_SEG)
    jflat = tuple(jnp.asarray(a.numpy().view(np.uint32)) if i == 7
                  else jnp.asarray(a.numpy()) for i, a in enumerate(flat2))
    old = jmega.INTERPRET
    jmega.INTERPRET = True
    try:
        ref = jmega._call_resume(
            pt, st, sb, vt, lt, jnp.uint32(seed), jflat, n_planar=n_planar,
            n_sphere=n_sphere, n_sph_seg=n_sph_seg, n_vol=n_vol, n_lights=n_lights,
            has_checker=js.has_checker, max_depth=5, b_start=2, b_end=5,
            block_rows=jmega.BLOCK_ROWS, sph_seg=jmega.SPH_SEG, has_noise=False)
        ref = [np.asarray(a) for a in ref]
    finally:
        jmega.INTERPRET = old
    assert len(ref) == len(port) == cw.RESUME_OUT_ROWS
    np.testing.assert_array_equal(port[9], ref[9])
    rows = [i for i in range(19) if i != 9]
    bad = ~np.isclose(np.stack([port[i] for i in rows]),
                      np.stack([ref[i] for i in rows]), rtol=1e-4, atol=1e-4).all(axis=0)
    assert bad.mean() < 0.01, bad.mean()
    flags = port[9]
    # every kind of ray went through: missed in phase 1, missed in phase 2,
    # alive at the end, radiance picked up before the cut
    assert ((flags & 1) != 0).any() and ((flags & 4) != 0).any()
    assert ((flat2[14].numpy() & 1) == 0).any() and (flat2[11].numpy() > 0).any()


def _random_state(n=4096, seed=0):
    """A 21-row state drawn with numpy: origins spread over a box (a few
    rays far out), directions in every octant, a third of the rays dead."""
    r = np.random.default_rng(seed)
    f = lambda *s: r.normal(size=s).astype(np.float32)
    o = f(3, n) * 3
    o[:, :8] *= 100
    rows = [o[0], o[1], o[2], *f(3, n), r.random(n).astype(np.float32),
            r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
            *np.abs(f(3, n)), *np.abs(f(3, n))]
    alive = r.random(n) > 1 / 3
    flags = (alive * 4 + (r.random(n) > 0.5) * 8 + (~alive & (r.random(n) > 0.5)) * 1
             + (~alive & (r.random(n) > 0.7)) * 2).astype(np.int32)
    rows += [flags, *f(3, n), *np.abs(f(3, n))]
    return rows, alive


def _to_port(rows):
    return tuple(torch.from_numpy(a.view(np.int32).copy() if a.dtype == np.uint32 else a)
                 for a in rows)


def test_phase_state_sort_matches_jax():
    rows, alive = _random_state()
    j_out, j_inv = jmega._phase_state_sort(tuple(jnp.asarray(a) for a in rows),
                                           jnp.asarray(alive))
    t_out, t_inv = cw._phase_state_sort(_to_port(rows), torch.from_numpy(alive))
    np.testing.assert_array_equal(t_inv.numpy(), np.asarray(j_inv))
    for i, (a, b) in enumerate(zip(t_out, j_out)):
        b = np.asarray(b)
        np.testing.assert_array_equal(a.numpy().view(b.dtype), b, err_msg=str(i))
    # the live rays come first, the dead sink to the back
    n_live = int(alive.sum())
    assert (t_out[14][:n_live] & 4).all() and not (t_out[14][n_live:] & 4).any()


def test_compact_partition_matches_jax():
    rows, alive = _random_state(seed=1)
    rows12 = rows[0:11] + [rows[14]]
    j_flat, j_pos = jmega._compact_partition(tuple(jnp.asarray(a) for a in rows12),
                                             jnp.asarray(alive))
    t_flat, t_pos = cw._compact_partition(_to_port(rows12), torch.from_numpy(alive))
    np.testing.assert_array_equal(t_pos.numpy(), np.asarray(j_pos))
    assert len(t_flat) == len(j_flat) == cw.RESUME_IN_ROWS
    for i, (a, b) in enumerate(zip(t_flat, j_flat)):
        b = np.asarray(b)
        np.testing.assert_array_equal(a.numpy().view(b.dtype), b, err_msg=str(i))


@pytest.mark.parametrize("mode, name", [
    ("split", "perlin"), ("compact", "perlin"), ("split", "mixed"),
    ("compact", "mixed"), ("split", "env-nee"),
])
def test_two_phase_modes_equal_single(monkeypatch, mode, name):
    """The module docstring says what each case holds."""
    if name == "perlin":
        ts, cam = grtt.load_scene("perlin", device="cpu")
        cam = dataclasses.replace(cam, image_width=24, samples_per_pixel=2, max_depth=9)
    elif name == "mixed":
        ts, cam = build_mixed(grtt, device="cpu"), tcamera.Camera(**MIXED_CAM)
        cam = dataclasses.replace(cam, max_depth=9)
    else:
        ts, cam = build_env_nee(grtt, device="cpu"), tcamera.Camera(**ENV_NEE_CAM)
        cam = dataclasses.replace(cam, max_depth=7)
        assert cw.uses_hdri_nee(ts)
    o, d, tm, ids = _rays(cam, 512, 4)
    single = twf.trace(ts, cam, o, d, tm, ids, 4, mega_mode="single").rows()
    monkeypatch.setattr(cw, "SPLIT_R_MIN", 1)
    monkeypatch.setattr(cw, "SPLIT_DEPTH_MIN", 1)
    picked = twf.choose_mega_mode(ts, cam, 512, False)
    assert picked == ("single" if name == "env-nee" else "split")
    if mode == "split" and name != "env-nee":
        two = twf.trace(ts, cam, o, d, tm, ids, 4).rows()   # picked by itself
    else:
        two = twf.trace(ts, cam, o, d, tm, ids, 4, mega_mode=mode).rows()
    assert float(single.mean()) > 0.01
    if mode == "split" or name == "perlin":
        assert torch.equal(two, single)
    else:
        torch.testing.assert_close(two, single, rtol=2.4e-7, atol=0.0)
    # the record runs one phase whatever the mode, with single's radiance
    rec, dec = twf.trace(ts, cam, o, d, tm, ids, 4, mega_mode=mode, record=True)
    assert torch.equal(rec.rows(), single) and dec.idx.shape == (cam.max_depth, 512)


def _table_scenes():
    """(name, JAX scene, port scene, camera fields) of the table."""
    out = []
    for name, build, cam in (("mixed", build_mixed, MIXED_CAM),
                             ("marble", build_marble, MARBLE_CAM),
                             ("mini-hdri", build_mini_hdri, MINI_HDRI_CAM),
                             ("env-nee", build_env_nee, ENV_NEE_CAM),
                             ("fog-room", build_fog_room, FOG_ROOM_CAM)):
        js = build(grt)
        out.append((name, js, convert.scene_from_numpy(scene_tree(js), "cpu"), cam))
    js, jcam = grt.load_scene("perlin")
    out.append(("perlin", js, convert.scene_from_numpy(scene_tree(js), "cpu"),
                {f.name: getattr(jcam, f.name) for f in dataclasses.fields(jcam)}))
    return out


def test_choose_mega_mode_matches_jax():
    """Every case of scenes x depths (5, 15, 16, 50) x rays (2^18 - 1, 2^18,
    2^22) x differentiable: the port's choice is the JAX package's with its
    megakernel enabled (interpret mode here, as on a TPU), which never
    answers 'image' for a scene without image textures."""
    seen = set()
    old = jmega.INTERPRET
    jmega.INTERPRET = True
    try:
        for name, js, ts, cam_fields in _table_scenes():
            for depth in (5, 15, 16, 50):
                jcam = jcamera.Camera(**{**cam_fields, "max_depth": depth})
                tcam = convert.camera_from_dict(dataclasses.asdict(jcam))
                for r in ((1 << 18) - 1, 1 << 18, 1 << 22):
                    for diff in (False, True):
                        want = jwf.choose_mega_mode(js, jcam, r, diff)
                        assert twf.choose_mega_mode(ts, tcam, r, diff) == want, \
                            (name, depth, r, diff)
                        seen.add(want)
    finally:
        jmega.INTERPRET = old
    assert seen == {"off", "single", "split"}
