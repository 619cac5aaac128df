"""PyTorch port vs the JAX package: the closest-hit kernels' plain versions,
volume sampling, materials and textures.

On the CPU the port's wrappers run each kernel's plain PyTorch version; the
JAX side runs its Pallas kernels in interpret mode (``INTERPRET`` restored
afterwards).  The CUDA kernels can only run on a GPU: their tests are in
tests/test_torch_cuda.py.  Inputs come from numpy seeds and reach both
packages as the same float32 arrays."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import go_raytracing_tpu as grt
import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu.core.vec3 import V3 as JV3
from go_raytracing_tpu.integrator import wavefront as jwf
from go_raytracing_tpu.materials import tables as jmats
from go_raytracing_tpu.materials import textures as jtex
from go_raytracing_tpu.ops import pallas_intersect as pk
from go_raytracing_tpu_torch import convert
from go_raytracing_tpu_torch.core.vec3 import V3
from go_raytracing_tpu_torch.geometry import packs as tpacks
from go_raytracing_tpu_torch.materials import tables as tmats
from go_raytracing_tpu_torch.materials import textures as ttex
from go_raytracing_tpu_torch.ops import cuda_intersect as ck
from test_torch_helpers import build_random_prims, random_rays, scene_tree

torch.set_num_threads(2)

BIG = float(tpacks.BIG)
N_RAYS = 700


def _tv3(a):
    return V3.from_rows(torch.from_numpy(np.ascontiguousarray(a)))


def _jv3(a):
    return JV3(*(jnp.asarray(a[:, i]) for i in range(3)))


@pytest.fixture(scope="module")
def prims():
    """The random scene in both packages, the rays, and every JAX kernel's
    answer at t_max = BIG (which the halved t_max is made from)."""
    js = build_random_prims(grt)
    ts = convert.scene_from_numpy(scene_tree(js), "cpu")
    o, d, tm = random_rays(N_RAYS, 1)
    return dict(js=js, ts=ts, o=o, d=d, tm=tm)


def _t_max(kind, t_hit, hit):
    big = np.full(N_RAYS, BIG, np.float32)
    if kind == "big":
        return big
    if kind == "halved":
        return np.where(hit, t_hit * np.float32(0.5), big).astype(np.float32)
    return np.where(np.arange(N_RAYS) % 3 == 0, np.float32(-1.0), big)


def _jax_kernel(name, c, t_max):
    """One JAX kernel in interpret mode -> numpy (t, idx, hit[, attrs])."""
    js = c["js"]
    o, d = jnp.asarray(c["o"]), jnp.asarray(c["d"])
    tm, t_max = jnp.asarray(c["tm"]), jnp.asarray(t_max)
    old = pk.INTERPRET
    pk.INTERPRET = True
    try:
        if name == "planar":
            out = pk.planar_closest(js.planar, o, d, t_max)
        elif name == "sphere":
            out = pk.sphere_closest(js.spheres, o, d, tm, t_max)
        elif name == "planar_attrs":
            con = pk._material_consts(js.materials, js.textures, js.planar.mat)
            out = pk.planar_closest_attrs(js.planar, con, o, d, t_max, n_attr=19)
        else:
            con = pk._material_consts(js.materials, js.textures, js.spheres.mat)
            out = pk.sphere_closest_attrs(js.spheres, con, o, d, tm, t_max,
                                          n_attr=17)
    finally:
        pk.INTERPRET = old
    res = [np.asarray(x) for x in out[:3]]
    if len(out) == 4:
        res.append(np.stack([np.asarray(a) for a in out[3]]))
    return res


def _port_kernel(name, c, t_max):
    ts = c["ts"]
    o, d = _tv3(c["o"]), _tv3(c["d"])
    tm, t_max = torch.from_numpy(c["tm"]), torch.from_numpy(t_max)
    before = (ck.LAUNCHES_PLANAR, ck.LAUNCHES_SPHERE, ck.LAUNCHES_PLANAR_ATTRS,
              ck.LAUNCHES_SPHERE_ATTRS)
    if name == "planar":
        out = ck.planar_closest(ts.planar, o, d, t_max)
    elif name == "sphere":
        out = ck.sphere_closest(ts.spheres, o, d, tm, t_max)
    elif name == "planar_attrs":
        con = ck._material_consts(ts.materials, ts.textures, ts.planar.mat)
        out = ck.planar_closest_attrs(ts.planar, con, o, d, t_max, n_attr=19)
    else:
        con = ck._material_consts(ts.materials, ts.textures, ts.spheres.mat)
        out = ck.sphere_closest_attrs(ts.spheres, con, o, d, tm, t_max, n_attr=17)
    # CPU tensors: plain versions, no launch
    assert before == (ck.LAUNCHES_PLANAR, ck.LAUNCHES_SPHERE,
                      ck.LAUNCHES_PLANAR_ATTRS, ck.LAUNCHES_SPHERE_ATTRS)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("t_max_kind", ["big", "halved", "minus-one"])
@pytest.mark.parametrize("name", ["planar", "sphere", "planar_attrs",
                                  "sphere_attrs"])
def test_plain_version_matches_interpret_pallas_kernel(prims, name, t_max_kind):
    """Same inputs, same formulas: hit and index are equal on every ray; a
    planar t and every attribute row agree to rtol 1e-6.  A sphere's root
    h -+ sqrt(h*h - a*c) is a difference of near-equal numbers, and XLA fuses
    the multiply-add in the discriminant where PyTorch does not: its t
    agrees to rtol 3e-5 (largest seen here: 1.0e-5)."""
    t0, _, h0 = _jax_kernel(name, prims, _t_max("big", None, None))[:3]
    t_max = _t_max(t_max_kind, t0, h0)
    j = _jax_kernel(name, prims, t_max)
    t = _port_kernel(name, prims, t_max)
    assert t[1].dtype == np.int32 and t[2].dtype == np.bool_
    np.testing.assert_array_equal(t[2], j[2])
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_allclose(t[0], j[0],
                               rtol=1e-6 if name.startswith("planar") else 3e-5)
    if len(j) == 4:
        assert t[3].shape == j[3].shape
        np.testing.assert_allclose(t[3], j[3], rtol=1e-6, atol=1e-6)
        # kindpack decodes to the winner's material and texture kinds
        prim_mat = (prims["ts"].planar.mat if name == "planar_attrs"
                    else prims["ts"].spheres.mat).numpy()
        mat = prim_mat[t[1]]
        kp = t[3][5 if name == "planar_attrs" else 4].astype(np.int32)
        kinds = prims["ts"].materials.kind.numpy()
        tkinds = prims["ts"].textures.kind.numpy()[prims["ts"].materials.tex.numpy()]
        np.testing.assert_array_equal((kp // 8)[t[2]], kinds[mat][t[2]])
        np.testing.assert_array_equal((kp % 8)[t[2]], tkinds[mat][t[2]])
    if t_max_kind == "big":
        assert 0.2 < t[2].mean() < 1.0
    elif t_max_kind == "halved":
        assert not t[2][h0].any()       # cut at half its nearest hit's distance
    else:
        dead = np.arange(N_RAYS) % 3 == 0
        assert not t[2][dead].any() and t[2][~dead].any()
        assert (t[0][dead] == np.float32(BIG)).all() and (t[1][dead] == 0).all()
        if len(t) == 4:
            assert (t[3][:, dead] == 0).all()


def test_first_primitive_wins_an_exact_tie():
    """Two coincident quads and two coincident spheres: the lower index is
    the winner, as in the Pallas kernels' strict ``t < t_best``."""
    b = grtt.SceneBuilder()
    m0, m1 = b.lambertian((0.1, 0.2, 0.3)), b.lambertian((0.9, 0.8, 0.7))
    b.quad((-1, -1, -2), (2, 0, 0), (0, 2, 0), m0)
    b.quad((-1, -1, -2), (2, 0, 0), (0, 2, 0), m1)
    b.sphere((0, 0, -5), 1.0, m0)
    b.sphere((0, 0, -5), 1.0, m1)
    scene = b.build(device="cpu")
    o = V3.zeros((4,))
    d = V3(torch.tensor([0.0, 0.05, -0.1, 0.1]), torch.tensor([0.0, 0.1, 0.05, -0.1]),
           -torch.ones(4))
    big = torch.full((4,), BIG)
    t, idx, hit = ck.planar_closest(scene.planar, o, d, big)
    assert hit.all() and (idx == 0).all()
    con = ck._material_consts(scene.materials, scene.textures, scene.planar.mat)
    _, idx, hit, attrs = ck.planar_closest_attrs(scene.planar, con, o, d, big)
    assert hit.all() and (idx == 0).all()
    np.testing.assert_allclose(attrs[8:11, 0].numpy(), [0.1, 0.2, 0.3], rtol=1e-6)
    t, idx, hit = ck.sphere_closest(scene.spheres, o, d, torch.zeros(4), big)
    assert hit.all() and (idx == 0).all()


def test_material_consts_match_jax(prims):
    js, ts = prims["js"], prims["ts"]
    for jmat, tmat in ((js.planar.mat, ts.planar.mat), (js.spheres.mat, ts.spheres.mat)):
        j = pk._material_consts(js.materials, js.textures, jmat)
        t = ck._material_consts(ts.materials, ts.textures, tmat)
        names = ["kindpack", "fuzz", "ior", "colr", "colg", "colb", "evenr",
                 "eveng", "evenb", "oddr", "oddg", "oddb", "scale", "tex_id"]
        assert t.shape == (ck.CONST_ROWS, jmat.shape[0]) and not t.requires_grad
        for row, name in enumerate(names):
            np.testing.assert_array_equal(t[row].numpy(), np.asarray(j[name]), name)


def test_wrappers_reject_bad_n_attr(prims):
    ts = prims["ts"]
    o, d = _tv3(prims["o"]), _tv3(prims["d"])
    big = torch.full((N_RAYS,), BIG)
    con = ck._material_consts(ts.materials, ts.textures, ts.planar.mat)
    with pytest.raises(ValueError, match="n_attr"):
        ck.planar_closest_attrs(ts.planar, con, o, d, big, n_attr=11)
    with pytest.raises(ValueError, match="n_attr"):
        ck.sphere_closest_attrs(ts.spheres, con, o, d, big, big, n_attr=19)


# -----------------------------------------------------------------------------
# Volume sampling
# -----------------------------------------------------------------------------

def _build_media(pkg, **kw):
    b = pkg.SceneBuilder()
    b.volume_box((-2, -1, -2), (1, 2, 1), 0.6, (0.8, 0.8, 0.8),
                 pkg.Affine.trs(rotation_deg=(0, 30, 0), position=(0.5, 0, 0)))
    b.volume_sphere((1.0, 0.5, -1.0), 1.5, 0.9, (0.9, 0.9, 0.7))
    b.volume_pyramid((-1.0, -1.0, 1.0), 3.0, 3.5, 1.2, (0.7, 0.9, 0.9))
    return b.build(**kw)


def test_sample_volumes_matches_jax():
    """Box slabs, unit sphere and half-space polyhedron, one of each in one
    pack, against the JAX integrator's ``_sample_volumes``: hit and winner
    equal, t to rtol 1e-5, and each kind of medium wins somewhere."""
    js = _build_media(grt)
    ts = convert.scene_from_numpy(scene_tree(js), "cpu")
    assert ts.volumes.kind.tolist() == [tpacks.VOL_BOX, tpacks.VOL_SPHERE,
                                        tpacks.VOL_PLANES]
    n = 3
    rng = np.random.default_rng(7)
    r = 1500
    o = (rng.normal(size=(r, 3)) * 2.5).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d[:50, 1] = 0.0                                   # rays along a slab
    u = rng.random((r, n)).astype(np.float32)
    t_surf = np.where(rng.random(r) < 0.5, BIG, rng.uniform(0.5, 6.0, r)).astype(np.float32)
    # one compiled program instead of a compile per operation
    jt, ji, jh = jax.jit(jwf._sample_volumes)(
        js.volumes, _jv3(o), _jv3(d), 1e-3, jnp.asarray(t_surf), jnp.asarray(u))
    tt, ti, th = tpacks.sample_volumes(ts.volumes, _tv3(o), _tv3(d), 1e-3,
                                       torch.from_numpy(t_surf), torch.from_numpy(u))
    assert ti.dtype == torch.int32 and th.dtype == torch.bool
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5)
    assert 0.02 < th.float().mean() < 0.98
    assert set(ti[th].tolist()) == {0, 1, 2}


def test_sample_volumes_backward_is_finite():
    """Every guarded lane (a sphere the ray misses, a slab the ray runs
    along, a masked pair) differentiates to a finite number."""
    ts = _build_media(grtt, device="cpu")
    rng = np.random.default_rng(8)
    r = 600
    o = torch.from_numpy((rng.normal(size=(3, r)) * 2.5).astype(np.float32)).requires_grad_()
    dn = rng.normal(size=(3, r)).astype(np.float32)
    dn[1, :40] = 0.0
    d = torch.from_numpy(dn).requires_grad_()
    u = torch.from_numpy(rng.random((r, 3)).astype(np.float32))
    t, _, hit = tpacks.sample_volumes(ts.volumes, V3(*o), V3(*d), 1e-3,
                                      torch.full((r,), BIG), u)
    assert hit.any() and not hit.all()
    torch.where(hit, t, 0.0).sum().backward()
    assert torch.isfinite(o.grad).all() and torch.isfinite(d.grad).all()
    assert float(o.grad.abs().max()) > 0


def test_empty_volume_pack():
    ts, _ = grtt.load_scene("quads", device="cpu")
    o = V3.zeros((5,))
    t, idx, hit = tpacks.sample_volumes(ts.volumes, o, o, 1e-3, torch.ones(5),
                                        torch.zeros((5, 0)))
    assert (t == BIG).all() and (idx == 0).all() and not hit.any()


# -----------------------------------------------------------------------------
# Materials and textures
# -----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shading():
    """2,000 hits with every material kind (one with a checker texture), in
    both packages, and both packages' ``scatter``."""
    def build(pkg, **kw):
        b = pkg.SceneBuilder()
        b.lambertian(b.checker(0.7, (0.2, 0.3, 0.1), (0.9, 0.9, 0.8)))
        b.lambertian((0.2, 0.5, 0.8))
        b.metal((0.8, 0.6, 0.2), 0.25)
        b.metal((0.9, 0.9, 0.9), 0.0)
        b.dielectric(1.5)
        b.diffuse_light((6, 5, 4))
        b.isotropic((0.8, 0.9, 1.0))
        return b.build(**kw)

    js = build(grt)
    ts = convert.scene_from_numpy(scene_tree(js), "cpu")
    rng = np.random.default_rng(11)
    r = 2000
    mat_id = rng.integers(0, 7, r).astype(np.int32)
    normal = rng.normal(size=(r, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    ray_d = rng.normal(size=(r, 3)).astype(np.float32)
    ray_d -= 1.5 * np.maximum((ray_d * normal).sum(1, keepdims=True), 0) * normal
    front = rng.random(r) < 0.7
    p = (rng.normal(size=(r, 3)) * 3).astype(np.float32)
    wo = rng.normal(size=(r, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    uv = rng.random((2, r)).astype(np.float32)
    stream = np.arange(r, dtype=np.uint32) + 12345
    flags = dict(has_noise=False, has_image=False)
    seed, bounce = 3, 2
    j_sc = jax.jit(functools.partial(jmats.scatter, **flags))(
        js.materials, js.textures, jnp.asarray(mat_id), _jv3(ray_d),
        _jv3(normal), jnp.asarray(front), jnp.asarray(uv[0]), jnp.asarray(uv[1]),
        _jv3(p), seed, jnp.asarray(stream), bounce)
    t_stream = torch.from_numpy(stream.astype(np.int64))
    t_sc = tmats.scatter(ts.materials, ts.textures, torch.from_numpy(mat_id),
                         _tv3(ray_d), _tv3(normal), torch.from_numpy(front),
                         torch.from_numpy(uv[0]), torch.from_numpy(uv[1]), _tv3(p),
                         seed, t_stream, bounce, **flags)
    return dict(js=js, ts=ts, mat_id=mat_id, normal=normal, ray_d=ray_d,
                front=front, p=p, wo=wo, uv=uv, stream=stream, t_stream=t_stream,
                seed=seed, bounce=bounce, flags=flags, j_sc=j_sc, t_sc=t_sc)


def _rows(v):
    if hasattr(v.x, "numpy"):
        return torch.stack(list(v)).detach().numpy()
    return np.stack([np.asarray(c) for c in v])


def _assert_scatter_equal(t_sc, j_sc, kinds):
    """All five fields; a ray whose branch (Schlick draw, total reflection,
    metal absorption) flipped on a rounding differs wholly: at most 2 of the
    2,000 may, the others agree to rtol 1e-5."""
    np.testing.assert_array_equal(t_sc.can_use_nee.numpy(), np.asarray(j_sc.can_use_nee))
    flipped = t_sc.scattered.numpy() != np.asarray(j_sc.scattered)
    flipped |= ~np.isclose(_rows(t_sc.direction), _rows(j_sc.direction),
                           rtol=1e-5, atol=1e-6).all(axis=0)
    assert flipped.sum() <= 2, flipped.sum()
    assert not flipped[(kinds != 1) & (kinds != 2)].any()   # only metal / glass branch
    for f in ("attenuation", "emitted"):
        np.testing.assert_allclose(_rows(getattr(t_sc, f)), _rows(getattr(j_sc, f)),
                                   rtol=1e-5, atol=1e-7, err_msg=f)


def test_scatter_matches_jax(shading):
    c = shading
    kinds = c["ts"].materials.kind.numpy()[c["mat_id"]]
    assert set(kinds.tolist()) == {0, 1, 2, 3, 4}
    _assert_scatter_equal(c["t_sc"], c["j_sc"], kinds)
    sc = c["t_sc"]
    assert not sc.scattered[torch.from_numpy(kinds == 3)].any()
    assert (_rows(sc.emitted)[:, kinds != 3] == 0).all()
    assert (_rows(sc.attenuation)[:, kinds == 2] == 1).all()


def test_scatter_from_attrs_is_scatter_and_matches_jax(shading):
    """The attribute twin: same body as ``scatter`` (bit-equal in the port),
    and equal to the JAX twin."""
    c = shading
    ts, js = c["ts"], c["js"]
    mid = torch.from_numpy(c["mat_id"]).long()
    albedo = ttex.evaluate(ts.textures, ts.materials.tex[mid],
                           torch.from_numpy(c["uv"][0]), torch.from_numpy(c["uv"][1]),
                           _tv3(c["p"]))
    t_sc = tmats.scatter_from_attrs(
        ts.materials.kind[mid], ts.materials.fuzz[mid], ts.materials.ior[mid],
        albedo, _tv3(c["ray_d"]), _tv3(c["normal"]), torch.from_numpy(c["front"]),
        c["seed"], c["t_stream"], c["bounce"])
    for a, b in zip(t_sc, c["t_sc"]):
        assert np.array_equal(_rows(a), _rows(b)) if isinstance(a, V3) \
            else torch.equal(a, b)
    jm = np.asarray(c["mat_id"])
    j_sc = jax.jit(jmats.scatter_from_attrs)(
        js.materials.kind[jm], js.materials.fuzz[jm], js.materials.ior[jm],
        JV3(*(jnp.asarray(r) for r in _rows(albedo))), _jv3(c["ray_d"]),
        _jv3(c["normal"]), jnp.asarray(c["front"]), c["seed"],
        jnp.asarray(c["stream"]), c["bounce"])
    _assert_scatter_equal(t_sc, j_sc, ts.materials.kind.numpy()[c["mat_id"]])


def test_brdf_pdf_emitted_and_evaluate_match_jax(shading):
    c = shading
    ts, js = c["ts"], c["js"]
    wi = -c["ray_d"] / np.linalg.norm(c["ray_d"], axis=1, keepdims=True)
    j_pdf = jmats.brdf_pdf(js.materials, jnp.asarray(c["mat_id"]), _jv3(wi),
                           _jv3(c["wo"]), _jv3(c["normal"]))
    t_pdf = tmats.brdf_pdf(ts.materials, torch.from_numpy(c["mat_id"]), _tv3(wi),
                           _tv3(c["wo"]), _tv3(c["normal"]))
    np.testing.assert_allclose(t_pdf.numpy(), np.asarray(j_pdf), rtol=1e-5, atol=1e-30)
    mid = torch.from_numpy(c["mat_id"]).long()
    t_pdf2 = tmats.brdf_pdf_from_attrs(ts.materials.kind[mid], ts.materials.fuzz[mid],
                                       _tv3(wi), _tv3(c["wo"]), _tv3(c["normal"]))
    assert torch.equal(t_pdf, t_pdf2)
    jm = np.asarray(c["mat_id"])
    j_pdf2 = jmats.brdf_pdf_from_attrs(js.materials.kind[jm], js.materials.fuzz[jm],
                                       _jv3(wi), _jv3(c["wo"]), _jv3(c["normal"]))
    np.testing.assert_allclose(t_pdf2.numpy(), np.asarray(j_pdf2), rtol=1e-5, atol=1e-30)
    kinds = ts.materials.kind.numpy()[c["mat_id"]]
    assert (t_pdf.numpy()[(kinds == 2) | (kinds == 3)] == 0).all()
    assert (t_pdf.numpy()[kinds == 4] == np.float32(1 / (4 * np.pi))).all()
    assert t_pdf.numpy()[kinds == 1].max() > 1.0     # the Phong lobe's peak

    u, v = (torch.from_numpy(x) for x in c["uv"])
    j_em = jmats.emitted(js.materials, js.textures, jnp.asarray(c["mat_id"]),
                         jnp.asarray(c["uv"][0]), jnp.asarray(c["uv"][1]),
                         _jv3(c["p"]), **c["flags"])
    t_em = tmats.emitted(ts.materials, ts.textures, torch.from_numpy(c["mat_id"]),
                         u, v, _tv3(c["p"]), **c["flags"])
    np.testing.assert_array_equal(_rows(t_em), _rows(j_em))
    assert _rows(t_em)[:, kinds == 3].min() == 4.0

    tex_id = np.random.default_rng(13).integers(
        0, ts.textures.kind.shape[0], len(kinds)).astype(np.int32)
    j_val = jtex.evaluate(js.textures, jnp.asarray(tex_id), jnp.asarray(c["uv"][0]),
                          jnp.asarray(c["uv"][1]), _jv3(c["p"]), **c["flags"])
    t_val = ttex.evaluate(ts.textures, torch.from_numpy(tex_id), u, v, _tv3(c["p"]),
                          **c["flags"])
    np.testing.assert_array_equal(_rows(t_val), _rows(j_val))
    checker = ts.textures.kind.numpy()[tex_id] == ttex.TEX_CHECKER
    assert checker.any() and len(np.unique(_rows(t_val)[0][checker])) == 2
    np.testing.assert_array_equal(tmats.can_use_nee_table(ts.materials).numpy(),
                                  np.asarray(jmats.can_use_nee_table(js.materials)))


@pytest.mark.parametrize("flag, item", [("has_noise", "A13"), ("has_image", "A16")])
def test_evaluate_names_the_roadmap_item(shading, flag, item):
    ts = shading["ts"]
    z = torch.zeros(3)
    with pytest.raises(NotImplementedError, match=item):
        ttex.evaluate(ts.textures, torch.zeros(3, dtype=torch.int32), z, z,
                      V3(z, z, z), **{flag: True})
