"""PyTorch port vs the JAX package: scene tables and megakernel tables.

Each scene is built three ways — by the JAX builder, by the port's own
builder, and carried across with ``convert.scene_from_numpy`` — and the
tables must agree.  Both builders do their arithmetic host-side in float64
numpy and cast once, so scene tables are EQUAL; the kernel tables add one
float32 cross product, compared to 1e-6 relative."""

import dataclasses

import numpy as np
import pytest
import torch

import go_raytracing_tpu as grt
import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu.ops import pallas_wavefront as jmega
from go_raytracing_tpu_torch import convert
from go_raytracing_tpu_torch.geometry.scene import Affine, SceneBuilder
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from test_torch_helpers import build_mixed, scene_tree

torch.set_num_threads(2)

PORTED = ["cornell", "cornell-smoke", "cornell-glossy", "simple", "quads",
          "checkered", "glossy-metal", "primitives", "random", "cornell-lucy"]
# what loading the scene raises, and the message names: a ROADMAP item, or
# (hdri-test) the missing asset, as the JAX package's builder raises it
NOT_PORTED = {"perlin": (NotImplementedError, "A13"),
              "earth": (NotImplementedError, "A16"),
              "hdri-test": (FileNotFoundError, "abandoned_hall_01_1k.hdr")}


def _both(name):
    if name == "mixed":
        return build_mixed(grt), build_mixed(grtt, device="cpu")
    js, jcam = grt.load_scene(name)
    ts, tcam = grtt.load_scene(name, device="cpu")
    assert dataclasses.asdict(tcam) == dataclasses.asdict(jcam)
    return js, ts


def _assert_scene_equal(ts, tree):
    for pack in ("spheres", "planar", "volumes", "materials", "textures"):
        for k, v in tree[pack].items():
            got = getattr(getattr(ts, pack), k)
            if v is None:
                assert got is None
                continue
            assert tuple(got.shape) == v.shape, (pack, k)
            np.testing.assert_array_equal(got.numpy(), v, err_msg=f"{pack}.{k}")
    for k in ("light_q", "light_u", "light_v", "light_normal", "light_area",
              "light_mat"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(), tree[k], err_msg=k)
    for k in ("has_noise", "has_image", "has_checker", "env_importance"):
        assert getattr(ts, k) == tree[k], k
    assert len(ts.meshes) == len(tree["meshes"])
    for proto, mtree in zip(ts.meshes, tree["meshes"]):
        for k, v in mtree.items():
            got = getattr(proto, k)
            if isinstance(v, tuple):
                for g, w in zip(got, v):
                    np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
            elif isinstance(v, int):
                assert got == v, k
            else:
                np.testing.assert_array_equal(got.numpy(), v, err_msg=k)


@pytest.mark.parametrize("name", PORTED + ["mixed"])
def test_scene_tables_equal(name):
    js, ts = _both(name)
    tree = scene_tree(js)
    _assert_scene_equal(ts, tree)
    _assert_scene_equal(convert.scene_from_numpy(tree, "cpu"), tree)
    assert ts.device.type == "cpu"
    # the megakernel takes every ported scene but the mesh scene, as in JAX
    assert cw.applicable(ts) == (not ts.meshes)


@pytest.mark.parametrize("name", ["cornell", "cornell-smoke", "mixed"])
def test_build_tables_match_jax(name):
    js, ts = _both(name)
    (pt, st, _sb, vt, lt, n_planar, n_sphere, n_seg, n_vol, n_lights) = \
        jmega.build_tables(js)
    assert n_seg == 0  # below the segment-culling threshold: same order
    for scene in (ts, convert.scene_from_numpy(scene_tree(js), "cpu")):
        tb = cw.build_tables(scene)
        assert (tb.n_planar, tb.n_sphere, tb.n_vol, tb.n_lights) == \
            (n_planar, n_sphere, n_vol, n_lights)
        for ours, theirs, n in ((tb.pt, pt, n_planar), (tb.st, st, n_sphere),
                                (tb.vt, vt, n_vol), (tb.lt, lt, n_lights)):
            assert ours.dtype == torch.float32 and ours.is_contiguous()
            assert ours.shape == (theirs.shape[0], max(n, 1))
            # the JAX tables pad columns to a multiple of 8; compare the real ones
            np.testing.assert_allclose(ours.numpy()[:, :n],
                                       np.asarray(theirs)[:, :n],
                                       rtol=1e-6, atol=0)


def test_cornell_prim_counts():
    ts, _ = grtt.load_scene("cornell", device="cpu")
    # 1 light + 5 walls + 2 boxes x 6 quads
    assert ts.planar.d.shape[0] == 18
    assert ts.spheres.radius.shape[0] == 0
    assert ts.n_volumes == 1 and ts.n_lights == 1


def test_registry_names_match_jax():
    assert sorted(grtt.REGISTRY) == sorted(grt.REGISTRY)


def test_unknown_scene_raises_keyerror():
    with pytest.raises(KeyError) as t_err:
        grtt.load_scene("not-a-scene", device="cpu")
    with pytest.raises(KeyError) as j_err:
        grt.load_scene("not-a-scene")
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("name", sorted(NOT_PORTED))
def test_not_ported_scene_names_roadmap_item(name):
    exc, match = NOT_PORTED[name]
    with pytest.raises(exc, match=match):
        grtt.load_scene(name, device="cpu")


def test_builder_gaps_and_errors():
    b = SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    for call, item in [
        (lambda: b.noise(4.0), "A13"),
        (lambda: b.image(np.zeros((2, 2, 3))), "A16"),
    ]:
        with pytest.raises(NotImplementedError, match=item):
            call()
    # environments are ported (A15): an array, or a path that must exist
    with pytest.raises(FileNotFoundError):
        b.set_environment("assets/hdri/not-there.hdr")
    # meshes are ported: a prototype without triangles is refused at
    # build, one without instances is left out
    assert b.mesh(np.zeros((3, 3)), np.zeros((0, 3))) == 0
    b.mesh_instance(0, m)
    with pytest.raises(ValueError, match="triangle"):
        b.build(device="cpu")
    b2 = SceneBuilder()
    b2.mesh(np.eye(3), np.array([[0, 1, 2]]))
    assert b2.build(device="cpu").meshes == ()
    with pytest.raises(ValueError, match="uniform"):
        b.sphere((0, 0, 0), 1.0, m, Affine.trs(scale=(1, 2, 1)))
    q = b.triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), m)
    with pytest.raises(ValueError, match="quads"):
        b.add_light(q)


def _media(pkg, which, **build_kwargs):
    b = pkg.SceneBuilder()
    b.quad((-5, 0, -5), (10, 0, 0), (0, 0, 10), b.lambertian((0.5, 0.5, 0.5)))
    turn = pkg.Affine.trs(scale=(1, 2, 1), rotation_deg=(10, 20, 30),
                          position=(1, 0, -1))
    if which in ("sphere", "all"):
        b.volume_sphere((0.5, 2.0, -1.0), 1.5, 0.3, (0.9, 0.9, 0.7))
    if which in ("convex", "all"):
        b.volume_convex([((0, 1, 0), 1.0), ((0, -1, 0), 0.5), (1, 0, 0, 2.0),
                         (-1, 0, 0, 2.0), ((0, 0, 1), 1.5), ((0, 0, -1), 1.5),
                         ((0.6, 0.8, 0), 2.2)], 0.4, (0.7, 0.9, 0.9), turn)
    if which in ("pyramid", "all"):
        b.volume_pyramid((-1.0, 0.0, 1.0), 3.0, 3.5, 1.2, (0.7, 0.9, 0.9), turn)
    if which == "all":
        b.volume_box((-3, 0, -3), (3, 3, 3), 0.02, b.checker(0.5, (0, 0, 0), (1, 1, 1)))
    return b.build(**build_kwargs)


@pytest.mark.parametrize("which", ["sphere", "convex", "pyramid", "all"])
def test_round_and_polyhedral_media_tables_equal(which):
    """``volume_sphere``, ``volume_convex`` and ``volume_pyramid`` build the
    JAX builder's tables: the unit-ball transform, the half-space rows (the
    shorter lists padded with the plane every point satisfies) and the
    volume kinds, built here and carried across."""
    js = _media(grt, which)
    ts = _media(grtt, which, device="cpu")
    tree = scene_tree(js)
    _assert_scene_equal(ts, tree)
    _assert_scene_equal(convert.scene_from_numpy(tree, "cpu"), tree)
    if which == "sphere":
        assert ts.volumes.planes is None
        assert ts.volumes.kind.tolist() == [grtt.geometry.packs.VOL_SPHERE]
    else:
        assert ts.volumes.planes.shape[1:] == (7 if which != "pyramid" else 5, 4)
    if which == "all":
        assert ts.volumes.kind.tolist() == [1, 2, 2, 0]
        # the pyramid's 5 planes are padded to the convex medium's 7, the
        # sphere's and the box's rows are all padding
        pad = torch.tensor([0.0, 0.0, 0.0, 1.0])
        assert bool((ts.volumes.planes[2, 5:] == pad).all())
        assert bool((ts.volumes.planes[[0, 3]] == pad).all())
    assert not cw.applicable(ts)     # the megakernel's volume window is a box


def test_build_without_device_raises_and_names_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        SceneBuilder().build()
    with pytest.raises(RuntimeError, match="CUDA"):
        grtt.load_scene("cornell")


def test_applicable_gate():
    ts, _ = grtt.load_scene("cornell", device="cpu")
    assert cw.applicable(ts)
    assert not cw.applicable(ts, max_prims=4)
    assert not cw.applicable(dataclasses.replace(ts, has_noise=True))
    assert not cw.applicable(dataclasses.replace(ts, has_image=True))
    vols = dataclasses.replace(ts.volumes, kind=torch.ones_like(ts.volumes.kind))
    assert not cw.applicable(dataclasses.replace(ts, volumes=vols))
