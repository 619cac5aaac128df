"""PyTorch port vs the JAX package: instanced triangle meshes, the parts
around the kernels.

The stand-in meshes and the BVH build equal the JAX package's bit for bit
(leaf order, level boxes, both kernels' tables, the ``cornell-lucy``
scene's tables); the ray-sort key and reach test of the standard
integrator equal the JAX package's; its sorted route gives every ray the
result of the unsorted sweep; and the mesh hit record agrees with the JAX
package's ``_mesh_record`` and ``mesh_bvh.mesh_hit_record``.  The JAX
kernels run in Pallas interpret mode (``INTERPRET`` set and restored)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import go_raytracing_tpu as grt
import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu.core.vec3 import V3 as JV3
from go_raytracing_tpu.geometry import mesh_bvh as jmesh
from go_raytracing_tpu.integrator import wavefront as jwf
from go_raytracing_tpu.io import obj as jobj
from go_raytracing_tpu.ops import pallas_mesh as jpm
from go_raytracing_tpu.ops import pallas_mesh_stream as jpms
from go_raytracing_tpu_torch.core.vec3 import V3
from go_raytracing_tpu_torch.geometry import mesh_bvh as tmesh
from go_raytracing_tpu_torch.integrator import wavefront as twf
from go_raytracing_tpu_torch.io import obj as tobj
from go_raytracing_tpu_torch.ops import cuda_mesh as cm
from test_torch_helpers import (build_lucy, lucy_instances, mesh_rays, mesh_tree,
                                scene_tree)

torch.set_num_threads(2)

T_MIN = 1e-3


def _jv3(a):
    return JV3(*(jnp.asarray(np.ascontiguousarray(c)) for c in a.T))


def _tv3(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a.T))


def _assert_proto_equal(jp, tp):
    """Every field of the port's MeshProto equals the JAX one's."""
    jt = mesh_tree(jp)
    for f in dataclasses.fields(tp):
        if not f.init:
            continue            # derived from the other fields
        v = getattr(tp, f.name)
        if isinstance(v, tuple):
            assert len(v) == len(jt[f.name]), f.name
            for a, b in zip(v, jt[f.name]):
                np.testing.assert_array_equal(a.numpy(), b, err_msg=f.name)
        elif isinstance(v, torch.Tensor):
            assert v.dtype == (torch.int32 if jt[f.name].dtype.kind == "i"
                               else torch.float32), f.name
            np.testing.assert_array_equal(v.numpy(), jt[f.name], err_msg=f.name)
        else:
            assert v == jt[f.name], f.name


@pytest.mark.parametrize("make", [
    lambda m: m.lucy_standin(12, 10),
    lambda m: m.lucy_standin(12, 10, roughness=0.35),
    lambda m: m.statue_standin(16),
], ids=["lathe", "rough", "statue"])
def test_standin_meshes_equal_jax(make):
    tv, tt = make(tobj)
    jv, jt = make(jobj)
    assert tv.dtype == jv.dtype and tt.dtype == jt.dtype
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("detail", [(12, 10), (80, 110)], ids=["small", "stream"])
def test_build_proto_equals_jax(detail):
    """The small mesh builds the ladder's tables, the 17,440-triangle one
    the stream's (the size rule at 16,384 triangles): both equal the JAX
    package's, and so does the stream build on the small mesh's triangles."""
    verts, tris = tobj.lucy_standin(*detail)
    insts = lucy_instances(3)
    jp = jmesh.build_proto(verts, tris, insts)
    tp = tmesh.build_proto(verts, tris, insts, torch.device("cpu"))
    _assert_proto_equal(jp, tp)
    assert cm.kernel_ok(tp) == (len(tris) <= cm.MAX_KERNEL_TRIS) != cm.stream_ok(tp)
    if cm.kernel_ok(tp):
        st = cm.build_stream_tables(*(a.numpy() for a in (tp.tri_v0, tp.tri_e1, tp.tri_e2)))
        jst = jpms.build_stream_tables(*(np.asarray(a) for a in (jp.tri_v0, jp.tri_e1, jp.tri_e2)))
        for a, b in zip(st, jst):
            np.testing.assert_array_equal(a, b)


def test_cornell_lucy_tables_equal_jax():
    """The scene built by each package's ``cornell-lucy`` builder, and the
    JAX scene carried across by ``convert.scene_from_numpy``, hold the same
    tables."""
    from go_raytracing_tpu_torch import convert

    js = build_lucy(grt)
    ts = build_lucy(grtt, device="cpu")
    carried = convert.scene_from_numpy(scene_tree(js), "cpu")
    assert len(ts.meshes) == len(js.meshes) == 1
    assert ts.meshes[0].n_instances == 3 and ts.meshes[0].n_tris == 216
    for scene in (ts, carried):
        _assert_proto_equal(js.meshes[0], scene.meshes[0])
        for name in ("planar", "materials", "textures"):
            for k, v in getattr(js, name)._asdict().items():
                if v is not None:
                    np.testing.assert_array_equal(
                        getattr(getattr(scene, name), k).numpy(), np.asarray(v),
                        err_msg=f"{name}.{k}")
    default, _ = grtt.load_scene("cornell-lucy", device="cpu")
    assert default.meshes[0].n_tris == 48 * 39 * 2 and default.meshes[0].n_instances == 10


@pytest.fixture(scope="module")
def lucy():
    """cornell-lucy (12, 10) with 3 instances in both packages, rays, and
    t_max with dead lanes."""
    js = build_lucy(grt)
    ts = build_lucy(grtt, device="cpu")
    o, d = mesh_rays(4096, seed=2)
    t_max = np.where(np.arange(4096) % 5 == 0, -1.0, 3e38).astype(np.float32)
    return dict(jp=js.meshes[0], tp=ts.meshes[0], o=o, d=d, t_max=t_max)


def test_sort_key_matches_jax(lucy):
    c = lucy
    j_reach, j_key = jwf._mesh_sort_key(c["jp"], _jv3(c["o"]), _jv3(c["d"]), T_MIN,
                                        jnp.asarray(c["t_max"]))
    t_reach, t_key = twf._mesh_sort_key(c["tp"], _tv3(c["o"]), _tv3(c["d"]), T_MIN,
                                        torch.from_numpy(c["t_max"]))
    np.testing.assert_array_equal(t_reach.numpy(), np.asarray(j_reach))
    np.testing.assert_array_equal(t_key.numpy(), np.asarray(j_key))
    reach = t_reach.numpy()
    assert 0.2 < reach.mean() < 0.95
    assert len(np.unique(t_key.numpy())) > 50


@pytest.mark.parametrize("any_hit", [False, True])
def test_sorted_route_matches_unsorted_and_jax(lucy, any_hit):
    """With ``_MESH_SORT_MIN`` lowered (in both packages, restored after),
    the batch goes through the sort and its inverse: bit for bit the
    unsorted results, and the JAX package's sorted route's."""
    c = lucy
    o, d, tmax = _tv3(c["o"]), _tv3(c["d"]), torch.from_numpy(c["t_max"])
    plain = twf._mesh_intersect(c["tp"], o, d, T_MIN, tmax, any_hit=any_hit)
    old = twf._MESH_SORT_MIN, jwf._MESH_SORT_MIN, jpm.INTERPRET
    twf._MESH_SORT_MIN = jwf._MESH_SORT_MIN = 1024
    jpm.INTERPRET = True
    try:
        seen = []
        real = cm.intersect_mesh_kernel

        def spy(proto, o_, d_, t_min, t_max, any_hit=False):
            seen.append(o_.x.clone())
            return real(proto, o_, d_, t_min, t_max, any_hit=any_hit)

        cm.intersect_mesh_kernel = spy
        try:
            sorted_ = twf._mesh_intersect(c["tp"], o, d, T_MIN, tmax, any_hit=any_hit)
        finally:
            cm.intersect_mesh_kernel = real
        j = jwf._mesh_intersect(c["jp"], _jv3(c["o"]), _jv3(c["d"]), T_MIN,
                                jnp.asarray(c["t_max"]), any_hit=any_hit)
    finally:
        twf._MESH_SORT_MIN, jwf._MESH_SORT_MIN, jpm.INTERPRET = old
    assert not torch.equal(seen[0], o.x)          # the kernel saw sorted rays
    for a, b in zip(sorted_[:4], plain[:4]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(sorted_[3].numpy(), np.asarray(j[3]))
    hit = sorted_[3].numpy()
    assert hit.sum() > 300
    if not any_hit:
        np.testing.assert_array_equal(sorted_[1].numpy(), np.asarray(j[1]))
        np.testing.assert_array_equal(sorted_[2].numpy(), np.asarray(j[2]))
        np.testing.assert_allclose(sorted_[0].numpy()[hit], np.asarray(j[0])[hit],
                                   rtol=5e-5)


def test_mesh_record_matches_jax(lucy):
    """The port's record against the JAX package's ``_mesh_record`` and its
    oracle ``mesh_bvh.mesh_hit_record``, on the hits of the closest-hit
    sweep (tolerance: XLA's fused multiply-adds, as for ``t``)."""
    c = lucy
    t, tri, inst, hit, _ = cm.intersect_mesh_kernel(
        c["tp"], torch.from_numpy(c["o"]), torch.from_numpy(c["d"]), T_MIN,
        torch.from_numpy(c["t_max"]))
    h = hit.numpy()
    t_rec = torch.where(hit, t, 1.0)
    rec = twf._mesh_record(c["tp"], tri, inst, _tv3(c["o"]), _tv3(c["d"]), t_rec)
    args = (c["jp"], jnp.asarray(tri.numpy()), jnp.asarray(inst.numpy()))
    j_rec = jwf._mesh_record(*args, _jv3(c["o"]), _jv3(c["d"]), jnp.asarray(t_rec.numpy()))
    j_orc = jmesh.mesh_hit_record(*args, jnp.asarray(c["o"]), jnp.asarray(c["d"]),
                                  jnp.asarray(t_rec.numpy()))

    def np_(x):
        if isinstance(x, (V3, JV3)):
            return np.stack([np.asarray(v) for v in x], axis=-1)
        return np.asarray(x)

    t_p, t_n, t_f, t_u, t_v, t_m = (np_(x) for x in rec)
    for ref in (j_rec, tuple(np_(x) for x in j_orc)):
        r_p, r_n, r_f, r_u, r_v, r_m = (np_(x) for x in ref)
        np.testing.assert_allclose(t_p[h], r_p[h], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(t_n[h], r_n[h], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(t_f[h], r_f[h])
        np.testing.assert_allclose(t_u[h], r_u[h], atol=1e-4)
        np.testing.assert_allclose(t_v[h], r_v[h], atol=1e-4)
        np.testing.assert_array_equal(t_m, r_m)
    assert ((t_u[h] >= -1e-4) & (t_v[h] >= -1e-4) & (t_u[h] + t_v[h] <= 1 + 1e-4)).all()
    assert np.allclose(np.linalg.norm(t_n[h], axis=1), 1.0, atol=1e-5)
