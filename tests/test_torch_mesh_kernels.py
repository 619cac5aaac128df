"""PyTorch port vs the JAX package: the two mesh intersection kernels.

The port's plain versions of ``mesh_sweep`` and ``mesh_stream``
(``ops/cuda_mesh``, run because the rays lie on the CPU) against the JAX
package's Pallas kernels ``pallas_mesh.intersect_mesh_kernel`` and
``pallas_mesh_stream.intersect_mesh_stream`` in interpret mode
(``INTERPRET`` set and restored), on the same 216-triangle statue with two
instances and the same 4,096 rays, in closest-hit and any-hit mode, for
three kinds of ``t_max``.  The stream kernel runs on the same small mesh,
its tables put into the prototype by ``dataclasses.replace`` (the size rule
builds them only above 16,384 triangles).

Tolerances: ``hit`` is equal on every ray; on hit rays ``t`` agrees to
2e-5 relative: XLA contracts a*b+c into fused multiply-adds on the CPU and
PyTorch does not, so Moller-Trumbore's and Baldwin-Weber's dot products
round differently, by up to 20 float32 ulp on the camera rays and, through
cancellation, more on the short rays from inside the box: the largest
relative difference on these rays is 1.549e-5 for the sweep and 1.168e-5
for the stream (closest hit, all three ``t_max`` kinds); ``tri`` and ``inst``
are equal except on rays where two triangles give exactly the same ``t``,
and the test counts those and expects none.  In any-hit mode only ``hit``
means anything.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracing_tpu.geometry import mesh_bvh as jmesh
from go_raytracing_tpu.ops import pallas_mesh as jpm
from go_raytracing_tpu.ops import pallas_mesh_stream as jpms
from go_raytracing_tpu_torch.geometry import mesh_bvh as tmesh
from go_raytracing_tpu_torch.io import obj as tobj
from go_raytracing_tpu_torch.ops import cuda_mesh as cm
from test_torch_helpers import lucy_instances, mesh_rays

torch.set_num_threads(2)

N_RAYS = 4096
T_MIN = 1e-3
T_RTOL = 2e-5          # just above the largest measured, 1.549e-5


@pytest.fixture(scope="module")
def case():
    verts, tris = tobj.lucy_standin(12, 10)
    insts = lucy_instances(2)
    jp = jmesh.build_proto(verts, tris, insts)
    tp = tmesh.build_proto(verts, tris, insts, torch.device("cpu"))
    st = cm.build_stream_tables(tp.tri_v0.numpy(), tp.tri_e1.numpy(), tp.tri_e2.numpy())
    jst = jpms.build_stream_tables(np.asarray(jp.tri_v0), np.asarray(jp.tri_e1),
                                   np.asarray(jp.tri_e2))
    for a, b in zip(st, jst):
        np.testing.assert_array_equal(a, b)
    jps = dataclasses.replace(jp, s_tri=jnp.asarray(jst[0]),
                              s_tilebox=jnp.asarray(jst[1]), s_n_seg=jst[2])
    tps = dataclasses.replace(tp, s_tri=torch.from_numpy(st[0]),
                              s_tilebox=torch.from_numpy(st[1]), s_n_seg=st[2])
    o, d = mesh_rays(N_RAYS)
    big = np.full(N_RAYS, 3e38, np.float32)
    big[::7] = np.inf                       # counted as BIG
    t_ref, _, _, h_ref, _ = cm.intersect_mesh_kernel(
        tp, torch.from_numpy(o), torch.from_numpy(d), T_MIN, torch.from_numpy(big))
    # a hit ray's t_max between half and one and a half times its hit
    # distance cuts about half the hits; the other rays get BIG / 2
    scale = np.random.default_rng(1).uniform(0.5, 1.5, N_RAYS)
    half = np.where(h_ref.numpy(), t_ref.numpy() * scale, 1.5e38).astype(np.float32)
    dead = np.where(np.arange(N_RAYS) % 2 == 0, -1.0, 3e38).astype(np.float32)
    return dict(protos={"sweep": (jp, tp), "stream": (jps, tps)}, o=o, d=d,
                t_max={"big": big, "half": half, "dead": dead}, jax={})


def _jax_result(c, kernel, any_hit, kind):
    key = (kernel, any_hit, kind)
    if key not in c["jax"]:
        jp = c["protos"][kernel][0]
        old = jpm.INTERPRET, jpms.INTERPRET
        jpm.INTERPRET = jpms.INTERPRET = True
        try:
            fn = (jpm.intersect_mesh_kernel if kernel == "sweep"
                  else jpms.intersect_mesh_stream)
            out = fn(jp, jnp.asarray(c["o"]), jnp.asarray(c["d"]), T_MIN,
                     jnp.asarray(c["t_max"][kind]), any_hit=any_hit)
            c["jax"][key] = [np.asarray(a) for a in out]
        finally:
            jpm.INTERPRET, jpms.INTERPRET = old
    return c["jax"][key]


@pytest.mark.parametrize("kind", ["big", "half", "dead"])
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kernel", ["sweep", "stream"])
def test_plain_kernel_matches_pallas(case, kernel, any_hit, kind):
    c = case
    tp = c["protos"][kernel][1]
    assert cm.kernel_ok(tp)        # the small mesh carries both table sets here
    fn = cm.intersect_mesh_kernel if kernel == "sweep" else cm.intersect_mesh_stream
    before = cm.LAUNCHES_SWEEP, cm.LAUNCHES_STREAM
    t, tri, inst, hit, ovf = (
        a.numpy() if isinstance(a, torch.Tensor) else a
        for a in fn(tp, torch.from_numpy(c["o"]), torch.from_numpy(c["d"]), T_MIN,
                    torch.from_numpy(c["t_max"][kind]), any_hit=any_hit))
    assert (cm.LAUNCHES_SWEEP, cm.LAUNCHES_STREAM) == before   # CPU: no launch
    jt, jtri, jinst, jhit, jovf = _jax_result(c, kernel, any_hit, kind)
    assert ovf == 0 and int(jovf) == 0
    np.testing.assert_array_equal(hit, jhit)
    assert 200 < hit.sum() < N_RAYS - 200
    if kind == "dead":
        assert not hit[::2].any()
    if any_hit:
        return
    assert (t[~hit] == np.float32(3e38)).all() and (tri[~hit] == 0).all() \
        and (inst[~hit] == 0).all()
    np.testing.assert_allclose(t[hit], jt[hit], rtol=T_RTOL, atol=0)
    ties = ((tri != jtri) | (inst != jinst)) & hit
    assert ties.sum() == 0
    if kind == "half":
        n_hit = (c["t_max"]["half"] < 1e38).sum()
        assert 0.3 * n_hit < hit.sum() < 0.7 * n_hit


def test_wrappers_refuse_the_other_size_class(case):
    tp = case["protos"]["sweep"][1]
    o, d = torch.from_numpy(case["o"][:8]), torch.from_numpy(case["d"][:8])
    with pytest.raises(ValueError, match="tile-stream"):
        cm.intersect_mesh_stream(tp, o, d, T_MIN, torch.full((8,), 3e38))
    big = dataclasses.replace(tp, k_n_coarse=0)
    with pytest.raises(ValueError, match="small-mesh"):
        cm.intersect_mesh_kernel(big, o, d, T_MIN, torch.full((8,), 3e38))


@pytest.mark.parametrize("kernel", ["sweep", "stream"])
def test_plain_counts_leave_dead_rays_out(case, kernel):
    """The work counts that the GPU check's bound is made of: a ray whose
    t_max is not above t_min costs no local ray, box or triangle test, and
    only the triangles whose plane t passes go on to Baldwin-Weber's
    barycentrics."""
    tp = case["protos"][kernel][1]
    o, d = torch.from_numpy(case["o"]), torch.from_numpy(case["d"])
    full, half = {}, {}
    cm.plain(kernel, tp, o, d, T_MIN, torch.from_numpy(case["t_max"]["big"]), counts=full)
    cm.plain(kernel, tp, o, d, T_MIN, torch.from_numpy(case["t_max"]["dead"]), counts=half)
    n_live = int((case["t_max"]["dead"] > T_MIN).sum())
    assert n_live == N_RAYS // 2
    assert full["local_rays"] == N_RAYS * tp.n_instances
    assert half["local_rays"] == n_live * tp.n_instances
    for key in ("box_tests", "tri_tests"):
        assert 0.3 * full[key] < half[key] < 0.7 * full[key], key
    if kernel == "stream":
        assert 0 < full["tri_t_pass"] < full["tri_tests"]
    else:
        assert "tri_t_pass" not in full
        # what the sweep's warps do below a tile (``_count_pairs``): the (ray,
        # leaf) pairs hold every leaf the ladder enters, a warp walks a tile
        # or sweeps it in rounds of four pairs
        for c in (full, half):
            assert c["tri_tests"] < cm.LEAF * c["sweep_pairs"]
            assert c["sweep_walk_tiles"] <= c["sweep_warp_tiles"]
            assert 4 * c["sweep_rounds"] < c["sweep_pairs"] + 4 * c["sweep_warp_tiles"]
        assert 0.3 * full["sweep_pairs"] < half["sweep_pairs"] < 0.7 * full["sweep_pairs"]


def test_plain_any_hit_counts_stop_at_the_first_slot_with_a_hit(case):
    """The work counts of the stream's any-hit bound: a ray's tests end with
    its first slot (segment by segment, slot by slot) that holds a hit, as
    the kernel's do, so any hit counts fewer triangle tests than closest hit
    on the same rays, and at least one slot of 128 a ray that hits."""
    tp = case["protos"]["stream"][1]
    o, d = torch.from_numpy(case["o"]), torch.from_numpy(case["d"])
    t_max = torch.from_numpy(case["t_max"]["big"])
    closest, first = {}, {}
    cm.plain("stream", tp, o, d, T_MIN, t_max, counts=closest)
    hit = cm.plain("stream", tp, o, d, T_MIN, t_max, any_hit=True, counts=first)[3]
    assert int(hit.sum()) > 0
    assert int(hit.sum()) * cm.TILE <= first["tri_tests"] < closest["tri_tests"]
    assert first["tri_t_pass"] < closest["tri_t_pass"]
    assert first["box_tests"] <= closest["box_tests"]


def test_sweep_pair_counts_follow_the_walk_rule(case, monkeypatch):
    """How ``cuda_mesh._count_pairs`` splits a warp's tiles between the
    one-lane-a-ray walk and rounds of four pairs follows ``WALK_PER_LANE``:
    a rule never met sweeps every tile with a pair in rounds, at least a
    round for each four pairs; one always met walks them all; the default
    lies between (a quarter of the rays, every t_max BIG)."""
    tp = case["protos"]["sweep"][1]
    n = N_RAYS // 4
    o, d = torch.from_numpy(case["o"][:n]), torch.from_numpy(case["d"][:n])

    def counts(walk):
        monkeypatch.setattr(cm, "WALK_PER_LANE", walk)
        c = {}
        cm.plain("sweep", tp, o, d, T_MIN, torch.from_numpy(case["t_max"]["big"][:n]), counts=c)
        return c

    default, pairs, walks = counts(cm.WALK_PER_LANE), counts(1 << 30), counts(0)
    assert pairs["sweep_walk_tiles"] == 0 and walks["sweep_rounds"] == 0
    assert 0 < walks["sweep_walk_tiles"] <= walks["sweep_warp_tiles"] == default["sweep_warp_tiles"]
    assert default["sweep_pairs"] <= 4 * pairs["sweep_rounds"]
    assert 4 * pairs["sweep_rounds"] < default["sweep_pairs"] + 4 * default["sweep_warp_tiles"]
    assert default["sweep_rounds"] <= pairs["sweep_rounds"]
