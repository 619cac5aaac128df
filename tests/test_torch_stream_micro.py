"""PyTorch port vs the JAX package: the tile-sweep probe of the mesh stream
(``scripts/stream_micro.py``, B10's sweep alone), five variants.

The JAX side is the script's own kernel (``make_kernel``, the script
imported by path) under ``pl.pallas_call`` with the script's block specs,
in interpret mode; the port runs its plain version.  2 blocks x 64 sweeps,
the script's inputs.  XLA contracts a*b+c into fused multiply-adds on the
CPU and PyTorch does not, so t is held to rtol 2e-5 and the winner's id
must be the same wherever no other candidate's t lies within that
tolerance of the winner's."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from go_raytracing_tpu_torch.utils import stream_micro as sm

torch.set_num_threads(2)

N_BLOCKS, N_SWEEPS = 2, 64
SCRIPT = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "stream_micro.py"


def _jax_probe(rays, tri, variant):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    spec = importlib.util.spec_from_file_location("stream_micro_script", SCRIPT)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    roll, dyn_tri, use_while = sm.VARIANTS[variant]
    n_blocks = rays.shape[0]
    spec_r = pl.BlockSpec((1, 7, 8, 128), lambda i: (i, 0, 0, 0),
                          memory_space=pltpu.VMEM)
    out_spec = pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0),
                            memory_space=pltpu.VMEM)
    fn = pl.pallas_call(
        script.make_kernel(N_SWEEPS, roll=roll, dyn_tri=dyn_tri,
                           use_while=use_while),
        grid=(n_blocks,),
        in_specs=[spec_r, pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=[out_spec, out_spec],
        out_shape=[jax.ShapeDtypeStruct((n_blocks, 8, 128), jnp.float32),
                   jax.ShapeDtypeStruct((n_blocks, 8, 128), jnp.int32)],
        interpret=True)
    t, ids = fn(jnp.asarray(rays.numpy()), jnp.asarray(tri.numpy()))
    return np.asarray(t), np.asarray(ids)


@pytest.mark.parametrize("variant", list(sm.VARIANTS))
def test_probe_plain_matches_interpret_pallas(variant):
    rays, tri = sm.probe_inputs(N_BLOCKS)
    t, ids = sm.stream_micro(rays, tri, N_SWEEPS, variant)
    assert sm.LAUNCHES == 0
    j_t, j_ids = _jax_probe(rays, tri, variant)
    t, ids = t.numpy(), ids.numpy()
    hit = j_t < 1e38
    assert hit.sum() >= 10, "too few hits to show a fault"
    assert ((t < 1e38) == hit).all()
    np.testing.assert_allclose(t, j_t, rtol=2e-5)
    # outputs where a passing candidate of another triangle lies within the
    # tolerance of the winner's t: there rounding may pick either
    near = np.zeros(t.shape, dtype=bool)
    for slot in sm.slots(N_SWEEPS, variant):
        ct, ok, pid = (x.numpy() for x in sm._candidates(rays, tri, slot, variant))
        near |= ok & (pid != ids) & (np.abs(ct - t) <= 2e-5 * np.abs(t))
    np.testing.assert_array_equal(ids[~near], j_ids[~near])
