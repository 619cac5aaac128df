"""The fused tier against the replay tier, in the JAX package and in the port,
over seeds (ROADMAP C11).  Not a test (pytest does not collect it): the JAX
fused kernel in Pallas interpret mode takes about 13 minutes to compile here
with the marble, and the question is a spread, not a bound.

    JAX_PLATFORMS=cpu python tests/torch_fused_replay_gap.py [--seeds 0,1,2,3,4]

The marble-glossy-nee scene (the noise + glossy scene under an environment
with its quad light: HDRI next-event estimation, the fused tier) at 16x16,
4 spp, depth 3, under ``chip_smoke.synthetic_sky()`` (1024x512, a small sun),
a target of uniform draws from ``numpy.random.default_rng(100 + seed)``.  For
each seed it prints one JSON line: the gradients' gap between the fused and
the replay tier of each package (the JAX package's replay tier by
``GRT_NO_GRADKERNEL=1``; the port's fused tier is its plain version on the
CPU), as the largest absolute difference over the largest entry of the
replay tier's, per key, and the port's fused tier against the JAX one's."""

import argparse
import json
import os
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

KEYS = ("color", "fuzz", "ior", "env_data")


def gap(a, b):
    out = {}
    for k in KEYS:
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        big = np.abs(y).max()
        out[k] = float(np.abs(x - y).max() / big) if big > 0 else None
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3,4")
    args = ap.parse_args()

    import jax
    import go_raytracing_tpu as grt
    import go_raytracing_tpu_torch as grtt
    from go_raytracing_tpu.ops import pallas_wavefront as mega
    from go_raytracing_tpu.render.grad import render_grad as jrender_grad
    from go_raytracing_tpu_torch.render import grad as tgrad
    from chip_smoke import synthetic_sky
    from test_torch_helpers import NOISE_GLOSSY_CAM, build_noise_glossy

    torch.set_num_threads(2)
    sky = synthetic_sky()[0]
    cam = {**NOISE_GLOSSY_CAM, "image_width": 16, "samples_per_pixel": 4, "max_depth": 3}
    js, jcam = build_noise_glossy(grt, env=sky), grt.Camera(**cam)
    ts, tcam = build_noise_glossy(grtt, env=sky, device="cpu"), grtt.Camera(**cam)
    assert tgrad.grad_tier(ts, cam["max_depth"]) == "fused"
    mega.INTERPRET, mega.BLOCK_ROWS = True, 8
    for seed in (int(s) for s in args.seeds.split(",")):
        target = np.random.default_rng(100 + seed).uniform(
            0.05, 0.5, (16, 16, 3)).astype(np.float32)
        rec = {"seed": seed}
        t0 = time.perf_counter()
        os.environ.pop("GRT_NO_GRADKERNEL", None)
        _, jf = jrender_grad(js, jcam, jax.numpy.asarray(target), seed=seed)
        os.environ["GRT_NO_GRADKERNEL"] = "1"
        try:
            _, jr = jrender_grad(js, jcam, jax.numpy.asarray(target), seed=seed)
        finally:
            os.environ.pop("GRT_NO_GRADKERNEL", None)
        tt = torch.from_numpy(target)
        _, tf = grtt.render_grad(ts, tcam, tt, seed=seed, device="cpu")
        _, tr = tgrad._render_grad_replay(ts, tcam, tt, spp=cam["samples_per_pixel"],
                                          max_depth=cam["max_depth"], seed=seed,
                                          chunk=None, stats=None, dec_budget=None)
        tf = {k: tf[k].numpy() for k in KEYS}
        rec["jax_gap"] = gap({k: jf[k] for k in KEYS}, {k: jr[k] for k in KEYS})
        rec["port_gap"] = gap(tf, {k: tr[k].numpy() for k in KEYS})
        rec["port_fused_vs_jax_fused"] = gap(tf, {k: jf[k] for k in KEYS})
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
