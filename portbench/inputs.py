"""Inputs the benchmark makes itself and hands to both the program and the
plain reference: the environment array a configuration names, and the seed
of every call a run makes, all drawn from the configuration and ``--seed``."""

from __future__ import annotations

import numpy as np

# The sun of the synthetic sky: texels within this many of its centre, at
# about SUN_GAIN times the map's mean radiance.
SUN_RADIUS, SUN_GAIN = 4, 100.0


def synthetic_sky(seed=7, h=512, w=1024):
    """An [h, w, 3] equirect environment from a fixed numpy seed, at the
    resolution of a "1k" map: a smooth sky gradient over a darker ground, a
    little seeded noise, and a small sun."""
    rng = np.random.default_rng(seed)
    v = (np.arange(h) + 0.5) / h
    elev = (0.5 - v) * np.pi
    up = np.clip(np.sin(elev), 0.0, 1.0)[:, None, None]
    horizon = np.array([1.0, 0.92, 0.82], np.float32)
    zenith = np.array([0.25, 0.45, 1.0], np.float32)
    ground = np.array([0.30, 0.26, 0.22], np.float32)
    sky = horizon * (1.0 - up) + zenith * up
    data = np.where((elev > 0)[:, None, None], sky, ground).astype(np.float32)
    data = np.broadcast_to(data, (h, w, 3)) * rng.uniform(0.95, 1.05, (h, w, 1))
    data = data.astype(np.float32)
    cy, cx = h // 4, (3 * w) // 8
    yy, xx = np.mgrid[0:h, 0:w]
    sun = (yy - cy) ** 2 + (xx - cx) ** 2 <= SUN_RADIUS ** 2
    data[sun] = SUN_GAIN * float(data.mean()) * np.array([1.0, 0.95, 0.85], np.float32)
    return data


def environment(config: dict):
    """The configuration's environment array, or None."""
    env = config.get("environment")
    if env is None:
        return None
    if env["kind"] != "synthetic_sky":
        raise ValueError(f"no maker for the environment {env['kind']!r}")
    return synthetic_sky(env["seed"], env["height"], env["width"])


# Streams of seeds drawn from --seed, one per use.
CALLS, TARGET, SAMPLE = 0, 1, 2


def seeds(seed: int, stream: int, n: int):
    """``n`` 32-bit seeds for the calls of one stream of a run."""
    return [int(x) for x in np.random.SeedSequence([seed % (1 << 64), stream]).generate_state(n)]


def sampler(seed: int):
    """The generator, from ``--seed``, that picks which answers to check."""
    return np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), SAMPLE]))
