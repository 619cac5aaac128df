"""The yardstick of the roofline metrics: the card's published peak and the
bytes a layer needs, computed from the configuration's shapes.

Peak: one NVIDIA H100 SXM, 80 GB of HBM3 at 3.35 TB/s (NVIDIA's data
sheet), at its 700 W limit.  A layer's bound is the least time that the
bytes its function must read and write take at that rate; its share is
the bound over the device time the trace gives the layer's kernels.  Each
input byte is counted once and each output byte once, whatever the
kernels read again.  What passes between the program's own stages is not
counted: the gradient stash between B2 and B3, the miss records the
megakernel writes for the miss shader run after it, the miss colour and
cotangent rows computed from them for the reverse sweep.  A design
without them reads against the same work.  The environment enters as its
texels, read once a launch, and the sample rows of its NEE (drawn for
scenes with quad lights beside it), which are the function's own draws.
"""

from __future__ import annotations

from .reference import scene as sc

PEAK_BYTES_PER_S = 3.35e12
F32 = 4
RAY_IN_ROWS = 8         # origin 3, direction 3, time, stream id
RADIANCE_ROWS = 3
COTANGENT_ROWS = 3
HDRI_ROWS = 7           # an environment sample a bounce: direction 3, emission 3, pdf


def table_bytes(config: dict, sky) -> int:
    """Bytes of the scene tables a tracing kernel reads (planar, sphere,
    volume and light rows), built on the host as the reference builds
    them."""
    tb = _scene(config, sky).tables
    return F32 * (sc.PT_ROWS * tb.n_planar + sc.ST_ROWS * tb.n_sphere
                  + sc.VT_ROWS * tb.n_vol + sc.LT_ROWS * tb.n_lights)


def _scene(config: dict, sky):
    """The reference's tables of the configuration, without its environment
    (only the environment's size enters the counts)."""
    return sc.build(config, None, "cpu")


def hdri_rows_per_ray(config: dict, sky) -> int:
    """Environment-sample rows a ray reads: 7 a bounce where the scene has
    an environment beside its quad lights."""
    tb = _scene(config, sky).tables
    return HDRI_ROWS * config["max_depth"] if sky is not None and tb.n_lights else 0


def env_texel_bytes(sky) -> int:
    """Bytes of the environment's texels, float32 RGB; 0 without one."""
    return 0 if sky is None else F32 * 3 * sky.shape[0] * sky.shape[1]


def megakernel_bytes(config: dict, sky, rays: int, launches: int) -> int:
    """B1 over ``rays`` camera rays in ``launches`` launches: rays in,
    radiance out, the environment's sample rows, the tables and the
    environment's texels once a launch."""
    per_ray = F32 * (RAY_IN_ROWS + RADIANCE_ROWS + hdri_rows_per_ray(config, sky))
    return rays * per_ray + launches * (table_bytes(config, sky) + env_texel_bytes(sky))


def grad_kernels_bytes(config: dict, sky, rays: int, launches: int) -> int:
    """The gradient kernels over ``rays`` camera rays (B2 + B3, B5a + B5b,
    or B4): rays and the cotangent in, radiance out, the environment's
    sample rows in; once a launch the tables and the environment's texels
    in, and the gradients out: colours (3 variants x 3 channels a texture),
    fuzz and IOR (a material each) and the texels' (as many as the
    texels)."""
    ref = _scene(config, sky)
    per_ray = F32 * (RAY_IN_ROWS + COTANGENT_ROWS + RADIANCE_ROWS
                     + hdri_rows_per_ray(config, sky))
    out = F32 * (9 * ref.n_tex + 2 * ref.n_mat) + env_texel_bytes(sky)
    return rays * per_ray + launches * (table_bytes(config, sky) + env_texel_bytes(sky) + out)


def share_pct(bytes_moved: float, device_s: float):
    """The bound's share of the measured device time, in %, or None where
    nothing was measured."""
    if device_s <= 0:
        return None
    return 100.0 * (bytes_moved / PEAK_BYTES_PER_S) / device_s
