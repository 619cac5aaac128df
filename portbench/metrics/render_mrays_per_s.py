"""render_mrays_per_s: camera rays (width x height x spp) of every frame
completed in the window, over the window's seconds, in millions.  Host
clock; each frame ends with its picture on the host."""

SOURCE = "host_clock"
UNIT = "Mrays/s"


def read(run):
    return run.rays_per_call * len(run.spans) / run.window_s / 1e6
