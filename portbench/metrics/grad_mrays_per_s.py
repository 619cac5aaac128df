"""grad_mrays_per_s: camera rays (width x height x spp) of every gradient step
completed in the window, over the window's seconds, in millions.  Host
clock; each step ends once its loss and every gradient are synchronised."""

SOURCE = "host_clock"
UNIT = "Mrays/s"


def read(run):
    return run.rays_per_call * len(run.spans) / run.window_s / 1e6
