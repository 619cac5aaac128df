"""setup_s: seconds from the harness's start to the window's: torch and
CUDA start, the kernels loaded (built by nvcc on a checkout's first run),
the scene, its environment and alias table, the call seeds, a fitting job's
target, and the warm-up calls on the cell's own shapes.  Host clock."""

SOURCE = "host_clock"
UNIT = "s"


def read(run):
    return run.setup_s
