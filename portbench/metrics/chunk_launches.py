"""chunk_launches.<render|grad>: device kernels launched a frame or a
gradient step (the entry points and their chunk loop: every kernel of the
call, glue and hand-written alike), from the trace."""

SOURCE = "device_trace"
UNIT = "launches"


def read(run):
    n = len(run.trace.kernels())
    return n / len(run.spans) if n else None
