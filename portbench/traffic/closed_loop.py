"""One client in a closed loop: the next call starts when the last one has
returned.  The users are one artist waiting for each frame, or one fitting
job waiting for each gradient before its parameter update.

The traffic file names the call and its parameters:

  ``"call": "frame"``      ``render_image`` with seed k of the run's call
                           seeds; the picture copied to the host.
  ``"call": "grad_step"``  ``render_grad`` against a target made in set-up
                           (the scene's framebuffer at another seed, times
                           ``target_scale``), seed k of the call seeds.
  ``"check_answers"``      how many answers of the window are compared with
                           the plain reference: the last one and a sample
                           of the rest drawn from ``--seed``.

The numbers compared (``compare``):

  frames:  ``frame_off_share``, the share of the picture's channels that
           differ from the reference's by more than ``OFF_BY``, and
           ``frame_mean_abs``, the mean absolute difference;
  steps:   ``loss_rel``, the loss's relative gap, and ``grad_rel``, the
           largest gap of a gradient entry over its gradient's largest
           reference entry, over every gradient that either side returns:
           one the program leaves out reads 1, and one whose reference is
           all zero, or missing, is measured against the largest entry of
           all.
"""

from __future__ import annotations

import time

from .. import inputs

OFF_BY = 1e-3


class Job:
    def __init__(self, params, program, scene, cam, seed, device):
        self.params, self.program = params, program
        self.scene, self.cam, self.device = scene, cam, device
        self.seeds = inputs.seeds(seed, inputs.CALLS, 1 << 16)
        self.kind = params["call"]
        self.target = None
        self.ref_targets = {}   # the reference's target, by ``hold``
        self.target_seed = inputs.seeds(seed, inputs.TARGET, 1)[0]
        if self.kind not in ("frame", "grad_step"):
            raise ValueError(f"no call {self.kind!r}")

    # ---- set-up and the window -------------------------------------------
    def setup(self):
        if self.kind == "grad_step":
            self.target = self.program.target(self.scene, self.cam, self.target_seed,
                                              self.params["target_scale"])

    def call(self, k):
        """Call k of the run (its seed is ``self.seeds[k]``)."""
        if self.kind == "frame":
            return self.program.frame(self.scene, self.cam, self.seeds[k])
        return self.program.grad_step(self.scene, self.cam, self.target, self.seeds[k])

    def rays_per_call(self):
        return self.program.camera_rays(self.cam)

    def window(self, seconds, sampler):
        """Calls back to back until ``seconds`` have passed.  Returns the
        [(start, end)] host times of each call, the answers kept for the
        comparison ({call index: answer}) and the window's length (the end
        of the last call).

        The answers kept are the last call's and a uniform sample of
        ``check_answers`` - 1 of all calls, drawn by ``sampler`` (a numpy
        Generator from ``--seed``) by reservoir sampling, so that the run
        holds no more than ``check_answers`` answers between calls and its
        peak of device memory is the calls' own."""
        slots = int(self.params["check_answers"]) - 1
        sample, last = {}, None
        spans = []
        t0 = time.perf_counter()
        k = 0
        while True:
            a = time.perf_counter()
            answer = self.call(k)
            b = time.perf_counter()
            spans.append((a - t0, b - t0))
            j = k if k < slots else int(sampler.integers(0, k + 1))
            if j < slots:
                sample[j] = (k, answer)
            last = (k, answer)
            del answer
            k += 1
            if b - t0 >= seconds:
                kept = dict(sample.values())
                kept[last[0]] = last[1]
                return spans, kept, b - t0

    def reference(self, jobs, ref, k, hold=None):
        """The plain reference's answer to call k (``hold``: see
        ``reference/jobs``)."""
        hold = hold or jobs.wf.keep
        if self.kind == "frame":
            return jobs.frame(ref, self.seeds[k], hold=hold, device=self.device).cpu()
        if hold not in self.ref_targets:
            fb = jobs.framebuffer(ref, self.target_seed, hold=hold, device=self.device)
            w, h = self.cam.image_width, self.cam.image_height
            self.ref_targets[hold] = (fb.reshape(h, w, 3) / self.cam.samples_per_pixel
                                      * self.params["target_scale"])
        return jobs.grad_step(ref, self.seeds[k], self.ref_targets[hold], hold=hold,
                              device=self.device)


def compare(kind, got, ref):
    """The numbers compared for one answer (see the module docstring)."""
    if kind == "frame":
        diff = (got.float().cpu() - ref.float().cpu()).abs()
        return {"frame_off_share": float((diff > OFF_BY).float().mean()),
                "frame_mean_abs": float(diff.mean())}
    loss, grads = got
    rloss, rgrads = ref
    loss_rel = abs(float(loss) - float(rloss)) / max(abs(float(rloss)), 1e-30)
    scales = {k: float(v.abs().max()) for k, v in rgrads.items()}
    biggest = max(scales.values())
    worst = 0.0
    for k in sorted(set(grads) | set(rgrads)):
        g, r = grads.get(k), rgrads.get(k)
        if g is None:
            worst = max(worst, 1.0)
            continue
        if r is None:
            gap = float(g.abs().max())
        else:
            gap = float((g.float() - r.to(g.device)).abs().max())
        scale = scales.get(k, 0.0) or biggest
        worst = max(worst, gap / scale)
    return {"loss_rel": loss_rel, "grad_rel": worst}


def worst(readings):
    """The largest reading of each number over several answers."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out
