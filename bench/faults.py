"""Faults planted under the timed path, to show that a broken program comes out not correct.

``plant(name)`` patches the port's entry points, or the benchmark's glue to
them, in this process:

- ``unchanged``: a fit that returns its starting state (Adam's steps run and
  are thrown away);
- ``half_batch``: half of the training rows left out, the posterior or the
  NLML then taken over the rest;
- ``altered``: one answer altered where it is produced (a mean a third of
  the way down by 5% of the largest |mean|; the fitted lengthscale by 5%).

The cells run on one card, so there is no exchange between cards to leave
out.  The benchmark's own runs never plant a fault: ``bench/tests`` and
``python3 -m bench.control --fault`` do.
"""

from __future__ import annotations


def _unchanged() -> None:
    from repro_torch.core import mll

    inner = mll.adam

    def adam(loss, raw0, steps, lr):
        _, losses = inner(loss, raw0, steps, lr)
        return raw0, losses

    mll.adam = adam


def _half_batch() -> None:
    from bench import program

    inner = program.make_gp

    def make_gp(cfg, x, y, device):
        return inner(cfg, x[: x.shape[0] // 2], y[: y.shape[0] // 2], device)

    program.make_gp = make_gp


def _altered() -> None:
    from repro_torch.core import GaussianProcess

    predict, pwu, optimize = GaussianProcess.predict, GaussianProcess.predict_with_uncertainty, GaussianProcess.optimize

    def alter(t):
        t = t.clone()
        t[t.shape[0] // 3] += 0.05 * t.abs().max()
        return t

    def predict_altered(self, x):
        return alter(predict(self, x))

    def pwu_altered(self, x):
        mean, var = pwu(self, x)
        return alter(mean), var

    def optimize_altered(self, *args, **kwargs):
        optimize(self, *args, **kwargs)
        p = self.params
        self.params = type(p)(p.lengthscale * 1.05, p.vertical, p.noise)
        return self

    GaussianProcess.predict = predict_altered
    GaussianProcess.predict_with_uncertainty = pwu_altered
    GaussianProcess.optimize = optimize_altered


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered": _altered}


def plant(name: str) -> None:
    FAULTS[name]()
