"""GP serve and train step factories: fleet-aware and mesh-aware.

A factory takes a GP front-end and an optional ``DeviceMesh`` and returns
``(step_fn, shardings)``, as the language-model factories do.  GP steps
close over a stateful front-end (the posterior cache lives on the object),
so the factory (a) installs the mesh on the front-end, whose fleets then
split their problem axis over the mesh's DP axes (DESIGN.md §12,
:mod:`repro_torch.dist.sharding`), and (b) puts the three front-ends behind
one callable signature:

* :class:`~repro_torch.core.gp.GaussianProcess`: one problem, nothing to
  split, so the mesh is ignored (the same launch script drives one GP or a
  fleet);
* :class:`~repro_torch.core.gp.GPBatch`: a stacked (B, n, D) fleet; each
  rank runs its contiguous slice of B;
* :class:`~repro_torch.core.gp.GPFleet`: a ragged bucketed fleet; each
  bucket is split when its width divides the DP axes, replicated otherwise.

Every rank builds the front-end from the same data and makes the same
calls; results come back global on every rank.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.gp import GaussianProcess, GPBatch, GPFleet
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shard_rules


def attach_mesh(gp, mesh):
    """Install ``mesh`` on a GP front-end; returns the front-end.

    The mesh is part of a fleet's cache key, so a change of mesh invalidates
    cached factors.  A :class:`GaussianProcess` has no problem axis: the
    mesh is ignored.
    """
    coll.check_mesh(mesh, "attach_mesh")
    if mesh is None or isinstance(gp, GaussianProcess):
        return gp
    if not isinstance(gp, (GPBatch, GPFleet)):
        raise TypeError(f"attach_mesh expects GaussianProcess/GPBatch/GPFleet; got {type(gp).__name__}")
    gp.mesh = mesh  # GPBatch slices its stacks at each call; GPFleet splits its buckets as it builds them
    return gp


def _gp_shardings(gp, mesh) -> Optional[dict]:
    """What each rank holds: for a GPBatch its rows of B and the axes they split over."""
    if mesh is None or isinstance(gp, GaussianProcess):
        return None
    if isinstance(gp, GPBatch):
        b = gp.batch_size
        return {"x_test": shard_rules.fleet_spec(mesh, b, 3), "batch_axes": shard_rules.fleet_axes(mesh, b)}
    return {"mesh": mesh}  # GPFleet: bucket widths vary, so the split is per bucket


def make_gp_serve_step(gp, mesh=None, *, uncertainty: bool = False):
    """``serve(x_test)`` for any GP front-end.

    ``x_test`` follows the front-end's own convention: an (n̂, D) block for
    :class:`GaussianProcess`, shared or stacked for :class:`GPBatch`, and for
    :class:`GPFleet` one shared (n̂, D) block or a length-B list of
    per-problem test sets (routed to ``predict_each``).  With
    ``uncertainty`` the step returns ``(mean, variance_diagonal)``.  Returns
    ``(serve_fn, shardings)``; ``shardings`` is None without a mesh.
    """
    attach_mesh(gp, mesh)

    def serve(x_test):
        if isinstance(gp, GPFleet) and isinstance(x_test, (list, tuple)):
            return gp.predict_each(x_test, full_cov=uncertainty)
        if uncertainty:
            return gp.predict_with_uncertainty(x_test)
        return gp.predict(x_test)

    return serve, _gp_shardings(gp, mesh)


def make_gp_train_step(gp, mesh=None, *, lr: float = 0.05):
    """``train(steps=1) -> nlml`` for any GP front-end.

    One call runs ``steps`` Adam iterations on the NLML through the
    front-end's ``optimize`` and returns the NLML after them: a scalar for
    one GP, the (B,) vector for a fleet.  ``optimize`` invalidates the
    cache, so the next serve step refactorizes under the new
    hyperparameters.  :class:`GPFleet` has no batched optimizer (its
    buckets have different geometries): its train step raises
    ``NotImplementedError``.
    """
    attach_mesh(gp, mesh)
    if isinstance(gp, GPFleet):
        def train(steps: int = 1):
            raise NotImplementedError(
                "GPFleet has no batched hyperparameter optimizer; train each bucket as a GPBatch "
                "(shared geometry) or per-problem GaussianProcess.optimize instead"
            )
        return train, _gp_shardings(gp, mesh)

    def train(steps: int = 1):
        gp.optimize(steps=steps, lr=lr)
        return gp.nlml()

    return train, _gp_shardings(gp, mesh)
