"""Carry hyperparameters and cached states across from the JAX package.

The JAX package's kernel params trees, ``PosteriorState`` and
``LowRankState`` (of one problem, or stacked by a ``GPBatch`` or a
``GPFleet`` bucket), and its language models' parameter trees, hold JAX
arrays; the caller hands their leaves over as numpy arrays (``np.asarray(leaf)``),
so this module needs neither JAX nor the ``repro`` package.  The tensors it
builds keep the numpy dtypes and go to ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import executor
from repro_torch.core import kernels_math as km
from repro_torch.core.lowrank import LowRankState
from repro_torch.core.predict import PosteriorState
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Transformer


def params_from_numpy(lengthscale, vertical, noise) -> km.SEKernelParams:
    """SE hyperparameters from the leaves of the JAX ``SEKernelParams``.

    Each leaf (a numpy scalar, 0-d array or Python float) becomes a Python
    float.
    """
    return km.SEKernelParams(
        float(np.asarray(lengthscale)), float(np.asarray(vertical)), float(np.asarray(noise))
    )


def kernel_params_from_numpy(kernel, leaves):
    """The params tree of any registered family or composite from the JAX tree's leaves.

    ``leaves`` are the JAX params pytree's leaves as numpy arrays, in JAX's
    order (``[np.asarray(l) for l in jax.tree.leaves(params)]``: dataclass
    fields in declaration order, tuple items in order), which is the port's
    :func:`repro_torch.core.kernels_math.tree_flatten` order.  A 0-d leaf
    becomes a Python float, a vector leaf (ARD lengthscales, or a fleet's
    per-problem (B,) leaf) a tensor copy.
    """
    kernel = km.resolve_kernel(kernel)
    template, treedef = km.tree_flatten(kernel.default_params())
    leaves = [np.asarray(leaf) for leaf in leaves]
    if len(leaves) != len(template):
        raise ValueError(f"{kernel.kernel_id()} has {len(template)} hyperparameter leaves, got {len(leaves)}")
    return km.tree_unflatten(
        treedef, [float(a) if a.ndim == 0 else torch.from_numpy(np.array(a)) for a in leaves]
    )


def _params_to(params, dev):
    """The params tree with its tensor leaves moved to ``dev``."""
    return km.tree_map(lambda l: l.to(dev) if isinstance(l, torch.Tensor) else l, params)


def posterior_state_from_numpy(
    lpacked,
    alpha,
    x_chunks,
    n: int,
    m: int,
    params: km.SEKernelParams,
    beta=None,
    y_chunks=None,
    *,
    n_valid=None,
    kernel=None,
    device="cuda",
) -> PosteriorState:
    """The port's :class:`PosteriorState` from the fields of a JAX one.

    ``lpacked`` (T, m, m), ``alpha`` (M, m), ``x_chunks`` (M, m, D) and the
    optional ``beta`` / ``y_chunks`` (M, m) are numpy arrays; ``params``
    comes from :func:`params_from_numpy` or :func:`kernel_params_from_numpy`.
    A stacked state of a ``GPBatch`` or of a ``GPFleet`` bucket has the
    leading B axis on every array, per-problem leaves (B,) in ``params``,
    and, for a ragged bucket, ``n_valid`` (B,) frontiers (``n`` is then the
    bucket's capacity).
    """
    dev = resolve_device(device)

    def t(a):
        return None if a is None else torch.from_numpy(np.array(a)).to(dev)

    lp, al, xc = t(lpacked), t(alpha), t(x_chunks)
    lead = xc.shape[:-3]
    m_tiles = xc.shape[-3]
    if xc.ndim not in (3, 4) or lp.shape != lead + (m_tiles * (m_tiles + 1) // 2, m, m) \
            or al.shape != lead + (m_tiles, m):
        raise ValueError(
            f"inconsistent state: lpacked {tuple(lp.shape)}, alpha {tuple(al.shape)}, "
            f"x_chunks {tuple(xc.shape)} for tile size {m}"
        )
    nv = None
    if n_valid is not None:
        nv = torch.from_numpy(np.asarray(n_valid, np.int32).reshape(-1).copy()).to(dev)
        if not lead or nv.shape != lead:
            raise ValueError(f"n_valid {tuple(nv.shape)} needs a stacked state of {lead} problems")
    return PosteriorState(
        lpacked=lp, alpha=al, x_chunks=xc, n=int(n), m=int(m), params=_params_to(params, dev),
        beta=t(beta), y_chunks=t(y_chunks), n_valid=nv, kernel=km.resolve_kernel(kernel),
    )


def lowrank_state_from_numpy(
    u_chunks,
    luu_packed,
    b_packed,
    lb_packed,
    c_chunks,
    gamma,
    yty,
    n: int,
    m: int,
    m_inducing: int,
    params: km.SEKernelParams,
    jitter: float,
    mu_valid=None,
    n_valid=None,
    *,
    kernel=None,
    device="cuda",
) -> LowRankState:
    """The port's :class:`LowRankState` from the fields of a JAX one.

    ``u_chunks`` (MU, m, D), the packed (T, m, m) stores ``luu_packed``,
    ``b_packed`` and ``lb_packed``, ``c_chunks`` / ``gamma`` (MU, m) and the
    scalar ``yty`` are numpy arrays; ``mu_valid`` is None or the count of
    distinct inducing points; ``params`` comes from :func:`params_from_numpy`
    or :func:`kernel_params_from_numpy`.  A ``GPBatch`` state has the
    leading B axis on every array (``yty`` (B,)) and may have (B,) leaves.
    A ragged one (a ``GPFleet`` bucket) also has ``n_valid`` (B,) and
    per-problem ``mu_valid`` (B,), which become (B,) int32 tensors on the
    device.  The field the port adds, ``c_w = L_uu^-1 c``, is solved from
    them (K_un's columns past a problem's ``n_valid`` are zero, so this is
    W y of its valid rows).
    """
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    uc, c, g = t(u_chunks), t(c_chunks), t(gamma)
    stores = [t(a) for a in (luu_packed, b_packed, lb_packed)]
    lead = uc.shape[:-3]
    mu_tiles = uc.shape[-3]
    shape = lead + (mu_tiles * (mu_tiles + 1) // 2, m, m)
    if any(a.shape != shape for a in stores) or c.shape != lead + (mu_tiles, m) or g.shape != c.shape:
        raise ValueError(
            f"inconsistent state: u_chunks {tuple(uc.shape)}, stores "
            f"{[tuple(a.shape) for a in stores]}, c_chunks {tuple(c.shape)}, gamma "
            f"{tuple(g.shape)} for tile size {m}"
        )
    def counts(a, what):
        v = torch.from_numpy(np.asarray(a, np.int32).reshape(-1).copy()).to(dev)
        if not lead or v.shape != lead:
            raise ValueError(f"{what} {tuple(v.shape)} needs a stacked state of {lead} problems")
        return v

    nv = None if n_valid is None else counts(n_valid, "n_valid")
    mv = None if mu_valid is None else np.asarray(mu_valid).reshape(-1)
    if mv is not None and (nv is not None or len(set(mv.tolist())) != 1):
        mv = counts(mv, "mu_valid")  # per problem, as a ragged state keeps it
    elif mv is not None:
        mv = int(mv[0])
    return LowRankState(
        u_chunks=uc, luu_packed=stores[0], b_packed=stores[1], lb_packed=stores[2],
        c_chunks=c, gamma=g, c_w=executor.run_solve(stores[0], c, lower=True, device=dev),
        yty=t(yty).reshape(lead), n=int(n), m=int(m),
        m_inducing=int(m_inducing), params=_params_to(params, dev), jitter=float(jitter),
        mu_valid=mv, n_valid=nv, kernel=km.resolve_kernel(kernel),
    )


def _tensor_from_numpy(a) -> torch.Tensor:
    """A tensor copy of a numpy array; bfloat16 arrays (ml_dtypes) keep their bits."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def lm_params_from_numpy(tree, cfg, device="cuda"):
    """The port's :class:`~repro_torch.models.transformer.Transformer` from the JAX parameter tree.

    ``tree`` is the reference's ``init_model`` pytree with numpy leaves
    (``jax.tree.map(np.asarray, params)``): ``embed``, ``final_norm``,
    ``lm_head`` when untied, ``groups`` (one dict per pattern position,
    each leaf stacked over cycles) and ``tail``.  Layer ``l`` takes
    ``groups[l % len(pattern)]`` at cycle ``l // len(pattern)``, the tail
    after.  Every parameter of the module must be given, in its shape.
    """
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev)
    plen = len(cfg.pattern)
    n_cycled = cfg.n_layers // plen * plen
    loaded = {}

    def walk(prefix, sub, index):
        for key, val in sub.items():
            name = f"{prefix}{key}"
            if isinstance(val, dict):
                walk(f"{name}.", val, index)
            else:
                loaded[name] = _tensor_from_numpy(val if index is None else np.asarray(val)[index])

    walk("", {k: v for k, v in tree.items() if k not in ("groups", "tail")}, None)
    for l in range(cfg.n_layers):
        if l < n_cycled:
            walk(f"layers.{l}.", tree["groups"][l % plen], l // plen)
        else:
            walk(f"layers.{l}.", tree["tail"][l - n_cycled], None)
    state = model.state_dict()
    if set(loaded) != set(state):
        raise ValueError(
            f"parameter trees differ: missing {sorted(set(state) - set(loaded))}, "
            f"unexpected {sorted(set(loaded) - set(state))}"
        )
    for name, t in loaded.items():
        if tuple(t.shape) != tuple(state[name].shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the port's is {tuple(state[name].shape)}")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(loaded[name])
    return model


def lm_opt_state_from_numpy(tree, params, optimizer):
    """The port's optimizer state from the reference's, for the port's ``params`` (a ``Transformer``).

    ``tree`` is the JAX package's ``Adam`` state (``m``, ``v``: parameter
    trees; ``step``) or ``Adafactor`` state (``v``: a parameter tree of
    ``{"vr", "vc"}`` or ``{"v"}`` leaves; ``step``) with numpy leaves.
    Layer ``l`` takes ``groups[l % len(pattern)]`` at cycle ``l //
    len(pattern)``, the tail after, as :func:`lm_params_from_numpy`.  Every
    moment lands on its parameter's device, float32.
    """
    from repro_torch.optim import Adafactor, Adam
    from repro_torch.tree import leaves_with_paths, path_str

    cfg = params.cfg
    named = dict(params.named_parameters())
    plen = len(cfg.pattern)
    n_cycled = cfg.n_layers // plen * plen

    def by_name(ptree, leaf_keys=None):
        """name -> moment (or, with ``leaf_keys``, name -> {key: moment}) from a parameter-shaped tree."""
        out = {}

        def take(val, index):
            a = np.asarray(val)
            return torch.from_numpy(np.array(a if index is None else a[index], dtype=np.float32))

        def walk(prefix, sub, index):
            for key, val in sub.items():
                name = f"{prefix}{key}"
                if isinstance(val, dict) and not (leaf_keys and set(val) <= leaf_keys):
                    walk(f"{name}.", val, index)
                elif isinstance(val, dict):
                    out[name] = {k: take(v, index).to(named[name].device) for k, v in val.items()}
                else:
                    out[name] = take(val, index).to(named[name].device)

        walk("", {k: v for k, v in ptree.items() if k not in ("groups", "tail")}, None)
        for l in range(cfg.n_layers):
            if l < n_cycled:
                walk(f"layers.{l}.", ptree["groups"][l % plen], l // plen)
            else:
                walk(f"layers.{l}.", ptree["tail"][l - n_cycled], None)
        if set(out) != set(named):
            raise ValueError(f"optimizer state and parameters differ: missing {sorted(set(named) - set(out))}, "
                             f"unexpected {sorted(set(out) - set(named))}")
        return {n: out[n] for n in named}

    step = torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32)
    if isinstance(optimizer, Adam):
        state = {"m": by_name(tree["m"]), "v": by_name(tree["v"]), "step": step}
    elif isinstance(optimizer, Adafactor):
        state = {"v": by_name(tree["v"], {"vr", "vc", "v"}), "step": step}
    else:
        raise TypeError(f"no state mapping for {type(optimizer).__name__}")
    # the port's own state for these parameters fixes every moment's shape (a stacked Adafactor leaf whose
    # cycle axis was one of its two factored dims has no per-layer slice)
    want = dict(leaves_with_paths(optimizer.init(params)))
    got = dict(leaves_with_paths(state))
    if set(want) != set(got) or any(tuple(got[k].shape) != tuple(want[k].shape) for k in want):
        raise ValueError("the optimizer state does not map onto the port's: "
                         f"{sorted((path_str(k), tuple(v.shape)) for k, v in got.items())[:8]} ...")
    return state
