"""Gaussian-process covariance math: the kernel registry, its params trees, and plain assembly.

The paper (Eq. 1) uses the squared-exponential kernel

    k(x_i, x_j) = v * exp( -1/(2*l) * sum_d (x_i_d - x_j_d)^2 ) + delta_ij * sigma^2

with lengthscale ``l``, vertical lengthscale ``v`` and noise variance
``sigma^2``.  The paper divides by ``2*l`` (not ``2*l**2``); the port keeps
that convention exactly, as the JAX package does, and every other
stationary family keeps it too (``lengthscale`` scales *squared* distances).

Beyond SE the registry holds Matérn 1/2, 3/2 and 5/2, the rational
quadratic, per-dimension ARD and white noise, and ``Sum`` / ``Product`` /
``Scaled`` compose them.  A kernel is a frozen dataclass implementing:

  * ``kfree(params, xa, xb)`` — the noise-free covariance block (torch ops,
    leading batch axes allowed);
  * ``noise(params)`` — the variance added on the global training diagonal;
  * ``diag(params)`` — the exact ``kfree(x, x)``; assembly pins the global
    diagonal to ``diag + noise`` instead of trusting the cancellation-prone
    expanded distance form;
  * ``default_params()``, ``base_ndims(params)`` and, where
    ``analytic_vjp`` is set (SE, Matérn 5/2), the hand-derived
    ``kfree_vjp``.

Hyperparameters are a params *tree*: small dataclasses whose leaves are
floats or tensors (0-d, or (D,) for ARD lengthscales), nested in tuples by
``Sum``/``Product`` and in ``ScaledParams.inner``.  :func:`tree_flatten`,
:func:`tree_unflatten` and :func:`tree_map` walk them.  Padding contract:
rows/cols with global index ``>= n_valid`` become identity (training
covariance) or zero (cross/prior covariance), so the padded system solves
the unpadded one exactly.

Fleets: a leaf may carry a leading problem axis, (B,) + its base shape
(per-problem hyperparameters) beside shared leaves of the base shape;
:func:`params_per_problem`, :func:`broadcast_params` and
:func:`gather_params` read and reshape such trees, and :func:`cov_tile`
takes them on a stack of B * G tiles, problem-major.
:func:`descriptor_table` writes a tree as the cov_tiles kernel's
descriptor: the family's structure, and a device table of per-problem
reals.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, ClassVar, List, Optional, Tuple, Union

import torch

Scalar = Union[float, torch.Tensor]


# ---------------------------------------------------------------------------
# Hyperparameter trees
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SEKernelParams:
    """Hyperparameters of the paper's SE kernel (Eq. 1): floats or 0-d tensors.

    Also the params of the Matérn families, which have the same three knobs.
    """

    lengthscale: Scalar = 1.0
    vertical: Scalar = 1.0
    noise: Scalar = 0.1  # sigma^2 (variance, not std)

    @staticmethod
    def paper_defaults() -> "SEKernelParams":
        # Section 4.1: l = 1, v = 1, sigma^2 = 0.1.
        return SEKernelParams(1.0, 1.0, 0.1)

    def as_floats(self) -> "SEKernelParams":
        """The same parameters as Python floats (reads a 0-d tensor to the host)."""
        return concrete_params(self)


@dataclasses.dataclass(frozen=True)
class RQKernelParams:
    """Rational-quadratic hyperparameters (an SE mixture over lengthscales)."""

    lengthscale: Scalar = 1.0
    vertical: Scalar = 1.0
    noise: Scalar = 0.1
    alpha: Scalar = 1.0  # mixture concentration; RQ -> SE as alpha -> inf


@dataclasses.dataclass(frozen=True)
class ARDKernelParams:
    """SE-ARD hyperparameters: one lengthscale per feature dimension (a (D,) tensor)."""

    lengthscales: Any = dataclasses.field(default_factory=lambda: torch.ones(1))
    vertical: Scalar = 1.0
    noise: Scalar = 0.1


@dataclasses.dataclass(frozen=True)
class WhiteKernelParams:
    """White-noise hyperparameter: the observation-noise variance."""

    noise: Scalar = 0.1


@dataclasses.dataclass(frozen=True)
class ScaledParams:
    """Params of ``Scaled``: an output scale wrapping the child's params tree."""

    scale: Scalar = 1.0
    inner: Any = None


def _is_node(tree) -> bool:
    return isinstance(tree, (tuple, list)) or (
        dataclasses.is_dataclass(tree) and not isinstance(tree, type)
    )


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef) of a params tree: dataclass fields and tuple items, depth first."""
    if isinstance(tree, (tuple, list)):
        parts = [tree_flatten(c) for c in tree]
        return [l for p in parts for l in p[0]], (type(tree), None, tuple(p[1] for p in parts))
    if _is_node(tree):
        names = tuple(f.name for f in dataclasses.fields(tree))
        parts = [tree_flatten(getattr(tree, n)) for n in names]
        return [l for p in parts for l in p[0]], (type(tree), names, tuple(p[1] for p in parts))
    return [tree], None


def tree_unflatten(treedef, leaves):
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(td):
        if td is None:
            return next(it)
        cls, names, children = td
        built = [build(c) for c in children]
        return cls(built) if names is None else cls(**dict(zip(names, built)))

    return build(treedef)


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of ``rest``)."""
    leaves, td = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(td, [fn(*ls) for ls in zip(leaves, *others)])


class TensorLeaves:
    """A params tree split into its tensor leaves (autograd operands) and the rest, which stay bound."""

    def __init__(self, params):
        self.leaves, self.treedef = tree_flatten(params)
        self.slots = [i for i, leaf in enumerate(self.leaves) if isinstance(leaf, torch.Tensor)]

    def values(self):
        return [self.leaves[i] for i in self.slots]

    def rebuild(self, values):
        """The tree with ``values`` in place of its tensor leaves."""
        filled = list(self.leaves)
        for i, v in zip(self.slots, values):
            filled[i] = v
        return tree_unflatten(self.treedef, filled)

    def pick(self, tree):
        """The leaves of ``tree`` (the same structure) at the tensor slots."""
        leaves = tree_leaves(tree)
        return [leaves[i] for i in self.slots]


def concrete_params(params):
    """The params tree as host values: 0-d leaves as floats, vector leaves as float tuples.

    Reads tensors to the host (detached): for host-side reading (the
    kernel's stated tolerance, tests), never on a program's path; the
    result is not for :func:`tree_map` (a vector leaf becomes a tuple).
    """

    def conv(leaf):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            return float(leaf) if leaf.ndim == 0 else tuple(float(v) for v in leaf.reshape(-1).cpu())
        return leaf if leaf is None else float(leaf)

    return tree_map(conv, params)


# ---------------------------------------------------------------------------
# Per-problem hyperparameters (fleets)
# ---------------------------------------------------------------------------


def _ndim(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.ndim
    return 1 if isinstance(leaf, (tuple, list)) else 0


def _base_ndims_of(params, kernel):
    return resolve_kernel(kernel).base_ndims(params)


def _leaf_pairs(params, kernel):
    return zip(tree_leaves(params), tree_leaves(_base_ndims_of(params, kernel)))


def params_per_problem(params, kernel=None) -> bool:
    """True iff any hyperparameter leaf carries a problem-batch axis (B, ...)."""
    return problem_count(params, kernel) is not None


def problem_count(params, kernel=None) -> Optional[int]:
    """B of the per-problem leaves, or None when every leaf is shared."""
    for leaf, nd in _leaf_pairs(params, kernel):
        if _ndim(leaf) > nd:
            return int(leaf.shape[0])
    return None


def broadcast_params(params, b: int, kernel=None, *, dtype=None, device=None):
    """Every leaf as a per-problem tensor of shape (B,) + its base shape.

    Mixed trees (a per-problem lengthscale beside a shared noise) are legal;
    this normalizes them for code that runs the problems one by one or
    trains them side by side.  Leaves become tensors of ``dtype`` on
    ``device`` (by default their own, a float's the default dtype on the CPU).
    """
    kernel = resolve_kernel(kernel)

    def bcast(leaf, nd):
        leaf = torch.as_tensor(leaf, dtype=dtype, device=device)
        if leaf.ndim == nd:
            return leaf.expand((b,) + tuple(leaf.shape))
        if leaf.ndim == nd + 1:
            return leaf.expand((b,) + tuple(leaf.shape[1:]))
        raise ValueError(
            f"hyperparameter leaf of rank {leaf.ndim} is neither shared (rank {nd}) "
            f"nor per-problem (rank {nd + 1})"
        )

    return tree_map(bcast, params, kernel.base_ndims(params))


def gather_params(params, idx, kernel=None):
    """Per-problem leaves taken at ``idx`` (an index or an index tensor); shared leaves pass through."""
    kernel = resolve_kernel(kernel)

    def gather(leaf, nd):
        return leaf if _ndim(leaf) == nd else leaf[idx]

    return tree_map(gather, params, kernel.base_ndims(params))


def _problem_view(params, kernel, p: int):
    """Per-problem leaves (P,) + base reshaped to broadcast against (P, G, m, mb) tiles."""

    def view(leaf, nd):
        if _ndim(leaf) == nd:
            return leaf
        return leaf.reshape((p,) + (1,) * (3 - nd) + tuple(leaf.shape[1:]))

    return tree_map(view, params, kernel.base_ndims(params))


# ---------------------------------------------------------------------------
# Distance helpers
# ---------------------------------------------------------------------------


def sq_dists(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances, (..., n1, D) x (..., n2, D) -> (..., n1, n2).

    The expanded form |a|^2 + |b|^2 - 2 a.b, clamped at zero, as the JAX
    reference computes it.  It cancels catastrophically for large-magnitude
    inputs, which is why training assembly pins the global diagonal.
    """
    n1sq = torch.sum(x1 * x1, dim=-1, keepdim=True)          # (..., n1, 1)
    n2sq = torch.sum(x2 * x2, dim=-1).unsqueeze(-2)          # (..., 1, n2)
    cross = x1 @ x2.transpose(-1, -2)
    return torch.clamp(n1sq + n2sq - 2.0 * cross, min=0.0)


def _safe_sqrt(d2: torch.Tensor) -> torch.Tensor:
    """sqrt with a zero (not NaN) gradient at d2 == 0 (double-where trick)."""
    pos = d2 > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, d2, torch.ones_like(d2))), torch.zeros_like(d2))


def _zeros_like_leaf(leaf):
    return torch.zeros_like(leaf) if isinstance(leaf, torch.Tensor) else 0.0


def _xgrads(w, xa, xb):
    """Cotangents of xa, xb from w = g * dk/d(d2): d(d2)/dxa = 2 (xa - xb) rowwise."""
    g_xa = 2.0 * (torch.sum(w, dim=1, keepdim=True) * xa - w @ xb)
    g_xb = 2.0 * (torch.sum(w, dim=0)[:, None] * xb - w.T @ xa)
    return g_xa, g_xb


# ---------------------------------------------------------------------------
# The kernel registry
# ---------------------------------------------------------------------------


class Kernel:
    """Base of the kernel contract (see the module docstring).

    ``analytic_vjp`` marks kernels with a hand-derived dK/dtheta
    (``kfree_vjp``); the others train through autograd of the program.
    """

    name: ClassVar[str] = "kernel"
    analytic_vjp: ClassVar[bool] = False

    def default_params(self):
        raise NotImplementedError

    def kfree(self, params, xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def noise(self, params):
        return params.noise

    def diag(self, params):
        return params.vertical

    def base_ndims(self, params):
        """Per-leaf base rank of the params tree (0 for scalars, 1 for ARD lengthscales)."""
        return tree_map(lambda _: 0, params)

    def kfree_vjp(self, params, xa, xb, g):
        """Hand-derived VJP of ``sum(g * kfree(params, xa, xb))``, one (n1, n2) block.

        Returns ``(g_params, g_xa, g_xb)``; the ``noise`` leaf of
        ``g_params`` is zero (kfree is noise-free).  Only kernels with
        ``analytic_vjp`` provide it.
        """
        raise NotImplementedError(
            f"{self.name} has no hand-derived kfree VJP (analytic_vjp is {self.analytic_vjp})"
        )

    def kernel_id(self) -> str:
        return self.name


@dataclasses.dataclass(frozen=True)
class SquaredExponential(Kernel):
    """The paper's kernel: k = v * exp(-d2 / (2 l)); ``l`` enters unsquared."""

    name: ClassVar[str] = "se"
    analytic_vjp: ClassVar[bool] = True

    def default_params(self) -> SEKernelParams:
        return SEKernelParams.paper_defaults()

    def kfree(self, params, xa, xb):
        return params.vertical * torch.exp(-0.5 / params.lengthscale * sq_dists(xa, xb))

    def kfree_vjp(self, params, xa, xb, g):
        l, v = params.lengthscale, params.vertical
        d2 = sq_dists(xa, xb)
        gk = g * (v * torch.exp(-0.5 / l * d2))
        g_l = torch.sum(gk * d2) / (2.0 * l * l)
        g_v = torch.sum(gk) / v
        # dk/d(d2) = -k / (2 l)
        g_xa, g_xb = _xgrads(-gk / (2.0 * l), xa, xb)
        return SEKernelParams(g_l, g_v, _zeros_like_leaf(params.noise)), g_xa, g_xb


@dataclasses.dataclass(frozen=True)
class Matern12(Kernel):
    """Matérn nu=1/2 (exponential): k = v * exp(-r), r^2 = d2 / l."""

    name: ClassVar[str] = "matern12"

    def default_params(self) -> SEKernelParams:
        return SEKernelParams.paper_defaults()

    def kfree(self, params, xa, xb):
        r = _safe_sqrt(sq_dists(xa, xb) / params.lengthscale)
        return params.vertical * torch.exp(-r)


@dataclasses.dataclass(frozen=True)
class Matern32(Kernel):
    """Matérn nu=3/2: k = v * (1 + sqrt(3) r) exp(-sqrt(3) r)."""

    name: ClassVar[str] = "matern32"

    def default_params(self) -> SEKernelParams:
        return SEKernelParams.paper_defaults()

    def kfree(self, params, xa, xb):
        s = math.sqrt(3.0) * _safe_sqrt(sq_dists(xa, xb) / params.lengthscale)
        return params.vertical * (1.0 + s) * torch.exp(-s)


@dataclasses.dataclass(frozen=True)
class Matern52(Kernel):
    """Matérn nu=5/2: k = v * (1 + sqrt(5) r + 5 r^2 / 3) exp(-sqrt(5) r)."""

    name: ClassVar[str] = "matern52"
    analytic_vjp: ClassVar[bool] = True

    def default_params(self) -> SEKernelParams:
        return SEKernelParams.paper_defaults()

    def kfree(self, params, xa, xb):
        s = math.sqrt(5.0) * _safe_sqrt(sq_dists(xa, xb) / params.lengthscale)
        return params.vertical * (1.0 + s + s * s / 3.0) * torch.exp(-s)

    def kfree_vjp(self, params, xa, xb, g):
        l, v = params.lengthscale, params.vertical
        s = math.sqrt(5.0) * _safe_sqrt(sq_dists(xa, xb) / l)
        e = torch.exp(-s)
        g_v = torch.sum(g * (1.0 + s + s * s / 3.0) * e)
        # dk/dl = v s^2 (1 + s) e^{-s} / (6 l)   (via ds/dl = -s / (2 l))
        g_l = torch.sum(g * s * s * (1.0 + s) * e) * v / (6.0 * l)
        # dk/d(d2) = -(5 v / (6 l)) (1 + s) e^{-s}: finite at d2 == 0
        w = g * (-(5.0 * v / (6.0 * l)) * (1.0 + s) * e)
        g_xa, g_xb = _xgrads(w, xa, xb)
        return SEKernelParams(g_l, g_v, _zeros_like_leaf(params.noise)), g_xa, g_xb


@dataclasses.dataclass(frozen=True)
class RationalQuadratic(Kernel):
    """RQ: k = v * (1 + d2 / (2 alpha l))^-alpha — an SE lengthscale mixture."""

    name: ClassVar[str] = "rq"

    def default_params(self) -> RQKernelParams:
        return RQKernelParams()

    def kfree(self, params, xa, xb):
        base = 1.0 + sq_dists(xa, xb) / (2.0 * params.alpha * params.lengthscale)
        return params.vertical * torch.exp(-params.alpha * torch.log(base))


@dataclasses.dataclass(frozen=True)
class ARDSquaredExponential(Kernel):
    """SE with one lengthscale per feature dim: k = v * exp(-0.5 sum d_i^2 / l_i).

    The plain version scales the features by 1/sqrt(l) and takes the
    expanded-form distance; the CUDA kernel computes sum (a_d - b_d)^2 / l_d
    as the Pallas body does (``csrc/cov_assembly.cu``).
    """

    ndim: int = 1

    name: ClassVar[str] = "se_ard"

    def default_params(self) -> ARDKernelParams:
        return ARDKernelParams(lengthscales=torch.ones(self.ndim))

    def kfree(self, params, xa, xb):
        ls = torch.as_tensor(params.lengthscales, dtype=xa.dtype, device=xa.device)
        inv = 1.0 / torch.sqrt(ls)
        return params.vertical * torch.exp(-0.5 * sq_dists(xa * inv, xb * inv))

    def base_ndims(self, params) -> ARDKernelParams:
        return ARDKernelParams(lengthscales=1, vertical=0, noise=0)

    def kernel_id(self) -> str:
        return f"se_ard{self.ndim}"


@dataclasses.dataclass(frozen=True)
class White(Kernel):
    """White observation noise: zero off the diagonal, ``noise`` on it (through the pin)."""

    name: ClassVar[str] = "white"

    def default_params(self) -> WhiteKernelParams:
        return WhiteKernelParams()

    def kfree(self, params, xa, xb):
        return xa.new_zeros(xa.shape[:-1] + (xb.shape[-2],))

    def diag(self, params):
        return 0.0


@dataclasses.dataclass(frozen=True, init=False)
class Sum(Kernel):
    """k = sum of children; params is the tuple of the children's params trees."""

    children: tuple

    name: ClassVar[str] = "sum"

    def __init__(self, *children: Kernel):
        object.__setattr__(self, "children", tuple(children))

    def default_params(self) -> tuple:
        return tuple(c.default_params() for c in self.children)

    def kfree(self, params, xa, xb):
        parts = [c.kfree(p, xa, xb) for c, p in zip(self.children, params)]
        return sum(parts[1:], parts[0])

    def noise(self, params):
        return sum(c.noise(p) for c, p in zip(self.children, params))

    def diag(self, params):
        return sum(c.diag(p) for c, p in zip(self.children, params))

    def base_ndims(self, params) -> tuple:
        return tuple(c.base_ndims(p) for c, p in zip(self.children, params))

    def kernel_id(self) -> str:
        return "sum(" + ",".join(c.kernel_id() for c in self.children) + ")"


@dataclasses.dataclass(frozen=True, init=False)
class Product(Kernel):
    """k = product of the children's noise-free parts; the children's noise is ignored."""

    children: tuple

    name: ClassVar[str] = "product"

    def __init__(self, *children: Kernel):
        object.__setattr__(self, "children", tuple(children))

    def default_params(self) -> tuple:
        return tuple(c.default_params() for c in self.children)

    def kfree(self, params, xa, xb):
        out = self.children[0].kfree(params[0], xa, xb)
        for c, p in zip(self.children[1:], params[1:]):
            out = out * c.kfree(p, xa, xb)
        return out

    def noise(self, params):
        return 0.0

    def diag(self, params):
        out = self.children[0].diag(params[0])
        for c, p in zip(self.children[1:], params[1:]):
            out = out * c.diag(p)
        return out

    def base_ndims(self, params) -> tuple:
        return tuple(c.base_ndims(p) for c, p in zip(self.children, params))

    def kernel_id(self) -> str:
        return "prod(" + ",".join(c.kernel_id() for c in self.children) + ")"


@dataclasses.dataclass(frozen=True)
class Scaled(Kernel):
    """k = scale * child (scale multiplies kfree, diag and the child's noise)."""

    inner: Kernel

    name: ClassVar[str] = "scaled"

    def default_params(self) -> ScaledParams:
        return ScaledParams(scale=1.0, inner=self.inner.default_params())

    def kfree(self, params, xa, xb):
        return params.scale * self.inner.kfree(params.inner, xa, xb)

    def noise(self, params):
        return params.scale * self.inner.noise(params.inner)

    def diag(self, params):
        return params.scale * self.inner.diag(params.inner)

    def base_ndims(self, params) -> ScaledParams:
        return ScaledParams(scale=0, inner=self.inner.base_ndims(params.inner))

    def kernel_id(self) -> str:
        return f"scaled({self.inner.kernel_id()})"


SQUARED_EXPONENTIAL = SquaredExponential()  # the default kernel everywhere

KERNEL_REGISTRY: dict[str, Callable[..., Kernel]] = {}


def register_kernel(name: str, factory: Callable[..., Kernel]) -> None:
    """Register a kernel factory under ``name`` (``get_kernel`` resolves it)."""
    KERNEL_REGISTRY[name] = factory


def get_kernel(name: str, **kwargs) -> Kernel:
    try:
        factory = KERNEL_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown kernel {name!r}; registered: {sorted(KERNEL_REGISTRY)}"
        ) from None
    return factory(**kwargs)


for _cls in (
    SquaredExponential, Matern12, Matern32, Matern52, RationalQuadratic, ARDSquaredExponential, White,
):
    register_kernel(_cls.name, _cls)


def resolve_kernel(kernel) -> Kernel:
    """None -> the SE default; a registry name -> its instance; else as-is."""
    if kernel is None:
        return SQUARED_EXPONENTIAL
    if isinstance(kernel, str):
        return get_kernel(kernel)
    return kernel


# ---------------------------------------------------------------------------
# The normal form the CUDA kernel evaluates
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Factor:
    """One leaf of a product term: ``family`` of a distance, with its host-side scalars.

    ``family`` is "se", "matern12", "matern32", "matern52", "rq" or "ard";
    ``lengthscale`` is l (for "ard" the tuple of per-dimension l), ``alpha``
    RQ's concentration.
    """

    family: str
    lengthscale: Any
    alpha: float = 0.0


def normal_form(kernel: Kernel, params) -> List[Tuple[float, Tuple[Factor, ...]]]:
    """kfree as a sum of products of leaves: ``[(coef, (factor, ...)), ...]`` on the host.

    ``Scaled`` and each leaf's ``vertical`` multiply ``coef``; ``Product``
    distributes over ``Sum``; White contributes nothing off the pinned
    diagonal (its kfree is zero), so a term holding it is dropped.
    ``params`` is read through :func:`concrete_params`.
    """
    return _normal_form(resolve_kernel(kernel), concrete_params(params))


_ISOTROPIC = {SquaredExponential: "se", Matern12: "matern12", Matern32: "matern32", Matern52: "matern52"}


def _normal_form(kernel, p):
    if type(kernel) in _ISOTROPIC:
        return [(p.vertical, (Factor(_ISOTROPIC[type(kernel)], p.lengthscale),))]
    if isinstance(kernel, RationalQuadratic):
        return [(p.vertical, (Factor("rq", p.lengthscale, p.alpha),))]
    if isinstance(kernel, ARDSquaredExponential):
        ls = p.lengthscales if isinstance(p.lengthscales, tuple) else (p.lengthscales,)
        return [(p.vertical, (Factor("ard", ls),))]
    if isinstance(kernel, White):
        return []
    if isinstance(kernel, Scaled):
        return [(p.scale * c, f) for c, f in _normal_form(kernel.inner, p.inner)]
    if isinstance(kernel, Sum):
        return [t for c, cp in zip(kernel.children, p) for t in _normal_form(c, cp)]
    if isinstance(kernel, Product):
        terms = [(1.0, ())]
        for c, cp in zip(kernel.children, p):
            terms = [(c1 * c2, f1 + f2) for c1, f1 in terms for c2, f2 in _normal_form(c, cp)]
        return terms
    raise ValueError(f"kernel {kernel.kernel_id()!r} has no normal form for the CUDA kernel")


# The descriptor of the cov_tiles kernel (kernels/csrc/cov_assembly.cu): its
# limits, its leaf ids, and the columns of one row of its table of reals.
DESC_MAX_TERMS, DESC_MAX_FACTORS, DESC_MAX_ARD_D = 4, 3, 64
DESC_LEAF_IDS = {"se": 0, "matern12": 1, "matern32": 2, "matern52": 3, "rq": 4}
DESC_COMPOSITE = 5
_DESC_NF = DESC_MAX_TERMS * DESC_MAX_FACTORS
DESC_COEF, DESC_S, DESC_A = 0, DESC_MAX_TERMS, DESC_MAX_TERMS + _DESC_NF
DESC_INV_L = DESC_A + _DESC_NF
DESC_DIAG = DESC_INV_L + DESC_MAX_ARD_D
DESC_WIDTH = 96  # DESC_DIAG + 1, padded to whole 16-byte vectors
_LOG2E = 1.4426950408889634


def distance_key(f: Factor):
    """The distance a factor reads: None (the isotropic one) or its ARD lengthscales' identity."""
    if f.family != "ard":
        return None
    return tuple(id(v) if isinstance(v, torch.Tensor) else v for v in f.lengthscale)


@dataclasses.dataclass(frozen=True)
class DescriptorLaunch:
    """One launch of the cov_tiles kernel: its structure (``ints``), ARD flag and table."""

    ints: Tuple[int, ...]
    ard: bool
    table: torch.Tensor  # (P, DESC_WIDTH) reals in the tiles' dtype, on their device


@dataclasses.dataclass(frozen=True)
class Descriptor:
    """A kernel tree as the cov_tiles kernel reads it, for P problems.

    One launch for a tree whose terms read one distance; a composite that
    mixes distances (an ARD leaf beside isotropic ones) has one launch per
    (term, distance), combined by the wrapper (``terms`` gives each
    launch's term), and then the pin of the diagonal to ``table[:, DESC_DIAG]``.
    """

    launches: Tuple[DescriptorLaunch, ...]
    terms: Tuple[int, ...]
    problems: int

    @property
    def mixed(self) -> bool:
        return len(self.launches) > 1

    @property
    def diag(self) -> torch.Tensor:
        """(P,) ``diag + noise`` per problem, in the tiles' dtype."""
        return self.launches[0].table[:, DESC_DIAG]

    def select(self, b: int) -> "Descriptor":
        """Problem ``b``'s rows alone (views), for a launch over that problem's tiles only."""
        if self.problems == 1:
            return self
        return Descriptor(
            tuple(dataclasses.replace(l, table=l.table[b : b + 1]) for l in self.launches), self.terms, 1
        )


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; a host tensor goes to the card by a pinned, asynchronous copy (no stream sync)."""
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _rdiv(num: float, v):
    """num / v rounded once, as the host's double division: ``float / tensor`` in torch is
    ``reciprocal(v) * num``, which rounds twice."""
    return torch.full_like(v, num) / v if isinstance(v, torch.Tensor) else num / v


def _descriptor_row(terms, d: int, log2: bool):
    """(ints, reals, inv_l) of one launch: the structure, the table's columns and ARD's 1 / l.

    ``reals`` has DESC_WIDTH entries (floats, or float64 tensors of shape ()
    or (P,)); ``inv_l`` is None, or a tuple of floats, or a tensor (..., d).
    """
    if len(terms) > DESC_MAX_TERMS or any(len(fs) > DESC_MAX_FACTORS for _, fs in terms):
        raise ValueError(
            f"the cov_tiles kernel takes at most {DESC_MAX_TERMS} terms of {DESC_MAX_FACTORS} factors; the "
            f"kernel's normal form has {[len(fs) for _, fs in terms]}"
        )
    if len({distance_key(f) for _, fs in terms for f in fs}) > 1:
        raise ValueError("one launch reads one distance")
    scale = _LOG2E if log2 else 1.0  # float32 takes the SE exponential as ex2
    n_factors, fam = [0] * DESC_MAX_TERMS, [0] * _DESC_NF
    reals = [0.0] * DESC_WIDTH
    ard = None
    for t, (c, fs) in enumerate(terms):
        reals[DESC_COEF + t], n_factors[t] = c, len(fs)
        for q, f in enumerate(fs):
            i = t * DESC_MAX_FACTORS + q
            if f.family == "ard":  # SE with l = 1 on the ARD distance
                fam[i], reals[DESC_S + i] = DESC_LEAF_IDS["se"], -0.5 * scale
                ard = f.lengthscale
                continue
            fam[i], l = DESC_LEAF_IDS[f.family], f.lengthscale
            if f.family == "se":
                reals[DESC_S + i] = _rdiv(-0.5, l) * scale
            elif f.family == "rq":
                reals[DESC_S + i] = _rdiv(1.0, 2.0 * f.alpha * l)
                reals[DESC_A + i] = -f.alpha
            else:
                reals[DESC_S + i] = _rdiv({"matern12": 1.0, "matern32": 3.0, "matern52": 5.0}[f.family], l)
    single = len(terms) == 1 and len(terms[0][1]) == 1
    ints = (fam[0] if single else DESC_COMPOSITE, len(terms), *n_factors, *fam)
    inv_l = None
    if ard is not None:
        if d > DESC_MAX_ARD_D:
            raise ValueError(f"the cov_tiles kernel's ARD distance takes at most {DESC_MAX_ARD_D} features, got {d}")
        if len(ard) == 1 and isinstance(ard[0], torch.Tensor):
            inv_l = _rdiv(1.0, ard[0])
            if inv_l.shape[-1] not in (1, d):
                raise ValueError(f"{inv_l.shape[-1]} ARD lengthscales for {d} features")
            inv_l = inv_l.expand(inv_l.shape[:-1] + (d,))
        else:
            full = ard * d if len(ard) == 1 else ard
            if len(full) != d:
                raise ValueError(f"{len(full)} ARD lengthscales for {d} features")
            inv_l = tuple(1.0 / float(v) for v in full)
    return ints, reals, inv_l


def _descriptor_table(reals, inv_l, p: int, home: torch.device) -> torch.Tensor:
    """The (P, DESC_WIDTH) float64 table of one launch on ``home``, from its columns."""
    host = [float(v) if not isinstance(v, torch.Tensor) else 0.0 for v in reals]
    if isinstance(inv_l, tuple):
        host[DESC_INV_L : DESC_INV_L + len(inv_l)] = inv_l
    live = [(j, v) for j, v in enumerate(reals) if isinstance(v, torch.Tensor)]
    base = torch.tensor([host], dtype=torch.float64)
    if not live and not isinstance(inv_l, torch.Tensor):
        return base if p == 1 else base.expand(p, DESC_WIDTH)
    table = _to_device(base, home).expand(p, DESC_WIDTH).clone()
    for j, v in live:
        table[:, j] = v.reshape(-1)
    if isinstance(inv_l, torch.Tensor):
        table[:, DESC_INV_L : DESC_INV_L + inv_l.shape[-1]] = inv_l
    return table


def descriptor_table(kernel, params, d: int, dtype: torch.dtype, device) -> Descriptor:
    """The kernel tree as the cov_tiles kernel reads it, for features of ``d`` dims.

    The structure (leaf families, term and factor counts, the ARD flag) is
    the same for every problem and goes to the kernel as a grid constant.
    The reals (coefficients, the leaves' distance scales, RQ's alphas, ARD's
    1 / l and each problem's ``diag + noise``) are one row per problem of a
    (P, DESC_WIDTH) table on ``device``, in ``dtype``: P = 1 for shared
    leaves, B for (B,) leaves.  They are computed in float64 by torch ops on
    the leaves' own device and rounded once, as the host computed them
    before; a tree of floats and host tensors goes to the card by one
    pinned, asynchronous copy.  Nothing is read back to the host, so a
    program whose hyperparameters live on the card never waits for them.
    """
    kernel = resolve_kernel(kernel)
    device = torch.device(device)
    p = problem_count(params, kernel) or 1
    on_card = [l.device for l in tree_leaves(params) if isinstance(l, torch.Tensor) and l.device.type != "cpu"]
    home = on_card[0] if on_card else torch.device("cpu")

    def f64(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().to(device=home, dtype=torch.float64)
        return leaf if leaf is None or isinstance(leaf, tuple) else float(leaf)

    pl = tree_map(f64, params)
    terms = _normal_form(kernel, pl)
    diag = kernel.diag(pl) + kernel.noise(pl)
    log2 = dtype == torch.float32
    groups = [(0, terms)]
    if len({distance_key(f) for _, fs in terms for f in fs}) > 1:
        # one launch per (term, distance), as cross tiles; the wrapper multiplies and sums them
        groups = []
        for t, (c, fs) in enumerate(terms):
            for q, key in enumerate(dict.fromkeys(distance_key(f) for f in fs)):
                groups.append((t, [(c if q == 0 else 1.0, tuple(f for f in fs if distance_key(f) == key))]))
    launches = []
    for _, group in groups:
        ints, reals, inv_l = _descriptor_row(group, d, log2)
        reals[DESC_DIAG] = diag
        table = _descriptor_table(reals, inv_l, p, home)
        launches.append(DescriptorLaunch(ints, inv_l is not None, _to_device(table.to(dtype).contiguous(), device)))
    return Descriptor(tuple(launches), tuple(t for t, _ in groups), p)


def cov_launch_count(kernel, params) -> int:
    """The cov_tiles kernel's launches for one call (:func:`descriptor_table`'s): one, or one per (term, distance)
    where the terms mix distances."""
    terms = normal_form(kernel, params)
    if len({distance_key(f) for _, fs in terms for f in fs}) <= 1:
        return 1
    return sum(len(dict.fromkeys(distance_key(f) for f in fs)) for _, fs in terms)


# ---------------------------------------------------------------------------
# Dense SE block and plain tile assembly
# ---------------------------------------------------------------------------


def se_kernel(x1: torch.Tensor, x2: torch.Tensor, params, *, diag_offset: Optional[int] = None) -> torch.Tensor:
    """Dense SE covariance block between x1 (n1, D) and x2 (n2, D).

    With ``diag_offset`` set, the entry (i, j) with ``i + diag_offset == j``
    gets the ``+ sigma^2`` noise term: the block lies on the global diagonal
    at that column offset (``diag_offset=0`` for the full training matrix).
    """
    k = params.vertical * torch.exp(-0.5 / params.lengthscale * sq_dists(x1, x2))
    if diag_offset is not None:
        i = torch.arange(x1.shape[0], device=k.device)[:, None]
        j = torch.arange(x2.shape[0], device=k.device)[None, :]
        noise = torch.as_tensor(params.noise, dtype=k.dtype, device=k.device)
        k = k + torch.where(i + diag_offset == j, noise, torch.zeros((), dtype=k.dtype, device=k.device))
    return k


def _diag_value(kernel: Kernel, params, dtype, device) -> torch.Tensor:
    """``diag + noise`` rounded once to ``dtype`` (summed in double for floats)."""
    val = kernel.diag(params) + kernel.noise(params)
    if isinstance(val, torch.Tensor):
        return val.to(dtype=dtype, device=device)
    return torch.tensor(val, dtype=dtype, device=device)


def cov_tile(
    xa: torch.Tensor,
    xb: torch.Tensor,
    row0,
    col0,
    params,
    n_valid_r,
    n_valid_c,
    symmetric: bool,
    kernel: Optional[Kernel] = None,
) -> torch.Tensor:
    """Covariance tiles with global-index masking, batched over leading axes.

    xa (..., m, D) rows, xb (..., mb, D) cols; ``row0``/``col0`` are global
    offsets (ints or tensors of the batch shape); ``n_valid_r``/``n_valid_c``
    ints or tensors of the batch shape.  Symmetric tiles pin the global
    diagonal to the exact ``diag + noise`` and are identity in the padded
    region; cross tiles are zero there.  This is the plain version of the
    ``cov_assembly`` CUDA kernel.

    Per-problem params (leaves (P,) + base) take a (T, m, D) stack of P
    problems' tiles, problem-major: tile t belongs to problem t // (T / P).
    """
    kernel = resolve_kernel(kernel)
    p = problem_count(params, kernel)
    if p is None:
        k = kernel.kfree(params, xa, xb)
        diagval = _diag_value(kernel, params, k.dtype, k.device) if symmetric else None
        return mask_tiles(k, row0, col0, n_valid_r, n_valid_c, symmetric, diagval)
    t = xa.shape[0]
    if xa.ndim != 3 or t % p:
        raise ValueError(f"per-problem params of {p} problems need a (T, m, D) stack with P | T, got {tuple(xa.shape)}")
    g = t // p
    pv = _problem_view(params, kernel, p)
    k = kernel.kfree(pv, xa.reshape((p, g) + xa.shape[1:]), xb.reshape((p, g) + xb.shape[1:]))
    k = k.reshape((t,) + k.shape[2:])
    diagval = None
    if symmetric:
        dv = _diag_value(kernel, pv, k.dtype, k.device)
        diagval = dv.reshape(-1, 1, 1, 1).expand(p, g, 1, 1).reshape(t, 1, 1)
    return mask_tiles(k, row0, col0, n_valid_r, n_valid_c, symmetric, diagval)


def mask_tiles(k, row0, col0, n_valid_r, n_valid_c, symmetric: bool, diagval=None) -> torch.Tensor:
    """The masks of :func:`cov_tile` on kfree tiles ``k`` (..., m, mb).

    Symmetric: the global diagonal becomes ``diagval`` (a scalar, or one
    value a tile as (..., 1, 1)) and the padded region the identity;
    otherwise the padded region becomes zero.  Offsets and frontiers are
    scalars or tensors of the batch shape, e.g. (B * G,) per-tile frontiers
    of a ragged fleet.
    """
    dev = k.device

    def col(v):  # (...,) -> (..., 1, 1) so it broadcasts over the tile
        v = torch.as_tensor(v, device=dev)
        return v.reshape(v.shape + (1, 1))

    gi = col(row0) + torch.arange(k.shape[-2], device=dev)[:, None]
    gj = col(col0) + torch.arange(k.shape[-1], device=dev)[None, :]
    on_diag = gi == gj
    valid = (gi < col(n_valid_r)) & (gj < col(n_valid_c))
    if symmetric:
        k = torch.where(on_diag, diagval, k)
        return torch.where(valid, k, on_diag.to(k.dtype))
    return torch.where(valid, k, torch.zeros((), dtype=k.dtype, device=dev))


# ---------------------------------------------------------------------------
# Dense assembly (the monolithic baseline's inputs).
# ---------------------------------------------------------------------------


def _index_grid(rows: int, cols: int, device):
    return (torch.arange(rows, device=device)[:, None], torch.arange(cols, device=device)[None, :])


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` in ``dtype``; ``dtype=None`` keeps it as it is (the port's own callers)."""
    return t if dtype is None else t.to(dtype)


def assemble_covariance(x: torch.Tensor, params, *, kernel=None, n_valid: Optional[int] = None,
                        dtype=torch.float32) -> torch.Tensor:
    """Full training covariance K = K_XX + sigma^2 I, diagonal pinned exactly.

    Rows >= ``n_valid`` of x are padding (any values): the padded region is
    identity on the diagonal and zero elsewhere, as the tiled assembly pins it.
    """
    kernel = resolve_kernel(kernel)
    x = _cast(x, dtype)
    k = _cast(kernel.kfree(params, x, x), dtype)
    n_pad = x.shape[0]
    i, j = _index_grid(n_pad, n_pad, x.device)
    k = torch.where(i == j, _diag_value(kernel, params, k.dtype, k.device), k)
    if n_valid is not None and n_valid != n_pad:
        k = torch.where((i < n_valid) & (j < n_valid), k, (i == j).to(k.dtype))
    return k


def assemble_cross_covariance(
    x_test: torch.Tensor, x_train: torch.Tensor, params, *, kernel=None,
    n_test_valid: Optional[int] = None, n_train_valid: Optional[int] = None, dtype=torch.float32,
) -> torch.Tensor:
    """Cross covariance K_{X̂,X} (n̂_pad × n_pad), rows and columns past the valid counts zero."""
    k = _cast(resolve_kernel(kernel).kfree(params, _cast(x_test, dtype), _cast(x_train, dtype)), dtype)
    nt, ntr = k.shape
    if (n_test_valid is not None and n_test_valid != nt) or (n_train_valid is not None and n_train_valid != ntr):
        i, j = _index_grid(nt, ntr, k.device)
        valid = torch.ones((nt, ntr), dtype=torch.bool, device=k.device)
        if n_test_valid is not None:
            valid &= i < n_test_valid
        if n_train_valid is not None:
            valid &= j < n_train_valid
        k = torch.where(valid, k, torch.zeros((), dtype=k.dtype, device=k.device))
    return k


def assemble_prior_covariance(
    x_test: torch.Tensor, params, *, kernel=None, n_valid: Optional[int] = None,
    include_noise: bool = False, dtype=torch.float32,
) -> torch.Tensor:
    """Prior test covariance K_{X̂,X̂}, with the observation noise on its diagonal
    when ``include_noise``; the padded region past ``n_valid`` is zero."""
    kernel = resolve_kernel(kernel)
    xt = _cast(x_test, dtype)
    k = _cast(kernel.kfree(params, xt, xt), dtype)
    n_pad = k.shape[0]
    i, j = _index_grid(n_pad, n_pad, k.device)
    zero = torch.zeros((), dtype=k.dtype, device=k.device)
    if include_noise:
        k = k + torch.where(i == j, torch.as_tensor(kernel.noise(params), dtype=k.dtype, device=k.device), zero)
    if n_valid is not None and n_valid != n_pad:
        k = torch.where((i < n_valid) & (j < n_valid), k, zero)
    return k
