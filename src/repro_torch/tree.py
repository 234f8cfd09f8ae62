"""Trees of tensors: nested dicts, lists and tuples, with a module standing for its parameters.

The port's counterpart of the few ``jax.tree`` functions its training,
sharding and checkpoint code needs.  A dict's entries go in sorted key
order, as ``jax.tree`` flattens them; an ``nn.Module`` is the dict of its
``named_parameters()`` in their order; a leaf is anything else (a tensor, an
array, a number).  A path is the tuple of keys and indices down to a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
from torch import nn


def named_tensors(params) -> Dict[str, torch.Tensor]:
    """A module's parameters by name, in ``named_parameters()`` order; a mapping is returned as it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def _children(node):
    if isinstance(node, nn.Module):
        return list(node.named_parameters())
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def leaves_with_paths(tree) -> List[Tuple[tuple, Any]]:
    """(path, leaf) of every leaf, depth first, in flattening order."""
    kids = _children(tree)
    if kids is None:
        return [((), tree)]
    return [((k,) + path, leaf) for k, sub in kids for path, leaf in leaves_with_paths(sub)]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def path_str(path: tuple) -> str:
    """The reference's checkpoint path string: the keys and indices joined by dots."""
    return ".".join(str(k) for k in path)


def map_tree(fn: Callable, tree, *rest):
    """``fn`` on each leaf (with the matching leaves of ``rest``); a module maps to the dict of its parameters."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, sub, *(r[k] for r in rest)) for k, sub in kids)
    return {k: map_tree(fn, sub, *(_get(r, k) for r in rest)) for k, sub in kids}


def _get(node, key):
    return named_tensors(node)[key] if isinstance(node, nn.Module) else node[key]
