"""Trees of tensors: nested dicts, lists and tuples, walked in the JAX
package's order.

``jax.tree_util`` visits a dict's values by sorted key, a list's or a
tuple's items in order and a NamedTuple's fields in order; anything else
is a leaf.  These helpers walk the port's trees (parameters, gradients,
optimizer state) the same way, so a leaf's index and its name
(:func:`leaves_with_path`, the string ``jax.tree_util.keystr`` gives the
same path: ``"['layers'][0]['mlp']['wo']"``) are the reference's.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr, leaf) for every leaf, in the reference's order."""
    ch = _children(tree)
    if ch is None:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key, c in ch:
        out.extend(leaves_with_path(c, prefix + key))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten_like(like, new_leaves) -> Any:
    """``like``'s structure holding ``new_leaves`` (in :func:`leaves`'
    order)."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            vals = {k: build(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[build(getattr(node, f))
                                for f in node._fields])
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("unflatten_like: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of each tree of ``rest``
    (the same structure), as ``jax.tree.map``."""
    cols = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("tree_map: trees of different structure")
    return unflatten_like(tree, [fn(*xs) for xs in zip(*cols)])
