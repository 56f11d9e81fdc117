"""Trees of tensors as the JAX package's pytrees flatten them.

A tree is a dict (keys visited in sorted order), a NamedTuple (fields in
order), a tuple or list (entries in order), ``None`` (no leaves) or a
leaf.  :func:`flatten` gives the leaves with their paths in
``jax.tree_util.tree_flatten_with_path``'s order, each path entry as the
JAX package's checkpoint keys print it: a dict key as itself, a
NamedTuple field as ``".name"``, a sequence entry as its index.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[str, ...]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) of every leaf, in JAX's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [item for f in tree._fields
                for item in flatten(getattr(tree, f), prefix + ("." + f,))]
    if isinstance(tree, (tuple, list)):
        return [item for i, v in enumerate(tree)
                for item in flatten(v, prefix + (str(i),))]
    return [(prefix, tree)]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def flatten_up_to(like, tree) -> List[Any]:
    """The subtrees of ``tree`` at the leaf positions of ``like``, in
    :func:`flatten`'s order (``treedef.flatten_up_to``)."""
    if like is None:
        return []
    if isinstance(like, dict):
        return [x for k in sorted(like)
                for x in flatten_up_to(like[k], tree[k])]
    if _is_namedtuple(like):
        return [x for f in like._fields
                for x in flatten_up_to(getattr(like, f), getattr(tree, f))]
    if isinstance(like, (tuple, list)):
        return [x for a, b in zip(like, tree) for x in flatten_up_to(a, b)]
    return [tree]


def unflatten(like, new_leaves) -> Any:
    """A tree shaped as ``like`` whose leaves are ``new_leaves`` (in
    :func:`flatten`'s order)."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}          # keep the key order
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    flat = [leaves(t) for t in (tree,) + rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
