"""Parameter trees (nested dicts, lists and NamedTuples of tensors) in the
reference's leaf order.

JAX flattens a pytree with dict keys sorted, NamedTuple fields in order and
lists by index, and renders a leaf's path as its keys joined by ``/`` (a
NamedTuple field as ``.name``: ``.params/embed/0/0/w``). The checkpoint
format stores leaves by that index, so the port flattens in the same order.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node: Any):
    """(path keys, children) of a container in JAX's order; None for a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return [str(k) for k in keys], [node[k] for k in keys]
    if _is_namedtuple(node):
        return [f".{f}" for f in node._fields], list(node)
    if isinstance(node, (list, tuple)):
        return [str(i) for i in range(len(node))], list(node)
    return None


def flatten_with_paths(tree: Any) -> Tuple[List[Any], List[str]]:
    """Leaves and their path strings, in JAX's flattening order."""
    leaves, paths = [], []

    def walk(node, prefix):
        kids = _children(node)
        if kids is None:
            leaves.append(node)
            paths.append("/".join(prefix))
            return
        for key, child in zip(*kids):
            walk(child, prefix + (key,))

    walk(tree, ())
    return leaves, paths


def leaves(tree: Any) -> List[Any]:
    return flatten_with_paths(tree)[0]


def unflatten(like: Any, new_leaves: List[Any]) -> Any:
    """A tree shaped like ``like`` holding ``new_leaves`` (in flatten order);
    dicts keep ``like``'s key order."""
    it = iter(new_leaves)
    missing = object()

    def build(node):
        if isinstance(node, dict):
            vals = {k: build(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*[build(c) for c in node])
        if isinstance(node, (list, tuple)):
            return type(node)([build(c) for c in node])
        leaf = next(it, missing)
        if leaf is missing:
            raise ValueError("fewer leaves than the tree holds")
        return leaf

    out = build(like)
    if next(it, missing) is not missing:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over matching leaves of trees of one structure."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *others)])
