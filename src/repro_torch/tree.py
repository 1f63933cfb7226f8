"""Parameter and state trees, flattened in the JAX package's order.

A tree is nested dicts, lists, tuples and NamedTuples with tensors (or
numpy arrays, or scalars) at the leaves; ``None`` holds no leaf.  Dict
keys are visited sorted and NamedTuple fields in their order, as
``jax.tree.flatten`` visits them, so the i-th leaf here is the i-th leaf
of the same tree in the JAX package (what the checkpoint store's
``leaf_<i>.npy`` files and the optimiser's global norm rely on).
"""
from __future__ import annotations


def leaves(tree) -> list:
    """The leaves of ``tree`` in flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(like, values) -> object:
    """A tree shaped like ``like`` holding ``values`` (an iterable of
    leaves in flatten order) at its leaves."""
    it = iter(values)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            kids = [build(v) for v in node]
            if hasattr(node, "_fields"):              # NamedTuple
                return type(node)(*kids)
            return type(node)(kids)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``
    (same structure), in flatten order."""
    cols = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])
