"""The nested-dict trees the port's params, grads and optimizer states
are (the JAX package's pytrees). As in JAX, a dict's leaves are taken
in sorted key order, so two dicts with the same keys line up whatever
order their keys were inserted in."""


def tree_leaves(tree):
    """The tensors of a nested dict, depth first in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in sorted key order; returns
    a tree like ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
