"""The nested trees the port's params, grads and optimizer states are
(the JAX package's pytrees): dicts and lists of tensors. As in JAX, a
dict's leaves are taken in sorted key order, so two dicts with the same
keys line up whatever order their keys were inserted in, and a list's
in its order (the ResNet's stages are lists of block dicts, the MLP a
list of layers)."""


def tree_leaves(tree):
    """The tensors of a nested dict/list, depth first: a dict's entries
    in sorted key order, a list's in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in :func:`tree_leaves`'
    order; returns a tree like ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
