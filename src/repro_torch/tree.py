"""Trees of tensors: nested dicts (and NamedTuples of them), named and
ordered as the reference's `jax.tree_util` flattens them (dict keys
sorted, a NamedTuple's fields in order), so a leaf's name is the same in
a checkpoint, a sharding spec and a collective of either package."""
from __future__ import annotations


def map_named(fn, tree, prefix=()):
    """`tree` with each leaf replaced by fn(name, leaf), visiting leaves
    in the reference's flattening order; a leaf's name is its path joined
    with ``/`` (``opt/master/blocks/in_x``)."""
    if isinstance(tree, dict):
        out = {k: map_named(fn, tree[k], prefix + (str(k),))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_named(fn, getattr(tree, f), prefix + (f,))
                            for f in tree._fields))
    return fn("/".join(prefix), tree)


def named_leaves(tree) -> list:
    """[(name, leaf)] in `map_named`'s order."""
    out = []
    map_named(lambda name, leaf: out.append((name, leaf)), tree)
    return out


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts of one structure."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, keys sorted at every level (the order
    `jax.tree_util` flattens a dict in)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out
