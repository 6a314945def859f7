"""Trees of tensors as the port keeps its state: dicts, lists and tuples
of tensors, and dataclasses (``train.steps.TrainState``) whose fields are
subtrees.

The order of the leaves and their paths are the reference's
(``jax.tree_util.tree_flatten_with_path``): a dict's keys sorted, a list's
items in order, a dataclass's fields by index (JAX flattens a node
registered without keys to ``FlattenedIndexKey``\\ s), and ``None`` an
empty subtree.  So the checkpoint store writes the leaf keys the
reference's ``_flatten`` gives for the same tree.
"""
from __future__ import annotations

import dataclasses


def _children(tree):
    """``(keys, children)`` of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return keys, [tree[k] for k in keys]
    if isinstance(tree, (list, tuple)):
        return list(range(len(tree))), list(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        vals = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
        return list(range(len(vals))), vals
    return None


def _rebuild(tree, children: list):
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), children))
    if isinstance(tree, tuple):
        return tuple(children)
    if isinstance(tree, list):
        return list(children)
    return type(tree)(*children)


def leaves_with_path(tree, path: tuple = (), is_leaf=None):
    """``(path, leaf)`` of every leaf in the reference's order.
    ``is_leaf(node)``, where given, stops the descent at a node it holds
    true of (``jax.tree_util``'s argument of that name)."""
    if tree is None:
        return
    node = None if is_leaf is not None and is_leaf(tree) else \
        _children(tree)
    if node is None:
        yield path, tree
        return
    for k, child in zip(*node):
        yield from leaves_with_path(child, path + (k,), is_leaf)


def tree_leaves(tree, is_leaf=None) -> list:
    return [leaf for _, leaf in leaves_with_path(tree, is_leaf=is_leaf)]


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree of ``rest`` (same structure), into a tree of ``tree``'s
    structure.  ``is_leaf`` as in :func:`leaves_with_path`, read on
    ``tree``."""
    if tree is None:
        return None
    node = None if is_leaf is not None and is_leaf(tree) else \
        _children(tree)
    if node is None:
        return fn(tree, *rest)
    others = [_children(r)[1] for r in rest]
    return _rebuild(tree, [tree_map(fn, c, *[o[i] for o in others],
                                    is_leaf=is_leaf)
                           for i, c in enumerate(node[1])])


def tree_map_with_path(fn, tree, *rest, is_leaf=None):
    """``fn(path, leaf, *matching leaves)`` over the leaves of ``tree``,
    into a tree of its structure (``jax.tree_util.tree_map_with_path``)."""
    paths = iter([p for p, _ in leaves_with_path(tree, is_leaf=is_leaf)])
    return tree_map(lambda *leaves: fn(next(paths), *leaves), tree, *rest,
                    is_leaf=is_leaf)


def tree_unflatten(tree, leaves) -> object:
    """A tree of ``tree``'s structure holding ``leaves`` in leaf order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
