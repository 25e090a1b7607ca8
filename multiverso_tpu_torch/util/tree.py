"""A small walker over nested dicts, lists and tuples of leaves.

The JAX package walks its pytrees with ``jax.tree_util``; the port's
trees (a trainer's parameters and updater state, a batch of arrays)
are plain dicts, lists and tuples, so this is all it needs.  Any other
object is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

__all__ = ["tree_map", "tree_map_with_path", "keystr"]

Path = Tuple[Any, ...]


def keystr(path: Path) -> str:
    """``('params', 'layers', 0)`` → ``['params']['layers'][0]``, the
    spelling of ``jax.tree_util.keystr``."""
    return "".join(f"[{k!r}]" for k in path)


def tree_map_with_path(fn: Callable[..., Any], tree: Any, *rest: Any,
                       path: Path = ()) -> Any:
    """``fn(path, leaf, *rest_leaves)`` at every leaf of ``tree``, rebuilt
    with the same containers.  Each tree of ``rest`` must have the same
    structure; a mismatch raises ``ValueError`` naming the path."""
    if isinstance(tree, dict):
        for other in rest:
            if not isinstance(other, dict) or set(other) != set(tree):
                raise ValueError(f"tree structure differs at {keystr(path)}")
        return type(tree)(
            (k, tree_map_with_path(fn, v, *(o[k] for o in rest),
                                   path=path + (k,)))
            for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        for other in rest:
            if (not isinstance(other, (list, tuple))
                    or len(other) != len(tree)):
                raise ValueError(f"tree structure differs at {keystr(path)}")
        out = [tree_map_with_path(fn, v, *(o[i] for o in rest),
                                  path=path + (i,))
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):          # a namedtuple
            return type(tree)(*out)
        return type(tree)(out)
    return fn(path, tree, *rest)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *rest_leaves)`` at every leaf (see
    :func:`tree_map_with_path`)."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)
