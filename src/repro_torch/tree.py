"""Nested-dict tree helpers (the port's stand-in for ``jax.tree``).

Parameters and caches are plain nested dicts of tensors (or numpy arrays
on the host), with the same keys as the JAX pytrees, so converting and
comparing the two stays a walk over matching paths.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over one or more dicts of identical keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_items(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """Yield ``(key_path, leaf)`` in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, path + (k,))
    else:
        yield path, tree


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def sorted_items(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """Yield ``(key_path, leaf)`` with each dict's keys sorted: the order
    of ``jax.tree.leaves`` over the reference's pytree of the same keys
    (sums over leaves follow it; a checkpoint's manifest lists it)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from sorted_items(tree[k], path + (k,))
    else:
        yield path, tree



def leaves_by_key(tree: Any, want: str) -> list:
    """Leaves whose path contains key ``want``."""
    return [leaf for path, leaf in tree_items(tree) if want in path]
