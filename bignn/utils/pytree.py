"""Frozen dataclasses registered as JAX pytrees.

Fields declared with ``static_field()`` are pytree metadata (hashable, part
of the jit cache key); every other field is a child (arrays or None).
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    return dataclasses.field(metadata={"static": True}, **kwargs)


def pytree_dataclass(cls):
    """Frozen dataclass, registered with ``jax.tree_util``, with a
    ``replace(**changes)`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(cls)
