"""Frozen dataclasses that are JAX pytrees.

``@struct.dataclass`` makes a frozen dataclass whose fields are pytree
leaves, except those declared with ``struct.field(static=True)``: those go
into the tree definition, so ``jit`` treats them as compile-time constants
and retraces when they change. ``.replace(**changes)`` returns an updated
copy.
"""

from __future__ import annotations

import dataclasses

import jax


def field(*, static: bool = False, **kwargs):
    """A dataclass field; ``static=True`` keeps it out of the pytree leaves."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["static"] = static
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    static = [f.name for f in fields if f.metadata.get("static", False)]
    data = [f.name for f in fields if not f.metadata.get("static", False)]
    cls.replace = _replace
    return jax.tree_util.register_dataclass(
        cls, data_fields=data, meta_fields=static
    )
