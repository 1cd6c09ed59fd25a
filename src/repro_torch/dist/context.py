"""Active mesh context.

A tiny indirection layer so model code (`repro.models`) can ask "what mesh
am I running under?" without importing the sharding machinery; the hook is
installed by `repro.dist.sharding.MeshContext`.
"""

from __future__ import annotations

from typing import Optional

_CURRENT = None


def set_ctx(ctx) -> None:
    global _CURRENT
    _CURRENT = ctx


def current_ctx() -> Optional["object"]:
    """The innermost active MeshContext, or None outside any context."""
    return _CURRENT
