"""Fork-diff module composition.

The reference flattens each fork's spec with spec-gen (AST merge of the
fork's diff modules onto the previous fork's spec,
spec-gen/src/generator.rs:372). Here the same layering is plain namespace
inheritance: a fork module declares its overrides, then calls
``inherit(globals(), parent_module)`` to pull in everything it did not
redefine. Ported from ethereum_consensus_tpu/models/_diff.py.
"""

from __future__ import annotations

from types import ModuleType

__all__ = ["inherit"]


def inherit(namespace: dict, parent: ModuleType) -> None:
    """Copy every public non-module attribute of ``parent`` not already
    present in ``namespace`` (the calling module's globals) — including the
    parent's own re-exports from earlier forks, so the whole surface chains.
    Extends ``__all__`` so star-imports and introspection see the full fork
    surface."""
    exported = list(namespace.get("__all__", ()))
    for name, value in vars(parent).items():
        if name.startswith("_") or isinstance(value, ModuleType):
            continue
        if name not in namespace:
            namespace[name] = value
        if name not in exported:
            exported.append(name)
    namespace["__all__"] = exported
