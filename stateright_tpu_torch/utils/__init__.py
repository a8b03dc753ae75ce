"""Utility data structures embedded in model states.

A copy of the JAX package's ``utils`` package, cut to the two immutable
collections the actor models use (the reference's
``HashableHashSet`` / ``HashableHashMap``, src/util.rs).
"""

from .hashable import HashableMap, HashableSet

__all__ = ["HashableMap", "HashableSet"]
