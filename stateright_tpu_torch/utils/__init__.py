"""Utility data structures embedded in model states.

A copy of the JAX package's ``utils`` package: the reference's L0
utilities (stateright src/util.rs, src/util/{densenatmap,vector_clock}.rs).
All collections here are *immutable* (updates return new values): model
states must be safely shareable between frontier entries, and the
fingerprint of a state must never change after it is computed.
"""

from .hashable import HashableMap, HashableSet
from .densenatmap import DenseNatMap
from .vector_clock import VectorClock

__all__ = ["HashableMap", "HashableSet", "DenseNatMap", "VectorClock"]
