"""CPU oracles (copies of the JAX package's merge-tree, interval, shared-
object, map, matrix and SharedTree modules): the byte-identity judges and
the fallback path for documents the device folds do not take."""

from .map import SharedDirectory, SharedMap
from .matrix import SharedMatrix

__all__ = ["SharedDirectory", "SharedMap", "SharedMatrix"]
