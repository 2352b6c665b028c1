"""Vietoris-Rips persistent homology (port of ``tdax.ops.rips``).

``rips`` / ``rips_from_distances`` run the native C++ cohomology engine
(``cpp/``) through the port's own ctypes binding; ``mst`` holds the H0
diagram from a Boruvka minimum spanning tree on the card.
"""

from tdax_torch.ops.rips.api import rips, rips_from_distances

__all__ = ["rips", "rips_from_distances"]
