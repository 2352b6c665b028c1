"""Vietoris-Rips persistent homology (port of ``tdax.ops.rips``).

``rips`` / ``rips_from_distances`` run the native C++ cohomology engine
(``cpp/``) through the port's own ctypes binding; ``csr_from_knn`` /
``rips_sparse`` feed its sparse (CSR) engine; ``mst`` holds the H0
diagram from a Boruvka minimum spanning tree on the card.
"""

from tdax_torch.ops.rips.api import rips, rips_from_distances
from tdax_torch.ops.rips.sparse import csr_from_knn, rips_sparse

__all__ = ["rips", "rips_from_distances", "csr_from_knn", "rips_sparse"]
