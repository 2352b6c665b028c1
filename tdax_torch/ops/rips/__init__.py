"""Vietoris-Rips persistent homology (port of ``tdax.ops.rips``).

``rips`` / ``rips_from_distances`` run the native C++ cohomology engine
(``cpp/``) through the port's own ctypes binding, or the numpy oracle
(``reference``, ``backend="python"``, and past maxdim 3);
``csr_from_knn`` / ``rips_sparse`` feed its sparse (CSR) engine; ``mst``
holds the H0 diagram from a Boruvka minimum spanning tree on the card;
``tiny_device.rips_tiny_batched`` reduces a batch of tiny clouds on the
device (the sweep's ``backend="device"``).
"""

from tdax_torch.ops.rips.api import rips, rips_from_distances
from tdax_torch.ops.rips.sparse import csr_from_knn, rips_sparse

__all__ = ["rips", "rips_from_distances"]  # tdax's; the CSR pair is imported by name
