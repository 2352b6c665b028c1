"""Metrics of the PyTorch port: silhouette and persistence summaries
(port of ``tdax.metrics``; the geometry metrics come in a later slice)."""
