"""Metrics of the PyTorch port (port of ``tdax.metrics``): silhouette,
persistence summaries and distances between diagrams, and the geometry
metrics."""

from tdax_torch.metrics.geometry import (compute_accuracy_by_example,
                                         compute_effective_dimensionality,
                                         compute_fixed_window_ed, compute_fixed_window_id,
                                         compute_intrinsic_dimensionality, matrix_entropy)
from tdax_torch.metrics.persistence import (bottleneck_distance, diagram_stats, get_persistence,
                                            wasserstein_distance)
from tdax_torch.metrics.silhouette import silhouette_score

__all__ = [
    "silhouette_score", "get_persistence", "bottleneck_distance",
    "wasserstein_distance",
    "diagram_stats",
    "compute_effective_dimensionality", "compute_fixed_window_ed",
    "compute_intrinsic_dimensionality", "compute_fixed_window_id",
    "compute_accuracy_by_example", "matrix_entropy",
]
