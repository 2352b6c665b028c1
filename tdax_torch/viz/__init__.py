"""Host-side plots (port of ``tdax.viz``): persistence diagrams, the
per-layer evolution figures and the interactive 3-D scatter.
Matplotlib is imported only when a plot is drawn."""

from tdax_torch.viz.diagrams import plot_diagrams
from tdax_torch.viz.evolution import plot_evolution_1x3, plot_evolution_2x2
from tdax_torch.viz.scatter3d import write_scatter3d_html

__all__ = ["plot_diagrams", "plot_evolution_2x2", "plot_evolution_1x3",
           "write_scatter3d_html"]
