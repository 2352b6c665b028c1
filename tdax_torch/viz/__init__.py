"""Plots of the sweep (port of ``tdax.viz``): persistence diagrams and
the per-layer evolution figure.  Matplotlib is imported only when a
plot is drawn."""
