"""Per-layer evolution plot (port of ``tdax/viz/evolution.py``): the
reference's 2x2 figure (debug_tda_pipeline.py:160-193), max H1
persistence, number of H1 loops, shape and colour silhouettes, max H0
persistence against the layer.  Matplotlib, imported when drawn."""

from __future__ import annotations


def plot_evolution_2x2(stats: list[dict], out_path: str) -> None:
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    layers = [s["layer"] for s in stats]
    fig = plt.figure(figsize=(12, 10))

    plt.subplot(2, 2, 1)
    plt.plot(layers, [s["max_h1_persistence"] for s in stats], "o-", color="r")
    plt.title("Max $H_1$ Persistence vs. Layer")
    plt.ylabel("Max Persistence (Death - Birth)")
    plt.grid(True)

    plt.subplot(2, 2, 2)
    plt.plot(layers, [s["n_h1_features"] for s in stats], "o-", color="b")
    plt.title("Number of $H_1$ Loops vs. Layer")
    plt.ylabel("Number of $H_1$ Features")
    plt.grid(True)

    plt.subplot(2, 2, 3)
    plt.plot(layers, [s["silhouette_shape"] for s in stats], "o-", label="Shape Score",
             color="purple")
    plt.plot(layers, [s["silhouette_color"] for s in stats], "o-", label="Color Score",
             color="orange")
    plt.title("Clustering Score vs. Layer")
    plt.ylabel("Silhouette Score")
    plt.xlabel("Model Layer")
    plt.legend()
    plt.grid(True)

    plt.subplot(2, 2, 4)
    plt.plot(layers, [s["max_h0_persistence"] for s in stats], "o-", color="g")
    plt.title("Max $H_0$ Persistence vs. Layer")
    plt.ylabel("Max Persistence")
    plt.xlabel("Model Layer")
    plt.grid(True)

    plt.tight_layout()
    plt.savefig(out_path)
    plt.close(fig)
