"""UMAP estimator and the batched sweep paths (port of
``tdax/ops/umap/umap.py``).

The reference uses two modes:
  * a fresh ``fit_transform`` per layer cloud (debug_tda_pipeline.py:96-104);
  * ``fit`` on the last layer, then ``transform`` of every layer, the
    shared-reducer "same camera" mode (analyze_tda_over_layers.py:65-72).

``fit_transform_batched`` and ``shared_transform_batched`` run either
mode on a stack of clouds [L, n, D] with the layer axis as a leading
batch dimension, where tdax vmaps one jitted program.  Under a process
group whose size divides L each rank embeds its contiguous share of the
layers and the embeddings are gathered (``shard_layer_axis``, tdax's
sharding of that axis over its devices).  Past the
instance's ``sparse_threshold`` (2048 points) ``UMAP.fit`` embeds on
the edge list (``sparse_path.py``), and ``UMAP.transform`` does too past
``sparse_threshold`` squared (train x new) pairs, as tdax dispatches.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from tdax_torch.config import UMAPConfig
from tdax_torch.ops.umap.fuzzy import fuzzy_simplicial_set, smooth_knn_dist
from tdax_torch.ops.umap.layout import optimize_layout
from tdax_torch.ops.umap.spectral import spectral_init
from tdax_torch.parallel import mesh as pm
from tdax_torch.runtime import as_device_f32

@functools.lru_cache(maxsize=64)
def find_ab_params(spread: float, min_dist: float) -> tuple[float, float]:
    """Fit (a, b) of 1/(1 + a x^(2b)) to the fuzzy membership target
    (umap-learn's find_ab_params, via scipy)."""
    from scipy.optimize import curve_fit

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.zeros_like(xv)
    yv[xv < min_dist] = 1.0
    yv[xv >= min_dist] = np.exp(-(xv[xv >= min_dist] - min_dist) / spread)
    params, _ = curve_fit(curve, xv, yv)
    return float(params[0]), float(params[1])


def _default_epochs(n: int, n_epochs: int | None) -> int:
    if n_epochs is not None:
        return int(n_epochs)
    return 500 if n <= 10000 else 200


def _transform_epochs(n_epochs_cfg: int | None, n_new: int) -> int:
    """umap-learn's transform epoch rule (n_epochs // 3, else 100 / 30)."""
    return int(n_epochs_cfg // 3) if n_epochs_cfg else (100 if n_new <= 10000 else 30)


def _embed(x: torch.Tensor, n_neighbors: int, n_components: int, metric: str,
           n_epochs: int, random_state: int, a: float, b: float, learning_rate: float,
           negative_sample_rate: int, repulsion_strength: float, local_connectivity: float,
           set_op_mix_ratio: float, init: torch.Tensor | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Clouds [..., n, D] -> (embedding [..., n, n_components], fuzzy graph).

    ``init`` replaces the spectral init (tests only: tdax's Threefry
    jitter cannot be drawn here, so parity runs start from tdax's init)."""
    w, _, _ = fuzzy_simplicial_set(x, n_neighbors, metric,
                                   local_connectivity=local_connectivity,
                                   set_op_mix_ratio=set_op_mix_ratio)
    if init is None:
        init = spectral_init(w, n_components, random_state)
    emb = optimize_layout(init, init, w, n_epochs, a, b, gamma=repulsion_strength,
                          initial_alpha=learning_rate,
                          negative_sample_rate=negative_sample_rate, move_other=True)
    return emb, w


def _transform_core(x: torch.Tensor, train_x: torch.Tensor, train_emb: torch.Tensor, k: int,
                    metric: str, n_epochs: int, a: float, b: float, learning_rate: float,
                    negative_sample_rate: int, repulsion_strength: float,
                    local_connectivity: float) -> torch.Tensor:
    """Embed new points x [..., m, D] against a fitted reducer (train
    points [n, D] and their embedding fixed): the core of
    ``UMAP.transform`` and of the shared-reducer sweep."""
    n_new, n_train = x.shape[-2], train_x.shape[-2]
    if metric == "cosine":
        xn = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-30)
        tn = train_x / torch.linalg.vector_norm(train_x, dim=-1, keepdim=True).clamp_min(1e-30)
        dist = (1.0 - xn @ tn.transpose(-1, -2)).clamp(0.0, 2.0)
    else:
        d2 = ((x * x).sum(-1)[..., :, None] + (train_x ** 2).sum(-1)[..., None, :]
              - 2.0 * x @ train_x.transpose(-1, -2))
        dist = d2.clamp_min(0.0).sqrt()
    if n_new == n_train:
        # x IS train_x for the fit layer: rho's "smallest nonzero distance"
        # rule is discontinuous at 0, so its self-distances are pinned to
        # the exact 0 that exact arithmetic gives (tdax umap.py:94-105)
        same = (x == train_x).flatten(-2).all(-1)[..., None, None]
        eye = torch.eye(n_new, dtype=torch.bool, device=x.device)
        dist = torch.where(same & eye, 0.0, dist)
    neg, idx = torch.topk(-dist, k, dim=-1)
    dists = -neg

    # no self column in a cross-kNN: prepend a zero column so the
    # calibration's skip-self convention holds
    sigma, rho = smooth_knn_dist(torch.cat([torch.zeros_like(dists[..., :1]), dists], -1),
                                 float(k), local_connectivity=local_connectivity)
    d_adj = dists - rho[..., None]
    w = torch.where(d_adj <= 0.0, 1.0, torch.exp(-d_adj / sigma[..., None]))
    graph = torch.zeros((*dists.shape[:-1], n_train), dtype=w.dtype, device=w.device)
    graph = graph.scatter_add_(-1, idx, w)

    # init: weighted mean of the neighbours' embeddings
    train_emb = train_emb.to(torch.float32)
    wsum = graph.sum(-1, keepdim=True).clamp_min(1e-12)
    init = (graph @ train_emb) / wsum
    return optimize_layout(init, train_emb, graph, n_epochs, a, b, gamma=repulsion_strength,
                           # umap-learn's transform damps the step size
                           initial_alpha=learning_rate / 4.0,
                           negative_sample_rate=negative_sample_rate, move_other=False)


class UMAP:
    """The reference's as-used ``umap.UMAP`` surface."""

    # above this point count the dense [n, n] fuzzy graph and [n, n, d]
    # epoch tensor stop fitting and the edge-list path takes over; an
    # instance may set its own (the tests force the edge-list path so)
    sparse_threshold: int = 2048

    def __init__(self, n_neighbors: int = 15, n_components: int = 2, min_dist: float = 0.1,
                 spread: float = 1.0, metric: str = "euclidean",
                 random_state: int | None = None, n_epochs: int | None = None,
                 learning_rate: float = 1.0, negative_sample_rate: int = 5,
                 repulsion_strength: float = 1.0, local_connectivity: float = 1.0,
                 set_op_mix_ratio: float = 1.0, init: str = "spectral", device=None):
        self.n_neighbors = n_neighbors
        self.n_components = n_components
        self.min_dist = min_dist
        self.spread = spread
        self.metric = metric
        self.random_state = 42 if random_state is None else int(random_state)
        self.n_epochs = n_epochs
        self.learning_rate = learning_rate
        self.negative_sample_rate = negative_sample_rate
        self.repulsion_strength = repulsion_strength
        self.local_connectivity = local_connectivity
        self.set_op_mix_ratio = set_op_mix_ratio
        if init != "spectral":
            raise NotImplementedError("only spectral init is supported")
        self.device = device
        self._a, self._b = find_ab_params(spread, min_dist)
        self.embedding_ = None
        self._train_x = None

    @classmethod
    def from_config(cls, cfg: UMAPConfig, device=None) -> "UMAP":
        return cls(n_neighbors=cfg.n_neighbors, n_components=cfg.n_components,
                   min_dist=cfg.min_dist, spread=cfg.spread, metric=cfg.metric,
                   random_state=cfg.random_state, n_epochs=cfg.n_epochs,
                   learning_rate=cfg.learning_rate,
                   negative_sample_rate=cfg.negative_sample_rate,
                   repulsion_strength=cfg.repulsion_strength,
                   local_connectivity=cfg.local_connectivity,
                   set_op_mix_ratio=cfg.set_op_mix_ratio, device=device)

    def fit(self, x) -> "UMAP":
        t0 = time.perf_counter()
        x = as_device_f32(x, self.device)  # a copy from the host ends before it returns
        upload_s = time.perf_counter() - t0
        n = x.shape[0]
        if n < 2:
            raise ValueError(f"UMAP requires at least 2 samples, got {n}")
        k = min(self.n_neighbors, n - 1)
        if n > self.sparse_threshold:
            from tdax_torch.ops.umap import sparse_path
            self.embedding_ = sparse_path.embed_sparse(
                x, k, self.n_components, self.metric, _default_epochs(n, self.n_epochs),
                self.random_state, self._a, self._b, self.learning_rate,
                self.negative_sample_rate, self.repulsion_strength, self.local_connectivity,
                self.set_op_mix_ratio)
            # the cloud came to the device here, before embed_sparse
            sparse_path.LAST_TIMINGS["upload_s"] += upload_s
        else:
            emb, _ = _embed(x, k, self.n_components, self.metric,
                            _default_epochs(n, self.n_epochs), self.random_state,
                            self._a, self._b, self.learning_rate, self.negative_sample_rate,
                            self.repulsion_strength, self.local_connectivity,
                            self.set_op_mix_ratio)
            self.embedding_ = emb.cpu().numpy()
        self._train_x = x
        return self

    def fit_transform(self, x) -> np.ndarray:
        self.fit(x)
        return self.embedding_

    def transform(self, x) -> np.ndarray:
        """Embed new points against the fitted reducer (train points fixed)."""
        if self.embedding_ is None:
            raise RuntimeError("transform called before fit")
        x = as_device_f32(x, self.device)
        n_new, n_train = x.shape[0], self._train_x.shape[0]
        k = min(self.n_neighbors, n_train)
        n_epochs = _transform_epochs(self.n_epochs, n_new)
        # past the dense fit ceiling's product the edge-list transform
        # takes over (always the case when the fit itself was sparse)
        if n_new * n_train > self.sparse_threshold ** 2:
            from tdax_torch.ops.umap.sparse_path import transform_sparse
            return transform_sparse(x, self._train_x, self.embedding_, k, self.metric,
                                    n_epochs, self.random_state, self._a, self._b,
                                    self.learning_rate, self.negative_sample_rate,
                                    self.repulsion_strength, self.local_connectivity)
        train_emb = torch.as_tensor(self.embedding_).to(x.device)
        emb = _transform_core(x, self._train_x, train_emb, k, self.metric, n_epochs,
                              self._a, self._b, self.learning_rate, self.negative_sample_rate,
                              self.repulsion_strength, self.local_connectivity)
        return emb.cpu().numpy()


def shard_layer_axis(embed, clouds: torch.Tensor) -> torch.Tensor:
    """``embed`` over the layer axis of clouds [L, ...]: under a process
    group whose W ranks divide L (a group of one included) each rank
    embeds its contiguous L/W layers and the results are gathered in
    rank order, as tdax shards that axis over its devices when they
    divide it; otherwise ``embed(clouds)`` whole, on every rank.
    Collective under a group: every rank calls it with the same stack."""
    mesh = pm.dp_mesh(clouds.shape[0])
    if mesh is None:
        return embed(clouds)
    per = clouds.shape[0] // mesh.shape["dp"]
    r0 = mesh.local_rank("dp") * per
    return pm.all_gather(embed(clouds[r0:r0 + per]), mesh, "dp")


def batched_embed(clouds: torch.Tensor, cfg: UMAPConfig, k: int, n_epochs: int,
                  a: float, b: float) -> torch.Tensor:
    """Per-layer fits of clouds [L, n, D] -> [L, n, n_components]
    (tdax's ``batched_embed_fn``): every layer with the same seed, as
    the reference builds a fresh ``UMAP(random_state=42)`` per layer;
    the layers split over a process group's ranks (``shard_layer_axis``)."""
    def embed(part):
        return _embed(part, k, cfg.n_components, cfg.metric, n_epochs, cfg.random_state,
                      a, b, cfg.learning_rate, cfg.negative_sample_rate,
                      cfg.repulsion_strength, cfg.local_connectivity, cfg.set_op_mix_ratio)[0]
    return shard_layer_axis(embed, clouds)


def batched_shared_embed(clouds: torch.Tensor, cfg: UMAPConfig, k: int, n_fit_epochs: int,
                         n_t_epochs: int, a: float, b: float) -> torch.Tensor:
    """Shared reducer (tdax's ``batched_shared_embed_fn``): fit on the
    LAST layer, then transform every layer against it, [L, n, D] ->
    [L, n, n_components].  The same as ``UMAP.fit`` + a per-layer
    ``transform`` loop: the transform draws nothing at random.  Under a
    process group every rank fits the whole stack's last layer and
    transforms its own share of the layers (``shard_layer_axis``)."""
    train = clouds[-1]
    emb_train, _ = _embed(train, k, cfg.n_components, cfg.metric, n_fit_epochs,
                          cfg.random_state, a, b, cfg.learning_rate,
                          cfg.negative_sample_rate, cfg.repulsion_strength,
                          cfg.local_connectivity, cfg.set_op_mix_ratio)
    return shard_layer_axis(
        lambda part: _transform_core(part, train, emb_train, k, cfg.metric, n_t_epochs, a, b,
                                     cfg.learning_rate, cfg.negative_sample_rate,
                                     cfg.repulsion_strength, cfg.local_connectivity),
        clouds)


def _prepare(clouds, cfg: UMAPConfig | None, n_neighbors: int | None, device):
    cfg = cfg or UMAPConfig()
    cs = as_device_f32(clouds, device)
    n = cs.shape[1]
    if n < 2:
        raise ValueError(f"UMAP requires at least 2 samples per cloud, got {n}")
    k = n_neighbors if n_neighbors is not None else min(cfg.n_neighbors, n - 1)
    return cfg, cs, n, k, find_ab_params(cfg.spread, cfg.min_dist)


def fit_transform_batched(clouds, cfg: UMAPConfig | None = None,
                          n_neighbors: int | None = None, device=None) -> np.ndarray:
    """Embed a stack of clouds [L, n, D] -> [L, n, n_components], one fit
    per layer; under a process group the layers split over its ranks
    (collective: every rank calls it with the same stack)."""
    cfg, cs, n, k, (a, b) = _prepare(clouds, cfg, n_neighbors, device)
    return batched_embed(cs, cfg, k, _default_epochs(n, cfg.n_epochs), a, b).cpu().numpy()


def shared_transform_batched(clouds, cfg: UMAPConfig | None = None,
                             n_neighbors: int | None = None, device=None) -> np.ndarray:
    """Shared-reducer embed of a stack [L, n, D] -> [L, n, c]: fit on
    clouds[-1], transform every layer.  Dense path only (n <= the sparse
    threshold): the legacy mode's workloads are the 36-point clouds.
    Under a process group the transforms split over its ranks
    (collective: every rank calls it with the same stack)."""
    cfg, cs, n, k, (a, b) = _prepare(clouds, cfg, n_neighbors, device)
    if n > UMAP.sparse_threshold:
        raise ValueError(
            f"shared_transform_batched is dense-path only (n <= "
            f"{UMAP.sparse_threshold}, got {n}); use UMAP.fit + transform")
    return batched_shared_embed(cs, cfg, k, _default_epochs(n, cfg.n_epochs),
                                _transform_epochs(cfg.n_epochs, n), a, b).cpu().numpy()
