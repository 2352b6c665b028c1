"""Process group, mesh, sharding rules and the training step (port of
``tdax.parallel``).

``mesh`` joins a ``torch.distributed`` process group and holds tdax's
dp x tp mesh and its hybrid dcn x dp x tp mesh, the Megatron and FSDP
sharding rules and ``shard_params``, with the collectives the model's
tp sites and FSDP gathers, the extraction's dp gather and the sweep's
layer split run; ``sharded_ops`` the row-sharded distances, kNN and
sparse edge extraction of the scale paths (a module of its own, as in
tdax, whose ``__all__`` does not name them); ``train`` the training
step and loop, on one device or over a mesh with sequence parallelism,
FSDP (ZeRO-3), gradient accumulation and context parallelism
(``make_mesh(cp=)``, ``cp_mesh=``; it adds no name to tdax's
``__all__``); ``pipeline`` the decoder's stages over a ``pp`` axis,
tdax's GPipe forward and its 1F1B and GPipe training schedules.

``__all__`` holds tdax's 17 names.  ``train``'s own names
(``AdamW``, ``OptState``, ``masked_ce``, ``masked_ce_parts``) resolve
here too, as attributes.  Names resolve on first use, so that the model
can import ``mesh`` without importing the training step (which imports
the model).
"""

_MESH = ("make_mesh", "make_hybrid_mesh", "hybrid_batch_sharding", "param_sharding_rules",
         "shard_params", "fsdp_sharding_rules", "named_shardings")
_TRAIN = ("lm_loss", "make_train_step", "train_loop", "default_optimizer", "warmup_cosine_lr")
_TRAIN_OWN = ("AdamW", "OptState", "masked_ce", "masked_ce_parts")
_PIPELINE = ("make_pp_mesh", "pipeline_forward", "shard_params_pp", "make_train_step_pp",
             "pipeline_1f1b_grads")

__all__ = [*_MESH, *_TRAIN, *_PIPELINE]


def __getattr__(name):
    if name in _MESH:
        from tdax_torch.parallel import mesh
        return getattr(mesh, name)
    if name in _TRAIN or name in _TRAIN_OWN:
        from tdax_torch.parallel import train
        return getattr(train, name)
    if name in _PIPELINE:
        from tdax_torch.parallel import pipeline
        return getattr(pipeline, name)
    raise AttributeError(f"module 'tdax_torch.parallel' has no attribute {name!r}")
