"""Process group, mesh, sharding rules and the training step (port of
``tdax.parallel``).

``mesh`` joins a ``torch.distributed`` process group and holds tdax's
dp x tp mesh, sharding rules and ``shard_params``, with the collectives
the model's tp sites and the extraction's dp gather run; ``train`` the
single-device step and loop.  tdax's FSDP rules, hybrid mesh, sequence
and context parallelism and the 1F1B pipeline are not ported yet.

Names resolve on first use, so that the model can import ``mesh``
without importing the training step (which imports the model).
"""

_MESH = ("make_mesh", "param_sharding_rules", "shard_params")
_TRAIN = ("AdamW", "OptState", "default_optimizer", "lm_loss", "make_train_step",
          "masked_ce", "masked_ce_parts", "train_loop", "warmup_cosine_lr")

__all__ = [*_MESH, *_TRAIN]


def __getattr__(name):
    if name in _MESH:
        from tdax_torch.parallel import mesh
        return getattr(mesh, name)
    if name in _TRAIN:
        from tdax_torch.parallel import train
        return getattr(train, name)
    raise AttributeError(f"module 'tdax_torch.parallel' has no attribute {name!r}")
