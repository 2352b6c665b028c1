"""Training on one card (port of ``tdax.parallel``'s training step).

tdax's meshes, sharded ops, sequence / context parallelism, FSDP and the
1F1B pipeline are not ported yet; ``train`` holds the single-device step
and loop.
"""

from tdax_torch.parallel.train import (AdamW, OptState, default_optimizer, lm_loss,
                                       make_train_step, masked_ce, masked_ce_parts,
                                       train_loop, warmup_cosine_lr)

__all__ = ["AdamW", "OptState", "default_optimizer", "lm_loss", "make_train_step",
           "masked_ce", "masked_ce_parts", "train_loop", "warmup_cosine_lr"]
