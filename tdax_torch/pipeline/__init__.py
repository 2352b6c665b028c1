"""End-to-end workflows of the PyTorch port (port of ``tdax.pipeline``).

``run_tda_sweep`` and ``run_adversarial_sweep`` resolve on first use, so
that importing a workflow module does not import the others.
"""

__all__ = ["run_tda_sweep", "run_adversarial_sweep"]


def __getattr__(name):
    if name == "run_tda_sweep":
        from tdax_torch.pipeline.tda_sweep import run_tda_sweep
        return run_tda_sweep
    if name == "run_adversarial_sweep":
        from tdax_torch.pipeline.adversarial import run_adversarial_sweep
        return run_adversarial_sweep
    raise AttributeError(f"module 'tdax_torch.pipeline' has no attribute {name!r}")
