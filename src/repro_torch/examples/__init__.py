"""The port's examples (counterparts of the JAX package's ``examples/``):
``python -m repro_torch.examples.quickstart``, ``... .serve_tiered`` and
``... .train_e2e``."""
