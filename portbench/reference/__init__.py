"""The plain PyTorch reference that decides ``correct``.  It imports
nothing of ``jax``, ``repro`` or ``repro_torch``."""
