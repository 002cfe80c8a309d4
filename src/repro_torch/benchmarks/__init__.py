"""The port's benchmarks: counterparts of ``benchmarks/traffic_bench.py``
and ``benchmarks/expert_tiering.py`` over ``repro_torch``, run with
``python -m repro_torch.benchmarks.<name>``."""
