"""The reading of ``launches_per_step``, in a cell whose throughput
the host paces, where a step's time shows end to end in ``tpot_p95_ms``
alone."""

from pathlib import Path

from portbench.harness.spec import metric_reader

read = metric_reader("launches_per_step", Path(__file__).resolve().parents[2])
