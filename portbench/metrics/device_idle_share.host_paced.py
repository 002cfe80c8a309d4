"""The reading of ``device_idle_share.decode``, in a cell whose throughput
the host paces, where a step's time shows end to end in ``tpot_p95_ms``
alone."""

from pathlib import Path

from portbench.harness.spec import metric_reader

read = metric_reader("device_idle_share.decode", Path(__file__).resolve().parents[2])
