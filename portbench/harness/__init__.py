"""The benchmark's yardstick: loading the data files, traffic, loops,
metric arithmetic, work counts, trace reduction and the output check."""
