"""The port's benchmarks: one counterpart of each module of the JAX
package's ``benchmarks/`` over ``repro_torch``, under the same names, run
with ``python -m repro_torch.benchmarks.<name>`` or all through
``python -m repro_torch.benchmarks.run``.  They write JSON only where
``--out`` says."""
