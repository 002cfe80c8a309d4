"""The serving engine's reference plane in bfloat16 against the JAX
engine's: the lifecycle of ``tests/test_serving_parity.py`` for the seven
served smoke archs.  What is held, and the runs that part at a float32
rounding tie, are set out in ``test_torch_bf16_serving.py``."""

import pytest

pytest.importorskip("torch")

from test_torch_bf16_serving import ARCHS, check_lifecycle  # noqa: E402


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_reference_lifecycle_matches_jax_engine(arch):
    check_lifecycle(arch, "reference")
