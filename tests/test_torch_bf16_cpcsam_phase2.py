"""Phase 2 of the bfloat16 fixed-prompt loss parity of
``test_torch_bf16_cpcsam.py``: the three prompted passes, their supervised
and consistency terms and the gradients against ``mia_tpu``'s bfloat16
``SamDualmask``, at the same tolerances. It takes ~4 minutes on the CPU
(three prompted 2B passes through a bfloat16 model, JAX's with the Pallas
encoder in interpret mode), so it is marked slow: run it with ``-m slow``."""

import pytest

from test_torch_bf16_cpcsam import bf16_models, check_bf16_losses  # noqa: F401
from test_torch_cpcsam import batch  # noqa: F401


@pytest.mark.slow
def test_bfloat16_fixed_prompt_phase2_losses_and_gradients_match_jax(bf16_models, batch):  # noqa: F811
    check_bf16_losses(bf16_models, batch, phase2=True)
