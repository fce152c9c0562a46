"""Phase 2 of the fixed-prompt loss parity of ``test_torch_cpcsam.py``: the
three prompted passes, the supervised and consistency terms and the LoRA
gradients against ``mia_tpu``'s, at the same tolerances. A file of its own,
so that its JAX compile runs beside the other parity files."""

from test_torch_cpcsam import batch, check_fixed_prompt_losses, models  # noqa: F401


def test_fixed_prompt_phase2_losses_and_lora_gradients_match_jax(models, batch):  # noqa: F811
    check_fixed_prompt_losses(models, batch, phase2=True)
