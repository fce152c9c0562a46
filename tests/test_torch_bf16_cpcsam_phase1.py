"""Phase 1 of the bfloat16 fixed-prompt loss parity of
``test_torch_bf16_cpcsam.py``: the unprompted pass of the labeled images,
loss1 and the LoRA and decoder gradients against ``mia_tpu``'s bfloat16
``SamDualmask``. A file of its own, so that its JAX compile runs beside the
other parity files."""

from test_torch_bf16_cpcsam import bf16_models, check_bf16_losses  # noqa: F401
from test_torch_cpcsam import batch  # noqa: F401


def test_bfloat16_fixed_prompt_phase1_losses_and_gradients_match_jax(bf16_models, batch):  # noqa: F811
    check_bf16_losses(bf16_models, batch, phase2=False)
