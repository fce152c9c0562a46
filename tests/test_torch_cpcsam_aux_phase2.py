"""Phase 2 of the auxiliary-loss parity of ``test_torch_cpcsam_aux.py``: the
trainer's phase-2 losses, refreshed memory and gradients with the
contrastive loss and VAT both on against ``mia_tpu``'s, at the same
tolerances. A file of its own, so that its JAX compiles run beside the
other parity files."""

from test_torch_cpcsam import batch, models  # noqa: F401
from test_torch_cpcsam_aux import check_aux_losses


def test_phase2_losses_with_both_auxiliary_flags_match_jax(models, batch, monkeypatch):  # noqa: F811
    check_aux_losses(models, batch, monkeypatch, True, True, True)
