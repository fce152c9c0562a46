"""The LoRA gradients of a narrow encoder of each route in bfloat16 against
the JAX encoder of the same option with ``dtype=bfloat16``: the backward
through K6b, K7's plain VJP, K8b or K9b (and the default route's kernels in
the other blocks) on the CPU, where every kernel takes its plain bfloat16
version.

The encoders are ``test_torch_bf16_routes.py``'s (LoRA rank 2, every leaf
seeded) with the loss ``sum(weight · embedding)``: the loss and the LoRA
gradients against ``jax.value_and_grad`` of the JAX encoder of the same
option in bfloat16, compiled op by op (``jax_bf16.py``). JAX's CPU autodiff
of flax's LayerNorm rounds its input cotangent twice and adds the two
roundings in bfloat16; the reference uses ``OnceRoundedLayerNorm``
(``test_torch_bf16_cpcsam.py``), whose VJP is float32 rounded once, as the
port's. The loss lies within ``LOSS_TOL`` and the LoRA gradients within
``LORA_TOL`` of JAX's bfloat16 encoder, each asserted below JAX's
bfloat16-vs-float32 gap; the port's float32 encoder misses both.
"""

import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp

import torch
from jax_bf16 import jit_op_by_op
from test_torch_bf16_cpcsam import OnceRoundedLayerNorm
from test_torch_bf16_routes import (BF, ROUTES, _f32, _rel, encoder_params, jax_encoder,  # noqa: F401
                                    port_encoder, route_params)

from mia_tpu_torch.models.sam_flax_bridge import sam_state_dict_from_flax

# the loss's relative distance to JAX's bfloat16 encoder: measured 2.07e-5 (K7) and 6.84e-5 (K6,
# K8, K9) against gaps of 1.57e-3 (K7) and 6.04e-4; the LoRA gradients' relative Frobenius
# distance: measured 2.91e-3 - 3.94e-3 against gaps of 6.16e-3 - 8.17e-3 (0.36-0.48 of each:
# a last-bit flip of a bfloat16 product compounds through three blocks and their backward). The
# port's float32 encoder lies as far as the gap. With flax's own LayerNorm VJP in the reference
# (its CPU autodiff rounds the input cotangent twice) the LoRA gradients lie 4.71e-3 - 5.38e-3
# away (0.61-0.80 of the gap).
LOSS_TOL = 2e-4
LORA_TOL = 5e-3


def _jax_loss_and_lora(params, x, weight, route, dtype):
    mdl = jax_encoder(route, dtype)

    def loss(p, x, w):
        return (mdl.apply({"params": p}, x).astype(jnp.float32) * w).sum()

    value, grads = jit_op_by_op(jax.value_and_grad(loss))(params, jnp.asarray(x),
                                                          jnp.asarray(weight))
    sd = sam_state_dict_from_flax({"params": {"image_encoder": jax.device_get(grads)}})
    return float(value), {k.removeprefix("image_encoder."): v.float().numpy()
                          for k, v in sd.items() if "lora_" in k}


def _port_loss_and_lora(params, x, weight, route, dtype):
    enc = port_encoder(params, route, dtype)
    names = [n for n, _ in enc.named_parameters() if "lora_" in n]
    for n, p in enc.named_parameters():
        p.requires_grad_(n in names)
    loss = (enc(torch.from_numpy(x)).float() * torch.from_numpy(weight)).sum()
    grads = torch.autograd.grad(loss, [dict(enc.named_parameters())[n] for n in names])
    return loss.item(), {n: g.float().numpy() for n, g in zip(names, grads)}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_encoder_route_lora_gradients_match_jax_bfloat16(encoder_params, route):
    """The loss and the LoRA gradients of each route's bfloat16 encoder (every
    LoRA tensor of every block; the backward through K6b, K7's plain VJP,
    K8b or K9b and the default route's kernels) against JAX's bfloat16
    encoder of the same option: within ``LOSS_TOL`` and ``LORA_TOL``, under
    JAX's own bfloat16-vs-float32 gaps; the port's float32 encoder misses."""
    x, params = encoder_params
    params = route_params(params, route)
    weight = _f32(np.random.default_rng(22), 2, 10, 10, 256)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "LayerNorm", OnceRoundedLayerNorm)
        j16 = _jax_loss_and_lora(params, x, weight, route, jnp.bfloat16)
    j32 = _jax_loss_and_lora(params, x, weight, route, jnp.float32)
    p16 = _port_loss_and_lora(params, x, weight, route, BF)
    p32 = _port_loss_and_lora(params, x, weight, route, torch.float32)
    assert set(p16[1]) == set(j16[1]) and len(p16[1]) == 12  # q and v, A and B, 3 blocks
    keys = sorted(p16[1])

    def flat(grads):
        return np.concatenate([grads[k].ravel() for k in keys])

    loss_gap = abs(j16[0] - j32[0]) / abs(j32[0])
    loss_err = abs(p16[0] - j16[0]) / abs(j32[0])
    assert loss_err <= LOSS_TOL < loss_gap, (route, loss_err, loss_gap)
    assert abs(p32[0] - j16[0]) / abs(j32[0]) > LOSS_TOL, route
    gap = _rel(flat(j16[1]), flat(j32[1]), flat(j32[1]))
    err = _rel(flat(p16[1]), flat(j16[1]), flat(j32[1]))
    assert err <= LORA_TOL < gap, (route, err, gap)
    assert _rel(flat(p32[1]), flat(j16[1]), flat(j32[1])) > LORA_TOL, route
