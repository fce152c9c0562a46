"""The CPC-SAM decoder's bfloat16 forward and backward module by module
against JAX's, on JAX's own inputs.

One unprompted pass of decoder 0 of the narrow ``SamDualmask`` of
``test_torch_bf16_cpcsam.py`` (the decoder is full width: 256 channels, 8
heads, MLP 2048, four upscaler stages) runs eagerly in JAX's
``SamDualmask(dtype=bfloat16)``, so op by op, and every flax module call
under the decoder is recorded (``flax.linen.intercept_methods``), the whole
decoder's too. Each is replayed on the port's module of the same name: its
outputs, the cotangent of each input and the gradient of each parameter
against ``jax.vjp`` of that flax module (compiled op by op, ``jax_bf16.py``,
its LayerNorms' VJP rounded once as the port's:
``test_torch_bf16_cpcsam.py::OnceRoundedLayerNorm``) on the same inputs and
a seeded cotangent.

- Inside a module, the outputs of its products (each Linear and transposed
  convolution) are forced to JAX's recorded values, while their VJPs stay the
  port's: a float32 sum in another order rounds about one output in 2000 the
  other way (``test_torch_bf16_sam.py``), and a softmax carries such a flip
  into its whole row. What lies between the products (softmaxes, residual
  sums, norms, ReLU, GELU and all the VJPs) is the port's own.
- The products, norms, MLPs and the upscaler (``ULPS``): every output, input
  cotangent and weight gradient within one bfloat16 ulp of JAX's (two inside
  an MLP or the upscaler; the ulp taken at no less than 2^-6 of max |JAX|)
  and at least 99% bit-equal (98%); a value that is not bfloat16 (a norm's
  float32 parameter gradient, the cotangent of a float32 input) within 1e-6
  relative (1e-4 inside the upscaler).
- The attentions, the two-way blocks, the transformer and the whole decoder
  (``SHARES``): outputs as above; the input cotangents and the weight
  gradients (each group concatenated) no farther from JAX's than the stated
  share of JAX's own bfloat16-vs-float32 distance on the same inputs
  (measured shares in the comment). An attention's query and key gradients
  cancel (the softmax's dS sums to zero along a row, and the keys share a
  large common part), so float32 rounding decides a few percent of their
  bfloat16 roundings in both packages, and the modules upstream carry that.
- Every product's bias gradient, alone or inside a module, equals the float64
  sum of the cotangent that reaches it rounded once to bfloat16 (one ulp, 99%
  bit-equal). JAX's CPU backward sums it in bfloat16 and misses that in 32
  of the 47 Linears and in the 4 convolutions, by up to 56 and 463 ulps
  (asserted for most), so JAX's bias gradients are not the reference.
- The port's float32 modules miss each check on the same inputs (every kind
  but the norms, which compute in float32 in both).
"""

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp

from mia_tpu.models.sam import SamDualmask as JaxSamDualmask

import torch
from jax_bf16 import jit_op_by_op
from test_torch_bf16_cpcsam import OnceRoundedLayerNorm, _rel, bf16_models  # noqa: F401
from test_torch_bf16_sam import _agreement, _port_module_name, _torch
from test_torch_cpcsam import KW

from mia_tpu_torch.models.sam import SamDualmask
from mia_tpu_torch.models.sam_flax_bridge import sam_state_dict_from_flax

PRODUCTS = ("Dense", "EinsumConvTranspose2x")  # flax modules that add a bias after a product
NORMS = ("LayerNorm", "LayerNorm2d")
# (bfloat16 ulps, share bit-equal) of outputs, input cotangents and weight gradients
# against JAX's (measured: 1 / 0.9992, 1 / 0.9999, 0 / 1.0, 1 / 0.9998, 1 / 0.9894,
# 0 / 1.0, 1.5 / 0.9983), and the relative distance of values that are not bfloat16
# (measured <= 6.7e-7; 2.9e-5 for a norm's scale inside the upscaler): inside an MLP or
# the upscaler a flipped hidden cotangent reaches a whole row of the next gradients
ULPS = {"Dense": (1.0, 0.99), "EinsumConvTranspose2x": (1.0, 0.99), "LayerNorm": (1.0, 0.99),
        "LayerNorm2d": (1.0, 0.99), "MLPReLU": (2.0, 0.98), "MLP": (2.0, 0.98),
        "_Upscaler": (2.0, 0.98, 1e-4)}
# ‖port − JAX bfloat16‖ / ‖JAX bfloat16 − JAX float32‖ of the input cotangents and of the
# weight gradients, at most over the calls; measured 0.084 / 0.072 (the last token-to-image
# attention; the other six read 0-0.0034), 0.129 / 0.064, 0.176 / 0.141, 0.093 / 0.053,
# where the port's float32 module reads 1.00 / 0.92, 0.27 / 0.27, 0.30 / 0.28, 0.22 / 0.17
SHARES = {"Attention": {"dx": 0.2, "weights": 0.2},
          "TwoWayAttentionBlock": {"dx": 0.2, "weights": 0.15},
          "TwoWayTransformer": {"dx": 0.25, "weights": 0.2},
          "MaskDecoderPromptLarge": {"dx": 0.15, "weights": 0.1}}
KINDS = tuple(ULPS) + tuple(SHARES)
CALLS = {"Dense": 47, "EinsumConvTranspose2x": 4, "LayerNorm": 9, "LayerNorm2d": 3,
         "Attention": 7, "MLPReLU": 2, "MLP": 5, "_Upscaler": 1, "TwoWayAttentionBlock": 2,
         "TwoWayTransformer": 1, "MaskDecoderPromptLarge": 1}


@pytest.fixture(scope="module")
def decoder_calls(bf16_models):  # noqa: F811
    """(path, kind, unbound flax module, its params, args, outputs) of every
    module call under JAX's bfloat16 decoder 0, in the order they return,
    and the port's bfloat16 and float32 decoder 0 modules by name."""
    params, _ = bf16_models
    jm = JaxSamDualmask(**KW, dtype=jnp.bfloat16, use_stacked_decoders=False)
    rng = np.random.default_rng(6)
    emb = jnp.asarray(rng.standard_normal((2, 4, 4, 256)).astype(np.float32), jnp.bfloat16)
    calls = []

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        mod = context.module
        if (context.method_name == "__call__" and mod.path[:1] == ("mask_decoder0",)
                and not kwargs and isinstance(args[0], jax.Array)):
            unbound, variables = mod.unbind()
            kind = "LayerNorm" if isinstance(mod, OnceRoundedLayerNorm) else type(mod).__name__
            calls.append((mod.path, kind, unbound, variables["params"], args, out))
        return out

    def decode(mdl, emb):
        sparse, dense = mdl.prompt_encoder()
        sparse = jnp.broadcast_to(sparse, (emb.shape[0],) + sparse.shape[1:])
        return mdl._run_decoder(0, emb, sparse, dense, True)

    with pytest.MonkeyPatch.context() as mp, nn.intercept_methods(record):
        mp.setattr(nn, "LayerNorm", OnceRoundedLayerNorm)
        jm.apply({"params": params}, emb, method=decode)
    port = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = SamDualmask(**KW, compute_dtype=dtype)
        model.load_state_dict(sam_state_dict_from_flax({"params": params}), strict=True)
        port[dtype] = dict(model.mask_decoder0.named_modules())
    return calls, port


def _name(path) -> str:
    """A flax module path under decoder 0 → the port's module name (the
    four-stage upscaler: stage i's convolution at 3i, its norm at 3i + 1)."""
    stages = {f"up{i}": str(3 * i) for i in range(4)} | {f"norm{i}": str(3 * i + 1) for i in range(3)}
    if "output_upscaling" in path:
        path = tuple(stages.get(p, p) for p in path)
    return _port_module_name(path)


def _nest(path, tree):
    for key in reversed(path):
        tree = {key: tree}
    return tree


def _bf16_valued(a) -> bool:
    a = np.asarray(a, np.float32)
    return bool((a == np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)).all())


def _cat(tensors):
    return np.concatenate([np.asarray(t.float() if isinstance(t, torch.Tensor) else t,
                                      np.float32).ravel() for t in tensors])


def _once_rounded_sum(g: torch.Tensor) -> torch.Tensor:
    """The float64 sum of a cotangent over all but its last (channel) axis,
    rounded once to bfloat16."""
    g = g.double()
    return g.reshape(-1, g.shape[-1]).sum(0).to(torch.bfloat16).float()


def _f32(mod):
    """The flax module in float32 (a decoder's transformer with it)."""
    if hasattr(mod, "transformer"):
        return mod.clone(dtype=jnp.float32, transformer=mod.transformer.clone(dtype=jnp.float32))
    return mod.clone(dtype=jnp.float32)


def _jax_vjp(mod, params, args, cotangents):
    """(outputs, parameter gradients, cotangents of the array arguments) of
    the flax module, compiled op by op."""
    arrays = [j for j, a in enumerate(args) if isinstance(a, jax.Array)]

    def run(p, xs, gs):
        def f(p, *xs):
            full = list(args)
            for j, x in zip(arrays, xs):
                full[j] = x
            return mod.apply({"params": p}, *full)

        y, vjp = jax.vjp(f, p, *xs)
        dp, *dxs = vjp(gs if isinstance(y, tuple) else gs[0])
        return y if isinstance(y, tuple) else (y,), dp, dxs

    return jit_op_by_op(run)(params, tuple(args[j] for j in arrays), cotangents)


def _forced(y: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``value`` forward, ``y``'s VJP backward (``y − y`` is an exact zero)."""
    return value + (y - y.detach())


def _port_vjp(path, args, cotangents, calls, modules, dtype):
    """The port's module ``path`` on ``args`` (as they are, or cast to
    ``dtype``), every product inside it forced to JAX's recorded output →
    (outputs, input cotangents, parameter gradients by name, the cotangent
    reaching each product inside it, by the product's name)."""
    module = modules[_name(path)]
    reached = {}
    with pytest.MonkeyPatch.context() as mp:
        for q, kind, _, _, _, out in calls:
            if len(q) > len(path) and q[:len(path)] == path and kind in PRODUCTS:
                sub = modules[_name(q)]

                def forward(*a, orig=sub.forward, out=out, key=_name(q)):
                    y = orig(*a)
                    y.register_hook(lambda g: reached.setdefault(key, g))
                    return _forced(y, _torch(out, y.dtype))

                mp.setattr(sub, "forward", forward)
        arrays = [j for j, a in enumerate(args) if isinstance(a, jax.Array)]
        xs = [_torch(args[j], dtype).requires_grad_() for j in arrays]
        full = list(args)
        for j, x in zip(arrays, xs):
            full[j] = x
        ys = module(*full)
        ys = ys if isinstance(ys, tuple) else (ys,)
        named = [(f"mask_decoder0.{_name(path)}.{n}".replace("..", "."), p)
                 for n, p in module.named_parameters()]
        grads = torch.autograd.grad(ys, xs + [p for _, p in named],
                                    [_torch(g, y.dtype) for g, y in zip(cotangents, ys)])
    return ([y.detach() for y in ys], list(grads[:len(xs)]),
            dict(zip((n for n, _ in named), grads[len(xs):])), reached)


def _product_bias(name, grads) -> bool:
    weight = name[:-len("bias")] + "weight"
    return name.endswith(".bias") and weight in grads and grads[weight].ndim > 1


def _groups(ys, dxs, grads, outs, dargs, want):
    """(group, port tensors, JAX tensors) of the outputs, the input
    cotangents and the weights' gradients (norm parameters and tokens among
    them); empty tensors left out."""
    weights = [n for n in sorted(grads) if not _product_bias(n, grads)]
    rows = [("out", ys, outs), ("dx", dxs, dargs),
            ("weights", [grads[n] for n in weights], [want[n] for n in weights])]
    return [(g, [a for a, b in zip(got, ref) if np.size(b)], [b for b in ref if np.size(b)])
            for g, got, ref in rows]


def _within_ulps(got, want, max_ulps, min_equal, f32_tol=1e-6) -> bool:
    """Every tensor within ``max_ulps`` bfloat16 ulps and ``min_equal``
    bit-equal, or within ``f32_tol`` relative where JAX's value is not
    bfloat16."""
    for g, w in zip(got, want):
        if _bf16_valued(w):
            ulps, equal = _agreement(g.float(), np.asarray(w, np.float32))
            if ulps > max_ulps or equal < min_equal:
                return False
        elif _rel(g.float().numpy(), w, w) > f32_tol:
            return False
    return True


@pytest.mark.parametrize("kind", KINDS)
def test_bfloat16_decoder_module_vjps_match_jax(decoder_calls, kind):
    """Every recorded call of one kind of module (see the module docstring
    for the measures)."""
    calls, port = decoder_calls
    rng = np.random.default_rng(KINDS.index(kind))
    held = jax_bias_misses = 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn, "LayerNorm", OnceRoundedLayerNorm)
        for i, (path, k, mod, params, args, out) in enumerate(calls):
            if k != kind:
                continue
            outs = out if isinstance(out, tuple) else (out,)
            gs = tuple(jnp.asarray(rng.standard_normal(o.shape).astype(np.float32), o.dtype)
                       for o in outs)
            _, dp, dargs = _jax_vjp(mod, params, args, gs)
            want = sam_state_dict_from_flax({"params": _nest(path, jax.device_get(dp))})
            if kind in SHARES:
                args32 = tuple(jnp.asarray(a, jnp.float32) if isinstance(a, jax.Array) else a
                               for a in args)
                y32, dp32, dargs32 = _jax_vjp(_f32(mod), params, args32,
                                              tuple(jnp.asarray(g, jnp.float32) for g in gs))
                want32 = sam_state_dict_from_flax({"params": _nest(path, jax.device_get(dp32))})
                ref32 = {g: w for g, _, w in _groups(y32, dargs32, want32, y32, dargs32, want32)}
            name = _name(path)
            passes = {}
            for dtype in (None, torch.float32):
                ys, dxs, grads, reached = _port_vjp(path, args, gs, calls[:i],
                                                    port[dtype or torch.bfloat16], dtype)
                assert set(grads) == set(want), (name, sorted(grads), sorted(want))
                ok = {}
                for group, got, ref in _groups(ys, dxs, grads, outs, dargs, want):
                    if kind in ULPS or group == "out":
                        ok[group] = _within_ulps(got, ref, *ULPS.get(kind, (1.0, 0.99)))
                    else:
                        w32 = _cat(ref32[group])
                        share = _rel(_cat(got), _cat(ref), w32) / _rel(_cat(ref), w32, w32)
                        ok[group] = share <= SHARES[kind][group]
                passes[dtype] = ok
                if dtype is None:
                    grads16, reached16 = grads, reached
            assert all(passes[None].values()), (name, passes[None])
            if kind not in NORMS:
                assert not all(passes[torch.float32].values()), (name, passes[torch.float32])
            grads, reached = grads16, reached16
            if kind in PRODUCTS:
                reached = {name: _torch(gs[0])}
                bias = torch.from_numpy(np.asarray(want[f"mask_decoder0.{name}.bias"]))
                ulps, equal = _agreement(bias, _once_rounded_sum(reached[name]))
                jax_bias_misses += ulps > 1.0 or equal < 0.99
            assert bool(reached) == (kind not in NORMS), name
            for key, g in reached.items():
                bias = grads[f"mask_decoder0.{key}.bias".replace("..", ".")]
                ulps, equal = _agreement(bias, _once_rounded_sum(g))
                assert ulps <= 1.0 and equal >= 0.99, (name, key, ulps, equal)
            held += 1
    assert held == CALLS[kind], held
    if kind in PRODUCTS:
        assert 2 * jax_bias_misses > held, (jax_bias_misses, held)
