"""JAX references for the bfloat16 parity tests of the port.

flax's ``dtype=bfloat16`` writes a model as bfloat16 operations, each
rounding its result. XLA's CPU backend by default keeps float32 through a
fusion instead (``xla_allow_excess_precision``): a residual sum that feeds a
LayerNorm, the product inside GELU, are then never rounded. The references
here are compiled with that option off, so JAX rounds where its model code
says, as the port does.
"""

from __future__ import annotations

import jax

OP_BY_OP = {"xla_allow_excess_precision": False}


def jit_op_by_op(fn):
    """``jax.jit(fn)`` compiled without excess precision (one executable per
    argument structure, shapes and dtypes)."""
    compiled = {}

    def call(*args):
        key = (jax.tree.structure(args),
               tuple((a.shape, str(a.dtype)) for a in jax.tree.leaves(args)))
        if key not in compiled:
            compiled[key] = jax.jit(fn).lower(*args).compile(compiler_options=OP_BY_OP)
        return compiled[key](*args)

    return call


class OpByOpJax:
    """``jax`` with ``jit`` replaced by :func:`jit_op_by_op`: patched into a
    module of the JAX package, its jitted programs round op by op."""

    jit = staticmethod(lambda fn, **kwargs: jit_op_by_op(fn))

    def __getattr__(self, name):
        return getattr(jax, name)
