"""mia_tpu_torch — the PyTorch + CUDA port of ``mia_tpu``.

The package mirrors ``mia_tpu``'s layout (``ops/warp.py`` ↔ ``ops/warp.py``
and so on) and ports its ``al_train`` main path: round-based active learning
of the 2D UNet on FUGC. Public functions keep the JAX package's NHWC layout.
Every TPU kernel on that path is a hand-written Hopper kernel under
``csrc/``; the plain PyTorch version of each stays beside it for CPU tensors.

Importing this package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
