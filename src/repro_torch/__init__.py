"""PyTorch / CUDA port of the Deep Potential MD package ``repro``.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``core/``, ``kernels/``, ``md/``) so each counterpart is easy to find.
It imports ``torch`` and never ``jax`` or ``repro``. Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``.
"""
