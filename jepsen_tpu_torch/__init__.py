"""jepsen_tpu_torch — the PyTorch/CUDA port of jepsen_tpu's analysis plane.

The JAX package :mod:`jepsen_tpu` stays the reference; this package sits
beside it, imports ``torch`` and numpy and never ``jax`` or anything of
``jepsen_tpu`` (it carries its own copies of the pure-Python modules it
needs).  Module names mirror the reference, so ``jepsen_tpu/ops/dense.py``
is ported by ``jepsen_tpu_torch/ops/dense.py`` and so on.

Entry points (:func:`jepsen_tpu_torch.ops.wgl.check_batch`) run on the
CUDA device unless the caller passes ``device="cpu"``; with no device
argument and no CUDA present they raise (:mod:`.device`).  On the card
the dense subset automaton, the frontier search and the Elle closure
screens (:func:`jepsen_tpu_torch.elle.check_batch`) run as hand-written
CUDA kernels (``ops/csrc/``); on the CPU the same functions run as their
plain PyTorch versions.
"""
