"""repro_torch: the PyTorch/CUDA port of the Hyena Hierarchy reproduction.

It sits beside the JAX package ``repro`` (the reference) and mirrors its
module layout, so each module here has a counterpart of the same name
there.  It imports ``torch`` and never ``jax``, and nothing of ``repro``.

Entry points take ``device=`` and default to ``"cuda"``; they raise when
CUDA is missing unless the caller asks for ``"cpu"`` (as the tests do).
"""

__version__ = "0.1.0"
