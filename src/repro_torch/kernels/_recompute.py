"""The backward shared by the kernels' ``torch.autograd.Function``s.

The Hopper kernels, like their TPU originals, compute the forward only.
Training differentiates the plain version instead, as the JAX package
differentiates its jnp counterparts (``_flash_jnp``, ``_wkv_scan``,
``_ssd_chunked``): the backward recomputes the output from the saved
inputs through the plain version under autograd and returns its
gradients.  No intermediate of the forward outlives it.
"""
from __future__ import annotations

import torch


def grads_through(plain, saved, needs, g, **kw) -> list:
    """The gradients of ``plain(*saved, **kw)`` against cotangent ``g`` for
    each input whose ``needs`` flag is set, None for the others."""
    ins = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
    with torch.enable_grad():
        out = plain(*ins, **kw)
    want = [t for t in ins if t.requires_grad]
    got = iter(torch.autograd.grad(out, want, g) if want else ())
    return [next(got) if t.requires_grad else None for t in ins]
