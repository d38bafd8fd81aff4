"""Start-up hook that lets the JAX package import on jax 0.9 in every
process, subprocesses included, without editing it.

Python imports ``sitecustomize`` from ``sys.path`` at start-up, so
``PYTHONPATH=src`` (how the tests and their subprocesses run) puts this
one in place.  jax 0.9 broke two things the JAX package relies on:

* ``batching.primitive_batchers`` is a ``PrimitiveBatchersProxy`` with no
  ``__contains__``, and ``repro/_compat.py`` tests membership on it;
* ``jax.experimental.pallas.load`` is gone, and the interpret-mode ring
  tier (``repro/kernels/collective_matmul_rdma.py``) calls it.

``apply_jax_shims`` gives both back, each only where it is missing (so it
is idempotent and inert on a jax that has them).  The hook applies them
just before ``repro._compat`` is first imported: a process that never
imports the JAX package (the PyTorch port, on the card) never imports jax
because of this file.  A ``sitecustomize`` further down ``sys.path``
still runs.  The repo's root ``conftest.py`` loads this file by path and
installs the same hook in the pytest process itself.
"""
import importlib.abc
import importlib.machinery
import importlib.util
import os
import sys


def apply_jax_shims() -> None:
    from jax._src.interpreters import batching
    from jax.experimental import pallas

    proxy = getattr(batching, "PrimitiveBatchersProxy", None)
    if proxy is not None and "__contains__" not in vars(proxy):
        proxy.__contains__ = (
            lambda self, k: k in batching.fancy_primitive_batchers)
    if not hasattr(pallas, "load"):
        pallas.load = lambda ref, idx, **kw: ref[idx]


class _ShimsBeforeCompat(importlib.abc.MetaPathFinder):
    """Applies the shims when ``repro._compat`` is looked up, then lets
    the normal finders load it."""

    done = False

    def find_spec(self, name, path=None, target=None):
        if name == "repro._compat" and not self.done:
            self.done = True
            apply_jax_shims()
        return None


def _chain_next_sitecustomize() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    rest = [p for p in sys.path
            if os.path.abspath(p or os.curdir) != here]
    spec = importlib.machinery.PathFinder.find_spec("sitecustomize", rest)
    if spec is not None and spec.loader is not None:
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)


if __name__ == "sitecustomize":
    sys.meta_path.insert(0, _ShimsBeforeCompat())
    _chain_next_sitecustomize()
