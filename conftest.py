"""Root conftest: the JAX package's test files import under jax 0.9.

``src/sitecustomize.py`` holds the two jax 0.9 shims (the membership test
of ``PrimitiveBatchersProxy`` and ``pallas.load``) and the import hook that
applies them just before ``repro._compat`` first loads; it installs the
hook in every process that starts with ``PYTHONPATH=src``.  This file
installs the same hook in the pytest process itself, whatever its start-up
path, before any test module imports the JAX package, so every file
collects in every worker.  A pytest process that never imports the JAX
package (the port's card tests) never imports jax because of it.
"""
import importlib.util
import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

_spec = importlib.util.spec_from_file_location(
    "_repro_jax_shims",
    pathlib.Path(__file__).resolve().parent / "src" / "sitecustomize.py")
_shims = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_shims)
sys.meta_path.insert(0, _shims._ShimsBeforeCompat())
