"""PyTorch port of the tuned-collectives library (PGMPITuneLib).

Same subpackage layout as the JAX package ``repro``: ``core`` holds the
tuning loop (cells, mock-up catalog, guidelines, profiles, dispatcher,
traces, measurement, cost model, tuner, selfcheck), ``kernels`` the
hand-written Hopper kernels with their plain PyTorch versions,
``models``/``configs`` the model stack and the architectures, ``dist``
the model-parallel ops over the dispatcher, and ``launch`` the serving
entry points.

Ranks are stacked on one device (``core._axis.StackedAxis``): a per-rank
``[n, ...]`` operand is a ``[p, n, ...]`` tensor and a ring hop is a
device-memory copy.  Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
