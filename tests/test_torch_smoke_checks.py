"""The gradient check of ``chip_smoke.py`` phase 14, on the CPU.

Phase 14 holds a float32 training step through the kernels' autograd
Functions to the step through the plain versions with each call's value
pinned to the kernel's output (``plain_recurrences(pins=...)``), and each
kernel output to its plain version at the model's inputs
(``kernel_outputs``).  On CPU tensors the Functions run the plain
versions, so here the pinned step must equal the recorded step bit for
bit, a pin that moves an output must move the loss, a pin list that does
not match the calls must be refused, and every held share is 0.  Small
zamba2 (Mamba2 blocks and the shared flash block) and rwkv6 configs, TP 2
on a ``StackedAxis``.
"""
import dataclasses
import importlib.util
import pathlib

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import make_batch
from repro_torch.models.params import tree_paths
from repro_torch.train import Trainer

_ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               _ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def _step(arch):
    cfg = dataclasses.replace(get_config(arch), attn_impl="flash",
                              dtype="float32",
                              n_layers=7 if arch.startswith("zamba") else 2,
                              vocab_size=512, d_model=256)
    tr = Trainer(cfg, mesh=(1, 2), device="cpu")
    params, _ = tr.init(0)
    return tr, params, tr.put_batch(make_batch(cfg, 2, 64, 0))


@pytest.mark.parametrize("arch,calls", [("zamba2-1.2b", 8),
                                        ("rwkv6-3b", 2)])
def test_pinned_plain_step_equals_the_recorded_step(arch, calls):
    tr, params, batch = _step(arch)
    with cs.kernel_outputs() as rec:
        loss0, g0 = tr.grads(params, batch)
    assert len(rec.outputs) == len(rec.shares) == calls
    assert all(share == 0.0 for _, share in rec.shares)
    with cs.plain_recurrences(pins=rec.outputs) as pl:
        loss1, g1 = tr.grads(params, batch)
    assert pl.left == []
    assert float(loss1) == float(loss0)
    assert cs.grads_rel_err(torch, dict(tree_paths(g1)),
                            dict(tree_paths(g0))) == (0.0, "")


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-3b"])
def test_pins_set_the_values_and_must_match_the_calls(arch):
    tr, params, batch = _step(arch)
    with cs.kernel_outputs() as rec:
        loss0, _ = tr.grads(params, batch)
    moved = [o.roll(1, -1) for o in rec.outputs]   # each value elsewhere
    with cs.plain_recurrences(pins=moved):
        loss1, _ = tr.grads(params, batch)
    assert float(loss1) != float(loss0)
    with cs.plain_recurrences(pins=rec.outputs[:-1]):
        with pytest.raises(RuntimeError, match="more calls"):
            tr.grads(params, batch)
    with cs.plain_recurrences(pins=rec.outputs + rec.outputs[-1:]) as pl:
        tr.grads(params, batch)
    assert len(pl.left) == 1
