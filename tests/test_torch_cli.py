"""The port's tuning CLI and example workflows on the CPU.

* ``examples/torch_tune_collectives.py`` (the PGMPITuneCLI workflow)
  against the JAX package's ``examples/tune_collectives.py``: on each of
  the three cost-model presets at ``--axis-size 16``, the printed summary
  and violation lines and every written Listing-1 profile file are equal
  byte for byte (the last line names the output directory, which differs);
  ``--backend measured`` builds ``tuner.MeasuredBackend`` at the given
  axis size on the given device;
* ``examples/torch_quickstart.py`` and ``examples/torch_train_tuned_lm.py``
  run on the CPU (stacked meshes, so their footers list real
  dispatches), and the training example resumes from its checkpoint.
"""
import contextlib
import importlib.util
import io
import pathlib
import sys

import pytest

import test_torch_ref  # noqa: F401  (the reference's import shims)

from repro.core import costmodel as rcostmodel
from repro_torch.ckpt import checkpoint as tck
from repro_torch.core import costmodel, tuner

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv, *, set_argv=False) -> str:
    """stdout of ``main(argv)`` (the JAX example reads ``sys.argv``)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if set_argv:
            old, sys.argv = sys.argv, ["tune_collectives.py"] + argv
            try:
                main()
            finally:
                sys.argv = old
        else:
            assert main(argv) == 0
    return buf.getvalue()


def test_presets_match_the_reference():
    assert sorted(costmodel.PRESETS) == sorted(rcostmodel.PRESETS)
    for name, topo in costmodel.PRESETS.items():
        ref = rcostmodel.PRESETS[name]
        assert topo.name == name
        for f in ("alpha", "link_bw", "gamma", "default_pricing",
                  "hw_bcast"):
            assert getattr(topo, f) == getattr(ref, f), (name, f)


@pytest.mark.parametrize("topo", ["v5e-ici", "v5e-dcn", "bgq-like"])
def test_tune_cli_equals_the_reference_byte_for_byte(tmp_path, topo):
    port, ref = _load("torch_tune_collectives"), _load("tune_collectives")
    argv = ["--topo", topo, "--axis-size", "16"]
    got = _run(port.main, argv + ["--out", str(tmp_path / "port")])
    want = _run(ref.main, argv + ["--out", str(tmp_path / "ref")],
                set_argv=True)
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert got_lines[:-1] == want_lines[:-1]
    assert "violations:" in got_lines and len(got_lines) > 10
    assert got_lines[-1].replace("port", "ref") == want_lines[-1]
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert files
    for f in files:
        assert ((tmp_path / "port" / f).read_bytes()
                == (tmp_path / "ref" / f).read_bytes()), f


def test_tune_cli_measured_backend_runs_at_the_axis_size(tmp_path,
                                                        monkeypatch):
    """``--backend measured`` measures on ``--axis-size`` stacked lanes of
    ``--device`` (the JAX example takes the host's device count); a
    stand-in backend records what the CLI built and prices every impl
    alike, so nothing is picked."""
    built = []

    class Stub:
        name = "measured"

        def __init__(self, p, device=None):
            built.append((p, device))
            self.supported_axis_size = p

        def latency(self, cell, impl_name):
            return 1e-6

        def nrep_for(self, cell, impl_name):
            return 1

    monkeypatch.setattr(tuner, "MeasuredBackend", Stub)
    cli = _load("torch_tune_collectives")
    out = _run(cli.main, ["--backend", "measured", "--axis-size", "6",
                          "--device", "cpu", "--out", str(tmp_path)])
    assert built == [(6, "cpu")]
    assert "pattern violations: 0" in out
    assert "wrote 0 profiles" in out


def test_quickstart_runs_on_a_stacked_mesh(tmp_path):
    qs = _load("torch_quickstart")
    out = _run(qs.main, ["--device", "cpu", "--out", str(tmp_path / "p")])
    assert "== tuning report ==" in out and "profiles reloaded" in out
    assert "step  15 loss" in out
    footer = out.split("which algorithm served each call) ==")[1]
    lines = [ln for ln in footer.splitlines() if ln.startswith("#@pgmpi")]
    assert lines and any(not ln.endswith(" default") for ln in lines)
    assert any((tmp_path / "p").iterdir())


def test_train_tuned_lm_runs_then_resumes(tmp_path):
    ex = _load("torch_train_tuned_lm")
    base = ["--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "3", "--seq", "16"]
    out = _run(ex.main, base + ["--steps", "4"])
    assert "step    0 loss" in out and "done: 4 steps" in out
    assert "#@pgmpi alg MPI_Allreduce" in out
    assert tck.latest_step(tmp_path / "ck") == 3
    out = _run(ex.main, base + ["--steps", "5", "--force",
                                "allreduce:alg=allreduce_as_rsb_allgather"])
    assert "resumed from step 3" in out and "done: 2 steps" in out
    assert "allreduce_as_rsb_allgather" in out
