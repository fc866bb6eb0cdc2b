"""The port's example programs (blama_tpu_torch/examples/) end to end on the
CPU (`--device cpu`), as tests/test_examples.py runs the reference's: each
on the tiny synthetic fixture, with the reference's printed markers."""

import io
import runpy
import sys

import pytest
import torch

torch.set_num_threads(1)   # tiny shapes: threads only contend with the other test workers


def _run(example, monkeypatch, argv=("--device", "cpu")):
    monkeypatch.setattr(sys, "argv", [f"{example}.py", *argv])
    runpy.run_module(f"blama_tpu_torch.examples.{example}", run_name="__main__")


@pytest.mark.parametrize("example", ["e_verify", "e_server_cli", "e_basic"])
def test_example_runs(example, monkeypatch, capsys):
    _run(example, monkeypatch)
    out = capsys.readouterr().out
    if example == "e_verify":
        assert "ACCEPT" in out
        assert "aggregate verification score: 1.000000" in out   # same backend: exact
    elif example == "e_server_cli":
        assert "completion:" in out
    else:
        assert "tiny synthetic fixture" in out


def test_example_verified_chat(monkeypatch, capsys):
    """One interactive turn through stdin; the same-backend replay trusts it."""
    monkeypatch.setattr(sys, "stdin", io.StringIO("hello there\n"))
    _run("e_verified_chat", monkeypatch)
    out = capsys.readouterr().out
    assert "verification score: 1.0000 — trusted" in out, out[-400:]


def test_examples_take_blama_device(monkeypatch, capsys):
    """BLAMA_DEVICE=cpu does what `--device cpu` does, as for the server."""
    monkeypatch.setenv("BLAMA_DEVICE", "cpu")
    _run("e_verify", monkeypatch, argv=())
    assert "ACCEPT" in capsys.readouterr().out


def test_examples_want_the_card_by_default(monkeypatch):
    """Without a device argument the examples run on the card: here, with
    none, Model raises rather than fall back to the CPU."""
    monkeypatch.delenv("BLAMA_DEVICE", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run("e_verify", monkeypatch, argv=())
