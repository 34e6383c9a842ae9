"""CPU smoke of the port's launcher: the paged engine end to end on a
scaled-down model, in a subprocess like a user would run it."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(*args, timeout=240):
    # one OpenMP thread: the launcher's tiny model runs in ~5 s either
    # way, but with a thread per core it spin-waits against the other
    # test processes of a parallel run and takes minutes
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        env=env, capture_output=True, text=True, timeout=timeout, cwd=ROOT)


def test_paged_launch_int4_weights_int8_pages_on_cpu():
    out = _run("--engine", "paged", "--local", "--device", "cpu",
               "--precision", "int4", "--cache-dtype", "int8")
    assert out.returncode == 0, out.stderr
    assert "weights quantized to int4" in out.stdout
    assert "4 requests, 128 tokens" in out.stdout
    assert "tok/s" in out.stdout


def test_spec_launch_on_cpu():
    """``--spec-k 2``: the verify-window engine end to end, with the JAX
    launcher's spec-decode stats line and the counts in the result."""
    from repro_torch.launch import serve
    res = serve.main(["--engine", "paged", "--local", "--device", "cpu",
                      "--spec-k", "2", "--steps", "24", "--layers", "2",
                      "--width", "64", "--vocab", "128"])
    assert res["tokens"] == 4 * 24
    assert res["spec_steps"] > 0 and res["spec_accepted"] > 0
    assert res["spec_drafted"] == res["spec_steps"]          # K-1 = 1 each
    out = _run("--engine", "paged", "--local", "--device", "cpu",
               "--spec-k", "2")
    assert out.returncode == 0, out.stderr
    assert "spec_k=2" in out.stdout
    assert "[serve] spec decode:" in out.stdout
    assert "tokens/iteration" in out.stdout


def test_static_launch_on_cpu():
    """``--engine static`` (the default, as in the JAX launcher): the
    static ``generate`` engine end to end, int4 weights; the result
    carries the prompts and the greedy tokens."""
    from repro_torch.launch import serve
    res = serve.main(["--local", "--device", "cpu", "--precision", "int4",
                      "--layers", "2", "--width", "64", "--vocab", "128",
                      "--batch", "3", "--prompt-len", "12", "--steps", "5"])
    assert res["prompts"].shape == (3, 12) and res["tokens"].shape == (3, 6)
    out = _run("--local", "--device", "cpu", "--precision", "int8")
    assert out.returncode == 0, out.stderr
    assert "static engine on cpu (int8 weights): generated 4x32 tokens" in out.stdout


def test_ring_launch_on_cpu():
    """``--sliding-window`` on Gemma3 cut to its local layers reaches the
    ring tables, as the JAX launcher does; at 6 layers (one global) the
    stack stays on flat tables."""
    args = ["--engine", "paged", "--arch", "gemma3-1b", "--local", "--device",
            "cpu", "--width", "64", "--vocab", "128", "--sliding-window", "16",
            "--precision", "int4", "--cache-dtype", "int8", "--prompt-len", "40",
            "--steps", "24"]
    out = _run(*args, "--layers", "2")
    assert out.returncode == 0, out.stderr
    assert "[serve] sliding window 16: ring tables 2 pages/slot" in out.stdout
    out = _run(*args, "--layers", "6")
    assert out.returncode == 0, out.stderr
    assert "ring tables" not in out.stdout and "4 requests" in out.stdout


def test_launch_refuses_unported_options(capsys):
    from repro_torch.launch import serve
    for extra in (["--devices", "2"], ["--dp", "2"]):
        with pytest.raises(SystemExit) as exc:
            serve.main(["--local", "--device", "cpu", *extra])
        assert exc.value.code != 0
        assert "not ported yet" in capsys.readouterr().err, extra
