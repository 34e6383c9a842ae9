"""CPU smoke of the port's launcher: the paged engine end to end on a
scaled-down model, in a subprocess like a user would run it."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
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


def test_launch_refuses_unported_options(capsys):
    from repro_torch.launch import serve
    for extra in (["--spec-k", "2"], ["--devices", "2"], ["--dp", "2"],
                  ["--engine", "static"]):
        with pytest.raises(SystemExit) as exc:
            serve.main(["--local", "--device", "cpu", *extra])
        assert exc.value.code != 0
        assert "not ported yet" in capsys.readouterr().err, extra
