"""The port stands alone: no file under ``src/repro_torch/`` and not
``chip_smoke.py`` imports JAX or the JAX package, ``import repro_torch``
works with JAX blocked, and an entry point given no device on a machine
without CUDA raises instead of running on the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_repro():
    files = _port_files()
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & set(FORBIDDEN))
           for f in files}
    bad = {k: v for k, v in bad.items() if v}
    assert not bad, f"port files import {bad}"


def test_import_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch, repro_torch.serve, repro_torch.launch.serve\n"
        "import repro_torch.bridge, repro_torch.kernels.ops\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in "
        "sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_without_device_raise_on_cpu_only_machine(monkeypatch):
    """With no device given and no CUDA present the port raises; it never
    falls back to the CPU on its own."""
    from repro_torch import resolve_device
    from repro_torch.configs import ARCHS
    from repro_torch.models import lm
    from repro_torch.serve.backend import SingleDeviceBackend
    from repro_torch.serve.scheduler import SchedulerConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ARCHS["granite-3-8b"].scaled_down(layers=1, width=32, vocab=64)
    cfg = SchedulerConfig(max_slots=1, page_size=8, max_seq=16, num_pages=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init(0, spec)
    params = lm.init(0, spec, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        SingleDeviceBackend(params, spec, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_paged_cache(spec, 1, 16, lm.PagedLayout(num_pages=4, page_size=8))
    assert resolve_device("cpu").type == "cpu"
