"""Import hygiene and device defaults of the torch port: ``repro_torch`` and
``chip_smoke.py`` load without JAX and without the JAX package, and the
entry points refuse to run on the CPU unless asked to."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import adapters
from repro_torch.core.hybrid import PersiaTrainer
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch.serve import serve

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any attempt to import jax raises
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m, mod in sys.modules.items() if mod is not None and
             (m == "repro" or m.startswith(("repro.", "jax"))))
print("LOADED", len([m for m in sys.modules if m.startswith("repro_torch")]))
print("BAD", bad)
print("HAS", sorted(m for m in sys.modules if m in {names!r}))
"""

# modules whose import must not need JAX (among all the walked ones): the
# pipelined trainer, the launchers, the click feedback, the LM data, the
# multi-process embedding PS and the mesh paths (the tier, the wire and
# checkpoints under a mesh among them)
_NAMED = ("repro_torch.core.backend", "repro_torch.core.hybrid",
          "repro_torch.checkpoint.ckpt", "repro_torch.core.pipeline", "repro_torch.launch.train",
          "repro_torch.launch.hostenv", "repro_torch.launch.online",
          "repro_torch.launch.cluster", "repro_torch.serving.feedback",
          "repro_torch.data.lm", "repro_torch.net", "repro_torch.net.wire",
          "repro_torch.net.rpc", "repro_torch.net.ps_server",
          "repro_torch.net.remote", "repro_torch.net.elastic",
          "repro_torch.sharding", "repro_torch.sharding.partition",
          "repro_torch.launch.mesh", "repro_torch.models.decode_dist",
          "repro_torch.core.theory", "repro_torch.models.tp",
          "repro_torch.launch.dryrun", "repro_torch.launch.op_cost",
          "repro_torch.launch.input_specs")


def test_port_and_chip_smoke_import_without_jax():
    code = _PROBE.format(src=str(ROOT / "src"), root=str(ROOT),
                         names=set(_NAMED))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert int(out.stdout.split("LOADED ")[1].split()[0]) >= 15
    assert f"HAS {sorted(_NAMED)}" in out.stdout, out.stdout


_PS_MAIN = r"""
import runpy, sys
sys.modules["jax"] = None            # any attempt to import jax raises
sys.path[:0] = [{src!r}]
sys.argv = ["ps_server", "--device", "cpu", "--port-file", {port_file!r}]
runpy.run_module("repro_torch.net.ps_server", run_name="__main__")
bad = sorted(m for m, mod in sys.modules.items() if mod is not None and
             (m == "repro" or m.startswith(("repro.", "jax"))))
print("BAD", bad)
"""


def test_ps_server_process_runs_without_jax(tmp_path):
    """``python -m repro_torch.net.ps_server --device cpu`` with JAX
    unimportable: it publishes its port, answers, and shuts down cleanly
    on the ``shutdown`` op, having loaded nothing of JAX or the JAX
    package."""
    from repro_torch.launch.cluster import wait_for_port_file
    from repro_torch.net.rpc import RpcClient
    port_file = str(tmp_path / "ps.port")
    code = _PS_MAIN.format(src=str(ROOT / "src"), port_file=port_file)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT),
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        port = wait_for_port_file(port_file, proc, timeout=120)
        c = RpcClient("127.0.0.1", port, timeout=10.0, retries=0)
        rep = c.call("ping")
        assert rep["pid"] == proc.pid and rep["device"] == "cpu"
        c.call("shutdown")
        c.close()
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    assert "BAD []" in out, out


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax\b|repro(\.|\s|$))")


def test_no_source_line_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{p.relative_to(ROOT)}:{i}: {line.strip()}"
            for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if _IMPORT.match(line)]
    assert not hits, hits


def test_default_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device()
    cfg = ModelConfig(name="d", arch_type="recsys", n_id_fields=1,
                      emb_dim=4, emb_rows=8, mlp_dims=(4,))
    with pytest.raises(RuntimeError, match="no GPU"):
        PersiaTrainer(adapters.recsys_adapter(cfg))
    with pytest.raises(RuntimeError, match="no GPU"):
        serve(get_config("granite_3_2b", reduced=True), 1, 2, 2)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_chip_smoke_without_gpu_fails_and_prints_no_result(monkeypatch,
                                                           capsys):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
