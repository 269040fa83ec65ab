"""The small CTR trainer of the cluster and online launchers (port of
``repro/launch/cluster.py``).

The JAX package's cluster spawns one trainer and k embedding-PS processes
and trains over its RPC wire. The port has no PS process yet
(``ROADMAP.md``, Queue 1: the multi-process PS): ``spawn_ps``,
``run_cluster`` and ``main`` raise. What the in-process online loop needs
is here: :func:`small_ctr_trainer`, and :func:`wait_for_port_file`, the
poll a launcher makes for a server's published port.
"""
from __future__ import annotations

import subprocess
import time

from repro_torch.configs.base import ModelConfig
from repro_torch.core import adapters
from repro_torch.core.hybrid import PersiaTrainer, TrainMode
from repro_torch.data.ctr import CTRDataset
from repro_torch.launch.shards import apply_backend_choice
from repro_torch.optim.optimizers import OptConfig

_NO_PS = ("embedding-PS processes are not ported yet (ROADMAP.md, Queue 1: "
          "the multi-process PS)")


def wait_for_port_file(port_file: str, proc: subprocess.Popen,
                       timeout: float = 30.0) -> int:
    """Poll for the server's atomically-written port file; fails fast if
    the process died before publishing."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"ps_server exited with {proc.returncode} before "
                f"publishing {port_file}")
        try:
            with open(port_file) as f:
                text = f.read().strip()
            if text:
                return int(text)
        except (OSError, ValueError):
            pass
        time.sleep(0.05)
    raise TimeoutError(f"no port published at {port_file} "
                       f"within {timeout:.0f}s")


def spawn_ps(*args, **kwargs):
    """Launch one PS shard process: raises until the PS is ported."""
    raise NotImplementedError(_NO_PS)


def small_ctr_trainer(mode: str = "hybrid", backend: str = "host_lru",
                      tau: int = 2, fields: int = 2,
                      rows_per_field: int = 64, dim: int = 8,
                      cache_rows: int = 48, seed: int = 0,
                      device: str = "cuda"):
    """A small CTR trainer + batch stream (the tests' model, sized so a
    run finishes in seconds on the CPU), on ``device``."""
    cfg = ModelConfig(name="cluster", arch_type="recsys",
                      n_id_fields=fields, ids_per_field=3,
                      emb_dim=dim, emb_rows=fields * rows_per_field,
                      n_dense_features=4, mlp_dims=(16,), n_tasks=1)
    ds = CTRDataset("cluster", n_rows=fields * rows_per_field,
                    n_fields=fields, ids_per_field=3, n_dense=4)
    coll = adapters.ctr_collection(cfg, lr=5e-2, field_rows=ds.field_rows())
    coll = apply_backend_choice(coll, backend, cache_rows)
    ad = adapters.recsys_adapter(cfg, field_rows=ds.field_rows(),
                                 collection=coll)
    tm = {"sync": TrainMode.sync(), "hybrid": TrainMode.hybrid(tau),
          "async": TrainMode.async_(tau, tau)}[mode]
    trainer = PersiaTrainer(ad, tm, OptConfig(kind="adam", lr=5e-3),
                            device=device)
    return trainer, ds


def run_cluster(*args, **kwargs) -> dict:
    """Train over k PS processes: raises until the PS is ported."""
    raise NotImplementedError(_NO_PS)


def main(argv=None):
    raise NotImplementedError(_NO_PS)


if __name__ == "__main__":
    main()
