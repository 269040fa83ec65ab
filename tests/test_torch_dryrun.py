"""The port's dry run (``launch/dryrun.py``, ``launch/input_specs.py``,
``launch/op_cost.py``) against the JAX package's.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices on import
(its first lines), which would change every later JAX test of a pytest
worker that has not started JAX yet: it is imported only in a subprocess
(``JAX_DRY``), which prints its numbers as JSON. ``repro.launch.
input_specs`` imports no such flag and runs here.

Checked: ``input_specs`` names, shapes and dtypes for every architecture
and input shape; ``active_params`` and ``model_flops`` equal to JAX's;
``_batch_specs`` and ``_cache_specs_guarded`` equal to JAX's on the
production mesh at batch and sequence sizes that do not divide over it;
``op_cost`` on small known functions (a matmul counts 2*M*N*K, a view no
bytes, an all-reduce twice its bytes, a kernel wrapper one kernel of its
formula on the CPU and on meta); and ``python -m repro_torch.launch.dryrun
--arch granite_3_2b`` with every row ``ok`` on the 16 x 16 mesh.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import input_specs as JIS

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as DR
from repro_torch.launch import input_specs as IS
from repro_torch.launch import op_cost
from repro_torch.utils import MeshLayout, _collective

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
# the uneven sizes of the spec checks: rows and positions that do not
# divide over 16 ranks
UNEVEN = (("granite_3_2b", 6, 40), ("granite_3_2b", 32, 4096),
          ("deepseek_v2_lite_16b", 24, 1000), ("jamba_v0_1_52b", 8, 48),
          ("whisper_medium", 1, 64), ("llama_3_2_vision_90b", 48, 100))

JAX_DRY = textwrap.dedent("""
    import json, sys
    import jax
    from repro.launch import dryrun as D
    from repro.configs import ARCH_IDS, INPUT_SHAPES, get_config
    from repro.launch import input_specs as IS
    from repro.launch.mesh import make_production_mesh
    from repro.models import transformer as T

    def spec(p):
        return [list(e) if isinstance(e, tuple) else e for e in p]
    out = {"flops": {}, "caches": [], "batches": []}
    for a in ARCH_IDS:
        cfg = get_config(a)
        out["flops"][a] = {s: [D.active_params(cfg),
                               D.model_flops(cfg, sh)]
                           for s, sh in INPUT_SHAPES.items()}
    mesh = make_production_mesh()
    for a, b, s in %(uneven)r:
        cfg = get_config(a)
        caches = jax.eval_shape(lambda: T.cache_init(
            cfg, b, s, jax.numpy.float32, memory_len=IS.memory_len(cfg)))
        sp = D._cache_specs_guarded(caches, cfg, mesh)
        out["caches"].append(jax.tree.map(
            spec, sp, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec)))
        shape = D.INPUT_SHAPES["train_4k"]
        batch = {"tokens": jax.ShapeDtypeStruct((b, s), "int32"),
                 "mask": jax.ShapeDtypeStruct((b, s), "float32")}
        bs = D._batch_specs(batch, mesh)
        out["batches"].append({k: spec(v) for k, v in bs.items()})
    print("JAXDRY" + json.dumps(out))
""") % {"uneven": UNEVEN}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC),
                                         env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def jax_dry():
    out = subprocess.run([sys.executable, "-c", JAX_DRY], env=_env(),
                         capture_output=True, text=True, timeout=600)
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("JAXDRY")]
    assert line, out.stdout[-3000:] + out.stderr[-3000:]
    return json.loads(line[0][6:])


_DTYPES = {jnp.int32: torch.int32, jnp.float32: torch.float32}


def _same(port: dict, jax_: dict):
    assert set(port) == set(jax_)
    for k, v in jax_.items():
        assert tuple(port[k].shape) == tuple(v.shape), k
        assert port[k].dtype == _DTYPES[np.dtype(v.dtype).type], k


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_input_specs_match_jax(shape):
    """The names, shapes and dtypes of every architecture's inputs at
    ``shape`` (the compute dtype fp32 on both sides); the token ids are
    real int32 on the CPU, the others on the meta device."""
    assert ARCH_IDS == JARCH_IDS
    sh, jsh = INPUT_SHAPES[shape], JSHAPES[shape]
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        if sh.kind == "decode":
            got, want = IS.decode_inputs(cfg, sh), JIS.decode_inputs(jcfg,
                                                                      jsh)
        elif sh.kind == "prefill":
            got = IS.prefill_inputs(cfg, sh, torch.float32)
            want = JIS.prefill_inputs(jcfg, jsh, jnp.float32)
        else:
            got = IS.train_inputs(cfg, sh, torch.float32)
            want = JIS.train_inputs(jcfg, jsh, jnp.float32)
        _same(got, want)
        assert got["tokens"].device.type == "cpu"
        assert int(got["tokens"].max()) < cfg.vocab_size
        assert all(v.device.type == "meta" for k, v in got.items()
                   if k != "tokens")
        assert IS.memory_len(cfg) == JIS.memory_len(jcfg)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_and_model_flops_match_jax(jax_dry, arch):
    cfg = get_config(arch)
    for shape, (active, mf) in jax_dry["flops"][arch].items():
        assert DR.active_params(cfg) == active
        assert DR.model_flops(cfg, INPUT_SHAPES[shape]) == mf


def _plain(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.mark.parametrize("case", range(len(UNEVEN)))
def test_cache_and_batch_specs_match_jax(jax_dry, case):
    """``_cache_specs_guarded`` and ``_batch_specs`` against JAX's on the
    production mesh, at batch rows and positions that do not divide over
    its 16 x 16 ranks."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding.partition import _zip_map
    arch, b, s = UNEVEN[case]
    cfg = get_config(arch)
    mesh = MeshLayout((16, 16), ("data", "model"))
    caches = T.cache_init(cfg, b, s, torch.float32, torch.device("meta"),
                          memory_len=IS.memory_len(cfg))
    got = _zip_map(lambda sp, _: _plain(sp),
                   DR._cache_specs_guarded(caches, cfg, mesh), caches)
    want = jax_dry["caches"][case]

    def norm(t):                  # trailing Nones are the same spec
        if isinstance(t, dict):
            return {k: norm(v) for k, v in t.items()}
        t = list(t)
        while t and t[-1] is None:
            t.pop()
        return t
    assert norm(got) == norm(want)
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32),
             "mask": torch.empty((b, s))}
    bs = {k: _plain(v) for k, v in DR._batch_specs(batch, mesh).items()}
    assert norm(bs) == norm(jax_dry["batches"][case])


def test_op_cost_counts_known_functions():
    """A matmul counts 2*M*N*K FLOPs and its operands' and result's bytes;
    a view no bytes; an all-reduce twice its result's bytes, an
    all-gather once; a kernel wrapper one kernel of its formula (its
    plain version's ops uncounted), alike on the CPU and on meta."""
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    _, c = op_cost.analyze(lambda: a @ b)
    assert c["flops"] == 2 * 8 * 4 * 16
    assert c["hbm_bytes"] == (8 * 16 + 16 * 4 + 8 * 4) * 4
    x = torch.randn(3, 5, 7)
    _, c = op_cost.analyze(lambda: x.view(15, 7).t().permute(1, 0)[2:])
    assert c["hbm_bytes"] == 0 and c["flops"] == 0
    _, c = op_cost.analyze(lambda: torch.bmm(x, torch.randn(3, 7, 2)))
    assert c["flops"] == 2 * 3 * 5 * 2 * 7
    y = torch.zeros(10)
    _, c = op_cost.analyze(lambda: (_collective("all-reduce", lambda: None,
                                                y),
                                    _collective("all-gather", lambda: None,
                                                y)))
    assert c["all-reduce"] == 80 and c["all-gather"] == 40
    assert c["collective_total"] == 120
    assert c["counts"] == {"all-gather": 1, "all-reduce": 1}
    q, k, v = (torch.randn(2, 4, 9, 8), torch.randn(2, 2, 9, 8),
               torch.randn(2, 2, 9, 8))
    costs = []
    for dev in ("cpu", "meta"):
        args = [t.to(dev) for t in (q, k, v)]
        (o, lse), c = op_cost.analyze(ops.flash_attention_fwd, *args, 0.3,
                                      True)
        assert o.device.type == dev and o.shape == (2, 4, 9, 8)
        assert lse.shape == (2, 4, 9)
        costs.append(c)
    flops, nbytes = ops.flash_cost(q, k, v, True, 0, 0)
    assert flops == 2.0 * 2 * 4 * 16 * (9 * 10 // 2)
    for c in costs:
        assert c["kernels"] == {"flash_attention_fwd": 1}
        assert c["flops"] == flops and c["hbm_bytes"] == nbytes


def test_dry_run_small_case_on_a_fake_mesh():
    """A train, prefill and decode row of reduced granite at mesh (2, 4)
    in a subprocess: every key of a JAX row (``trace_s`` for the lowering
    and compile times), the H100's constants, the kernels counted."""
    code = textwrap.dedent("""
        import json
        from repro_torch.configs import get_config
        from repro_torch.configs.base import InputShape
        from repro_torch.launch import dryrun as DR
        cfg = get_config("granite_3_2b", reduced=True)
        rows = [DR.run_case("granite_3_2b", n, cfg=cfg,
                            shape=InputShape(n, 64, 4, k),
                            mesh_shape=((2, 4), ("data", "model")),
                            verbose=False)
                for n, k in (("t", "training"), ("p", "prefill"),
                             ("d", "decode"))]
        print("ROWS" + json.dumps(rows))
    """)
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("ROWS")]
    assert line, out.stdout[-3000:] + out.stderr[-3000:]
    keys = {"arch", "shape", "mesh", "note", "status", "trace_s",
            "argument_bytes_per_device", "temp_bytes_per_device",
            "peak_bytes_per_device", "flops_per_device",
            "hbm_bytes_per_device", "collectives", "compute_s", "memory_s",
            "collective_s", "dominant", "model_flops", "useful_flops_frac",
            "dtype", "hardware"}
    for row in json.loads(line[0][4:]):
        assert row["status"] == "ok", row.get("error")
        assert keys <= set(row)
        assert row["hardware"]["peak_flops_fp32"] == 67e12
        assert row["hardware"]["hbm_bytes_per_s"] == 3.35e12
        assert row["dtype"] == "float32" and row["mesh"] == "2x4"
        if row["shape"] != "d":        # the decode attention is plain
            assert row["kernels"]["flash_attention_fwd"] > 0
        assert row["flops_per_device"] > 0 and row["collectives"]["total"] > 0


def test_dry_run_at_zero_stage_2_on_a_fake_mesh():
    """The train row of reduced granite at mesh (2, 4) at ZeRO stages 3
    and 2 (``partition.zero_stage``; ``REPRO_ZERO_STAGE`` for the CLI): stage 2
    holds the tensor-parallel weights whole over ``data`` (more argument
    bytes) and all-gathers fewer times (one gather a leaf after the
    update, none a layer), and the stage is restored after the row.
    ``tests/test_torch_lm_mesh.py`` holds the stage-2 row to the CPU
    world's own count."""
    code = textwrap.dedent("""
        import json
        from repro_torch.configs import get_config
        from repro_torch.configs.base import InputShape
        from repro_torch.launch import dryrun as DR
        from repro_torch.sharding import partition as SP
        cfg = get_config("granite_3_2b", reduced=True)
        rows = {}
        for s in (3, 2):
            with SP.zero_stage(s):
                rows[s] = DR.run_case(
                    "granite_3_2b", "t", cfg=cfg,
                    shape=InputShape("t", 64, 4, "training"),
                    mesh_shape=((2, 4), ("data", "model")), verbose=False)
        rows["after"] = SP.ZERO_STAGE
        print("ROWS" + json.dumps(rows))
    """)
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("ROWS")]
    assert line, out.stdout[-3000:] + out.stderr[-3000:]
    rows = json.loads(line[0][4:])
    z3, z2 = rows["3"], rows["2"]
    assert rows["after"] == 3
    for s, r in ((3, z3), (2, z2)):
        assert r["status"] == "ok", r.get("error")
        assert r["zero_stage"] == s
    c3, c2 = z3["collectives"]["counts"], z2["collectives"]["counts"]
    assert c2["all-gather"] < c3["all-gather"]
    assert c2["reduce-scatter"] > 0
    assert z2["argument_bytes_per_device"] > z3["argument_bytes_per_device"]
    assert z2["kernels"] == z3["kernels"]


def test_dry_run_cli_granite_on_the_production_mesh(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch granite_3_2b --out f``:
    one row per input shape on the 16 x 16 mesh, every one ``ok`` (the
    long_500k row the sliding-window variant)."""
    out = tmp_path / "rows.json"
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--arch", "granite_3_2b", "--out", str(out)],
                         env=_env(), capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    rows = json.loads(out.read_text())
    assert [r["shape"] for r in rows] == list(INPUT_SHAPES)
    for r in rows:
        assert r["status"] == "ok", r.get("error")
        assert r["mesh"] == "16x16"
        assert r["argument_bytes_per_device"] > 0
    assert rows[-1]["note"] == "sliding-window 4096 variant"
    assert "4 ok / 0 skipped / 0 failed" in run.stdout
