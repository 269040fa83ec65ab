"""The paper's own model family (Table 1): embedding bags + the
4096-2048-1024-512-256 FFNN. Sparse row counts follow Table 1; the three
trainable analogs scale rows by 1e-3 (full counts are used for the
capacity dry-runs where tables are never materialised)."""
from repro_torch.configs.base import ModelConfig


def _dlrm(name, rows, fields, width, dense, tasks=1, tau=3):
    return ModelConfig(
        name=name, arch_type="recsys", source="Persia KDD'22 Table 1",
        n_id_fields=fields, ids_per_field=width, emb_dim=128,
        emb_rows=rows, n_dense_features=dense,
        mlp_dims=(4096, 2048, 1024, 512, 256), n_tasks=tasks,
        emb_staleness=tau,
    )


TAOBAO = _dlrm("taobao-dlrm", 29_000, 8, 4, 8)
AVAZU = _dlrm("avazu-dlrm", 134_000, 16, 4, 4)
CRITEO = _dlrm("criteo-dlrm", 540_000, 26, 2, 13)
KWAI = _dlrm("kwai-dlrm", 2_000_000, 32, 8, 16, tasks=4)


def criteo_syn(trillions: float) -> ModelConfig:
    """Criteo-Syn_k capacity family: `trillions` x 1e12 params at dim 128."""
    rows = int(trillions * 1e12) // 128
    return _dlrm(f"criteo-syn-{trillions}t", rows, 26, 2, 13)
