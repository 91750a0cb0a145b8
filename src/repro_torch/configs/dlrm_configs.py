"""DLRM configs for the paper's own workloads (Table 3).

S1: WDL [12] on Criteo-Kaggle-shaped data, S2: DFM [24] on Avazu-shaped,
S3: DCN [66] on Criteo-Sponsored-shaped.  Embedding size defaults to the
paper's 512.  These are `family="dlrm"`: the model is embedding tables +
feature interaction + MLP, and ESD drives their sparse input path.
"""
from __future__ import annotations

import dataclasses

__all__ = ["DLRMConfig", "DLRM_CONFIGS"]


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str
    kind: str                     # wdl | dfm | dcn
    workload: str                 # synthetic workload key (data/synthetic.py)
    embedding_dim: int = 512      # paper default
    n_dense: int = 13
    mlp_dims: tuple[int, ...] = (1024, 512, 256)
    cross_layers: int = 3         # dcn only
    family: str = "dlrm"

    @property
    def source(self) -> str:
        return {"wdl": "WDL [12] / Criteo Kaggle [1]",
                "dfm": "DeepFM [24] / Avazu [2]",
                "dcn": "DCN [66] / Criteo Sponsored Search [61]"}[self.kind]


DLRM_CONFIGS = {
    "wdl-s1": DLRMConfig("wdl-s1", "wdl", "S1"),
    "dfm-s2": DLRMConfig("dfm-s2", "dfm", "S2"),
    "dcn-s3": DLRMConfig("dcn-s3", "dcn", "S3"),
    "wdl-tiny": DLRMConfig("wdl-tiny", "wdl", "tiny", embedding_dim=16,
                           mlp_dims=(64, 32)),
    "dfm-tiny": DLRMConfig("dfm-tiny", "dfm", "tiny", embedding_dim=16,
                           mlp_dims=(64, 32)),
    "dcn-tiny": DLRMConfig("dcn-tiny", "dcn", "tiny", embedding_dim=16,
                           mlp_dims=(64, 32), cross_layers=2),
}
