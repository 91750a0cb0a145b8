"""Multi-parameter-server addressing: V-space partition + translations.

``PsPartition`` maps global embedding ids to ``(ps_shard, local_row)``
addresses (and to the PS-linearized space the cost/cache/dispatch engines
run on).  See :mod:`repro_torch.ps.partition` for the (shard, local_row)
convention and the single-PS identity special case.
"""
from .partition import PsPartition, make_partition

__all__ = ["PsPartition", "make_partition"]
