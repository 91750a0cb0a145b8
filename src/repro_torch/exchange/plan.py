"""Exchange-plan compilation: from a dispatch assignment to an explicit
ragged all-to-all schedule with exact byte accounting.

Addressing / wire format
------------------------
One training iteration moves sample rows between the n workers: source
shard ``i`` holds ``m`` local samples (rows of ``(m, F)`` int32 ids,
PAD = -1) and the dispatch assignment sends each row to one destination
worker.  The exchange is described per ordered link ``(src, dst)``:

  * ``counts[i, j]``  — payload rows src ``i`` owes dst ``j``.  Row order
    on the wire is the *stable* source order: rows keep their original
    index order within each destination group (``argsort(assign,
    stable=True)``), so a receiver can reproduce the sender's view
    without per-row tags.
  * ``offsets[i, j]`` — ragged start of link (i, j) inside src i's
    concatenated payload (``offsets[i, n] == m``): the address a
    zero-copy sender would slice at.
  * ``buckets[i, j]`` — the on-wire block size: ``counts`` rounded up to
    the next power of two (0 stays 0), capped at ``m``.  Bucketing
    quantizes block shapes so a compiled executor sees a handful of
    distinct shapes instead of one per step, while the pad it ships is
    at most the payload again (< 2x) — versus the fixed-shape baseline,
    which must pad EVERY link to one uniform block (``max(counts)``,
    i.e. ``m/n`` under the hard capacity cap).
  * ``schedule``      — the distinct non-zero bucket sizes, descending:
    executing one masked collective per schedule entry moves exactly the
    bucketed blocks.  The single-shape executor instead uses ``budget =
    schedule[0]`` for every link (what a one-``all_to_all`` jit path
    must ship); both roll up in :class:`PlanStats`.

A receiver reassembles its batch by concatenating the valid prefix of
every (src -> me) block in ascending src order — exactly what
:func:`repro_torch.exchange.ragged.compact_recv` does on device, and what
:func:`gather_reference` does here in numpy for tests.

Byte accounting (``PlanStats``): ``payload = counts * row_bytes``;
ragged wire bytes follow ``buckets``; the padded baseline ships
``padded_block`` rows on every link.  ``pad_reduction`` is the headline
number: the fraction of the baseline's pad bytes the ragged schedule
does not ship.

Host-side numpy, copied line for line from the JAX package's module of
the same path, so both packages give the same results from one seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..obs.trace import traced

__all__ = ["ExchangePlan", "PlanStats", "bucket_sizes", "compile_plan",
           "gather_reference"]


def bucket_sizes(counts: np.ndarray, cap: int | None = None) -> np.ndarray:
    """Round each count up to the next power of two (0 stays 0).

    ``cap`` clamps the bucket (a link never ships more than the sender
    holds); it must be >= counts.max().
    """
    counts = np.asarray(counts)
    if (counts < 0).any():
        raise ValueError("negative counts")
    out = np.zeros_like(counts)
    nz = counts > 0
    out[nz] = 1 << np.ceil(np.log2(counts[nz])).astype(np.int64)
    if cap is not None:
        if counts.size and counts.max() > cap:
            raise ValueError(f"count {counts.max()} exceeds cap {cap}")
        # clamp to the largest pow2 <= cap, with cap itself as the single
        # terminal bucket: every schedule entry is a power of two or cap,
        # so a non-pow2 cap contributes exactly ONE extra distinct block
        # shape instead of leaking one per clamped count, and
        # len(schedule) <= floor(log2(cap)) + 2 always holds
        top = 1 << int(np.floor(np.log2(cap)))
        out = np.where(out > top, cap, out)
    return out


@dataclasses.dataclass(frozen=True)
class PlanStats:
    """Exact byte accounting for one exchange step (totals over links)."""

    payload_bytes: int        # rows actually needed by receivers
    ragged_bytes: int         # bucketed-schedule wire bytes
    padded_bytes: int         # fixed-shape baseline wire bytes
    per_link_bytes: np.ndarray  # (n, n) ragged wire bytes per (src, dst)
    # codec tagging (repro_torch.quant): when the payload ships quantized,
    # payload/ragged/padded count *code* bytes at the codec's width and
    # the scale/zero-point side channel is reported separately (mirroring
    # how the plan's counts/offsets side channel is never charged as
    # wire bytes).  codec None keeps the plain fp32-width accounting.
    codec: str | None = None
    meta_bytes: int = 0              # scale/zp bytes on the ragged wire
    payload_fp32_bytes: int | None = None  # same payload at 4 bytes/elem

    @property
    def pad_bytes_ragged(self) -> int:
        return self.ragged_bytes - self.payload_bytes

    @property
    def pad_bytes_padded(self) -> int:
        return self.padded_bytes - self.payload_bytes

    @property
    def pad_reduction(self) -> float:
        """Fraction of the baseline's pad bytes the ragged plan avoids
        (1.0 = no pad shipped at all; 0.0 = no better than padded).

        A perfectly balanced assignment ships zero pad on BOTH plans —
        that is the best case, not the worst, so both-zero reports 1.0
        (it used to report 0.0, tarring Zipf a=0 sweeps as worst-case).
        """
        base = self.pad_bytes_padded
        if base == 0:
            return 1.0 if self.pad_bytes_ragged == 0 else 0.0
        return 1.0 - self.pad_bytes_ragged / base

    @property
    def byte_reduction(self) -> float | None:
        """fp32 payload bytes / codec payload bytes (None without codec)."""
        if self.payload_fp32_bytes is None or self.payload_bytes == 0:
            return None
        return self.payload_fp32_bytes / self.payload_bytes

    def summary(self) -> dict:
        out = {
            "payload_bytes": int(self.payload_bytes),
            "ragged_bytes": int(self.ragged_bytes),
            "padded_bytes": int(self.padded_bytes),
            "pad_bytes_ragged": int(self.pad_bytes_ragged),
            "pad_bytes_padded": int(self.pad_bytes_padded),
            "pad_reduction": float(self.pad_reduction),
        }
        if self.codec is not None:
            out["codec"] = self.codec
            out["meta_bytes"] = int(self.meta_bytes)
            out["payload_fp32_bytes"] = int(self.payload_fp32_bytes)
            out["byte_reduction"] = float(self.byte_reduction or 0.0)
        return out


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """Compiled exchange schedule for one step's assignment."""

    n: int                    # workers (sources == destinations)
    m: int                    # samples per source shard
    row_bytes: int
    counts: np.ndarray        # (n, n) payload rows per (src, dst)
    offsets: np.ndarray       # (n, n + 1) ragged starts per src
    buckets: np.ndarray       # (n, n) pow2-rounded on-wire block sizes
    schedule: tuple[int, ...]  # distinct non-zero bucket sizes, descending
    padded_block: int         # per-link block of the fixed-shape baseline
    stats: PlanStats

    @property
    def budget(self) -> int:
        """Static per-link block for the single-shape jit executor
        (= largest bucket; 1 when the step moves nothing)."""
        return self.schedule[0] if self.schedule else 1

    def send_rows(self) -> np.ndarray:
        """(n,) bucketed rows each source puts on the wire."""
        return self.buckets.sum(axis=1)

    def recv_rows(self) -> np.ndarray:
        """(n,) bucketed rows each destination takes off the wire."""
        return self.buckets.sum(axis=0)


@traced("exchange.compile", track="exchange")
def compile_plan(assign: np.ndarray, n: int, m: int | None = None,
                 row_bytes: int = 4, cap: int | None = None,
                 active: np.ndarray | None = None,
                 codec=None, row_elems: int | None = None) -> ExchangePlan:
    """Compile an assignment into an :class:`ExchangePlan`.

    Args:
      assign: (k,) destination worker per sample; samples are laid out
        source-major (sample ``i`` lives on shard ``i // m``).
      n: worker count (sources == destinations).
      m: samples per source (default ``k // n``; must divide k).
      row_bytes: wire bytes per sample row (ids: F * 4).
      cap: per-(src, dst) capacity the dispatcher enforced (bounds the
        buckets; default m).
      active: (n,) bool elastic membership mask.  Routing a sample to an
        inactive destination is a hard error (the dispatcher's dead-
        worker penalty should make it impossible); the fixed-shape
        baseline is re-based on the surviving destinations (a balanced
        assignment over n_active workers fills ``ceil(m / n_active)``
        per link, and only active columns carry blocks).  ``None`` or
        all-active reproduces the static-cluster accounting exactly.
      codec: optional wire codec (name / :class:`repro_torch.quant.Codec`).
        When set, ``row_elems`` must give the float elements per row;
        ``row_bytes`` is derived as the codec's payload code bytes and
        the scale/zero-point side channel lands in ``stats.meta_bytes``
        (never charged as pad-reduction wire bytes, mirroring the
        counts/offsets side channel).
      row_elems: float elements per row (required with ``codec``).

    The fixed-shape baseline block (``padded_block``) is what one
    uniform ``lax.all_to_all`` must use: the largest per-link count, but
    never below ``ceil(m / n)`` (a balanced assignment fills m/n).
    """
    if codec is not None:
        from ..quant.codecs import get_codec, meta_row_bytes, wire_row_bytes
        codec = get_codec(codec)
    if codec is not None:
        if row_elems is None:
            raise ValueError("codec-tagged plans need row_elems")
        row_bytes = wire_row_bytes(row_elems, codec)

    assign = np.asarray(assign)
    k = assign.shape[0]
    if m is None:
        if k % n:
            raise ValueError(f"k {k} not divisible by n {n} and no m given")
        m = k // n
    if k != n * m:
        raise ValueError(f"assign length {k} != n*m = {n * m}")
    if k and (assign.min() < 0 or assign.max() >= n):
        raise ValueError("assignment targets outside [0, n)")
    cap = m if cap is None else int(cap)

    src = np.arange(k) // m
    counts = np.zeros((n, n), np.int64)
    np.add.at(counts, (src, assign), 1)
    offsets = np.zeros((n, n + 1), np.int64)
    np.cumsum(counts, axis=1, out=offsets[:, 1:])
    buckets = bucket_sizes(counts, cap=cap)
    schedule = tuple(sorted(np.unique(buckets[buckets > 0]).tolist(),
                            reverse=True))
    n_dst = n
    n_src = n
    if active is not None:
        active = np.asarray(active, bool)
        if active.shape != (n,):
            raise ValueError(f"active mask shape {active.shape} != ({n},)")
        dead_rows = counts[:, ~active]
        if dead_rows.size and dead_rows.any():
            bad = np.where(~active)[0][dead_rows.any(axis=0)]
            raise ValueError(
                f"assignment routes samples to inactive workers {bad.tolist()}")
        n_dst = int(active.sum())
        if n_dst == 0:
            raise ValueError("no active destination workers")
        # dead sources hold no samples, so the fixed-shape baseline only
        # ships active-source rows — counting all n sources inflated
        # padded_bytes and flattered pad_reduction under churn
        n_src = n_dst

    padded_block = int(max(counts.max(initial=0), -(-m // n_dst)))

    payload = int(counts.sum()) * row_bytes
    ragged = int(buckets.sum()) * row_bytes
    padded = n_src * n_dst * padded_block * row_bytes
    if codec is None:
        stats = PlanStats(payload_bytes=payload, ragged_bytes=ragged,
                          padded_bytes=padded,
                          per_link_bytes=buckets * row_bytes)
    else:
        stats = PlanStats(
            payload_bytes=payload, ragged_bytes=ragged, padded_bytes=padded,
            per_link_bytes=buckets * row_bytes, codec=codec.name,
            meta_bytes=int(buckets.sum()) * meta_row_bytes(row_elems, codec),
            payload_fp32_bytes=int(counts.sum()) * 4 * row_elems)
    return ExchangePlan(n=n, m=m, row_bytes=row_bytes, counts=counts,
                        offsets=offsets, buckets=buckets, schedule=schedule,
                        padded_block=padded_block, stats=stats)


def gather_reference(samples: np.ndarray, assign: np.ndarray,
                     n: int) -> list[np.ndarray]:
    """Numpy oracle for the exchange: per destination, its received rows
    in wire order (ascending src, stable source order within each src) —
    what plan -> execute -> compact must reproduce exactly."""
    samples = np.asarray(samples)
    assign = np.asarray(assign)
    # ascending original index IS ascending (src, stable position) order
    return [samples[assign == j] for j in range(n)]
