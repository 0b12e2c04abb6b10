"""Collective-traffic accounting for the multi-device decode paths.

Port of ``ka9q_viterbi_comparison_tpu/harness/comms.py``, in two halves:

* **Counted**: ``collective_trace`` runs a sharded decode with every
  collective of ``parallel/mesh.py`` recorded (the JAX module walks the
  jaxpr instead; the port counts the calls that ran) and reports each with
  its per-shard payload, pair count and count.  Tests hold the counts to the
  analytic models below.
* **Analytic** (``statewise_model``, ``timeblock_model``,
  ``state_time_model``, ``frame_model``): per-step wire bytes and a
  predicted scaling efficiency, with the JAX module's formulas and keys.
  ``hbm`` and ``ici`` default to ``utils/chipinfo.py``'s figures of the
  attached card, the H100 SXM data sheet's where there is none: HBM3
  3.35 TB/s, and for "ICI" -- the JAX module's name for the chip-to-chip
  link, kept so that the models' arguments and keys match -- the card's
  NVLink egress, 450 GB/s a direction.

What the models say on the H100 figures: frame DP moves no bytes (100 %);
a time block moves one halo each way per frame, and its efficiency is the
warm-up's share; state sharding moves one metric-vector copy over NVLink a
step, against some 8 bytes a state of HBM traffic, so its step efficiency
is ``t_hbm / max(t_hbm, t_nvlink)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..configs import CodeSpec
from ..parallel import mesh as mesh_mod

__all__ = [
    "Collective",
    "CommsReport",
    "collective_trace",
    "statewise_model",
    "timeblock_model",
    "state_time_model",
    "frame_model",
    "HBM_BYTES_PER_S",
    "ICI_EGRESS_BYTES_PER_S",
]


def __getattr__(name: str):
    # Resolved at first read, so that importing this module touches no card.
    if name in ("HBM_BYTES_PER_S", "ICI_EGRESS_BYTES_PER_S"):
        from ..utils.chipinfo import chip_info

        info = chip_info()
        return (info.hbm_bytes_per_s if name == "HBM_BYTES_PER_S"
                else info.ici_egress_bytes_per_s)
    raise AttributeError(name)


@dataclass
class Collective:
    prim: str
    shape: tuple
    dtype: str
    payload_bytes: int      # one shard's payload (bytes leaving one source)
    pairs: int              # ppermute: # (src, dst) pairs; reductions: 1
    count: int              # executions
    axes: tuple

    @property
    def wire_bytes(self) -> int:
        """Bytes crossing links per execution (ppermute: every pair ships
        one payload; reductions: the payload, a lower bound)."""
        return self.payload_bytes * self.pairs


@dataclass
class CommsReport:
    collectives: list[Collective] = field(default_factory=list)

    def total_wire_bytes(self, prim_prefix: str = "") -> int:
        return sum(c.wire_bytes * c.count for c in self.collectives
                   if c.prim.startswith(prim_prefix))

    def total_count(self, prim_prefix: str = "") -> int:
        return sum(c.count for c in self.collectives if c.prim.startswith(prim_prefix))

    def to_json_obj(self) -> dict:
        return {
            "collectives": [
                {"prim": c.prim, "shape": list(c.shape), "dtype": c.dtype,
                 "payload_bytes": c.payload_bytes, "pairs": c.pairs,
                 "count": c.count, "axes": list(c.axes), "wire_bytes": c.wire_bytes}
                for c in self.collectives
            ],
            "total_wire_bytes": self.total_wire_bytes(),
        }


def collective_trace(fn, *args, **kwargs) -> CommsReport:
    """Run ``fn(*args, **kwargs)`` and account every collective it issued.

    Calls of one collective (same primitive, shape, dtype, axes and
    permutation) merge into one entry whose ``count`` is the number of
    calls, as a scan's trip count multiplies an equation in the JAX trace.
    """
    with mesh_mod.recording() as calls:
        fn(*args, **kwargs)
    merged: dict[tuple, Collective] = {}
    for c in calls:
        key = (c.prim, c.shape, c.dtype, c.pairs, c.axes, c.site)
        if key in merged:
            merged[key].count += 1
        else:
            merged[key] = Collective(c.prim, c.shape, c.dtype, c.payload_bytes, c.pairs, 1,
                                     c.axes)
    return CommsReport(list(merged.values()))


# ---------------------------------------------------------------------------
# Analytic models.  All byte counts are per frame batch (B frames decoded
# together), int32 metrics and symbols as the sharded paths use.
# ---------------------------------------------------------------------------


def statewise_model(code: CodeSpec, n_state: int, B: int, T: int,
                    hbm: float | None = None,
                    ici: float | None = None) -> dict:
    """State-sharded update (``parallel/statewise.py``).

    Per trellis step the butterfly exchange runs 4 half-shard ppermutes of
    ``[B, chunk]`` int32 (chunk = S/2n), n/2 pairs each: total wire bytes =
    one full metric-vector copy (4*B*S bytes); per-shard egress 4*B*S/n.

    Efficiency: per shard and step, HBM traffic = read old shard + write new
    shard + packed decisions ~ (4+4+1/8)*B*S/n bytes; wire 4*B*S/n at the
    link's rate.  Perfect overlap gives ``eff = t_hbm / max(t_hbm, t_ici)``.
    """
    hbm = hbm if hbm is not None else __getattr__("HBM_BYTES_PER_S")
    ici = ici if ici is not None else __getattr__("ICI_EGRESS_BYTES_PER_S")
    S = code.num_states
    chunk = S // (2 * n_state)
    step_wire = 4 * (n_state // 2 if n_state > 1 else 0) * (4 * B * chunk)
    egress_dev = step_wire / max(n_state, 1)
    hbm_dev = (8 + 0.125) * B * S / n_state
    t_hbm = hbm_dev / hbm
    t_ici = egress_dev / ici
    eff = 1.0 if step_wire == 0 else t_hbm / max(t_hbm, t_ici)
    # Traceback: one psum of [B] int32 per step (latency-, not bandwidth-bound).
    return {
        "axis": "state", "n": n_state, "B": B, "T": T,
        "step_wire_bytes": step_wire,
        "step_egress_bytes_per_device": egress_dev,
        "update_ppermutes": 4 * T,
        "traceback_psums": T,
        "traceback_psum_bytes": 4 * B,
        "predicted_step_efficiency": eff,
    }


def timeblock_model(code: CodeSpec, n_time: int, B: int, T: int,
                    overlap: int | None = None,
                    hbm: float | None = None,
                    ici: float | None = None) -> dict:
    """Time-block SP (``parallel/timeblock.py``): two one-shot symbol-halo
    ppermutes of ``[B, overlap, R]`` int32 per frame (not per step), plus
    ``overlap`` extra warm-up ACS steps per shard.

    Efficiency has two terms: the redundant warm-up compute
    ``Tb / (Tb + 2*overlap)``, and the one-shot wire time amortised over the
    block's ACS.
    """
    from ..parallel import default_overlap

    hbm = hbm if hbm is not None else __getattr__("HBM_BYTES_PER_S")
    ici = ici if ici is not None else __getattr__("ICI_EGRESS_BYTES_PER_S")
    if overlap is None:
        overlap = default_overlap(code)
    Tb = T // n_time
    halo_payload = 4 * B * overlap * code.R
    wire = 2 * (n_time - 1) * halo_payload
    # ACS step cost (one shard, HBM side): metrics read + write ~ 8*B*S.
    t_block = (Tb + 2 * overlap) * 8 * B * code.num_states / hbm
    t_wire = (2 * halo_payload / ici) if n_time > 1 else 0.0
    eff_warmup = Tb / (Tb + 2 * overlap)
    eff = eff_warmup * t_block / (t_block + t_wire)
    return {
        "axis": "time", "n": n_time, "B": B, "T": T, "overlap": overlap,
        "halo_ppermutes": 2,
        "halo_payload_bytes": halo_payload,
        "total_wire_bytes": wire,
        "predicted_efficiency": eff,
        "warmup_share": 1 - eff_warmup,
    }


def state_time_model(code: CodeSpec, n_state: int, n_time: int, B: int,
                     T: int, overlap: int | None = None,
                     hbm: float | None = None,
                     ici: float | None = None) -> dict:
    """Composed mesh (``parallel/state_time.py``): the statewise per-step
    exchange inside every block x the time block's one-shot halos;
    tracebacks block-local (``Tb + overlap`` psums instead of T)."""
    from ..parallel import default_overlap

    if overlap is None:
        overlap = default_overlap(code)
    Tb = T // n_time
    sw = statewise_model(code, n_state, B, Tb + 2 * overlap, hbm, ici)
    tb = timeblock_model(code, n_time, B, T, overlap, hbm, ici)
    return {
        "axes": ("state", "time"), "n_state": n_state, "n_time": n_time,
        "B": B, "T": T, "overlap": overlap,
        "step_wire_bytes": sw["step_wire_bytes"],
        "update_ppermutes_per_device_stream": 4 * (Tb + 2 * overlap),  # warm-up + main scans
        "halo_payload_bytes": tb["halo_payload_bytes"],
        "traceback_psums": Tb + overlap,
        "predicted_efficiency": sw["predicted_step_efficiency"] * tb["predicted_efficiency"],
    }


def frame_model(n_frame: int, B: int) -> dict:
    """Frame DP (``parallel/frame.py``): zero collectives; scaling bounded
    only by dispatch imbalance."""
    return {"axis": "frame", "n": n_frame, "B": B, "total_wire_bytes": 0,
            "predicted_efficiency": 1.0}
