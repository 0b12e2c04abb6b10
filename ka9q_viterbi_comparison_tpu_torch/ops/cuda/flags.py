"""The port's ``KA9Q_TORCH_*`` environment knobs.

Port of ``inplace_mode`` from ``ka9q_viterbi_comparison_tpu/ops/pallas/flags.py``.
Read at each call, so a test can pin a route with ``monkeypatch.setenv``.
"""

from __future__ import annotations

import os

__all__ = ["KNOBS", "inplace_mode"]

# name -> (default, meaning).
KNOBS: dict[str, tuple[str, str]] = {
    "KA9Q_TORCH_INPLACE": (
        "auto",
        "Routing of 5 < K <= 15 through the in-place rotating-address kernel. "
        "auto: at B >= 128 when one block's shared memory fits the card; "
        "0: never; 1: force at any batch (tests pin coverage with this).",
    ),
}


def inplace_mode() -> str:
    """``"auto"``, ``"off"`` (=0) or ``"force"`` (=1)."""
    v = os.environ.get("KA9Q_TORCH_INPLACE", KNOBS["KA9Q_TORCH_INPLACE"][0])
    return {"0": "off", "1": "force"}.get(v, "auto")
