"""Data-sheet figures of the attached card, for the communication models.

The port's counterpart of ``ka9q_viterbi_comparison_tpu/utils/chipinfo.py``.
It detects the card with ``torch.cuda.get_device_name`` and serves the
figures ``harness/comms.py`` reads: the HBM bytes a second and the NVLink
egress bytes a second of one card.  On the CPU, or on a card it does not
know, it returns the H100 SXM figures flagged ``assumed=True``.

Sources (NVIDIA's data sheets, not measurements):

* H100 Tensor Core GPU, SXM5: HBM3 3.35 TB/s; NVLink 900 GB/s total, that is
  450 GB/s a direction.
* H100 Tensor Core GPU, PCIe: HBM2e 2.0 TB/s; NVLink bridge 600 GB/s total,
  300 GB/s a direction.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

__all__ = ["ChipInfo", "chip_info", "detect_kind", "resolve"]


@dataclasses.dataclass(frozen=True)
class ChipInfo:
    name: str                      # canonical part name
    device_kind: str               # the matched device name ("" if assumed)
    hbm_bytes_per_s: float         # device memory rate of one card
    ici_egress_bytes_per_s: float  # NVLink egress of one card, one direction
    assumed: bool                  # True: fallback figures, not the detected card


H100_SXM = ChipInfo("H100 SXM", "NVIDIA H100 80GB HBM3", 3.35e12, 450e9, False)
H100_PCIE = ChipInfo("H100 PCIe", "NVIDIA H100 PCIe", 2.0e12, 300e9, False)

# lower-cased substring of the device name -> figures; the first match wins.
_KNOWN: list[tuple[str, ChipInfo]] = [
    ("h100 pcie", H100_PCIE),
    ("h100", H100_SXM),
]

_FALLBACK = dataclasses.replace(H100_SXM, device_kind="", assumed=True)


def detect_kind() -> str | None:
    """The card's name (``torch.cuda.get_device_name(0)``), or None where
    there is no CUDA device."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(0)


def resolve(kind: str | None) -> ChipInfo:
    """Figures for a device name; the H100 SXM figures, flagged ``assumed``,
    for None or a name the table does not know."""
    if not kind:
        return _FALLBACK
    low = kind.lower()
    for sub, info in _KNOWN:
        if sub in low:
            return dataclasses.replace(info, device_kind=kind)
    return dataclasses.replace(_FALLBACK, device_kind=kind)


@functools.lru_cache(maxsize=1)
def chip_info() -> ChipInfo:
    """Figures for the attached card (cached)."""
    return resolve(detect_kind())
