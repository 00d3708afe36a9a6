"""Published peaks of the cards the benchmark runs on.

NVIDIA's data sheet for the H100 SXM: 3.35 TB/s of HBM3 at its full power
limit of 700 W. A run prints the card's power limit beside its numbers
(``nvidia-smi``), since a card set below it reaches less.
"""

from __future__ import annotations

#: (part of ``torch.cuda.get_device_name()``, peaks)
PEAKS = (
    ("H100", {"bytes_per_s": 3.35e12}),
)


def peaks(kind: str) -> dict | None:
    """The peaks of the card named ``kind``; None for a card not listed."""
    for part, table in PEAKS:
        if part in kind:
            return table
    return None
