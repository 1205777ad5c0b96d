"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet, H100 SXM5 80GB, dense rates, at the 700 W power limit), found by
the prefix of `torch.cuda.get_device_name()`."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def peaks_for(kind: str) -> dict | None:
    for prefix, p in PEAKS.items():
        if kind.startswith(prefix):
            return p
    return None
