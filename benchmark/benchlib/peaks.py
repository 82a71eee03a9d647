"""Published peaks of the cards the benchmark states rooflines against.

NVIDIA H100 SXM5 data sheet (dense, no sparsity, at the 700 W limit):
3.35 TB/s of HBM3; 34 TFLOP/s in float64 and 67 TFLOP/s in float32 on the
CUDA cores (the stencils use no tensor core). A card not in the table gets
no roofline.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                              "flops_per_s": {"float64": 34e12, "float32": 67e12}},
}


def lookup(kind: str, dtype: str) -> dict | None:
    """``{"bytes_per_s", "flops_per_s"}`` of card ``kind`` for ``dtype``
    arithmetic, or None."""
    card = PEAKS.get(kind)
    if card is None or dtype not in card["flops_per_s"]:
        return None
    return {"bytes_per_s": card["bytes_per_s"], "flops_per_s": card["flops_per_s"][dtype]}
