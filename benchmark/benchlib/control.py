"""The control of the comparison: the plain reference put in the program's
place and computed in the precision next below the configuration's, then
judged exactly as the program's answers are. Its numbers have to fail the
cell's limits; the probe `probes/limits.py` reads them on the card, and a
test holds them at a small size."""

from __future__ import annotations

LOWER = {"float64": "float32", "float32": "bfloat16"}


def control_numbers(cell, seed: int, device: str) -> dict:
    """The numbers of one control answer on ``seed``'s inputs, shaped as
    the mix's generator shapes an answer."""
    ref, cfg, tr = cell.reference, cell.cfg, cell.traffic
    consts = ref.consts(cfg)
    inputs = ref.inputs(cfg, tr.get("members"), int(seed), device)
    model = cell.model.Model(cfg, tr, consts, inputs, device)
    try:
        ans = cell.generator.control_answer(model, ref, inputs, consts, tr, LOWER[cfg["dtype"]])
    finally:
        model.close()
    truth = ref.run(inputs, consts, {"steps": [ans.steps]}, ref.DTYPE)
    return model.judge(ans, truth)
