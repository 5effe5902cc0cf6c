"""How ``correct`` is decided: the program's first three training steps,
driven in set-up through the window's own call and feed, against the
plain reference over the same weights and bunches.

Both sides are read by one ``Recorder`` from their state:

- ``loss``: each step's summed Xent, before the step's update;
- ``grad``: the norm of each leaf's first gradient as the optimizer gets
  it, worked out from the state after step 1 (the velocity with momentum;
  ``(W0 - W1) / a`` without, ``a`` the step's scale), and the gradient
  itself (``first``, kept on the host);
- ``change``: the norm of each leaf's change after step 3, ``W3 - W0``.

The numbers compared (``NUMBERS``), each against its limit in
``limits/<workload>.json``:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_norm_gap`` and ``change_norm_gap``: by the worst leaf, the gap
  between the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``grad_diff``: by the worst leaf, the norm of the difference of the
  first gradients over the same denominator. The norm gaps barely see
  random rounding, and TF32 products read no farther from the reference in
  them than the port's own f32 route does on the card (PERF.md); the
  difference separates the two.

Leaves whose reference gradient is under a thousandth of the median
leaf's (nought to rounding) are left out of every number.
"""

from __future__ import annotations

import json
import os
import statistics
from typing import Dict, List, Optional, Tuple

from .reference.mlp_frame_ce import Leaf, step_coeff

HERE = os.path.dirname(os.path.abspath(__file__))
NUMBERS = ("loss_gap", "grad_norm_gap", "change_norm_gap", "grad_diff")
STEPS = 3
NEGLIGIBLE = 1e-3


class Recorder:
    """Reads one side's state at steps 0, 1 and 3 (``after_step``)."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.loss: List[float] = []
        self.grad: Dict[str, float] = {}
        self.change: Dict[str, float] = {}
        self.first: Dict[str, object] = {}     # the first gradient, on the host
        self._w0: Dict[str, object] = {}

    def after_step(self, k: int, loss: Optional[float], leaves: List[Leaf]) -> None:
        if k == 0:
            self._w0 = {name: p.detach().clone() for name, p, _ in leaves}
            return
        self.loss.append(float(loss))
        if k == 1:
            a = step_coeff(self.cfg, self.cfg["bunch"])
            for name, p, v in leaves:
                p = p.detach()
                g = v.double() if v is not None else (self._w0[name].double() - p.double()) / a
                self.grad[name] = float(g.norm())
                self.first[name] = g.float().cpu()
        if k == STEPS:
            for name, p, _ in leaves:
                self.change[name] = float((p.detach().double() - self._w0[name].double()).norm())
            self._w0 = {}

    def readings(self) -> dict:
        return {"loss": self.loss, "grad": self.grad, "change": self.change,
                "first": self.first}


def _norm_gap(got: Dict[str, float], want: Dict[str, float], keep: List[str]) -> float:
    med = statistics.median(want[k] for k in keep)
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keep)


def compare(got: dict, want: dict) -> Dict[str, float]:
    """The numbers of ``NUMBERS`` between a side's readings and the
    reference's."""
    if len(got["loss"]) != STEPS or len(want["loss"]) != STEPS:
        raise ValueError(f"want {STEPS} steps' readings, got {len(got['loss'])} "
                         f"and {len(want['loss'])}")
    med = statistics.median(want["grad"].values())
    keep = [k for k, g in want["grad"].items() if g >= NEGLIGIBLE * med]
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])),
           "grad_norm_gap": _norm_gap(got["grad"], want["grad"], keep),
           "change_norm_gap": _norm_gap(got["change"], want["change"], keep)}
    if got.get("first") and want.get("first"):
        med = statistics.median(want["grad"][k] for k in keep)
        out["grad_diff"] = max(float((got["first"][k].double() - want["first"][k].double()).norm())
                               / max(want["grad"][k], med) for k in keep)
    return out


def by_leaf(got: dict, want: dict) -> Dict[str, dict]:
    """Each leaf's relative gaps, for the calibration's record."""
    out = {}
    for k, g in want["grad"].items():
        row = {"grad": g, "grad_norm_rel": (got["grad"][k] - g) / g,
               "change_norm_rel": (got["change"][k] - want["change"][k]) / want["change"][k]}
        if got.get("first") and want.get("first"):
            row["grad_diff_rel"] = float((got["first"][k].double()
                                          - want["first"][k].double()).norm()) / g
        out[k] = row
    return out


def load_limits(workload: str) -> Dict[str, float]:
    with open(os.path.join(HERE, "limits", f"{workload}.json")) as f:
        limits = json.load(f)["limits"]
    missing = [k for k in NUMBERS if k not in limits]
    if missing:
        raise ValueError(f"limits/{workload}.json lacks {missing}")
    return limits


def verdict(values: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """(every number finite and within its limit, {name: {value, limit}})."""
    rows = {k: {"value": values.get(k, float("nan")), "limit": limits[k]} for k in NUMBERS}
    ok = all(r["value"] == r["value"] and r["value"] <= r["limit"] for r in rows.values())
    return ok, rows
