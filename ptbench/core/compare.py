"""The numbers that decide `correct`, from the program's pixels and the reference's.

- rel_l1: the sum over compared channels finite on both sides of |program - reference|
  over the sum of |reference| there. Rounding that differs between the two moves it little; a path
  that takes another branch moves its pixel by that path's share of the mean.
- pixels_off: the share of compared pixels with a channel off by more than OFF_REL of
  the pixel's largest reference channel (plus OFF_ABS): pixels whose paths differ.
A pixel with a channel that only one side makes NaN or infinite is off.
"""

from __future__ import annotations

import numpy as np

OFF_REL = 1e-4
OFF_ABS = 1e-6


def _host(x):
    """An array or a tensor on any device -> a float64 array on the host."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def film_numbers(got, want) -> dict:
    got, want = _host(got), _host(want)
    finite = np.isfinite(got) & np.isfinite(want)
    # the estimator divides by an unguarded pdf, as the Rust reference does, so a path can
    # give NaN: a channel that both sides make NaN (or the same infinity) agrees, and one
    # that only one side makes non-finite is off
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    diff = np.where(finite, np.abs(got - want), 0.0)
    scale = np.where(np.isfinite(want), np.abs(want), 0.0).max(axis=1) * OFF_REL + OFF_ABS
    off = (diff.max(axis=1) > scale) | (~finite & ~same).any(axis=1)
    total = np.where(finite, np.abs(want), 0.0).sum()
    return {"rel_l1": float(diff.sum() / max(total, 1e-30)),
            "pixels_off": float(off.mean()),
            "max_abs": float(diff.max()),
            "nonfinite": int((~np.isfinite(want)).any(axis=1).sum()),
            "one_sided": int((~finite & ~same).any(axis=1).sum()),
            "compared": int(want.shape[0])}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every limited number at or under its limit, {name: {value, limit}})."""
    out = {name: {"value": numbers[name], "limit": lim} for name, lim in limits.items()}
    return all(v["value"] <= v["limit"] for v in out.values()), out


def _norms(leaves) -> dict:
    return {n: float(np.linalg.norm(np.asarray(v.detach().cpu(), dtype=np.float64))) for n, v in leaves.items()}


def _worst(gaps) -> float:
    """The largest gap; infinite where a gap is not finite (a NaN on either side), since a
    comparison with NaN is false and a plain max would pass over it."""
    g = np.asarray(list(gaps), dtype=np.float64)
    if g.size == 0:
        return 0.0
    return float(g.max()) if np.isfinite(g).all() else float("inf")


def _gap(a, b, scale):
    """|a - b| / scale; nought where both sides agree, NaN on both included (as film_numbers
    has it), and NaN where one side alone is NaN."""
    if a == b or (np.isnan(a) and np.isnan(b)):
        return 0.0
    return abs(a - b) / scale


def _leaf_gaps(got, want, counted, floor):
    """{leaf: |norm(got) - norm(want)| / max(norm(want), floor)} over the counted leaves."""
    g, w = _norms(got), _norms(want)
    return {n: _gap(g.get(n, 0.0), w[n], max(w[n], floor)) for n in counted}


def _worst_leaf(got, want, counted, floor):
    """The largest of _leaf_gaps."""
    return _worst(_leaf_gaps(got, want, counted, floor).values())


def _counted(grads):
    """(leaves counted, median leaf norm): leaves whose reference gradient is under a
    thousandth of the median leaf's are left out (their gradient is nought to rounding,
    and Adam moves them by round-off alone)."""
    gw = _norms(grads)
    med = float(np.median(list(gw.values())))
    return [n for n, v in gw.items() if v >= 1e-3 * med and v > 0.0], med


def train_numbers(got: dict, want: dict) -> dict:
    """The numbers of an inverse-rendering cell, program (got) against reference (want):

    - loss: the largest relative gap of a followed step's loss;
    - grad1: the first step's gradient as the optimizer holds it, by the worst leaf: the gap
      between the two norms of a leaf over the larger of the reference's norm of that leaf
      and of the median leaf;
    - change: the parameters' change over the followed steps, by the worst leaf, alike;
    - last_film, last_grad: the window's last step, worked out again from the parameters
      and cotangent it was handed: its film's rel_l1 (as film_numbers; infinite where a
      pixel is non-finite on one side only) and its gradient by the worst leaf.
    Each counts only the leaves that _counted keeps. A gap that is not finite reads
    infinite."""
    counted, med = _counted(want["grad1"])
    cw = _norms(want["change"])
    cmed = float(np.median([cw[n] for n in counted])) if counted else 0.0
    last, lmed = _counted(want["last"]["grads"])
    film = film_numbers(got["last"]["film"], want["last"]["film"])
    return {"loss": _worst(_gap(a, b, max(abs(b), 1e-30)) for a, b in zip(got["loss"], want["loss"])),
            "grad1": _worst_leaf(got["grad1"], want["grad1"], counted, med),
            "change": _worst_leaf(got["change"], want["change"], counted, cmed),
            "last_film": film["rel_l1"] if film["one_sided"] == 0 else float("inf"),
            "last_grad": _worst_leaf(got["last"]["grads"], want["last"]["grads"], last, lmed),
            "leaves": counted, "steps": len(want["loss"]),
            "last_grad_by_leaf": _leaf_gaps(got["last"]["grads"], want["last"]["grads"], last, lmed)}
