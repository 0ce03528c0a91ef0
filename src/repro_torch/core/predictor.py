"""Staleness-alleviated embedding prediction (SAT) for the halo store, on
tensors (the port of ``src/repro/core/predictor.py``).

DIGEST's Theorem-1 error grows with the sync interval because consumers
read raw stale representations.  SAT (arXiv 2308.13466) predicts the
current embedding from the stale history.  The pusher keeps a history per
(part, layer) and emits prediction rows into a second store-shaped dict,
the ``pstore``, with the store's slot geometry and precision; consumers
read

    predicted(row) = dequant(store row) + gamma * dequant(pstore row)

fused into the halo kernels (K2/K3/K4's ``pdata``/``pscale``/``gamma``).

* :class:`PredictorConfig` — ``kind="none"`` (no predictor state at all,
  so the run is the predictor-free one bit for bit), ``"delta"`` (the
  last-two-syncs delta) or ``"ema"`` (a beta-EMA of per-sync deltas).
* :func:`init_history` / :func:`update_history` — the pusher-side
  history and its transition, a pure function of the accepted-push
  sequence: no store reads, no random numbers, no round numbers.

The emitted rows are ``coef * base``: per (part, layer) the scalar
least-squares fit of this push's realised change against the previously
pushed base rows, beta-EMA-smoothed and clipped to [COEF_MIN, COEF_MAX].
The coefficient starts at 0, so the first pushes predict nothing.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device

KINDS = ("none", "delta", "ema")

# Clip range of the learned coefficient: negative fits damp oscillation
# but stop at -1; fits above 1 extrapolate past linear but stop well short
# of runaway feedback.
COEF_MIN = -1.0
COEF_MAX = 1.5


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    """kind:  "none", "delta" or "ema".
    gamma: pull-time coefficient — predicted = stale + gamma * history.
    beta:  EMA weight of the newest delta (and of the newest fit)."""
    kind: str = "none"
    gamma: float = 1.0
    beta: float = 0.5

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"predictor kind {self.kind!r} not in {KINDS}")
        if not (0.0 < self.beta <= 1.0):
            raise ValueError(f"predictor beta {self.beta} must be in (0, 1]")

    @property
    def enabled(self) -> bool:
        return self.kind != "none"


def init_history(num_parts: int, num_hidden_layers: int, rows: int,
                 hidden: int, device="cuda") -> dict:
    """fp32 history state, shaped like the push buffers:

    prev:  (M, L-1, S, hidden) — the representations each part last pushed.
    ema:   (M, L-1, S, hidden) — the last emitted base rows (the delta or
           its beta-EMA) before the coefficient.
    coef:  (M, L-1) — the learned scaling of the base rows (starts at 0).
    count: (M,) int32 — accepted pushes per part.
    """
    dev = resolve_device(device)
    shape = (num_parts, num_hidden_layers, rows, hidden)
    return {"prev": torch.zeros(shape, dtype=torch.float32, device=dev),
            "ema": torch.zeros(shape, dtype=torch.float32, device=dev),
            "coef": torch.zeros((num_parts, num_hidden_layers),
                                dtype=torch.float32, device=dev),
            "count": torch.zeros((num_parts,), dtype=torch.int32,
                                 device=dev)}


def update_history(hist: dict, reps: torch.Tensor, ok: torch.Tensor,
                   cfg: PredictorConfig) -> tuple[dict, torch.Tensor]:
    """One push event: returns ``(new_hist, push_rows)``.

    reps: (M, L-1, S, hidden) fp32 — what the store push consumes.
    ok:   (M,) bool — the parts whose push takes effect (the store push's
          own gate); masked parts keep every history leaf as it was.
    push_rows (M, L-1, S, hidden) fp32 is what belongs in the pstore for
    the gated parts.  Pure: ``hist`` is not written.
    """
    gate = ok[:, None, None, None]
    seen = (hist["count"] > 0)[:, None, None, None]
    zero = reps.new_zeros(())
    delta = torch.where(seen, reps - hist["prev"], zero)
    if cfg.kind == "ema":
        base = cfg.beta * delta + (1.0 - cfg.beta) * hist["ema"]
    elif cfg.kind == "delta":
        base = delta
    else:
        raise ValueError(f"update_history with kind={cfg.kind!r}")
    # How much of the realised change did last sync's base rows explain?
    num = torch.sum(delta * hist["ema"], dim=(2, 3))          # (M, L-1)
    den = torch.sum(torch.square(hist["ema"]), dim=(2, 3))    # (M, L-1)
    fit = torch.clamp(num / torch.clamp_min(den, 1e-12), COEF_MIN, COEF_MAX)
    have_fit = ok[:, None] & (den > 1e-12)
    coef = torch.where(have_fit,
                       cfg.beta * fit + (1.0 - cfg.beta) * hist["coef"],
                       hist["coef"])
    rows = coef[:, :, None, None] * base
    new_hist = {"prev": torch.where(gate, reps, hist["prev"]),
                "ema": torch.where(gate, base, hist["ema"]),
                "coef": coef,
                "count": hist["count"] + ok.to(torch.int32)}
    return new_hist, rows
