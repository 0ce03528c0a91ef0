#!/usr/bin/env python
"""The roofline table of the port's dry-run records
(``scripts/torch_run_dryruns.py``): each case's three terms on one
NVIDIA H100 SXM5 80GB (published peaks, ``repro_torch.launch.mesh``:
predictions, not measurements), the bounding term, the peak memory a
card against its 80 GB, and MODEL_FLOPS over the counted FLOPs.

MODEL_FLOPS convention (the reference's ``scripts/roofline_report.py``):
  train    6 · (N_active_body + d·V) · D      (fwd+bwd, remat-free ideal)
  prefill  2 · (N_active_body + d·V) · D
  decode   2 · (N_active_body + d·V) · D_step (D_step = batch·1 token)
divided by the cards.  N_active_body leaves out the embeddings and, for
MoE, counts only the top-k experts a token.  Attention score FLOPs are
left out of MODEL_FLOPS, so long prefills read high; remat recomputes
and the one-process MoE's every-expert products read low.

  PYTHONPATH=src python scripts/torch_roofline_report.py \\
      dryrun-single.jsonl dryrun-multi.jsonl [--status dryrun-status.jsonl]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.configs import ALIASES, get_arch             # noqa: E402
from repro_torch.launch.specs import SHAPES                   # noqa: E402
from repro_torch.models.transformer import arch_specs         # noqa: E402
from repro_torch.nn import param_count                        # noqa: E402

NAME_TO_ID = {get_arch(a).name: a for a in ALIASES.values()}
CARD_BYTES = 80e9


def model_flops_per_chip(arch_name: str, shape: str, chips: int) -> float:
    cfg = get_arch(NAME_TO_ID[arch_name])
    total = param_count(arch_specs(cfg))
    body = total - cfg.vocab_size * cfg.d_model * 2   # embed + lm_head
    if cfg.num_experts:
        n_moe_layers = sum(k == "moe" for k in cfg.pattern) * cfg.repeats
        inactive = ((cfg.num_experts - cfg.experts_per_token)
                    * 3 * cfg.d_model * cfg.d_ff)
        body -= inactive * n_moe_layers
    n_eff = body + cfg.d_model * cfg.vocab_size       # + lm_head matmul
    sh = SHAPES[shape]
    if sh["kind"] == "train":
        toks, mult = sh["batch"] * sh["seq"], 6
    elif sh["kind"] == "prefill":
        toks, mult = sh["batch"] * sh["seq"], 2
    else:
        toks, mult = sh["batch"], 2
    return mult * n_eff * toks / chips


def _load(paths: list) -> dict:
    """The last record of each (arch, shape, mesh)."""
    dedup = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                if line.strip():
                    r = json.loads(line)
                    dedup[(r["arch"], r["shape"], r["mesh"])] = r
    return dedup


def _terms(r: dict) -> dict:
    return {"compute": r["compute_term_s"], "memory": r["memory_term_s"],
            "collective": r["collective_term_s"]}


def emit_table(paths: list, status: dict) -> None:
    """One row an (arch, shape), the two meshes side by side: each cell
    "16x16 / 2x16x16" ("-" where a mesh has no record, the reason where
    its case failed); "!" marks a peak over the card's 80 GB."""
    dedup = _load(paths)
    failed = {k: s for k, s in status.items() if s["rc"] != 0}
    print("| arch | shape | bound by | compute s | memory s | collective "
          "s | peak GB (of 80) | MODEL TFLOP/card | MF/counted | "
          "inter-pod GB |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    keys = sorted({(a, s) for a, s, _ in dedup}
                  | {(a, s) for a, s, _ in failed})
    for arch, shape in keys:
        cells = {k: [] for k in ("dom", "compute", "memory", "collective",
                                 "peak", "mf", "ratio", "pod")}
        for mesh in ("16x16", "2x16x16"):
            r = dedup.get((arch, shape, mesh))
            if r is None:
                s = failed.get((arch, shape, mesh))
                why = ("-" if s is None else "time limit" if s["rc"] == -9
                       else f"exit {s['rc']}")
                for v in cells.values():
                    v.append(why)
                continue
            terms = _terms(r)
            cells["dom"].append(max(terms, key=terms.get))
            for k, v in terms.items():
                cells[k].append(f"{v:.3g}")
            peak = r["mem_peak_bytes"]
            cells["peak"].append(f"{peak / 1e9:.3g}"
                                 + ("!" if peak > CARD_BYTES else ""))
            mf = model_flops_per_chip(arch, shape, r["chips"])
            cells["mf"].append(f"{mf / 1e12:.3g}")
            cells["ratio"].append(f"{mf / r['flops']:.3g}" if r["flops"]
                                  else "nan")
            cells["pod"].append(f"{r['inter_pod_bytes'] / 1e9:.3g}")
        print(f"| {arch} | {shape} | "
              + " | ".join(" / ".join(v) for v in cells.values()) + " |")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("records", nargs="*",
                    default=["dryrun-single.jsonl", "dryrun-multi.jsonl"])
    ap.add_argument("--status", default=None,
                    help="the runner's dryrun-status.jsonl: failed cases")
    args = ap.parse_args()
    status = {}
    if args.status:
        with open(args.status) as f:
            for line in f:
                if line.strip():
                    s = json.loads(line)
                    status[(s["arch"], s["shape"], s["mesh"])] = s
    emit_table([p for p in args.records if os.path.exists(p)], status)


if __name__ == "__main__":
    main()
