"""Gate a GNN dry run's collective census on the zero-all_gather rule (the
port of ``src/repro/launch/census_check.py``).

The multi-pod collective epoch (``repro_torch.launch.dryrun_gnn --pull
collective``) must not pick up a dense-fallback collective:

  PYTHONPATH=src python -m repro_torch.launch.census_check census.jsonl \\
      [--records 2]

For every JSON line the census (``collective_counts``, the port's op
names of ``core.collectives``) must show

  * all_gather == 0 — the op the owner-sharded two-stage exchange exists
    to avoid (the port has no reduce-scatter op, the reference's other
    forbidden one);
  * all_to_all >= 1 — the intra-pod ragged pull is present;
  * send >= 1 — so is the inter-pod hop (the reference's
    collective-permute).

``--records`` (default 2) pins the line count so a silently-skipped run
cannot pass; ``--records 0`` accepts any non-empty file.
"""
from __future__ import annotations

import argparse
import json
import sys

FORBIDDEN = ("all_gather",)
REQUIRED = ("all_to_all", "send")


def check_census(records: list[dict], expect_records: int = 2) -> list[str]:
    """Return a list of violation strings (empty = census OK)."""
    errors = []
    if expect_records and len(records) != expect_records:
        errors.append(f"expected {expect_records} census records, "
                      f"found {len(records)}")
    if not records:
        errors.append("census file is empty")
    for rec in records:
        counts = rec.get("collective_counts")
        label = (f"{rec.get('mesh')} {rec.get('precision')} "
                 f"ppd={rec.get('parts_per_device')} "
                 f"predictor={rec.get('predictor', 'none')}")
        if counts is None:
            errors.append(f"{label}: record has no collective_counts")
            continue
        for op in FORBIDDEN:
            if counts.get(op, 0) != 0:
                errors.append(f"{label}: {op} == {counts.get(op)} "
                              f"(must be 0): {counts}")
        for op in REQUIRED:
            if counts.get(op, 0) < 1:
                errors.append(f"{label}: {op} == {counts.get(op, 0)} "
                              f"(two-stage exchange missing): {counts}")
    return errors


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("census", help="JSONL file from dryrun_gnn --out")
    ap.add_argument("--records", type=int, default=2,
                    help="exact record count expected (0 = any non-empty)")
    args = ap.parse_args(argv)
    with open(args.census) as f:
        records = [json.loads(line) for line in f if line.strip()]
    errors = check_census(records, expect_records=args.records)
    for rec in records:
        status = "FAIL" if errors else "OK"
        print(f"census {status}: {rec.get('mesh')} {rec.get('precision')} "
              f"ppd={rec.get('parts_per_device')} "
              f"predictor={rec.get('predictor', 'none')} "
              f"{rec.get('collective_counts')}")
    for e in errors:
        print(f"census violation: {e}", file=sys.stderr)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
