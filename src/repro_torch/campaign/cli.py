"""``python -m repro_torch.campaign`` — run / merge / report.

The hpcbench-style command-line surface over the campaign layer:

    # execute a spec, journal every run, print the ranked report
    python -m repro_torch.campaign run spec.json --journal runs.ndjson

    # fold journals (partial ones from killed runs included)
    python -m repro_torch.campaign merge a.ndjson b.ndjson --out merged.ndjson

    # render a merged (or raw) journal
    python -m repro_torch.campaign report merged.ndjson --md report.md \
        --csv runs.csv --json report.json

``run`` also accepts ``--edition-study E1 E2 [...]``: a shorthand that
builds the longitudinal TOP500 spec (one fleet selector per vendored
sample edition) without writing a spec file — the two-edition
drift study is ``run --edition-study 2020_06 2020_11``.  ``run --device``
names the device the sweeps run on (default ``cuda``; ``cpu`` runs
without a card).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .exec import run_campaign
from .report import (campaign_report, merge_journals, render_markdown,
                     render_text, write_csv, write_journal)
from .spec import CampaignSpec, PlatformSelector


def edition_study_spec(editions: List[str], *, name: str = "",
                       limit: int = 0) -> CampaignSpec:
    """The longitudinal TOP500 campaign: one fleet selector per vendored
    sample edition (prediction + per-fabric calibration per edition,
    drift reported between the earliest and latest)."""
    return CampaignSpec(
        name=name or f"top500-drift-{'-'.join(editions)}",
        platforms=tuple(PlatformSelector(top500=f"sample:{ed}",
                                         limit=limit)
                        for ed in editions))


def _cmd_run(args) -> int:
    if args.edition_study:
        spec = edition_study_spec(args.edition_study, limit=args.limit)
    elif args.spec:
        spec = CampaignSpec.load(args.spec)
    else:
        print("run: need a spec file or --edition-study", file=sys.stderr)
        return 2
    tuning = None
    if args.max_ranks:
        from repro_torch.top500 import FleetTuning
        tuning = FleetTuning(max_ranks=args.max_ranks,
                             panels_cap=max(args.max_ranks * 8, 2048))
    result = run_campaign(spec, journal=args.journal, tuning=tuning,
                          strict=args.strict, device=args.device)
    report = campaign_report(result.records)
    out = render_markdown(report) if args.markdown \
        else render_text(report)
    print(out, end="")
    print(f"[campaign {spec.name!r}: {len(result.matrix.cases)} runs "
          f"in {result.wall_s:.1f}s"
          + (f"; journal -> {args.journal}" if args.journal else "")
          + "]", file=sys.stderr)
    return 0


def _cmd_merge(args) -> int:
    records = merge_journals(args.journals, strict=args.strict)
    write_journal(records, args.out)
    merged = records[-1]["meta"]
    print(f"merged {len(args.journals)} journal(s): "
          f"{merged['n_runs']} runs, {merged['n_summaries']} "
          f"summaries -> {args.out}", file=sys.stderr)
    return 0


def _cmd_report(args) -> int:
    records = merge_journals(args.journals, strict=args.strict)
    report = campaign_report(records)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
    if args.csv:
        write_csv(records, args.csv)
    md = render_markdown(report, top=args.top)
    if args.md:
        with open(args.md, "w") as fh:
            fh.write(md)
    print(md if args.markdown else render_text(report, top=args.top),
          end="")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.campaign",
        description="Declarative fleet studies over the prediction "
                    "stack: run a campaign spec, merge NDJSON journals, "
                    "render ranked + drift reports.")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="execute a campaign spec")
    r.add_argument("spec", nargs="?", help="campaign spec JSON file")
    r.add_argument("--edition-study", nargs="+", metavar="EDITION",
                   help="shorthand: longitudinal study over vendored "
                        "TOP500 sample editions (e.g. 2020_06 2020_11)")
    r.add_argument("--limit", type=int, default=0,
                   help="edition-study: top-N rows per edition")
    r.add_argument("--max-ranks", type=int, default=0,
                   help="fleet proxy-grid cap (FleetTuning.max_ranks)")
    r.add_argument("--journal", help="append one NDJSON line per run")
    r.add_argument("--strict", action="store_true",
                   help="resolution errors raise instead of isolating")
    r.add_argument("--markdown", action="store_true",
                   help="print Markdown instead of aligned text")
    r.add_argument("--device", default="cuda",
                   help="device the sweeps run on (default cuda)")
    r.set_defaults(fn=_cmd_run)

    m = sub.add_parser("merge", help="fold NDJSON journals into one")
    m.add_argument("journals", nargs="+")
    m.add_argument("--out", required=True, help="merged NDJSON path")
    m.add_argument("--strict", action="store_true",
                   help="corrupt journal lines raise instead of skip")
    m.set_defaults(fn=_cmd_merge)

    rp = sub.add_parser("report", help="render journals as a report")
    rp.add_argument("journals", nargs="+")
    rp.add_argument("--json", help="write the report dict as JSON")
    rp.add_argument("--csv", help="write one CSV row per run")
    rp.add_argument("--md", help="write the Markdown report")
    rp.add_argument("--top", type=int, default=20,
                    help="rows per ranked table")
    rp.add_argument("--strict", action="store_true",
                    help="corrupt journal lines raise instead of skip")
    rp.add_argument("--markdown", action="store_true",
                    help="print Markdown instead of aligned text")
    rp.set_defaults(fn=_cmd_report)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
