"""``python -m repro_torch.serve`` — serving-side operational commands.

``warm`` builds the sweep buckets a (workload, platform) traffic mix
will need, so the first real wave served by a fresh process pays zero
compiles::

    python -m repro_torch.serve warm --workloads hpl,transformer \\
        --platforms frontera,pupmaya --count 32 --json

``--count`` replicates each (workload, platform) cell so the warm
dispatch is padded to the same power-of-two lane count the real waves
will use (the compile counters are keyed on the padded batch shape —
warm with the wave size you expect to serve).  ``--device`` names the
device the sweeps run on (default ``cuda``; ``cpu`` runs without a
card).
"""
from __future__ import annotations

import argparse
import json
import sys


def _csv(text: str):
    return [t for t in (s.strip() for s in text.split(",")) if t]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("warm", help="build the sweep buckets for a "
                                    "(workload, platform) grid")
    w.add_argument("--workloads", default="hpl",
                   help="comma-separated workload kind names (default hpl)")
    w.add_argument("--platforms", required=True,
                   help="comma-separated registered platform names")
    w.add_argument("--count", type=int, default=1,
                   help="scenarios per (workload, platform) cell — match "
                        "the wave size you expect to serve")
    w.add_argument("--shard", action="store_true",
                   help="warm the device-sharded dispatch path")
    w.add_argument("--device", default="cuda",
                   help="device the sweeps run on (default cuda)")
    w.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the warm report as one JSON line")
    args = ap.parse_args(argv)

    if args.cmd == "warm":
        from repro_torch.serve import warm
        report = warm(_csv(args.workloads), _csv(args.platforms),
                      count=args.count, shard=args.shard,
                      device=args.device)
        if args.as_json:
            print(json.dumps(report, sort_keys=True))
        else:
            print(f"warmed {report['scenarios']} scenarios in "
                  f"{report['dispatches']} dispatches "
                  f"({report['compiles']} compiles)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
