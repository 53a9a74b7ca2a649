"""TOP500 list rows: versioned schema + a tolerant CSV/TSV parser.

The TOP500 site exports lists as CSV (older lists as TSV / Excel dumps)
whose headers drift across editions — "Rmax" vs "Rmax [TFlop/s]",
"Computer" vs "System Name", "Total Cores" vs "Cores".  This module
normalizes all of that into one frozen ``Top500Row`` with an explicit
``schema_version`` so downstream inference can evolve without silently
reinterpreting old dumps.

Only the columns the prediction pipeline consumes are modeled; anything
else in the file is ignored.  Numbers may carry thousands separators
("2,414,592") — TOP500 exports do.
"""
from __future__ import annotations

import csv
import dataclasses
import io
import os
import re
from typing import Dict, List, Optional, Tuple, Union

ROW_SCHEMA_VERSION = 1

# normalized header (lowercased, alphanumerics only) -> field name;
# every alias observed across list editions maps to one schema field.
_HEADER_ALIASES: Dict[str, str] = {
    "rank": "rank",
    "site": "site",
    "system": "system",
    "systemname": "system",
    "name": "system",
    "computer": "system",
    "country": "country",
    "year": "year",
    "totalcores": "cores",
    "cores": "cores",
    "acceleratorcoprocessorcores": "accel_cores",
    "acceleratorcores": "accel_cores",
    "coprocessorcores": "accel_cores",
    "rmaxtflops": "rmax_tflops",
    "rmax": "rmax_tflops",
    "rmaxgflops": "rmax_gflops",          # pre-2022 lists are in GFlop/s
    "rpeaktflops": "rpeak_tflops",
    "rpeak": "rpeak_tflops",
    "rpeakgflops": "rpeak_gflops",
    "powerkw": "power_kw",
    "power": "power_kw",
    "processor": "processor",
    "processortechnology": "processor",
    "acceleratorcoprocessor": "accelerator",
    "accelerator": "accelerator",
    "interconnect": "interconnect",
    "interconnectfamily": "interconnect",
    "nmax": "nmax",
    "nhalf": "nhalf",
}

_REQUIRED = ("rank", "processor", "cores", "interconnect",
             "rmax_tflops", "rpeak_tflops")


@dataclasses.dataclass(frozen=True)
class Top500Row:
    """One list entry, normalized.  ``schema_version`` stamps the layout
    this row was parsed under (see ``ROW_SCHEMA_VERSION``)."""
    rank: int
    site: str
    system: str
    processor: str               # e.g. "Xeon Platinum 8280 28C 2.7GHz"
    cores: int                   # total cores as listed (CPU + accel)
    interconnect: str            # e.g. "Mellanox InfiniBand HDR"
    rmax_tflops: float
    rpeak_tflops: float
    accel_cores: int = 0         # accelerator/co-processor cores subset
    accelerator: str = ""        # e.g. "NVIDIA Tesla V100"
    country: str = ""
    year: int = 0
    power_kw: float = 0.0
    nmax: int = 0                # published HPL Nmax when the list has it
    schema_version: int = ROW_SCHEMA_VERSION

    @property
    def cpu_cores(self) -> int:
        """Host-CPU cores: listed total minus the accelerator subset."""
        return max(self.cores - self.accel_cores, 0)

    @property
    def efficiency(self) -> float:
        """Published HPL efficiency Rmax / Rpeak."""
        return self.rmax_tflops / self.rpeak_tflops


@dataclasses.dataclass
class ParseReport:
    """What ``parse_top500`` accepted and what it skipped (lenient mode)."""
    rows: List[Top500Row]
    skipped: List[Tuple[int, str]]   # (1-based data line, reason)


def _norm_header(h: str) -> str:
    return re.sub(r"[^a-z0-9]", "", h.lower())


def _num(text: str) -> float:
    return float(text.replace(",", "").replace(" ", "") or 0)


def _sniff_delimiter(header_line: str) -> str:
    return "\t" if header_line.count("\t") >= header_line.count(",") \
        and "\t" in header_line else ","


def _row_from_record(rec: Dict[str, str]) -> Top500Row:
    missing = [f for f in _REQUIRED if f not in rec
               and not (f == "rmax_tflops" and "rmax_gflops" in rec)
               and not (f == "rpeak_tflops" and "rpeak_gflops" in rec)]
    if missing:
        raise ValueError(f"missing required column(s): {', '.join(missing)}")
    rmax = (_num(rec["rmax_tflops"]) if "rmax_tflops" in rec
            else _num(rec["rmax_gflops"]) / 1e3)
    rpeak = (_num(rec["rpeak_tflops"]) if "rpeak_tflops" in rec
             else _num(rec["rpeak_gflops"]) / 1e3)
    if rmax <= 0 or rpeak <= 0:
        raise ValueError(f"non-positive Rmax/Rpeak ({rmax}, {rpeak})")
    cores = int(_num(rec["cores"]))
    if cores <= 0:
        raise ValueError(f"non-positive core count {cores}")
    if not rec["processor"].strip():
        raise ValueError("empty processor cell")
    if not rec["interconnect"].strip():
        raise ValueError("empty interconnect cell")
    return Top500Row(
        rank=int(_num(rec["rank"])),
        site=rec.get("site", "").strip(),
        system=rec.get("system", "").strip(),
        processor=rec["processor"].strip(),
        cores=cores,
        interconnect=rec["interconnect"].strip(),
        rmax_tflops=rmax,
        rpeak_tflops=rpeak,
        accel_cores=int(_num(rec.get("accel_cores", "0") or "0")),
        accelerator=rec.get("accelerator", "").strip(),
        country=rec.get("country", "").strip(),
        year=int(_num(rec.get("year", "0") or "0")),
        power_kw=_num(rec.get("power_kw", "0") or "0"),
        nmax=int(_num(rec.get("nmax", "0") or "0")))


def parse_top500(source: Union[str, os.PathLike], *,
                 strict: bool = False) -> ParseReport:
    """Parse a TOP500 list export (CSV or TSV) into ``Top500Row``s.

    ``source`` is a path, or the raw text itself when it contains a
    newline.  Headers are normalized through the alias table; the
    delimiter is sniffed from the header line.  In lenient mode
    (default) malformed data rows are collected into ``report.skipped``
    with a reason; ``strict=True`` raises on the first bad row.  A
    missing *required column* in the header always raises.
    """
    text = str(source)
    if "\n" not in text:
        with open(source, "r", encoding="utf-8") as fh:
            text = fh.read()
    lines = text.lstrip("﻿").splitlines()
    if not lines:
        raise ValueError("parse_top500: empty input")
    delim = _sniff_delimiter(lines[0])
    reader = csv.reader(io.StringIO(text.lstrip("﻿")), delimiter=delim)
    try:
        raw_header = next(reader)
    except StopIteration:
        raise ValueError("parse_top500: empty input") from None
    fields: List[Optional[str]] = [
        _HEADER_ALIASES.get(_norm_header(h)) for h in raw_header]
    present = {f for f in fields if f}
    missing = [f for f in _REQUIRED if f not in present
               and not (f == "rmax_tflops" and "rmax_gflops" in present)
               and not (f == "rpeak_tflops" and "rpeak_gflops" in present)]
    if missing:
        raise ValueError("parse_top500: header lacks required column(s): "
                         f"{', '.join(missing)} (saw: {raw_header})")

    rows: List[Top500Row] = []
    skipped: List[Tuple[int, str]] = []
    for lineno, cells in enumerate(reader, start=1):
        if not any(c.strip() for c in cells):
            continue
        rec = {f: c for f, c in zip(fields, cells) if f}
        try:
            rows.append(_row_from_record(rec))
        except (ValueError, KeyError) as exc:
            if strict:
                raise ValueError(
                    f"parse_top500: data row {lineno}: {exc}") from exc
            skipped.append((lineno, str(exc)))
    return ParseReport(rows=rows, skipped=skipped)


#: vendored sample list editions, oldest first (the edition-drift
#: studies of the campaign layer compare any pair of these)
SAMPLE_EDITIONS: Tuple[str, ...] = ("2020_06", "2020_11")


def list_sample_editions() -> List[str]:
    return list(SAMPLE_EDITIONS)


def sample_list_path(edition: str = "2020_06") -> str:
    """Path of a vendored ~40-50-row sample list edition (default: the
    June-2020-era list the original fleet demo used)."""
    if edition not in SAMPLE_EDITIONS:
        import difflib
        close = difflib.get_close_matches(edition, SAMPLE_EDITIONS, n=3,
                                          cutoff=0.5)
        hint = (f"did you mean: {', '.join(close)}?" if close
                else f"vendored: {', '.join(SAMPLE_EDITIONS)}")
        raise ValueError(f"unknown sample edition {edition!r}; {hint}")
    return os.path.join(os.path.dirname(__file__), "data",
                        f"top500_sample_{edition}.csv")


def load_sample(strict: bool = True,
                edition: str = "2020_06") -> List[Top500Row]:
    """A vendored sample list, parsed strictly (it must be clean)."""
    return parse_top500(sample_list_path(edition), strict=strict).rows
