"""repro_torch.campaign — declarative fleet studies over the prediction
stack (the port of ``repro.campaign``).

One frozen ``CampaignSpec`` names a study (workloads x platforms x
sweep axes x fault scenarios x seeds); ``expand`` turns it into a
deterministic run matrix; ``run_campaign`` serves the whole matrix
through the batched engines (one compiled sweep per workload family
for grid cells, one forced-bucket compile per TOP500 edition for
fleets) and journals one NDJSON manifest line per run; the report
module merges journals with the metrics monoid and renders ranked +
edition-drift reports.  ``python -m repro_torch.campaign`` is the CLI
(``run`` / ``merge`` / ``report``).  The sweeps run on ``device=``
(default ``"cuda"``); expansion, journals and reports are host Python.

Quickstart::

    from repro_torch.campaign import CampaignSpec, run_campaign

    spec = CampaignSpec.make(
        "what-if", workloads=["hpl", "transformer"],
        platforms=["tpu-v5e-pod", "syn-torus-fugaku-4k"],
        seeds=[0, 1])
    result = run_campaign(spec, journal="runs.ndjson", device="cuda")
"""
from .spec import (CAMPAIGN_VERSION, Budget, CampaignSpec,
                   PlatformSelector)
from .matrix import RunCase, RunMatrix, expand, machine_key
from .exec import CampaignResult, dispatch_counts, run_campaign
from .report import (campaign_report, edition_drift, load_journal,
                     merge_journals, render_markdown, render_text,
                     render_report, write_csv, write_journal)
from .cli import edition_study_spec, main

__all__ = [
    "CAMPAIGN_VERSION", "Budget", "CampaignSpec", "PlatformSelector",
    "RunCase", "RunMatrix", "expand", "machine_key",
    "CampaignResult", "dispatch_counts", "run_campaign",
    "campaign_report", "edition_drift", "load_journal",
    "merge_journals", "render_markdown", "render_text", "render_report",
    "write_csv", "write_journal",
    "edition_study_spec", "main",
]
