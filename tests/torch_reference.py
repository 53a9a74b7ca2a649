"""Run a snippet of the JAX reference package in a child interpreter.

Installed jax no longer has ``jax.experimental.enable_x64``, which the
reference imports, so the child aliases it to ``jax.enable_x64`` before
the snippet imports ``repro``; the alias never touches the pytest
process.  The snippet reads its JSON payload from ``PAYLOAD`` and puts
its answer (plain JSON data) in ``OUT``.  Floats round-trip through
JSON exactly.
"""
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = r"""
import json, sys
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
PAYLOAD = json.loads(sys.stdin.read())
OUT = {}
"""

_EPILOGUE = r"""
print(json.dumps(OUT))
"""


def run_reference(code: str, payload=None, timeout: int = 600) -> dict:
    """``OUT`` of ``code`` run against ``repro`` on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p])
    proc = subprocess.run(
        [sys.executable, "-c", _PRELUDE + code + _EPILOGUE],
        input=json.dumps(payload), capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def assert_close(got, want, rtol=1e-12, path="$"):
    """``got == want`` apart from floats, which agree within ``rtol``
    relative (NaN matches NaN)."""
    if isinstance(want, float) and isinstance(got, float):
        if got == want or (math.isnan(got) and math.isnan(want)):
            return
        assert abs(got - want) <= rtol * max(abs(got), abs(want)), \
            (path, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), \
            (path, sorted(got), sorted(want))
        for k in want:
            assert_close(got[k], want[k], rtol, f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, rtol, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)
