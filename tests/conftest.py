"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches must
see the real single CPU device; multi-device tests run in subprocesses that
set --xla_force_host_platform_device_count themselves."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

# Every inline-code snippet run by ``run_subprocess_devices`` gets the repo
# on its path and MUST import JAX version-sensitive symbols (shard_map,
# compiler params, ...) through ``repro.compat`` — the spawned interpreter
# sees the same drifted JAX as the host process.
_FAILED_LINE_RE = re.compile(r'File "<string>", line (\d+)')


def _culprit_lines(code: str, stderr: str, context: int = 1) -> str:
    """Map ``File "<string>", line N`` frames in the traceback back to the
    inline source so failures show the offending snippet line, not just a
    generic assertion."""
    lines = code.splitlines()
    hits = [int(m) for m in _FAILED_LINE_RE.findall(stderr)
            if 1 <= int(m) <= len(lines)]
    if not hits:
        return ""
    ln = hits[-1]                       # innermost <string> frame
    lo, hi = max(1, ln - context), min(len(lines), ln + context)
    shown = "\n".join(f"{'>' if i == ln else ' '} {i:4d} | {lines[i - 1]}"
                      for i in range(lo, hi + 1))
    return f"\nfailing inline code (line {ln}):\n{shown}"


def run_subprocess_devices(code: str, n_devices: int = 4,
                           timeout: int = 900) -> str:
    """Run ``code`` in a fresh python with n forced host devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["REPRO_PALLAS_INTERPRET"] = "1"
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(
            f"subprocess exited {out.returncode} "
            f"(n_devices={n_devices}, REPRO_PALLAS_INTERPRET=1)"
            f"{_culprit_lines(code, out.stderr)}\n"
            f"STDOUT:{out.stdout[-4000:]}\n"
            f"STDERR:{out.stderr[-4000:]}")
    return out.stdout


@pytest.fixture(scope="session")
def subproc():
    return run_subprocess_devices


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "multidev: spawns a multi-device subprocess (skipped by "
        "scripts/verify.sh --fast)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the port's hand-written kernels); skips "
        "inside the test when none is present")


def pytest_collection_modifyitems(config, items):
    """Every test that uses the ``subproc`` fixture is a multi-device
    subprocess sweep — auto-mark so ``verify.sh --fast`` can skip them."""
    for item in items:
        if "subproc" in getattr(item, "fixturenames", ()):
            item.add_marker(pytest.mark.multidev)
