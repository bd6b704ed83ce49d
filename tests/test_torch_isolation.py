"""The port stands alone: importing every module of ``dlaf_tpu_torch``
(the multi-process ``comm/multihost.py``, the telemetry package ``obs``,
the resilience modules ``health/inject.py``, ``health/registry.py``,
``health/resume.py`` and ``matrix/checkpoint.py``, the fleet tier ``fleet/``
and the merger ``obs/aggregate.py`` and the device-timeline attribution
``obs/devtrace.py`` and ``obs/critpath.py`` among them), and
``chip_smoke``,
loads no ``jax`` module and nothing of the JAX package ``dlaf_tpu``. Checked in a fresh interpreter, since the test process
itself imports both packages."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys
import dlaf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dlaf_tpu_torch.__path__, "dlaf_tpu_torch.")]
assert "dlaf_tpu_torch.comm.multihost" in names, "the multi-process module is not walked"
assert "dlaf_tpu_torch.obs.exporter" in names, "the obs package is not walked"
for new in ("health.inject", "health.registry", "health.resume", "matrix.checkpoint",
            "fleet.transport", "fleet.membership", "fleet.router", "fleet.worker",
            "obs.aggregate", "obs.devtrace", "obs.critpath"):
    assert "dlaf_tpu_torch." + new in names, new + " is not walked"
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "dlaf_tpu"
             or m.startswith("dlaf_tpu."))
print(len(names))
print(" ".join(bad))
"""


def test_port_imports_no_jax_and_no_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = (out.stdout.splitlines() + ["", ""])[:2]
    assert int(count) >= 40, f"only {count} modules found"
    assert bad == "", f"the port loaded {bad}"
