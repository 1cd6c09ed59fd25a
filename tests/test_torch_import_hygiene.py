"""The port imports neither JAX nor anything of the JAX package."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)           # defines main(), does not run it
assert callable(mod.main)
bad = sorted(m for m, mod in sys.modules.items()
             if mod is not None and m.split(".")[0] in ("jax", "repro"))
assert not bad, bad
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax_or_repro():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT / "chip_smoke.py")],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20     # every module was imported


def test_no_source_of_the_port_names_jax_or_repro():
    srcs = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    srcs.append(ROOT / "chip_smoke.py")
    for path in srcs:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                mod = stripped.split()[1]
                assert mod.split(".")[0] not in ("jax", "repro", "jaxlib"), \
                    f"{path}: {line}"
