"""The port stands alone: importing every module of
``tilelang_mesh_tpu_torch`` (and ``chip_smoke.py``) pulls in neither JAX
nor the JAX package, and nothing is built at import time. Checked in a
fresh interpreter, since the test process itself imports both."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import tilelang_mesh_tpu_torch as P
mods = sorted(m.name for m in pkgutil.walk_packages(P.__path__,
                                                    P.__name__ + "."))
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tilelang_mesh_tpu"))
assert not bad, bad
from tilelang_mesh_tpu_torch.ops import _build
assert not _build._libs, "a kernel library was loaded at import time"
print(len(mods))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_neither_jax_nor_the_jax_package():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 33


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No card: non-zero exit and no result line, from the checkout and
    from a directory holding chip_smoke.py alone."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        env = _env()
        if cwd == tmp_path:
            env.pop("PYTHONPATH")
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
