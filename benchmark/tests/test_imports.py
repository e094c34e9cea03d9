"""The import check: no module the harness or its reference loads, and
none a whole run loads, has the top-level name jax, jaxlib or
avatarcap_tpu (compared whole: avatarcap_tpu_torch is the program); and
the reference loads nothing of the program."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "avatarcap_tpu"}

_LOADED = """
import importlib, json, pkgutil, sys
import benchmark, benchmark.{pkg}
for m in pkgutil.walk_packages(benchmark.{pkg}.__path__, 'benchmark.{pkg}.'):
    if '.tests' not in m.name:
        importlib.import_module(m.name)
{extra}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(pkg: str, extra: str = "") -> set:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _LOADED.format(
        pkg=pkg, extra=extra)], cwd=REPO, env=env, capture_output=True,
        text=True, check=True, timeout=600).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_program():
    names = _top_level("reference")
    assert not names & FORBIDDEN
    assert "avatarcap_tpu_torch" not in names


def test_harness_loads_no_jax():
    names = _top_level("loops", "import benchmark.run, benchmark.metrics\n"
                       "for m in pkgutil.walk_packages(benchmark.metrics"
                       ".__path__, 'benchmark.metrics.'):\n"
                       "    importlib.import_module(m.name)")
    assert not names & FORBIDDEN


def test_a_whole_run_loads_no_jax():
    names = _top_level("loops", """
import torch
torch.set_num_threads(4)
from benchmark import run as R
from benchmark.tests.small import SPEC, small_cfg
R.run_cell(SPEC, 'sdf.train_b4', 3, 0.5, False, 'cpu',
           cfg_override=small_cfg('sdf.train_b4'))
""")
    assert "avatarcap_tpu_torch" in names
    assert not names & FORBIDDEN
