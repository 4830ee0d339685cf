"""The fixture of the benchmark's CPU tests: a copy of the benchmark's
folder whose cells are cut to sizes that the CPU runs in moments.

These tests are run on their own (``python -m pytest -q oocbench/tests``);
the repository's suite does not collect them.  A test module imports
:func:`tiny` to use it.

What the tests need to know of an entry point is data: ``cuts/<entry>.json``
beside this file holds

  * ``config``: the configuration keys that every configuration of that
    entry point is cut to, at which the CPU runs a call in milliseconds and
    every call is still out of core (a mix gives its operands' sizes by
    these keys, so the cut reaches them);
  * ``useful_flops``: ``equal`` or ``below``, how the reference's useful
    work compares with the work the schedules count (their ``dgemm``
    products where they have any, else their ops' flops);
  * ``fault``: where the planted faults go (``test_oocbench_faults.py``):
    ``at``, the program's function as ``module.name``; ``state``, its
    argument that holds the state the call updates; ``scale``, the argument
    that scales its contribution (or null); and optionally ``when``, the
    argument values of the calls that are planted (the others run as they
    are).

So a new entry point brings its own file, and no test changes.
"""

import json
import pathlib
import shutil

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "oocbench"
CUTS = pathlib.Path("tests") / "cuts"   # under the benchmark's folder


def _copied(folder, names):
    """What the copy leaves out: caches, and of ``tests/`` all but the
    cuts."""
    skip = [n for n in names if n == "__pycache__"]
    if pathlib.Path(folder).name == "tests":
        skip += [n for n in names if n != "cuts"]
    return skip


def cut_of(root: pathlib.Path, entry: str) -> dict:
    """The cut of ``entry`` in the benchmark under ``root``."""
    return json.loads((root / "oocbench" / CUTS / f"{entry}.json")
                      .read_text())


def cut_configs(root: pathlib.Path) -> None:
    """Cut every configuration that ``root``'s manifest names to its entry
    point's cut, in place."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(cut_of(root, cfg["entry"])["config"])
        path.write_text(json.dumps(cfg))


def tiny_root(dest: pathlib.Path) -> pathlib.Path:
    """``dest`` holding ``BENCHMARK.json`` and a copy of ``oocbench/`` whose
    configurations are cut to their entry points' cuts; the limits stay
    the cells'."""
    shutil.copytree(BENCH, dest / "oocbench", ignore=_copied)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    cut_configs(dest)
    return dest


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(tmp_path)
