"""The package's former import name still works: each of its submodules is
the very module object of ``bignn.<sub>``, and ``python -m <former>.run``
runs the CLI."""

import importlib
import os
import pathlib
import subprocess
import sys

import pytest

import bignn

ROOT = pathlib.Path(__file__).resolve().parent.parent
ALIASES = sorted(p.name for p in ROOT.iterdir()
                 if p.name.startswith("bignn_") and (p / "__init__.py").is_file())


def test_one_alias_package():
    assert len(ALIASES) == 1


@pytest.mark.parametrize("sub", ["models.bignn", "train", "ops.spmm", "run"])
def test_alias_submodule_is_the_same_module(sub):
    old = importlib.import_module(f"{ALIASES[0]}.{sub}")
    new = importlib.import_module(f"bignn.{sub}")
    assert old is new
    assert new.__spec__.name == f"bignn.{sub}"
    assert importlib.import_module(ALIASES[0]).__version__ == bignn.__version__


def test_alias_runs_the_cli():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", f"{ALIASES[0]}.run", "--help"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "--config" in r.stdout
