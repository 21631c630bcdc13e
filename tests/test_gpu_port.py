"""Guards on the package: it carries no Pallas kernel and no switch that
picks a kernel or a path by backend, so every user path is the same XLA
program on the GPU as in these CPU tests."""

import ast
import os

import pytest

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "smarc_navigation_tpu")


def _sources():
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(root, f)
                with open(p, encoding="utf-8") as fh:
                    yield os.path.relpath(p, PKG), fh.read()


def test_no_pallas_import():
    bad = []
    for rel, text in _sources():
        for node in ast.walk(ast.parse(text)):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                names = [mod] + [f"{mod}.{a.name}" for a in node.names]
            if any(n.startswith("jax.experimental.pallas") for n in names):
                bad.append(rel)
    assert bad == []


@pytest.mark.parametrize("needle", [
    "default_backend", "device_kind", "use_pallas", "use_da_kernel",
    "segmented", "interpret", '"pallas"',
])
def test_no_backend_switches_or_kernel_options(needle):
    hits = [rel for rel, text in _sources() if needle in text]
    assert hits == [], f"{needle!r} in {hits}"


def test_run_cli_has_no_pallas_flag():
    from smarc_navigation_tpu import run

    with pytest.raises(SystemExit):
        run.main(["pf", "--pallas"])
