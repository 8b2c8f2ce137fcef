"""Contracts of the port as a package: it never imports JAX, its entry
points run on the CPU when asked to, and ``chip_smoke.py`` refuses to run
without a card."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "autobzcore_torch"
ENV = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")


def _run(args, cwd, timeout=240):
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          timeout=timeout, env=ENV, cwd=cwd)


def test_import_leaves_jax_out():
    modules = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                     for p in PACKAGE.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'autobzcore_tpu'))]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = _run(["-c", code], cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in PACKAGE.rglob("*.py"))
                         + ["chip_smoke.py", "examples/aps_example_torch.py", "tools/kernel_ab.py",
                            "tools/kernel_variants.py"])
def test_no_source_imports_jax(path):
    """Also the imports inside functions, which an import test cannot see."""
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "autobzcore_tpu"), (path, name)


def test_example_runs_flagship_on_cpu(tmp_path):
    out = _run([str(REPO / "examples" / "aps_example_torch.py"), "--flagship", "--device", "cpu",
                "--npt", "6", "--eta", "0.3", "--out", str(tmp_path / "dos.npz")],
               cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "PTR(npt=6) interpolant" in out.stderr
    assert out.stdout.startswith("PTR DOS(0.5 eV) = ")
    assert (tmp_path / "dos.npz").exists()


def test_example_runs_cold_iai_leg_on_cpu(tmp_path):
    """The IAI leg, warm by default and cold with --cold-iai; an omega block
    that does not divide the chunk is refused as the reference refuses it
    (the blocked leg runs in test_torch_iai_block.py)."""
    args = [str(REPO / "examples" / "aps_example_torch.py"), "--flagship", "--device", "cpu",
            "--skip-ptr", "--with-iai", "--eta", "0.5", "--abstol", "1.0", "--iai-inner-cap", "16",
            "--atol-interp", "5"]
    for extra, tier in (([], "warm"), (["--cold-iai"], "cold")):
        out = _run(args + extra, cwd=tmp_path)
        assert out.returncode == 0, out.stderr[-2000:]
        assert f"IAI interpolant ({tier}, complex128)" in out.stderr and "retcode True" in out.stderr
        assert out.stdout.startswith("IAI DOS(0.5 eV) = ")
        assert ("IAI chunk seeds: " in out.stderr) == (tier == "warm")
    blocked = _run(args + ["--iai-block", "2"], cwd=tmp_path)
    assert blocked.returncode != 0 and "must divide into blocks of 2" in blocked.stderr


def test_example_runs_fullgrid_leg_on_cpu(tmp_path):
    out = _run([str(REPO / "examples" / "aps_example_torch.py"), "--flagship", "--device", "cpu",
                "--skip-ptr", "--with-fullgrid", "--eta", "0.5", "--abstol", "1e-3", "--fullgrid-nmin", "8",
                "--fullgrid-nmax", "32", "--fullgrid-omegas", "40", "--out", str(tmp_path / "dos.npz")],
               cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "fullgrid ladder (40 omegas, abstol=0.001)" in out.stderr and "retcode True" in out.stderr
    assert out.stdout.startswith("fullgrid DOS(")
    saved = np.load(tmp_path / "dos.npz")
    assert saved["dos_fullgrid"].shape == (40,) and np.all(np.isfinite(saved["dos_fullgrid"]))


def _assert_refused(out):
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert not lines or '"ok"' not in lines[-1]
    for line in lines:
        if line.startswith("{"):
            assert not json.loads(line).get("ok")


def test_chip_smoke_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card; chip_smoke.py would run")
    _assert_refused(_run([str(REPO / "chip_smoke.py")], cwd=REPO))


def test_chip_smoke_refuses_without_the_package(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    _assert_refused(_run(["chip_smoke.py"], cwd=tmp_path))


@pytest.mark.parametrize("source", ["fourier_points", "transport_gamma"])
def test_kernel_variants_patch_the_current_source(source):
    """Every variant of ``tools/kernel_variants.py`` is a text patch that
    still applies to the package's source, and changes it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("kernel_variants", REPO / "tools" / "kernel_variants.py")
    kv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kv)
    text = (PACKAGE / "csrc" / f"{source}.cu").read_text()
    variants = kv.SOURCES[source][0](text)
    assert variants and all(v != text for v in variants.values())


@pytest.mark.parametrize("args", [["tree", "label"], ["tree", "label", "--phases", "k19"],
                                  ["tree", "--phases", "fourier"]])
def test_kernel_ab_refuses_bad_arguments(args):
    """``tools/kernel_ab.py`` prints its usage and runs nothing without a
    tree, a label and a known group of phases."""
    out = _run([str(REPO / "tools" / "kernel_ab.py"), *args], cwd=REPO, timeout=60)
    assert out.returncode != 0 and "--phases fourier|rule_transport" in out.stderr
