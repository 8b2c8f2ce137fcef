"""Lazy builds of the port's shared libraries.

Libraries go to ``build/autobzcore_torch/`` at the repository root (listed
in ``.gitignore``), are rebuilt when a source is newer than the library, and
are written under a temporary name and renamed into place, so concurrent
processes never load a half-written file.
"""
from __future__ import annotations

import os
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR.parent / "build" / "autobzcore_torch"


def is_stale(out: Path, sources) -> bool:
    if not out.exists():
        return True
    t = out.stat().st_mtime
    return any(Path(s).stat().st_mtime > t for s in sources)


def build_shared(cmd_prefix, sources, out: Path, timeout=600):
    """Run ``cmd_prefix + sources + ['-o', tmp]`` and rename ``tmp`` to
    ``out``. Raises ``RuntimeError`` with the compiler's output on failure."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = list(cmd_prefix) + [str(s) for s in sources] + ["-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
        if r.returncode != 0:
            raise RuntimeError(f"build failed ({' '.join(cmd)}):\n{r.stdout}\n{r.stderr}")
        os.replace(tmp, out)
        return r.stdout + r.stderr
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
