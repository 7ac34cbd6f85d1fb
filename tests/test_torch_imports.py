"""The port stands alone: no file of ``crdt_tpu_torch/`` nor
``chip_smoke.py`` imports ``jax`` or the reference package, and the
port imports and replays with both blocked."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    p.relative_to(ROOT).as_posix()
    for p in (ROOT / "crdt_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "crdt_tpu", "bench")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_files_found():
    assert "crdt_tpu_torch/__init__.py" in PORT_FILES
    assert "crdt_tpu_torch/ops/kernels.py" in PORT_FILES
    assert len(PORT_FILES) > 15


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_reference_or_jax_import(rel):
    bad = [
        mod for mod in _imported_modules(ROOT / rel)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"{rel} imports {bad}"


def test_imports_and_replays_with_jax_blocked():
    # a fresh interpreter in which `import jax` and `import crdt_tpu`
    # fail: the whole port must import, build and load its own native
    # codec, and run a CPU replay
    code = (
        "import sys\n"
        "for m in list(sys.modules):\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'crdt_tpu'):\n"
        "        del sys.modules[m]\n"
        "for m in ('jax', 'jaxlib', 'crdt_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import pkgutil, importlib, crdt_tpu_torch\n"
        "for mod in pkgutil.walk_packages(crdt_tpu_torch.__path__,\n"
        "                                 'crdt_tpu_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "import chip_smoke\n"
        "from crdt_tpu_torch.codec import native\n"
        "assert native.available(), native._build_error\n"
        "from crdt_tpu_torch.models.traces import build_trace\n"
        "r = crdt_tpu_torch.replay_trace(build_trace(4, 6), device='cpu')\n"
        "assert r.n_ops == 24 and r.snapshot\n"
        "assert not [m for m in sys.modules\n"
        "            if m.split('.')[0] in ('jax', 'crdt_tpu')\n"
        "            and sys.modules[m] is not None]\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
