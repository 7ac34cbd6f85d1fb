"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface. At first use it is
compiled by ``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` into
its own shared library under ``crdt_tpu_torch/build/kernels/`` (listed
in ``.gitignore``) and loaded with ``ctypes``. The library's file name
carries a hash of its source and of every header under ``csrc/``, so
an edited kernel or header never loads a stale build. :func:`build_all`
starts one ``nvcc`` per source, all at once, and waits for them
together. A failed build, load or launch raises :class:`KernelError`;
nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, NamedTuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build" / "kernels"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# kernel name -> (source file, {C function: (restype, argtypes)})
KERNELS: Dict[str, tuple] = {
    "seg_argmax_scan": ("seg_argmax_scan.cu", {
        "seg_argmax_scan_tile": (_I, ()),
        "seg_argmax_scan_scratch_words": (_L, (_I,)),
        "seg_argmax_scan_launch": (_I, (_P, _P, _P, _P, _I, _P)),
    }),
    "stream_scatter": ("stream_scatter.cu", {
        "stream_scatter_launch": (_I, (_P, _I, _P, _I, _P)),
    }),
    "ds_mask": ("ds_mask.cu", {
        "ds_mask_scratch_words": (_L, (_I,)),
        "ds_mask_prepare": (_I, (_P, _P, _P, _I, _P, _P)),
        "ds_mask_search": (_I, (_P, _P, _P, _I, _I, _P, _P, _P)),
    }),
    "sv_deficit": ("sv_deficit.cu", {
        "sv_deficit_launch": (_I, (_P, _I, _I, _P, _P, _P)),
    }),
}


class KernelError(Exception):
    """A hand-written kernel failed to build, load or launch. Not a
    ``RuntimeError`` on purpose: the guarded dispatch ladder
    (:mod:`crdt_tpu_torch.guard.device`) must let it through rather
    than route the work quietly to the host."""


class Built(NamedTuple):
    path: Path  # the shared library
    log: str    # nvcc's output (ptxas resource usage with -Xptxas -v)


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else
    the toolkit's default location. Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels cannot be built"
    )


def _target(name: str) -> Path:
    h = hashlib.sha1()
    for src in [CSRC / KERNELS[name][0], *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=None) -> Dict[str, Built]:
    """Compile the named kernels (default: all), one ``nvcc`` process
    per source, started together. Reuses a library already built from
    the same source. Raises KernelError naming every failed build."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    done: Dict[str, Built] = {}
    for name in names:
        out = _target(name)
        if out.exists():
            done[name] = Built(out, "")
            continue
        tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
        cmd = [
            nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(tmp), str(CSRC / KERNELS[name][0]),
        ]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ), tmp, out, cmd)
    errors = []
    for name, (proc, tmp, out, cmd) in procs.items():
        log, _ = proc.communicate()
        log = log.decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"{name}: {' '.join(cmd)}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        done[name] = Built(out, log)
    if errors:
        raise KernelError("CUDA kernel build failed:\n" + "\n".join(errors))
    return done


def library(name: str) -> ctypes.CDLL:
    """The loaded, signature-bound library of one kernel (built at
    first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        built = build_all([name])[name]
        try:
            lib = ctypes.CDLL(str(built.path))
        except OSError as e:
            raise KernelError(f"cannot load {built.path}: {e}") from e
        for fn, (restype, argtypes) in KERNELS[name][1].items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = list(argtypes)
        _libs[name] = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise when a launch entry point reports a CUDA error."""
    if code != 0:
        raise KernelError(f"{what}: CUDA error {code}")
