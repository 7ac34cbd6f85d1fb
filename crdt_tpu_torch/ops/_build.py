"""Build and load the port's native libraries.

Every native library of the port is built and loaded here: the v1
codec (``csrc/v1codec.cc``, a CPython extension, ``g++``), the kvlog
store and the transport (the shared ``native/*/*.cc``, ``g++``, bound
with ``ctypes``) and the four CUDA kernels (``csrc/*.cu``, each with a
plain C interface, ``nvcc -gencode arch=compute_90a,code=sm_90a``,
bound with ``ctypes``). Each lands in its own directory under the
gitignored ``crdt_tpu_torch/build/``, never in ``native/build/``.

A library's file name is ``lib<name>-<hash>.so``: the hash covers its
source, the headers beside it that it includes, its compiler and its
flags, so an edited source, header or flag never loads a stale build.
The compiler writes a temporary file named for its process and thread,
which ``os.replace`` publishes; it runs outside any lock, so racing
first builds each write their own file. Only the table of loaded
libraries is taken under the lock, and a loaded library is returned
without it. :func:`build` starts one compiler per source, all at once,
and waits for them together. A failed build or load raises the
recipe's error class: ``RuntimeError`` for the host libraries,
:class:`KernelError` for the kernels, where nothing falls back to the
plain version. A missing compiler raises at first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from functools import partial
from pathlib import Path
from typing import Callable, Dict, NamedTuple, Sequence, Tuple, TypeVar

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build" / "kernels"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-Wall")

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


class Recipe(NamedTuple):
    """How one library is built."""

    name: str                # the file is lib<name>-<hash>.so
    src: Path
    out_dir: Path
    flags: Tuple[str, ...]
    headers: str = ""        # glob beside ``src`` of the headers it includes
    compiler: str = "g++"    # "nvcc" resolves through :func:`nvcc_path`
    error: type = RuntimeError


class Built(NamedTuple):
    path: Path  # the shared library
    log: str    # the compiler's output (ptxas resource usage with -Xptxas -v)


T = TypeVar("T")

_lock = threading.Lock()
_loaded: Dict[str, object] = {}


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


def target(r: Recipe) -> Path:
    """The library's path: its name and a hash of what builds it."""
    h = hashlib.sha1("\0".join((r.compiler, *r.flags)).encode())
    headers = sorted(r.src.parent.glob(r.headers)) if r.headers else []
    for src in [r.src, *headers]:
        h.update(b"\0" + src.name.encode() + b"\0" + src.read_bytes())
    return r.out_dir / f"lib{r.name}-{h.hexdigest()[:12]}.so"


def build(recipes: Sequence[Recipe]) -> Dict[str, Built]:
    """Compile each recipe's library unless it is already built, one
    compiler process per source, started together. Raises the first
    failed recipe's error class, naming every failed build."""
    done: Dict[str, Built] = {}
    procs = {}
    errors = []
    for r in recipes:
        out = target(r)
        if out.exists():
            done[r.name] = Built(out, "")
            continue
        r.out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(
            f".so.tmp.{os.getpid()}.{threading.get_ident()}")
        compiler = nvcc_path() if r.compiler == "nvcc" else r.compiler
        cmd = [compiler, *r.flags, "-o", str(tmp), str(r.src)]
        try:
            procs[r.name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            ), r, tmp, out, cmd)
        except OSError as e:
            errors.append((r, f"{' '.join(cmd)}: {e}"))
    for name, (proc, r, tmp, out, cmd) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append((r, f"{' '.join(cmd)}\n{log}"))
            continue
        os.replace(tmp, out)
        done[name] = Built(out, log)
    if errors:
        raise errors[0][0].error("native build failed:\n" + "\n".join(
            f"lib{r.name}: {text}" for r, text in errors))
    return done


def load(r: Recipe, bind: Callable[[Path], T]) -> T:
    """The library of ``r``, built at first use and handed once to
    ``bind`` (its path in, the loaded and signature-bound library out).
    An ``OSError`` from ``bind`` raises the recipe's error class."""
    lib = _loaded.get(r.name)
    if lib is not None:
        return lib
    path = build([r])[r.name].path
    with _lock:
        lib = _loaded.get(r.name)
        if lib is None:
            try:
                lib = _loaded[r.name] = bind(path)
            except OSError as e:
                raise r.error(f"cannot load {path}: {e}") from e
    return lib


def _recipe(name: str) -> Recipe:
    return Recipe(name, CSRC / KERNELS[name][0], BUILD_DIR, NVCC_FLAGS,
                  headers="*.cuh", compiler="nvcc", error=KernelError)


def build_all(names=None) -> Dict[str, Built]:
    """Compile the named kernels (default: all) together. Reuses a
    library already built from the same source. Raises KernelError
    naming every failed build."""
    return build([_recipe(n) for n in (KERNELS if names is None else names)])


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in KERNELS[name][1].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = list(argtypes)
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded, signature-bound library of one kernel (built at
    first use)."""
    lib = _loaded.get(name)
    return lib if lib is not None else load(_recipe(name),
                                            partial(_bind, name))


def check(code: int, what: str) -> None:
    """Raise when a launch entry point reports a CUDA error."""
    if code != 0:
        raise KernelError(f"{what}: CUDA error {code}")
