"""Build the CUDA sources into shared libraries and bind them with ctypes.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` (all of them
started together) for ``sm_90a`` into ``build/repro_torch/`` at the root
of the checkout, as a library with a plain C interface. Nothing includes
PyTorch's headers, so a build takes seconds. A library's file name
carries a digest of its sources and flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. Nothing is built or imported at
module import: the first kernel call (or :func:`build_all`) builds.

Every C entry point returns the ``cudaGetLastError()`` of its launches;
:func:`check` raises on anything but 0.

The cost count (``launch.op_cost.counting``) is held here, where every
wrapper reads it: :func:`counting_target` is the device a meta tensor
stands for ("cuda" or "cpu"; None outside a count) and
:func:`record_cost` adds a kernel's ``cost(...)`` to the active count.
The count is process-wide, not a context variable: the autograd engine
runs a CUDA backward, and with it the forward a checkpointed layer
recomputes (B2 included), on a device thread of its own.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("vrmom", "flash_attention", "decode_attention")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMMON_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-lineinfo", "-Xptxas", "-v")
# The aggregation kernels keep every multiply and add separately rounded,
# like the plain version's one-op-at-a-time arithmetic, so the two agree
# bit for bit (no fused multiply-add contraction).
EXTRA_FLAGS = {"vrmom": ("--fmad=false",)}

_LIBS: Dict[str, ctypes.CDLL] = {}
_COUNT = None   # the active launch.op_cost.OpCost, or None


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _flags(name: str) -> list:
    return [*ARCH_FLAGS, *COMMON_FLAGS, *EXTRA_FLAGS.get(name, ())]


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all at once.

    Returns the wall seconds each build took (0.0 for a library that was
    already built). The compiler's report (registers, shared memory,
    spills from ``-Xptxas -v``) is kept beside each library as ``.log``.
    """
    from time import sleep

    from ..obs.metrics import now

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc_path(), *_flags(name), "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       log, tmp, out, now())
    seconds = {name: 0.0 for name in names}
    failed = []
    pending = dict(procs)
    while pending:
        for name, (proc, log, tmp, out, t0) in list(pending.items()):
            rc = proc.poll()
            if rc is None:
                continue
            del pending[name]
            seconds[name] = now() - t0
            log.close()
            if rc != 0:
                failed.append(f"{name}: nvcc exit {rc}\n"
                              + out.with_suffix(".log").read_text()[-4000:])
            else:
                os.replace(tmp, out)
        if pending:
            sleep(0.05)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The built library ``name`` with ``argtypes``/``restype`` declared for
    each entry point in ``signatures`` (building it first if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def count_launch(fn) -> None:
    """Add one to ``fn.launches`` for a kernel launched now. A launch made
    while a CUDA graph is being captured on the current stream only
    records the kernel, and a replay of the graph runs it without calling
    the wrapper, so neither is counted here: the counts are the eager
    launches, and a replay's kernels are read from a profiler trace."""
    import torch

    if not torch.cuda.is_current_stream_capturing():
        fn.launches += 1


def active_count():
    """The active cost count (a ``launch.op_cost.OpCost``), or None."""
    return _COUNT


def set_count(count):
    """Make ``count`` the active cost count; returns the one it replaces."""
    global _COUNT
    prev, _COUNT = _COUNT, count
    return prev


def counting_target():
    """The device a meta tensor stands for inside
    ``launch.op_cost.counting`` ("cuda" or "cpu"); None outside a count."""
    return None if _COUNT is None else _COUNT.target


def record_cost(name: str, flops: float, nbytes: float) -> None:
    """Add one call of kernel ``name`` (its ``cost(...)``) to the active
    count, if there is one."""
    if _COUNT is not None:
        _COUNT.add_kernel(name, flops, nbytes)


def device_kind(device, what: str) -> str:
    """The kind of device a tensor on ``device`` runs on: its own ("cpu",
    "cuda", ...), or for the meta device the count's target. A meta tensor
    outside ``launch.op_cost.counting`` raises, as any device but cpu and
    cuda does: meta computes nothing, so there is no fallback to run."""
    kind = device.type
    if kind != "meta":
        return kind
    target = counting_target()
    if target is None:
        raise ValueError(f"{what}: tensor on {device} (a meta tensor is "
                         f"taken only inside launch.op_cost.counting)")
    return target


def stream_handle(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float
