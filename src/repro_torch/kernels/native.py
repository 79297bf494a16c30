"""Build, load and call the port's hand-written CUDA kernels.

The sources in ``repro_torch/csrc/`` have a plain C interface (no PyTorch
headers), so each compiles in seconds.  At first use every source goes to
its own ``nvcc`` (all started together) for ``sm_90a``; the objects are
linked into one shared library under ``build/kernels/`` at the root of the
checkout, named by a hash of the sources and flags, and loaded with
``ctypes``.  A failed build or a launch that returns a CUDA error raises.

Each kernel's wrapper keeps a :class:`LaunchCounter` that moves only where
the wrapper launches its kernel, so a run can show that its main path went
through the kernels and not through their plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("overlay_patch.cu", "flash_attention.cu", "decode_attention.cu", "ssd_scan.cu",
           "moe_experts.cu")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the entry points (see each source's extern "C" block)
_SIGNATURES = {
    "rt_overlay_patch": [_P, _P, _P, _P, _P, _L, _L, _L, _P],
    "rt_flash_attention": [_I, _P, _P, _P, _P, *[_L] * 12, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "rt_decode_attention": [
        _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ],
    "rt_ssd_scan": [_I, *[_P] * 8, *[_L] * 12, _I, _I, _I, _I, _I, _I, _P],
    "rt_moe_experts": [*[_P] * 10, _I, _I, _I, _I, _P],
}


# the head dims the attention kernels (K2, K3) are compiled for; above the
# last, each has a generic instance that takes the head dim at run time
ATTENTION_HEAD_DIMS = (64, 128, 192, 256)
SMEM_MAX = 232448  # the shared memory one block can have on sm_90 (227 KB)
# bytes of the generic instance's shared memory at head dim hd: its
# generic_smem_floats in csrc/flash_attention.cu and csrc/decode_attention.cu
# (K2: q and k chunks of 256 padded to 257, P, the rescales, a 16-row
# accumulator; K3: the query row, the accumulator, two 32-slot weight rows)
GENERIC_SMEM_BYTES = {
    "flash_attention": lambda hd: 4 * (16 * 257 + 32 * 257 + 16 * 32 + 16 + 16 * hd),
    "decode_attention": lambda hd: 4 * (2 * hd + 2 * 32 + 1),
}


def padded_head_dim(what: str, hd: int) -> int:
    """The head dim attention kernel ``what`` (``"flash_attention"`` or
    ``"decode_attention"``) runs head dim ``hd`` at: up to 256 the least of
    :data:`ATTENTION_HEAD_DIMS` not below it (the wrapper zero-pads the
    rest); above 256 ``hd`` itself, on the generic instance.  Raises
    ``ValueError`` for hd < 1 and for an hd whose generic instance needs
    more than one block's shared memory (:data:`SMEM_MAX`)."""
    if hd < 1:
        raise ValueError(f"{what}: head dim {hd} is not positive")
    for d in ATTENTION_HEAD_DIMS:
        if hd <= d:
            return d
    need = GENERIC_SMEM_BYTES[what](hd)
    if need > SMEM_MAX:
        raise ValueError(
            f"{what}: head dim {hd} needs {need} bytes of shared memory in the generic "
            f"instance, past the {SMEM_MAX} bytes (227 KB) one block can have on sm_90")
    return hd


class LaunchCounter:
    """A plain integer count of one kernel's launches (thread-safe)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        self._lock.acquire()  # cheaper than the context manager, per launch
        self.count += 1
        self._lock.release()

    def reset(self) -> None:
        with self._lock:
            self.count = 0


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return h.hexdigest()[:16]


class _Build:
    lock = threading.Lock()
    lib: Optional[ctypes.CDLL] = None
    path: Optional[Path] = None
    seconds = 0.0
    log = ""


def build() -> Path:
    """Compile the kernels (if this source set was not built before) and
    return the shared library's path.  Raises on any compiler error."""
    so = BUILD_DIR / f"librepro_kernels_{_digest()}.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:  # one nvcc per source, all started together
            obj = os.path.join(tmp, src.replace(".cu", ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        logs: List[str] = []
        failed = []
        for src, _obj, p in procs:
            out, _ = p.communicate()
            logs.append(f"--- {src}\n{out}")
            if p.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(
                f"nvcc failed for {failed}:\n" + "\n".join(logs)
            )
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, "-shared", "-o", tmp_so, *[o for _s, o, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        # the compiler's report beside the library, for a later process
        so.with_suffix(".log").write_text("\n".join(logs))
        os.replace(tmp_so, so)  # atomic: a reader never sees half a library
    _Build.seconds = time.perf_counter() - t0
    _Build.log = "\n".join(logs)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    if _Build.lib is None:
        with _Build.lock:
            if _Build.lib is None:
                path = build()
                lib = ctypes.CDLL(str(path))
                for fn, argtypes in _SIGNATURES.items():
                    f = getattr(lib, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                _Build.path = path
                _Build.lib = lib
    return _Build.lib


def build_info() -> Dict[str, object]:
    """Where the library is, how long this process spent building it (0
    when it was already built), and the compiler's per-kernel report (read
    back from beside the library when another process built it)."""
    log = _Build.log
    if not log and _Build.path is not None and _Build.path.with_suffix(".log").exists():
        log = _Build.path.with_suffix(".log").read_text()
    return {"path": str(_Build.path), "seconds": _Build.seconds, "log": log}


def launch(entry: str, dev: torch.device, *args) -> None:
    """Call the library's C entry point ``entry`` with ``args`` and, as its
    last argument, the raw handle of ``dev``'s current stream; raise on a
    CUDA error.  The stream is read on every call (``torch.cuda.stream``
    blocks, graph capture and the uploader thread each change it), by
    PyTorch's C calls, the cheapest correct reads; a device guard is
    entered only when ``dev`` is not the current device."""
    cur = torch._C._cuda_getDevice()
    idx = cur if dev.index is None else dev.index
    fn = getattr(library(), entry)
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == cur:
        err = fn(*args, stream)
    else:
        with torch.cuda.device(idx):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")


def check_inputs(what: str, *tensors: torch.Tensor) -> None:
    """Shape-independent launch preconditions shared by every wrapper."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: every input must be contiguous")
