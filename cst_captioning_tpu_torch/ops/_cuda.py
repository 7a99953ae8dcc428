"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface in ``build/`` inside the package
and loaded with ``ctypes``.  The library's file name carries a hash of its
sources and flags, so an edited source is rebuilt at its first use and a
stale library is never loaded.  ``build()`` compiles several sources at
once, one ``nvcc`` process each, all started together.

Nothing here runs at import: the CPU tests import every module, on
hosts that may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from ..utils.locksan import named_lock

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int

#: C functions of every kernel library: ``{library: {function: argtypes}}``;
#: the first is the float32 launcher, the second the bfloat16 one
#: (pointers, then ints, then the stream).  Each returns a CUDA error
#: code.
SIGNATURES = {
    "attention": {
        "additive_attention_forward": [_P] * 6 + [_I] * 5 + [_P],
        "additive_attention_forward_bf16": [_P] * 6 + [_I] * 5 + [_P]},
    "decode_cell": {
        "decode_cell_forward": [_P] * 12 + [_I] * 7 + [_P],
        "decode_cell_forward_bf16": [_P] * 12 + [_I] * 7 + [_P],
        "decode_cell_gate_max_clusters": [_I, _I, _I,
                                          ctypes.POINTER(ctypes.c_int)]},
}

# No reference counterpart (the reference compiles no kernel library): a
# name of the port's own for the sanitizer.
_lock = named_lock("ops.cuda.build")
_loaded: Dict[Tuple[str, str], Callable[..., int]] = {}
_compiles = 0       # libraries this process compiled


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                           "toolkit's bin/ on PATH")
    return found


def library_path(name: str) -> Path:
    """``build/lib<name>-<hash>.so``: hash of the sources and flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernel libraries (default: all) that are not
    built yet, in parallel.  Returns ``{name: {"seconds", "ptxas",
    "cached"}}``; raises with nvcc's output if any compile fails."""
    global _compiles
    names = list(SIGNATURES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, dict] = {}
    procs = {}
    nvcc = None
    for name in names:
        dest = library_path(name)
        if dest.exists():
            out[name] = {"seconds": 0.0, "ptxas": "", "cached": True}
            continue
        nvcc = nvcc or _nvcc()
        tmp = dest.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, dest, time.perf_counter())
    failed = []
    for name, (proc, tmp, dest, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, dest)
        _compiles += 1      # not under _lock: load() holds it to build
        ptxas = "\n".join(ln for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln)
        out[name] = {"seconds": seconds, "ptxas": ptxas, "cached": False}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str, function: Optional[str] = None):
    """The loaded C function ``function`` (default: the launcher) of kernel
    library ``name`` (built on first use), with its ctypes signature
    declared."""
    function = function or next(iter(SIGNATURES[name]))
    with _lock:
        fn = _loaded.get((name, function))
        if fn is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            fn = getattr(ctypes.CDLL(str(path)), function)
            fn.argtypes = SIGNATURES[name][function]
            fn.restype = ctypes.c_int
            _loaded[(name, function)] = fn
    return fn


def library_builds() -> int:
    """Libraries this process has compiled with ``nvcc``: 0 where every
    library it loaded came from the build directory."""
    with _lock:
        return _compiles


def library_events() -> int:
    """Libraries this process has compiled plus the (library, function)
    pairs it has loaded: a path that must build and load nothing (the
    serving engine's rebuild) compares it before and after."""
    with _lock:
        return _compiles + len(_loaded)


def loaded_libraries() -> Tuple[Tuple[str, str], ...]:
    """The (library, function) pairs loaded so far in this process: a
    measurement that must build or load nothing compares it before and
    after its clock."""
    with _lock:
        return tuple(sorted(_loaded))


#: Storage dtypes the kernels take: float32, and bfloat16 (the reference
#: kernels' bf16 storage under ``--use_bfloat16``; math in float32).
STORAGE_DTYPES = (torch.float32, torch.bfloat16)


def storage_dtype(what: str, tensor: "torch.Tensor") -> "torch.dtype":
    """The storage dtype a kernel call runs in, read from one operand
    that carries it; ``TypeError`` for a dtype no kernel takes."""
    if tensor.dtype not in STORAGE_DTYPES:
        raise TypeError(f"{what}: storage dtype {tensor.dtype}; the kernels "
                        "take float32 or bfloat16 storage")
    return tensor.dtype


def on_cuda(what: str, tensors: Dict[str, "torch.Tensor"],
            dtypes: Optional[Dict[str, "torch.dtype"]] = None) -> bool:
    """Route a kernel wrapper's call: False when every input lies on the
    CPU (the wrapper then takes its plain version), True when every input
    is a contiguous tensor of its dtype on one CUDA device (the wrapper
    launches its kernel).  ``dtypes`` gives the dtype each operand must
    have (default: float32 for every operand).  Anything else raises: an
    operand of another dtype (``TypeError``, on either device), mixed
    devices, a non-contiguous CUDA tensor."""
    devices = {t.device for t in tensors.values()}
    for key, t in tensors.items():
        want = torch.float32 if dtypes is None else dtypes[key]
        if t.dtype != want:
            raise TypeError(f"{what}: {key} is {t.dtype}; this call takes "
                            f"{want} (float32 storage, or bfloat16 storage "
                            "with a float32 score_v)")
    if len(devices) != 1:
        raise ValueError(f"{what}: inputs on several devices {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {dev}")
    for key, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {key} must be contiguous")
    return True


def check_aligned(what: str, tensors: Dict[str, "torch.Tensor"]) -> None:
    """The kernels copy their operands 16 bytes at a time: raise
    ``ValueError`` for a tensor that does not start on a 16-byte
    boundary."""
    for key, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {key} must start on a 16-byte "
                             "boundary")


def check(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
