"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Every kernel lives in `csrc/<name>.cu` behind a plain C launcher (see
csrc/common.cuh); a library may export several launchers, each named in
`_SIGNATURES`, and its wrapper module then counts each launcher's
launches apart (`counter`). At first use
`launcher(name)` compiles that one source for Hopper (sm_90a) into
`build/repro_torch_kernels/` at the repository root, named by a digest
of the flags, the source and every header under csrc/, so that an edited
kernel or header is rebuilt, and loads it with ctypes. `build(names)`
compiles several sources at once, one nvcc process each, and returns
what ptxas reports about registers and spills; `compile_sources` and
`use_library` build and launch another version of a kernel's source
(tools/k1_ab.py). Nothing here falls back: a missing nvcc or a failed
compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("hash_probe", "csr_expand", "compact", "radix_rank", "intersect", "seg_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# launcher symbol and argument types of each launcher of the C interfaces
_SIGNATURES = {
    "hash_probe": ("hash_probe_launch", (_P, _P, _P, _L, _L, _P, _I, _I, _I, _I, _I, _P)),
    "csr_expand": ("csr_expand_launch", (_P, _P, _P, _P, _P, _I, _I, _P)),
    "compact": ("compact_launch", (_P, _P, _P, _I, _I, _P)),
    "radix_rank": ("radix_rank_launch", (_P, _P, _P, _P, _I, _P)),
    "intersect": ("intersect_launch", (_P, _P, _P, _P, _P, _I, _I, _I, _P)),
    "digit_counts": ("digit_counts_launch", (_P, _P, _P, _P, _L, _I, _P)),
    "max_scan": ("max_scan_launch", (_P, _P, _P, _L, _I, _P)),
}
# launchers that share a library (csrc/<library>.cu) with others
_LIBRARY = {"digit_counts": "seg_scan", "max_scan": "seg_scan"}

_lock = threading.Lock()
_launchers: dict[str, tuple] = {}

# Calls of each launcher's plain version: the CPU branch of its wrapper,
# where the card would launch the kernel. A CPU run of the launch audit
# counts these in place of launches, and counts no tensor op made inside one.
plain_calls = dict.fromkeys(_SIGNATURES, 0)
_plain_depth = 0


def nvcc() -> str:
    """Path of the CUDA compiler: nvcc on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    path = home / "bin" / "nvcc"
    if not path.exists():
        raise FileNotFoundError("nvcc not found on PATH or under CUDA_HOME")
    return str(path)


def _lib_path(name: str) -> Path:
    """Where kernel `name`'s library goes, named by a digest of the flags,
    its source and every header under csrc/ (any of which it may include)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def compile_sources(jobs: dict, *, verbose: bool = False) -> dict[str, str]:
    """Compile each job's `(source, library)`: one nvcc process each, all
    started together, csrc/ on the include path. Returns key -> the
    compiler's diagnostics (ptxas register and spill lines when
    `verbose`). Raises if any compile fails."""
    procs = {}
    for key, (src, out) in jobs.items():
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        tmp = Path(out).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for key, (proc, tmp, out) in procs.items():
        logs[key] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{key} (nvcc exit {proc.returncode}):\n{logs[key]}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees old or new
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def build(names=KERNELS, *, verbose: bool = False) -> dict[str, str]:
    """Compile the named kernels (compile_sources). Returns name -> the
    compiler's diagnostics."""
    return compile_sources({name: (CSRC / f"{name}.cu", _lib_path(name)) for name in names},
                           verbose=verbose)


def load(name: str, path) -> tuple:
    """(C launcher, error-string function) of launcher `name` in the
    library at `path`."""
    lib = ctypes.CDLL(str(path))
    symbol, argtypes = _SIGNATURES[name]
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = (ctypes.c_int,)
    lib.repro_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_error_string


def use_library(name: str, path) -> None:
    """Launch kernel `name` from the library at `path` from now on: a
    build of another version of its source, as tools/k1_ab.py compares."""
    with _lock:
        _launchers[name] = load(name, path)


def counter(name: str) -> str:
    """The attribute of launcher `name`'s wrapper module that counts its
    launches on the card: `launches`, or `<name>_launches` where the
    module wraps several launchers of one library (seg_scan)."""
    return f"{name}_launches" if name in _LIBRARY else "launches"


def launcher(name: str):
    """The C launcher `name`, building its library on first use."""
    with _lock:
        hit = _launchers.get(name)
        if hit is None:
            lib = _LIBRARY.get(name, name)
            path = _lib_path(lib)
            if not path.exists():
                build((lib,))
            hit = load(name, path)
            _launchers[name] = hit
    return hit


def launch(name: str, device: torch.device, *args) -> None:
    """Enqueue kernel `name` on the device's current PyTorch stream; raise
    if the launch was refused. Tensor arguments are passed as pointers."""
    fn, err_string = launcher(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        rc = fn(*ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {err_string(rc).decode()}")


def run_plain(name: str, fn, *args):
    """Run kernel `name`'s plain version `fn(*args)` (a wrapper's CPU
    branch), counted in plain_calls."""
    global _plain_depth
    plain_calls[name] += 1
    _plain_depth += 1
    try:
        return fn(*args)
    finally:
        _plain_depth -= 1


def in_plain() -> bool:
    """True while a kernel's plain version runs."""
    return _plain_depth > 0


def common_device(name: str, strided: tuple = (), **tensors: torch.Tensor) -> torch.device:
    """Validate a kernel's tensor arguments: int32, contiguous (but those
    named in `strided`, which the kernel reads through their strides), all
    on one device. Returns that device; raises ValueError otherwise."""
    devices = set()
    for arg, t in tensors.items():
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise ValueError(f"{name}: {arg} must be an int32 tensor")
        if arg not in strided and not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        devices.add(t.device)
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return device
