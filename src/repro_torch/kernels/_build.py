"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with `ctypes` (no PyTorch
headers, so a build takes seconds).  Libraries go to ``build/repro_torch/``
under the repository root, named by a digest of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source is rebuilt and
an unchanged one is reused.  A build happens at first use, never at
import.  There is no fallback: a missing ``nvcc`` or a failed build
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("stencil_tb", "stencil_tb_tti", "stencil_tb_elastic", "ssd_scan")
# IEEE division and square root (no fast math), and no multiply-add
# contraction: every product is rounded before it is added, as the
# reference rounds it.  With contraction the TTI and elastic 512^3 paths
# drifted 1.7e-4 and 2.5e-4 (relative) from the Listing-1 reference over
# their 236 and 399 steps; without it their fields match it bit for bit,
# at the same speed (PERF.md).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float      # nvcc wall time; 0.0 when an existing build was reused
    log: str            # nvcc's output, including the -Xptxas -v lines
                        # (kept beside the library, so a reuse has it too)


_loaded: Dict[str, Built] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from source at first use")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Built]:
    """Build (one nvcc per source, all started together) and load every
    named library not loaded yet; returns all the named builds."""
    todo = [n for n in names if n not in _loaded]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = _target(name)
        if out.is_file():
            log = out.with_suffix(".log")
            _loaded[name] = Built(ctypes.CDLL(str(out)), out, 0.0,
                                  log.read_text() if log.is_file() else "")
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        # atomic, the log first: a process that finds the library (a rank
        # started beside this build) finds its whole log too
        log_tmp = tmp.with_suffix(".log")
        log_tmp.write_text(log)
        os.replace(log_tmp, out.with_suffix(".log"))
        os.replace(tmp, out)          # concurrent builds agree
        _loaded[name] = Built(ctypes.CDLL(str(out)), out, secs, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {n: _loaded[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it if needed."""
    if name not in _loaded:
        build_all([name])
    return _loaded[name].lib
