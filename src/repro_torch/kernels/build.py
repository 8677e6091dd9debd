"""Build the CUDA kernels with nvcc and load them through ctypes.

Every ``csrc/*.cu`` source compiles to an object (one ``nvcc`` per source,
all started together), and the objects link into one shared library with a
plain C interface.  The library lands in ``build/repro_torch_kernels/`` at
the repository root, named by a hash of the sources, the headers they
share (``csrc/*.cuh``) and the flags, so an edited file never loads a stale
build.  It is built on first use, from the sources alone.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# --fmad=false keeps every multiply and add separately rounded, as the
# plain PyTorch versions compute them, so kernel and plain version agree to
# the last bit wherever their reduction orders do.
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "--fmad=false"]

_lock = threading.Lock()
_lib = None
build_log = ""            # compiler output of this process's build


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the repro_torch CUDA kernels are "
                       "built with nvcc from the CUDA toolkit")


def headers() -> list[Path]:
    """The headers the sources include: hashed with them, not compiled."""
    return sorted(CSRC.glob("*.cuh"))


def _digest(sources: list[Path], flags: list[str]) -> str:
    h = hashlib.sha1(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(sources: list[Path], out: Path, verbose: bool) -> str:
    """nvcc each source in parallel, then link one shared library."""
    nvcc = _nvcc()
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *flags, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        # Every nvcc ends before a failure is raised: none is left running.
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, text in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
        part = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", *map(str, objs), "-o", str(part)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(part, out)        # atomic: concurrent builds race safely
    return "".join(logs) + link.stdout


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.sroa_invert_rate.argtypes = [p, p, p, ll, p, ll, i, i, i, p]
    lib.sroa_solve.argtypes = ([p] * 19 + [i] * 6 + [f] * 5 + [p])
    lib.sroa_solve_lanes.argtypes = ([p] * 19 + [i] * 6 + [f] * 5
                                     + [i, p])
    lib.sroa_solve_lanes_occupancy.argtypes = [i, i, p]
    lib.sroa_solve_cluster.argtypes = ([p] * 19 + [i] * 6 + [f] * 5
                                       + [i, p])
    lib.sroa_solve_cluster_occupancy.argtypes = [i, i, p, p, p, p]
    lib.sroa_math_check.argtypes = [p, ll, p]
    lib.topk_moves.argtypes = [p] * 10 + [i] * 4 + [p]
    lib.topk_moves_warp.argtypes = [p] * 10 + [i] * 5 + [p]
    lib.topk_moves_warp_occupancy.argtypes = [i] * 3 + [p]
    lib.topk_moves_cluster.argtypes = [p] * 10 + [i] * 4 + [p]
    lib.topk_moves_cluster_smem.argtypes = [i] * 3
    lib.topk_empty.argtypes = [p]
    lib.flash_attention.argtypes = ([p] * 4 + [i] * 6 + [ll] * 12 + [i] * 4
                                    + [f, p])
    lib.flash_attention_sm90.argtypes = ([p] * 4 + [i] * 5 + [ll] * 12
                                         + [i] * 4 + [f, p])
    lib.flash_attention_sm90_occupancy.argtypes = [i, p, p]
    lib.flash_attention_sm90_f32.argtypes = lib.flash_attention_sm90.argtypes
    lib.flash_attention_sm90_f32_occupancy.argtypes = [i, p, p]
    lib.rmsnorm.argtypes = [p, p, p, i, ll, i, f, p]
    lib.mamba2_scan.argtypes = [p] * 7 + [i] * 5 + [p]
    lib.mlstm_scan.argtypes = [p] * 12 + [i] * 4 + [p]
    lib.slstm_scan.argtypes = [p] * 14 + [i] * 4 + [p]
    lib.mamba2_scan_ckpt.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.mamba2_scan_bwd.argtypes = [p] * 14 + [i] * 5 + [p]
    lib.mlstm_scan_ckpt.argtypes = [p] * 11 + [i] * 4 + [p]
    lib.mlstm_scan_bwd.argtypes = [p] * 28 + [i] * 4 + [p]
    lib.slstm_scan_save.argtypes = [p] * 10 + [i] * 4 + [p]
    lib.slstm_scan_bwd.argtypes = [p] * 25 + [i] * 4 + [p]
    lib.mamba2_chunked.argtypes = [p] * 8 + [i] * 6 + [p]
    lib.mamba2_chunked_bwd.argtypes = [p] * 12 + [i] * 6 + [p]
    lib.mlstm_chunked_bwd.argtypes = [p] * 19 + [i] * 5 + [p]
    lib.mlstm_gates_bwd.argtypes = [p] * 9 + [i] * 4 + [p]
    lib.mlstm_gates_bwd_seq.argtypes = [p] * 9 + [i] * 4 + [p]
    lib.slstm_scan_bwd_short.argtypes = [p] * 18 + [i] * 4 + [p]
    lib.slstm_dR.argtypes = [p] * 7 + [i] * 4 + [p]
    lib.slstm_handshake_floor.argtypes = [p] + [i] * 5 + [p]
    lib.topk_moves_cluster_smem.restype = ctypes.c_longlong
    for fn in (lib.sroa_invert_rate, lib.sroa_solve, lib.sroa_solve_lanes,
               lib.sroa_solve_lanes_occupancy, lib.sroa_solve_cluster,
               lib.sroa_solve_cluster_occupancy, lib.sroa_math_check,
               lib.topk_moves, lib.topk_moves_warp,
               lib.topk_moves_warp_occupancy, lib.topk_moves_cluster,
               lib.topk_empty,
               lib.flash_attention, lib.flash_attention_sm90,
               lib.flash_attention_sm90_occupancy,
               lib.flash_attention_sm90_f32,
               lib.flash_attention_sm90_f32_occupancy, lib.rmsnorm,
               lib.mamba2_scan, lib.mlstm_scan, lib.slstm_scan,
               lib.mamba2_scan_ckpt, lib.mamba2_scan_bwd,
               lib.mlstm_scan_ckpt, lib.mlstm_scan_bwd,
               lib.slstm_scan_save, lib.slstm_scan_bwd, lib.mamba2_chunked,
               lib.mamba2_chunked_bwd, lib.mlstm_chunked_bwd,
               lib.mlstm_gates_bwd, lib.mlstm_gates_bwd_seq,
               lib.slstm_scan_bwd_short, lib.slstm_dR,
               lib.slstm_handshake_floor):
        fn.restype = ctypes.c_int
    return lib


def load(verbose: bool = False) -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` on first use.

    ``verbose`` builds anew even when a library is on disk and keeps the
    compiler's report (``-Xptxas -v``: registers, spills) in ``build_log``.
    """
    global _lib, build_log
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(CSRC.glob("*.cu"))
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        digest = _digest(sources + headers(), NVCC_FLAGS)
        so = out_dir / f"libreprotorch_{digest}.so"
        if not so.exists() or verbose:
            build_log = _compile(sources, so, verbose)
        _lib = _bind(ctypes.CDLL(str(so)))
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {err}")
