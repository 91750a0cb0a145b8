"""Build a CUDA source of this package with ``nvcc`` and bind it with
``ctypes``.

The source compiles on first use into ``build/kernels/`` at the root of
the checkout, named by a hash of the source and the flags, so an edited
kernel is rebuilt and an unchanged one is loaded as it is.  The library
has a plain C interface: its launchers take device pointers, ints and a
stream, and return ``cudaGetLastError()``.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "load_library", "load_libraries", "build_log",
           "library_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# no --use_fast_math: the quantize kernel relies on IEEE division and
# nvcc's default -prec-div=true
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signature of every launcher: name -> argtypes (pointers and the stream
# as c_void_p, so ctypes passes all 64 bits; ints as c_int, strides as
# c_longlong, floats as c_float)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
SIGNATURES = {
    "emb_lookup": {
        "pooled_lookup_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "staged_gather_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "pooled_lookup_staged_launch": [_P, _P, _P, _P, _P, _P,
                                        _I, _I, _I, _I, _I, _I, _P],
        "pooled_lookup_quant_launch": [_P, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _I, _I, _P],
        "empty_launch": [_P],
    },
    "exchange_pack": {
        "gather_rows_launch": [_P, _P, _P, _I, _I, _I, _I, _P],
        "gather_rows_quant_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _F, _F, _F, _P],
        "pack_send_all_launch": [_P] * 5 + [_I] + [_P] * 3 + [_I] * 4
                                + [_P],
        "pack_send_all_quant_launch": [_P] * 5 + [_I] + [_P] * 4
                                      + [_F, _F, _I] + [_P] * 3
                                      + [_I] * 4 + [_P],
    },
    "auction": {
        "auction_bids_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
        "auction_solve_launch": [_P] * 6 + [_I] * 7 + [_L, _P],
    },
    "flash_attn": {
        "flash_attention_launch": [_P] * 5 + [_I] * 7 + [_L] * 13 + [_P],
    },
    "flash_attn_sm90": {
        "flash_attention_sm90_launch": [_P] * 5 + [_I] * 7 + [_L] * 10
                                       + [_P],
    },
    "flash_attn_bwd": {
        "flash_attention_bwd_launch": [_P] * 10 + [_I] * 8 + [_L] * 14
                                      + [_P],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}
_paths: dict[str, Path] = {}
_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>`` built from ``csrc/<name>.cu``, compiled on
    the first call in this checkout."""
    return load_libraries(name)[0]


def load_libraries(*names: str) -> list[ctypes.CDLL]:
    """Load several libraries; the ones not built yet compile together,
    one ``nvcc`` process per source, all started at once."""
    builds = []
    for name in names:
        if name in _loaded:
            continue
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS)
                                .encode()).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}_{digest}.so"
        proc = tmp = None
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                     str(src)], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
        builds.append((name, src, out, tmp, proc))
    # wait for every compiler before raising, so none outlives a failure
    errs = [proc.communicate()[1] if proc is not None else ""
            for *_, proc in builds]
    for (name, src, out, tmp, proc), err in zip(builds, errs):
        if proc is not None:
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"(exit {proc.returncode}):\n{err}")
            os.replace(tmp, out)
            _logs[name] = err
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
        _paths[name] = out
    return [_loaded[name] for name in names]


def build_log(name: str) -> str:
    """What ``nvcc`` printed while building ``name`` in this process
    (registers, shared memory and spills per kernel); empty when the
    library was already built."""
    return _logs.get(name, "")


def library_path(name: str) -> Path:
    """The shared library that :func:`load_libraries` loaded for
    ``name`` in this process (for ``cuobjdump``)."""
    return _paths[name]
