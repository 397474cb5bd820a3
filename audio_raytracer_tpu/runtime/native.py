"""Build + load the native C++ scene registry (ctypes binding).

The shared library is compiled from native/scene_registry.cpp on first
use (g++ only; no external deps) into ``runtime/_build/``, named by the
source's content hash: a changed source, or a checkout without the build
directory, rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "native" / "scene_registry.cpp"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"

_lock = threading.Lock()
_lib = None


def library_path() -> pathlib.Path:
    """The library built from the current source."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libaudio_rt_scene-{digest}.so"


def _compile(lib: pathlib.Path) -> None:
    _BUILD_DIR.mkdir(exist_ok=True)
    # Build under a private name, then rename: concurrent first users
    # (test workers) never load a half-written library.
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
           str(_SRC), "-o", str(tmp)]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, lib)


def load() -> ctypes.CDLL:
    """Load (building if missing) the native registry library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))

        lib.art_registry_create.restype = ctypes.c_void_p
        lib.art_registry_destroy.argtypes = [ctypes.c_void_p]
        lib.art_add.restype = ctypes.c_int64
        lib.art_add.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_float)]
        lib.art_update.restype = ctypes.c_int
        lib.art_update.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_float)]
        lib.art_remove.restype = ctypes.c_int
        lib.art_remove.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.art_handle_slot.restype = ctypes.c_int
        lib.art_handle_slot.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.art_add_target.restype = ctypes.c_int
        lib.art_add_target.argtypes = [ctypes.c_void_p, ctypes.c_float,
                                       ctypes.c_float, ctypes.c_float]
        lib.art_set_target_position.restype = ctypes.c_int
        lib.art_set_target_position.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float]
        lib.art_remove_target.restype = ctypes.c_int
        lib.art_remove_target.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.art_update_job_batch.restype = ctypes.c_int
        lib.art_update_job_batch.argtypes = [ctypes.c_void_p]
        lib.art_version.restype = ctypes.c_uint64
        lib.art_version.argtypes = [ctypes.c_void_p]
        lib.art_counts.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int)]
        lib.art_job_data.restype = ctypes.POINTER(ctypes.c_float)
        lib.art_job_data.argtypes = [ctypes.c_void_p, ctypes.c_int]

        _lib = lib
        return lib
