"""Build-on-first-use for the port's native components.

Each ``<name>.cc`` of this directory is compiled once with the system's
``g++`` (``-O2 -shared -fPIC -std=c++17``) into ``_build/`` beside it,
keyed by a hash of the source, so an edited source builds anew and a
built one is reused by every process.  No toolchain, or a source that
does not compile, gives no library: :func:`lib_path` returns None and
:func:`build_error` says why, and the callers fall back to their Python
paths.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional

_NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_NATIVE_DIR, "_build")
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib_paths: Dict[str, Optional[str]] = {}
_build_errors: Dict[str, str] = {}


def lib_path(name: str = "channel") -> Optional[str]:
    """Path to the built ``librtpu_<name>.so``, built now if this source
    has none yet; None when the build failed (see :func:`build_error`)."""
    with _lock:
        if name in _lib_paths:
            return _lib_paths[name]
        src = os.path.join(_NATIVE_DIR, f"{name}.cc")
        try:
            with open(src, "rb") as f:
                tag = hashlib.sha256(f.read()).hexdigest()[:16]
            out = os.path.join(_BUILD_DIR, f"librtpu_{name}-{tag}.so")
            if not os.path.exists(out):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                tmp = f"{out}.tmp.{os.getpid()}"
                subprocess.run(["g++", *_FLAGS, "-o", tmp, src, "-lpthread",
                                "-lrt"], check=True, capture_output=True,
                               timeout=120)
                os.replace(tmp, out)  # atomic: racing builds both succeed
            _lib_paths[name] = out
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", None)
            _build_errors[name] = f"g++ {' '.join(_FLAGS)} {src}: {e!r}" + (
                f": {detail.decode(errors='replace')}" if detail else "")
            _lib_paths[name] = None
        return _lib_paths[name]


def build_error(name: str = "channel") -> Optional[str]:
    """Why ``name`` has no library (None when it built or was not asked
    for)."""
    return _build_errors.get(name)
