"""Lazy build of the native helper libraries (fastadb, leafalign).

The native components are throughput optimizations with pure-Python
fallbacks, which makes their ABSENCE silent — and expensive: without
``native/libleafalign.so`` a 100k x 100k traceback runs ~10x slower through
the Python leaf fill. The .so files are build artifacts (never in git), so
the bridges self-build: when a library is missing or stale and the repo's
``native/`` sources plus a C++ compiler are available, build it once,
under a file lock (the multi-process tests spawn concurrent importers).
Failure is silent by design — the Python fallbacks remain correct, and
hirschberg warns on the expensive path. Opt out with
``LIBSSA_NO_NATIVE_BUILD=1``.

A library is fresh only if it is newer than its source AND a stamp beside
it names this host's machine, compiler and flags: a library copied with a
checkout onto another host is rebuilt there instead of being loaded. The
flags are portable (no ``-march=native``), so even a stale copy cannot hit
an illegal instruction.
"""
from __future__ import annotations

import os
import platform
import subprocess

_CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]


def _source_dir() -> str | None:
    here = os.path.dirname(os.path.abspath(__file__))  # libssa_tpu/util
    root = os.path.dirname(os.path.dirname(here))  # repo root
    cand = os.path.join(root, "native")
    return cand if os.path.isdir(cand) else None


def _host_stamp(cxx: str) -> str:
    return " ".join(
        [platform.node(), platform.machine(), cxx, *_CXXFLAGS]
    )


def _fresh(out: str, src: str, stamp: str) -> bool:
    if not (
        os.path.isfile(out) and os.path.getmtime(out) >= os.path.getmtime(src)
    ):
        return False
    try:
        with open(out + ".stamp") as f:
            return f.read() == stamp
    except OSError:
        return False


def ensure_built(so_name: str, source_name: str) -> str | None:
    """Path to an up-to-date ``so_name``, building it if needed/possible."""
    if os.environ.get("LIBSSA_NO_NATIVE_BUILD"):
        return None
    src_dir = _source_dir()
    if src_dir is None:
        return None
    src = os.path.join(src_dir, source_name)
    if not os.path.isfile(src):
        return None
    out = os.path.join(src_dir, so_name)
    cxx = os.environ.get("CXX", "g++")
    stamp = _host_stamp(cxx)
    if _fresh(out, src, stamp):
        return out
    if not os.access(src_dir, os.W_OK):
        return None
    tmp = f"{out}.tmp.{os.getpid()}"
    try:
        import fcntl

        with open(out + ".lock", "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            if not _fresh(out, src, stamp):  # a concurrent holder may have built
                subprocess.run(
                    [cxx, *_CXXFLAGS, "-o", tmp, src],
                    check=True,
                    capture_output=True,
                    timeout=300,
                )
                os.replace(tmp, out)
                with open(out + ".stamp", "w") as f:
                    f.write(stamp)
    except Exception:
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out
