"""On-demand build of the native shared library.

The library is compiled once per source change (mtime + content hash) into
the package directory; tests and the CLI trigger the build transparently.
No external build system needed -- a single g++ invocation.
"""

from __future__ import annotations

import hashlib
import pathlib
import subprocess

_DIR = pathlib.Path(__file__).resolve().parent
_SOURCES = ["replay_engine.cpp"]
_LIB = _DIR / "libgassembly.so"
_STAMP = _DIR / ".build_stamp"


def _digest() -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update((_DIR / name).read_bytes())
    return h.hexdigest()


def build(force: bool = False) -> pathlib.Path:
    """Compile the shared library if missing or stale; returns its path."""
    digest = _digest()
    if (
        not force
        and _LIB.exists()
        and _STAMP.exists()
        and _STAMP.read_text().strip() == digest
    ):
        return _LIB
    sources = [str(_DIR / s) for s in _SOURCES]
    cmd = [
        "g++",
        "-O2",
        "-std=c++17",
        "-fPIC",
        "-shared",
        "-o",
        str(_LIB),
        *sources,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    _STAMP.write_text(digest)
    return _LIB


_SELFTEST = _DIR / "replay_selftest_asan"


def build_sanitizer_selftest(force: bool = False) -> pathlib.Path:
    """ASan+UBSan build of the replay engine with a synthetic driver.

    The reference ships with latent memory bugs (SURVEY.md 2.1.9); this
    guards our engine against growing its own (SURVEY.md 5.2).
    """
    if _SELFTEST.exists() and not force:
        return _SELFTEST
    cmd = [
        "g++",
        "-O1",
        "-g",
        "-std=c++17",
        "-fsanitize=address,undefined",
        "-fno-sanitize-recover=all",
        str(_DIR / "replay_engine.cpp"),
        str(_DIR / "selftest_main.cpp"),
        "-o",
        str(_SELFTEST),
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return _SELFTEST


if __name__ == "__main__":
    print(build(force=True))
