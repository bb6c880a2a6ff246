"""Build a C++ source of the repo's native/ into a shared library in the
port's _build/ with g++ (never into native/), for a ctypes binding."""
from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess

PKG = pathlib.Path(__file__).resolve().parents[1]
NATIVE = PKG.parent / "native"
BUILD_DIR = PKG / "_build"
FLAGS = ("-O3", "-std=c++17", "-march=native", "-shared", "-fPIC",
         "-pthread")


def build(source: pathlib.Path, stem: str,
          build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """``build_dir/lib<stem>-<digest>.so`` compiled from ``source``, built
    unless it exists: the digest covers the source and the flags, so an
    edited source never loads a stale build. Raises if g++ fails."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(FLAGS).encode())
    so = build_dir / f"lib{stem}-{h.hexdigest()[:16]}.so"
    if not so.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        out = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(source)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed on {source}:\n{out.stderr}")
        os.replace(tmp, so)
    return so
