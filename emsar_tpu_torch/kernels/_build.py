"""Build a CUDA source of this package into a shared library, at first use.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
-Xcompiler -fPIC`` into ``emsar_tpu_torch/_build/``, keyed by a hash of the
source and the flags, then ``ctypes`` loads it.  Sources expose plain
``extern "C"`` launchers (no PyTorch headers), so a build takes seconds.
The compiler's report (``-Xptxas -v``: registers, shared memory, spills)
is kept beside the library as ``<lib>.log``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
# the measurement builds of bench/pair_parts.py and bench/cycle_parts.py
PARTS_DIR = os.path.join(BUILD_DIR, "parts")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def library_path(source: str) -> str:
    """Where the library built from ``csrc/<source>`` lives (keyed by the
    source, the headers of csrc/ it includes and the flags)."""
    with open(os.path.join(CSRC_DIR, source), "rb") as fh:
        text = fh.read()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
    for header in re.findall(rb'#include\s+"([^"]+)"', text):
        with open(os.path.join(CSRC_DIR, header.decode()), "rb") as fh:
            digest.update(fh.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def load(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` if its library is missing, then load it.
    Raises RuntimeError with the compiler's output when the build fails."""
    so = library_path(source)
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for "
                               f"{source}:\n{proc.stdout}{proc.stderr}")
        with open(so + ".log", "w") as fh:
            fh.write(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    return ctypes.CDLL(so)


def build_variants(source: str, variants: dict) -> dict:
    """{name: ctypes library} of ``csrc/<source>`` built with each of
    ``variants`` ({name: its extra nvcc flags, such as "-DNAME=1"}) into
    ``PARTS_DIR``, one nvcc each, all started together: measurement
    builds that the benches time against the package's, used nowhere
    else.  Raises RuntimeError with the compiler's output when a build
    fails."""
    os.makedirs(PARTS_DIR, exist_ok=True)
    stem = os.path.splitext(source)[0]

    def one(item):
        name, flags = item
        so = os.path.join(PARTS_DIR, f"{stem}_{name.replace(' ', '_')}.so")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, *flags, "-o", so,
             os.path.join(CSRC_DIR, source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} {name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        return name, so
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = dict(pool.map(one, variants.items()))
    return {name: ctypes.CDLL(so) for name, so in built.items()}
