"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use (or all at once by ``build_all``, one ``nvcc`` per source in parallel)
into ``repro_torch/_build/<name>-<hash>.so`` (the hash covers the source,
the ``csrc/*.cuh`` headers it includes and the flags, so an edited source or
header is rebuilt; the directory is listed in ``.gitignore``). ``nvcc``'s
own report, registers and shared memory per kernel from ``-Xptxas -v``, is
kept beside the library as ``.log``.

Nothing here runs at import: the CPU tests import every module on a machine
with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc (the CUDA compiler) was not found on PATH, in "
                       "$CUDA_HOME/bin or in /usr/local/cuda/bin; the port's "
                       "CUDA kernels cannot be built without it")


def headers(src: Path) -> List[Path]:
    """The ``csrc/*.cuh`` that ``src`` includes (``#include "x.cuh"``), and
    those they include, in the order first seen."""
    found: List[Path] = []
    todo = [src]
    while todo:
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+\.cuh)"',
                               todo.pop().read_text(), re.M):
            path = CSRC_DIR / name
            if path not in found:
                found.append(path)
                todo.append(path)
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: the name carries a hash of the
    source, of every header it includes and of the flags."""
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in headers(src):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


SOURCES = ("flash_attention", "decode_attention", "ssd_scan", "rglru_scan",
           "policy_score")


def build_all(names=SOURCES) -> Dict[str, float]:
    """Compile every ``csrc/<name>.cu`` of ``names`` that is not built yet,
    one ``nvcc`` per source, all started together. Returns the seconds each
    took from the common start (0.0 for a library that was already built);
    raises on a compiler error, naming every source that failed."""
    seconds = {name: 0.0 for name in names}
    running = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        # nvcc writes its report into the .log; the child keeps the file
        with open(out.with_suffix(".log"), "w") as log:
            proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o",
                                     str(tmp), str(CSRC_DIR / f"{name}.cu")],
                                    stdout=log, stderr=subprocess.STDOUT)
        running[name] = (proc, tmp, out)
    failed = []
    while running:
        for name, (proc, tmp, out) in list(running.items()):
            if proc.poll() is None:
                continue
            seconds[name] = time.perf_counter() - t0
            del running[name]
            if proc.returncode != 0:
                failed.append(f"nvcc failed for csrc/{name}.cu (exit "
                              f"{proc.returncode}):\n{build_report(name)}")
            else:
                os.replace(tmp, out)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def build(name: str) -> float:
    """Compile ``csrc/<name>.cu`` unless it is built already. Returns the
    seconds spent (0.0 for a library that was already built); raises on a
    compiler error."""
    return build_all((name,))[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if need be."""
    lib = _LIBS.get(name)
    if lib is None:
        build(name)
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def build_report(name: str) -> str:
    """What ``nvcc -Xptxas -v`` said when the library was built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _demangle(names: List[str]) -> List[str]:
    """C++ names through the toolkit's ``cu++filt`` (or ``c++filt``); the
    mangled names where neither is found."""
    for tool in (str(Path(nvcc_path()).parent / "cu++filt"), "c++filt"):
        if shutil.which(tool) or Path(tool).exists():
            proc = subprocess.run([tool, *names], capture_output=True,
                                  text=True, check=False)
            out = proc.stdout.splitlines()
            if proc.returncode == 0 and len(out) == len(names):
                return out
    return names


def sass(name: str) -> Dict[str, str]:
    """Each kernel's machine code (SASS) in the built ``csrc/<name>.cu``, by
    demangled name, as the toolkit's ``cuobjdump --dump-sass`` shows it."""
    tool = Path(nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "--dump-sass", str(library_path(name))],
                         capture_output=True, text=True, check=True).stdout
    parts = re.split(r"^\s*Function : (\S+)\s*$", out, flags=re.M)
    return dict(zip(_demangle(parts[1::2]), parts[2::2]))


def ptxas_summary(name: str) -> List[Dict[str, object]]:
    """Registers, spill bytes and static shared memory of every kernel in
    ``csrc/<name>.cu``, from what ``nvcc -Xptxas -v`` said when it was
    built."""
    rows: List[Dict[str, object]] = []
    for line in build_report(name).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            rows.append({"function": m.group(1)})
            continue
        if not rows:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rows[-1]["spill_stores"] = int(m.group(1))
            rows[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[-1]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            rows[-1]["static_smem"] = int(sm.group(1)) if sm else 0
    for row, full in zip(rows, _demangle([r["function"] for r in rows])):
        row["function"] = full
    return rows


def _cu(result: int, what: str) -> None:
    if result != 0:
        raise RuntimeError(f"{what} failed: CUresult {result}")


def graph_kernels(fn) -> List[str]:
    """The kernels that one call of ``fn`` launches on the current card, by
    demangled name in the order of capture: the kernel nodes of a CUDA graph
    captured from the call, read through the driver's graph API. A capture
    records every launch of the call and nothing else, so the count is
    exact; memory copies and sets are other node types and are not
    listed."""
    import torch
    cu = ctypes.CDLL("libcuda.so.1")
    vp, byref = ctypes.c_void_p, ctypes.byref
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    raw = vp(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    _cu(cu.cuGraphGetNodes(raw, None, byref(count)), "cuGraphGetNodes")
    nodes = (vp * count.value)()
    _cu(cu.cuGraphGetNodes(raw, nodes, byref(count)), "cuGraphGetNodes")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        _cu(cu.cuGraphNodeGetType(vp(node), byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:                     # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func first, kern at byte 56
        params = (ctypes.c_uint64 * 16)()
        _cu(cu.cuGraphKernelNodeGetParams_v2(vp(node), params),
            "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params[0]:
            _cu(cu.cuFuncGetName(byref(name), vp(params[0])), "cuFuncGetName")
        else:
            _cu(cu.cuKernelGetName(byref(name), vp(params[7])),
                "cuKernelGetName")
        names.append(name.value.decode())
    del graph
    return _demangle(names) if names else names
