"""Shared parts of the scripts that time builds of a kernel source in turns
(``cost_turns.py``, ``lk_turns.py``, ``pm_turns.py``), on one NVIDIA GPU.

A build is one or more source texts compiled with nvcc into a library of
its own under ``ocean_perception_tpu_torch/_build/<script>/<name>/``, every
build's nvcc started together. A variant of a source is the text with one
or more exact replacements (``edited``); a stamped build adds an array of
timer stamps and an entry point that copies it to the host
(``with_stamps``). Builds are timed in turns, in order and then in reverse
(A B B A, ``turn_order``), so that the card's drift shows.

The stereo entry points take a batch size B since the batched
``perception_step``; a build of older sources, without it, is called
through ``Unbatched`` with B = 1 (``signatures``, ``loaded``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import re
import shutil
import subprocess

import torch
from torch.autograd import DeviceType

from ocean_perception_tpu_torch.ops import cuda


@dataclasses.dataclass(frozen=True)
class Build:
    """files: {file name: text}, every ``.cu`` file compiled with
    ``cuda.NVCC_FLAGS`` and linked into one library; signatures: {entry
    point: ctypes argument types}."""
    files: dict
    signatures: dict


def build_all(script: str, builds: dict) -> dict:
    """{name: Build} -> {name: ctypes.CDLL}, one nvcc a build, all started
    together; prints each build's registers and spills as ptxas reports
    them."""
    jobs = {}
    for name, b in builds.items():
        out_dir = cuda._BUILD / script / re.sub(r"\W+", "_", name)
        shutil.rmtree(out_dir, ignore_errors=True)
        out_dir.mkdir(parents=True)
        for f, text in b.files.items():
            (out_dir / f).write_text(text)
        cmd = [cuda._nvcc(), *cuda.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
               str(out_dir / "lib.so"), *(str(out_dir / f) for f in b.files if f.endswith(".cu"))]
        jobs[name] = (out_dir, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True))
    libs, failed = {}, []
    for name, (out_dir, proc) in jobs.items():  # wait for every job, failed or not
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{err}")
            continue
        usage = re.findall(r"Used \d+ registers[^\n]*|\d+ bytes spill stores|"
                           r"\d+ bytes stack frame[^\n]*", err)
        print(f"[build] {name}: {sorted(set(usage))}")
        dll = ctypes.CDLL(str(out_dir / "lib.so"))
        for fn, argtypes in builds[name].signatures.items():
            getattr(dll, fn).argtypes = argtypes
            getattr(dll, fn).restype = ctypes.c_int
        libs[name] = dll
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


# Where each stereo entry point takes the batch size B: the int after its
# pointers.
BATCH_ARG = {"opt_cost_volume": 5, "opt_pm_match": 6, "opt_build_volumes": 6,
             "opt_pm_match_strip": 7}


def takes_batch(text: str, fn: str) -> bool:
    """Whether the entry point fn, declared in text, takes the batch size."""
    m = re.search(rf'extern "C" int {fn}\(([^)]*)\)', text)
    if m is None:
        raise RuntimeError(f"no entry point {fn} in the source")
    return re.search(r"\bint B\b", m.group(1)) is not None


def signatures(texts, names) -> dict:
    """ctypes argument types of the entry points names, as the sources texts
    declare them (with or without the batch size)."""
    text = "\n".join(texts)
    out = {}
    for fn in names:
        sig = list(cuda._SIGNATURES[fn])
        if fn in BATCH_ARG and not takes_batch(text, fn):
            del sig[BATCH_ARG[fn]]
        out[fn] = sig
    return out


class Unbatched:
    """A library whose stereo entry points predate the batch, called with
    the batched wrappers' arguments: B, which must be 1, is dropped."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name not in BATCH_ARG:
            return fn
        k = BATCH_ARG[name]

        def call(*args):
            if args[k] != 1:
                raise ValueError(f"{name}: a build without the batch takes B = 1, got {args[k]}")
            return fn(*args[:k], *args[k + 1:])
        return call


def loaded(lib, texts):
    """lib as ops/cuda.py's wrappers call it: through Unbatched where its
    sources texts predate the batch."""
    text = "\n".join(texts)
    if any(f'int {fn}(' in text and not takes_batch(text, fn) for fn in BATCH_ARG):
        return Unbatched(lib)
    return lib


def edited(text: str, edits, what: str) -> str:
    """text with each (old, new) of edits replacing the one occurrence of
    old; what names the text in the error where old is not there once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{what} must hold {old!r} exactly once")
        text = text.replace(old, new)
    return text


def with_stamps(text: str, ctype: str, size: int) -> str:
    """text with ``__device__ <ctype> g_stamps[size]`` at the top of its
    anonymous namespace, and ``opt_stamps(out)`` to copy it to the host."""
    anchor = "namespace {\n"
    if anchor not in text:
        raise RuntimeError("the source has no anonymous namespace")
    return (text.replace(anchor, anchor + f"__device__ {ctype} g_stamps[{size}];\n", 1)
            + f"\nextern \"C\" int opt_stamps({ctype}* out) {{\n"
            f"  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof({ctype}) * {size});\n}}\n")


def kernels_ms(fn, n: int, names=None) -> float | None:
    """Device time of one call of fn() in ms: the device time of every
    kernel torch.profiler recorded over n calls, over n; None where it
    recorded none. With names, fails if the window ran a kernel whose name
    holds none of them."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if names is not None and not any(name in e.key for name in names):
            raise AssertionError(f"the profiled window also ran {e.key!r}")
        total += e.device_time_total
    return total / 1e3 / n if total > 0 else None


def turn_order(names) -> list:
    """[(turn, name)]: the names in order, then in reverse."""
    names = list(names)
    return [(0, name) for name in names] + [(1, name) for name in names[::-1]]
