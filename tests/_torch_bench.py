"""Helpers of the card scripts that time variants of a kernel against each
other (``tests/_torch_spmv_lanes_bench.py``, ``tests/_torch_flash_f32_bench.py``):
building text-edited copies of a source side by side, timing with CUDA
events, and reading ``ptxas -v``.  Not a test module; needs nvcc and one
NVIDIA GPU.
"""
import ctypes
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build  # noqa: E402

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def edit(text, old, new):
    """``text`` with ``old`` replaced by ``new``; ``old`` must be there."""
    if old not in text:
        raise SystemExit(f"variant edit not found in the source: {old!r}")
    return text.replace(old, new)


def build_variants(variants):
    """Libraries of one source each: ``variants`` maps a name to (source
    text, directory of the headers it includes).  All are compiled at once
    with the package's flags into ``kernels/_build/variants/<name>/``;
    returns name -> (loaded ``ctypes.CDLL`` with no signatures set, nvcc's
    output)."""
    procs = {}
    for name, (text, include) in variants.items():
        d = _build.BUILD_DIR / "variants" / name
        d.mkdir(parents=True, exist_ok=True)
        src = d / "variant.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS, "-shared", "-I", str(include),
             str(src), "-o", str(d / "variant.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        out[name] = (ctypes.CDLL(str(_build.BUILD_DIR / "variants" / name
                                     / "variant.so")), log)
    return out


def ptxas(log, kernel):
    """'template arguments: registers' (and any spill line) of each
    instance of ``kernel`` in nvcc's ``-Xptxas -v`` output."""
    res, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(kernel + r"I(\w+?)EEv", ln)
            cur = m.group(1) if m else None
        elif cur and "Used" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            res.append(f"{cur}: {regs} regs")
        elif cur and re.search(r"[1-9]\d* bytes spill", ln):
            res.append(f"{cur}: {ln.strip()}")
    return res


def ev_ms(fn, reps):
    """Device ms of one ``fn()`` over ``reps`` calls (CUDA events, behind a
    sleep kernel so that the host's launches run ahead of the card)."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(reps * 1_000_000)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps
