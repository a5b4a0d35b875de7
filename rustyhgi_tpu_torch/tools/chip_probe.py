"""Probes of the card, run one at a time.

Counterpart of the JAX repo's ``tools/chip_probe.py``.  One subcommand is
ported: ``vpucal``, the op-rate calibration probe (``cmd_vpucal``), on
the probe kernel K8 (:mod:`..ops.vpucal`, ``csrc/hgi_probe.cu``)::

    python -m rustyhgi_tpu_torch.tools.chip_probe vpucal [names]

``names`` is a comma-separated subset of the rows:

  mix3x16   K8's mix3 chain (add, shift, xor), four independent chains
            a thread: the JAX probe's own chain
  add / shift / csel   single-op-class chains of K8: which op class is
            slow?
  f32add    K8's float32 chain (add, mul, add, never fused): are the
            int32 lanes the limit?
  torch     the same mix3 chain as plain PyTorch elementwise ops on the
            card, one launch per op: an independent implementation on the
            same machine, where the JAX probe had its ``xla`` row.

The input is 8x1080x1920 random bytes from a seeded numpy generator.
Each row runs k = 200 and k = 2000 rounds; each is timed with CUDA
events, the median of ``REPEATS`` calls after a warm-up, and the rate is
``3 * (k_hi - k_lo) * pixels / (t_hi - t_lo)``: the slope cancels the
launch and the fixed load and store.

The nominal 3 ops a round is what the chain says, not what the card
issues: nvcc may fold an op (an IADD3 adds three operands) or add loop
control.  So the probe reads the built library's SASS (``cuobjdump
-sass``), counts the instructions of each kind's main loop body, which
holds ``kUnroll`` rounds of a thread's four chains, and prints that count
per pixel and round beside the rate computed from it.  Without
``cuobjdump`` the count is "not measured".

Each line ends with the card's name and power limit (``nvidia-smi``); the
last line is one JSON object ``{"vpucal": {row: {...}}}``.  The probe
needs a CUDA card and raises without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import _build, vpucal
from ..utils.benchsuite import device_samples

__all__ = ["cmd_vpucal", "main", "sass_loops"]

SEED = 20261016
SHAPE = (8, 1080, 1920)
K_LO, K_HI = 200, 2000
REPEATS = 7  # timed calls per k after a warm-up, as chip_smoke.py's REPEATS
UNROLL = 4  # rounds in the main loop body of csrc/hgi_probe.cu (kUnroll)
ROWS = ("mix3x16", "add", "shift", "csel", "f32add", "torch")
_ROW_KIND = {"mix3x16": "mix3", "add": "add", "shift": "shift", "csel": "csel",
             "f32add": "f32add", "torch": "mix3"}


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# -- SASS ----------------------------------------------------------------------

_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_BRANCH = re.compile(r"\bBRA\b[^`(]*`?\(?\s*(\.L_x_\d+|0x[0-9a-f]+)")
_KERNEL = re.compile(r"vpucal_kernelILi(\d)ELb1E")  # the 32-bit word variant


def _opcode(text: str) -> str:
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0] if words else ""


def _loops(lines) -> list:
    """The loops of one function, as the backward branches close them:
    ``[(body opcodes)]``, each body from the branch's target to the
    branch, NOPs left out; the trap that ends a listing (a branch to
    itself) is no loop."""
    insns, labels = [], {}
    for line in lines:
        m = _LABEL.match(line)
        if m:
            labels[m.group(1)] = None  # bound to the next instruction
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for name, at in labels.items():
                if at is None:
                    labels[name] = addr
            insns.append((addr, m.group(2)))
    loops = []
    for addr, text in insns:
        if _opcode(text) != "BRA":
            continue
        m = _BRANCH.search(text)
        if not m:
            continue
        target = m.group(1)
        to = int(target, 16) if target.startswith("0x") else labels.get(target)
        if to is None or to >= addr:
            continue
        loops.append([_opcode(t) for a, t in insns if to <= a <= addr and _opcode(t) != "NOP"])
    return loops


def sass_loops(sass: str) -> Dict[str, dict]:
    """Per kind, from ``cuobjdump -sass`` of the library: the main loop
    body (the largest loop of the kernel's word variant), its instruction
    count, the count per thread per round (``/ UNROLL``) and per pixel per
    round (``/ (4 * UNROLL)``), and its opcode histogram."""
    funcs, name = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    out = {}
    for fname, lines in funcs.items():
        m = _KERNEL.search(fname)
        if not m:
            continue
        loops = _loops(lines)
        if not loops:
            continue
        body = max(loops, key=len)
        kind = vpucal.KINDS[int(m.group(1))]
        out[kind] = {
            "function": fname,
            "loop_instructions": len(body),
            "per_thread_round": len(body) / UNROLL,
            "per_pixel_round": len(body) / (4 * UNROLL),
            "remainder_loop_instructions": min(len(b) for b in loops),
            "opcodes": dict(collections.Counter(body).most_common()),
        }
    return out


def _cuobjdump() -> Optional[str]:
    nvcc = _build.find_nvcc()
    if nvcc is None:
        return None
    path = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    return path if os.access(path, os.X_OK) else None


def library_sass() -> Optional[str]:
    """``cuobjdump -sass`` of the kernels' library; None without the tool."""
    tool = _cuobjdump()
    if tool is None:
        return None
    return subprocess.run([tool, "-sass", str(_build.build())], capture_output=True,
                          text=True, check=True, timeout=300).stdout


# -- vpucal --------------------------------------------------------------------


def _event_ms(fn) -> float:
    """Median ms of REPEATS CUDA-event-timed calls after a warm-up."""
    return float(np.median(device_samples(fn, REPEATS, "cuda"))) * 1e3


def cmd_vpucal(names=None) -> Dict[str, dict]:
    """The op-rate rows of ``names`` (all of :data:`ROWS` by default),
    printed one a line; returns ``{row: {...}}``."""
    if not torch.cuda.is_available():
        raise RuntimeError("vpucal needs a CUDA card: torch.cuda.is_available() is false")
    names = list(ROWS) if names is None else list(names)
    unknown = [n for n in names if n not in ROWS]
    if unknown:
        raise ValueError(f"unknown vpucal rows {unknown}; expected some of {ROWS}")
    smi = card()
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.integers(0, 256, SHAPE, dtype=np.uint8)).to("cuda")
    pix = x.numel()
    _build.load()
    sass = library_sass()
    counts = sass_loops(sass) if sass is not None else {}
    print(f"device: {torch.cuda.get_device_name(0)} | input {'x'.join(map(str, SHAPE))} "
          f"u8, k {K_LO} and {K_HI}, median of {REPEATS} CUDA-event-timed calls", flush=True)
    rows = {}
    for name in names:
        kind = _ROW_KIND[name]
        fn = vpucal.vpucal_plain if name == "torch" else vpucal.vpucal_chain
        times = {k: _event_ms(lambda k=k: fn(x, kind, k)) for k in (K_LO, K_HI)}
        dt = (times[K_HI] - times[K_LO]) / 1e3
        rate = 3 * (K_HI - K_LO) * pix / dt
        row = {"kind": kind, "ms_k_lo": times[K_LO], "ms_k_hi": times[K_HI],
               "ops_per_s": rate}
        shown = ""
        if name != "torch":
            c = counts.get(kind)
            if c is None:
                row["sass_per_pixel_round"] = None
                shown = ", SASS count not measured"
            else:
                per = c["per_pixel_round"]
                row.update(sass_per_pixel_round=per, sass_ops_per_s=rate * per / 3,
                           sass_loop_instructions=c["loop_instructions"],
                           sass_opcodes=c["opcodes"])
                shown = (f", SASS {per:.3f} instr/pixel/round ({c['loop_instructions']} in "
                         f"a {UNROLL}-round x 4-pixel loop) -> {rate * per / 3 / 1e12:6.2f} "
                         f"T instr/s")
        rows[name] = row
        print(f"{name:10s} {rate / 1e12:6.2f} T op/s at 3 op/round{shown} "
              f"(k{K_LO} {times[K_LO]:9.3f} ms, k{K_HI} {times[K_HI]:9.3f} ms) [{smi}]",
              flush=True)
    print(json.dumps({"vpucal": rows}))
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m rustyhgi_tpu_torch.tools.chip_probe",
        description="probes of the CUDA card",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("vpucal", help="op-rate calibration on the probe kernel K8")
    p.add_argument("names", nargs="?", default=None,
                   help=f"comma-separated rows, of {','.join(ROWS)} (default all)")
    args = parser.parse_args(argv)
    cmd_vpucal(args.names.split(",") if args.names else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
