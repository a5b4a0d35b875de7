"""Probes of the card, run one at a time.

Counterpart of the JAX repo's ``tools/chip_probe.py``.  Three subcommands
are ported: ``vpucal``, the op-rate calibration probe (``cmd_vpucal``), on
the probe kernel K8 (:mod:`..ops.vpucal`, ``csrc/hgi_probe.cu``);
``sweep`` (``cmd_sweep``), which times lossy K1's and K3's tile and fine
depth, the same for the decodes K2 and K5 (fine 0: a launch a level; K5's
previews; the tile at more plane counts and sizes), and X1's lanes a
block, where the JAX probe swept its Pallas kernel's row tiles; and
``validate`` (:func:`validate`), which holds the codec's kernels on the
card against the oracle at the JAX probe's five cases.  A fourth,
``times`` (``cmd_times``), times each kernel against its plain version
and its bound::

    python -m rustyhgi_tpu_torch.tools.chip_probe vpucal [names]
    python -m rustyhgi_tpu_torch.tools.chip_probe sweep
    python -m rustyhgi_tpu_torch.tools.chip_probe validate
    python -m rustyhgi_tpu_torch.tools.chip_probe times

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
last line is one JSON object ``{"vpucal": {row: {...}}}``.  Every
subcommand needs a CUDA card and raises without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import statistics
import subprocess
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import _build, vpucal
from ..ops.quantizers import QuantizationLevel, quantize_fn
from ..utils import profiling

__all__ = ["KERNELS", "REPLACES", "VALIDATE_CASES", "cmd_sweep", "cmd_times", "cmd_vpucal",
           "device_ms", "expanded", "kernel_rows", "main", "placed", "sass_chain", "sass_loops",
           "validate"]

SEED = 20261016
SHAPE = (8, 1080, 1920)
K_LO, K_HI = 200, 2000
REPEATS = 7  # timed or traced calls after a warm-up
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
    return [[_opcode(t) for t in body] for _, _, body in _loop_bodies(lines)]


def _loop_bodies(lines) -> list:
    """``[(first address, branch address, [instruction text])]`` of each
    loop of one function, NOPs left out."""
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
        loops.append((to, addr, [t for a, t in insns if to <= a <= addr and _opcode(t) != "NOP"]))
    return loops


def _functions(sass: str) -> Dict[str, list]:
    funcs, name = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return funcs


def sass_loops(sass: str) -> Dict[str, dict]:
    """Per kind, from ``cuobjdump -sass`` of the library: the main loop
    body (the largest loop of the kernel's word variant), its instruction
    count, the count per thread per round (``/ UNROLL``) and per pixel per
    round (``/ (4 * UNROLL)``), and its opcode histogram."""
    out = {}
    for fname, lines in _functions(sass).items():
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


_REGISTER = re.compile(r"\b(U?R\d+|U?P\d+)(\.64)?\b")
_GUARD = re.compile(r"^@!?(U?P\d+|U?PT)\s+")
# Opcodes (up to the first dot) that write no register.
_NO_DEST = {"ST", "STG", "STS", "STL", "BRA", "EXIT", "BAR", "RET", "CALL", "NOP", "YIELD",
            "WARPSYNC", "DEPBAR", "LDGDEPBAR", "LDGSTS", "RED", "REDUX", "CCTL", "MEMBAR",
            "ERRBAR", "BSYNC", "BSSY", "NANOSLEEP", "SYNCS", "ARRIVES"}


def _registers(operand: str, width: int = 1) -> list:
    """The registers an operand names; ``R4.64`` (or ``width`` 2 or 4) is
    R4 and the next ones."""
    out = []
    for m in _REGISTER.finditer(operand):
        name = m.group(1)
        n = 2 if m.group(2) else width
        kind, num = re.match(r"(U?[RP])(\d+)", name).groups()
        out += [f"{kind}{int(num) + i}" for i in range(n if kind.endswith("R") else 1)]
    return out


def _dataflow(text: str):
    """``(opcode, dests, sources)`` of one SASS instruction; a guarded
    instruction also reads its guard and, since it may not write, its
    destinations' old values."""
    guard = _GUARD.match(text)
    body = text[guard.end():] if guard else text
    op, _, rest = body.partition(" ")
    operands = [o.strip() for o in rest.split(",")] if rest.strip() else []
    srcs = _registers(guard.group(1)) if guard else []
    dests = []
    if op.split(".")[0] not in _NO_DEST and operands:
        width = 4 if ".128" in op else 2 if (".64" in op or ".WIDE" in op) else 1
        dests = _registers(operands[0], width)
        i = 1
        while i < len(operands) and re.fullmatch(r"!?(U?P\d+|U?PT)", operands[i]):
            dests += _registers(operands[i])  # carry-outs and second predicates
            i += 1
        operands = operands[i:]
        if ".WIDE" in op and len(operands) >= 3:  # a 64-bit addend
            srcs += _registers(operands[2], 2)
            operands = operands[:2] + operands[3:]
    for o in operands:
        srcs += _registers(o)
    if guard:
        srcs += dests
    return op, dests, srcs


def sass_chain(sass: str, function: str, rows: int, marker: str) -> Optional[dict]:
    """The dependent chain of the main loop of the first function whose
    name contains ``function``: of its innermost loops, the one with the
    most instructions of opcode ``marker`` (then the most instructions),
    whose body codes ``rows`` rows.  Returns its instruction count, the
    longest read-after-write path through its body in instructions
    (``chain``), that per row (``chain_per_row``), and the path's opcodes;
    None when no such function or loop exists."""
    for fname, lines in _functions(sass).items():
        if function not in fname:
            continue
        loops = _loop_bodies(lines)
        inner = [lp for lp in loops
                 if not any(o is not lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
        if not inner:
            return None
        body = max(inner, key=lambda lp: (sum(_opcode(t) == marker for t in lp[2]),
                                          len(lp[2])))[2]
        depth, path, writer = [], [], {}
        for text in body:
            op, dests, srcs = _dataflow(text)
            prev = [writer[r] for r in srcs if r in writer]
            best = max(prev, key=lambda i: depth[i]) if prev else None
            depth.append(1 + (depth[best] if best is not None else 0))
            path.append((op, best))
            for r in dests:
                writer[r] = len(depth) - 1
        end = max(range(len(depth)), key=depth.__getitem__)
        ops = []
        while end is not None:
            ops.append(path[end][0])
            end = path[end][1]
        return {"function": fname, "loop_instructions": len(body), "chain": max(depth),
                "chain_per_row": max(depth) / rows, "chain_opcodes": ops[::-1]}
    return None


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


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_summary(log: str, names) -> Dict[str, dict]:
    """From the build log's ``-Xptxas -v`` lines: registers, static shared
    memory and spill bytes of each kernel whose mangled name contains one
    of ``names``."""
    out, current = {}, None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            current = m.group(1) if any(n in m.group(1) for n in names) else None
            if current:
                out[current] = {}
            continue
        if current is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            out[current].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = _PTXAS_USED.search(line)
        if m:
            out[current].update(registers=int(m.group(1)), smem=int(m.group(2) or 0))
    return out


# -- vpucal --------------------------------------------------------------------


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
        times = {k: statistics.median(profiling.device_samples(lambda k=k: fn(x, kind, k),
                                                               REPEATS, "cuda")) * 1e3
                 for k in (K_LO, K_HI)}
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


# -- sweep ---------------------------------------------------------------------

SWEEP_SHAPES = ((1, 1080, 1920), (8, 1080, 1920))
SWEEP_TILES = ((16, 64), (32, 32), (32, 64), (64, 64), (32, 128), (64, 128), (128, 128))
SWEEP_LEVELS = (4, 8)
SWEEP_FINE = (4, 5)
SWEEP_DECODE_FINE = (0, 3, 4, 5)  # 0: every level a launch of its own
# The decodes' tile by the tiles a call cuts: previews at L4 (upto 2 is
# 1/16 of the pixels) and full decodes at more plane counts and sizes,
# at the default fine depth.
SWEEP_DECODE_TILES = ((16, 16), (16, 32), (32, 32), (32, 64), (64, 64), (64, 128), (128, 128))
SWEEP_PREVIEWS = (3, 2)
SWEEP_DECODE_SHAPES = ((2, 1080, 1920), (1, 2614, 2368), (4, 1080, 1920))
SWEEP_LANE_BLOCKS = (32, 64, 128)
SWEEP_X1_PLANES = (1, 8, 32)
SWEEP_BITPACK_SHAPES = ((1, 1080, 1920), (8, 1080, 1920))  # one stream of a grid's bytes


def _plane(rng, shape) -> np.ndarray:
    """A smooth plane with mild noise (waves plus sigma 6)."""
    *lead, h, w = shape
    y = np.linspace(0.0, 6.0, h)[:, None]
    x = np.linspace(0.0, 9.0, w)[None, :]
    base = 128 + 60 * np.sin(y) * np.cos(x) + 30 * np.sin(3 * x + y)
    return np.clip(base + rng.normal(0.0, 6.0, (*lead, h, w)), 0, 255).astype(np.uint8)


def _table(preset):
    q = quantize_fn(preset)
    return None if q.identity else q.table


def _traced_ms(records, only: str = "") -> Optional[float]:
    """Device ms of the records of ``profiling.device_trace`` whose name
    holds ``only``; None when none has time."""
    return sum(r.seconds for k, r in records.items() if only in k) * 1e3 or None


def device_ms(fn) -> Optional[float]:
    """Device ms of one call of ``fn``, its kernels, copies and memsets;
    None when the traces dropped records."""
    return _traced_ms(profiling.device_trace(fn, REPEATS))


def expanded(packed, widths, nb: int, n: int) -> torch.Tensor:
    """K6's 8-plane output framed and re-expanded on the host, as a reader
    gets it, on the card."""
    from ..ops import bitpack

    data = bitpack.finalize_packed(packed.cpu().numpy(), widths.cpu().numpy(), nb, n)
    return torch.from_numpy(bitpack.expand_packed(data, n)[0]).to("cuda")


def placed(body: torch.Tensor, n: int) -> torch.Tensor:
    """A copy of a codec-2 body placed as ``unpack_bytes`` places it: its
    planes on a 16-byte boundary."""
    from ..ops import bitpack

    pad = -(8 + (-(-n // bitpack.BLOCK) + 1) // 2) % 16
    buf = torch.empty(pad + body.numel(), dtype=torch.uint8, device=body.device)
    buf[pad:].copy_(body)
    return buf[pad:]


def _decode_rows(rows, img, levels, table, smi, fines, tiles, uptos=()) -> None:
    """K2's and K5's rows of the sweep on ``img`` at ``levels``: every
    fine depth of ``fines`` with every tile of ``tiles`` it divides (fine
    0, one launch a level, once), and K5's previews at each ``upto`` of
    ``uptos``; each checked equal to the plain version.  A row's key names
    the tiles the call cuts."""
    from ..ops import cuda_codec, pyramid

    hw = tuple(img.shape[-2:])
    b = img.shape[0] if img.dim() == 3 else 1
    grid, recon = cuda_codec.encode_plane(img, levels, table)
    anchors, subbands, _ = cuda_codec.encode_subbands(img, levels, table)
    if not torch.equal(pyramid.decode_plane(grid, levels), recon):
        raise RuntimeError("the plain decode differs from the recon")
    for fine in fines:
        if fine > levels:
            continue  # the same launches as fine = levels
        for tile in tiles[-1:] if fine == 0 else tiles:
            if (tile[0] | tile[1]) % (1 << fine):
                continue
            runs = [(name, upto) for upto in (levels, *uptos)
                    for name in (("K2", "K5") if upto == levels else ("K5",))]
            for name, upto in runs:
                s = 1 << (levels - upto)
                if name == "K2":
                    run = lambda: cuda_codec.decode_plane_tiled(grid, levels, "crossed", tile, fine)
                else:
                    run = lambda: cuda_codec.decode_preview_tiled(
                        anchors, subbands[:upto], hw, levels, upto, "crossed", tile, fine)
                if not torch.equal(run(), recon[..., ::s, ::s]):
                    raise RuntimeError(f"{name} upto {upto} tile {tile} fine {fine} differs at "
                                       f"{tuple(img.shape)} L{levels}")
                ms = device_ms(run)
                cut = b * -(-hw[0] // s // tile[0]) * -(-hw[1] // s // tile[1])
                key = (f"{'x'.join(map(str, img.shape))} L{levels}"
                       + (f" preview {upto}" if upto < levels else "") + f" fine {fine}"
                       + ("" if fine == 0 else f" tile {tile[0]}x{tile[1]} ({cut} tiles)"))
                rows[name.lower()][key] = ms
                print(f"sweep {name} {key}: device {ms if ms is None else f'{ms:.4f}'} ms "
                      f"[{smi}]", flush=True)


def _bitpack_rows(rows, img, table, smi) -> None:
    """K6 and K7 at each of ``bitpack.PER_WARP`` on ``img``'s residual grid
    as one stream, each output checked against the plain version's."""
    from ..ops import bitpack, cuda_codec

    flat = cuda_codec.encode_plane(img, 4, table)[0].reshape(-1)
    n = flat.numel()
    body = bitpack.pack_stream_plain(flat)
    body_placed = placed(body, n)
    packed, widths, nb = bitpack.pack_plain(flat)
    full = expanded(packed, widths, nb, n)
    shape = "x".join(map(str, img.shape))
    for per in bitpack.PER_WARP:
        buf, head, start = bitpack.pack_compact(flat, per)
        total = int(buf[:8].view(torch.int64).item())
        got = bitpack.pack_blocks(flat, per)
        if not (torch.equal(buf[head : start + 128 * total], body)
                and torch.equal(got[0], packed) and torch.equal(got[1], widths)):
            raise RuntimeError(f"K6 at {per} blocks a warp differs at {shape}")
        if not torch.equal(bitpack.unpack_stream(body_placed, n, per), flat):
            raise RuntimeError(f"K7 at {per} blocks a warp differs at {shape}")
        if not torch.equal(bitpack.unpack_blocks(full, per)[:n], flat):
            raise RuntimeError(f"K7 8-plane at {per} blocks a warp differs at {shape}")
        for name, fn in (
                ("K6 compacting", lambda: bitpack.pack_compact(flat, per)),
                ("K6 8-plane", lambda: bitpack.pack_blocks(flat, per)),
                ("K7 compacted", lambda: bitpack.unpack_stream(body_placed, n, per)),
                ("K7 8-plane", lambda: bitpack.unpack_blocks(full, per))):
            key = f"{shape} {name} {per} a warp"
            rows[key] = ms = device_ms(fn)
            print(f"sweep {key}: device {ms if ms is None else f'{ms:.4f}'} ms [{smi}]",
                  flush=True)


def _same_layout(got, want) -> bool:
    """Whether two subband encodes give the same anchors, quads and recon."""
    return (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
            and all(torch.equal(a, b) for qa, qb in zip(got[1], want[1]) for a, b in zip(qa, qb)))


def cmd_sweep() -> Dict[str, dict]:
    """Lossy K1's and K3's tile and fine depth, K2's and K5's (with K5's previews
    and more plane counts and sizes for the decodes' tile), X1's lanes
    a block, and K6's and K7's blocks a warp (both contracts), by device time
    (``torch.profiler``, the mean of ``REPEATS`` calls), on smooth
    planes at medium; every choice's output is checked equal to the
    default's or the plain version's.  Prints a row a line, then one JSON
    object ``{"sweep": {...}, "launches": {...}}``, the latter the wrapper
    calls of K1, K2, K3, K5, K6, K7 and X1 the sweep made."""
    if not torch.cuda.is_available():
        raise RuntimeError("sweep needs a CUDA card: torch.cuda.is_available() is false")
    from ..ops import bitpack, cuda_codec, pyramid, tpurans

    smi = card()
    rng = np.random.default_rng(SEED)
    table = quantize_fn(QuantizationLevel.MEDIUM).table

    rows = {"k1": {}, "k3": {}, "k2": {}, "k5": {}, "x1": {}, "bitpack": {}}
    counters = {"K1": (cuda_codec, "encode_launches"), "K2": (cuda_codec, "decode_launches"),
                "K3": (cuda_codec, "encode_subbands_launches"),
                "K5": (cuda_codec, "decode_subbands_launches"), "X1": (tpurans, "rans_launches"),
                "K6": (bitpack, "pack_launches"), "K7": (bitpack, "unpack_launches")}
    before = {k: getattr(m, a) for k, (m, a) in counters.items()}
    print(f"device: {torch.cuda.get_device_name(0)} | K1, K3, K2, K5 medium (crossed) and X1 on "
          f"smooth planes; device ms, torch.profiler mean | default tile {cuda_codec.TILE}, "
          f"fine {cuda_codec.FINE_LEVELS}, decode tiles {cuda_codec.DECODE_TILES}, fine "
          f"{cuda_codec.DECODE_FINE_LEVELS}, lane block {tpurans.LANE_BLOCK}", flush=True)
    for shape in SWEEP_SHAPES:
        img = torch.from_numpy(_plane(rng, shape)).to("cuda")
        for levels in SWEEP_LEVELS:
            fine = cuda_codec.DECODE_FINE_LEVELS
            if levels == SWEEP_LEVELS[0]:  # every decode tile and the previews at one depth
                _decode_rows(rows, img, levels, table, smi,
                             [f for f in SWEEP_DECODE_FINE if f != fine], SWEEP_TILES)
                _decode_rows(rows, img, levels, table, smi, (fine,),
                             SWEEP_DECODE_TILES, SWEEP_PREVIEWS)
            else:
                _decode_rows(rows, img, levels, table, smi, SWEEP_DECODE_FINE, SWEEP_TILES)
            want = cuda_codec.encode_plane(img, levels, table)
            want_sub = pyramid.encode_subbands(img, levels, table)
            for fine in SWEEP_FINE:
                if fine > min(SWEEP_FINE) and fine > levels:
                    continue  # F = min(L, fine): the same launch as fine 4
                for tile in SWEEP_TILES:
                    if (tile[0] | tile[1]) % (1 << fine):
                        continue
                    run = lambda: cuda_codec.encode_plane_tiled(img, levels, table, "crossed",
                                                                tile, fine)
                    got = run()
                    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                        raise RuntimeError(f"K1 tile {tile} fine {fine} differs at {shape} L{levels}")
                    key = f"{'x'.join(map(str, shape))} L{levels} fine {fine} tile {tile[0]}x{tile[1]}"
                    rows["k1"][key] = ms = device_ms(run)
                    print(f"sweep K1 {key}: device {ms if ms is None else f'{ms:.4f}'} ms [{smi}]",
                          flush=True)
                    run = lambda: cuda_codec.encode_subbands_tiled(img, levels, table, "crossed",
                                                                   True, tile, fine)
                    if not _same_layout(run(), want_sub):
                        raise RuntimeError(f"K3 tile {tile} fine {fine} differs at {shape} L{levels}")
                    rows["k3"][key] = ms = device_ms(run)
                    print(f"sweep K3 {key}: device {ms if ms is None else f'{ms:.4f}'} ms [{smi}]",
                          flush=True)
    grid = cuda_codec.encode_plane(torch.from_numpy(_plane(rng, (1, 1080, 1920))).to("cuda"),
                                   4, table)[0].reshape(1, -1)
    for planes in SWEEP_X1_PLANES:
        sym = grid.expand(planes, -1).contiguous()
        want = tpurans.encode_batch(sym)
        for lb in SWEEP_LANE_BLOCKS:
            got = tpurans.encode_batch(sym, lb)
            if not all(torch.equal(a, b) for a, b in zip(got[:3], want[:3])):
                raise RuntimeError(f"X1 lane block {lb} differs at {planes} planes")
            ms = device_ms(lambda: tpurans.encode_batch(sym, lb))
            key = f"{planes}x1080x1920 lane block {lb}"
            rows["x1"][key] = ms
            print(f"sweep X1 {key}: device {ms if ms is None else f'{ms:.4f}'} ms [{smi}]",
                  flush=True)
    for shape in SWEEP_BITPACK_SHAPES:
        _bitpack_rows(rows["bitpack"], torch.from_numpy(_plane(rng, shape)).to("cuda"), table, smi)
    drng = np.random.default_rng([SEED, 1])
    for shape in SWEEP_DECODE_SHAPES:
        img = torch.from_numpy(_plane(drng, shape)).to("cuda")
        _decode_rows(rows, img, SWEEP_LEVELS[0], table, smi,
                     (cuda_codec.DECODE_FINE_LEVELS,), SWEEP_DECODE_TILES[-2:])
    launches = {k: getattr(m, a) - before[k] for k, (m, a) in counters.items()}
    print(json.dumps({"sweep": rows, "launches": launches}))
    return rows


# -- times ---------------------------------------------------------------------

TIMES_SHAPES = ((1, 1080, 1920), (8, 1080, 1920))
X1_SCALING_SHAPES = ((1, 1080, 1920), (1, 2614, 2368), (1, 4096, 4096), (8, 1080, 1920),
                     (32, 1080, 1920))
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "X1")
_CODEC_SRC = "rustyhgi_tpu_torch/csrc/hgi_codec.cu"
_ENTROPY_SRC = "rustyhgi_tpu_torch/csrc/hgi_entropy.cu"
_PROBE_SRC = "rustyhgi_tpu_torch/csrc/hgi_probe.cu"
REPLACES = {  # C entry point, the TPU kernel it replaces, its source
    "K1": ("hgi_encode", "rustyhgi_tpu/ops/pallas_codec.py:778", _CODEC_SRC),
    "K2": ("hgi_decode", "rustyhgi_tpu/ops/pallas_codec.py:1037", _CODEC_SRC),
    "K3": ("hgi_encode_subbands", "rustyhgi_tpu/ops/pallas_codec.py:913", _CODEC_SRC),
    "K4": ("hgi_assemble_grid", "rustyhgi_tpu/ops/pallas_codec.py:1249", _CODEC_SRC),
    "K5": ("hgi_decode_subbands", "rustyhgi_tpu/ops/pallas_codec.py:1321", _CODEC_SRC),
    "K6": ("bitpack_pack_compact", "rustyhgi_tpu/ops/pallas_kernels.py:120", _ENTROPY_SRC),
    "K7": ("bitpack_unpack_compact", "rustyhgi_tpu/ops/pallas_kernels.py:157", _ENTROPY_SRC),
    # the same kernels without compaction, JAX's contract: timed beside
    # them and kept in their records under "eight_plane"
    "K6 8-plane": ("bitpack_pack", "rustyhgi_tpu/ops/pallas_kernels.py:120", _ENTROPY_SRC),
    "K7 8-plane": ("bitpack_unpack", "rustyhgi_tpu/ops/pallas_kernels.py:157", _ENTROPY_SRC),
    "K8": ("hgi_vpucal", "tools/chip_probe.py:641", _PROBE_SRC),
    "X1": ("rans_tpu_encode", "rustyhgi_tpu/ops/tpurans.py:172", _ENTROPY_SRC),
}
# The published device-memory rate of one H100 SXM at 700 W.  The kernels'
# operations are held to the card's issue ceiling: each of an SM's four
# schedulers issues one 32-lane warp instruction a clock, so 132 SMs x 128
# lanes x the SM clock (about 33.4 T instructions/s at 1980 MHz; the data
# sheet's 67 TFLOP/s of FP32 is the same ceiling with an FMA counted as two
# operations).  No mix of integer or FP32 instructions issues faster: K8's
# chains of IADD3, LOP3, ISETP or FADD come within 4% of it, and a chain of
# shifts (SHF, on the 64-lane INT32 pipe alone) reads half of it.  Where a K8 row's
# SASS rate is higher, the bound takes it, so that it stays a lower bound.
PEAK_BYTES_PER_S = 3.35e12
SMS, DISPATCH_LANES_PER_SM, INT32_LANES_PER_SM = 132, 128, 64
K8_ROUNDS = K_LO  # K8's rounds in its row
X1_ROWS_A_LOOP = 8  # rows a pass of X1's main lanes loop codes (two groups of 4, hgi_entropy.cu)
# K6's and K7's operations a symbol, from the function, not from either
# kernel: its fold, one operation, and each of its 8 bits put into its
# own plane, one operation a bit on 32-bit words of 4 symbols, so two a
# symbol.  The bytes set their bound at any count near this.
BITPACK_OPS_PER_SYMBOL = 3


def max_sm_mhz() -> float:
    """The SM clock's maximum in MHz, as nvidia-smi reports it."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0])


def kernel_rows(img: torch.Tensor, table) -> list:
    """``[(row, kernel call, plain call, bytes, operations)]`` on ``img`` at
    L4 under ``table``: the bytes each input read once and each output
    written once; the integer operations of K1-K5 and X1 estimated from
    the kernel's source per element, those of K6 and K7 counted from the
    function (BITPACK_OPS_PER_SYMBOL)."""
    from ..ops import bitpack, cuda_codec, pyramid, tpurans, vpucal

    hw = img.shape[-2:]
    b, n = img.shape[0], img.numel()
    lossy = n if table is not None else 0
    anchors, subbands, _ = cuda_codec.encode_subbands(img, 4, table)
    grid = cuda_codec.encode_plane(img, 4, table)[0]
    canvas = anchors.numel() + sum(q.numel() for quads in subbands for q in quads)
    flat = grid.reshape(-1)
    packed, widths, nb = bitpack.pack_blocks(flat)
    full = expanded(packed, widths, nb, n)
    body = placed(bitpack.pack_stream(flat), n)  # as codec 2's read places it
    sym = grid.reshape(b, -1)
    counts = tpurans.encode_batch(sym)[1]
    lanes, words = counts.shape[1], int(counts.sum())
    cells = b * lanes * -(-sym.shape[1] // lanes)
    return [
        ("K1", lambda: cuda_codec.encode_plane(img, 4, table),
         lambda: pyramid.encode_plane(img, 4, table), 2 * n + lossy, 12 * n),
        ("K2", lambda: cuda_codec.decode_plane(grid, 4),
         lambda: pyramid.decode_plane(grid, 4), 2 * n, 8 * n),
        ("K3", lambda: cuda_codec.encode_subbands(img, 4, table),
         lambda: pyramid.encode_subbands(img, 4, table), n + canvas + lossy, 12 * canvas),
        ("K4", lambda: cuda_codec.assemble_grid(anchors, subbands, hw),
         lambda: pyramid.assemble_grid(anchors, subbands, hw), canvas + n, 10 * n),
        ("K5", lambda: cuda_codec.decode_subbands(anchors, subbands, hw, 4),
         lambda: pyramid.decode_subbands(anchors, subbands, hw, 4), canvas + n, 8 * canvas),
        ("K6", lambda: bitpack.pack_compact(flat), lambda: bitpack.pack_stream_plain(flat),
         n + body.numel(), BITPACK_OPS_PER_SYMBOL * n),
        ("K7", lambda: bitpack.unpack_stream(body, n),
         lambda: bitpack.unpack_stream_plain(body, n), body.numel() + n,
         BITPACK_OPS_PER_SYMBOL * n),
        ("K6 8-plane", lambda: bitpack.pack_blocks(flat), lambda: bitpack.pack_plain(flat),
         n + packed.numel() + 4 * nb, BITPACK_OPS_PER_SYMBOL * n),
        ("K7 8-plane", lambda: bitpack.unpack_blocks(full),
         lambda: bitpack.unpack_plain(full), 2 * full.numel(), BITPACK_OPS_PER_SYMBOL * n),
        ("X1", lambda: tpurans.encode_batch(sym), lambda: tpurans.encode_plain(sym),
         n + 4 * b * (256 + 2 * lanes) + 2 * words, 22 * cells),
        ("K8", lambda: vpucal.vpucal_chain(img, "mix3", K8_ROUNDS),
         lambda: vpucal.vpucal_plain(img, "mix3", K8_ROUNDS), 2 * n, 3 * K8_ROUNDS * n),
        # without a plain version or a bound: the bench's call of K3, and
        # the one PyTorch call that computes X1's histogram stage
        ("K3 no recon", lambda: cuda_codec.encode_subbands(img, 4, table, want_recon=False),
         None, 0, 0),
        ("torch.bincount", lambda: torch.bincount(flat, minlength=256), None, 0, 0),
    ]


def x1_chain(mhz: float) -> dict:
    """X1's lanes loop in SASS (``cuobjdump -sass`` of the library): its
    dependent chain a row, and what that gives at 4 cycles an instruction;
    empty without cuobjdump.  Raises unless the loop is found and divides
    nowhere."""
    from ..ops import tpurans

    sass = library_sass()
    if sass is None:
        return {}
    name = f"rans_encode_lanesILi{tpurans.LANE_BLOCK}ELb1E"
    chain = sass_chain(sass, name, X1_ROWS_A_LOOP, "IMAD.HI.U32")
    if chain is None:
        raise RuntimeError(f"no lanes loop found in the SASS of {name}")
    if any(op.startswith(("IDIV", "I2F", "MUFU")) for op in chain["chain_opcodes"]):
        raise RuntimeError(f"X1's lanes loop divides: {chain['chain_opcodes']}")
    chain["ns_a_row"] = chain["chain_per_row"] * 4 / mhz * 1e3
    return chain


def _x1_scaling(rng, smi: str, chain: dict) -> None:
    """X1 alone: its device time against its rows T and its threads B*L at
    medium, beside its chain bound.  A lane codes its T rows in turn, so
    while the card has idle room the time follows T, not the pixels."""
    from ..ops import cuda_codec, tpurans

    for shape in X1_SCALING_SHAPES:
        img = torch.from_numpy(_plane(rng, shape)).to("cuda")
        grid = cuda_codec.encode_plane(img, 4, _table(QuantizationLevel.MEDIUM))[0]
        sym = grid.reshape(shape[0], -1)
        lanes = tpurans.lanes_for(sym.shape[1])
        rows = -(-sym.shape[1] // lanes)
        parts = profiling.device_trace(lambda: tpurans.encode_batch(sym), REPEATS)
        dev = _traced_ms(parts)
        shown = ("not measured" if dev is None
                 else f"{dev:.4f} ms, {sym.numel() / dev / 1e3:.1f} MPix/s")
        by_kernel = ", ".join(f"{name} {_traced_ms(parts, name) or 0:.4f}" for name in (
            "rans_histogram", "rans_normalize", "rans_encode_lanes", "Memset"))
        bound = f"{rows * chain['ns_a_row'] / 1e6:.4f} ms" if chain else "not measured"
        print(f"x1-scaling {'x'.join(map(str, shape))} medium: L {lanes}, T {rows}, "
              f"{shape[0] * lanes} threads: device {shown} ({by_kernel} ms); chain bound "
              f"{bound} [{smi}]", flush=True)


def _events(fn) -> list:
    """ms of REPEATS CUDA-event-timed calls of ``fn`` after a warm-up, L2
    flushed; none when ``fn`` is None."""
    return [] if fn is None else [t * 1e3 for t in profiling.device_samples(fn, REPEATS, "cuda")]


def _shown(d, e) -> str:
    return ("not measured (no device time in the trace)" if d is None
            else f"{d:.4f} ms ({100 * (1 - d / e):.1f}% idle in the event window)")


def cmd_times() -> list:
    """Each kernel against its plain version on the same inputs, at 1x and
    8x1080x1920 L4, lossless and medium, on smooth planes: the median and
    range of ``2 * REPEATS`` CUDA-event-timed calls (L2 flushed; plain,
    kernel, kernel, plain), the device time and the device kernels of one
    call (``profiling.device_trace``), and the bound: the larger of the
    bytes over PEAK_BYTES_PER_S and the operations over the issue ceiling
    (SMS x DISPATCH_LANES_PER_SM x the SM clock's maximum) or the highest
    SASS rate a K8 chain measured (``cmd_vpucal``), where that is higher.
    Also X1's histogram stage against ``torch.bincount``, X1's chain bound
    from the SASS of its lanes loop, and X1's device time from one plane
    to 32.  Prints a row a line; the last line is one JSON object
    ``{"kernels": [...]}``, a record a kernel at 1x1080x1920 L4 medium;
    returns that list."""
    if not torch.cuda.is_available():
        raise RuntimeError("times needs a CUDA card: torch.cuda.is_available() is false")
    from ..ops import tpurans

    smi, mhz = card(), max_sm_mhz()
    _build.load()
    print(f"device: {torch.cuda.get_device_name(0)} | K1-K8 and X1 against their plain "
          f"versions on smooth planes at L4; {2 * REPEATS} CUDA-event-timed calls, L2 "
          f"flushed; device time the mean of {REPEATS} calls under torch.profiler", flush=True)
    rng = np.random.default_rng([SEED, 9])
    cases = {}
    for shape in TIMES_SHAPES:
        img = torch.from_numpy(_plane(rng, shape)).to("cuda")
        for preset in (QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM):
            cases["x".join(map(str, shape)), preset.name.lower()] = kernel_rows(
                img, _table(preset))
    # Every trace first: the plain versions launch many kernels (X1's a
    # kernel per symbol row), after which the profiler's traces drop records.
    traced = {(row, *case): profiling.device_trace(kern, REPEATS)
              for case, calls in cases.items() for row, kern, *_ in calls}
    chain = x1_chain(mhz)
    if chain:
        print(f"X1 lanes loop ({chain['function']}): {chain['loop_instructions']} SASS "
              f"instructions for {X1_ROWS_A_LOOP} rows; dependent chain {chain['chain']} "
              f"({chain['chain_per_row']:g} a row: {' '.join(chain['chain_opcodes'])}); at 4 "
              f"cycles each and {mhz:.0f} MHz, {chain['ns_a_row']:.2f} ns a row [{smi}]",
              flush=True)
    else:
        print("X1 lanes loop: cuobjdump not found, chain not measured", flush=True)
    _x1_scaling(rng, smi, chain)

    rates = cmd_vpucal()
    ceiling = SMS * DISPATCH_LANES_PER_SM * mhz * 1e6
    sass = {name: r["sass_ops_per_s"] for name, r in rates.items() if r.get("sass_ops_per_s")}
    peak_ops = max(ceiling, *sass.values())
    shown = ", ".join(f"{name} {v / 1e12:.3f}" for name, v in sass.items()) or "not measured"
    print(f"ops bound: issue ceiling {SMS} SMs x {DISPATCH_LANES_PER_SM} lanes x {mhz:.0f} MHz = "
          f"{ceiling / 1e12:.3f} T instr/s (the {INT32_LANES_PER_SM}-lane INT32 pipe alone "
          f"{SMS * INT32_LANES_PER_SM * mhz * 1e6 / 1e12:.3f} T); K8 mix3x16 measured "
          f"{rates['mix3x16']['ops_per_s'] / 1e12:.3f} T op/s at 3 op/round; K8 SASS rates "
          f"(T instr/s): {shown}; the bounds use {peak_ops / 1e12:.3f} T op/s [{smi}]",
          flush=True)

    rows = {}
    for (shape, preset), calls in cases.items():
        for row, kern, plain, io_bytes, ops in calls:
            # Plain, kernel, kernel, plain: compare within one call.
            p1, k1 = _events(plain), _events(kern)
            k2, p2 = _events(kern), _events(plain)
            k = statistics.median(k1 + k2)
            records = traced[row, shape, preset]
            dev = _traced_ms(records)
            out = rows[row, shape, preset] = {
                "ms": k, "device_ms": dev,
                "device_launches": profiling.kernel_launches(records)}
            what = f"mix3 k={K8_ROUNDS}" if row == "K8" else f"L4 {preset}"
            label = f"{row} {REPLACES[row][0]}" if row in REPLACES else row
            text = (f"time {label} {shape} {what}: kernel median {k:.4f} ms "
                    f"[{min(k1 + k2):.4f}..{max(k1 + k2):.4f}]")
            if plain:
                p = statistics.median(p1 + p2)
                t_bytes, t_ops = io_bytes / PEAK_BYTES_PER_S, ops / peak_ops
                out.update(plain_ms=p, bound_ms=max(t_bytes, t_ops) * 1e3,
                           bound_by="bytes" if t_bytes >= t_ops else "operations")
                text += (f", plain median {p:.4f} ms [{min(p1 + p2):.4f}..{max(p1 + p2):.4f}], "
                         f"{2 * REPEATS} runs each, L2 flushed; bound {out['bound_ms']:.4f} ms "
                         f"by {out['bound_by']} ({io_bytes} B, {ops} ops)")
            else:
                text += f", {2 * REPEATS} runs, L2 flushed"
            print(f"{text} [{smi}]", flush=True)
            # The event window includes the wrapper's host time whenever
            # the card finishes first; the profiler's device time does not.
            count = ("launches not measured" if out["device_launches"] is None
                     else f"{out['device_launches']:g} device launch(es) a call")
            print(f"device {row} {shape} {what}: kernel {_shown(dev, k)}, torch.profiler mean "
                  f"of {REPEATS} calls; {count} [{smi}]", flush=True)
        hist = _traced_ms(traced["X1", shape, preset], "rans_histogram")
        rows["X1", shape, preset]["histogram_device_ms"] = hist
        lib = rows["torch.bincount", shape, preset]
        lib_ms, lib_dev = lib["ms"], lib["device_ms"]
        print(f"histogram {shape} L4 {preset}: X1 rans_histogram device "
              f"{'not measured' if hist is None else f'{hist:.4f} ms'}; torch.bincount event "
              f"median {lib_ms:.4f} ms, device "
              f"{'not measured' if lib_dev is None else f'{lib_dev:.4f} ms'} "
              f"[{smi}]", flush=True)

    kernels = []
    _, h, w = TIMES_SHAPES[0]
    shape = "x".join(map(str, TIMES_SHAPES[0]))
    for kernel in KERNELS:
        entry, replaces, src = REPLACES[kernel]
        row = rows[kernel, shape, "medium"]
        record = {"name": f"{kernel} {entry}", "route": "cuda", "source": src,
                  "replaces": replaces, "library_ms": None,
                  **{k: row[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                         "device_launches")}}
        if kernel in ("K6", "K7"):
            eight = rows[f"{kernel} 8-plane", shape, "medium"]
            record["eight_plane"] = {"name": REPLACES[f"{kernel} 8-plane"][0],
                                     **{k: eight[k] for k in ("ms", "device_ms", "plain_ms",
                                                              "bound_ms", "device_launches")}}
        if kernel == "X1":  # the histogram stage against torch.bincount; the chain bound
            record["histogram_device_ms"] = row["histogram_device_ms"]
            record["bincount_ms"] = rows["torch.bincount", shape, "medium"]["ms"]
            t = -(-h * w // tpurans.lanes_for(h * w))
            record["chain_bound_ms"] = t * chain["ns_a_row"] / 1e6 if chain else None
        kernels.append(record)
    print(json.dumps({"kernels": kernels}))
    return kernels


# -- validate ------------------------------------------------------------------

# The JAX probe's cases: ((height, width), levels, preset, predictor).
VALIDATE_CASES = (
    ((1080, 1920), 4, QuantizationLevel.LOSSLESS, "crossed"),
    ((1080, 1920), 4, QuantizationLevel.MEDIUM, "crossed"),
    ((517, 1024), 3, QuantizationLevel.LOSSLESS, "crossed"),  # ragged height
    ((300, 500), 4, QuantizationLevel.MEDIUM, "crossed"),  # ragged height and width
    ((256, 384), 5, QuantizationLevel.HIGH, "left_top"),
)
VALIDATE_COLUMNS = ("grid", "decode", "subband", "sb-decode", "plain", "native")


def validate(cases=VALIDATE_CASES) -> dict:
    """The codec's kernels on the card against the oracle, at each case
    of ``cases`` (default the JAX probe's five), on seeded random bytes:

    * grid: K1's grid equals ``oracle_encode``'s;
    * decode: K2 of the oracle's grid equals ``oracle_decode``'s plane;
    * subband: K3's anchors, quads and recon equal the plain version's
      (:func:`..ops.pyramid.encode_subbands` on the card), and its quads
      assembled into a grid equal the oracle's;
    * sb-decode: K5 of the plain version's layout equals the plain
      version's decode and the oracle's plane;
    * plain: the plain version's grid and decode on the card equal the
      oracle's (the JAX probe's ``planar`` column, whose engine is the
      plain version here);
    * native: the scalar C++ stand-in's grid and decode equal the
      oracle's; Crossed only, so a left_top case reads ``n/a``.

    Prints a line a case in the JAX probe's form, then one JSON object
    ``{"validate": {case: {column: true|false|null}}, "seconds": {case:
    s}, "launches": {...}, "ok": ...}``: each case's host seconds, most
    of them the oracle's, and the wrapper calls of K1, K2, K3 and K5 it
    made; returns that object.  Needs a CUDA card and raises
    without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("validate needs a CUDA card: torch.cuda.is_available() is false")
    from ..ops import cuda_codec, native, pyramid
    from ..oracle import oracle_decode, oracle_encode

    counters = {"K1": "encode_launches", "K2": "decode_launches",
                "K3": "encode_subbands_launches", "K5": "decode_subbands_launches"}
    before = {k: getattr(cuda_codec, a) for k, a in counters.items()}
    print(f"device: {torch.cuda.get_device_name(0)} [{card()}] | the kernels against the "
          f"oracle (rustyhgi_tpu_torch.oracle) on np.random.default_rng(1) bytes", flush=True)
    rng = np.random.default_rng(1)
    rows, seconds = {}, {}
    for (h, w), levels, preset, pred in cases:
        t0 = time.perf_counter()
        img = rng.integers(0, 256, (h, w), np.uint8)
        q = quantize_fn(preset)
        table = None if q.identity else q.table
        x = torch.from_numpy(img).to("cuda")
        grid_o = oracle_encode(img, levels, preset, pred)
        plane_o = oracle_decode(grid_o, levels, pred)
        grid_od = torch.from_numpy(grid_o).to("cuda")

        def same(t, want) -> bool:
            return np.array_equal(t.cpu().numpy(), want)

        plain_sb = pyramid.encode_subbands(x, levels, table, pred)
        anchors, subbands, _ = plain_sb
        k3 = cuda_codec.encode_subbands(x, levels, table, pred)
        k5 = cuda_codec.decode_subbands(anchors, subbands, (h, w), levels, pred)
        row = {
            "grid": same(cuda_codec.encode_plane(x, levels, table, pred)[0], grid_o),
            "decode": same(cuda_codec.decode_plane(grid_od, levels, pred), plane_o),
            "subband": _same_layout(k3, plain_sb)
            and same(pyramid.assemble_grid(k3[0], k3[1], (h, w)), grid_o),
            "sb-decode": torch.equal(k5, pyramid.decode_subbands(anchors, subbands, (h, w),
                                                                 levels, pred))
            and same(k5, plane_o),
            "plain": same(pyramid.encode_plane(x, levels, table, pred)[0], grid_o)
            and same(pyramid.decode_plane(grid_od, levels, pred), plane_o),
            "native": None if pred != "crossed" else bool(
                np.array_equal(native.native_encode(img, levels, preset), grid_o)
                and np.array_equal(native.native_decode(grid_o, levels), plane_o)),
        }
        key = f"{h}x{w} l{levels} {preset.name} {pred}"
        rows[key] = row
        seconds[key] = time.perf_counter() - t0
        shown = " ".join(f"{c}={'n/a' if v is None else 'OK' if v else 'FAIL'}"
                         for c, v in row.items())
        print(f"{key}: {shown}", flush=True)
    launches = {k: getattr(cuda_codec, a) - before[k] for k, a in counters.items()}
    out = {"validate": rows, "seconds": seconds, "launches": launches,
           "ok": all(v is not False for row in rows.values() for v in row.values())}
    print(json.dumps(out))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m rustyhgi_tpu_torch.tools.chip_probe",
        description="probes of the CUDA card",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("vpucal", help="op-rate calibration on the probe kernel K8")
    p.add_argument("names", nargs="?", default=None,
                   help=f"comma-separated rows, of {','.join(ROWS)} (default all)")
    sub.add_parser("sweep", help="the tile and fine depth of lossy K1, K3, K2 and K5, X1's "
                                 "lanes a block")
    sub.add_parser("validate", help="K1, K2, K3, K5, the plain version and the C++ stand-in "
                                    "against the oracle at the JAX probe's five cases")
    sub.add_parser("times", help="K1-K8 and X1 against their plain versions and their bounds")
    args = parser.parse_args(argv)
    if args.command == "validate":
        return 0 if validate()["ok"] else 1
    if args.command == "sweep":
        cmd_sweep()
    elif args.command == "times":
        cmd_times()
    else:
        cmd_vpucal(args.names.split(",") if args.names else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
