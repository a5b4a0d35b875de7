"""Codec 4 of ``.thgi``, the context-adaptive binary range coder, in plain
NumPy, written from the format's description; it codes a batch of
payloads of one piece table in lockstep, one array element a payload.

The payload is the subband layout's pieces one after another: the
anchors (group 0), then each level's three quads, coarsest first, in
group ``min(level + 1, 4)``.  Each byte is coded as follows:

* the anchors piece codes ``(v - pred) & 255`` with ``pred`` the left
  neighbour, the upper one in column 0, and 128 at the piece's corner;
  every other piece codes its bytes as they are;
* the coded byte is zigzagged, ``2v`` below 128 and ``2 (256 - v) - 1``
  from 128 up;
* its context is (group, activity bucket), the activity being the
  zigzagged values to its left and above in the same piece (0 outside
  it), bucketed by the thresholds 1, 3, 8 and 20: 25 contexts;
* the zigzagged byte is 8 binary decisions, high bit first, down a tree
  of 255 nodes (node 1 the root, a child ``2 node + bit``) of 12-bit
  probabilities of a 0, all 2048 at the start; after each decision the
  node's probability moves by ``(4096 - p) >> shift`` up on a 0 and by
  ``p >> shift`` down on a 1, ``shift`` 5 for lossless and 4 for the
  lossy presets;
* a carryless 32-bit range coder codes each decision: ``bound = (range
  >> 12) p``; a 0 keeps ``[low, low + bound)``, a 1 the rest.  Then,
  while the top bytes of ``low`` and ``low + range`` agree, or else while
  ``range`` is below 2**16 (``range`` cut first to ``-low mod 2**16``),
  the top byte of ``low`` is written and both shift left by 8.  At the
  end the four bytes of ``low`` follow, high first.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["piece_table", "encode", "decode"]

PROB_BITS = 12
ONE = 1 << PROB_BITS
GROUPS, BUCKETS = 5, 5
CONTEXTS = GROUPS * BUCKETS
THRESHOLDS = np.array([1, 3, 8, 20])
TOP, BOT = 1 << 24, 1 << 16
BLOCK = 4096  # symbols whose decisions are laid out at once


def piece_table(anchor_shape: Tuple[int, int],
                quad_shapes: Sequence[Tuple[int, int]]) -> List[Tuple[int, int, int]]:
    """``(h, w, group)`` of each piece of a subband payload."""
    rows = [(int(anchor_shape[0]), int(anchor_shape[1]), 0)]
    for level, (h, w) in enumerate(quad_shapes):
        rows += [(int(h), int(w), min(level + 1, GROUPS - 1))] * 3
    return rows


def _next_prob(shift: int) -> np.ndarray:
    """``[2 * 4096]``: a node's next probability after a 0 (first half)
    or a 1 (second half), by its probability."""
    p = np.arange(ONE, dtype=np.int64)
    return np.concatenate((p + ((ONE - p) >> shift), p - (p >> shift))).astype(np.uint32)


def _zigzag(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64)
    return np.where(v < 128, 2 * v, 2 * (256 - v) - 1)


def _unzigzag(z: np.ndarray) -> np.ndarray:
    return np.where(z & 1, (256 - ((z + 1) >> 1)) & 255, z >> 1)


def _symbols(payload: np.ndarray, pieces) -> Tuple[np.ndarray, np.ndarray]:
    """``[B, N]`` payloads -> the zigzagged byte and the context of every
    position, both ``[B, N]``."""
    b, total = payload.shape
    zs, ctxs, pos = [], [], 0
    for h, w, group in pieces:
        plane = payload[:, pos : pos + h * w].reshape(b, h, w).astype(np.int64)
        pos += h * w
        if group == 0:
            pred = np.empty_like(plane)
            pred[:, :, 1:] = plane[:, :, :-1]
            pred[:, 1:, 0] = plane[:, :-1, 0]
            pred[:, 0, 0] = 128
            plane = (plane - pred) & 255
        z = _zigzag(plane)
        act = np.zeros_like(z)
        act[:, :, 1:] += z[:, :, :-1]
        act[:, 1:, :] += z[:, :-1, :]
        ctx = group * BUCKETS + np.searchsorted(THRESHOLDS, act, side="right")
        zs.append(z.reshape(b, -1))
        ctxs.append(ctx.reshape(b, -1))
    if pos != total:
        raise ValueError("the piece table does not cover the payload")
    return np.concatenate(zs, 1), np.concatenate(ctxs, 1)


class _Coder:
    """The range coder's state for ``b`` streams in lockstep, in uint32
    arrays; constants are arrays too, as NumPy takes those fastest."""

    def __init__(self, b: int):
        self.low = np.zeros(b, np.uint32)
        self.rng = np.full(b, 0xFFFFFFFF, np.uint32)
        self.spare = np.empty(b, np.uint32)
        self.t = np.empty(b, np.uint32)
        self.bound = np.empty(b, np.uint32)
        self.settled = np.empty(b, bool)
        self.small = np.empty(b, bool)
        self.ship = np.empty(b, bool)
        self.cut = np.empty(b, bool)
        self.shift = np.empty(b, np.uint32)
        self.c12 = np.full(b, PROB_BITS, np.uint32)
        self.c24 = np.full(b, 24, np.uint32)
        self.c8 = np.full(b, 8, np.uint32)
        self.top = np.full(b, TOP, np.uint32)
        self.bot = np.full(b, BOT, np.uint32)
        self.mask16 = np.full(b, BOT - 1, np.uint32)

    def renorm(self, shipped) -> None:
        """Ship bytes while any stream must; ``shipped(top_bytes, mask,
        shift)`` takes the top byte of ``low`` of the streams that ship one
        (``mask``; ``shift`` 8 there, else 0)."""
        low, t, settled, small, ship = self.low, self.t, self.settled, self.small, self.ship
        while True:
            rng = self.rng
            np.add(low, rng, out=t)
            np.bitwise_xor(t, low, out=t)
            np.less(t, self.top, out=settled)
            np.less(rng, self.bot, out=small)
            np.logical_or(settled, small, out=ship)
            if not np.count_nonzero(ship):
                return
            np.greater(small, settled, out=self.cut)
            if np.count_nonzero(self.cut):
                np.negative(low, out=t)
                np.bitwise_and(t, self.mask16, out=t)
                np.copyto(rng, t, where=self.cut)
            np.right_shift(low, self.c24, out=t)
            np.multiply(ship, self.c8, out=self.shift)
            shipped(t, ship, self.shift)
            np.left_shift(low, self.shift, out=low)
            np.left_shift(rng, self.shift, out=rng)

    def narrow(self, p, ones_mask, zeros) -> None:
        """Narrow each stream's interval for a decision of probability
        ``p`` (of a 0): ``ones_mask`` all ones where it came out 1,
        ``zeros`` True where it came out 0."""
        bound, t = self.bound, self.t
        np.right_shift(self.rng, self.c12, out=bound)
        np.multiply(bound, p, out=bound)
        np.bitwise_and(bound, ones_mask, out=t)
        np.add(self.low, t, out=self.low)
        np.subtract(self.rng, bound, out=self.spare)
        np.copyto(self.spare, bound, where=zeros)
        self.rng, self.spare = self.spare, self.rng


def encode(payloads: np.ndarray, pieces, shift: int) -> List[bytes]:
    """uint8 ``[B, N]`` subband payloads of one piece table -> one codec-4
    stream each."""
    payloads = np.ascontiguousarray(payloads, np.uint8)
    b, total = payloads.shape
    z, ctx = _symbols(payloads, pieces)
    probs = np.full(b * CONTEXTS * 256, ONE // 2, np.uint32)
    nxt = _next_prob(shift)
    base = (np.arange(b, dtype=np.int64) * CONTEXTS)[None, :]
    k = np.arange(8, dtype=np.int64)[None, :, None]
    margin = 32 * BLOCK  # at most 3 bytes a decision ship, 24 a symbol
    cap = max(total + total // 2, margin) + margin
    out = np.zeros(b * cap, np.uint8)
    rows = np.arange(b, dtype=np.int64) * cap
    pos = np.zeros(b, np.int64)
    where = np.empty(b, np.int64)
    coder = _Coder(b)

    def shipped(top, mask, _shift):
        np.add(rows, pos, out=where)
        out[where] = top  # a stream that ships nothing is overwritten later
        np.add(pos, mask, out=pos, casting="unsafe")

    for lo in range(0, total, BLOCK):
        zb = z[:, lo : lo + BLOCK].T.astype(np.int64)[:, None, :]  # [S, 1, B]
        # Decision k of a symbol: node (1 << k) | z >> (8 - k), bit z >> (7 - k) & 1.
        nodes = (1 << k) | (zb >> (8 - k))  # [S, 8, B]
        bits = (zb >> (7 - k)) & 1
        cells = ((base + ctx[:, lo : lo + BLOCK].T) * 256)[:, None, :] + nodes
        offsets = bits << PROB_BITS
        ones = (bits * 0xFFFFFFFF).astype(np.uint32)
        zeros = bits == 0
        for s in range(cells.shape[0]):
            # The tree's nodes on a symbol's path differ, so its eight
            # probabilities are read, and moved, together.
            cell = cells[s]
            p = probs[cell]
            probs[cell] = nxt[offsets[s] + p]
            o, zr = ones[s], zeros[s]
            for j in range(8):
                coder.narrow(p[j], o[j], zr[j])
                coder.renorm(shipped)
        if pos.max() > cap - margin:
            grown = np.zeros(b * 2 * cap, np.uint8)
            grown.reshape(b, 2 * cap)[:, :cap] = out.reshape(b, cap)
            out, cap = grown, 2 * cap
            rows[:] = np.arange(b, dtype=np.int64) * cap
    low = coder.low.astype(np.int64)
    flush = np.stack([(low >> (24 - 8 * i)) & 255 for i in range(4)], 1).astype(np.uint8)
    out = out.reshape(b, cap)
    return [out[i, : pos[i]].tobytes() + flush[i].tobytes() for i in range(b)]


def decode(streams: Sequence[bytes], pieces, shift: int) -> np.ndarray:
    """Codec-4 streams of one piece table -> uint8 ``[B, N]`` payloads.
    A stream read past its end reads zeros, as the format's decoder does."""
    b = len(streams)
    total = sum(h * w for h, w, _ in pieces)
    cap = max(len(s) for s in streams) + 8
    data = np.zeros((b, cap), np.uint32)
    for i, s in enumerate(streams):
        data[i, : len(s)] = np.frombuffer(s, np.uint8)
    flat = data.reshape(-1)
    rows = np.arange(b, dtype=np.int64) * cap
    last = rows + cap - 1  # a zero past every stream's end
    probs = np.full(b * CONTEXTS * 256, ONE // 2, np.uint32)
    nxt = _next_prob(shift)
    coder = _Coder(b)
    code = np.zeros(b, np.uint32)
    for i in range(4):
        code = (code << np.uint32(8)) | data[:, i]
    pos = np.full(b, 4, np.int64)
    where = np.empty(b, np.int64)
    byte = np.empty(b, np.uint32)
    gap = np.empty(b, np.uint32)
    one = np.empty(b, bool)
    zero = np.empty(b, bool)
    ones_mask = np.empty(b, np.uint32)
    all_ones = np.full(b, 0xFFFFFFFF, np.uint32)
    node = np.empty(b, np.int64)
    ix = np.empty(b, np.int64)
    off = np.empty(b, np.int64)
    cell = np.empty(b, np.int64)
    base = np.arange(b, dtype=np.int64) * CONTEXTS * 256

    def shipped(_top, mask, by):
        np.add(rows, pos, out=where)
        np.minimum(where, last, out=where)
        np.take(flat, where, out=byte)
        np.multiply(byte, mask, out=byte, casting="unsafe")
        np.left_shift(code, by, out=code)
        np.bitwise_or(code, byte, out=code)
        np.add(pos, mask, out=pos, casting="unsafe")

    out = np.empty((b, total), np.uint8)
    start = 0
    for h, w, group in pieces:
        plane = out[:, start : start + h * w].reshape(b, h, w)
        start += h * w
        up = np.zeros((b, w), np.int64)
        for y in range(h):
            left = np.zeros(b, np.int64)
            for x in range(w):
                act = np.searchsorted(THRESHOLDS, left + up[:, x], side="right")
                np.add(base, (group * BUCKETS + act) * 256, out=cell)
                node.fill(1)
                for _ in range(8):
                    np.add(cell, node, out=ix)
                    p = probs[ix]
                    bound = coder.bound
                    np.right_shift(coder.rng, coder.c12, out=bound)
                    np.multiply(bound, p, out=bound)
                    np.subtract(code, coder.low, out=gap)
                    np.greater_equal(gap, bound, out=one)
                    np.logical_not(one, out=zero)
                    np.multiply(one, all_ones, out=ones_mask)
                    np.bitwise_and(bound, ones_mask, out=coder.t)
                    np.add(coder.low, coder.t, out=coder.low)
                    np.subtract(coder.rng, bound, out=coder.spare)
                    np.copyto(coder.spare, bound, where=zero)
                    coder.rng, coder.spare = coder.spare, coder.rng
                    np.left_shift(one, PROB_BITS, out=off, casting="unsafe")
                    np.add(off, p, out=off)
                    probs[ix] = nxt[off]
                    np.left_shift(node, 1, out=node)
                    np.add(node, one, out=node, casting="unsafe")
                    coder.renorm(shipped)
                z = node & 255
                v = _unzigzag(z)
                if group == 0:
                    if x:
                        pred = plane[:, y, x - 1].astype(np.int64)
                    elif y:
                        pred = plane[:, y - 1, 0].astype(np.int64)
                    else:
                        pred = np.full(b, 128, np.int64)
                    v = (pred + v) & 255
                plane[:, y, x] = v
                up[:, x] = z
                left = z
    return out
