"""The scene cell's stand-in for a disk: a process of its own that reads
the command's output FIFO, one writer after another, into a SHA-256, a
byte count and the host time of each read.

It runs apart from the process under test, so that reading and hashing
some 100 MB a scene never waits for, or holds, that process's GIL, and
it widens the pipe, so that the command's writes, a block of about 200
KB each followed by a flush, go on without waiting for a reader as they
would into a file.  Outputs kept whole stay here: only the blocks that
the check samples cross back, since some 100 MB through a socket a few
hundred KB at a time takes seconds on a virtual machine.  This module
imports the standard library and, to cut sampled blocks out of a kept
output, the reference's container parser.

Protocol on ``conn``: ``(index, keep)`` opens the FIFO for the next
writer and answers ``(index, digest, marks)`` at its end of file, where
``marks`` are ``(perf_counter, bytes so far)``; with ``keep`` the output
is also kept whole.  ``("sample", samples)`` answers ``{index: blocks}``
for the kept outputs in the order of their indices, ``blocks`` those of
the output's ``.thgit`` at the indices of the next list in ``samples``
(or the parser's error, as a string), and forgets every kept output;
``None`` ends the process.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import time

__all__ = ["PIPE_BYTES", "READ_BYTES", "widen", "serve"]

PIPE_BYTES = (4 << 20, 1 << 20)  # the pipe sizes tried, largest first
READ_BYTES = 1 << 20
F_SETPIPE_SZ = getattr(fcntl, "F_SETPIPE_SZ", 1031)


def widen(fd: int) -> int:
    """Set the pipe's size to the largest of ``PIPE_BYTES`` the system
    allows; returns the size set, or 0 where it allows none."""
    for size in PIPE_BYTES:
        try:
            return fcntl.fcntl(fd, F_SETPIPE_SZ, size)
        except OSError:
            continue
    return 0


def _read(fifo: str, keep: bool):
    fd = os.open(fifo, os.O_RDONLY)
    try:
        widen(fd)
        h, n, marks = hashlib.sha256(), 0, []
        data = bytearray() if keep else None
        while True:
            chunk = os.read(fd, READ_BYTES)
            if not chunk:
                break
            h.update(chunk)
            n += len(chunk)
            marks.append((time.perf_counter(), n))
            if data is not None:
                data += chunk
    finally:
        os.close(fd)
    return h.hexdigest(), marks, (bytes(data) if data is not None else None)


def _blocks(data: bytes, picks):
    from .reference import formats

    try:
        blocks = formats.parse_thgit(data)[3]
        return [blocks[i] for i in picks]
    except Exception as e:  # a malformed output: the check reads the error
        return repr(e)


def serve(fifo: str, conn) -> None:
    kept = {}
    while True:
        job = conn.recv()
        if job is None:
            return
        if job[0] == "sample":
            conn.send({index: _blocks(kept[index], picks)
                       for index, picks in zip(sorted(kept), job[1])})
            kept = {}
            continue
        index, keep = job
        digest, marks, data = _read(fifo, keep)
        if data is not None:
            kept[index] = data
        conn.send((index, digest, marks))
