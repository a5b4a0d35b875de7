"""The scene cell's drain: a process that reads the output FIFO, one
writer after another, into digests, byte marks and the outputs kept."""

import hashlib
import multiprocessing
import os

from hgibench import drain
from hgibench.reference import formats


def _write(path, data, step=70_000):
    with open(path, "wb") as f:
        for lo in range(0, len(data), step):
            f.write(data[lo : lo + step])
            f.flush()


def test_the_drain_reads_each_writer_and_returns_the_sampled_blocks(tmp_path):
    fifo = str(tmp_path / "out")
    os.mkfifo(fifo)
    spawn = multiprocessing.get_context("spawn")
    conn, child = spawn.Pipe()
    p = spawn.Process(target=drain.serve, args=(fifo, child), daemon=True)
    p.start()
    child.close()
    try:
        blocks = [os.urandom(1000 + 37 * i) for i in range(15)]
        thgit = formats.thgit_frame((300, 530), 128, blocks)[0]
        outputs = [thgit, b"", os.urandom(5_000_000), thgit]
        for index, data in enumerate(outputs):
            conn.send((index, index != 1))
            _write(fifo, data)
            got, digest, marks = conn.recv()
            assert got == index and digest == hashlib.sha256(data).hexdigest()
            assert [n for _, n in marks] == sorted({n for _, n in marks})
            assert (marks[-1][1] if marks else 0) == len(data)
            assert all(t0 <= t1 for (t0, _), (t1, _) in zip(marks, marks[1:]))
        conn.send(("sample", [[0, 14], [3], [2, 5]]))
        got = conn.recv()
        assert got[0] == [blocks[0], blocks[14]] and got[3] == [blocks[2], blocks[5]]
        assert isinstance(got[2], str) and "thgit" in got[2]  # not a .thgit: the parser's error
        conn.send(("sample", [[0]]))
        assert conn.recv() == {}  # a sample forgets what was kept
        conn.send(None)
        p.join(10)
        assert p.exitcode == 0
    finally:
        if p.is_alive():
            p.terminate()
            p.join(10)


def test_the_pipe_is_widened(tmp_path):
    r, w = os.pipe()
    try:
        size = drain.widen(w)
        assert size == 0 or size >= min(drain.PIPE_BYTES)
    finally:
        os.close(r)
        os.close(w)
