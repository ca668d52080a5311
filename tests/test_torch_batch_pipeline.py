"""The recheck plane's batch loop (``parallel/pipeline.py::run_batches``),
on the CPU with fake loads, launches and drains.

The order of the calls and of the regions around them for a few batch
counts, the ``beside`` flag with a load held open, a failing load or
launch (it leaves the loop, nothing launches after it, and the loader
thread ends), and no batches at all.
"""

from __future__ import annotations

import contextlib
import threading

import pytest

from torrent_tpu_torch.parallel import pipeline

WAIT_S = 10.0  # every wait of a test is bounded


class Recorder:
    """Fake ``load`` / ``launch`` / ``drain`` that log, in order, what the
    calling thread does, with the regions it opens; each load marks its
    start and may be held until a launch releases it."""

    def __init__(self, n: int, held: bool = False):
        self.log: list = []
        self.started = [threading.Event() for _ in range(n)]
        self.release = [threading.Event() for _ in range(n)]
        self.held = held
        self.loader: list = []
        self.besides: list = []

    def region(self, name):
        @contextlib.contextmanager
        def cm():
            self.log.append(("open", name))
            yield
            self.log.append(("close", name))

        return cm()

    def load(self, i: int):
        self.loader.append(threading.current_thread())
        self.started[i].set()
        if self.held and i > 0:
            assert self.release[i].wait(WAIT_S)
        return f"loaded {i}"

    def launch(self, i: int, loaded, beside: bool):
        assert loaded == f"loaded {i}"
        if i + 1 < len(self.started):
            # batch i+1's load was submitted before this launch: it starts
            # while this thread waits here
            assert self.started[i + 1].wait(WAIT_S), f"load {i + 1} not submitted before launch {i}"
        self.log.append(("launch", i))
        self.besides.append(beside)
        if i + 1 < len(self.release):
            self.release[i + 1].set()
        return f"pending {i}"

    def drain(self, pending) -> None:
        self.log.append(("drain", int(pending.split()[1])))

    def run(self, monkeypatch, n: int) -> None:
        monkeypatch.setattr(pipeline, "maybe_profile_batch", self.region)
        monkeypatch.setattr(pipeline, "annotate", self.region)
        pipeline.run_batches(n, self.load, self.launch, self.drain, "verify.test.batch")

    def loader_ended(self) -> bool:
        for t in set(self.loader):
            t.join(WAIT_S)
        return bool(self.loader) and not any(t.is_alive() for t in self.loader)


def expected_log(n: int) -> list:
    """Each batch a region holding its wait for the load and its launch;
    batch i-1 drains after batch i launched, the last inside its own."""
    log = []
    for i in range(n):
        log += [("open", "verify.test.batch"), ("open", "verify.wait_load"), ("close", "verify.wait_load"), ("launch", i)]
        if i > 0:
            log.append(("drain", i - 1))
        if i == n - 1:
            log.append(("drain", i))
        log.append(("close", "verify.test.batch"))
    return log


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_call_order(monkeypatch, n):
    rec = Recorder(n)
    rec.run(monkeypatch, n)
    assert rec.log == expected_log(n)
    assert all(e.is_set() for e in rec.started)
    assert len(set(rec.loader)) == 1 and threading.current_thread() not in rec.loader
    assert rec.loader_ended()


@pytest.mark.parametrize("n", [2, 4])
def test_beside_while_the_next_load_runs(monkeypatch, n):
    """Each load after the first is held until the launch before it: every
    launch but the last has a load beside it; the last has none left."""
    rec = Recorder(n, held=True)
    rec.run(monkeypatch, n)
    assert rec.besides == [True] * (n - 1) + [False]
    assert rec.log == expected_log(n)


@pytest.mark.parametrize("bad", [0, 2])
def test_a_failing_load_leaves_the_loop(monkeypatch, bad):
    rec = Recorder(4)
    real = rec.load

    def load(i):
        if i == bad:
            rec.loader.append(threading.current_thread())
            rec.started[i].set()
            raise OSError(f"load {i}")
        return real(i)

    rec.load = load
    with pytest.raises(OSError, match=f"load {bad}"):
        rec.run(monkeypatch, 4)
    assert [i for kind, i in rec.log if kind == "launch"] == list(range(bad))
    assert rec.loader_ended()


@pytest.mark.parametrize("bad", [0, 1])
def test_a_failing_launch_leaves_the_loop(monkeypatch, bad):
    rec = Recorder(4)
    real = rec.launch

    def launch(i, loaded, beside):
        out = real(i, loaded, beside)
        if i == bad:
            raise RuntimeError(f"launch {i}")
        return out

    rec.launch = launch
    with pytest.raises(RuntimeError, match=f"launch {bad}"):
        rec.run(monkeypatch, 4)
    assert [i for kind, i in rec.log if kind == "launch"] == list(range(bad + 1))
    assert [i for kind, i in rec.log if kind == "drain"] == []  # batch i-1 drains after launch i returns
    # the load submitted before the failing launch was the last one
    assert [e.is_set() for e in rec.started] == [i <= bad + 1 for i in range(4)]
    assert rec.loader_ended()


def test_no_batches_make_no_call(monkeypatch):
    rec = Recorder(0)
    threads = threading.active_count()
    rec.run(monkeypatch, 0)
    assert rec.log == [] and rec.loader == []
    assert threading.active_count() == threads
