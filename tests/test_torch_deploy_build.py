"""``ops/cuda_build.py`` under threads, on the CPU (no nvcc here: the compile
step is replaced by a stand-in that writes the library slowly): eight
threads that reach ``build`` and ``load`` together compile each source
once, see no half-written library, and share one handle."""

import os
import sys
import threading
import time

import pytest

from change3d_tpu_torch.ops import cuda_build


class _FakeNvcc:
    """A finished-later process that writes ``out`` the way nvcc would."""

    def __init__(self, out, log):
        self.out, self.returncode = out, 0
        log.append(out)

    def communicate(self):
        time.sleep(0.05)  # long enough for every thread to arrive meanwhile
        self.out.write_bytes(b"\x7fELF stand-in")
        return "ptxas info: 40 registers", None


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    started = []
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "library_path", lambda name: tmp_path / f"{name}-0.so")
    monkeypatch.setattr(cuda_build, "_start_nvcc", lambda name, out: _FakeNvcc(out, started))
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    yield started
    sys.setswitchinterval(before)


def _together(fn, n=8):
    barrier, errors, results = threading.Barrier(n), [], [None] * n

    def run(i):
        barrier.wait()
        try:
            results[i] = fn()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not errors, errors
    return results


def test_build_from_eight_threads_compiles_once(fake_build, tmp_path):
    reports = _together(lambda: cuda_build.build(["fused_block"]))
    assert len(fake_build) == 1  # one compile; the other threads found the library
    assert sorted(reports, key=len) == [{}] * 7 + [{"fused_block": "ptxas info: 40 registers"}]
    assert (tmp_path / "fused_block-0.so").read_bytes() == b"\x7fELF stand-in"
    assert not list(tmp_path.glob("*.tmp"))
    # Already built: eight more threads compile nothing.
    assert _together(lambda: cuda_build.build(["fused_block"])) == [{}] * 8
    assert len(fake_build) == 1
    # The temporary name carries the process and the thread that built.
    _, pid, tid, tmp = fake_build[0].name.rsplit(".", 3)
    assert (pid, tmp) == (str(os.getpid()), "tmp") and int(tid) != threading.get_ident()


def test_load_from_eight_threads_shares_one_handle(fake_build, monkeypatch):
    opened = []

    class _Lib:
        def __init__(self, path):
            opened.append(path)

        def __getattr__(self, fn):
            f = type("F", (), {})()
            setattr(self, fn, f)
            return f

    monkeypatch.setattr(cuda_build.ctypes, "CDLL", _Lib)
    libs = _together(lambda: cuda_build.load("repros"))
    assert len(fake_build) == 1 and len(opened) == 1
    assert all(lib is libs[0] for lib in libs)
    f = libs[0].c3d_dot_1d
    assert f.restype == cuda_build.SIGNATURES["repros"]["c3d_dot_1d"][1]
    assert cuda_build.load("repros") is libs[0]
