"""Every kernel launch of the port goes to the device that holds its
tensors (``repro_torch.kernels._build.launch``), checked on the CPU.

``launch`` makes the tensors' device the current one, takes PyTorch's
current stream on it, calls the C entry with that stream last, and only
then checks and counts the launch.  Here ``torch.cuda.device``,
``torch.cuda.current_stream`` and the C entry are recorders (no card is
needed), and each ``kernels/*/ops.py`` is parsed to show that it launches
only through ``launch``.  The card test that the output lies on the
device the launch was guarded to is in ``tests/test_torch_cuda.py``.
"""

import ast
import contextlib
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build

KERNELS_DIR = Path(_build.__file__).resolve().parent
OPS = sorted(KERNELS_DIR.glob("*/ops.py"))


@pytest.fixture
def calls(monkeypatch):
    """Record, in order, entering and leaving the device guard, taking the
    stream and calling the entry; restore the launch counts afterwards."""
    log = []

    @contextlib.contextmanager
    def device(dev):
        log.append(("enter", dev))
        try:
            yield
        finally:
            log.append(("exit", dev))

    class Stream:
        def __init__(self, dev):
            log.append(("stream", dev))
            self.cuda_stream = 0xC0FFEE

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    saved = dict(_build.LAUNCHES)
    yield log
    _build.LAUNCHES.clear()
    _build.LAUNCHES.update(saved)


def _entry(log, rc=0):
    def fn(*args):
        log.append(("entry", args, _build.LAUNCHES["merge"]))
        return rc
    return fn


@pytest.mark.parametrize("dev", [torch.device("cuda", 1), "cuda:0", 3])
def test_launch_enters_the_device_before_the_entry_and_counts_after(calls,
                                                                    dev):
    before = _build.LAUNCHES["merge"]
    _build.launch("merge", _entry(calls), 11, 22, device=dev)
    assert calls == [("enter", dev), ("stream", dev),
                     ("entry", (11, 22, 0xC0FFEE), before), ("exit", dev)]
    assert _build.LAUNCHES["merge"] == before + 1


def test_launch_counts_the_kernel_variant(calls):
    counts = dict(_build.LAUNCHES)
    _build.launch("flash_attention", _entry(calls), device="cuda:0",
                  variant="bf16_tc")
    changed = {k for k in counts if _build.LAUNCHES[k] != counts[k]}
    assert changed == {"flash_attention", "flash_attention:bf16_tc"}
    _build.launch("flash_attention", _entry(calls), device="cuda:0",
                  variant="f32_cuda_core")
    assert _build.LAUNCHES["flash_attention"] == counts["flash_attention"] + 2
    assert _build.LAUNCHES["flash_attention:f32_cuda_core"] \
        == counts["flash_attention:f32_cuda_core"] + 1


def test_launch_raises_on_a_cuda_error_and_counts_nothing(calls,
                                                          monkeypatch):
    class Lib:
        @staticmethod
        def kernel_error_string(rc):
            return b"too many resources requested for launch"

    monkeypatch.setattr(_build, "_library", lambda name: Lib)
    counts = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="too many resources"):
        _build.launch("merge", _entry(calls, rc=701), device="cuda:1")
    assert calls[-1] == ("exit", "cuda:1")
    assert _build.LAUNCHES == counts


def test_launch_leaves_the_guard_when_the_entry_raises(calls):
    def fn(*args):
        raise ctypes_error

    ctypes_error = OSError("access violation")
    with pytest.raises(OSError):
        _build.launch("merge", fn, device="cuda:2")
    assert calls == [("enter", "cuda:2"), ("stream", "cuda:2"),
                     ("exit", "cuda:2")]


def test_the_recorders_do_not_outlive_the_fixture():
    assert torch.cuda.device.__module__.startswith("torch")
    assert torch.cuda.current_stream.__module__.startswith("torch")


def _calls_to(tree, owner, attr):
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute) and n.func.attr == attr
            and isinstance(n.func.value, ast.Name) and n.func.value.id == owner]


def test_every_wrapper_has_an_ops_file():
    assert {p.parent.name for p in OPS} == set(_build.KERNELS)


@pytest.mark.parametrize("path", OPS, ids=[p.parent.name for p in OPS])
def test_ops_launches_only_through_the_guard(path):
    """Each C entry that ``_build.kernel_fn`` returns is handed to
    ``_build.launch`` and called nowhere else; no wrapper takes a stream,
    checks or counts a launch itself."""
    tree = ast.parse(path.read_text(), filename=str(path))
    entries = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and _calls_to(node.value, "_build", "kernel_fn"):
            entries |= {t.id for t in node.targets}
    launches = _calls_to(tree, "_build", "launch")
    assert entries and launches, f"{path.parent.name} launches nothing"
    for call in launches:
        assert isinstance(call.args[1], ast.Name)
        assert call.args[1].id in entries
        assert any(kw.arg == "device" for kw in call.keywords)
    assert {c.args[1].id for c in launches} == entries
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            assert node.func.id not in entries, \
                f"{path.parent.name} calls its C entry {node.func.id} directly"
    for attr in ("check", "stream_of"):
        assert not _calls_to(tree, "_build", attr), \
            f"{path.parent.name} calls _build.{attr}"
    assert "current_stream" not in path.read_text()
