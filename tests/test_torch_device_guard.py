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
import importlib
import re
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


_C_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')


@pytest.mark.parametrize("path", OPS, ids=[p.parent.name for p in OPS])
def test_entry_types_every_parameter_of_its_c_signature(path):
    """Each C entry's ``argtypes`` (the tuple handed to
    ``_build.kernel_fn``) has one type per parameter of the entry in
    ``csrc/*.cu``, the stream's a pointer: an argument past the types
    would go through as a C ``int``, and a stream so passed is garbage in
    its upper half."""
    entries = {m.group(1): [a for a in m.group(2).split(",") if a.strip()]
               for cu in _build.CSRC_DIR.glob("*.cu")
               for m in _C_ENTRY.finditer(cu.read_text())}
    src = path.read_text()
    module = importlib.import_module(
        f"repro_torch.kernels.{path.parent.name}.ops")
    launch_names = {n.value for n in ast.walk(ast.parse(src))
                    if isinstance(n, ast.Constant) and isinstance(n.value, str)
                    and n.value in entries}
    calls = _calls_to(ast.parse(src), "_build", "kernel_fn")
    assert calls
    for call in calls:
        argtypes = getattr(module, call.args[2].id)
        symbols = ([call.args[1].value]
                   if isinstance(call.args[1], ast.Constant) else launch_names)
        assert symbols
        for symbol in symbols:
            params = entries[symbol]
            assert len(argtypes) == len(params), symbol
            assert "cudaStream_t" in params[-1], symbol
            assert argtypes[-1] is _build.P, symbol


# ---------------------------------------------------------------------------
# the dynamic shared-memory attribute belongs to each device
# ---------------------------------------------------------------------------

CSRC = sorted(_build.CSRC_DIR.glob("*.cu"))
_SET_ATTR = "cudaFuncSetAttribute"


def _bodies_calling(src, name):
    """The body, braces included, of the function around each call of
    ``name`` in the C++ source ``src``: walking back from the call, the
    outermost enclosing ``{`` whose head ends with ``)`` (a function's
    parameter list; a namespace's head does not), matched forward."""
    bodies = []
    for m in re.finditer(r"\b" + name + r"\s*\(", src):
        depth, start = 0, None
        for j in range(m.start() - 1, -1, -1):
            if src[j] == "}":
                depth += 1
            elif src[j] == "{" and depth:
                depth -= 1
            elif src[j] == "{" and src[:j].rstrip().endswith(")"):
                start = j
        assert start is not None, f"no function around {name}"
        depth = 0
        for j in range(start, len(src)):
            depth += {"{": 1, "}": -1}.get(src[j], 0)
            if depth == 0:
                bodies.append(src[start:j + 1])
                break
    return bodies


def _process_wide_guards(body):
    """The names of ``static`` local variables in a function body that are
    not an array indexed by the device from ``cudaGetDevice``: a flag set
    once per process where the attribute is set once per device."""
    body = re.sub(r"//[^\n]*", "", body)
    names = re.findall(
        r"\bstatic\s+(?!constexpr\b|const\b|_assert\b|_cast\b)"
        r"[A-Za-z_][\w:<>]*\s+([A-Za-z_]\w*)\s*(\[[^\]]*\])?", body)
    dev = re.search(r"cudaGetDevice\s*\(\s*&\s*([A-Za-z_]\w*)\s*\)", body)
    bad = []
    for var, index in names:
        per_device = bool(index) and dev is not None and re.search(
            r"\b" + var + r"\s*\[\s*" + dev.group(1) + r"\s*\]", body)
        if not per_device:
            bad.append(var)
    return bad


_PROCESS_WIDE = """
template <int D> int launch(const Args& a, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, 1 << 16);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  return 0;
}
"""
_PER_DEVICE = """
template <int D> int launch(const Args& a, cudaStream_t stream) {
  static bool configured[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (!configured[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, 1 << 16);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  return 0;
}
"""
_EVERY_CALL = """
template <int D> int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = 1 << 16;
  static_assert(D > 0, "d");
  const cudaError_t err = cudaFuncSetAttribute(
      kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return (int)err;
}
"""


@pytest.mark.parametrize("src,bad", [(_PROCESS_WIDE, ["configured"]),
                                     (_PER_DEVICE, []), (_EVERY_CALL, [])],
                         ids=["process_wide", "per_device", "every_call"])
def test_the_static_guard_check_tells_the_cases_apart(src, bad):
    (body,) = _bodies_calling(src, _SET_ATTR)
    assert _process_wide_guards(body) == bad


@pytest.mark.parametrize("path", CSRC, ids=[p.stem for p in CSRC])
def test_shared_memory_attribute_is_set_per_device(path):
    """Every source that raises a kernel's dynamic shared-memory limit
    does so on every call, or behind a flag indexed by the current device:
    never behind a process-wide ``static`` flag, which would leave a
    second card's first launch refused for its shared memory."""
    src = path.read_text()
    for body in _bodies_calling(src, _SET_ATTR):
        assert not _process_wide_guards(body), \
            f"{path.name}: {_SET_ATTR} behind a process-wide static guard"
