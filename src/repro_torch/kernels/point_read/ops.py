"""Dispatch for the fused per-level point read (kernel 3).

:class:`LevelLayout` is one level's run layout — run offsets, Bloom
parameters, fence keys, the flat Bloom words, and the search's key sample
— kept on the host for the plain version and, for the kernel, as one small
int64 table on the device (built once per layout, not re-traced per layout
as the Pallas kernel is).  :func:`point_read_level` launches the CUDA kernel
(``csrc/point_read.cu``) for CUDA tensors and runs the plain version
(``ref.point_read_level_ref``) for CPU tensors.  Both return per-key
counters; the caller sums them.

The sample (:func:`sample_runs`): each run of at least
:data:`SAMPLE_MIN_RUN` entries keeps every :data:`SAMPLE_STRIDE`-th key
(level 1: an eighth of its keys, 1 MB for each 8 MB of keys), every
:data:`SAMPLE_FANOUT`-th of those (level 2), and so on, up to the first
level that fits the run's share of :data:`TOP_CAP` entries (32 KB, the
kernel's shared memory): the run's ``top``, bisected in shared memory.
The levels below it are the run's ``sample``, read in the L2 as an
implicit search tree whose node is 4 adjacent entries of a level (32
bytes, one sector of the L2), each level padded to whole nodes with the
largest int64, which no key is below.  A run of fewer entries takes at
most 12 halvings, in the L2, and keeps the plain search.  A run's levels
are built once, as its chain (:func:`run_sample`), which the level store
keeps beside the run's Bloom words; :func:`pack_samples` lays a level's
chains out.  ``ref.point_read_sampled_ref`` runs the kernel's algorithm
on the CPU for the tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import _build
from .._build import I32, I64, P
from ...utils.u64 import as_i64, mod_magic
from .ref import level_sizes, point_read_level_ref

_LAUNCH_ARGS = (P, I64, P, P, P, I32, P, P, P, I32, I32, P, P, P, P, P, P)

#: level 1 keeps every SAMPLE_STRIDE-th key of a run (the kernel's
#: ``kStride``), each later level every SAMPLE_FANOUT-th entry of the one
#: below (``kFanout``)
SAMPLE_STRIDE, SAMPLE_FANOUT = 8, 4
#: runs of fewer entries keep the plain search and have no sample
SAMPLE_MIN_RUN = 4096
#: top entries of a level, at most (the kernel's ``kTopCap``)
TOP_CAP = 4096
#: the largest k the kernel holds in registers (its ``KMAX`` templates:
#: 4, 8, 16, 32).  Monkey's allocation at 10 bits an entry gives level 1
#: ``round(ln 2 * (10 + ln T (L - T / (T - 1)) / ln(2)^2))``: 23 at T = 2
#: with 18 levels, 9 for the 10 M-entry tree's nominal tuning (T = 40)
KMAX_BOUND = 32
_PAD = (1 << 63) - 1


_PADS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _pad(like: torch.Tensor, fanout: int) -> torch.Tensor:
    """``fanout`` copies of the largest int64 on ``like``'s device, made
    once a device: a level's padding is a view of it, not a fill."""
    key = (like.device, fanout)
    if key not in _PADS:
        _PADS[key] = like.new_full((fanout,), _PAD)
    return _PADS[key]


def run_sample(run: torch.Tensor, stride: int = SAMPLE_STRIDE,
               fanout: int = SAMPLE_FANOUT,
               top_cap: int = TOP_CAP) -> torch.Tensor:
    """One run's sample chain: levels 1..g of ``level_sizes`` (level l
    every ``stride * fanout**(l-1)``-th key of ``run``), each padded to
    its size with the largest int64, back to back, where level g is the
    first of at most ``top_cap`` entries (the most a top can hold).  One
    concatenation of strided views of the run, on its device.
    :func:`pack_samples` cuts it into a level's layout without reading
    the run again."""
    if stride < 2 or fanout < 2 or top_cap < 1:
        raise ValueError("run_sample: stride and fanout >= 2, top_cap >= 1")
    pad = _pad(run, fanout)
    parts, every = [], stride
    for size in level_sizes(run.shape[0], stride, fanout):
        level = run[::every]
        parts += [level, pad[:size - level.shape[0]]]
        if level.shape[0] <= top_cap:
            break
        every *= fanout
    return torch.cat(parts)


def pack_samples(chains: Sequence[Optional[torch.Tensor]],
                 lens: Sequence[int], like: torch.Tensor,
                 stride: int = SAMPLE_STRIDE, fanout: int = SAMPLE_FANOUT,
                 top_cap: int = TOP_CAP) -> Dict:
    """The search's key sample of a level from its runs' chains
    (:func:`run_sample` at this ``top_cap``; ``None`` for a run without a
    sample) and lengths ``lens``.  Run r's top level f is the first of at
    most its share of ``top_cap`` entries (the cap over the runs with a
    chain); its levels 1..f-1, each padded to a multiple of ``fanout``
    (``level_sizes``), lie back to back in ``sample`` (run r's from
    ``sample_off[r]``); level f, unpadded, in ``top`` (at
    ``top_off[r]:top_off[r+1]``); ``top_level[r]`` = f, 0 for a run
    without a chain.  Levels past a chain's last (a run that shares its
    level's cap) are strided views of that last level.  A level of one
    chain takes views of it; otherwise new tensors on ``like``'s
    device."""
    share = max(1, top_cap // max(1, sum(c is not None for c in chains)))
    samples, tops, top_level = [], [], []
    sample_off, top_off = [0], [0]
    for chain, n in zip(chains, lens):
        at, f, m = 0, 0, 0
        if chain is not None:
            sizes = level_sizes(n, stride, fanout)
            reals = [-(-n // stride)]
            while len(reals) < len(sizes):
                reals.append(-(-reals[-1] // fanout))
            f = next(i for i, r in enumerate(reals, 1) if r <= share)
            m = reals[f - 1]
            at = sum(sizes[:f - 1])
            g, held = 0, 0                  # the chain's levels, entries
            while held < chain.shape[0]:
                held += sizes[g]
                g += 1
            if f <= g:
                samples.append(chain[:at])
                tops.append(chain[at:at + m])
            else:
                last = chain[held - sizes[g - 1]:][:reals[g - 1]]
                pad = _pad(like, fanout)
                samples.append(chain)
                for lvl in range(g + 1, f):
                    level = last[::fanout ** (lvl - g)]
                    samples += [level, pad[:sizes[lvl - 1] - level.shape[0]]]
                tops.append(last[::fanout ** (f - g)])
        sample_off.append(sample_off[-1] + at)
        top_off.append(top_off[-1] + m)
        top_level.append(f)

    def flat(parts):
        parts = [t for t in parts if t.shape[0]]
        if len(parts) == 1 and parts[0].is_contiguous():
            return parts[0]
        return torch.cat(parts) if parts else like.new_zeros(0)

    return {"sample": flat(samples), "sample_off": sample_off,
            "top": flat(tops), "top_off": top_off, "top_level": top_level,
            "stride": stride, "fanout": fanout}


def sample_runs(keys: torch.Tensor, starts: Sequence[int],
                stride: int = SAMPLE_STRIDE, fanout: int = SAMPLE_FANOUT,
                min_run: int = SAMPLE_MIN_RUN, top_cap: int = TOP_CAP
                ) -> Dict:
    """The search's key sample of the level whose runs lie at ``starts`` in
    ``keys``, from scratch: :func:`run_sample` of each run of at least
    ``min_run`` entries (a shorter run has none), laid out by
    :func:`pack_samples`."""
    if stride < 2 or fanout < 2 or min_run < 1 or top_cap < 1:
        raise ValueError("sample_runs: stride and fanout >= 2, min_run and "
                         "top_cap >= 1")
    lens = [starts[r + 1] - starts[r] for r in range(len(starts) - 1)]
    chains = [run_sample(keys[starts[r]:starts[r + 1]], stride, fanout,
                         top_cap) if n >= min_run else None
              for r, n in enumerate(lens)]
    return pack_samples(chains, lens, keys, stride, fanout, top_cap)


@dataclasses.dataclass
class LevelLayout:
    """Run layout of one level (R runs, newest first).

    ``starts``/``word_off``/``sample_off``/``top_off`` have R+1 entries;
    the others R.  Fence keys are in the ordered int64 form of the arenas.
    ``words`` is every run's Bloom words back to back (int64 bit patterns),
    run r's at ``words[word_off[r]:word_off[r+1]]`` — flat, not padded to
    the widest run, so a tiered level pays no padding.  ``sample``, ``top``
    and the rows after them are :func:`sample_runs`'s."""

    starts: List[int]
    n_bits: List[int]
    ks: List[int]
    fence_lo: List[int]
    fence_hi: List[int]
    word_off: List[int]
    words: torch.Tensor
    sample: torch.Tensor
    sample_off: List[int]
    top: torch.Tensor
    top_off: List[int]
    top_level: List[int]
    stride: int = SAMPLE_STRIDE
    fanout: int = SAMPLE_FANOUT
    _table: Optional[torch.Tensor] = None

    @property
    def num_runs(self) -> int:
        return len(self.starts) - 1

    @property
    def magic(self) -> List[int]:
        """Each run's reciprocal of ``n_bits`` for the exact modulo
        (``utils/u64.mod_magic``), as int64."""
        return [as_i64(mod_magic(n)) for n in self.n_bits]

    def table(self) -> torch.Tensor:
        """The (10, R+1) int64 layout table on the words' device, in the
        kernel's row order."""
        if self._table is None:
            pad = [0]
            rows = [self.starts, self.n_bits + pad, self.ks + pad,
                    self.fence_lo + pad, self.fence_hi + pad, self.word_off,
                    self.magic + pad, self.sample_off, self.top_off,
                    self.top_level + pad]
            self._table = torch.tensor(rows, dtype=torch.int64).to(
                self.words.device)
        return self._table


def launch_args(q: torch.Tensor, arena_keys: torch.Tensor,
                arena_vals: torch.Tensor, layout: LevelLayout,
                outs: Sequence[torch.Tensor]) -> Tuple:
    """The C entry's arguments, the stream excepted, for contiguous CUDA
    tensors and the outputs ``outs`` (hit, enc, probes, reads, fps)."""
    if layout.sample.data_ptr() % 16:
        raise ValueError("point_read: the sample must be 16-byte aligned")
    if (layout.stride, layout.fanout) != (SAMPLE_STRIDE, SAMPLE_FANOUT):
        raise ValueError(f"point_read: the kernel takes a sample of every "
                         f"{SAMPLE_STRIDE}th key and levels of every "
                         f"{SAMPLE_FANOUT}th entry, not ({layout.stride}, "
                         f"{layout.fanout})")
    top_total = layout.top_off[-1]
    if top_total > TOP_CAP:
        raise ValueError(f"point_read: {top_total} top entries > {TOP_CAP}")
    if q.shape[0] >= 2 ** 31 or any(
            e - s >= 2 ** 31 for s, e in zip(layout.starts, layout.starts[1:])):
        raise ValueError("point_read: the kernel takes batches and runs of "
                         "fewer than 2^31 entries")
    kmax = max(layout.ks, default=0)
    if kmax > KMAX_BOUND:
        raise ValueError(f"point_read: a run's Bloom filter takes {kmax} "
                         f"hashes; the kernel holds at most {KMAX_BOUND}")
    return (q.data_ptr(), q.shape[0], arena_keys.data_ptr(),
            arena_vals.data_ptr(), layout.table().data_ptr(),
            layout.num_runs, layout.words.data_ptr(),
            layout.sample.data_ptr(), layout.top.data_ptr(), top_total, kmax,
            *(t.data_ptr() for t in outs))


def point_read_level(q: torch.Tensor, arena_keys: torch.Tensor,
                     arena_vals: torch.Tensor, layout: LevelLayout
                     ) -> Tuple[torch.Tensor, ...]:
    """(hit bool, enc, probes, reads, fps), each (B,), for ordered int64
    query keys ``q`` against one level's arenas."""
    ts = (q, arena_keys, arena_vals, layout.words, layout.sample, layout.top)
    if any(t.dtype != torch.int64 or t.dim() != 1 for t in ts):
        raise TypeError("point_read takes 1-D int64 keys, arenas, words and "
                        "samples")
    dev = q.device
    if any(t.device != dev for t in ts):
        raise ValueError("point_read: tensors on different devices")
    if dev.type == "cpu":
        return point_read_level_ref(
            q, arena_keys, arena_vals, layout.starts, layout.n_bits,
            layout.ks, layout.fence_lo, layout.fence_hi, layout.words,
            layout.word_off)
    if dev.type != "cuda":
        raise ValueError(f"point_read: no kernel for device {dev}")
    if arena_keys.shape[0] != layout.starts[-1]:
        raise ValueError("point_read: arena length does not match layout")
    q, arena_keys, arena_vals = (t.contiguous() for t in
                                 (q, arena_keys, arena_vals))
    B = q.shape[0]
    hit = torch.empty(B, dtype=torch.bool, device=dev)
    enc = torch.empty(B, dtype=torch.int64, device=dev)
    probes = torch.empty_like(enc)
    reads = torch.empty_like(enc)
    fps = torch.empty_like(enc)
    outs = (hit, enc, probes, reads, fps)
    if B == 0:
        return outs
    args = launch_args(q, arena_keys, arena_vals, layout, outs)
    fn = _build.kernel_fn("point_read", "point_read_launch", _LAUNCH_ARGS)
    _build.launch("point_read", fn, *args, device=dev)
    return outs
