"""The host-side plan and the walk of K6 (``csrc/pick2.cu``, the rank
pick) on the CPU, where the kernel cannot run: its plan's partition of
each site into a ragged head, 16-byte vectors of 4 items split over CTAs
and a ragged tail; the kernel's per-thread walk (vectors K6_THREADS apart,
the channel advanced without a division, codes outside [0, 256) read as
0, sets in chunks of at most K6_MAX_KC) mirrored in numpy and held
exactly against ``pick2_plain``; the set-major output
(each set's ranks contiguous); the raises where a 32-bit index would
overflow; the constants against the source; and, for every kernel, the
op that ``segment_cuda._launch`` records around its C call under
torch.profiler, inside the enclosing ``measure/<family>`` range."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from saguaro_tpu_torch.kernels import segment_cuda as sc

from .torch_data import PICK2_CASES, pick2_case, share_cpu_threads

share_cpu_threads()

SOURCE = (Path(sc.__file__).resolve().parents[1] / "csrc" / "pick2.cu").read_text()


def k6_walk(batch: int, n: int, n_ch: int, plan: sc.Pick2Plan):
    """The items K6 writes, as pick2.cu walks them: (site, flat item g of
    the (B * n * n_ch) stream, the channel the walk gives it), in order.
    A site's ragged head and tail go to threads 0-7 of its first CTA; CTA j
    takes the site's aligned vectors [j * vecs, (j + 1) * vecs), thread t
    the vectors t, t + T, ... of its range, with the channel of its first
    item advanced by 4 T mod n_ch a vector."""
    threads = sc.K6_THREADS
    items = n * n_ch
    dc = (4 * threads) % n_ch
    for b in range(batch):
        g_lo, g_hi = b * items, (b + 1) * items
        a_lo = min((g_lo + 3) & ~3, g_hi)
        a_hi = max(g_hi & ~3, a_lo)
        for t in range(8):
            g = g_lo + t if t < 4 else a_hi + t - 4
            if g < (a_lo if t < 4 else g_hi):
                yield b, g, (g - g_lo) % n_ch
        nv = (a_hi - a_lo) >> 2
        for cta in range(plan.ctas):
            u1 = min(nv, (cta + 1) * plan.vecs)
            for t in range(threads):
                u = cta * plan.vecs + t
                if u >= u1:
                    continue
                c = ((a_lo - g_lo) + 4 * u) % n_ch
                while u < u1:
                    cp = c
                    for p in range(4):
                        yield b, a_lo + 4 * u + p, cp
                        cp = 0 if cp + 1 == n_ch else cp + 1
                    c = c + dc - n_ch if c + dc >= n_ch else c + dc
                    u += threads


def k6_emulate(hi, lo, tables, plan):
    """K6's output (the (K, plane) buffer's (B, N, C, K) view) from its walk
    over numpy codes and tables: each chunk of at most K6_MAX_KC sets a
    launch, each item's table row (c << 16 | hi << 8 | lo) * K + k0 of its
    site, 0 where a code lies outside [0, 256)."""
    b, n, n_ch = hi.shape
    k_tab = tables.shape[4]
    buf, out = sc.pick2_out(b, n, n_ch, k_tab, "cpu")
    buf.fill_(float("nan"))  # every item must be written
    hf, lf = hi.reshape(-1), lo.reshape(-1)
    tf = tables.reshape(b, -1)
    dst = buf.numpy()
    walk = list(k6_walk(b, n, n_ch, plan))
    for k0 in range(0, k_tab, sc.K6_MAX_KC):
        for site, g, c in walk:
            h, l = int(hf[g]), int(lf[g])
            ok = 0 <= h < 256 and 0 <= l < 256
            row = ((c << 16) | ((h << 8) | l if ok else 0)) * k_tab + k0
            for k in range(min(sc.K6_MAX_KC, k_tab - k0)):
                dst[k0 + k, g] = tf[site, row + k] if ok else 0.0
    return out


# (batch, n, n_ch): B = 1, odd n, n * C not a multiple of 4 (the later
# sites start unaligned), several CTAs a site and a partial last one, sites
# of fewer than 4 items, and none
COVER = [(1, 4_097, 1), (1, 30_001, 3), (3, 10_001, 5), (2, 4_999, 2), (8, 1_001, 7),
         (3, 2_049, 8), (5, 3, 1), (2, 1, 3), (4, 0, 2)]


@pytest.mark.parametrize("batch,n,n_ch", COVER)
def test_k6_plan_covers_every_item_once(batch, n, n_ch):
    plan = sc.pick2_plan(batch, n, n_ch)
    n_vec = n * n_ch // 4
    assert plan.vecs == sc.K6_CTA_VECS and plan.ctas >= 1
    assert plan.ctas * plan.vecs >= n_vec and (plan.ctas - 1) * plan.vecs < max(n_vec, 1)
    walk = np.array(list(k6_walk(batch, n, n_ch, plan)), np.int64).reshape(-1, 3)
    assert np.array_equal(np.sort(walk[:, 1]), np.arange(batch * n * n_ch))
    site, g, c = walk.T
    assert np.array_equal(site, g // max(n * n_ch, 1))
    assert np.array_equal(c, (g - site * n * n_ch) % n_ch)  # the division-free channels


def test_k6_plan_at_the_main_path_shape():
    """Many short CTAs: two vectors a thread, 2,848 CTAs a site."""
    assert sc.pick2_plan(8, 1_166_400, 5) == sc.Pick2Plan(-(-1_458_000 // 512), 512)
    assert sc.K6_CTA_VECS == 2 * sc.K6_THREADS


# (batch, n, n_ch, k): every channel count and set count of the card
# tests, K > K6_MAX_KC (chunks), several CTAs a site, tiny and empty sites
EMULATE = [(1, 1_001, 1, 1), (3, 777, 2, 2), (1, 1_001, 3, 3), (3, 1_231, 5, 4), (1, 333, 8, 4),
           (2, 301, 3, 6), (3, 2, 1, 1), (2, 1, 3, 2), (2, 0, 2, 1), (2, 2_049, 8, 1)]


@pytest.mark.parametrize("batch,n,n_ch,k", EMULATE)
def test_k6_walk_matches_the_plain_form(batch, n, n_ch, k):
    rng = np.random.default_rng(batch * 100 + n_ch * 10 + k)
    hi = rng.integers(-3, 259, (batch, n, n_ch)).astype(np.int32)
    lo = rng.integers(-3, 259, (batch, n, n_ch)).astype(np.int32)
    hi[:, : n // 2, 0] = rng.integers(0, 3, (batch, n // 2))  # rows the main path reaches
    tables = rng.integers(0, 65536, (batch, n_ch, 256, 256, k)).astype(np.float32)
    args = tuple(torch.from_numpy(a) for a in (hi, lo, tables))
    got = k6_emulate(*args, sc.pick2_plan(batch, n, n_ch))
    want = sc.pick2_plain(*args)
    assert got.shape == want.shape == (batch, n, n_ch, k)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_ch,k", PICK2_CASES)
def test_pick2_plain_sets_are_contiguous(n_ch, k):
    """The plain form returns the kernel's set-major layout: each set's
    (B, N, C) ranks contiguous and 16-byte aligned, the values those of a
    direct gather."""
    hi, lo, tables = pick2_case(n_ch, k, seed=n_ch + 10 * k, n=301)
    got = sc.pick2_plain(*(torch.from_numpy(a) for a in (hi, lo, tables)))
    b, n = hi.shape[:2]
    assert got.shape == (b, n, n_ch, k)
    assert got.stride()[:3] == (n * n_ch, n_ch, 1)
    for kk in range(k):
        assert got[..., kk].is_contiguous() and got[..., kk].data_ptr() % 16 == 0
    ok = (hi >= 0) & (hi < 256) & (lo >= 0) & (lo < 256)
    site = np.arange(b)[:, None, None]
    chan = np.arange(n_ch)[None, None, :]
    want = tables[site, chan, np.where(ok, hi, 0), np.where(ok, lo, 0)]
    assert np.array_equal(got.numpy(), np.where(ok[..., None], want, 0.0))


def test_k6_wrapper_raises_where_an_index_overflows():
    """A site of n * C >= 2^31 items, or tables of C * 65536 * K >= 2^31
    floats a site, is refused before any launch (meta tensors: the shapes
    without the memory)."""
    before = dict(sc.LAUNCHES)
    with pytest.raises(ValueError, match="32 bits"):
        sc.pick2_plan(1, 2**30, 2)
    sc.pick2_plan(1, 2**31 - 1, 1)  # the largest site that fits

    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match="32 bits"):
        sc.seg_pick2(meta(1, 2**29, 4), meta(1, 2**29, 4), meta(1, 4, 256, 256, 1, dtype=torch.float32))
    with pytest.raises(ValueError, match="32 bits"):
        sc.seg_pick2(meta(1, 8, 8), meta(1, 8, 8), meta(1, 8, 256, 256, 4096, dtype=torch.float32))
    with pytest.raises(ValueError, match="do not match"):
        sc.seg_pick2(meta(1, 8, 2), meta(1, 8, 3), meta(1, 2, 256, 256, 1, dtype=torch.float32))
    assert sc.LAUNCHES == before


def test_k6_args_copy_unaligned_inputs():
    hi = torch.arange(13, dtype=torch.int32)[1:].view(1, 4, 3)
    lo = hi.clone()
    tables = torch.zeros((1, 3, 256, 256, 2))
    buf, _ = sc.pick2_out(1, 4, 3, 2, "cpu")
    plan = sc.pick2_plan(1, 4, 3)
    args, (hi_c, lo_c, tab_c) = sc.pick2_args(hi, lo, tables, buf, plan)
    assert hi.data_ptr() % 16 and hi_c.data_ptr() % 16 == 0 and torch.equal(hi_c, hi)
    assert lo_c is lo and tab_c is tables
    assert args[0] == hi_c.data_ptr() and args[4:] == (1, 4, 3, 2, 12, 1, sc.K6_CTA_VECS)


def test_k6_constants_match_the_source():
    for name in ("K6_THREADS", "K6_MAX_KC"):
        m = re.search(rf"#define {name} (\d+)", SOURCE)
        assert m and int(m.group(1)) == getattr(sc, name), name


def test_launch_records_an_op_inside_the_enclosing_range(monkeypatch):
    """Under torch.profiler each C call of ``_launch`` is an op of its own,
    ``sag/<kernel>``, a child of the ``measure/<family>`` range around it
    (the profiler links a kernel to such an op, not to a range), and is
    counted once. A stand-in library and stream take the card's place."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    calls = []

    class Lib:
        @staticmethod
        def sag_pick2(*args):
            calls.append(args)
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(sc, "_lib", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream)
    monkeypatch.setitem(sc.LAUNCHES, "seg_pick2", 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("measure/colocalization"):
            sc._launch("sag_pick2", "seg_pick2", torch.device("cpu"), 1, 2)
    assert calls == [(1, 2, 0)] and sc.LAUNCHES["seg_pick2"] == 1
    (op,) = [e for e in prof.events() if e.name == "sag/seg_pick2"]
    assert op.device_type == DeviceType.CPU and op.cpu_parent.name == "measure/colocalization"
