"""Which path an entry's upload takes (``models.bank._upload``,
``utils.graphs.StepGraphs.upload``) on the CPU.

A host block in page-locked memory, for a single-device wrapper that
captures on a card, is copied on a copy stream while the block before
runs; every other input keeps the synchronous copy: pageable numpy, a CPU
tensor, a tensor already on a device, ``capture=False`` and a CPU
device.  These cases hold that rule (nothing of them reaches the card),
that every entry counts its upload by path in ``trace.upload_inline``
and ``trace.upload_overlapped``, and that the synchronous path's results
are those of the copy it always made.  The overlapped path itself runs
on the card (``tests/test_torch_graphs_cuda.py``).
"""

import numpy as np
import pytest
import torch

from ka9q_sdr_tpu_torch.models import bank as TB
from ka9q_sdr_tpu_torch.utils import graphs, trace

FS, L, M = 192000.0, 3840, 4353


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    yield
    trace.reset()


def _block(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-900, 900, (L, 2), dtype=np.int16)


#: (StepGraphs arguments, input): each takes the synchronous path
INLINE = {
    "pageable numpy": (("cuda",), lambda: _block()),
    "cpu tensor": (("cuda",), lambda: torch.as_tensor(_block())),
    "device tensor": (("cuda",),
                      lambda: torch.empty((L, 2), dtype=torch.int16,
                                          device="meta")),
    "capture off": (("cuda", False), lambda: _block()),
    "cpu device": (("cpu",), lambda: _block()),
    "a list": (("cuda",), lambda: [[1, 2], [3, 4]]),
}


@pytest.mark.parametrize("name", sorted(INLINE))
def test_what_takes_the_synchronous_path(name):
    args, make = INLINE[name]
    g = graphs.StepGraphs(*args)
    assert g.upload(make(), torch.int16) is None
    assert g._copy is None and g._staging == {} and g._unread == {}


def test_upload_declines_another_dtype_or_layout():
    g = graphs.StepGraphs("cuda")
    x = _block()
    assert g.upload(x.astype(np.float32), torch.int16) is None
    assert g.upload(np.asfortranarray(x), None) is None
    assert g._staging == {}


@pytest.mark.parametrize("feed", ["numpy", "tensor"])
def test_inline_upload_is_the_synchronous_copy(feed):
    x = _block(3) if feed == "numpy" else torch.as_tensor(_block(3))
    got = TB._upload(x, torch.int16, torch.device("cpu"),
                     graphs.StepGraphs("cpu"))
    want = torch.as_tensor(x, dtype=torch.int16, device="cpu")
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert (trace.upload_inline, trace.upload_overlapped) == (1, 0)


def _channel_bank(capture=True):
    cfg = TB.make_bank_config(2, "FM", samprate=FS, L=L, M=M, enable_pl=True)
    return TB.ChannelBank(cfg, [-30e3, 40e3], device="cpu", capture=capture)


def _multi_bank(capture=True):
    return TB.MultiBank([("FM", [-30e3]), ("USB", [10e3, 30e3])],
                        samprate=FS, L=L, M=M, device="cpu", capture=capture)


#: (wrapper, call): every entry, each fed a host block (k of them a scan)
ENTRIES = {
    "bank.i16_pcm": (_channel_bank, lambda w, x: w.process_i16_pcm(x)),
    "bank.i16": (_channel_bank, lambda w, x: w.process_i16(x)),
    "bank.active": (_channel_bank, lambda w, x: w.process_active(x, 1)),
    "bank.packed": (_channel_bank,
                    lambda w, x: w.process(x.to(torch.float32)
                                           if torch.is_tensor(x)
                                           else x.astype(np.float32))),
    "bank.scan": (_channel_bank, lambda w, x: w.process_scan_i16(
        torch.stack([x, x]) if torch.is_tensor(x) else np.stack([x, x]))),
    "multi.i16_pcm": (_multi_bank, lambda w, x: w.process_i16_pcm(x)),
    "multi.i16": (_multi_bank, lambda w, x: w.process_i16(x)),
}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_entries_count_inline_uploads_and_keep_their_results(name):
    """Pageable numpy into one wrapper, CPU tensors into its
    ``capture=False`` twin: one inline upload a call, none overlapped,
    and the same outputs and state bit for bit."""
    make, call = ENTRIES[name]
    a, b = make(), make(capture=False)
    for i in range(3):
        x = _block(i)
        assert_bit_equal(call(a, x), call(b, torch.as_tensor(x)))
    assert_bit_equal(a.state if hasattr(a, "state") else a.states,
                 b.state if hasattr(b, "state") else b.states)
    assert (trace.upload_inline, trace.upload_overlapped) == (6, 0)


def _bits(t):
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_bit_equal(x, y):
    """Every tensor of two trees equal bit for bit (NaN PL readings too)."""
    lx, ly = graphs.tree_leaves(x), graphs.tree_leaves(y)
    assert len(lx) == len(ly)
    for p, q in zip(lx, ly):
        assert p.dtype == q.dtype and torch.equal(_bits(p), _bits(q))


def test_reset_clears_the_counts():
    trace.uploaded(True)
    trace.uploaded(False)
    trace.uploaded(False)
    assert (trace.upload_overlapped, trace.upload_inline) == (1, 2)
    trace.reset()
    assert (trace.upload_overlapped, trace.upload_inline) == (0, 0)
