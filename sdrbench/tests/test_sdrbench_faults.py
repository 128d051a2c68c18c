"""A whole run on the CPU at a tiny size, the card's look skipped: sound,
it comes out correct; with the timed path broken underneath it comes out
not correct, once for each fault a one-card bank can have (a step that
returns its state unchanged; half of the channels left out; an answer
altered where it is produced).  The exchange between chips does not
exist on one card."""

import numpy as np
import pytest
import torch

from sdrbench import cells, generator, program
from sdrbench.run import run_cell
from sdrbench.tests import tiny

SEED = 2**31 + 1234


class Frozen(program.System):
    """Every block from the fresh state: the step's new state is dropped."""

    def call(self, x):
        out = super().call(x)
        self.reset()
        return out


class Half(program.System):
    """Every other channel's outputs left out (zero)."""

    def call(self, x):
        out = super().call(x)
        for k, v in out.items():
            if k.endswith((".pcm", ".bb_power")):
                v[::2] = 0
        return out


class Altered(program.System):
    """One instant of one block's PCM changed by 64 LSB on every
    channel."""

    n = 0

    def call(self, x):
        out = super().call(x)
        Altered.n += 1
        if Altered.n == 5:                  # block 2 (two warm-up calls)
            out["g0.pcm"][:, 100] += 64
        return out


def _run(cfg_name, traffic, workload, factory=None, seconds=2.0):
    Altered.n = 0
    res = run_cell(tiny.config(cfg_name), tiny.traffic(traffic),
                   cells.limits(workload), SEED, seconds, False,
                   torch.device("cpu"), system_factory=factory)
    return res


@pytest.mark.parametrize("cfg_name,traffic,workload", [
    ("fm_pl_4096_20ms", "sat", "fm4096-sat"),
    ("fm_pl_4096_20ms", "live", "fm4096-live"),
    ("mixed6144_20ms", "sat", "mixed6144-sat"),
])
def test_sound_run_is_correct(cfg_name, traffic, workload):
    res = _run(cfg_name, traffic, workload)
    assert res["attempted"] >= 2
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [Frozen, Half, Altered])
@pytest.mark.parametrize("cfg_name,traffic,workload", [
    ("fm_pl_4096_20ms", "sat", "fm4096-sat"),
    ("mixed6144_20ms", "sat", "mixed6144-sat"),
])
def test_broken_path_is_not_correct(fault, cfg_name, traffic, workload):
    res = _run(cfg_name, traffic, workload, fault)
    assert not res["correct"], res["checks"]


def test_compaction_fault_is_not_correct():
    class Dropped(program.System):
        """The compaction's first active channel reported as unused."""

        def call(self, x):
            out = super().call(x)
            idx = out["g0.idx"]
            idx[int(np.argmax(idx.cpu().numpy() >= 0))] = -1
            return out

    res = _run("fm_pl_4096_20ms", "live", "fm4096-live", Dropped, 4.0)
    assert not res["correct"], res["checks"]


def _usb_carrier(cfg_name, traffic):
    """The first USB carrier's channel and the USB group's index."""
    cfg, tr = tiny.config(cfg_name), tiny.traffic(traffic)
    groups = program.channel_freqs(cfg)
    g = next(i for i, (m, _) in enumerate(groups) if m == "USB")
    plan = generator.draw(groups, float(cfg["samprate"]), tr["signals"], SEED)
    return g, int(plan.channels(g)[0])


@pytest.mark.parametrize("fault", ["level", "shape"])
def test_one_hang_agc_carrier_at_fault_is_not_correct(fault):
    """One USB carrier of the mixed bank wrong in every block: its hang
    AGC settled 6 dB low (the PCM halved), or its PCM one sample late.
    At this size one carrier of four is a quarter of the carrier-blocks,
    so the gain's 95th percentile sees the level fault; on the card one
    of 32 is not, and only the shape's worst carrier sees one carrier."""
    g, ch = _usb_carrier("mixed6144_20ms", "sat")

    class OneCarrier(program.System):
        def call(self, x):
            out = super().call(x)
            pcm = out[f"g{g}.pcm"]
            if fault == "level":
                pcm[ch] = torch.div(pcm[ch], 2, rounding_mode="trunc")
            else:
                pcm[ch] = torch.roll(pcm[ch], 1, dims=-1)
            return out

    res = _run("mixed6144_20ms", "sat", "mixed6144-sat", OneCarrier)
    assert not res["correct"], res["checks"]
