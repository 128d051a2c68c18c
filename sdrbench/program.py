"""The system under test, built from a configuration file: the port's
``ChannelBank`` or ``MultiBank`` on one card, or with the configuration's
``mesh`` > 1 on that many cards (``parallel.mesh``, as ``bankd --mesh``
builds it), and the entry a cell drives.  It calls only these public
entries of the program:

- ``models.bank.make_bank_config``, ``ChannelBank``, ``MultiBank``;
- ``parallel.mesh.make_channel_mesh`` and ``pad_channels`` (a mesh);
- ``ChannelBank.process_i16_pcm``, ``ChannelBank.process_active``,
  ``MultiBank.process_i16_pcm`` (the timed path), and the banks'
  ``state`` / ``states`` (read once before the first block and written
  back after the warm-up, so the window starts from a fresh bank);
- ``ops.ffill.forward_fill_multi`` and ``ops.agc.agc_block`` (the kernel
  metrics, outside the window).

``recorder.py`` and ``uploads.py`` read the program's tracer
(``utils.trace``) once a run has ended; no other module of the benchmark
imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

#: the diag leaves a block's egress carries: bankd's status leaves and
#: the ones the comparison reads
DIAG_KEYS = ("snr", "bb_power", "squelch_open", "plfreq", "pll_lock")


def channel_freqs(cfg: dict) -> list:
    """[(mode, [Hz, ...])]: every group's channels in order, spread over
    `span` of the band (the root bench.py's grid, bench.py:40-54 and
    144-157)."""
    fs = float(cfg["samprate"])
    total = sum(n for _, n in cfg["groups"])
    usable = cfg["span"] * fs
    grid = np.linspace(-usable / 2, usable / 2, total, endpoint=False)
    out, i = [], 0
    for mode, n in cfg["groups"]:
        out.append((mode, [float(f) for f in grid[i:i + n]]))
        i += n
    return out


def mesh_size(cfg: dict) -> int:
    """The cards (or CPU shards) the configuration's bank spans."""
    return int(cfg.get("mesh", 1))


def make_mesh(cfg: dict, device):
    """The channel mesh of a configuration with ``mesh`` > 1 (None
    otherwise): the first ``mesh`` cards, or that many CPU shards where
    `device` is the CPU."""
    n = mesh_size(cfg)
    if n == 1:
        return None
    from ka9q_sdr_tpu_torch.parallel.mesh import make_channel_mesh

    mesh = make_channel_mesh(n, cpu=torch.device(device).type == "cpu")
    if mesh.size != n:
        raise RuntimeError(f"the configuration's mesh needs {n} devices; "
                           f"found {mesh.size}")
    return mesh


class System:
    """The bank of a configuration and the entry of a cell.

    `call(x)` runs one block (a host (L, 2) int16 array) through the
    entry and returns its outputs as {name: tensor}: per group g
    ``g<g>.pcm``, ``g<g>.idx`` (compaction only) and the diag leaves.

    With the configuration's ``mesh`` > 1 a ``ChannelBank`` is sharded
    over the mesh as bankd's ``--mesh`` (``shard_fft`` as
    ``--shard-fft``): its channels padded to a multiple of the mesh, the
    compaction told the real count (``n_valid``), and the padding rows
    dropped from every output before the comparison sees it.  `mesh`:
    the configuration's mesh (``make_mesh``) where the caller has built
    it already, built here otherwise."""

    def __init__(self, cfg: dict, compact: bool, device, mesh=None):
        from ka9q_sdr_tpu_torch.models.bank import (ChannelBank, MultiBank,
                                                    make_bank_config)

        self.cfg = cfg
        self.groups = channel_freqs(cfg)
        kw = dict(samprate=float(cfg["samprate"]), L=cfg["L"], M=cfg["M"],
                  enable_pl=bool(cfg.get("enable_pl", False)))
        self.max_active = cfg.get("max_active") if compact else None
        if mesh is None:
            mesh = make_mesh(cfg, device)
        self.mesh = mesh
        self.n_real = None          # the real rows where the mesh pads
        if cfg["kind"] == "ChannelBank":
            (mode, freqs), = self.groups
            if mesh is None:
                bc = make_bank_config(len(freqs), mode, **kw)
                self.bank = ChannelBank(bc, freqs, device=device)
            else:
                from ka9q_sdr_tpu_torch.parallel.mesh import pad_channels

                padded = pad_channels(freqs, mesh.size)
                if len(padded) != len(freqs):
                    self.n_real = len(freqs)
                bc = make_bank_config(len(padded), mode, **kw)
                self.bank = ChannelBank(
                    bc, padded, mesh=mesh,
                    shard_fft=bool(cfg.get("shard_fft", False)))
            self._fresh = self.bank.state
            if self.max_active:
                self._entry = self._active
            else:
                self._entry = self._pcm
        elif cfg["kind"] == "MultiBank":
            if mesh is not None:
                raise ValueError("no configuration runs a MultiBank on a "
                                 "mesh yet")
            self.bank = MultiBank(self.groups, device=device, **kw)
            self._fresh = self.bank.states
            self._entry = self._multi
        else:
            raise ValueError(f"unknown bank kind {cfg['kind']!r}")

    def _pack(self, g: int, pcm, diag, idx=None) -> dict:
        n = self.n_real
        if n is not None:
            # the mesh's padding rows dropped (bankd's a[: n_real]); the
            # compacted PCM has a row a slot, which n_valid keeps padding
            # out of
            diag = {k: v[:n] for k, v in diag.items() if v is not None}
            if idx is None:
                pcm = pcm[:n]
        out = {f"g{g}.pcm": pcm}
        if idx is not None:
            out[f"g{g}.idx"] = idx
        out.update({f"g{g}.{k}": diag[k] for k in DIAG_KEYS
                    if diag.get(k) is not None})
        return out

    def _pcm(self, x):
        pcm, diag = self.bank.process_i16_pcm(x)
        return self._pack(0, pcm, diag)

    def _active(self, x):
        n = self.n_real
        if n is None:
            pcm, idx, diag = self.bank.process_active(x, self.max_active)
        else:
            pcm, idx, diag = self.bank.process_active(x, self.max_active,
                                                      n_valid=n)
        return self._pack(0, pcm, diag, idx)

    def _multi(self, x):
        out = {}
        for g, (pcm, diag) in enumerate(self.bank.process_i16_pcm(x)):
            out.update(self._pack(g, pcm, diag))
        return out

    def call(self, x) -> dict:
        return self._entry(x)

    def reset(self) -> None:
        """Back to the state of a fresh bank (after the warm-up); the
        captured graphs stay."""
        if self.cfg["kind"] == "ChannelBank":
            self.bank.state = self._fresh
        else:
            self.bank.states = self._fresh


def fill_call(shape, device, seed: int):
    """A closure running the two fills the FM demodulator makes a block at
    `shape` (channels, samples): a complex64 conjugate view and a float32
    array, each with a bool mask and a per-row initial value."""
    from ka9q_sdr_tpu_torch.ops.ffill import forward_fill_multi

    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    B, T = shape
    z = torch.randn((B, T, 2), generator=g, device=device)
    bb = torch.view_as_complex(z)
    mask = torch.rand((B, T), generator=g, device=device) > 0.25
    disc = torch.randn((B, T), generator=g, device=device)
    init_c = torch.ones(B, dtype=torch.complex64, device=device)
    init_f = torch.zeros(B, dtype=torch.float32, device=device)
    conj = torch.conj(bb)

    def run():
        forward_fill_multi((conj,), mask, (init_c,))
        forward_fill_multi((disc,), mask, (init_f,))

    return run


def agc_call(shape, device, seed: int, modes):
    """A closure running the hang AGC once a mode in `modes` at `shape`,
    with each mode's parameters at 48 kHz (as the linear demodulator
    makes them, from the benchmark's own mode table)."""
    from ka9q_sdr_tpu_torch.ops.agc import AGCParams, agc_block, agc_init

    from .reference.core import mode_row

    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    B, T = shape
    level = torch.rand((B, T), generator=g, device=device) * 0.01
    T_s = 1.0 / 48000.0
    params = [AGCParams.from_mode(-15.0, mode_row(m).recovery,
                                  mode_row(m).hang, T_s) for m in modes]
    state = agc_init(100.0, (B,), device=device)

    def run():
        for p in params:
            agc_block(state, level, p)

    return run
