"""Channel mesh: shard the channel bank's channel axis over devices (the
JAX package's ``parallel/mesh.py``, same split of the state).

The per-block work is one shared wideband FFT plus per-channel
gather/IFFT/demod.  So the sharding is:

- the wideband block and the master overlap: replicated on every device;
- every per-channel state leaf (bin shifts, NCO phases, demod state) and
  the audio: split on the leading channel axis.

Each device then runs the bank step on its own channels with no
communication.  ``shard_fft=True`` distributes the master FFT too: the
two-step decomposition of ``parallel.dfft`` leaves each device a comb of
the spectrum, and each device gathers its channels' bins straight from the
comb slices where they live.

The JAX package shards one jitted program over a ``jax.sharding.Mesh``;
the port drives the devices from one process, as JAX's ``bankd --mesh``
does: a mesh is a list of devices (``cuda:0..D-1`` on a machine with D
cards; a list that repeats one card runs the same sharded code on it; CPU
shards on the host), a sharded state is a tuple with one ``BankState`` per
device, and the step's audio and diagnostics are gathered onto the mesh's
first device (one peer copy per shard) so callers fetch them as one tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..models.bank import (BankConfig, BankState, _active_pcm,
                           _bank_step_bins, _complex_block, _edit_row,
                           _gather_index, _map_leaves, _pcm, _top_active,
                           bank_recenter, bank_step, iq_from_i16)
from ..utils.graphs import MeshGraphs, fetch, scan, static_copy
from .dfft import comb_assemble, comb_positions, make_dfft_sm

__all__ = [
    "CHANNEL_AXIS",
    "ChannelMesh",
    "ShardedBankStep",
    "make_channel_mesh",
    "bank_state_shardings",
    "shard_bank_state",
    "gather_bank_state",
    "shard_configs",
    "gather_shards",
    "edit_channel",
    "make_sharded_bank_step",
    "pad_channels",
]

CHANNEL_AXIS = "ch"


class ChannelMesh(NamedTuple):
    """The devices a bank's channel axis is split over, in shard order."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_channel_mesh(n_devices: int | None = None, *,
                      devices: Sequence | None = None,
                      cpu: bool = False) -> ChannelMesh:
    """A mesh of the first `n_devices` CUDA devices (all of them when None;
    fewer where the machine has fewer, as the JAX package takes
    ``jax.devices()[:n]``), or of `n_devices` CPU shards when `cpu`, or of
    an explicit `devices` list (which may name one card several times)."""
    if devices is None:
        if cpu:
            devices = [torch.device("cpu")] * (n_devices or 1)
        else:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
            devices = devices[:n_devices]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a channel mesh needs at least one device")
    return ChannelMesh(devices)


def pad_channels(freqs, n_devices: int):
    """Pad a frequency list to a multiple of the device count.  The pads
    duplicate the last frequency; callers keep n_real = len(freqs) and
    ignore the padded audio rows (``n_valid`` keeps them out of the active
    set)."""
    freqs = list(freqs)
    rem = len(freqs) % n_devices
    if rem:
        freqs = freqs + [freqs[-1]] * (n_devices - rem)
    return freqs


def bank_state_shardings(mesh, state: BankState) -> BankState:
    """A BankState of the same structure whose leaves say where each state
    leaf lives: CHANNEL_AXIS (split on its leading axis) or None
    (replicated), as the JAX package's bank_state_shardings."""
    del mesh
    ch = lambda t: _map_leaves(lambda a, _: CHANNEL_AXIS, t, t)
    return BankState(overlap=None, resp=None, k=CHANNEL_AXIS,
                     r=CHANNEL_AXIS, dr=CHANNEL_AXIS, nco=ch(state.nco),
                     demod=ch(state.demod), gain_factor=None)


def _check_divisible(n_channels: int, mesh: ChannelMesh) -> int:
    if n_channels % mesh.size:
        raise ValueError(
            f"n_channels={n_channels} not divisible by the {mesh.size}-device "
            f"mesh; pad the bank to a multiple of {mesh.size} channels "
            f"(pad_channels)")
    return n_channels // mesh.size


def shard_bank_state(mesh: ChannelMesh, state: BankState) -> tuple:
    """Split a BankState over the mesh: one BankState per device."""
    b = _check_divisible(state.k.shape[0], mesh)
    spec = bank_state_shardings(mesh, state)
    return tuple(
        _map_leaves(lambda t, s: (t[d * b:(d + 1) * b]
                                  if s == CHANNEL_AXIS else t).to(dev),
                    state, spec)
        for d, dev in enumerate(mesh.devices))


def _gather_tree(trees, spec, device):
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, tuple):
        out = [_gather_tree([t[i] for t in trees], spec[i], device)
               for i in range(len(t0))]
        return type(t0)(*out) if hasattr(t0, "_fields") else tuple(out)
    if spec == CHANNEL_AXIS:
        return torch.cat([t.to(device) for t in trees])
    return t0.to(device)


def gather_bank_state(states: Sequence[BankState], device=None) -> BankState:
    """The inverse of shard_bank_state: one BankState on `device` (the
    first shard's device by default); replicated leaves from shard 0."""
    device = states[0].k.device if device is None else device
    return _gather_tree(list(states), bank_state_shardings(None, states[0]),
                        device)


def shard_configs(cfg: BankConfig, mesh: ChannelMesh) -> list:
    """The host config `cfg` for one shard of its channels on each device
    of the mesh."""
    b = _check_divisible(cfg.n_channels, mesh)
    return [cfg._replace(n_channels=b).to(dev) for dev in mesh.devices]


def gather_shards(parts, device):
    """Per-device tensors split on their leading axis, as one tensor on
    `device` (None stays None: a diag entry the mode does not produce)."""
    if parts[0] is None:
        return None
    return torch.cat([p.to(device) for p in parts])


def edit_channel(states, channel: int, fn) -> tuple:
    """A sharded state with fn(state, row) applied to the shard that owns
    `channel` (a live edit such as bank_tune or bank_set_doppler, given the
    row within that shard)."""
    return _edit_row(states, states[0].k.shape[0], channel,
                     lambda s, i, _: fn(s, i))


def _ingest(x: torch.Tensor, ingest: str) -> torch.Tensor:
    """The raw block as complex64: (L, 2) int16 ("i16"), or (L,) complex
    or (L, 2) float I/Q ("f32")."""
    return iq_from_i16(x) if ingest == "i16" else _complex_block(x)


class ShardedBankStep:
    """The bank step over a mesh for one config: each device runs its
    shard's channels through ``bank_step`` (replicated master FFT) or, with
    `shard_fft`, through the distributed master FFT and the comb gather.

    Calls take the sharded state (one BankState per device) and write the
    new state into it in place.  Each shard's step is captured as a CUDA
    graph on its own device (``utils.graphs``; `capture=False` runs it
    eagerly), so a block replays one graph a shard.  The ``shard_fft``
    step exchanges data between devices inside the block: it is a chain
    of three graphs a shard (``MeshGraphs.chain``, ``_fft_links``), so a
    block replays three a shard, ordered by events on the devices, with no
    host wait.  The gather onto the first device and ``active()``'s top-k
    run eagerly after the replays."""

    def __init__(self, cfg: BankConfig, mesh: ChannelMesh,
                 shard_fft: bool = False, capture: bool = True):
        self.mesh = mesh
        self.b = cfg.n_channels // mesh.size
        self.cfg = cfg
        self.cfgs = shard_configs(cfg, mesh)
        self.dfft = None
        if shard_fft:
            P, N, N_dec = mesh.size, cfg.N, cfg.N_dec
            if N % P or N_dec % P:
                raise ValueError(
                    f"shard_fft: N={N} and N_dec={N_dec} must both be "
                    f"divisible by the {P}-device mesh")
            base = np.asarray(cfg.base_idx, np.int64)
            # comb_gather reads column i of a channel's window from device
            # (base[i] + k) % P: the columns of one device are every P-th
            if base[0] != 0 or np.any(base % P != np.arange(N_dec) % P):
                raise ValueError("shard_fft: the slave gather pattern is not "
                                 "a window of consecutive bins")
            self.dfft = make_dfft_sm(mesh, N)
        self.mesh_graphs = MeshGraphs(mesh.devices, capture)
        self.graphs = self.mesh_graphs.shards

    def set_config(self, cfg: BankConfig) -> None:
        """A config of the same geometry (a filter swap): the shards'
        configs follow it, and the steps are captured again where the
        demodulator's constants (the FM audio gain) changed with it."""
        if cfg.demod_cfg is not self.cfg.demod_cfg:
            self.mesh_graphs.clear()
        self.cfg = cfg
        self.cfgs = shard_configs(cfg, self.mesh)

    def _shard_fn(self, d: int, ingest: str, pcm_out: bool):
        """Shard d's step: (state, x) -> (state, (audio, diag))."""
        cfg, dev = self.cfgs[d], self.mesh.devices[d]

        def fn(state, x):
            new, audio, diag = bank_step(cfg, state, _ingest(x.to(dev),
                                                             ingest))
            return new, ((_pcm(audio) if pcm_out else audio), diag)

        return fn

    def _fft_links(self, ingest: str, pcm_out: bool) -> tuple:
        """The shard_fft step as three links a shard (``MeshGraphs.chain``):

        - ingest: the shard's block after the overlap, its slice's partial
          products (``DistributedFFT.partials``), the recentered state
          (written) and where each comb slice keeps its channels' bins
          (``comb_positions``);
        - fft: comb slice j from every shard's partials (the reduce-scatter
          sum, twiddle, local FFT), and from it the bins each shard's
          channels need;
        - demod: the shard's bins from every comb slice
          (``comb_assemble``), channelize and demod -> (audio, diag)."""
        P, devs, dfft = self.mesh.size, self.mesh.devices, self.dfft
        L, Q = self.cfg.master.L, self.cfg.N // P

        def ingest_link(d):
            cfg = self.cfgs[d]

            def fn(s, x):
                blk = _ingest(x, ingest)
                if blk.shape[-1] != L:
                    raise ValueError(f"block length {blk.shape[-1]} != L = "
                                     f"{L}")
                buf = torch.cat([s.overlap, blk * s.gain_factor])
                s = bank_recenter(cfg, s)   # k-hops for swept channels
                pos = comb_positions(_gather_index(cfg, s), P)
                return (s._replace(overlap=buf[L:]),
                        (dfft.partials(d, buf[d * Q:(d + 1) * Q]), pos))

            return fn

        def fft_link(j):
            def fn(s, prev):
                comb = dfft.combine(j, [fetch(z[j], devs[j])
                                        for z, _ in prev])
                return s, [comb[fetch(pos[j], devs[j])] for _, pos in prev]

            return fn

        def demod_link(d):
            cfg = self.cfgs[d]

            def fn(s, prev):
                bins = comb_assemble([fetch(parts[d], devs[d])
                                      for parts in prev],
                                     _gather_index(cfg, s))
                new, audio, diag = _bank_step_bins(cfg, s, bins)
                return new, ((_pcm(audio) if pcm_out else audio), diag)

            return fn

        return ingest_link, fft_link, demod_link

    def _run(self, states, x, ingest: str, pcm_out: bool,
             replicated: bool = False) -> list:
        """Every shard's (audio, diag); the new state written into
        `states`.  A `shard_fft` mesh runs its chain unless `replicated`:
        then each shard's step with the master FFT replicated, after a
        fence."""
        x = torch.as_tensor(x, device=self.mesh.devices[0])
        # the block reaches every device before any shard's step is
        # queued: a copy from the first device waits on its stream, so a
        # copy queued behind shard 0's step would hold the others back
        xs = [x.to(dev) for dev in self.mesh.devices]
        if self.dfft is not None:
            if not replicated:
                return self.mesh_graphs.chain(
                    (ingest, pcm_out), self._fft_links(ingest, pcm_out),
                    states, xs)
            # after a shard_fft block: no graph may overwrite what another
            # device's link still reads
            self.mesh_graphs.fence()
        return [g.run((ingest, pcm_out), self._shard_fn(d, ingest, pcm_out),
                      states[d], (xs[d],)) for d, g in enumerate(self.graphs)]

    def _gather_diag(self, diags) -> dict:
        dev = self.mesh.devices[0]
        return {k: gather_shards([d[k] for d in diags], dev)
                for k in diags[0]}

    def step(self, states, x, ingest: str = "f32", pcm_out: bool = False):
        """One block: (L,) complex or (L, 2) float I/Q (ingest "f32"), or
        (L, 2) int16 (ingest "i16").  Writes the new state into `states`;
        returns (audio, diag) with the audio (B, L_dec[, 2]) (int16 when
        pcm_out) and the diag gathered onto the mesh's first device."""
        outs = self._run(states, x, ingest, pcm_out)
        return (gather_shards([a for a, _ in outs], self.mesh.devices[0]),
                self._gather_diag([d for _, d in outs]))

    def scan(self, states, blocks, pcm_out: bool = False):
        """(k, L, 2) int16 blocks in order: on each shard one graph of k
        steps.  Returns the audio (k, B, L_dec[, 2]) on the first device.

        The steps replicate the master FFT, with `shard_fft` too: the JAX
        package compiles a mesh bank's ``process_scan_i16`` as the
        replicated ``bank_scan_packed_i16`` whatever ``shard_fft`` says."""
        dev0 = self.mesh.devices[0]
        blocks = torch.as_tensor(blocks, device=dev0)
        staged = [blocks.to(dev) for dev in self.mesh.devices]   # see _run
        # after a shard_fft block: no graph may overwrite what another
        # device's link still reads
        self.mesh_graphs.fence()
        parts = []
        for d, g in enumerate(self.graphs):
            def one(s, x, fn=self._shard_fn(d, "i16", pcm_out)):
                s, (audio, _) = fn(s, x)
                return s, audio

            parts.append(g.run(
                ("scan", pcm_out), lambda s, xs, one=one: scan(one, s, xs),
                states[d], (staged[d],),
                warmup=lambda s, xs, one=one: one(s, xs[0])))
        return torch.cat([p.to(dev0) for p in parts], dim=1)

    def active(self, states, x_i16, max_active: int,
               n_valid: int | None = None):
        """bank_step_active over the mesh: each shard's (B/D,) audio peaks
        are gathered onto the first device, the top-max_active taken there
        (rows at or past n_valid never compete), and each selected row is
        fetched from the shard that owns it.  Writes the new state into
        `states`; returns (pcm, idx, diag) as bank_step_active.

        The steps replicate the master FFT, with `shard_fft` too: the JAX
        package compiles a mesh bank's ``process_active`` as the
        replicated ``bank_step_active`` whatever ``shard_fft`` says."""
        outs = self._run(states, x_i16, "i16", False, replicated=True)
        dev0, b = self.mesh.devices[0], self.b
        flats = [a.reshape(a.shape[0], -1) for a, _ in outs]
        peak = gather_shards(
            [torch.amax(torch.abs(f), dim=-1) for f in flats], dev0)
        idx = _top_active(peak, max_active, n_valid)
        sel = None
        for d, f in enumerate(flats):
            rows = f[(idx - d * b).clamp(0, b - 1).to(f.device)].to(dev0)
            sel = rows if sel is None else torch.where(
                (idx // b == d)[:, None], rows, sel)
        pcm, idx = _active_pcm(sel, idx, n_valid)
        return pcm, idx, self._gather_diag([d for _, d in outs])


def make_sharded_bank_step(cfg: BankConfig, mesh: ChannelMesh,
                           state: BankState, shard_fft: bool = False,
                           ingest: str = "f32", pcm_out: bool = False):
    """The bank step with the channel axis sharded over `mesh`, and the
    initial `state` (one BankState on any device) split over it.

    ingest: "f32" = (L,) complex64 or (L, 2) float32 I/Q; "i16" = raw
    (L, 2) int16 with the scale conversion on the device; pcm_out also
    quantises the audio to int16 (only with ingest="i16").  shard_fft
    distributes the master FFT (``parallel.dfft``); the audio is the same
    to float32 rounding.  The channel count must divide evenly over the
    mesh (pad_channels pads a frequency list).

    Returns (step, sharded_state); step(sharded_state, x) -> (sharded_state,
    audio, diag).  The step is functional and eager: it leaves the state
    it is given as it was (``ChannelBank(mesh=)`` holds a static state and
    replays the captured steps, the twin of this one)."""
    if ingest not in ("f32", "i16"):
        raise ValueError(f"ingest must be 'f32' or 'i16', got {ingest!r}")
    if pcm_out and ingest != "i16":
        raise ValueError("pcm_out requires ingest='i16'")
    sb = ShardedBankStep(cfg, mesh, shard_fft, capture=False)

    def step(states, x):
        states = tuple(static_copy(s) for s in states)
        audio, diag = sb.step(states, x, ingest, pcm_out)
        return states, audio, diag

    return step, shard_bank_state(mesh, state)
