"""Tiny geometries of the benchmark's configurations and mixes for the CPU
tests: 1.536 Msps, 20 ms blocks (L 30,720, M 34,817, N = 2^16), the same
decimated geometry as the cells (960 samples a block at 48 kHz, a 2048-bin
channel filter), fewer channels and signals.  A mesh configuration keeps
its ``mesh``: on the CPU that many shards of the host."""

from __future__ import annotations

from sdrbench import cells

FS, L, M = 1536000, 30720, 34817


def config(name: str) -> dict:
    cfg = cells.config(name)
    groups = {"fm_pl_4096_20ms": [["FM", 64]],
              "mixed6144_20ms": [["FM", 64], ["USB", 16], ["CAM", 16]],
              # 62 real channels on 4 shards: padded to 64, 16 a shard
              "fm_pl_4094_mesh4_20ms": [["FM", 62]]}[name]
    cfg.update(samprate=FS, L=L, M=M, groups=groups,
               channels=sum(n for _, n in groups), max_active=8)
    return cfg


def traffic(name: str) -> dict:
    t = cells.traffic(name)
    for s in t["signals"]:
        s["count"] = {"FM": 6, "USB": 4, "CAM": 4}[s["mode"]]
    t["track_noise"] = 4
    return t
