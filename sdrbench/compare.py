"""How ``correct`` is decided: every block the window served, held
against the plain reference (``reference.bank.RefBank``, float64) run
over the same blocks from a fresh state, once the window has closed.

What is kept from each block (``Check.keep``) and compared:

- the int16 PCM of the followed channels (every channel that carries a
  signal, and `track_noise` noise channels a group drawn from the seed):
  ``pcm_gap_lsb``, the largest |program - reference| in LSB, the
  reference unrounded (the program truncates toward zero, so a sound run
  reads below 1 plus its arithmetic's error);
- in a group whose AGC holds a clamp for a hang time (USB): each
  carrier's block of PCM fitted to the reference's by one scalar gain c,
  its shape as the RMS residual after that gain relative to the
  reference's RMS, and its level as |c - 1|: each over all carriers and
  blocks at the 95th percentile (``hang_agc_shape_p95``,
  ``hang_agc_gain_p95``), and the worst carrier's median over its blocks
  (``hang_agc_shape_worst_median``: a fault on one carrier).  A clamp
  that rounding decides apart holds a gain up to some tens of percent
  apart in a few blocks (the hang, 1.1 s, against the recovery's
  growth), so neither the largest gap nor a sample-by-sample one is
  steady; these are, and bfloat16 moves them.  The gain's worst-carrier
  median (``hang_agc_gain_worst_median``) is reported with no limit: a
  carrier that recovers for long stretches drifts some 0.1-0.3% in
  float32, less than three times under what bfloat16 reads;
- every channel's ``bb_power`` diag: ``bb_power_rel_gap``, the largest
  relative gap (it covers the int16 ingest, the master FFT and the
  channelizer of every channel);
- every FM channel's squelch flag and each followed PLL channel's lock
  flag: ``flags_mismatch``, the count that differ;
- each followed FM carrier's measured PL tone: ``plfreq_mismatch``, the
  count of readings more than one PL bin (1500/16384 Hz) apart or NaN on
  one side only (the peak pick may part a near tie of two bins);
- with the entry's compaction (``process_active``): the set of channels
  each block returns against the reference's (the channels whose squelch
  was open in the block or the two before, whose audio the filter still
  carries), ``active_mismatch`` blocks, and each returned row's PCM under
  ``pcm_gap_lsb``.

The domain, and why: an FM carrier's PCM from block 0; an FM noise
channel's from block 3, once its squelch (open in a cold bank's first
block) has shut and the audio filter's memory (2 blocks at 20 ms) has
passed, since its discriminator on noise turns rounding into other
blanked samples; a linear channel's PCM from block 1, since in a cold
bank's first block the AGC's 100 dB start magnifies rounding on the
filter's rising edge; a PLL or hang-AGC channel that carries no signal
has no PCM compared (a carrier search over noise picks among near ties; a
hang AGC on noise holds whichever peak rounding let clamp) but a PLL
channel's lock flag is; the active set from block 3.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.bank import RefBank
from .reference.core import Prec, mode_row

PL_BIN = 1500.0 / 16384


class Check:
    """What the window keeps and how it is held against the reference."""

    def __init__(self, groups, plan, cfg: dict, traffic: dict, seed: int):
        self.groups = groups                      # [(mode, freqs)]
        self.cfg = cfg
        rng = np.random.default_rng([seed % (1 << 63), 1])
        self.rows, self.signal = [], []
        for g, (mode, freqs) in enumerate(groups):
            sig = set(plan.channels(g).tolist())
            quiet = np.setdiff1d(np.arange(len(freqs)), sorted(sig))
            k = min(traffic.get("track_noise", 0), len(quiet))
            noise = set(rng.choice(quiet, k, replace=False).tolist())
            self.rows.append(np.asarray(sorted(sig | noise), np.int64))
            self.signal.append(np.asarray(
                [c in sig for c in self.rows[-1]]))
        # a hang AGC holds whatever gain a clamp set for the hang time, so
        # a clamp that rounding decides apart holds a gain apart for up to
        # that long: such groups' carriers are compared by each block's
        # fitted gain and shape (above); their noise channels not at all;
        # the other groups sample by sample
        self.hang = [mode_row(m).demod == "LINEAR" and mode_row(m).hang > 0
                     for m, _ in groups]
        self.kept: dict = {}

    def keep(self, b: int, host: dict) -> None:
        """Keep block b's outputs that the comparison reads."""
        out = []
        for g, (mode, _) in enumerate(self.groups):
            rows = self.rows[g]
            k = {"bb_power": host[f"g{g}.bb_power"].copy()}
            if f"g{g}.idx" in host:
                k["idx"] = host[f"g{g}.idx"].copy()
                k["pcm"] = host[f"g{g}.pcm"].copy()
            else:
                k["pcm"] = host[f"g{g}.pcm"][rows].copy()
            for key in ("squelch_open", "plfreq", "pll_lock"):
                v = host.get(f"g{g}.{key}")
                if v is not None:
                    k[key] = v.copy() if key == "squelch_open" else v[rows]
            out.append(k)
        self.kept[b] = out

    def reference(self, device, prec: Prec | None = None) -> RefBank:
        cfg = self.cfg
        return RefBank([(m, f, self.rows[g])
                        for g, (m, f) in enumerate(self.groups)],
                       float(cfg["samprate"]), cfg["L"], cfg["M"],
                       enable_pl=bool(cfg.get("enable_pl")),
                       ingest="i16", device=device, prec=prec)

    def observed_from(self, ref_out: list) -> list:
        """A reference run's outputs in the kept form (the control)."""
        out = []
        for g, r in enumerate(ref_out):
            k = {"bb_power": r["bb_power"].cpu().numpy(),
                 "pcm": _pcm(r["audio"].cpu().numpy())}
            if "squelch_open" in r:
                k["squelch_open"] = r["squelch_open"].cpu().numpy()
            for key in ("plfreq", "pll_lock"):
                if key in r:
                    k[key] = r[key].cpu().numpy()
            out.append(k)
        return out

    def compare(self, blocks: np.ndarray, device,
                control: Prec | None = None, n_blocks: int = 0) -> dict:
        """Run the reference over blocks 0..last kept and hold every kept
        block against it.  With `control`, the reference in that precision
        stands in the program's place, every block from 0 to the last
        kept one (its rows held as the uncompacted entry's), or the first
        `n_blocks`."""
        observed = self.kept
        last = (max(observed) if observed else -1) if control is None \
            else n_blocks - 1
        ref = self.reference(device)
        alt = self.reference(device, control) if control is not None else None
        tally = Tally()
        loop = torch.as_tensor(blocks, device=device)
        history = []                       # FM squelch flags, last 3 blocks
        for b in range(last + 1):
            x = loop[b % loop.shape[0]]
            r = ref.step(x)
            history = (history + [[o.get("squelch_open") for o in r]])[-3:]
            obs = (self.observed_from(alt.step(x)) if alt is not None
                   else observed.get(b))
            if obs is None:
                continue
            for g, (o, rr) in enumerate(zip(obs, r)):
                self._block(tally, b, g, o, rr, history)
        self.where = tally.where
        return tally.numbers()

    def _active_ref(self, history, g):
        flags = [h[g] for h in history if h[g] is not None]
        if len(flags) < 3:
            return None
        anyopen = np.logical_or.reduce([f.cpu().numpy() for f in flags])
        return set(np.nonzero(anyopen)[0].tolist())

    def _block(self, t, b, g, o, r, history) -> None:
        rows, signal = self.rows[g], self.signal[g]
        ref_pcm = np.clip(r["audio"].cpu().numpy() * 32767.0, -32768, 32767)
        is_fm = "squelch_open" in r
        pll = "pll_lock" in r
        first = np.where(signal, 0 if is_fm else 1, 3 if is_fm else 1)
        cmp = b >= first
        if pll:
            cmp &= signal
        if "idx" in o:
            pos = {c: i for i, c in enumerate(rows)}
            act = self._active_ref(history, g)
            got = set(int(c) for c in o["idx"] if c >= 0)
            if b >= 3 and act is not None and len(act) <= len(o["idx"]):
                t.count("active_mismatch", got != act)
            for i, c in enumerate(o["idx"]):
                c = int(c)
                if c >= 0 and c in pos and cmp[pos[c]]:
                    t.gap("pcm_gap_lsb", np.abs(
                        o["pcm"][i].astype(np.float64) - ref_pcm[pos[c]]),
                        (b, g, c))
        elif self.hang[g]:
            sel = cmp & signal
            if sel.any():
                p = o["pcm"][sel].astype(np.float64)
                rr = ref_pcm[sel]
                rn = np.sum(rr * rr, axis=-1)
                ok = rn > rr.shape[-1]               # above 1 LSB RMS
                c = np.sum(p * rr, axis=-1)[ok] / rn[ok]
                res = p[ok] - c[:, None] * rr[ok]
                chans = rows[sel][ok]
                t.sample("hang_agc_shape",
                         np.sqrt(np.sum(res * res, axis=-1) / rn[ok]), chans)
                t.sample("hang_agc_gain", np.abs(c - 1.0), chans)
        elif cmp.any():
            d = np.abs(o["pcm"][cmp].astype(np.float64) - ref_pcm[cmp])
            t.gap("pcm_gap_lsb", d,
                  (b, g, int(rows[cmp][np.argmax(d.max(axis=-1))])))
        rb = r["bb_power"].cpu().numpy()
        ok = rb > 0
        t.gap("bb_power_rel_gap",
              np.abs(o["bb_power"][ok] - rb[ok]) / rb[ok])
        if is_fm and "squelch_open" in o:
            t.count("flags_mismatch", int(np.sum(
                o["squelch_open"] != r["squelch_open"].cpu().numpy())))
        if pll and "pll_lock" in o:
            t.count("flags_mismatch", int(np.sum(
                o["pll_lock"] != r["pll_lock"].cpu().numpy())))
        if "plfreq" in r and "plfreq" in o:
            rp = r["plfreq"].cpu().numpy()[signal]
            op = o["plfreq"][signal].astype(np.float64)
            nan = np.isnan(rp) != np.isnan(op)
            far = np.abs(np.nan_to_num(op) - np.nan_to_num(rp)) > PL_BIN * 1.01
            t.count("plfreq_mismatch", int(np.sum(nan | far)))


def _pcm(audio: np.ndarray) -> np.ndarray:
    return np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)


class Tally:
    def __init__(self):
        self.v: dict = {}
        self.where: dict = {}          # the largest gap's (block, group, row)
        self.samples: dict = {}

    def gap(self, name: str, values, where=None) -> None:
        if np.size(values):
            m = float(np.max(values))
            if m > self.v.get(name, -1.0):
                self.where[name] = where
            self.v[name] = max(self.v.get(name, 0.0), m)
        else:
            self.v.setdefault(name, 0.0)

    def sample(self, name: str, values, keys) -> None:
        d = self.samples.setdefault(name, {})
        for k, v in zip(np.ravel(keys).tolist(), np.ravel(values).tolist()):
            d.setdefault(k, []).append(v)

    def count(self, name: str, n) -> None:
        self.v[name] = self.v.get(name, 0) + int(n)

    def numbers(self) -> dict:
        out = dict(self.v)
        for k, per in self.samples.items():
            v = [x for xs in per.values() for x in xs]
            out[f"{k}_p95"] = float(np.percentile(v, 95)) if v else None
            out[f"{k}_worst_median"] = max(
                (float(np.median(xs)) for xs in per.values()), default=None)
        return out
