"""Half-band decimator cascade for power-of-2 sample-rate reduction.

Port of ``ka9q_sdr_tpu.ops.decimate`` (the reference's decimate.c, as the
hackrf front end uses it, hackrf.c:229-238, 295-318): decimate-by-2 stages,
a 3-tap (1, 2, 1) filter for the early wideband stages and the
Goodman/Carey "F8" 15-tap half-band filter for the final ones.  Each stage
is a sum of strided slices, one per nonzero tap, in the JAX package's term
order; its state is the carried (ntaps - 1)-sample overlap.

Each stage has +6 dB DC gain (unity middle tap); callers apply
0.5^stages (Filter_atten, hackrf.c:469).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["hb15_coeffs", "hb15_block", "hb3_block", "hb_cascade",
           "cascade_init"]


def hb15_coeffs() -> np.ndarray:
    """Goodman/Carey F8 15-tap half-band taps (hackrf.c:230-238).

    coeffs[3] = 490/802 is adjacent to the unity centre tap; even taps
    are 0."""
    c = np.array([-6.0, 33.0, -116.0, 490.0]) / 802.0
    taps = np.zeros(15)
    taps[7] = 1.0  # unity centre tap
    for i, cv in enumerate(c):  # i=0 at the tails (offset 7,5,3,1)
        off = 7 - 2 * i
        taps[7 - off] = cv
        taps[7 + off] = cv
    return taps


_HB3_TAPS = np.array([1.0, 2.0, 1.0])


def _fir_decim2(state: torch.Tensor, x: torch.Tensor, taps: np.ndarray):
    """Decimate-by-2 FIR: y[k] = sum_j taps[j] * xx[2k + j] with
    xx = [carried overlap | x].  Returns (new_state, y)."""
    if x.shape[-1] % 2:
        # an odd block would shift the decimation grid one sample for every
        # later block
        raise ValueError(f"decimate-by-2 needs an even block, got "
                         f"{x.shape[-1]}")
    xx = torch.cat([state, x], dim=-1)
    n_out = x.shape[-1] // 2
    y = None
    for j, tap in enumerate(taps):
        if tap == 0.0:
            continue
        sl = xx[..., j: j + 2 * n_out: 2]
        # the tap rounded to float32, as the JAX package's asarray does
        term = sl if tap == 1.0 else sl * float(np.float32(tap))
        y = term if y is None else y + term
    return xx[..., x.shape[-1]:], y


def hb15_block(state: torch.Tensor, x: torch.Tensor):
    """15-tap half-band decimate-by-2 (decimate.c:111-146); state carries
    14 samples."""
    return _fir_decim2(state, x, hb15_coeffs())


def hb3_block(state: torch.Tensor, x: torch.Tensor):
    """3-tap (1,2,1) half-band decimate-by-2 (decimate.c:148-161); state
    carries 2 samples."""
    return _fir_decim2(state, x, _HB3_TAPS)


def cascade_init(log_decimate: int, stage_threshold: int = 8,
                 dtype=torch.float32, batch_shape=(), *,
                 device) -> list[torch.Tensor]:
    """Zero state for a 2^log_decimate cascade, widest-band stage first;
    stages at index >= stage_threshold (counted as in hackrf.c:295-299)
    use the 3-tap filter."""
    states = []
    for stage in range(log_decimate - 1, -1, -1):
        ntaps = 3 if stage >= stage_threshold else 15
        states.append(torch.zeros(tuple(batch_shape) + (ntaps - 1,),
                                  dtype=dtype, device=device))
    return states


def hb_cascade(states: list[torch.Tensor], x: torch.Tensor,
               log_decimate: int, stage_threshold: int = 8):
    """Run a full 2^log_decimate decimation cascade (hackrf.c:295-318).

    Returns (new_states, y) with y decimated by 2^log_decimate and a DC
    gain of 2^log_decimate."""
    new_states = []
    for i, stage in enumerate(range(log_decimate - 1, -1, -1)):
        fn = hb3_block if stage >= stage_threshold else hb15_block
        s, x = fn(states[i], x)
        new_states.append(s)
    return new_states, x
