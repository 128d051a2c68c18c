"""DSP primitives on torch tensors (port of ``ka9q_sdr_tpu.ops``)."""

from .window import (
    i0,
    make_kaiser,
    window_filter,
    window_rfilter,
    brickwall_response,
    design_bandpass,
)
from .fftfilt import (
    FilterType,
    MasterSpec,
    SlaveSpec,
    master_init,
    master_execute,
    slave_execute,
    slave_bin_indices,
    noise_gain,
    set_filter_response,
)
from .nco import (
    OscState,
    osc_init,
    set_osc,
    set_osc_traced,
    osc_block,
    split_double,
    phase_ramp,
    nco_mix,
    osc_advance,
)
from .ffill import forward_fill, forward_fill_multi, last_true_index
