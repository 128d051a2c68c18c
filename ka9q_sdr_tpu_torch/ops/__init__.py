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
    fft_fourstep,
    FOURSTEP_MIN,
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
from .agc import AGCParams, AGCState, agc_init, agc_block, agc_block_coarse
from .iir import one_pole_lowpass, dc_block, notch_init, notch_block
from .decimate import hb15_coeffs, hb15_block, hb3_block, hb_cascade, cascade_init
from .pstock import make_fft_cols, stockham_rows, stockham_rows_np
