"""Demodulators, receivers and channel banks on torch tensors (port of
``ka9q_sdr_tpu.models``): the noise estimate, the FM, AM and linear
demodulators, the single-channel receiver, and the single- and mixed-mode
channel banks."""

from .noise import compute_n0, passband_mask
from .demod_fm import FMConfig, FMState, fm_init, fm_demod
from .demod_am import AMConfig, AMState, am_init, am_demod
from .demod_linear import LinearConfig, LinearState, linear_init, linear_demod
from .receiver import ReceiverConfig, ReceiverState, Receiver, make_receiver
from .bank import (BankConfig, BankState, ChannelBank, MultiBank, make_bank,
                   make_bank_config)
