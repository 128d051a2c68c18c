"""Demodulators and the channel bank on torch tensors (port of
``ka9q_sdr_tpu.models``): FM, AM and linear demodulators and the
single-mode channel bank."""

from .demod_fm import FMConfig, FMState, fm_init, fm_demod
from .demod_am import AMConfig, AMState, am_init, am_demod
from .demod_linear import LinearConfig, LinearState, linear_init, linear_demod
from .bank import BankConfig, BankState, ChannelBank, make_bank_config
