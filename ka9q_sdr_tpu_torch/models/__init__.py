"""Demodulators and the channel bank on torch tensors (port of
``ka9q_sdr_tpu.models``): so far the FM demodulator and the FM(+PL) bank."""

from .demod_fm import FMConfig, FMState, fm_init, fm_demod
from .bank import BankConfig, BankState, ChannelBank, make_bank_config
