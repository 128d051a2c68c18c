"""Multi-device sharding of the channel bank (port of
``ka9q_sdr_tpu.parallel``).

The scaling axis is the channel dimension of the bank: every device holds
the replicated wideband block, computes the (replicated) forward FFT, and
gathers/IFFTs/demodulates only its shard of channels, with no
communication in the steady state.  ``shard_fft`` distributes the master
FFT itself (``dfft``).  ``dryrun.dryrun_multichip`` checks every sharded
path against the unsharded bank.
"""

from .mesh import (
    ChannelMesh,
    ShardedBankStep,
    make_channel_mesh,
    bank_state_shardings,
    shard_bank_state,
    gather_bank_state,
    make_sharded_bank_step,
    pad_channels,
)
from .dfft import make_dfft, make_dfft_sm, dfft, undo_comb, comb_index
