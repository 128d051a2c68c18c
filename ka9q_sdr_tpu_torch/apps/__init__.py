"""The port's serving daemons (port of ``ka9q_sdr_tpu.apps``): ``bankd``,
the wideband multichannel bank, and ``radio``, the single receiver.  Each
runs with ``python -m ka9q_sdr_tpu_torch.apps.<name>``, on the CUDA card
unless ``--cpu``."""
