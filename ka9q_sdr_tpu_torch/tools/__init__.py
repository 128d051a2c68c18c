"""Measurement tools of the port (twins of the JAX package's ``tools/``):
``stage_profile`` (the FM bank block's per-stage device time, and the
receiver's front end), ``serve_soak`` (a sustained serving run of the
active-channel bank) and ``soak.sh`` (the full daemon constellation on
localhost).  Run as ``python -m ka9q_sdr_tpu_torch.tools.<name>``; on the
CUDA card unless ``--cpu``."""
