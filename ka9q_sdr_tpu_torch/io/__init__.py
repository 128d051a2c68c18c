"""Signal synthesis on torch tensors (port of ``ka9q_sdr_tpu.io``'s test
modulator; the JAX package's ``io`` package imports jax through it)."""

from .modulate import Modulator, MODULATE_PRESETS
