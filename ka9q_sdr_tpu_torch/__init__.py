"""ka9q_sdr_tpu_torch — the PyTorch/CUDA port of ``ka9q_sdr_tpu``.

The JAX package ``ka9q_sdr_tpu`` is the reference; this package mirrors its
layout and public names so each counterpart sits under the same path:

- ``ops``      — overlap-save filter engine (``torch.fft``), Kaiser design,
                 fixed-point NCO, and the FM blanking forward fill with its
                 hand-written Hopper kernel (``csrc/ffill.cu``).
- ``models``   — the FM demodulator and the FM(+PL) channel bank.
- ``interop``  — carries state between the two packages as numpy trees.

It imports torch and numpy and never jax.  No function chooses a device by
itself: callers name one (``device=``), and a tensor on a CUDA device always
goes through the CUDA kernels.
"""

__version__ = "0.1.0"
