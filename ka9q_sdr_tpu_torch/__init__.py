"""ka9q_sdr_tpu_torch — the PyTorch/CUDA port of ``ka9q_sdr_tpu``.

The JAX package ``ka9q_sdr_tpu`` is the reference; this package mirrors its
layout and public names so each counterpart sits under the same path:

- ``ops``      — overlap-save filter engine (``torch.fft``), Kaiser design,
                 fixed-point NCO, one-pole scans, half-band decimators, and
                 three hand-written Hopper kernels with plain versions: the
                 FM blanking forward fill (``csrc/ffill.cu``), the hang AGC
                 (``csrc/agc.cu``) and the column Stockham FFT
                 (``csrc/pstock.cu``).
- ``models``   — the FM, AM and linear (SSB/CW/IQ/ISB/CAM PLL)
                 demodulators, the noise estimate, the single receiver
                 with its control plane, the single- and mixed-mode
                 channel banks with their live control, and the hardware
                 front-end model (host numpy).
- ``io``       — the I/Q test modulator, PCM packetisation, RTP block
                 assembly and I/Q recordings.
- ``net``      — RTP, the TLV status/command protocol, multicast, RTCP and
                 the legacy in-band status header.
- ``native``   — the C++ RTP I/Q engine, PCM fan-out and PCM -> Opus
                 transcoder (g++ at first use).
- ``decode``   — the AFSK-1200 modem, AX.25 and APRS (host numpy).
- ``audio``    — the libopus binding, the Opus transcoder sessions and the
                 playout mixer (host only).
- ``apps``     — the daemons: ``bankd`` and ``radio``; ``frontend``,
                 ``iqplay``, ``iqrecord``, ``modulate``, ``pcmsend``;
                 ``packetd``, ``aprs`` and ``aprsfeed``; the listening and
                 control end, ``opusd``, ``opussend``, ``pcmcat``,
                 ``monitor``, ``control`` and ``display``.
- ``parallel`` — the channel bank sharded over a list of devices (the
                 channel mesh), the distributed master FFT and the
                 multi-device dry run.
- ``tools``    — the stage profile, the serving soak and the daemon
                 constellation soak.
- ``utils``    — the mode table, the band plan, frequency parsing, state
                 files, the daemons' device choice, device timing.
- ``interop``  — carries state between the two packages as numpy trees.
- ``bench``    — the flagship benchmark (the root ``bench.py``'s rows on
                 the card through the captured banks).

It imports torch and numpy and never jax, nor anything of the JAX package:
the host modules the daemons need are copies owned by the port.  No library
function chooses a device by itself: callers name one (``device=``) or a
mesh of them (``parallel.make_channel_mesh``, which takes the first cards),
and a tensor on a CUDA device always goes through the CUDA kernels.  The daemons
that use a device (``bankd``, ``radio``, ``modulate``) run on the CUDA card
unless ``--cpu``.
"""

__version__ = "0.1.0"
