"""Stream I/O (port of ``ka9q_sdr_tpu.io``): PCM packetisation, RTP block
assembly, I/Q recording and replay, and the test modulator on torch
tensors.

The host modules are copies owned by the port: audio.c (PCM RTP output
with silence suppression), the RTP I/Q block assembler, and iqrecord.c /
iqplay.c (headerless s16 recordings with xattr metadata).
"""

from .pcm import PCMOutput, PCM_BUFSIZE, scaleclip_int16, pcm_to_float
from .assembler import BlockAssembler
from .iqfile import IQRecorder, IQReader, write_metadata, read_metadata
from .modulate import Modulator, MODULATE_PRESETS
