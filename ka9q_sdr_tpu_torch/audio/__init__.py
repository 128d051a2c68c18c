"""Playback-side audio modules (port of ``ka9q_sdr_tpu.audio``): the Opus
codec binding, the transcoder sessions and the multi-stream playout mixer
(reference: opus.c, monitor.c, opussend.c).  Host-side only: codecs and
jitter buffers never touch the card.
"""

from .opus_codec import (
    OPUS_AVAILABLE,
    OpusEncoder,
    OpusDecoder,
    OpusError,
)
from .transcode import LEGAL_FRAMES_MS, OpusSession, OpusTranscoder
from .playout import PlayoutSession, Mixer
