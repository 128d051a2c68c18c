"""Wire-compatible host transport (a copy of ``ka9q_sdr_tpu.net`` owned by
the port): RTP over IP multicast, the TLV status/command protocol, RTCP and
the legacy in-band status header.

This layer reproduces the reference's network interfaces bit-for-bit
(multicast.c, status.c, rtcp.c, sdr.h) so the reference's own consumers --
monitor, pcmcat, opus, VLC -- and the JAX package's tools interoperate
with the port's streams.  Pure host code; the card never sees a packet.
"""

from .rtp import (
    RTPHeader,
    RTPState,
    rtp_process,
    RTP_VERS,
    IQ_PT,
    IQ_PT8,
    AX25_PT,
    PCM_MONO_PT,
    PCM_STEREO_PT,
    OPUS_PT,
)
from .status import (
    StatusType,
    encode_int,
    encode_float,
    encode_double,
    encode_string,
    encode_eol,
    decode_int,
    decode_float,
    decode_double,
    decode_packet,
    StatusCompactor,
)
from .multicast import setup_mcast, DEFAULT_MCAST_PORT
from .rtcp import (RTCPSenderReport, RTCPReceiverReport, SDESItem, gen_sr,
                   gen_rr, gen_sdes, gen_bye)
from .sdr_header import LegacyStatus, LEGACY_STATUS_SIZE
