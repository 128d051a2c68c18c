"""Digital decode chain: AFSK-1200 modem, HDLC deframer, AX.25 utilities,
APRS position decoding, APRS-IS i-gate (reference: packet.c, ax25.c,
aprs.c, aprsfeed.c).

The port's copy of ``ka9q_sdr_tpu.decode``, host numpy like its original:
the AFSK tone filtering and mixdown are vectorised block math; the
bit-sync and HDLC state machines are host code at symbol rate (1200 Hz),
where sequential control flow costs nothing.
"""

from .ax25 import (
    AX25Frame,
    ax25_parse,
    crc_good,
    append_crc,
    get_callsign,
    encode_callsign,
    decode_base91,
    frame_to_tnc2,
)
from .afsk import AFSKDemodulator
from .aprs import (
    parse_timestamp,
    parse_position,
    parse_mice_position,
    parse_aprs,
    Station,
    look_angles,
)
