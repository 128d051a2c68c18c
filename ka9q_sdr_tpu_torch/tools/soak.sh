#!/bin/bash
# Full-constellation soak of the port's daemons on localhost multicast:
# frontend (replaying a recording) -> radio -> {opusd, packetd} -> monitor,
# with control polling radio near the end.  The reference is verified by
# field operation; this is the lab equivalent.
#
# Usage: ka9q_sdr_tpu_torch/tools/soak.sh [seconds]
#   SOAK_IQ=file.iq     192 kHz int16 I/Q to replay (default: a 400 Hz AM
#                       tone 48 kHz above the front end's centre, written
#                       into the output directory)
#   SOAK_DIR=dir        logs, the control readout and monitor's mix
#                       (default: a new temporary directory)
#   SOAK_RADIO_FLAGS=.. radio's extra flags (default none: the card;
#                       --cpu runs it on the host)
#   PYTHON=python3      the interpreter
set -u
SECS=${1:-60}
B=239.99.20
DIR=${SOAK_DIR:-$(mktemp -d)}
ROOT=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH=$ROOT${PYTHONPATH:+:$PYTHONPATH}
PY=${PYTHON:-python3}
trap 'kill $(jobs -p) 2>/dev/null' EXIT

IQ=${SOAK_IQ:-$DIR/test_am.iq}
if [ ! -e "$IQ" ]; then
    $PY - "$IQ" <<'PYEOF'
import sys
import numpy as np
t = np.arange(2 * 192000) / 192000.0
x = 0.3 * (1 + 0.8 * np.sin(2 * np.pi * 400 * t)) * np.exp(2j * np.pi * 48e3 * t)
iq = np.empty((len(t), 2), np.int16)
iq[:, 0], iq[:, 1] = np.round(x.real * 32767), np.round(x.imag * 32767)
iq.tofile(sys.argv[1])
PYEOF
fi

$PY -m ka9q_sdr_tpu_torch.apps.frontend -R $B.1:5004 -f 146m52 -r 192000 \
    --iq-file "$IQ" --seconds $((SECS + 30)) 2>"$DIR/fe.err" &
sleep 1
$PY -m ka9q_sdr_tpu_torch.apps.radio -I $B.1:5004 -R $B.2:5004 -f 146m568 \
    -m AM ${SOAK_RADIO_FLAGS-} 2>"$DIR/radio.err" &
RADIO=$!
$PY -m ka9q_sdr_tpu_torch.apps.opusd -I $B.2:5004 -R $B.3:5004 -o 32000 \
    2>"$DIR/opus.err" &
$PY -m ka9q_sdr_tpu_torch.apps.packetd -I $B.2:5004 -R $B.4:5004 \
    2>"$DIR/pkt.err" &
$PY -m ka9q_sdr_tpu_torch.apps.monitor $B.3:5004 --seconds "$SECS" \
    >"$DIR/mix.s16" 2>"$DIR/mon.err" &
MON=$!
sleep $((SECS > 10 ? SECS - 10 : 1))
$PY -m ka9q_sdr_tpu_torch.apps.control $B.2:5004 --once \
    >"$DIR/control.txt" 2>/dev/null
wait $MON
kill $RADIO 2>/dev/null
echo "soak: logs and mix in $DIR"
exit 0
