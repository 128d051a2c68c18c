"""Command-line daemons mirroring the reference binaries (port of
``ka9q_sdr_tpu.apps``).  Each runs with
``python -m ka9q_sdr_tpu_torch.apps.<name>``; those that drive a device run
on the CUDA card unless ``--cpu``.

bankd    — multichannel bank daemon: wideband I/Q in, N PCM streams out
radio    — core receiver: I/Q multicast in, PCM out (main.c/radio.c)
frontend — front-end daemon/simulator with the frac-N LO model (funcube.c)
iqplay   — replay recordings/stdin as an RTP I/Q stream (iqplay.c)
iqrecord — record RTP sessions to files with xattr metadata (iqrecord.c)
modulate — baseband audio -> modulated I/Q test signal (modulate.c)
pcmsend  — raw s16 on stdin -> PCM RTP stream (pcmsend.c)
packetd  — AFSK/AX.25 demodulator daemon (packet.c)
aprs     — APRS position monitor with look angles (aprs.c)
aprsfeed — APRS i-gate: AX.25 -> APRS-IS (aprsfeed.c)
"""
