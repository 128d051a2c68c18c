"""Host-side tables of the port (port of ``ka9q_sdr_tpu.utils``)."""
