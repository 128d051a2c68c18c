"""Host-side tables and helpers of the port (port of
``ka9q_sdr_tpu.utils``): the mode table, frequency parsing, receiver state
files and the device choice of the daemons."""
