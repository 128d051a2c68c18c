"""Host-side tables and helpers of the port (port of
``ka9q_sdr_tpu.utils``): the mode table, frequency parsing, receiver state
files and the device choice of the daemons."""

from .modes import ModeDef, parse_modes, DEFAULT_MODES, load_modes
from .misc import parse_frequency, db2voltage, voltage2db, power2db, db2power
