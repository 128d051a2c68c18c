"""The benchmark's plain reference: the wideband channel bank written out
in plain PyTorch, computed in float64 (``Prec("float64")``) or, for the
control, with every stage's result rounded to bfloat16
(``Prec("bfloat16")``).

It imports nothing of the program: the mode table, the filter design, the
overlap-save master FFT, the channelizer and the demodulators are written
here from the semantics of ka9q-radio (filter.c, fm.c, linear.c, osc.c)
and the design rules the program states in its docstrings.  Each
demodulator is a module of this package named after the mode table's
demod column (``fm``, ``linear``), found by name, so a later mode adds a
module and edits none.
"""
