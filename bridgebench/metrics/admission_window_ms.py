"""admission_window_ms: the fast path's window install after each solve
(the `admission.window` span inside "bind": the residual view and the
protected gangs, with counters `protected` and `deductions`), window mean
per tick."""

from bblib.parts import part_mean


def read(run):
    return part_mean(run, "admission.window")
