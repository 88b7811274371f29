"""format_ms.call: host ms per device batch in ``caller.format`` (the
renormalisation and the formatter) and ``caller.write``, in the measured
window."""

from dsbench.program import ms_per


def read(res, cell):
    return ms_per(res, ("caller.format", "caller.write"), "caller.forward")
