"""rechunk_ms.call: host ms per device batch of the caller cutting its input
into device batches, the concatenation and slices of
``coalesce_feature_batches`` (the program's ``caller.rechunk`` spans over
its ``caller.dispatch`` spans, one a device batch in
``call_mods_on_batches``, in the measured window)."""

from dsbench.program import ms_per, seconds


def read(res, cell):
    if not seconds(res, "caller.rechunk"):
        return None
    return ms_per(res, ("caller.rechunk",), "caller.dispatch")
