"""program_idle_ms (ms a unit): device-idle time inside the port's unit
range, ``tdax.capture`` or ``tdax.train_step`` (the first the trace
holds): the card waiting on the port's own host code, apart from the
job's copies.  None where the window ran nothing on the device."""

UNIT_SPANS = ("capture", "train_step")


def read(ctx):
    held = set(ctx.trace.span_names())
    span = next((n for n in UNIT_SPANS if n in held), None)
    if span is None or ctx.units <= 0 or ctx.trace.busy_s() <= 0:
        return None
    return 1e3 * ctx.trace.span_idle_s(span) / ctx.units
