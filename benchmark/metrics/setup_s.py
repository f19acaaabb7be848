"""Set-up time: from the process's start to the first timed frame or step
(imports, the card's start, kernel builds on a checkout's first run,
weights, inputs, warm-up)."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(run):
    return run.record.setup_s
