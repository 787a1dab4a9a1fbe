"""Set-up: from the run's start (the harness's first line) to the
window's, loading, building, warming up and reaching the traffic's start
state; host clock."""


def read(ctx):
    return ctx.setup_s
