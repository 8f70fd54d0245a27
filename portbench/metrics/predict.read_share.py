"""The share of the calls' wall time spent reading and resampling the
WAVs (``predict_recordings(...)["seconds"]["read"]``), %."""


def read(ctx):
    return ctx.runner.read_share()
