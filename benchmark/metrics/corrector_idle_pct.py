"""corrector_idle_pct: the card's idle time inside the program's
``lcqpow::corrector`` span (the df32 corrector and certificate), in
percent of the traced window (``benchmark/stages.py``)."""

from benchmark import stages


def read(ctx):
    return stages.idle_pct(ctx.trace, "corrector")
