"""entry_idle_pct: the card's idle time inside the program's
``lcqpow::call`` span (the entry) and outside its predictor, inner QP and
corrector spans (the entry's casts of the data and the key split), in
percent of the traced window (``benchmark/stages.py``)."""

from benchmark import stages


def read(ctx):
    return stages.idle_pct(ctx.trace, "entry")
