"""inner_qp_idle_pct: the card's idle time inside the program's
``lcqpow::inner_qp`` spans (each call of the inner QP engine, its KKT
solves included), in percent of the traced window
(``benchmark/stages.py``)."""

from benchmark import stages


def read(ctx):
    return stages.idle_pct(ctx.trace, "inner_qp")
