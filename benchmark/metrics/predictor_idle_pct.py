"""predictor_idle_pct: the card's idle time inside the program's
``lcqpow::predictor`` span (the f32 homotopy) and outside its
``lcqpow::inner_qp`` spans, in percent of the traced window
(``benchmark/stages.py``)."""

from benchmark import stages


def read(ctx):
    return stages.idle_pct(ctx.trace, "predictor")
