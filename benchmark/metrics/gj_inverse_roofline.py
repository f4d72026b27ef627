"""gj_inverse_roofline: the least time of the traced calls' batched SPD
inverses at their shapes (``roofline.gj_bound_s``) over the device time
of every kernel launched inside the program's entry to the inverse
(``ops.chol.gj_inverse``), in percent."""

SPANS = {"gj_inverse": ("lcqpow_tpu_torch.ops.chol.gj_inverse", "call")}


def read(ctx):
    records = ctx.spans.get("gj_inverse")
    if not records or ctx.trace is None:
        return None
    device = ctx.trace.range_device_ns("bench::gj_inverse")
    if device is None or device[1] == 0:
        return None
    bound = sum(ctx.roofline.gj_bound_s(r["shapes"][0][0],
                                        r["shapes"][0][-1])
                for r in records)
    return 100.0 * bound / (device[1] / 1e9)
