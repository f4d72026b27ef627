"""perturb_apply_roofline: the least time of the traced calls' step
perturbations (draw, add, key carry) at their shapes and going lanes
(``roofline.perturb_bound_s``) over the device time of every kernel
launched inside each pass's call of the step that
``prng.perturbation`` hands the solver, in percent."""

SPANS = {"perturb_apply": ("lcqpow_tpu_torch.prng.perturbation", "factory")}


def read(ctx):
    records = ctx.spans.get("perturb_apply")
    if not records or ctx.trace is None:
        return None
    device = ctx.trace.range_device_ns("bench::perturb_apply")
    if device is None or device[1] == 0:
        return None
    bound = 0.0
    for r in records:
        (B, _), _, (_, n) = r["shapes"]
        size = r["dtypes"][2].itemsize
        bound += ctx.roofline.perturb_bound_s(B, n, int(r["trues"][1]), size)
    return 100.0 * bound / (device[1] / 1e9)
