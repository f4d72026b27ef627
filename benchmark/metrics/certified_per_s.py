"""certified_per_s: lanes the program certified (ret 0) in every call of
the window, over the host time from the first call's start to the last
call's end (each call ends in a device synchronisation)."""


def read(ctx):
    return ctx.certified / ctx.window_s
