"""Host-device synchronisations per traced frame: the warnings of
``torch.cuda.set_sync_debug_mode("warn")`` over the traced frames."""


def read(ctx):
    w = ctx.get("window")
    return None if not w else w.get("syncs")
