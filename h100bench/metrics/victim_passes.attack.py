"""victim_passes.attack: the victim's forward passes per attacked batch in
the window, counted by the benchmark's hook on the victim's network."""


def read(ctx):
    if not ctx.units or not ctx.passes:
        return None
    return len(ctx.passes) / ctx.units
